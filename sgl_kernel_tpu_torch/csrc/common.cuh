// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace skt {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
// running-max start value, finite so exp2(m_old - m_new) stays 0 and never NaN
constexpr float kMaxInit = -1e30f;

template <int N> struct VecOf;
template <> struct VecOf<2> { typedef uint32_t T; };
template <> struct VecOf<4> { typedef uint2 T; };
template <> struct VecOf<8> { typedef uint4 T; };

// N consecutive bf16 values -> float, one vector load (p aligned to 2N bytes)
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&out)[N]) {
  typename VecOf<N>::T raw = *reinterpret_cast<const typename VecOf<N>::T*>(p);
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = __bfloat162float(h[i]);
}

template <int N>
__device__ __forceinline__ void store_bf16(bf16* p, const float (&in)[N]) {
  typename VecOf<N>::T raw;
  bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) h[i] = __float2bfloat16(in[i]);
  *reinterpret_cast<typename VecOf<N>::T*>(p) = raw;
}

// 16 one-byte values -> bf16, exactly: int8 and both fp8 formats (denormals
// included) fit bf16
__device__ __forceinline__ void to_bf16x16(const int8_t* b, bf16* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16((float)b[i]);
}

__device__ __forceinline__ void to_bf16x16(const __nv_fp8_e4m3* b, bf16* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(float(b[i]));
}

__device__ __forceinline__ void to_bf16x16(const __nv_fp8_e5m2* b, bf16* out) {
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = __float2bfloat16(float(b[i]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace skt
