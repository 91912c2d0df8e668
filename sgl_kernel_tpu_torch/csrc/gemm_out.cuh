// Output stores of the GEMMs with a bf16 / f16 / float32 output, K17 / K18
// (blockwise_fp8.cu) and K19 (qserve_gemm.cu); both sum a split K's
// partials in the same launch.
#pragma once

#include <cuda_fp16.h>

#include "common.cuh"

namespace skt {

// output element kinds of the GEMMs
enum { kOutBf16 = 0, kOutF16 = 1, kOutF32 = 2 };

// two consecutive outputs at out[idx], out[idx + 1] (idx even)
__device__ __forceinline__ void store2(void* out, int kind, long long idx, float v0, float v1) {
  if (kind == kOutF32)
    *reinterpret_cast<float2*>(reinterpret_cast<float*>(out) + idx) = make_float2(v0, v1);
  else if (kind == kOutF16)
    *reinterpret_cast<__half2*>(reinterpret_cast<__half*>(out) + idx) = __floats2half2_rn(v0, v1);
  else
    *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(out) + idx) = __floats2bfloat162_rn(v0, v1);
}

__device__ __forceinline__ void store1(void* out, int kind, long long idx, float v) {
  if (kind == kOutF32) reinterpret_cast<float*>(out)[idx] = v;
  else if (kind == kOutF16) reinterpret_cast<__half*>(out)[idx] = __float2half_rn(v);
  else reinterpret_cast<bf16*>(out)[idx] = __float2bfloat16(v);
}

}  // namespace skt
