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

// 8 one-byte codes -> 8 fp16, exactly (every int8 and fp8 value is a half).
// int8 x: with its sign bit flipped, the byte under 0x64 is the half
// 1024 + (x + 128), and one packed subtraction of 1152 leaves x: a byte
// permute and a half2 subtraction a pair. fp8: a pair an instruction.
__device__ __forceinline__ uint4 f16x8_of(const int8_t* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t lo = raw.x ^ 0x80808080u, hi = raw.y ^ 0x80808080u;
  const __half2 bias = __halves2half2(__ushort_as_half(0x6480), __ushort_as_half(0x6480));  // 1152
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
  const uint32_t pairs[4] = {__byte_perm(lo, 0x64646464u, 0x5140), __byte_perm(lo, 0x64646464u, 0x7362),
                             __byte_perm(hi, 0x64646464u, 0x5140), __byte_perm(hi, 0x64646464u, 0x7362)};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2 h = __hsub2(*reinterpret_cast<const __half2*>(&pairs[i]), bias);
    w[i] = *reinterpret_cast<const uint32_t*>(&h);
  }
  return v;
}

__device__ __forceinline__ uint4 f16x8_of_fp8(const void* p, __nv_fp8_interpretation_t kind) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_fp8x2_storage_t* c = reinterpret_cast<const __nv_fp8x2_storage_t*>(&raw);
  uint4 v;
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(c[i], kind);
    w[i] = (uint32_t)h.x | ((uint32_t)h.y << 16);
  }
  return v;
}

__device__ __forceinline__ uint4 f16x8_of(const __nv_fp8_e4m3* p) { return f16x8_of_fp8(p, __NV_E4M3); }
__device__ __forceinline__ uint4 f16x8_of(const __nv_fp8_e5m2* p) { return f16x8_of_fp8(p, __NV_E5M2); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---- tensor-core tiles (mma.sync), cp.async and ldmatrix, shared by every
// kernel that stages tiles in shared memory ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

// two consecutive bf16 (p 4-byte aligned) as one fragment register
__device__ __forceinline__ uint32_t ld32(const bf16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// 16 bytes global -> shared
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem));
}

// the same; ok false writes zeros and reads nothing (gmem need not be valid)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(smem)), "l"(gmem),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the row address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// the same, each matrix transposed on the load
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// B fragment (k16 x n8) of a row-major [k][n] tile: rows k0..k0+15 from
// lanes 0-15's row addresses, columns n0..n0+7
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& b0, uint32_t& b1, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 operands
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---- Hopper warpgroup MMA (wgmma) over 128-byte-swizzled shared memory ----
//
// A swizzled tile is [rows][64] bf16: rows of 128 bytes, 16-byte chunk c of
// row r stored at chunk c ^ (r % 8). The hardware applies the XOR to address
// bits 4-6 from bits 7-9, so a tile starts on a 1024-byte boundary. A wider
// matrix is a row of such tiles.

// byte offset of 16-byte chunk c16 (0..7) of row r in a swizzled tile
__device__ __forceinline__ uint32_t sw128(int r, int c16) { return (uint32_t)(r * 128 + ((c16 ^ (r & 7)) << 4)); }

// shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets (each in 16-byte units, 14 bits)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// orders register and shared-memory accesses before the next wgmma
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// makes this thread's shared-memory writes (st.shared, cp.async) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// ---- mbarriers and TMA (a producer filling a ring of stages) ----

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to every thread and to the async proxy
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// one arrival that also expects `bytes` of asynchronous copies (TMA) in this phase
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed; a wait that never ends
// (a fault in a ring's bookkeeping) traps after ~2^24 polls, which the
// launch then reports, rather than hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// the box of a 3-D tensor map `tm` (a CUtensorMap in kernel parameters) at
// coordinates (c0, c1, c2), innermost first, into shared memory, completing
// on `bar`; past the tensor's edges the box is filled with zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tm, int c0, int c1, int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// the box of a 4-D tensor map at (c0, c1, c2, c3), innermost first
__device__ __forceinline__ void tma_load_4d(void* dst, const void* tm, int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], "
      "[%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// the box of a 2-D tensor map at (c0, c1), innermost first (tma_map.cuh)
__device__ __forceinline__ void tma_load_2d(void* dst, const void* tm, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` contiguous bytes global -> shared by the bulk-copy engine,
// completing on `bar` (dst, src and bytes multiples of 16)
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4 bytes global -> shared by cp.async (ca)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// an arrival on `bar` once this thread's earlier cp.async copies have
// landed; it counts toward the barrier's expected arrivals (noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// a barrier among the first `threads` threads of the block (warps that do
// not take part, such as a producer, never wait on it); id 0 is __syncthreads'
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// an arrival on that barrier that does not wait: the handing side of a
// hand-off between warpgroups, whose other side waits in named_sync
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the same barrier, returning whether `pred` held for any of those threads
__device__ __forceinline__ bool named_sync_or(int id, int threads, bool pred) {
  uint32_t any;
  asm volatile(
      "{\n .reg .pred p, q;\n setp.ne.b32 p, %1, 0;\n bar.red.or.pred q, %2, %3, p;\n selp.u32 %0, 1, 0, q;\n}\n"
      : "=r"(any)
      : "r"((uint32_t)pred), "r"(id), "r"(threads)
      : "memory");
  return any != 0;
}

// keeps the compiler from moving accesses of registers that an asynchronous
// wgmma reads or writes across this point (call after wgmma_wait)
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define SKT_ACC32(d)                                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), \
      "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),  \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, float32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 64), bf16,
// A and B from shared memory, both K-major (B stored [n][k]). Thread i of the
// warpgroup holds rows 16 (i / 32) + (i % 32) / 4 (+8) of d: d[4j + e] at
// column 8j + 2 (i % 4) + (e & 1), the lower row for e < 2.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : SKT_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A (64 x 16) * B (16 x 64): A from registers in mma.sync's m16k16 A
// fragment layout, warp w holding rows 16w..16w+15 (which is d's layout with
// column pairs packed by pack_bf16x2); B from shared memory, N-major (stored
// [k][n], the transpose-B form).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SKT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, float32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x 64), A
// from registers in mma.sync's m16k16 A fragment layout (warp w holding rows
// 16w..16w+15), B from shared memory K-major (stored [n][k]); fp16 operands
// with F16, else bf16.
template <bool F16>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (F16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : SKT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  else
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : SKT_ACC32(d)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define SKT_F8(d, o)                                                                                          \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), \
      "+f"(d[o + 7])
#define SKT_ACC128(d)                                                                                         \
  SKT_F8(d, 0), SKT_F8(d, 8), SKT_F8(d, 16), SKT_F8(d, 24), SKT_F8(d, 32), SKT_F8(d, 40), SKT_F8(d, 48),       \
      SKT_F8(d, 56), SKT_F8(d, 64), SKT_F8(d, 72), SKT_F8(d, 80), SKT_F8(d, 88), SKT_F8(d, 96), SKT_F8(d, 104), \
      SKT_F8(d, 112), SKT_F8(d, 120)

// d (64 x 256, float32) += A (64 x 16) * B (16 x 256), bf16, both from
// shared memory: A K-major (stored [m][k]), B N-major (stored [k][n], the
// transpose-B form). For B as a row of four swizzled [rows][64] sub-tiles
// (a [K][N] bank tile), the descriptor's leading byte offset steps from one
// 64-column sub-tile to the next and its stride byte offset from one 8-row
// group of k to the next (1024 B). d's layout is the n64 one's with 32
// column groups: d[4j + e] at column 8j + 2 (i % 4) + (e & 1).
__device__ __forceinline__ void wgmma_m64n256k16_ss_tb(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, "
      "%21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, "
      "%59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, "
      "%78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, "
      "%97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, "
      "%113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : SKT_ACC128(d)
      : "l"(da), "l"(db), "r"(1));
}

#define SKT_ACC8(d) SKT_F8(d, 0)
#define SKT_ACC16(d) SKT_F8(d, 0), SKT_F8(d, 8)
#define SKT_ACC64(d)                                                                                          \
  SKT_F8(d, 0), SKT_F8(d, 8), SKT_F8(d, 16), SKT_F8(d, 24), SKT_F8(d, 32), SKT_F8(d, 40), SKT_F8(d, 48),       \
      SKT_F8(d, 56)

// d (64 x N, float32) = (scale_d ? d : 0) + A (64 x 32) * B (32 x N), e4m3
// operands (fp8 wgmma takes both K-major; it has no transpose forms). A from
// registers in mma.sync's m16n8k32 A fragment layout, warp w holding rows
// 16w..16w+15: a[0] row g, k 4t..4t+3; a[1] row g+8, the same k; a[2] and
// a[3] the same rows at k 16 + 4t.. (g = lane / 4, t = lane % 4). B from
// shared memory K-major (stored [n][k]). d's layout is the n64 one's with
// N / 8 column groups: d[4j + e] at row 16w + g + 8 (e >> 1), column 8j +
// 2t + (e & 1).
template <int N>
__device__ __forceinline__ void wgmma_e4m3_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_e4m3_rs<16>(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : SKT_ACC8(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_e4m3_rs<32>(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : SKT_ACC16(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_e4m3_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : SKT_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_e4m3_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : SKT_ACC64(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#define SKT_R8(d, o)                                                                                          \
  "+r"(d[o]), "+r"(d[o + 1]), "+r"(d[o + 2]), "+r"(d[o + 3]), "+r"(d[o + 4]), "+r"(d[o + 5]), "+r"(d[o + 6]), \
      "+r"(d[o + 7])

// d (64 x N, int32) = (scale_d ? d : 0) + A (64 x 32) * B (32 x N), s8
// operands, both K-major: A from registers in the m16n8k32 fragment layout
// of wgmma_e4m3_rs (warp w rows 16w..16w+15; a[0] row g, k 4t..4t+3; a[1]
// row g+8; a[2], a[3] the same rows at k 16 + 4t..), B from shared memory
// K-major (stored [n][k]). d's layout is wgmma_e4m3_rs's; the sums are
// exact int32.
template <int N>
__device__ __forceinline__ void wgmma_s8_rs(uint32_t (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_s8_rs<16>(uint32_t (&d)[8], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p;\n}\n"
      : SKT_R8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<32>(uint32_t (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : SKT_R8(d, 0), SKT_R8(d, 8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<64>(uint32_t (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : SKT_R8(d, 0), SKT_R8(d, 8), SKT_R8(d, 16), SKT_R8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_s8_rs<128>(uint32_t (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : SKT_R8(d, 0), SKT_R8(d, 8), SKT_R8(d, 16), SKT_R8(d, 24), SKT_R8(d, 32), SKT_R8(d, 40), SKT_R8(d, 48),
        SKT_R8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef SKT_R8
#undef SKT_ACC64
#undef SKT_ACC16
#undef SKT_ACC8
#undef SKT_ACC128
#undef SKT_F8
#undef SKT_ACC32

}  // namespace skt
