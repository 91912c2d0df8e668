// The int8 warpgroup MMA's rate on the card, alone (and the bf16
// register-A loop of csrc/w4a16_wgmma.cu, with and without its int4
// decode): each warpgroup of a
// block issues `iters` rounds of four chained k32 wgmmas (.s32.s8.s8,
// m64nNk32) into one accumulator, a commit group a round with one group
// left in flight (as csrc/qserve_gemm.cu issues a box), its B (and, in
// shared-memory mode, its A) from a zero tile of 128-byte-swizzled shared
// memory read through the descriptors qserve_gemm.cu uses; the operands
// zeros or the bytes of a hash. Built and timed by tools/wgmma_probe.py;
// measurement only.

#include "w4a16_tile.cuh"  // common.cuh and int4_pair (the W4A16 tiles' int4 decode)

namespace {

// the wgmma forms timed here (common.cuh's wgmma_s8_rs is the kernels' own)
__device__ __forceinline__ void mma_rs_128(uint32_t (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_ss_128(uint32_t (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs_256(uint32_t (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_ss_256(uint32_t (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N, int NWG, bool RS>
__global__ void __launch_bounds__(128 * NWG, 1) wgmma_probe_kernel(int iters, int rnd, unsigned* out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* a_tile = base;                 // [64 NWG rows][128 bytes]
  uint8_t* b_tile = base + 64 * NWG * 128;  // [N rows][128 bytes]
  for (int i = threadIdx.x; i < (64 * NWG + N) * 128 / 4; i += blockDim.x)  // zeros, or bytes of a hash
    reinterpret_cast<uint32_t*>(base)[i] = rnd ? (uint32_t)i * 2654435761u ^ 0x9E3779B9u : 0u;
  skt::fence_proxy_async();
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint32_t a_s = skt::smem_u32(a_tile) + wg * 64 * 128, b_s = skt::smem_u32(b_tile);
  uint32_t acc[N / 2];
#pragma unroll
  for (int x = 0; x < N / 2; ++x) acc[x] = 0u;
  uint32_t f[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) f[x] = rnd ? (threadIdx.x * 4 + x) * 2246822519u ^ 0x85EBCA77u : 0u;
  for (int it = 0; it < iters; ++it) {
    skt::fence_regs(f);
    skt::fence_regs(acc);
    skt::wgmma_fence();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint64_t db = skt::wgmma_desc(b_s + 32 * q, 16, 1024);
      if constexpr (RS) {
        if constexpr (N == 128) mma_rs_128(acc, f, db);
        else mma_rs_256(acc, f, db);
      } else {
        const uint64_t da = skt::wgmma_desc(a_s + 32 * q, 16, 1024);
        if constexpr (N == 128) mma_ss_128(acc, da, db);
        else mma_ss_256(acc, da, db);
      }
    }
    skt::wgmma_commit();
    skt::wgmma_wait<1>();
    skt::fence_regs(acc);
  }
  skt::wgmma_wait<0>();
  skt::fence_regs(acc);
  unsigned v = 0;
#pragma unroll
  for (int x = 0; x < N / 2; ++x) v ^= acc[x];
  out[blockIdx.x * blockDim.x + threadIdx.x] = v;
}

template <int N, int NWG, bool RS>
cudaError_t launch(int blocks, int iters, int rnd, unsigned* out, cudaStream_t st) {
  auto kernel = wgmma_probe_kernel<N, NWG, RS>;
  const int smem = 1024 + (64 * NWG + N) * 128;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, 128 * NWG, smem, st>>>(iters, rnd, out);
  return cudaGetLastError();
}

// The bf16 loop of csrc/w4a16_wgmma.cu, alone: each warpgroup of a block
// issues k16 steps of two m64n64k16 register-A wgmmas (two accumulators),
// a commit group a step with one group left in flight, B a zero 64-row
// tile of swizzled shared memory; the fragments held (DECODE false) or
// decoded each step from two int4 code words of a swizzled [64][128-byte]
// stage of hash bytes, as that tile reads them (DECODE); with PROMOTE,
// every 8 steps (a group of 128) the accumulators are waited for and added
// into a total, scaled.
template <bool DECODE, bool PROMOTE>
__global__ void __launch_bounds__(256, 1) bf16_probe_kernel(int iters, unsigned* out) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* codes = base;             // [2 warpgroups][64 rows][128 bytes]
  uint8_t* b_tile = base + 2 * 8192;  // [64 rows][128 bytes] zeros
  for (int i = threadIdx.x; i < 3 * 8192 / 4; i += blockDim.x)
    reinterpret_cast<uint32_t*>(base)[i] = i < 2 * 8192 / 4 ? (uint32_t)i * 2654435761u ^ 0x9E3779B9u : 0u;
  skt::fence_proxy_async();
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4, w = warp % 4;
  const int g = lane >> 2, t = lane & 3, chunk = w + 4 * (g >> 2);
  const uint8_t* wbox = codes + wg * 8192;
  const int off0 = t * 128 + ((chunk ^ t) << 4) + 4 * (g & 3);
  const int off1 = (t + 4) * 128 + ((chunk ^ (t + 4)) << 4) + 4 * (g & 3);
  const uint32_t b_s = skt::smem_u32(b_tile);
  float acc[2][32], part[2][32];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int x = 0; x < 32; ++x) acc[m][x] = 0.f, part[m][x] = 0.f;
  uint32_t fr[2][2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) fr[h][m][x] = 0x3F803F80u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      if (DECODE) {
        const uint32_t x0 = *reinterpret_cast<const uint32_t*>(wbox + (kk & 1) * 1024 + off0);
        const uint32_t x1 = *reinterpret_cast<const uint32_t*>(wbox + (kk & 1) * 1024 + off1);
        const uint32_t y0 = x0 >> 4, y1 = x1 >> 4;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 2 * m + (q & 1);
            fr[kk & 1][m][q] = int4_pair(__byte_perm(q < 2 ? x0 : x1, q < 2 ? y0 : y1,
                                                     j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12)));
          }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        skt::fence_regs(fr[kk & 1][m]);
        skt::fence_regs(part[m]);
      }
      skt::wgmma_fence();
      const uint64_t db = skt::wgmma_desc(b_s + (kk & 3) * 32, 16, 1024);
#pragma unroll
      for (int m = 0; m < 2; ++m) skt::wgmma_m64n64k16_rs<false>(part[m], fr[kk & 1][m], db, PROMOTE ? kk != 0 : 1);
      skt::wgmma_commit();
      if (PROMOTE && kk == 7) {
        skt::wgmma_wait<0>();
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          skt::fence_regs(part[m]);
#pragma unroll
          for (int x = 0; x < 32; ++x) acc[m][x] += part[m][x] * (1.f + 0.001f * x);
        }
      } else {
        skt::wgmma_wait<1>();
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          skt::fence_regs(part[m]);
          skt::fence_regs(fr[(kk + 1) & 1][m]);
        }
      }
    }
  }
  skt::wgmma_wait<0>();
  float v = 0.f;
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    skt::fence_regs(part[m]);
#pragma unroll
    for (int x = 0; x < 32; ++x) v += acc[m][x] + part[m][x];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = __float_as_uint(v);
}

template <bool DECODE, bool PROMOTE>
cudaError_t launch_bf16(int blocks, int iters, unsigned* out, cudaStream_t st) {
  auto kernel = bf16_probe_kernel<DECODE, PROMOTE>;
  const int smem = 1024 + 3 * 8192;
  kernel<<<blocks, 256, smem, st>>>(iters, out);
  return cudaGetLastError();
}

}  // namespace

// The bf16 loop of the W4A16 wgmma tile: mode 0 fragments held, 1 decoded
// from int4 codes each step, 2 decoded with a promotion every 8 steps;
// two warpgroups a block, `iters` rounds of 8 steps; out holds blocks x 256
// words. Returns cudaGetLastError().
extern "C" int skt_wgmma_probe_bf16(int mode, int blocks, int iters, void* out, void* stream) {
  unsigned* o = (unsigned*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == 0) return (int)launch_bf16<false, false>(blocks, iters, o, st);
  if (mode == 1) return (int)launch_bf16<true, false>(blocks, iters, o, st);
  if (mode == 2) return (int)launch_bf16<true, true>(blocks, iters, o, st);
  return (int)cudaErrorInvalidValue;
}

// mode 0: A from registers, 1: A from shared memory; n 128 or 256; nwg
// 1 or 2 warpgroups a block; rnd 0: zero operands, 1: bytes of a hash;
// out holds blocks x 128 nwg words. Returns cudaGetLastError().
extern "C" int skt_wgmma_probe(int mode, int n, int nwg, int rnd, int blocks, int iters, void* out, void* stream) {
  unsigned* o = (unsigned*)out;
  cudaStream_t st = (cudaStream_t)stream;
#define SKT_CASE(N, W)                                                                   \
  if (n == N && nwg == W) return (int)(mode == 0 ? launch<N, W, true>(blocks, iters, rnd, o, st) \
                                                 : launch<N, W, false>(blocks, iters, rnd, o, st));
  SKT_CASE(128, 1) SKT_CASE(128, 2) SKT_CASE(256, 1) SKT_CASE(256, 2)
#undef SKT_CASE
  return (int)cudaErrorInvalidValue;
}
