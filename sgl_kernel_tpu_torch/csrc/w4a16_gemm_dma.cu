// K10: decode-bucket W4A16 GEMM with streamed weights,
// out[M,N] = prologue(A)[M,K] @ dequant(W)[K,N] (+bias) (+residual), M <= 32.
//
// Replaces w4a16_gemm_dma (sgl_kernel_tpu/ops/gemm/w4a16_dma.py:170, Pallas
// kernel _kernel, pallas_call at :266). Contract and rounding points are
// K1's (w4a16_gemm.cu): W uint8 [K/2, N] with rows 2r / 2r+1 in the low /
// high nibble, two's-complement int4 or e2m1 (mxfp4); scales bf16 [K/G, N];
// zeros the z*s pre-product; the silu_mul prologue rounded to bf16 before
// the product; each scale group's partial product in f32, scaled per column;
// bias and residual added in f32 before the one cast. No norm prologue and no
// fused gate/up (the JAX kernel has neither).
//
// Bound: bytes. At M=16 a decode GEMM reads 0.5 byte of codes per weight and
// does 32 flops on it: 8-270 MB of codes per call at Llama-3-8B widths, far
// below the card's ridge. The TPU kernel exists because its BlockSpec
// pipeline fell behind a weight stream issued by hand (w4a16_dma.py:1-16).
//
// Design, the TPU kernel's idea carried to the card. A block is one
// producer warp and four consumer warps of 32 columns each. The block's [<=32, K-range]
// activations are staged once in shared memory by the consumers, the silu
// prologue applied on the way and rounded to bf16, in the k order that lets a
// nibble pair decode with one mask (w4a16_tile.cuh). The packed weights
// stream through a four-stage ring of 256-K-row chunks: one lane of the
// producer warp fills each stage with TMA tensor copies (one 16 KB box of
// 128 packed rows x 128 columns, 128-byte swizzled so the fragment reads
// spread over the banks, and one box each of the chunk's scale and zero
// rows), completing on the stage's "full" mbarrier; consumers wait on it,
// decode nibbles to bf16 in registers and run mma.sync m16n8k16 (K1's
// fragment code), scale each group's partial per column into f32, and
// release the stage on its "empty" mbarrier. The producer runs up to four
// chunks ahead and walks on across the block's column tiles without draining
// (a block takes several tiles when there are more tiles than SMs, reusing its
// staged activations).
// K is split across blocks in whole groups when the activations would not
// fit in shared memory or the tiles alone cannot fill the SMs (K1's plan);
// the splits' f32 partials are summed in a fixed order by a second pass.
// Tried first: one plain bulk copy (cp.async.bulk) a packed row, 128 bytes,
// ~130 a stage; the copy engine's cost a request held every decode shape to
// 9-14 % of HBM (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).
// wgmma, warp-specialised register budgets and cluster multicast are not
// used yet.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include "w4a16_tile.cuh"

namespace k10 {

using skt::bf16;

constexpr int BN = 128;                       // columns of a tile: four warps of 32
constexpr int KC = 256;                       // K rows of a ring stage
constexpr int kStages = 4;
constexpr int W_BYTES = (KC / 2) * BN;       // a stage's codes: one TMA box, 128-byte swizzled rows
constexpr int kSmemLimit = 232448;            // 227 KB a block

struct Params {
  const bf16* a;
  const bf16* a2;       // or null
  const uint8_t* w;     // [K/2, N]
  const bf16* scales;   // [K/G, N]
  const bf16* zeros;    // or null
  const float* bias;    // or null
  const bf16* residual; // or null
  void* out;            // [M, N] bf16 or f32
  float* partial;       // [split, M, N] when split > 1
  int M, N, lda, lda2, n_groups, groups_per_split, split, workers, out_f32;
  // TMA descriptors: codes [K/2, N] u8 in boxes of 128 rows x 128 columns,
  // 128-byte swizzle; scales and zeros [K/G, N] bf16 in boxes of KC/G rows
  CUtensorMap tm_w, tm_s, tm_z;
};

constexpr int kConsumers = 4;  // warps, 32 columns each
constexpr int kThreads = (kConsumers + 1) * 32;  // and the producer warp

template <int G, bool ZR>
struct Layout {
  static constexpr int SROWS = KC / G;  // scale rows of a stage
  static constexpr int S_BYTES = SROWS * BN * 2;
  // stages start on 1024-byte boundaries, the 128-byte swizzle's period
  static constexpr int STAGE = (W_BYTES + S_BYTES * (ZR ? 2 : 1) + 1023) / 1024 * 1024;
  static constexpr int RING = kStages * STAGE;
};

// dynamic shared memory of a launch: ring, activations, zero-point row sums,
// barriers, and the slack to align the ring
template <int G, bool ZR>
__host__ __device__ constexpr int smem_bytes(int rows, int per) {
  return Layout<G, ZR>::RING + rows * (per * G + 8) * 2 + (ZR ? rows * per * 4 : 0) + 2 * kStages * 8 + 1024;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// until the phase of parity `parity` has completed; a wait that never ends
// (a fault in the ring's bookkeeping) traps after ~2^24 polls, which the
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

// the box of `tm` at (column c0, row c1) into shared memory, completing on
// `bar` (TMA; past the tensor's edge the box is filled with zeros)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* tm, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tm)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// byte `col` of packed row `row` in a stage's swizzled code box: the
// 16-byte chunk index is XORed with the row's index mod 8
__device__ __forceinline__ int swz(int row, int col) {
  return row * BN + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers * 32) : "memory");
}

__device__ __forceinline__ void store_out(const Params& p, int row, int col, float v) {
  const long long idx = (long long)row * p.N + col;
  if (p.bias) v += p.bias[col];
  if (p.residual) v += __bfloat162float(p.residual[idx]);
  if (p.out_f32)
    reinterpret_cast<float*>(p.out)[idx] = v;
  else
    reinterpret_cast<bf16*>(p.out)[idx] = __float2bfloat16(v);
}

// MT m16 tiles of rows; G group size; MX mxfp4 codes; ZR zero points;
// PRO the silu_mul prologue
template <int G, int MT, bool MX, bool ZR, bool PRO>
__global__ void __launch_bounds__(kThreads, 1) gemm_dma_kernel(const __grid_constant__ Params p) {
  using L = Layout<G, ZR>;
  constexpr int MP = 16 * MT;
  constexpr int GPC = KC / G;  // groups of a stage
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int per = p.groups_per_split;
  const int KR = per * G, AST = KR + 8;  // staged K range, its row stride (bf16)
  bf16* act = reinterpret_cast<bf16*>(smem + L::RING);
  float* asum = reinterpret_cast<float*>(smem + L::RING + MP * AST * 2);
  uint64_t* full = reinterpret_cast<uint64_t*>(asum + (ZR ? MP * per : 0));
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g0 = blockIdx.z * per;
  const int ng = min(p.n_groups, g0 + per) - g0;  // >= 1 (the host's plan)
  const int n_chunks = (ng + GPC - 1) / GPC;
  const int tiles = (p.N + BN - 1) / BN;
  const int my_tiles = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / p.workers + 1 : 0;
  const int T = my_tiles * n_chunks;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers) {
    // producer, one lane: chunk t of the walk is tile blockIdx.x + (t /
    // n_chunks) * workers, groups g0 + (t % n_chunks) * GPC onward; a stage
    // is two or three TMA boxes (a chunk past the block's K range reads rows
    // that go unused, or zeros past the tensor, and the full boxes count)
    if (lane == 0) {
      for (int t = 0; t < T; ++t) {
        const int s = t % kStages;
        if (t >= kStages) mbar_wait(&empty[s], ((t / kStages) - 1) & 1);
        const int n0 = (blockIdx.x + (t / n_chunks) * p.workers) * BN;
        const int gs = g0 + (t % n_chunks) * GPC;
        uint8_t* stage = smem + s * L::STAGE;
        mbar_expect_tx(&full[s], W_BYTES + L::S_BYTES * (ZR ? 2 : 1));
        tma_load(stage, &p.tm_w, n0, gs * G / 2, &full[s]);
        tma_load(stage + W_BYTES, &p.tm_s, n0, gs, &full[s]);
        if (ZR) tma_load(stage + W_BYTES + L::S_BYTES, &p.tm_z, n0, gs, &full[s]);
      }
    }
    return;
  }

  // consumers: stage the activations of the block's K range once
  const int k_begin = g0 * G, kn = ng * G;
  for (int c = tid; c < MP * (KR / 16); c += kConsumers * 32) {
    const int m = c / (KR / 16), kk = (c % (KR / 16)) * 16;
    uint4 v[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (m < p.M && kk < kn) {
      const bf16* src = p.a + (long long)m * p.lda + k_begin + kk;
      v[0] = reinterpret_cast<const uint4*>(src)[0];
      v[1] = reinterpret_cast<const uint4*>(src)[1];
      if (PRO) {
        const bf16* src2 = p.a2 + (long long)m * p.lda2 + k_begin + kk;
        const uint4 u[2] = {reinterpret_cast<const uint4*>(src2)[0], reinterpret_cast<const uint4*>(src2)[1]};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x[8], y[8];
          unpack8(v[h], x);
          unpack8(u[h], y);
          bf16* hv = reinterpret_cast<bf16*>(&v[h]);
#pragma unroll
          for (int e = 0; e < 8; ++e) hv[e] = __float2bfloat16(prologue_silu(x[e], y[e]));
        }
      }
    }
    // k 0..15 of the chunk into the slot order (w4a16_tile.cuh, store_a)
    uint4 lo, hi;
    lo.x = __byte_perm(v[0].x, v[1].x, 0x5410);
    lo.y = __byte_perm(v[0].y, v[1].y, 0x5410);
    lo.z = __byte_perm(v[0].z, v[1].z, 0x5410);
    lo.w = __byte_perm(v[0].w, v[1].w, 0x5410);
    hi.x = __byte_perm(v[0].x, v[1].x, 0x7632);
    hi.y = __byte_perm(v[0].y, v[1].y, 0x7632);
    hi.z = __byte_perm(v[0].z, v[1].z, 0x7632);
    hi.w = __byte_perm(v[0].w, v[1].w, 0x7632);
    bf16* dst = act + m * AST + kk;
    *reinterpret_cast<uint4*>(dst) = lo;
    *reinterpret_cast<uint4*>(dst + 8) = hi;
  }
  consumers_sync();
  if (ZR) {
    for (int i = tid; i < MP * ng; i += kConsumers * 32) {
      const int m = i / ng, gi = i % ng;
      float s = 0.f;
      for (int k = 0; k < G; ++k) s += __bfloat162float(act[m * AST + gi * G + k]);
      asum[m * per + gi] = s;
    }
    consumers_sync();
  }

  const int gq = lane >> 2, tq = lane & 3;
  int t = 0;
  for (int tile = 0; tile < my_tiles; ++tile) {
    const int n0 = (blockIdx.x + tile * p.workers) * BN;
    const int nc = warp * 32;  // the warp's first column in the tile
    float acc[MT][4][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int c = 0; c < n_chunks; ++c, ++t) {
      const int s = t % kStages;
      mbar_wait(&full[s], (t / kStages) & 1);
      const uint8_t* stage = smem + s * L::STAGE;
      const bf16* srow = reinterpret_cast<const bf16*>(stage + W_BYTES);
      const int gl0 = c * GPC, gn = min(GPC, ng - gl0);  // local group index of the chunk
      for (int gi = 0; gi < gn; ++gi) {
        float part[MT][4][4];
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < G / 16; ++ks) {
          uint32_t af[MT][4];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const bf16* base = act + (i * 16 + gq) * AST + (gl0 + gi) * G + ks * 16 + tq * 2;
            af[i][0] = *reinterpret_cast<const uint32_t*>(base);
            af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * AST);
            af[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
            af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * AST + 8);
          }
          // packed rows t and t+4 of this step, the thread's byte of each n8 tile
          const int wr = gi * (G / 2) + ks * 8 + tq;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(stage + swz(wr, nc + 4 * gq));
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(stage + swz(wr + 4, nc + 4 * gq));
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t x = __byte_perm(w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
            uint32_t b0, b1;
            if (MX) {
              b0 = mxfp4_pair(x);
              b1 = mxfp4_pair(x >> 4);
            } else {
              b0 = int4_pair(x);
              b1 = int4_pair(x >> 4);
            }
#pragma unroll
            for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], af[i], b0, b1);
          }
        }
        // lane columns 2t and 2t+1 of tile j are columns 8t + j and 8t + 4 + j
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cl = nc + 8 * tq + j;
          const float s0 = __bfloat162float(srow[gi * BN + cl]), s1 = __bfloat162float(srow[gi * BN + cl + 4]);
          const float z0 = ZR ? __bfloat162float(srow[(L::SROWS + gi) * BN + cl]) : 0.f;
          const float z1 = ZR ? __bfloat162float(srow[(L::SROWS + gi) * BN + cl + 4]) : 0.f;
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            acc[i][j][0] += part[i][j][0] * s0;
            acc[i][j][1] += part[i][j][1] * s1;
            acc[i][j][2] += part[i][j][2] * s0;
            acc[i][j][3] += part[i][j][3] * s1;
            if (ZR) {
              const int r = i * 16 + gq, gl = gl0 + gi;
              acc[i][j][0] -= asum[r * per + gl] * z0;
              acc[i][j][1] -= asum[r * per + gl] * z1;
              acc[i][j][2] -= asum[(r + 8) * per + gl] * z0;
              acc[i][j][3] -= asum[(r + 8) * per + gl] * z1;
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = i * 16 + gq + (e >> 1) * 8;
          const int col = n0 + nc + 8 * tq + 4 * (e & 1) + j;
          if (row >= p.M || col >= p.N) continue;
          if (p.split > 1)
            p.partial[((long long)blockIdx.z * p.M + row) * p.N + col] = acc[i][j][e];
          else
            store_out(p, row, col, acc[i][j][e]);
        }
  }
}

// second pass of split-K: the partials summed in split order, then bias,
// residual and the cast
__global__ void reduce_kernel(const Params p) {
  const long long total = (long long)p.M * p.N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < p.split; ++s) v += p.partial[s * total + idx];
  store_out(p, (int)(idx / p.N), (int)(idx % p.N), v);
}

template <int G, int MT, bool MX, bool ZR, bool PRO>
cudaError_t launch(const Params& p, cudaStream_t st) {
  const int bytes = smem_bytes<G, ZR>(16 * MT, p.groups_per_split);
  if (bytes > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = gemm_dma_kernel<G, MT, MX, ZR, PRO>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.workers, 1, p.split), kThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <int G, int MT, bool MX>
cudaError_t dispatch_flags(const Params& p, cudaStream_t st) {
  const bool zr = p.zeros != nullptr, pro = p.a2 != nullptr;
  if (zr && pro) return launch<G, MT, MX, true, true>(p, st);
  if (zr) return launch<G, MT, MX, true, false>(p, st);
  if (pro) return launch<G, MT, MX, false, true>(p, st);
  return launch<G, MT, MX, false, false>(p, st);
}

template <int G>
cudaError_t dispatch_rows(int mxfp4, const Params& p, cudaStream_t st) {
  if (p.M <= 16) return mxfp4 ? dispatch_flags<G, 1, true>(p, st) : dispatch_flags<G, 1, false>(p, st);
  return mxfp4 ? dispatch_flags<G, 2, true>(p, st) : dispatch_flags<G, 2, false>(p, st);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, fetched once through the runtime's entry-point
// query (no link against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// a 2-D row-major [rows, cols] tensor in boxes of box_rows x BN columns
bool tensor_map(CUtensorMap* tm, CUtensorMapDataType type, const void* base, int rows, int cols, int elem_bytes,
                int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)BN, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  EncodeTiled encode = encoder();
  return encode && encode(tm, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace k10

// One call: the main kernel and, with split > 1, the reduction. M <= 32;
// K a multiple of the group (32, 64 or 128); N a multiple of 16; a, a2
// (null without the silu_mul prologue), scales, zeros (or null) and
// residual bf16, with a / a2 rows 16-byte aligned (lda, lda2 multiples of
// 8); bias f32; out bf16 or f32 (out_f32). The grid is workers x split
// blocks; block (x, z) takes column tiles x, x + workers, ... over groups
// [z * groups_per_split, (z + 1) * groups_per_split).
extern "C" int skt_w4a16_gemm_dma(const void* a, const void* a2, const void* w, const void* scales,
                                  const void* zeros, const void* bias, const void* residual, void* out,
                                  void* partial, int M, int N, int K, int lda, int lda2, int group, int split,
                                  int groups_per_split, int workers, int mxfp4, int out_f32, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (M < 1 || M > 32 || N % 16 || K % group || split < 1 || workers < 1 || (split > 1 && !partial) ||
      (long long)(split - 1) * groups_per_split >= K / group)
    return (int)cudaErrorInvalidValue;
  k10::Params p{};
  p.a = (const skt::bf16*)a;
  p.a2 = (const skt::bf16*)a2;
  p.w = (const uint8_t*)w;
  p.scales = (const skt::bf16*)scales;
  p.zeros = (const skt::bf16*)zeros;
  p.bias = (const float*)bias;
  p.residual = (const skt::bf16*)residual;
  p.out = out;
  p.partial = (float*)partial;
  p.M = M, p.N = N, p.lda = lda, p.lda2 = lda2, p.n_groups = K / group;
  p.groups_per_split = groups_per_split, p.split = split, p.workers = workers, p.out_f32 = out_f32;
  const int srows = k10::KC / group;
  if (!k10::tensor_map(&p.tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, K / 2, N, 1, k10::KC / 2,
                       CU_TENSOR_MAP_SWIZZLE_128B) ||
      !k10::tensor_map(&p.tm_s, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scales, K / group, N, 2, srows,
                       CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (zeros && !k10::tensor_map(&p.tm_z, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, zeros, K / group, N, 2, srows,
                                 CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (group) {
    case 32: err = k10::dispatch_rows<32>(mxfp4, p, st); break;
    case 64: err = k10::dispatch_rows<64>(mxfp4, p, st); break;
    case 128: err = k10::dispatch_rows<128>(mxfp4, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)M * N;
  k10::reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
