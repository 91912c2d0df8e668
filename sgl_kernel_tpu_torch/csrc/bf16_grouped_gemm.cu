// K12: grouped bf16 GEMM over expert-sorted, block-aligned rows (MoE).
//
// Replaces bf16_grouped_mm (sgl_kernel_tpu/ops/moe/grouped_gemm.py:107,
// Pallas kernel _bf16_kernel, pallas_call at :175). Contract: x [cap, K] bf16,
// rows sorted by expert and aligned so that row block i (block_rows rows)
// belongs to expert block_expert_ids[i]; w [E, K, N] bf16 (x @ w[e], N
// contiguous), one layer of a stacked [L, E, K, N] bank picked by the caller's
// pointer offset and the expert by this kernel's, never by a copy of the bank.
// Row blocks at or past num_valid_blocks are alignment padding: nothing is
// fetched or computed for them and their output rows are left unwritten
// (undefined by contract). Products accumulate in float32 and round once to
// out (bf16 or float32).
//
// Bound: bytes at decode. At a B=16 decode step each valid row block holds a
// few tokens' rows of one expert and streams that expert's whole [K, N] bank
// once: DeepSeek-V2-Lite's gate_up (K 2048 -> N 2816) over ~51 of 64 experts
// is 0.59 GB, Mixtral-8x7B's (K 4096 -> N 28672) over ~8 of 8 is 1.9 GB,
// against 16 activation rows an expert: a few flops a byte. At prefill (bm
// 128, hundreds of rows an expert) operations bound it.
//
// Design: mma.sync m16n8k16 bf16 tiles with float32 accumulators. Each block
// computes one (row tile, column tile) of the output over the whole K: a ring
// of S stages in shared memory is filled by cp.async (16 bytes a thread,
// zero-filled past K and N), A fragments come from the [BM, BK] tile by
// ldmatrix and B fragments from the [BK, BN] tile (N contiguous) by
// ldmatrix.trans, so no transpose of the bank is ever made. Each block reads
// its expert id and *num_valid itself (the TPU's scalar prefetch becomes two
// loads a block); the grid covers every row block of cap, so the host never
// reads the valid count, and blocks past it return at once. The row tile
// equals the alignment block (16, 32, 64 or 128 rows), so a tile never spans
// two experts; at decode (bm 16) the column tiles are 64 wide, so the ~8 to
// ~51 valid row blocks times N / 64 tiles give thousands of blocks over the
// 132 SMs, each with a few stages of 8 KB weight tiles in flight.

#include "common.cuh"

namespace {

using skt::bf16;
using skt::cp_async16;
using skt::cp_async_commit;
using skt::cp_async_wait;
using skt::mma_bf16;

struct Params {
  const bf16* x;          // [M, lda]
  const bf16* w;          // [E, K, N]
  const int* expert_ids;  // [M / block_rows]
  const int* num_valid;   // [] valid row blocks
  void* out;              // [M, N] bf16 or f32
  int M, N, K, lda, block_rows, out_f32;
  long long w_estride;    // elements of one expert's [K, N]
};

// BM x BN output tile, BK deep stages, WM x WN warps (each a (BM/WM) x (BN/WN)
// warp tile of m16n8 mma tiles), S stages in the ring.
template <int BM, int BN, int BK, int WM, int WN, int S>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = BN / WN / 8;
  static constexpr int A_LD = BK + 8, B_LD = BN + 8;  // bf16 per smem row: conflict-free ldmatrix
  static constexpr int A_ELEMS = BM * A_LD, B_ELEMS = BK * B_LD;
  static constexpr int SMEM = S * (A_ELEMS + B_ELEMS) * 2;
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile of whole m16 and n16 steps");
  static_assert(BK % 16 == 0 && BN % 8 == 0, "tile shape");
};

template <int BM, int BN, int BK, int WM, int WN, int S>
__global__ void __launch_bounds__(Tile<BM, BN, BK, WM, WN, S>::kThreads)
    bf16_grouped_kernel(const Params p) {
  using T = Tile<BM, BN, BK, WM, WN, S>;
  constexpr int MT = T::MT, NT = T::NT, A_LD = T::A_LD, B_LD = T::B_LD;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sa = reinterpret_cast<bf16*>(smem_raw);  // [S][BM][A_LD]
  bf16* sb = sa + S * T::A_ELEMS;                // [S][BK][B_LD]

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int blk = m0 / p.block_rows;
  if (blk >= *p.num_valid) return;  // alignment padding: nothing to fetch or compute
  const bf16* wb = p.w + (long long)p.expert_ids[blk] * p.w_estride;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int n_k = (p.K + BK - 1) / BK;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = kt * BK;
    bf16* a_dst = sa + stage * T::A_ELEMS;
    for (int c = tid; c < BM * (BK / 8); c += T::kThreads) {
      const int r = c / (BK / 8), kc = (c % (BK / 8)) * 8;
      const bool ok = m0 + r < p.M && k0 + kc < p.K;
      const bf16* src = ok ? p.x + (long long)(m0 + r) * p.lda + k0 + kc : p.x;
      cp_async16(a_dst + r * A_LD + kc, src, ok);
    }
    bf16* b_dst = sb + stage * T::B_ELEMS;
    for (int c = tid; c < BK * (BN / 8); c += T::kThreads) {
      const int r = c / (BN / 8), nc = (c % (BN / 8)) * 8;
      const bool ok = k0 + r < p.K && n0 + nc < p.N;
      const bf16* src = ok ? wb + (long long)(k0 + r) * p.N + n0 + nc : wb;
      cp_async16(b_dst + r * B_LD + nc, src, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_k) load_stage(s, s);
    cp_async_commit();
  }

  // ldmatrix row of this lane: rows 0-15 of a 16 x 16 tile, its left or
  // right 8 columns (A: m x k; B, transposed on the load: k x n)
  const int lrow = lane % 16, lcol = (lane / 16) * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<S - 2>();  // stage kt has landed
    __syncthreads();         // ... for every thread, and stage kt - 1 is consumed
    if (kt + S - 1 < n_k) load_stage(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    const bf16* a_t = sa + (kt % S) * T::A_ELEMS;
    const bf16* b_t = sb + (kt % S) * T::B_ELEMS;
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        skt::ldsm_x4(af[i], a_t + (wm * MT * 16 + i * 16 + lrow) * A_LD + ks * 16 + lcol);
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t bf[4];  // b0, b1 of n8 tile 2 j2, then of 2 j2 + 1
        skt::ldsm_x4_trans(bf, b_t + (ks * 16 + lrow) * B_LD + wn * NT * 8 + j2 * 16 + lcol);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][2 * j2], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][2 * j2 + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * MT * 16 + i * 16 + gq + 8 * h;
        const int col = n0 + wn * NT * 8 + j * 8 + 2 * tq;
        if (row >= p.M || col >= p.N) continue;
        const long long idx = (long long)row * p.N + col;
        const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if (p.out_f32)
          *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + idx) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(p.out) + idx) = __floats2bfloat162_rn(v0, v1);
      }
}

template <int BM, int BN, int BK, int WM, int WN, int S>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using T = Tile<BM, BN, BK, WM, WN, S>;
  auto kernel = bf16_grouped_kernel<BM, BN, BK, WM, WN, S>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, T::kThreads, T::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x [M, lda] bf16; w [E, K, N] bf16 (w_estride = K * N elements); expert_ids
// [M / block_rows] int32; num_valid [] int32 on the device; out [M, N] bf16 or
// float32 (out_f32). block_rows is the alignment block: 16, 32, 64 or 128
// (the row tile). K and N multiples of 8, x's rows 16-byte aligned. Returns
// cudaGetLastError() after the launch.
extern "C" int skt_bf16_grouped_mm(const void* x, const void* w, const void* expert_ids, const void* num_valid,
                                   void* out, int M, int N, int K, int lda, int block_rows, long long w_estride,
                                   int out_f32, void* stream) {
  if (K % 8 || N % 8 || lda % 8 || M % block_rows) return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = (const bf16*)x;
  p.w = (const bf16*)w;
  p.expert_ids = (const int*)expert_ids;
  p.num_valid = (const int*)num_valid;
  p.out = out;
  p.M = M, p.N = N, p.K = K, p.lda = lda, p.block_rows = block_rows, p.out_f32 = out_f32;
  p.w_estride = w_estride;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_rows) {
    case 16: return (int)launch<16, 64, 64, 1, 4, 4>(p, st);
    case 32: return (int)launch<32, 64, 64, 2, 2, 4>(p, st);
    case 64: return (int)launch<64, 64, 64, 2, 2, 3>(p, st);
    case 128: return (int)launch<128, 128, 32, 2, 4, 4>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
