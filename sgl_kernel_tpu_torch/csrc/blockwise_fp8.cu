// K17 / K18: blockwise-scaled fp8 GEMM (DeepSeek 1x128 activation and
// 128x128 weight scale blocks), dense and grouped over experts.
//
// Replaces fp8_blockwise_scaled_mm (sgl_kernel_tpu/ops/gemm/blockwise_fp8.py:268,
// Pallas kernel _kernel :220, pallas_call at :310) and
// fp8_blockwise_scaled_grouped_mm (:362, _grouped_kernel :336, pallas_call at
// :403). Contract: A [M, K] e4m3 (row stride lda), B [K, N] e4m3 (N
// contiguous) or a bank [E, K, N] with one expert per row block of
// block_rows rows (expert_ids [M / block_rows]); sa [M, K/128] float32;
// sb [K/128, sb_ld] float32 (or [E, K/128, sb_ld]), the scale of column n
// being sb[g, n / sb_div] * sb_mul (compact: sb_div 128, sb_mul 1; the
// TPU's prepared rows: sb_div 1, sb_mul 2^-120). K and N multiples of 128.
//
//   out[m, n] = sum_g (A[m, g] @ B[g, n]) * (sa[m, g] * sb(g, n))
//
// over the 128-deep scale groups g, in float32, rounded once to bf16, f16 or
// float32. Every row block is computed: the TPU kernel has no valid-block
// count.
//
// Bound: bytes at decode, operations at prefill. A DeepSeek-V3 decode step's
// shared-expert gate_up at M=16 streams 29.4 MB of B for 0.94 GFLOP; at
// M=1,024 it does 60 GFLOP over ~37 MB.
//
// Design: one block per 128-column tile of BM rows (16, 32, 64 or 128) and a
// range of k-tiles; a k-tile is one scale group, so the block promotes each
// group's partial into its float32 accumulators with the group's scales as
// soon as the group's four m16n8k32 e4m3 mma.sync steps are done (the fp8
// mma's own accumulation then spans 128 products only). A ring of S stages
// in shared memory is filled by cp.async; A's rows and B's k-rows are 144
// bytes apart (128 + 16), so the loads below are free of bank conflicts.
//
// The mma takes B with k contiguous for each column, and B lies with n
// contiguous; Hopper's ldmatrix transposes 16-bit elements only. So each
// 16-bit element is a pair of adjacent columns: ldmatrix.x4.trans over 32
// k-rows gives lane (g, t) two k-rows of columns 2g and 2g+1 per matrix, and
// two byte permutes split them into the 4-byte k-runs of column 2g (the "even"
// n8 tile) and of column 2g+1 (the "odd" tile). The k-runs a lane holds are
// k {2t, 2t+1, 2t+8, 2t+9} (+16), not the mma's {4t .. 4t+3}; A's fragments
// are read in the same permuted order, which leaves every sum over k intact.
// Output column 2j of the even tile and 2j+1 of the odd one sit side by side,
// so each lane ends with 4 adjacent columns of a row.
//
// When the output tiles cannot give every SM two blocks, K splits across
// blocks in whole groups and a second pass sums the partials in order.

#include "gemm_out.cuh"

namespace {

constexpr int kBK = 128;         // k-tile: one scale group
constexpr int kBN = 128;         // columns of a block
constexpr int kLD = kBK + 16;    // bytes between A rows in shared memory
constexpr int kLDB = kBN + 16;   // bytes between B k-rows in shared memory

struct Params {
  const uint8_t* a;        // [M, lda] e4m3
  const uint8_t* b;        // [K, N] e4m3 (+ expert * b_estride)
  const float* sa;         // [M, K/128]
  const float* sb;         // [K/128, sb_ld] (+ expert * sb_estride)
  const int* expert_ids;   // [M / block_rows] or null
  void* out;               // [M, N]
  float* partial;          // [split, M, N] when split > 1
  int M, N, K, lda;
  long long b_estride, sb_estride;
  int sb_ld, sb_div;
  float sb_mul;
  int block_rows, n_experts, out_kind, split, groups_per_split;
};

template <int BM, int WM, int WN, int S>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = kBN / WN / 8;
  static constexpr int A_BYTES = BM * kLD, B_BYTES = kBK * kLDB;
  static constexpr int SMEM = S * (A_BYTES + B_BYTES);
  static_assert(MT >= 1 && NT >= 2 && NT % 2 == 0, "warp tile of whole m16 and n16 steps");
};

// a0 / a2 of the permuted fragment: bytes {2t, 2t+1, 2t+8, 2t+9} of a row's 16
__device__ __forceinline__ uint32_t a_run(const uint8_t* row16, int t) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(row16 + 2 * t);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(row16 + 2 * t + 8);
  return lo | (hi << 16);
}

template <int BM, int WM, int WN, int S>
__global__ void __launch_bounds__(Tile<BM, WM, WN, S>::kThreads) blockwise_fp8_kernel(const Params p) {
  using T = Tile<BM, WM, WN, S>;
  constexpr int MT = T::MT, NT = T::NT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sa_t = smem;                   // [S][BM][kLD]
  uint8_t* sb_t = smem + S * T::A_BYTES;  // [S][kBK][kLDB]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const uint8_t* bw = p.b;
  const float* sbw = p.sb;
  if (p.expert_ids != nullptr) {  // an id outside [0, E) reads its nearest expert, never past the bank
    const long long e = min(max(p.expert_ids[m0 / p.block_rows], 0), p.n_experts - 1);
    bw += e * p.b_estride;
    sbw += e * p.sb_estride;
  }
  const int n_groups = p.K / kBK;
  const int g0 = blockIdx.z * p.groups_per_split;
  const int g1 = min(n_groups, g0 + p.groups_per_split);
  const int n_k = g1 - g0;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = (g0 + kt) * kBK;
    uint8_t* a_dst = sa_t + stage * T::A_BYTES;
    for (int c = tid; c < BM * (kBK / 16); c += T::kThreads) {
      const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const bool ok = m0 + r < p.M;
      skt::cp_async16(a_dst + r * kLD + kc, ok ? p.a + (long long)(m0 + r) * p.lda + k0 + kc : p.a, ok);
    }
    uint8_t* b_dst = sb_t + stage * T::B_BYTES;
    for (int c = tid; c < kBK * (kBN / 16); c += T::kThreads) {
      const int r = c / (kBN / 16), nc = (c % (kBN / 16)) * 16;
      skt::cp_async16(b_dst + r * kLDB + nc, bw + (long long)(k0 + r) * p.N + n0 + nc);
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
    skt::cp_async_commit();
  }

  const int row_base = m0 + wm * MT * 16;
  const int col_base = n0 + wn * NT * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    const int grp = g0 + kt;
    // this group's scales, fetched while the stage lands
    float s_a[MT][2], s_b[NT / 2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + i * 16 + g + 8 * h;
        s_a[i][h] = row < p.M ? p.sa[(long long)row * n_groups + grp] : 0.f;
      }
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s_b[j2][c] = sbw[(long long)grp * p.sb_ld + (col_base + j2 * 16 + 4 * t + c) / p.sb_div] * p.sb_mul;

    skt::cp_async_wait<S - 2>();  // stage kt has landed
    __syncthreads();                    // ... for every thread, and stage kt - 1 is consumed
    if (kt + S - 1 < n_k) load_stage(kt + S - 1, (kt + S - 1) % S);
    skt::cp_async_commit();
    const uint8_t* a_s = sa_t + (kt % S) * T::A_BYTES;
    const uint8_t* b_s = sb_t + (kt % S) * T::B_BYTES;

    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* r0 = a_s + (wm * MT * 16 + i * 16 + g) * kLD + ks * 32;
        const uint8_t* r1 = r0 + 8 * kLD;
        af[i][0] = a_run(r0, t);
        af[i][1] = a_run(r1, t);
        af[i][2] = a_run(r0 + 16, t);
        af[i][3] = a_run(r1 + 16, t);
      }
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t r[4];  // k-rows 0-7, 8-15, 16-23, 24-31 of the step, 16 columns
        skt::ldsm_x4_trans(r, b_s + (ks * 32 + lane) * kLDB + wn * NT * 8 + j2 * 16);
        const uint32_t e0 = __byte_perm(r[0], r[1], 0x6420), o0 = __byte_perm(r[0], r[1], 0x7531);
        const uint32_t e1 = __byte_perm(r[2], r[3], 0x6420), o1 = __byte_perm(r[2], r[3], 0x7531);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          skt::mma_e4m3(part[i][2 * j2], af[i], e0, e1);
          skt::mma_e4m3(part[i][2 * j2 + 1], af[i], o0, o1);
        }
      }
    }
    // promote: (even c0, odd c0, even c1, odd c1) are columns 4t + 0..3
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* ev = part[i][2 * j2];
          float* od = part[i][2 * j2 + 1];
          acc[i][2 * j2][2 * h] = fmaf(ev[2 * h], s_a[i][h] * s_b[j2][0], acc[i][2 * j2][2 * h]);
          acc[i][2 * j2 + 1][2 * h] = fmaf(od[2 * h], s_a[i][h] * s_b[j2][1], acc[i][2 * j2 + 1][2 * h]);
          acc[i][2 * j2][2 * h + 1] = fmaf(ev[2 * h + 1], s_a[i][h] * s_b[j2][2], acc[i][2 * j2][2 * h + 1]);
          acc[i][2 * j2 + 1][2 * h + 1] =
              fmaf(od[2 * h + 1], s_a[i][h] * s_b[j2][3], acc[i][2 * j2 + 1][2 * h + 1]);
        }
  }
  skt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_base + i * 16 + g + 8 * h;
      if (row >= p.M) continue;
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        const int col = col_base + j2 * 16 + 4 * t;
        const float v0 = acc[i][2 * j2][2 * h], v1 = acc[i][2 * j2 + 1][2 * h];
        const float v2 = acc[i][2 * j2][2 * h + 1], v3 = acc[i][2 * j2 + 1][2 * h + 1];
        if (p.split > 1)
          skt::store4(p.partial + (long long)blockIdx.z * p.M * p.N, skt::kOutF32, (long long)row * p.N + col, v0,
                      v1, v2, v3);
        else
          skt::store4(p.out, p.out_kind, (long long)row * p.N + col, v0, v1, v2, v3);
      }
    }
}

template <int BM, int WM, int WN, int S>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using T = Tile<BM, WM, WN, S>;
  auto kernel = blockwise_fp8_kernel<BM, WM, WN, S>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(p.N / kBN, (p.M + BM - 1) / BM, p.split);
  kernel<<<grid, T::kThreads, T::SMEM, st>>>(p);
  return cudaGetLastError();
}

}  // namespace

// a [M, lda] e4m3 (16-byte aligned rows); b [K, N] e4m3, or the expert bank
// [E, K, N] (b_estride = K * N, E = n_experts) with expert_ids [M / block_rows]; sa [M, K/128]
// float32; sb [K/128, sb_ld] float32 (sb_estride per expert), column n's
// scale sb[g, n / sb_div] * sb_mul; out [M, N] (out_kind 0 bf16, 1 f16, 2
// float32); with split > 1, partial [split, M, N] float32 holds each split's
// sum over its groups_per_split groups before the reduction into out.
// block_rows is the row tile: 16, 32, 64 or 128 (with expert_ids, the
// alignment block). K and N multiples of 128. Returns cudaGetLastError().
extern "C" int skt_fp8_blockwise_mm(const void* a, const void* b, const void* sa, const void* sb,
                                    const void* expert_ids, void* out, void* partial, int M, int N, int K, int lda,
                                    long long b_estride, long long sb_estride, int sb_ld, int sb_div, float sb_mul,
                                    int block_rows, int n_experts, int out_kind, int split, int groups_per_split,
                                    void* stream) {
  if (K % kBK || N % kBN || lda % 16 || split < 1 || (split > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  if (expert_ids != nullptr && (M % block_rows || n_experts < 1)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = (const uint8_t*)a;
  p.b = (const uint8_t*)b;
  p.sa = (const float*)sa;
  p.sb = (const float*)sb;
  p.expert_ids = (const int*)expert_ids;
  p.out = out;
  p.partial = (float*)partial;
  p.M = M, p.N = N, p.K = K, p.lda = lda;
  p.b_estride = b_estride, p.sb_estride = sb_estride;
  p.sb_ld = sb_ld, p.sb_div = sb_div, p.sb_mul = sb_mul;
  p.block_rows = block_rows, p.n_experts = n_experts, p.out_kind = out_kind, p.split = split;
  p.groups_per_split = groups_per_split;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (block_rows) {
    case 16: err = launch<16, 1, 4, 4>(p, st); break;
    case 32: err = launch<32, 2, 2, 4>(p, st); break;
    case 64: err = launch<64, 2, 2, 3>(p, st); break;
    case 128: err = launch<128, 4, 2, 3>(p, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)min((total + 255) / 256, (long long)4096);
  skt::split_k_reduce<<<blocks, 256, 0, st>>>((const float*)partial, out, out_kind, total, split);
  return (int)cudaGetLastError();
}
