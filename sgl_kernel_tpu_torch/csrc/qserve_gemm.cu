// K19: QServe W4A8 GEMM with progressive per-group dequantization.
//
// Replaces qserve_w4a8_per_group_gemm (sgl_kernel_tpu/ops/gemm/qserve.py:61,
// Pallas kernel _per_group_kernel :34, pallas_call at :102). Contract: A
// [M, K] int8 (row-major), W [N, K] uint4 codes one a byte (K contiguous),
// s2 and zs2 [N, K/G] float32 (the group scale and zero * scale), ascales
// [M] and wscales [N] float32:
//
//   W8[n, k] = bf16(code * s2[n, k/G] - zs2[n, k/G])     (product and
//              difference each rounded in float32, then one bf16 rounding)
//   out[m, n] = (sum_k A[m, k] * W8[n, k]) * ascales[m] * wscales[n]
//
// as the TPU kernel rounds it (qserve.py:46-51), float32 sums, the output
// rounded once to f16, bf16 or float32. int8 values are exact in bf16.
//
// Bound: bytes at decode. Llama-3-8B's gate_up at M=16 streams 117 MB of
// one-byte codes for 3.8 GFLOP.
//
// Design: one block per 128-column tile of BM rows (16, 32, 64 or 128) and a
// range of 128-deep k-tiles. A ring of S stages in shared memory is filled
// by cp.async with the raw bytes (A's int8 rows and W's code rows, 144 bytes
// apart, so every fragment read below is free of bank conflicts), and the
// fragments are made in registers: a lane reads 4 consecutive bytes of a row
// (k 4t .. 4t+3 of a 16-deep step) and hands them to the mma.sync m16n8k16
// bf16 tile as its k {2t, 2t+1} and {2t+8, 2t+9} pairs; A and W use the same
// order, so every sum over k is intact. W's bytes are dequantized right there
// with the lane's group scales, loaded once a k-tile; the k-tile holds 1, 2
// or 4 groups (G 128, 64 or 32). Past K the bytes are zero. When the output
// tiles cannot give every SM two blocks, K splits across blocks in whole
// k-tiles; each split's partial is scaled and a second pass sums them.

#include "gemm_out.cuh"

namespace {

constexpr int kBK = 128;
constexpr int kBN = 128;
constexpr int kLD = kBK + 16;  // bytes between rows in shared memory

struct Params {
  const int8_t* a;    // [M, K]
  const uint8_t* w;   // [N, K]
  const float* s2;    // [N, K/G]
  const float* zs2;   // [N, K/G]
  const float* as;    // [M]
  const float* ws;    // [N]
  void* out;          // [M, N]
  float* partial;     // [split, M, N] when split > 1
  int M, N, K, G, out_kind, split, tiles_per_split;
};

template <int BM, int WM, int WN, int S>
struct Tile {
  static constexpr int kThreads = WM * WN * 32;
  static constexpr int MT = BM / WM / 16, NT = kBN / WN / 8;
  static constexpr int A_BYTES = BM * kLD, W_BYTES = kBN * kLD;
  static constexpr int SMEM = S * (A_BYTES + W_BYTES);
  static_assert(MT >= 1 && NT >= 1, "warp tile of whole m16 and n8 steps");
};

// 4 int8 at bits 0-31 -> bf16 pairs (bytes 0, 1) and (bytes 2, 3)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t x, uint32_t& lo, uint32_t& hi) {
  const float v0 = (float)(int8_t)(x & 0xFFu), v1 = (float)(int8_t)((x >> 8) & 0xFFu);
  const float v2 = (float)(int8_t)((x >> 16) & 0xFFu), v3 = (float)(int8_t)(x >> 24);
  lo = skt::pack_bf16x2(v0, v1);
  hi = skt::pack_bf16x2(v2, v3);
}

__device__ __forceinline__ float w8(uint32_t code, float s, float z) {
  return __fsub_rn(__fmul_rn((float)code, s), z);  // no contraction: JAX rounds the product first
}

template <int BM, int WM, int WN, int S, int GPT>
__global__ void __launch_bounds__(Tile<BM, WM, WN, S>::kThreads) qserve_kernel(const Params p) {
  using T = Tile<BM, WM, WN, S>;
  constexpr int MT = T::MT, NT = T::NT;
  constexpr int STEPS_PER_GROUP = kBK / 16 / GPT;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* sa_t = smem;                   // [S][BM][kLD]
  uint8_t* sw_t = smem + S * T::A_BYTES;  // [S][kBN][kLD]

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int n_tiles = (p.K + kBK - 1) / kBK;
  const int t0 = blockIdx.z * p.tiles_per_split;
  const int n_k = min(n_tiles, t0 + p.tiles_per_split) - t0;
  const int n_groups = p.K / p.G;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;

  auto load_stage = [&](int kt, int stage) {
    const int k0 = (t0 + kt) * kBK;
    uint8_t* a_dst = sa_t + stage * T::A_BYTES;
    for (int c = tid; c < BM * (kBK / 16); c += T::kThreads) {
      const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const bool ok = m0 + r < p.M && k0 + kc < p.K;
      skt::cp_async16(a_dst + r * kLD + kc, ok ? p.a + (long long)(m0 + r) * p.K + k0 + kc : p.a, ok);
    }
    uint8_t* w_dst = sw_t + stage * T::W_BYTES;
    for (int c = tid; c < kBN * (kBK / 16); c += T::kThreads) {
      const int r = c / (kBK / 16), kc = (c % (kBK / 16)) * 16;
      const bool ok = n0 + r < p.N && k0 + kc < p.K;
      skt::cp_async16(w_dst + r * kLD + kc, ok ? p.w + (long long)(n0 + r) * p.K + k0 + kc : p.w, ok);
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

  const int wrow = wm * MT * 16, wcol = wn * NT * 8;
  for (int kt = 0; kt < n_k; ++kt) {
    // the lane's column of each n8 tile: its groups' scales, fetched while the stage lands
    float sc[NT][GPT], zc[NT][GPT];
    const int grp0 = (t0 + kt) * GPT;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wcol + j * 8 + g;
#pragma unroll
      for (int q = 0; q < GPT; ++q) {
        const bool ok = n < p.N && grp0 + q < n_groups;
        sc[j][q] = ok ? p.s2[(long long)n * n_groups + grp0 + q] : 0.f;
        zc[j][q] = ok ? p.zs2[(long long)n * n_groups + grp0 + q] : 0.f;
      }
    }
    skt::cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < n_k) load_stage(kt + S - 1, (kt + S - 1) % S);
    skt::cp_async_commit();
    const uint8_t* a_s = sa_t + (kt % S) * T::A_BYTES;
    const uint8_t* w_s = sw_t + (kt % S) * T::W_BYTES;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int q = ks / STEPS_PER_GROUP;
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const uint8_t* r0 = a_s + (wrow + i * 16 + g) * kLD + ks * 16 + 4 * t;
        int8x4_to_bf16(*reinterpret_cast<const uint32_t*>(r0), af[i][0], af[i][2]);
        int8x4_to_bf16(*reinterpret_cast<const uint32_t*>(r0 + 8 * kLD), af[i][1], af[i][3]);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t c = *reinterpret_cast<const uint32_t*>(w_s + (wcol + j * 8 + g) * kLD + ks * 16 + 4 * t);
        const float s = sc[j][q], z = zc[j][q];
        const uint32_t b0 = skt::pack_bf16x2(w8(c & 0xFFu, s, z), w8((c >> 8) & 0xFFu, s, z));
        const uint32_t b1 = skt::pack_bf16x2(w8((c >> 16) & 0xFFu, s, z), w8(c >> 24, s, z));
#pragma unroll
        for (int i = 0; i < MT; ++i) skt::mma_bf16(acc[i][j], af[i], b0, b1);
      }
    }
  }
  skt::cp_async_wait<0>();

  void* dst = p.split > 1 ? (void*)(p.partial + (long long)blockIdx.z * p.M * p.N) : p.out;
  const int kind = p.split > 1 ? skt::kOutF32 : p.out_kind;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wrow + i * 16 + g + 8 * h;
      if (row >= p.M) continue;
      const float sa = p.as[row];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + wcol + j * 8 + 2 * t + e;
          if (col < p.N) skt::store1(dst, kind, (long long)row * p.N + col, acc[i][j][2 * h + e] * sa * p.ws[col]);
        }
    }
}

template <int BM, int WM, int WN, int S, int GPT>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using T = Tile<BM, WM, WN, S>;
  auto kernel = qserve_kernel<BM, WM, WN, S, GPT>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid((p.N + kBN - 1) / kBN, (p.M + BM - 1) / BM, p.split);
  kernel<<<grid, T::kThreads, T::SMEM, st>>>(p);
  return cudaGetLastError();
}

template <int GPT>
cudaError_t launch_rows(const Params& p, int block_rows, cudaStream_t st) {
  switch (block_rows) {
    case 16: return launch<16, 1, 4, 4, GPT>(p, st);
    case 32: return launch<32, 2, 2, 4, GPT>(p, st);
    case 64: return launch<64, 2, 2, 3, GPT>(p, st);
    case 128: return launch<128, 4, 2, 3, GPT>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// a [M, K] int8; w [N, K] uint8 codes; s2 / zs2 [N, K/G] float32; ascales
// [M], wscales [N] float32; out [M, N] (out_kind 0 bf16, 1 f16, 2 float32);
// with split > 1, partial [split, M, N] float32 holds each split's scaled sum
// over its tiles_per_split k-tiles of 128 before the reduction into out.
// G 32, 64 or 128; K a multiple of 16 and of G; a and w 16-byte aligned.
// block_rows (16, 32, 64 or 128) is the row tile. Returns cudaGetLastError().
extern "C" int skt_qserve_w4a8_per_group(const void* a, const void* w, const void* s2, const void* zs2,
                                         const void* ascales, const void* wscales, void* out, void* partial, int M,
                                         int N, int K, int G, int block_rows, int out_kind, int split,
                                         int tiles_per_split, void* stream) {
  if (K % 16 || K % G || split < 1 || (split > 1 && partial == nullptr)) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = (const int8_t*)a;
  p.w = (const uint8_t*)w;
  p.s2 = (const float*)s2;
  p.zs2 = (const float*)zs2;
  p.as = (const float*)ascales;
  p.ws = (const float*)wscales;
  p.out = out;
  p.partial = (float*)partial;
  p.M = M, p.N = N, p.K = K, p.G = G, p.out_kind = out_kind, p.split = split, p.tiles_per_split = tiles_per_split;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (G) {
    case 128: err = launch_rows<1>(p, block_rows, st); break;
    case 64: err = launch_rows<2>(p, block_rows, st); break;
    case 32: err = launch_rows<4>(p, block_rows, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)M * N;
  const int blocks = (int)min((total + 255) / 256, (long long)4096);
  skt::split_k_reduce<<<blocks, 256, 0, st>>>((const float*)partial, out, out_kind, total, split);
  return (int)cudaGetLastError();
}
