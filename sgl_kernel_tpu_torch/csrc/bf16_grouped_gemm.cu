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
// Bound: bytes at decode, operations at prefill. At a B=16 decode step (bm
// 16) each valid row block holds a few tokens' rows of one expert and
// streams that expert's whole [K, N] bank once: DeepSeek-V2-Lite's gate_up
// (K 2048 -> N 2816) over ~51 of 64 experts is 0.59 GB, Mixtral-8x7B's (K
// 4096 -> N 28672) over ~8 of 8 is 1.9 GB, a few flops a byte. At prefill
// (bm 64 / 128, hundreds of rows an expert) the 2 * rows * K * N flops at
// 989 TFLOP/s bound it: wave A's DeepSeek gate_up (98,304 routed rows) is
// 1.13 TFLOP, 1.15 ms.
//
// Every block reads its expert id and *num_valid itself (the TPU's scalar
// prefetch becomes two loads a block); the grid covers every row block of
// cap, so the host never reads the valid count, and blocks past it return
// at once. The row tile equals the alignment block (16, 32, 64 or 128 rows),
// so a tile never spans two experts, and the bank is read as it lies (N
// contiguous), never transposed.
//
// Decode tiles (bm 16 / 32): mma.sync m16n8k16 with float32 accumulators.
// A block computes one (row tile, 64-column tile) over the whole K from a
// ring of S stages filled by cp.async (16 bytes a thread, zero-filled past K
// and N); A fragments by ldmatrix, B fragments by ldmatrix.trans. The ~8 to
// ~51 valid row blocks times N / 64 tiles give thousands of blocks over the
// 132 SMs, each with a few stages of 8 KB weight tiles in flight.
//
// Prefill tile (bm 64 / 128): Hopper's warpgroup MMA. A block is one
// producer warpgroup and one consumer warpgroup per 64 rows; its tile is
// bm x 256 over the whole K, in 64-deep stages of a four-stage ring in
// shared memory (48 KB a stage at bm 128), each operand in 128-byte-swizzled
// [64][64] sub-tiles (common.cuh). The producer brings the bank's [64][256]
// slice of a stage by TMA (four boxes of a 3-D map over the layer's [E, K,
// N] bank, coordinates (n, k, expert), zero-filled past K and N; the map is
// encoded once per bank and kept) and x's rows by cp.async; consumers run
// wgmma m64n256k16 with both operands in shared memory, B in its
// transpose-B form, and release each stage on an mbarrier once its group
// has completed. Blocks are ordered by an expert-aware raster (below): the
// row tiles of one expert, consecutive in x_sorted, take each column tile at
// about the same time, so an expert's bank is read from HBM about once.
// Tried and not kept (same tile, one call each, H100): a 128-column tile
// (64 flops a byte brought from L2 against 87); multicasting the bank's
// slice to a cluster of two row tiles of one expert (it halves the bank's
// L2 reads, yet its coupled ring ran slower); a persistent grid of one block
// an SM taking tiles from a counter (no gain beyond the spread between calls).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time

#include <map>
#include <mutex>
#include <tuple>

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

// ---- bm 64 / 128: the warpgroup MMA (wgmma) tile ----

constexpr int kSub = 64 * 128;  // bytes of one swizzled [64][64] bf16 sub-tile
constexpr int kWgBN = 256;      // columns of a tile: m64n256k16, 128 accumulators a thread
constexpr int kWgStages = 4;
constexpr int kGroupRows = 8;   // row tiles a raster group walks down each column tile

// BM rows (one consumer warpgroup per 64) and BN columns, 64-deep k steps
// (one 128-byte swizzled row), S stages, and a producer warpgroup. A stage
// is x's [BM][64] tile as BM / 64 sub-tiles, then the bank's [64][BN] tile
// as BN / 64 sub-tiles; after the ring, S "full" and S "empty" mbarriers.
template <int BM, int BN, int S>
struct WgTile {
  static constexpr int kConsumers = BM / 64;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int A_BYTES = kConsumers * kSub, B_BYTES = (BN / 64) * kSub, STAGE = A_BYTES + B_BYTES;
  static constexpr int SMEM = S * STAGE + 2 * S * 8 + 1024;  // + slack to start on a 1024-byte boundary
  static_assert((BM == 64 || BM == 128) && BN == 256 && S >= 2, "wgmma tile shape");
};

struct alignas(64) WgParams {
  CUtensorMap tm_w;  // the bank [E, K, N] as a 3-D map: boxes of 64 n x 64 k x 1 expert, 128-byte swizzle
  Params p;
};

template <int BM, int BN, int S>
__global__ void __launch_bounds__(WgTile<BM, BN, S>::kThreads, 1)
    bf16_grouped_wgmma_kernel(const __grid_constant__ WgParams wp) {
  using T = WgTile<BM, BN, S>;
  using skt::fence_regs;
  const Params& p = wp.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * T::STAGE);
  uint64_t* empty = full + S;

  // Expert-aware raster: consecutive blocks walk a group of kGroupRows row
  // tiles down one column tile, then the next column tile, so the row tiles
  // of one expert read each [K, BN] slice of its bank at about the same
  // time (one HBM read, the rest from L2) and the group's x panel stays in L2.
  const int m_tiles = p.M / BM, n_tiles = (p.N + BN - 1) / BN;
  const int span = kGroupRows * n_tiles, first = (blockIdx.x / span) * kGroupRows;
  const int rows = min(kGroupRows, m_tiles - first), in = blockIdx.x % span;
  const int mt = first + in % rows, n0 = (in / rows) * BN;
  if (mt >= *p.num_valid) return;  // the row tile is the alignment block: padding, nothing to do
  const int tid = threadIdx.x, n_k = (p.K + 63) / 64;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      skt::mbar_init(&full[s], 128 + 1);             // the producers' x arrivals + the bank's expect_tx
      skt::mbar_init(&empty[s], 4 * T::kConsumers);  // one arrival a consumer warp
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // Producer warpgroup. Thread 0 brings the bank's BN / 64 boxes of stage t
    // by TMA (zeros past K and N); all 128 copy x's [BM][64] tile by
    // cp.async (zero-filled past K) and, once their copies of stage t - 1
    // have landed, make them visible to the async proxy and arrive. A slot
    // is refilled once every consumer warp has released it.
    const bf16* xa = p.x + (long long)mt * BM * p.lda;
    const int e = p.expert_ids[mt];
    for (int t = 0; t < n_k; ++t) {
      const int s = t % S, k0 = t * 64;
      if (t >= S) skt::mbar_wait(&empty[s], ((t / S) - 1) & 1);
      uint8_t* sa = smem + s * T::STAGE;
      if (tid == 0) {
        skt::mbar_expect_tx(&full[s], T::B_BYTES);
#pragma unroll
        for (int j = 0; j < BN / 64; ++j)
          skt::tma_load_3d(sa + T::A_BYTES + j * kSub, &wp.tm_w, n0 + 64 * j, k0, e, &full[s]);
      }
#pragma unroll
      for (int i = 0; i < BM * 8 / 128; ++i) {
        const int c = i * 128 + tid, r = c / 8, ch = c % 8;
        const bool ok = k0 + ch * 8 < p.K;
        cp_async16(sa + (r / 64) * kSub + skt::sw128(r % 64, ch), xa + (long long)r * p.lda + (ok ? k0 + ch * 8 : 0),
                   ok);
      }
      cp_async_commit();
      if (t > 0) {
        cp_async_wait<1>();
        skt::fence_proxy_async();
        skt::mbar_arrive(&full[(t - 1) % S]);
      }
    }
    cp_async_wait<0>();
    skt::fence_proxy_async();
    skt::mbar_arrive(&full[(n_k - 1) % S]);
    return;
  }

  // Consumer warpgroups: wg takes rows 64 wg..64 wg + 63 of the tile. Stage
  // t's wgmma group runs while the wait for stage t + 1 and its issue
  // proceed; stage t - 1's slot is released once its group has completed.
  const int wg = tid / 128 - 1, lane = tid % 32;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const uint32_t base = skt::smem_u32(smem);
  for (int t = 0; t < n_k; ++t) {
    const int s = t % S;
    skt::mbar_wait(&full[s], (t / S) & 1);
    const uint32_t a_addr = base + s * T::STAGE + wg * kSub, b_addr = base + s * T::STAGE + T::A_BYTES;
    fence_regs(acc);
    skt::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 16 k a step: 32 bytes along A's rows, two 8-row groups (2 KB) of B
      skt::wgmma_m64n256k16_ss_tb(acc, skt::wgmma_desc(a_addr + kk * 32, 16, 1024),
                                  skt::wgmma_desc(b_addr + kk * 2048, kSub, 1024));
    skt::wgmma_commit();
    skt::wgmma_wait<1>();
    fence_regs(acc);
    // release stage t - 1 where a producer will wait for it
    if (t > 0 && t - 1 + S < n_k && lane == 0) skt::mbar_arrive(&empty[(t - 1) % S]);
  }
  skt::wgmma_wait<0>();
  fence_regs(acc);

  // thread i of consumer warpgroup wg: rows 64 wg + 16 (i / 32) + (i % 32) / 4 (+8)
  const long long row = (long long)mt * BM + wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane % 4);
    if (col >= p.N) continue;  // N % 8 == 0: a pair is wholly in or out
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long idx = (row + 8 * h) * p.N + col;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (p.out_f32)
        *reinterpret_cast<float2*>(reinterpret_cast<float*>(p.out) + idx) = make_float2(v0, v1);
      else
        *reinterpret_cast<__nv_bfloat162*>(reinterpret_cast<bf16*>(p.out) + idx) = __floats2bfloat162_rn(v0, v1);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The bank's tensor map, encoded once per (pointer, E, K, N) and kept: a
// bank is one layer's weights, the same pointer call after call, so no map
// is encoded on the host per call once the model has run a step.
bool bank_map(CUtensorMap* tm, const void* w, int n_experts, int K, int N) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, int>, CUtensorMap> cache;
  static EncodeTiled encode = nullptr;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(w, n_experts, K, N);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *tm = hit->second;
    return true;
  }
  if (!encode) {  // cuTensorMapEncodeTiled through the runtime's entry-point query (no link against libcuda)
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)K, (cuuint64_t)n_experts};
  const cuuint64_t strides[2] = {(cuuint64_t)N * 2, (cuuint64_t)K * N * 2};
  const cuuint32_t box[3] = {64, 64, 1}, elem_strides[3] = {1, 1, 1};
  if (encode(tm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();  // banks freed and made anew; never more than a few hundred live
  cache.emplace(key, *tm);
  return true;
}

template <int BM>
cudaError_t launch_wgmma(const Params& p, int n_experts, cudaStream_t st) {
  using T = WgTile<BM, kWgBN, kWgStages>;
  auto kernel = bf16_grouped_wgmma_kernel<BM, kWgBN, kWgStages>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  WgParams wp;
  wp.p = p;
  if (!bank_map(&wp.tm_w, p.w, n_experts, p.K, p.N)) return cudaErrorInvalidValue;
  const long long blocks = (long long)(p.M / BM) * ((p.N + kWgBN - 1) / kWgBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, T::kThreads, T::SMEM, st>>>(wp);
  return cudaGetLastError();
}

}  // namespace

// x [M, lda] bf16; w [E, K, N] bf16 (w_estride = K * N elements, n_experts
// = E); expert_ids [M / block_rows] int32; num_valid [] int32 on the device;
// out [M, N] bf16 or float32 (out_f32). block_rows is the alignment block:
// 16, 32, 64 or 128 (the row tile). K and N multiples of 8, x's rows and w
// 16-byte aligned. Returns cudaGetLastError() after the launch.
extern "C" int skt_bf16_grouped_mm(const void* x, const void* w, const void* expert_ids, const void* num_valid,
                                   void* out, int M, int N, int K, int lda, int block_rows, long long w_estride,
                                   int n_experts, int out_f32, void* stream) {
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
    case 64: return (int)launch_wgmma<64>(p, n_experts, st);
    case 128: return (int)launch_wgmma<128>(p, n_experts, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
