// K1 at M > 32 and K11 at bm 64 / 128: the W4A16 GEMM on wgmma, one tile
// for both, out[M,N] = prologue(A)[M,K] @ dequant(W)[K,N] (+bias) (+residual).
//
// Replaces w4a16_gemm (sgl_kernel_tpu/ops/gemm/w4a16.py:301, Pallas kernels
// _kernel / _kernel_inner, pallas_call at :539 and :551) for prefill rows,
// and w4a16_grouped_mm (sgl_kernel_tpu/ops/moe/grouped_gemm.py:259,
// pallas_call at :419) at row blocks of 64 and 128. The contract and the
// rounding points are w4a16_gemm.cu's: W uint8 [K/2, N] with rows 2r (low
// nibble) and 2r+1 (high) in byte (r, n), int4 or e2m1 (mxfp4) codes,
// scales [K/G, N], zeros the z*s pre-product; the prologue's result
// (rmsnorm, or silu(a) * a2) rounded to bf16 before the product, each
// group's partial product in float32 scaled per column, zeros subtracting
// sum_k(a_g) * (z*s), bias and residual added in float32 before the one
// cast. K11 takes a bank [E, K/2, N] (a stacked bank's layer by pointer
// offset) with one expert a row block of block_rows rows.
//
// Bound: operations. A 1,024-row Llama-3-8B gate_up is 240 GFLOP over 128
// MB of codes, scales, activations and output (1,900 flops a byte, the
// card's balance point being ~295); a 128-row block of an expert does 256
// flops a 4-bit code. The tile's work is the tensor cores' and the codes'
// decoding.
//
// Design. The product is taken transposed, out^T = W^T A^T, on wgmma
// m64nBMk16 bf16 with float32 sums: the weights are wgmma's M, decoded from
// the code bytes straight into A fragments in registers, and BM activation
// rows are its N, read by descriptor from 128-byte-swizzled TMA stages,
// K-major as [M, K] lies. A block is two warpgroups (eight warps, so a
// thread may hold 255 registers; a ninth, producer warp capped them at 168
// and spilled): 128 rows by 128 columns, a warpgroup 64 columns (one m64
// tile), or, for 64-row tiles (K1 up to 64 rows, K11 at bm 64), 64 rows by
// 256 columns, a warpgroup two m64 tiles. Either way a thread holds 64
// accumulators; at 128 rows each decoded code feeds twice the products.
// Thread 0 also keeps the ring of 128-deep stages full (five or six, by
// TMA behind mbarriers: [64 packed rows][128 columns] code boxes through a
// 3-D map over [E, K/2, N] with the expert a coordinate, two [BM rows][64
// k] activation boxes; 128-byte swizzled, zero-filled past N and M; maps
// encoded once per pointer and shape and kept), refilling a slot one stage
// after the warps released it, so the two warpgroups may run a stage apart.
// K11's K may end in half a stage (gpt-oss's 2,880 = 22 x 128 + 64, groups
// of 32): the maps span the true K, the last stage brings its first
// activation box and a code box whose rows past K/2 TMA zero-fills, and the
// warps run its first four k16 steps only, so no scale past K/G is read.
//
// Codes to fragments without a k permutation. A fragment register of row r
// holds k (2t, 2t+1) or (2t+8, 2t+9) of a k16 step: the two nibbles of one
// code byte, packed row t or t+4. The wgmma row a lane holds is free to
// stand for any column, so lane (g, t) of warp w takes its rows g and g+8
// of each m64 tile as adjacent columns: one 16- or 32-bit word of packed
// row t and one of row t+4 give its registers, each one byte permute, one
// and-xor and one bf16x2 fma (int4_pair; mxfp4_pair for e2m1). The words a
// load reads lie in distinct banks under the swizzle.
//
// Group scaling. Each scale group's product runs in its own accumulators
// (scale-d 0 at the group's first step) and is then added into the total
// times the lane's columns' scales (and, with zeros, less the rows'
// activation sums times z*s). Two such sets alternate by group parity: a
// group's set is promoted one step into the next group, once its wgmmas
// have completed, while the next group's run on the other. The group's
// scales are read from device memory at its first step. Two fragment sets
// alternate too, so a step's codes decode while the last step's wgmmas run.
//
// Rows pass. A prologue (norm, silu_mul), activations TMA cannot map
// (unaligned rows) and zeros (which need each group's activation sums) take
// a first small kernel, one block a row: it writes the prologue's bf16 rows,
// zero past the true K, and the sums of every group as [K/G][M] float32
// (M rounded up to 128). Without them the tile reads A itself: one launch
// a call.
//
// Grid. Blocks walk an expert-aware raster (8 row tiles down each column
// tile). K11's grid covers every row tile of cap: a block whose row block
// is at or past *num_valid returns before any load, so the host reads
// nothing. K1's K splits over blocks (blockIdx.y) where the tiles cannot
// give every SM a block: each writes its float32 partial to a workspace
// and the last block of a tile to arrive (a counter it resets) sums them in
// split order (its own from its registers, each split's rows loaded at
// once), adds bias and residual and stores; one launch, the same bits call
// after call. The splits never make a second wave of blocks. ops/gemm/w4a16.py's wgmma_plan is the tile choice and
// the split in plain Python.
//
// What holds it (H100, variants of this file timed in turns): at 128 rows
// the feed, then the decode. With the codes and activations of the first
// stages reused (no further TMA) a 1,024-row gate_up runs 0.47 ms against
// 0.61, and also without the decode 0.41; tools/wgmma_probe.py's loop of
// register-A wgmmas reaches 99.6 % of the bf16 peak with held fragments
// and 55 % decoding two n64 tiles' fragments a step. Not kept (slower in
// turns): a producer warp (168 registers: spills) or a producer warpgroup
// with setmaxnreg (ptxas still allocates 168), two steps in flight with
// four fragment sets, multicasting the activations to a cluster of two
// blocks, reading the next step's codes after the wgmmas issue.

#include "gemm_out.cuh"
#include "tma_map.cuh"
#include "w4a16_tile.cuh"

namespace {

namespace w4g {

constexpr int kBK = 128;                     // k of a stage
constexpr int kThreads = 256;                // two warpgroups, eight warps: up to 255 registers a thread
constexpr int kWBox = (kBK / 2) * 128;       // a code box: 64 packed rows x 128 columns
constexpr int kGroupRows = 8;                // row tiles a raster group walks down each column tile
constexpr int kMaxSmem = 232448;             // dynamic shared memory a block may take

// BM activation rows a block (wgmma's N: 64 or 128); each warpgroup holds
// MT = 128 / BM m64 tiles of weight columns, so its accumulators are 64
// floats a thread at either BM; a block is BN = 128 MT columns, MT code
// boxes a stage, then two [BM][64 k] activation boxes.
template <int BM>
struct Cfg {
  static constexpr int MT = 128 / BM, BN = 128 * MT, kABox = BM * 128;
  static constexpr int STAGE = MT * kWBox + 2 * kABox;
  static constexpr int S = (kMaxSmem - 1024 - 256) / STAGE < 6 ? (kMaxSmem - 1024 - 256) / STAGE : 6;
  static constexpr int SMEM = 1024 + S * STAGE + 2 * S * 8 + 16;  // + slack to a 1024-byte boundary
  static_assert(BM == 64 || BM == 128, "row tiles");
  static_assert(S >= 4 && SMEM <= kMaxSmem, "stages");
};

struct Params {
  const bf16* scales;      // [K/G, N] (+ expert * s_estride), group stride s_gstride (0: per channel)
  const bf16* zeros;       // the same layout, or null
  const float* asum;       // [K/G][ld_sum] each group's activation sums (zeros only)
  const float* bias;       // [N] or null
  const bf16* residual;    // [M, N] or null
  void* out;               // [M, N]
  float* ws;               // [split, M, N] float32 partials when split > 1
  int* counters;           // [tiles] arrivals, zero between calls
  const int* expert_ids;   // grouped: [M / block_rows], else null
  const int* num_valid;    // grouped: the valid row blocks
  long long s_estride, s_gstride;
  int M, N, K, n_experts, block_rows, ld_sum, out_kind, split, stages_per_split;
};

struct alignas(64) KParams {
  CUtensorMap tm_w;  // codes [E][K/2][N] bytes: boxes of 128 n x 64 rows x 1 expert, 128-byte swizzle
  CUtensorMap tm_a;  // activations [M][lda] bf16: boxes of 64 k x BM rows, 128-byte swizzle
  Params p;
};

// byte j of x as a nibble pair for int4_pair / mxfp4_pair: its low nibble
// at bits 0-3, its high nibble (byte j of xs = x >> 4) at bits 16-19
__device__ __forceinline__ uint32_t nib(uint32_t x, uint32_t xs, int j) {
  return __byte_perm(x, xs, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
}

template <bool MX>
__device__ __forceinline__ uint32_t dec(uint32_t v) {
  return MX ? mxfp4_pair(v) : int4_pair(v);
}

// the n bf16 at q (2n-byte aligned) as floats
template <int N>
__device__ __forceinline__ void ldn(const bf16* q, float (&v)[N]) {
  static_assert(N == 2 || N == 4, "two or four columns");
  if constexpr (N == 4) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(q));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&r.y);
    v[0] = __low2float(a), v[1] = __high2float(a), v[2] = __low2float(b), v[3] = __high2float(b);
  } else {
    const unsigned int r = __ldg(reinterpret_cast<const unsigned int*>(q));
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&r);
    v[0] = __low2float(a), v[1] = __high2float(a);
  }
}

// n adjacent outputs of row m from column col (a multiple of n): bias,
// residual, the cast
template <int N>
__device__ __forceinline__ void store_cols(const Params& p, int m, int col, float (&v)[N]) {
  const long long o = (long long)m * p.N + col;
  if (p.bias) {
#pragma unroll
    for (int x = 0; x < N; x += 2) {
      const float2 b = __ldg(reinterpret_cast<const float2*>(p.bias + col + x));
      v[x] += b.x, v[x + 1] += b.y;
    }
  }
  if (p.residual) {
    float r[N];
    ldn<N>(p.residual + o, r);
#pragma unroll
    for (int x = 0; x < N; ++x) v[x] += r[x];
  }
#pragma unroll
  for (int x = 0; x < N; x += 2) skt::store2(p.out, p.out_kind, o + x, v[x], v[x + 1]);
}

#define W4G_F8(d, o)                                                                                          \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), \
      "+f"(d[o + 7])

// d (64 x BM, float32) = (scale_d ? d : 0) + A (64 x 16) * B (16 x BM),
// bf16: A from registers in mma.sync's m16k16 A fragment layout (warp w
// rows 16w..16w+15), B from shared memory K-major ([n][k]); d[4j + e] at
// row 16w + g + 8 (e >> 1), column 8j + 2t + (e & 1)
template <int BM>
__device__ __forceinline__ void wgmma_rs(float (&d)[BM / 2], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  if constexpr (BM == 64) {
    skt::wgmma_m64n64k16_rs<false>(d, a, db, scale_d);
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : W4G_F8(d, 0), W4G_F8(d, 8), W4G_F8(d, 16), W4G_F8(d, 24), W4G_F8(d, 32), W4G_F8(d, 40), W4G_F8(d, 48),
          W4G_F8(d, 56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
}

#undef W4G_F8

// The lane's fragment registers of one k16 step from its code words of
// packed rows t (x0) and t + 4 (x1): tile m's rows g and g + 8 are the
// words' bytes 2m and 2m + 1
template <int MT, bool MX>
__device__ __forceinline__ void decode(uint32_t (&f)[MT][4], uint32_t x0, uint32_t x1) {
  const uint32_t y0 = x0 >> 4, y1 = x1 >> 4;
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    f[m][0] = dec<MX>(nib(x0, y0, 2 * m));
    f[m][1] = dec<MX>(nib(x0, y0, 2 * m + 1));
    f[m][2] = dec<MX>(nib(x1, y1, 2 * m));
    f[m][3] = dec<MX>(nib(x1, y1, 2 * m + 1));
  }
}

// acc += pt * (the lane's columns' scales s) [- asum * z]: pt[m][4j + 2h +
// x] is column 2m + h of the lane's, row 8j + 2t + x; sums points at row
// 2t of the group's activation sums (zeros only)
template <int BM, int MT, bool ZR>
__device__ __forceinline__ void promote(float (&acc)[MT][BM / 2], float (&pt)[MT][BM / 2], const float (&s)[2 * MT],
                                        const float (&z)[2 * MT], const float* sums) {
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) {
    float2 as = make_float2(0.f, 0.f);
    if (ZR) as = __ldg(reinterpret_cast<const float2*>(sums + 8 * j));
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          float& a = acc[m][4 * j + 2 * h + x];
          a += pt[m][4 * j + 2 * h + x] * s[2 * m + h];
          if (ZR) a -= (x ? as.y : as.x) * z[2 * m + h];
        }
  }
}

template <int G, int BM, bool MX, bool ZR>
__global__ void __launch_bounds__(kThreads, 1) w4a16_wgmma_kernel(const __grid_constant__ KParams kp) {
  using C = Cfg<BM>;
  constexpr int MT = C::MT, BN = C::BN, S = C::S, NC = 2 * MT;  // NC: the lane's columns
  constexpr int KPG = G / 16;             // k16 steps a group
  constexpr int kPair = 2 * kBK / 16;     // the steps of two stages: a group's parity is a constant of the step
  const Params& p = kp.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * C::STAGE);
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);

  // the raster: blockIdx.x -> (row tile, column tile)
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = (p.N + BN - 1) / BN;
  const int span = kGroupRows * n_tiles, first = (blockIdx.x / span) * kGroupRows;
  const int rows = min(kGroupRows, m_tiles - first), in = blockIdx.x % span;
  const int mt = first + in % rows, nt = in / rows;
  const int m0 = mt * BM, n0 = nt * BN;
  int e = 0;
  if (p.expert_ids != nullptr) {  // grouped: the row block's expert; padding blocks do nothing
    const int blk = m0 / p.block_rows;
    if (blk >= *p.num_valid) return;
    e = min(max(p.expert_ids[blk], 0), p.n_experts - 1);
  }
  const int s0 = blockIdx.y * p.stages_per_split;
  const int n_k = min((p.K + kBK - 1) / kBK, s0 + p.stages_per_split) - s0;  // stages, the last maybe half
  const int n_q = min(p.K, (s0 + p.stages_per_split) * kBK) / 16 - s0 * (kBK / 16);  // k16 steps
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Thread 0 is also the producer: stage s0 + i into slot i % S, a code
  // box wholly past N not fetched (its columns are never stored)
  const int boxes = min(MT, (p.N - n0 + 127) / 128);
  auto fetch = [&](int i) {
    const int s = i % S, k = (s0 + i) * kBK;
    const bool whole = k + kBK <= p.K;  // else half a stage: no second activation box
    uint8_t* st = ring + s * C::STAGE;
    skt::mbar_expect_tx(&full[s], boxes * kWBox + (whole ? 2 : 1) * C::kABox);
    for (int b = 0; b < boxes; ++b) skt::tma_load_3d(st + b * kWBox, &kp.tm_w, n0 + 128 * b, k / 2, e, &full[s]);
    skt::tma_load_2d(st + MT * kWBox, &kp.tm_a, k, m0, &full[s]);
    if (whole) skt::tma_load_2d(st + MT * kWBox + C::kABox, &kp.tm_a, k + 64, m0, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      skt::mbar_init(&full[s], 1);                // the producer's expect_tx
      skt::mbar_init(&empty[s], kThreads / 32);  // each warp, once its wgmmas on the stage completed
    }
    skt::mbar_init_fence();
    for (int i = 0; i < min(S, n_k); ++i) fetch(i);
  }
  __syncthreads();

  // Warpgroup wg holds columns n0 + 64 MT wg ..; lane (g, t) of warp w its
  // rows g, g+8 of each m64 tile as NC adjacent columns of the code box:
  // MT 2, a word, chunk w + 4 (g >> 2) of warpgroup wg's box; MT 1, a
  // halfword, chunk 4 wg + w of the block's one box. Either way the lanes
  // of a load touch distinct banks under the swizzle.
  const int wg = warp / 4, w = warp % 4, g = lane >> 2, t = lane & 3;
  const int chunk = MT == 2 ? w + 4 * (g >> 2) : 4 * wg + w;
  const int cbyte = MT == 2 ? 4 * (g & 3) : 2 * g;                     // in the chunk
  const int col = n0 + (MT == 2 ? 128 * wg : 0) + 16 * chunk + cbyte;  // the first of the lane's columns
  const bool cols_in = col < p.N;
  const uint8_t* wbox = ring + (MT == 2 ? wg * kWBox : 0);
  const int off0 = t * 128 + ((chunk ^ t) << 4) + cbyte;              // packed row t of step 0
  const int off1 = (t + 4) * 128 + ((chunk ^ (t + 4)) << 4) + cbyte;  // packed row t + 4
  auto word = [&](int at) -> uint32_t {
    if constexpr (MT == 2) return *reinterpret_cast<const uint32_t*>(wbox + at);
    else return *reinterpret_cast<const uint16_t*>(wbox + at);
  };
  const uint32_t a_base = skt::smem_u32(ring + MT * kWBox);
  const bf16* sp = p.scales + e * p.s_estride + col;
  const bf16* zp = ZR ? p.zeros + e * p.s_estride + col : nullptr;
  const float* sums = ZR ? p.asum + m0 + 2 * t : nullptr;  // + group * ld_sum

  // Each group's product runs in part[its parity] and is added into acc
  // one step into the next group, once its wgmmas have completed, while
  // the next group's run on the other set.
  float acc[MT][BM / 2], part[2][MT][BM / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int x = 0; x < BM / 2; ++x) acc[m][x] = 0.f, part[0][m][x] = 0.f, part[1][m][x] = 0.f;
  uint32_t fr[2][MT][4];  // two fragment sets: a step decodes while the last step's wgmmas run
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int x = 0; x < 4; ++x) fr[b][m][x] = 0u;
  float sc[2][NC] = {}, zc[2][NC] = {};
  const long long g0 = (long long)s0 * kBK / G;  // the split's first group

  skt::mbar_wait(&full[0], 0);
  uint32_t x0 = word(off0), x1 = word(off1);
  for (int i0 = 0; i0 < n_k; i0 += 2) {
#pragma unroll
    for (int q = 0; q < kPair; ++q) {
      const int i = i0 + q / 8, kk = q % 8, par = (q / KPG) & 1;
      if (i * (kBK / 16) + kk >= n_q) break;
      const int s = i % S;
      const long long gi = g0 + ((long long)i * kBK + kk * 16) / G;  // this step's group
      if (kk % KPG == 0 && cols_in) {  // a new group: its scales, used at its promotion
        ldn<NC>(sp + gi * p.s_gstride, sc[par]);
        if (ZR) ldn<NC>(zp + gi * p.s_gstride, zc[par]);
      }
      uint32_t(&f)[MT][4] = fr[q & 1];
      decode<MT, MX>(f, x0, x1);
      // the next step's code words, read before this step's wgmmas issue
      if (kk < 7) {
        x0 = word(s * C::STAGE + (kk + 1) * 1024 + off0);
        x1 = word(s * C::STAGE + (kk + 1) * 1024 + off1);
      } else if (i + 1 < n_k) {
        const int s1 = (i + 1) % S;
        skt::mbar_wait(&full[s1], ((i + 1) / S) & 1);
        x0 = word(s1 * C::STAGE + off0);
        x1 = word(s1 * C::STAGE + off1);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        skt::fence_regs(f[m]);
        skt::fence_regs(part[par][m]);
      }
      skt::wgmma_fence();
      const uint64_t desc = skt::wgmma_desc(a_base + s * C::STAGE + (kk >> 2) * C::kABox + (kk & 3) * 32, 16, 1024);
#pragma unroll
      for (int m = 0; m < MT; ++m) wgmma_rs<BM>(part[par][m], f[m], desc, kk % KPG != 0);
      skt::wgmma_commit();
      skt::wgmma_wait<1>();  // every step but this one has completed
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        skt::fence_regs(part[par ^ 1][m]);
        skt::fence_regs(fr[(q + 1) & 1][m]);
      }
      // one step into a group the last one's product is complete: promote it
      if (kk % KPG == 0 && i * (kBK / 16) + kk >= KPG)
        promote<BM, MT, ZR>(acc, part[par ^ 1], sc[par ^ 1], zc[par ^ 1], ZR ? sums + (gi - 1) * p.ld_sum : nullptr);
      // and the last stage's wgmmas too: release its slot; thread 0 refills
      // the slot released a stage earlier (lag two: the warpgroups may run
      // up to a stage apart without waiting for each other)
      if (kk == 0 && i > 0) {
        __syncwarp();
        if (lane == 0) skt::mbar_arrive(&empty[(i - 1) % S]);
        if (tid == 0 && i >= 2 && i - 2 + S < n_k) {
          skt::mbar_wait(&empty[(i - 2) % S], ((i - 2) / S) & 1);
          fetch(i - 2 + S);
        }
        __syncwarp();
      }
    }
  }
  skt::wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    skt::fence_regs(part[0][m]);
    skt::fence_regs(part[1][m]);
  }
  {  // the last group
    const int q_last = n_q - 1;
    const long long gl = g0 + q_last / KPG;
    const float* ls = ZR ? sums + gl * p.ld_sum : nullptr;
    if ((q_last / KPG) & 1) promote<BM, MT, ZR>(acc, part[1], sc[1], zc[1], ls);
    else promote<BM, MT, ZR>(acc, part[0], sc[0], zc[0], ls);
  }

  // acc[m][4j + 2h + x]: column col + 2m + h, row m0 + 8j + 2t + x
  auto cols_of = [&](int j, int x, float (&v)[NC]) {
#pragma unroll
    for (int m = 0; m < MT; ++m) v[2 * m] = acc[m][4 * j + x], v[2 * m + 1] = acc[m][4 * j + 2 + x];
  };
  if (p.split == 1) {
    if (cols_in)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = m0 + 8 * j + 2 * t + x;
          if (row >= p.M) continue;
          float v[NC];
          cols_of(j, x, v);
          store_cols<NC>(p, row, col, v);
        }
    return;
  }
  // split K: this block's partial, then the last block of the tile sums all
  float* ws = p.ws + (long long)blockIdx.y * p.M * p.N;
  if (cols_in)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = m0 + 8 * j + 2 * t + x;
        if (row >= p.M) continue;
        float v[NC];
        cols_of(j, x, v);
#pragma unroll
        for (int c = 0; c < NC; c += 2)
          *reinterpret_cast<float2*>(ws + (long long)row * p.N + col + c) = make_float2(v[c], v[c + 1]);
      }
  __threadfence();
  __syncthreads();
  const int tile = mt * n_tiles + nt;
  if (tid == 0) *last = atomicAdd(p.counters + tile, 1) == p.split - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  if (tid == 0) p.counters[tile] = 0;  // every split has arrived: ready for the next call
  if (!cols_in) return;
  // the splits' partials in split order, this block's own from its
  // registers; every load of a split at once
  float sum[MT][BM / 2];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int x = 0; x < BM / 2; ++x) sum[m][x] = 0.f;
  for (int z = 0; z < p.split; ++z) {
    if (z == (int)blockIdx.y) {
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int x = 0; x < BM / 2; ++x) sum[m][x] += acc[m][x];
      continue;
    }
    const float* wz = p.ws + (long long)z * p.M * p.N + col;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = min(m0 + 8 * j + 2 * t + x, p.M - 1);  // rows past M are never stored
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float2 q = __ldcg(reinterpret_cast<const float2*>(wz + (long long)row * p.N + 2 * m));
          sum[m][4 * j + x] += q.x;
          sum[m][4 * j + 2 + x] += q.y;
        }
      }
  }
#pragma unroll
  for (int j = 0; j < BM / 8; ++j)
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int row = m0 + 8 * j + 2 * t + x;
      if (row >= p.M) continue;
      float v[NC];
#pragma unroll
      for (int m = 0; m < MT; ++m) v[2 * m] = sum[m][4 * j + x], v[2 * m + 1] = sum[m][4 * j + 2 + x];
      store_cols<NC>(p, row, col, v);
    }
}

struct RowsParams {
  const bf16 *a, *a2, *norm_w;  // a [M, lda]; a2 [M, lda2] (silu_mul); norm_w [k_valid]
  bf16* act;                    // [M, K] the prologue's rows, zero past k_valid, or null
  float* asum;                  // [K/G][ld_sum] each group's sum of them, or null
  const int* num_valid;         // grouped: rows of blocks at or past *num_valid are skipped
  int block_rows, M, K, k_valid, lda, lda2, prologue, group, ld_sum, vec;
  float eps;
};

// The rows pass: one block a row, 8 k a thread; the norm's
// rsqrt(mean(x^2) + eps) over the true K first (w4a16.py:181).
__global__ void __launch_bounds__(128) w4a16_rows_kernel(const RowsParams r) {
  const int m = blockIdx.x, tid = threadIdx.x;
  if (r.num_valid != nullptr && m / r.block_rows >= *r.num_valid) return;
  __shared__ float part[4];
  float rs = 0.f;
  if (r.prologue == kPrologueNorm) {
    float sq = 0.f;
    for (int k = 8 * tid; k < r.k_valid; k += 8 * 128) {
      float x[8];
      unpack8(load8(r.a, m, r.M, r.lda, k, r.k_valid, r.vec), x);
#pragma unroll
      for (int q = 0; q < 8; ++q) sq += x[q] * x[q];
    }
    sq = skt::warp_sum(sq);
    if (tid % 32 == 0) part[tid / 32] = sq;
    __syncthreads();
    rs = rsqrtf((part[0] + part[1] + part[2] + part[3]) / r.k_valid + r.eps);  // torch.rsqrt's instruction
  }
  const int lanes = r.group / 8;  // neighbouring lanes of one group
  for (int base = 0; base < r.K; base += 8 * 128) {
    const int k = base + 8 * tid;
    const bool in = k < r.K;
    float sum = 0.f;
    if (in) {
      uint4 v = load8(r.a, m, r.M, r.lda, k, r.k_valid, r.vec);
      if (r.prologue != kPrologueNone) {
        const uint4 y = r.prologue == kPrologueNorm ? load8(r.norm_w, 0, 1, 0, k, r.k_valid, r.vec)
                                                    : load8(r.a2, m, r.M, r.lda2, k, r.k_valid, r.vec);
        float x[8], yy[8];
        unpack8(v, x);
        unpack8(y, yy);
        bf16* hv = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int q = 0; q < 8; ++q)
          hv[q] = __float2bfloat16(q + k < r.k_valid ? (r.prologue == kPrologueNorm ? prologue_norm(x[q], yy[q], rs)
                                                                                    : prologue_silu(x[q], yy[q]))
                                                     : 0.f);
      }
      float x[8];
      unpack8(v, x);
#pragma unroll
      for (int q = 0; q < 8; ++q) sum += x[q];
      if (r.act) *reinterpret_cast<uint4*>(r.act + (long long)m * r.K + k) = v;
    }
    if (r.asum) {
      for (int o = 1; o < lanes; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (in && tid % lanes == 0) r.asum[(long long)(k / r.group) * r.ld_sum + m] = sum;
    }
  }
}

template <int G, int BM, bool MX, bool ZR>
cudaError_t launch_kernel(const KParams& kp, dim3 grid, cudaStream_t st) {
  auto kernel = w4a16_wgmma_kernel<G, BM, MX, ZR>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BM>::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  kernel<<<grid, kThreads, Cfg<BM>::SMEM, st>>>(kp);
  return cudaGetLastError();
}

template <int G, int BM>
cudaError_t dispatch(const KParams& kp, bool mx, bool zr, dim3 grid, cudaStream_t st) {
  if (mx) return zr ? launch_kernel<G, BM, true, true>(kp, grid, st) : launch_kernel<G, BM, true, false>(kp, grid, st);
  return zr ? launch_kernel<G, BM, false, true>(kp, grid, st) : launch_kernel<G, BM, false, false>(kp, grid, st);
}

// The rows pass where it writes rows or sums, then the tile over `a` (the
// rows pass's rows where it wrote them): codes w [n_experts][K/2][N], BM
// rows a block.
cudaError_t run(const Params& p, const RowsParams& r, const void* w, const void* a, int lda, int group, int bm,
                int mxfp4, cudaStream_t st) {
  if (r.act != nullptr || r.asum != nullptr) {
    w4a16_rows_kernel<<<p.M, 128, 0, st>>>(r);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  KParams kp;
  const long long kn = (long long)(p.K / 2) * p.N;
  const bool act = r.act != nullptr;
  if (!skt::map_tiled(&kp.tm_w, w, 1, 3, {p.N, p.K / 2, p.n_experts, 1}, {p.N, kn, kn * p.n_experts}, 128, kBK / 2,
                      true) ||
      !skt::map_2d(&kp.tm_a, act ? (const void*)r.act : a, 2, p.M, act ? p.K : r.k_valid, act ? p.K : lda, 64, bm,
                   true))
    return cudaErrorInvalidValue;
  kp.p = p;
  const int bn = bm == 64 ? Cfg<64>::BN : Cfg<128>::BN;
  const long long tiles = (long long)((p.M + bm - 1) / bm) * ((p.N + bn - 1) / bn);
  if (tiles > 0x7fffffffLL || p.split > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, (unsigned)p.split);
  const bool zr = p.zeros != nullptr;
  switch (group * 1000 + bm) {
    case 32064: return dispatch<32, 64>(kp, mxfp4, zr, grid, st);
    case 64064: return dispatch<64, 64>(kp, mxfp4, zr, grid, st);
    case 128064: return dispatch<128, 64>(kp, mxfp4, zr, grid, st);
    case 32128: return dispatch<32, 128>(kp, mxfp4, zr, grid, st);
    case 64128: return dispatch<64, 128>(kp, mxfp4, zr, grid, st);
    case 128128: return dispatch<128, 128>(kp, mxfp4, zr, grid, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; }

}  // namespace w4g

}  // namespace

// K1 at M > 32. a [M, lda] (and a2 [M, lda2] with prologue 2; norm_w [K]
// with prologue 1), k_valid columns used; w [K/2, N] uint8, scales / zeros
// [K/G, N] bf16, all 16-byte aligned, N a multiple of 16, K a multiple of
// 128; bias [N] float32 and residual [M, N] bf16 16- and 8-byte aligned;
// out [M, N] (out_f32: float32, else bf16). The rows pass runs for a
// prologue or rows TMA cannot map (a not 16-byte aligned or lda not a
// multiple of 8), writing act_ws [M, K] bf16, and for zeros, writing asum_ws
// [K/G][round_up(M, 128)] float32. block_m (64 or 128) rows a block. K
// splits over `split` blocks of
// stages_per_split 128-deep stages; with split > 1, ws holds split x M x N
// floats and counters one int a tile, zero (the kernel leaves them so).
// Returns cudaGetLastError().
extern "C" int skt_w4a16_wgmma(const void* a, const void* a2, const void* norm_w, void* act_ws, void* asum_ws,
                               const void* w, const void* scales, const void* zeros, const void* bias,
                               const void* residual, void* out, void* ws, void* counters, int M, int N, int K,
                               int k_valid, int lda, int lda2, int group, int block_m, int prologue, int mxfp4,
                               int out_f32, int vec_a, int split, int stages_per_split, float eps, void* stream) {
  const int stages = K / w4g::kBK;
  const bool want_act = prologue != kPrologueNone || !w4g::aligned16(a) || lda % 8;
  if (M < 1 || N % 16 || K % w4g::kBK || K % group || k_valid > K || (block_m != 64 && block_m != 128) ||
      split < 1 || stages_per_split < 1 ||
      (long long)split * stages_per_split < stages || (long long)(split - 1) * stages_per_split >= stages ||
      (split > 1 && (ws == nullptr || counters == nullptr)) || (want_act && act_ws == nullptr) ||
      (zeros && asum_ws == nullptr) || !w4g::aligned16(w) || !w4g::aligned16(scales) ||
      (zeros && !w4g::aligned16(zeros)))
    return (int)cudaErrorInvalidValue;
  w4g::Params p{};
  p.scales = (const bf16*)scales;
  p.zeros = (const bf16*)zeros;
  p.asum = (const float*)asum_ws;
  p.bias = (const float*)bias;
  p.residual = (const bf16*)residual;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.s_gstride = N;
  p.M = M, p.N = N, p.K = K, p.n_experts = 1, p.block_rows = 1, p.ld_sum = (M + 127) / 128 * 128;
  p.out_kind = out_f32 ? skt::kOutF32 : skt::kOutBf16;
  p.split = split, p.stages_per_split = stages_per_split;
  w4g::RowsParams r{};
  r.a = (const bf16*)a, r.a2 = (const bf16*)a2, r.norm_w = (const bf16*)norm_w;
  r.act = want_act ? (bf16*)act_ws : nullptr, r.asum = zeros ? (float*)asum_ws : nullptr;
  r.block_rows = 1, r.M = M, r.K = K, r.k_valid = k_valid, r.lda = lda, r.lda2 = lda2;
  r.prologue = prologue, r.group = group, r.ld_sum = p.ld_sum, r.vec = vec_a, r.eps = eps;
  return (int)w4g::run(p, r, w, a, lda, group, block_m, mxfp4, (cudaStream_t)stream);
}

// K11 at bm 64 / 128: x [cap, lda] bf16, k_valid columns used; w [E, K/2,
// N] uint8 (one layer of a stacked bank), 16-byte aligned, K a multiple of
// 64 (the last stage half deep where K % 128 == 64); scales / zeros
// [E, *, N] bf16, 8-byte aligned, expert e's group g at e * s_estride + g *
// s_gstride (s_gstride 0: per channel; both multiples of 4);
// block_expert_ids [cap / block_rows], *num_valid the valid row blocks (read
// on the device); out [cap, N]. The rows pass as for K1, over the valid row
// blocks' rows: act_ws [cap, K] where TMA cannot map x, asum_ws
// [K/G][cap] with zeros. Returns cudaGetLastError().
extern "C" int skt_w4a16_wgmma_grouped(const void* x, const void* w, const void* scales, const void* zeros,
                                       const void* expert_ids, const void* num_valid, void* act_ws, void* asum_ws,
                                       void* out, int M, int N, int K, int k_valid, int lda, int group,
                                       int block_rows, int n_experts, long long s_estride, long long s_gstride,
                                       int mxfp4, int out_f32, int vec_a, void* stream) {
  const bool want_act = !w4g::aligned16(x) || lda % 8;
  if (M < 1 || N % 16 || K % (w4g::kBK / 2) || K % group || k_valid > K || (block_rows != 64 && block_rows != 128) ||
      M % block_rows || n_experts < 1 || (want_act && act_ws == nullptr) || (zeros && asum_ws == nullptr) ||
      !w4g::aligned16(w) || reinterpret_cast<uintptr_t>(scales) % 8 || s_estride % 4 || s_gstride % 4 ||
      (zeros && reinterpret_cast<uintptr_t>(zeros) % 8))
    return (int)cudaErrorInvalidValue;
  w4g::Params p{};
  p.scales = (const bf16*)scales;
  p.zeros = (const bf16*)zeros;
  p.asum = (const float*)asum_ws;
  p.out = out;
  p.expert_ids = (const int*)expert_ids;
  p.num_valid = (const int*)num_valid;
  p.s_estride = s_estride, p.s_gstride = s_gstride;
  p.M = M, p.N = N, p.K = K, p.n_experts = n_experts, p.block_rows = block_rows, p.ld_sum = M;
  p.out_kind = out_f32 ? skt::kOutF32 : skt::kOutBf16;
  p.split = 1, p.stages_per_split = (K + w4g::kBK - 1) / w4g::kBK;
  w4g::RowsParams r{};
  r.a = (const bf16*)x;
  r.act = want_act ? (bf16*)act_ws : nullptr, r.asum = zeros ? (float*)asum_ws : nullptr;
  r.num_valid = (const int*)num_valid;
  r.block_rows = block_rows, r.M = M, r.K = K, r.k_valid = k_valid, r.lda = lda;
  r.prologue = kPrologueNone, r.group = group, r.ld_sum = M, r.vec = vec_a;
  return (int)w4g::run(p, r, w, x, lda, group, block_rows, mxfp4, (cudaStream_t)stream);
}
