// The W4A16 weight-streaming core shared by K10 (w4a16_gemm_dma.cu, one
// dense weight, M <= 32) and K11 at decode (w4a16_grouped_decode.cu, a row
// block of 16 or 32 rows a routed expert): out = a @ dequant(W) over int4 or
// e2m1 codes in K1's K-paired layout (byte (r, n) holds rows 2r and 2r+1 in
// its low and high nibble), scales and z*s zeros a scale group, bias and
// residual added in f32 before the one cast. Rounding points are K1's: the
// prologue's result (silu(a) * a2) rounded to bf16 before the product, each
// group's partial product in f32 scaled per column.
//
// Bound: bytes. A decode call streams 8-470 MB of codes against <= 32
// activation rows, 64 flop a code byte at most.
//
// Design. Two launches that overlap by programmatic dependent launch: a rows
// pass (rows_kernel, a thread a 16-k chunk) writes the activations once,
// rounded to bf16 and in the GEMM's k order (each 16 k as k 0, 2, .., 14, 1,
// 3, .., 15), with each scale group's sum; the GEMM (stream_kernel) starts
// behind it and waits for it only before its first activation load. The
// GEMM's work is units of (row block, 256-column tile, 256-deep k block),
// counted on the device from *num_valid (K11) or one row block (K10), so the
// host never reads a count and a captured graph stays right when the count
// changes. The grid is one block an SM whatever the shape. Where whole
// tiles balance the blocks as well as splitting them (Share, kOrderAuto:
// Mixtral-8x7B's and V2-Lite's down GEMMs, the lm_head) every block takes
// whole tiles and no tile is shared; else each block takes an equal share of
// the units, tile-major (stream-K). A block is a producer warp and sixteen
// consumer warps: the producer's lanes bring a unit's boxes by TMA into a
// four-stage mbarrier ring, one box a lane, the weight boxes in one
// instruction (two 128-byte-swizzled boxes of codes side by side, so every
// weight row is read as 256 contiguous bytes; scales; zeros) and the
// activation boxes in a second (four [MP][64] sub-tiles, the group sums).
// Codes, scales and zeros come through one 4-D map per bank, [L][E][K/2 |
// K/G][N] with layer and expert as coordinates, encoded once and kept. The
// consumers take the codes as mma.sync's A operand straight from registers
// and the activation rows as B (the swapped product out^T = W^T a^T of K1's
// decode kernel): int4 decodes as 136 + c with one and-xor, the 136 taken off
// with the group's activation sum; eight column slices of 32, each stage's
// two scale groups (G = 128) split between two halves that add their sums at
// the end of a tile. A tile one block holds whole is stored at once; a tile
// shared by blocks leaves f32 partials in a workspace and the last block to
// arrive (a counter it resets) sums them in block order (merge_store) and
// applies the epilogue, so the result is bit-identical from call to call and
// across graph replays.
//
// The stream's shape (StreamCfg) follows tools/w4a16_stream_probe.py's table
// on an NVIDIA H100 80GB HBM3 at 700 W (cold banks of 1.2-1.4 GB at
// Mixtral-8x7B's widths; PERF.md section 6 holds the table): a plain read
// reaches ~3.1 TB/s; a TMA ring whose boxes are 128 bytes wide, tile-major,
// stalls at 2.0-2.25 TB/s with consumers that do nothing, at any stage count,
// while 256-byte runs of each row reach 3.0-3.15 (row locality in the
// DRAM); a producer that issues a stage's boxes from one lane loses a third
// of that with every box of a stage in flight at one block an SM, one lane a
// box recovers it; with the real consumers the stream is held by the
// consumers, and one block of 16 consumer warps with four 43 KB stages beat
// two blocks of eight with two. Spills decide much of the consumers' rate:
// 17 warps are allocated as 20, 96 registers a thread, so the shared-tile
// merge is kept out of the main loop (merge_store). A shared tile's
// epilogue (partials, fence, counter, merge) costs a block the time of a
// few units, hence whole tiles wherever they balance.
#pragma once

#include "tma_map.cuh"
#include "w4a16_tile.cuh"

// internal linkage, as w4a16_tile.cuh: each library that includes the core
// keeps its own launch state (a kernel's shared-memory attribute is set once
// per library)
namespace {
namespace w4s {

using skt::bf16;

// A block is consumer warps and one producer warp; an SM holds 16 consumer
// warps, as two blocks of 8 (MINB 2) or one of 16 (MINB 1).
template <int MINB>
__host__ __device__ constexpr int consumers() { return 16 / MINB; }
template <int MINB>
__host__ __device__ constexpr int threads() { return 32 * (16 / MINB + 1); }
constexpr int kOrderTile = 0;   // each block's share contiguous, a tile's k blocks in turn (stream-K)
constexpr int kOrderKSync = 1;  // whole tiles b, b + NB, ..: neighbouring blocks on neighbouring tiles
                                // of the same k rows at once; the last partial round as kOrderTile
constexpr int kOrderAuto = 2;   // every tile whole when that is as short as stream-K (within half a
                                // tile's units), else kOrderTile: no partials, no merges
// what a probe build's consumers do: 0 compute; 1 release a stage of codes only;
// 2 release a full stage (codes, activations, scales, sums)
constexpr int kConsume = 0, kEmptyCodes = 1, kEmptyAll = 2;

// BOX: 0 = one 128-byte-swizzled box of 128 columns a stage; 1 = one
// unswizzled 256-byte box of 256 columns; 2 = two 128-byte-swizzled boxes
// side by side (256 columns). KS: k of a stage (KS / 2 packed rows).
template <int G, int MP, int BOX, int KS, int S, int MODE = kConsume, int NC = 8>
struct Layout {
  static constexpr int BN = BOX == 0 ? 128 : 256;
  static constexpr int KR = KS / 2;
  static constexpr int SLICES = BN / 32;               // column slices of 32, one a warp
  static constexpr int HALVES = NC / SLICES;           // a stage's scale groups split between them
  static constexpr int SG = KS / G;                    // scale groups of a stage
  static_assert(SG % HALVES == 0, "a half takes whole scale groups");
  static_assert(HALVES <= 2, "one or two halves");
  static constexpr int CODES = KR * BN;
  static constexpr int ACT = MP * KS * 2;              // KS / 64 swizzled [MP][64] sub-tiles
  static constexpr int SC = SG * BN * 2;
  static constexpr int SUM = SG * MP * 4;
  static constexpr int STAGE = ((MODE == kEmptyCodes ? CODES : CODES + ACT + 2 * SC + SUM) + 1023) / 1024 * 1024;
  static constexpr int RED = HALVES > 1 ? 2 * (MP / 8) * 4 * (32 * SLICES) * 4 : 0;
  static constexpr int BYTES = 1024 + S * STAGE + RED + 2 * S * 8;
};

struct Params {
  const float* bias;       // [N] or null
  const bf16* residual;    // [rows, N] or null
  void* out;               // [rows, N] bf16 or f32
  float* partial;          // [grid][2][MP][BN]: a block's first and last shared tile
  int* counters;           // [n_rb * tiles], zero between calls
  const int* expert_ids;   // [n_rb] (K11) or null (K10: expert 0)
  const int* num_valid;    // row blocks to compute (K11) or null (K10: one)
  int rows, bm, n_rb;      // output rows; rows a row block (its first row rb * bm); row blocks at most
  int N, n_kb, tiles, layer, order, out_f32, zeros;
};

struct alignas(64) Args {
  CUtensorMap tw, ts, tz;  // codes, scales, zeros: 4-D over [L][E][K/2 | K/G][N]
  CUtensorMap ta, tsum;    // the rows pass's activations [rows][K] and group sums [K/G][ld], as 4-D maps
  Params p;
};

// byte offset of 16-byte chunk ch (8 k slots) of activation row m: tiles of
// [MP][64] bf16, 128-byte swizzled
template <int MP>
__device__ __forceinline__ uint32_t act_off(int m, int ch) {
  return (uint32_t)((ch >> 3) * MP * 128) + skt::sw128(m, ch & 7);
}

// byte offset of columns col .. col + 3 (col % 4 == 0) of packed row r in a
// stage's codes
template <int BOX, int KR>
__device__ __forceinline__ uint32_t code_off(int r, int col) {
  if (BOX == 1) return (uint32_t)(r * 256 + col);
  return (uint32_t)((col >> 7) * (KR * 128) + r * 128 + ((((col >> 4) & 7) ^ (r & 7)) << 4) + (col & 15));
}

// An int4 nibble pair (bits 0-3 and 16-19) -> bf16 136 + c, exact: 0x4300
// is 128.0 with a mantissa unit of 1, and a two's-complement nibble c has
// c ^ 8 == c + 8, so one and-xor builds both.
constexpr float kInt4Bias = 136.f;
__device__ __forceinline__ uint32_t int4_biased_pair(uint32_t v) { return (v & 0x000F000Fu) ^ 0x43084308u; }

// bytes [w0.b, w0.b, w1.b, w1.b]: low nibbles of the two bytes at bits 0-3
// and 16-19, high nibbles at 4-7 and 20-23
__device__ __forceinline__ uint32_t pair_bytes(uint32_t w0, uint32_t w1, int b) {
  return __byte_perm(w0, w1, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
}

struct RowsParams {
  const bf16 *a, *a2;      // a [rows, lda]; a2 [rows, lda2] (silu_mul) or null
  bf16* act;               // [rows, K]
  float* asum;             // [K / G][ld]
  const int* num_valid;    // grouped: rows of row blocks at or past it are skipped
  int rows, K, k_valid, lda, lda2, group, bm, ld, vec_a;
};

// The rows pass: row m of a (or silu(a) * a2), rounded to bf16, zero past
// the true K, each 16 k as k 0, 2, .., 14, 1, 3, .., 15, and each group's sum
// of the rounded values. A thread takes one 16-k chunk of the flattened
// [rows][K / 16] chunks, so every lane works whatever K is and a group's
// chunks are neighbouring lanes (K is a multiple of the group). It lets the
// GEMM launch at once.
__global__ void __launch_bounds__(256) rows_kernel(const RowsParams p) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int cpr = p.K / 16;                         // chunks a row
  const long long c_all = (long long)blockIdx.x * 256 + threadIdx.x;
  const int m = (int)(c_all / cpr), c = (int)(c_all % cpr), k = 16 * c;
  const int valid_rows = p.num_valid ? min(p.rows, *p.num_valid * p.bm) : p.rows;
  if ((long long)blockIdx.x * 256 >= (long long)valid_rows * cpr) return;  // the whole block past the valid rows
  const bool live = m < valid_rows;
  float sum = 0.f;
  if (live) {
    uint4 v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) v[h] = load8(p.a, m, p.rows, p.lda, k + 8 * h, p.k_valid, p.vec_a);
    if (p.a2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint4 y = load8(p.a2, m, p.rows, p.lda2, k + 8 * h, p.k_valid, p.vec_a);
        float x[8], yy[8];
        unpack8(v[h], x);
        unpack8(y, yy);
        bf16* hv = reinterpret_cast<bf16*>(&v[h]);
#pragma unroll
        for (int e = 0; e < 8; ++e) hv[e] = __float2bfloat16(prologue_silu(x[e], yy[e]));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x[8];
      unpack8(v[h], x);
#pragma unroll
      for (int e = 0; e < 8; ++e) sum += x[e];
    }
    uint4 lo, hi;  // k 0, 2, .., 14 and k 1, 3, .., 15
    lo.x = __byte_perm(v[0].x, v[0].y, 0x5410);
    lo.y = __byte_perm(v[0].z, v[0].w, 0x5410);
    lo.z = __byte_perm(v[1].x, v[1].y, 0x5410);
    lo.w = __byte_perm(v[1].z, v[1].w, 0x5410);
    hi.x = __byte_perm(v[0].x, v[0].y, 0x7632);
    hi.y = __byte_perm(v[0].z, v[0].w, 0x7632);
    hi.z = __byte_perm(v[1].x, v[1].y, 0x7632);
    hi.w = __byte_perm(v[1].z, v[1].w, 0x7632);
    bf16* row = p.act + (long long)m * p.K;
    *reinterpret_cast<uint4*>(row + k) = lo;
    *reinterpret_cast<uint4*>(row + k + 8) = hi;
  }
  // the group's sum: a butterfly over its 2, 4 or 8 neighbouring lanes
  const int gw = p.group / 16;
  for (int o = 1; o < gw; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (live && c % gw == 0) p.asum[(long long)(c / gw) * p.ld + m] = sum;
}

// The block's units: first whole tiles (tile r * NB + b), then an equal
// share [v0, v1) of the remaining tiles' units, tile-major. kOrderTile: no
// whole tiles, every block the same count of units, +-1. kOrderKSync:
// floor(TT / NB) rounds of whole tiles first. kOrderAuto: every tile whole
// (blocks b < TT % NB one round more, the rest idle when TT < NB) when the
// longest block then takes no more than half a tile's units beyond
// stream-K's, else as kOrderTile; the rule reads the tile count on the
// device. (A call's units fit an int:
// 14,336 at Mixtral's gate_up.)
struct Share {
  int NB, n_kb, n_round, tail0, Wt, NBt, v0, v1;
  __device__ Share(const Params& p) {
    const int R = p.num_valid ? max(0, min(*p.num_valid, p.n_rb)) : 1;
    const int TT = R * p.tiles;
    NB = gridDim.x;
    n_kb = p.n_kb;
    int rounds = 0, extra = 0;
    tail0 = 0;
    if (p.order == kOrderKSync) {
      rounds = TT / NB;
      tail0 = rounds * NB;
    } else if (p.order == kOrderAuto && TT > 0 &&
               (long long)((TT + NB - 1) / NB) * n_kb <= ((long long)TT * n_kb + NB - 1) / NB + n_kb / 2) {
      rounds = TT / NB;
      extra = (int)blockIdx.x < TT % NB;
      tail0 = TT;
    }
    n_round = (rounds + extra) * n_kb;
    Wt = (TT - tail0) * n_kb;
    NBt = min(NB, Wt);
    const int b = blockIdx.x;
    v0 = b < NBt ? (int)((long long)Wt * b / NBt) : 0;
    v1 = b < NBt ? (int)((long long)Wt * (b + 1) / NBt) : 0;
  }
  __device__ __forceinline__ int n_items() const { return n_round + v1 - v0; }
  __device__ __forceinline__ void item(int i, int& tile, int& kb) const {
    if (i < n_round) {
      tile = (i / n_kb) * NB + blockIdx.x;
      kb = i % n_kb;
    } else {
      const int v = v0 + i - n_round;
      tile = tail0 + v / n_kb;
      kb = v % n_kb;
    }
  }
  // the block whose tail share holds unit v, and where its share starts
  __device__ __forceinline__ int block_of(int v) const {
    return (int)(((long long)(v + 1) * NBt + Wt - 1) / Wt) - 1;
  }
  __device__ __forceinline__ int start_of(int b) const { return (int)((long long)Wt * b / NBt); }
};

// Output columns col .. col + 3 of row row0 + m: bias and residual added in
// f32, then the one cast (N % 16 == 0: the 4 columns are wholly in or out).
__device__ __forceinline__ void store4(const Params& p, int row0, int m, int col, float (&o)[4]) {
  const int row = row0 + m;
  if (m >= p.bm || row >= p.rows || col >= p.N) return;
  const long long idx = (long long)row * p.N + col;
  if (p.bias) {
    const float4 bv = *reinterpret_cast<const float4*>(p.bias + col);
    o[0] += bv.x, o[1] += bv.y, o[2] += bv.z, o[3] += bv.w;
  }
  if (p.residual) {
    const uint2 rv = *reinterpret_cast<const uint2*>(p.residual + idx);
    const bf16* rh = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] += __bfloat162float(rh[q]);
  }
  if (p.out_f32) {
    *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + idx) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    __align__(8) bf16 ob[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) ob[q] = __float2bfloat16(o[q]);
    *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(p.out) + idx) = *reinterpret_cast<const uint2*>(ob);
  }
}

// The last block to arrive at a shared tile: the n_c sharers' partials
// (blocks cf, cf + 1, ..; cf's in its slot 1 when the tile is its last),
// summed in block order and stored. Sixteen loads in flight: every row of
// this thread's fragment for 16 / rows sharers at a time. Not inlined, so
// that its registers do not crowd the stream's main loop.
template <int MP, int BN>
__device__ __noinline__ void merge_store(const Params& p, int row0, int col, int ccol, int tq, int cf, int cf_slot,
                                         int n_c) {
  constexpr int kR = MP / 4, kB = 16 / kR;  // rows of a thread's fragment; sharers a round
  float o[kR][4];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[r][q] = 0.f;
  for (int c0 = 0; c0 < n_c; c0 += kB) {
    float4 pv[kB][kR];
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const int cb = cf + min(c0 + b, n_c - 1);
      const float* src = p.partial + (cb * 2 + (cb == cf ? cf_slot : 0)) * (MP * BN) + ccol;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        pv[b][r] = __ldcg(reinterpret_cast<const float4*>(src + (8 * (r / 2) + 2 * tq + (r & 1)) * BN));
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      if (c0 + b >= n_c) break;
#pragma unroll
      for (int r = 0; r < kR; ++r)
        o[r][0] += pv[b][r].x, o[r][1] += pv[b][r].y, o[r][2] += pv[b][r].z, o[r][3] += pv[b][r].w;
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) store4(p, row0, 8 * (r / 2) + 2 * tq + (r & 1), col, o[r]);
}

template <int G, int MP, bool MX, int BOX, int KS, int S, int MINB, int MODE>
__global__ void __launch_bounds__(threads<MINB>(), MINB) stream_kernel(const __grid_constant__ Args da) {
  constexpr int kConsumers = consumers<MINB>();
  using L = Layout<G, MP, BOX, KS, S, MODE, kConsumers>;
  constexpr int BN = L::BN, KR = L::KR, SG = L::SG, NSL = L::SLICES, H = L::HALVES;
  const Params& p = da.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* red = reinterpret_cast<float*>(smem + S * L::STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * L::STAGE + L::RED);
  uint64_t* empty = full + S;
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const Share sh(p);
  const int n_items = sh.n_items();
  if (n_items == 0) return;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      skt::mbar_init(&full[s], 1);
      skt::mbar_init(&empty[s], kConsumers);
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  // Producer: the first lanes stream the share, each lane one box of a
  // stage, all of a stage's weight boxes (codes, scales, zeros) in one
  // instruction and its activation boxes (the rows pass's sub-tiles and
  // group sums) in a second. The weights of the first stages go out before
  // the wait for the rows pass (griddepcontrol.wait), since they do not
  // depend on it.
  if (warp == kConsumers) {
    constexpr int kCode = BOX == 2 ? 2 : 1;             // code boxes: lanes [0, kCode), then scales, zeros
    constexpr int kW = kCode + 2;                       // weight lanes
    constexpr int kActBoxes = MODE == kEmptyCodes ? 0 : KS / 64 + 1;  // activation sub-tiles, then the sums
    constexpr unsigned kLanes = 0xffffffffu >> (32 - kW - kActBoxes);
    if (lane >= kW + kActBoxes) return;
    const uint32_t bytes = MODE == kEmptyCodes ? L::CODES : L::CODES + L::ACT + (p.zeros ? 2 : 1) * L::SC + L::SUM;
    const bool my_weights = lane < kCode || (MODE != kEmptyCodes && lane < kW && (lane == kCode || p.zeros));
    const bool my_rows = lane >= kW;
    int cur_rb = -1, expert = 0;
    // this lane's box of unit i into stage st
    auto issue = [&](int i, int st) {
      int tile, kb;
      sh.item(i, tile, kb);
      const int rb = tile / p.tiles, n0 = (tile % p.tiles) * BN;
      uint8_t* dst = smem + st * L::STAGE;
      const CUtensorMap* tm;
      int c[4];
      if (lane < kW) {
        if (rb != cur_rb) {
          cur_rb = rb;
          expert = p.expert_ids ? __ldg(p.expert_ids + rb) : 0;
        }
        if (lane < kCode) {  // codes: 128-byte boxes side by side (one 256-byte box for BOX 1)
          tm = &da.tw;
          dst += lane * KR * 128;
          c[0] = n0 + 128 * lane, c[1] = kb * KR;
        } else {  // the scale rows, then the zero rows
          tm = lane == kCode ? &da.ts : &da.tz;
          dst += L::CODES + L::ACT + (lane - kCode) * L::SC;
          c[0] = n0, c[1] = kb * SG;
        }
        c[2] = expert, c[3] = p.layer;
      } else if (lane < kW + KS / 64) {  // an activation sub-tile [MP][64]
        tm = &da.ta;
        dst += L::CODES + (lane - kW) * MP * 128;
        c[0] = kb * KS + 64 * (lane - kW), c[1] = rb * p.bm, c[2] = 0, c[3] = 0;
      } else {  // the group sums [SG][MP]
        tm = &da.tsum;
        dst += L::CODES + L::ACT + 2 * L::SC;
        c[0] = rb * p.bm, c[1] = kb * SG, c[2] = 0, c[3] = 0;
      }
      skt::tma_load_4d(dst, tm, c[0], c[1], c[2], c[3], &full[st]);
    };
    const int first = min(S, n_items);
    for (int k = 0; k < first; ++k) {
      if (lane == 0) skt::mbar_expect_tx(&full[k], bytes);
      __syncwarp(kLanes);
      if (my_weights) issue(k, k);
    }
    if (my_rows) {
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      for (int k = 0; k < first; ++k) issue(k, k);
    }
    for (int k = first; k < n_items; ++k) {
      const int st = k % S;
      skt::mbar_wait(&empty[st], ((k / S) - 1) & 1);
      if (lane == 0) skt::mbar_expect_tx(&full[st], bytes);
      __syncwarp(kLanes);
      if (my_weights || my_rows) issue(k, st);
    }
    return;
  }
  auto release = [&](int st) {
    __syncwarp();
    if (lane == 0) skt::mbar_arrive(&empty[st]);
  };

  if (MODE != kConsume) {  // probe: release each stage as it lands
    for (int k = 0; k < n_items; ++k) {
      const int st = k % S;
      skt::mbar_wait(&full[st], (k / S) & 1);
      release(st);
    }
    return;
  }

  // Consumers: warp w takes columns 32 (w % NSL) .. + 31 of the tile and the
  // stage's scale groups of half w / NSL.
  const int gq = lane >> 2, tq = lane & 3;
  const int ws = warp % NSL, half = warp / NSL;
  const int lr = (lane >> 4) * 8 + (lane & 7), lc = (lane >> 3) & 1;  // this lane's ldmatrix row and chunk
  const int ccol = 32 * ws + 4 * gq;                                 // its codes' first column in the tile
  constexpr int kHalf = SG / H;                                      // scale groups a half takes a stage
  int k = 0;  // stages consumed
  for (int i = 0; i < n_items;) {
    int tile, kb0;
    sh.item(i, tile, kb0);
    // this block's run of the tile: whole (a round), or part of a tail tile
    const bool in_round = i < sh.n_round;
    const int v = in_round ? 0 : sh.v0 + i - sh.n_round;
    const int us = in_round ? 0 : (v / sh.n_kb) * sh.n_kb;  // the tail tile's first unit
    const int run = in_round ? sh.n_kb : min(sh.v1, us + sh.n_kb) - v;
    // acc[c][j][e]: column ccol + 2 (e >> 1) + c, activation row 8 j + 2 tq + (e & 1)
    float acc[2][MP / 8][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    for (int r = 0; r < run; ++r, ++k) {
      const int st = k % S;
      skt::mbar_wait(&full[st], (k / S) & 1);
      const uint8_t* codes = smem + st * L::STAGE;
      const uint8_t* sact = codes + L::CODES;
      const bf16* srow = reinterpret_cast<const bf16*>(codes + L::CODES + L::ACT);
      const float* ssum = reinterpret_cast<const float*>(codes + L::CODES + L::ACT + 2 * L::SC);
#pragma unroll
      for (int gh = 0; gh < kHalf; ++gh) {
        const int gi = half * kHalf + gh;
        float part[2][MP / 8][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[c][j][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < G / 16; ++kq) {
          const int ks = gi * (G / 16) + kq;
          // packed rows 8 ks + 2 tq and + 1: k slots (2 tq, 2 tq + 1) are the
          // two rows' low nibbles, (2 tq + 8, 2 tq + 9) their high nibbles
          const int r0 = 8 * ks + 2 * tq;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(codes + code_off<BOX, KR>(r0, ccol));
          const uint32_t w1 = *reinterpret_cast<const uint32_t*>(codes + code_off<BOX, KR>(r0 + 1, ccol));
          uint32_t af[2][4];  // A rows gq and gq + 8 of set c: bytes c and 2 + c
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t xa = pair_bytes(w0, w1, c), xb = pair_bytes(w0, w1, 2 + c);
            if (MX) {
              af[c][0] = mxfp4_pair(xa);
              af[c][2] = mxfp4_pair(xa >> 4);
              af[c][1] = mxfp4_pair(xb);
              af[c][3] = mxfp4_pair(xb >> 4);
            } else {  // 136 + c: the offset comes off per group, 136 sum(a)
              af[c][0] = int4_biased_pair(xa);
              af[c][2] = int4_biased_pair(xa >> 4);
              af[c][1] = int4_biased_pair(xb);
              af[c][3] = int4_biased_pair(xb >> 4);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MP / 16; ++mt) {
            uint32_t bfr[4];  // activation rows 16 mt + 0-7 / 8-15, slots 0-7 / 8-15
            skt::ldsm_x4(bfr, sact + act_off<MP>(16 * mt + lr, 2 * ks + lc));
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              mma_bf16(part[c][2 * mt], af[c], bfr[0], bfr[1]);
              mma_bf16(part[c][2 * mt + 1], af[c], bfr[2], bfr[3]);
            }
          }
        }
        // the group's output-side scaling (and zero-point term) per column
        const uint2 sv = *reinterpret_cast<const uint2*>(srow + gi * BN + ccol);
        const bf16* shv = reinterpret_cast<const bf16*>(&sv);
        float sc[4], zc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[q] = __bfloat162float(shv[q]);
        if (p.zeros) {
          const uint2 zv = *reinterpret_cast<const uint2*>(srow + (SG + gi) * BN + ccol);
          const bf16* zh = reinterpret_cast<const bf16*>(&zv);
#pragma unroll
          for (int q = 0; q < 4; ++q) zc[q] = __bfloat162float(zh[q]);
        }
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float am = ssum[gi * MP + 8 * j + 2 * tq + rr];
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
              for (int h2 = 0; h2 < 2; ++h2) {
                const int q = 2 * h2 + c, e = 2 * h2 + rr;
                acc[c][j][e] += (MX ? part[c][j][e] : part[c][j][e] - kInt4Bias * am) * sc[q] - am * zc[q];
              }
          }
      }
      release(st);
    }
    i += run;

    // The tile's part is done: the second half's sums join the first's.
    if (H == 2) {
      skt::named_sync(1, 32 * kConsumers);
      if (half == 1) {
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              red[((c * (MP / 8) + j) * 4 + e) * (32 * NSL) + tid - 32 * NSL] = acc[c][j][e];
      }
      skt::named_sync(1, 32 * kConsumers);
      if (half == 1) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[c][j][e] += red[((c * (MP / 8) + j) * 4 + e) * (32 * NSL) + tid];
    }

    // Epilogue: a thread holds 4 adjacent columns of rows 8 j + 2 tq + r.
    const int row0 = (tile / p.tiles) * p.bm;
    const int col = (tile % p.tiles) * BN + ccol;
    const int cf = in_round ? 0 : sh.block_of(us), cl = in_round ? 0 : sh.block_of(us + sh.n_kb - 1);
    if (cf == cl) {  // the whole tile is this block's
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float o[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q] = acc[q & 1][j][2 * (q >> 1) + rr];
          store4(p, row0, 8 * j + 2 * tq + rr, col, o);
        }
      continue;
    }
    // Shared: this block's partial (slot 0 if the tile is its first tail
    // tile, else its last), then the last block to arrive sums every
    // sharer's in block order.
    float* mine = p.partial + (blockIdx.x * 2 + (us <= sh.v0 ? 0 : 1)) * (MP * BN);
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = 8 * j + 2 * tq + rr;
        float o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = acc[q & 1][j][2 * (q >> 1) + rr];
        *reinterpret_cast<float4*>(mine + m * BN + ccol) = make_float4(o[0], o[1], o[2], o[3]);
      }
    __threadfence();
    skt::named_sync(2, 32 * NSL);
    if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == cl - cf;
    skt::named_sync(2, 32 * NSL);
    if (!s_last) continue;
    __threadfence();
    merge_store<MP, BN>(p, row0, col, ccol, tq, cf, sh.start_of(cf) < us ? 1 : 0, cl - cf + 1);
    if (tid == 0) p.counters[tile] = 0;  // ready for the next call
  }
}

// ---- host side ----

// The bank maps of one call: codes [L][E][K/2][N] uint8, scales and zeros
// [L][E][K/G][N] bf16 (zeros may be null), each encoded once per bank and
// kept; the rows pass's activations [rows][K] and sums [K/G][ld]. False if a
// map is refused (pointers and rows must be 16-byte aligned).
template <int G, int MP, int BOX, int KS, int S>
bool make_maps(Args& da, const void* w, const void* scales, const void* zeros, const void* act, const void* asum,
               int L, int E, int K, int N, int rows, int ld) {
  using Lay = Layout<G, MP, BOX, KS, S>;
  const long long dw[4] = {N, K / 2, E, L}, ds[4] = {N, K / G, E, L}, da_[4] = {K, rows, 1, 1},
                  dsum[4] = {ld, K / G, 1, 1};
  const bool ok = skt::map_4d(&da.tw, w, 1, dw, BOX == 1 ? 256 : 128, Lay::KR, BOX != 1) &&
                  skt::map_4d(&da.ts, scales, 2, ds, Lay::BN, Lay::SG, false) &&
                  (!zeros || skt::map_4d(&da.tz, zeros, 2, ds, Lay::BN, Lay::SG, false)) &&
                  skt::map_4d(&da.ta, act, 2, da_, 64, MP, true) &&
                  skt::map_4d(&da.tsum, asum, 4, dsum, MP, Lay::SG, false);
  if (ok && !zeros) da.tz = da.ts;  // never read
  return ok;
}

// The GEMM behind the rows pass (programmatic dependent launch), `blocks`
// blocks.
template <int G, int MP, bool MX, int BOX, int KS, int S, int MINB, int MODE>
cudaError_t launch(const Args& da, int blocks, cudaStream_t st) {
  using Lay = Layout<G, MP, BOX, KS, S, MODE, consumers<MINB>()>;
  auto kernel = stream_kernel<G, MP, MX, BOX, KS, S, MINB, MODE>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads<MINB>());
  cfg.dynamicSmemBytes = Lay::BYTES;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, da);
}

// blocks of `kernel` that fit on one SM with its shared memory
template <int G, int MP, bool MX, int BOX, int KS, int S, int MINB, int MODE>
int blocks_per_sm() {
  using Lay = Layout<G, MP, BOX, KS, S, MODE, consumers<MINB>()>;
  auto kernel = stream_kernel<G, MP, MX, BOX, KS, S, MINB, MODE>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::BYTES) != cudaSuccess) return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads<MINB>(), Lay::BYTES) != cudaSuccess)
    return 0;
  return n;
}

// The stream's shape (from the probe's table; see the note at the top): two
// 128-byte boxes side by side, 256 columns, 256 k a stage (32 KB of codes),
// one block an SM of 16 consumer warps in two halves of a stage's scale
// groups, four stages (three at 32 rows), the units in kOrderAuto.
struct StreamCfg {
  static constexpr int BOX = 2, KS = 256, MINB = 1;
  template <int MP>
  static constexpr int stages() { return MP == 16 ? 4 : 3; }
};

// One call: the rows pass over `rows` rows of a (and a2 for silu_mul) into
// act / asum, then the GEMM of `blocks` blocks over the units of one row
// block (expert_ids null: K10, bm = M) or of *num_valid row blocks of bm rows
// (K11). w, scales, zeros: banks [L][E][K/2 | K/G][N], layer `layer`, the
// expert of row block rb expert_ids[rb]. Returns cudaGetLastError().
inline int run(const bf16* a, const bf16* a2, int lda, int lda2, int rows, int k_valid, int K, int N, const void* w,
        const void* scales, const void* zeros, int L, int E, int layer, const int* expert_ids, const int* num_valid,
        int bm, int n_rb, const float* bias, const bf16* residual, void* out, int out_f32, void* act, void* asum,
        int ld, void* partial, void* counters, int blocks, int group, int mxfp4, int vec_a, cudaStream_t st) {
  using C = StreamCfg;
  const int mp = bm <= 16 ? 16 : 32;
  if (bm < 1 || bm > 32 || (expert_ids && bm != mp) || N % 16 || K % group || K % 16 || blocks < 1 || !act ||
      !asum || !partial || !counters || ld % 4 || ld < rows)
    return (int)cudaErrorInvalidValue;
  Args da;
  bool ok = false;
  switch (group * 64 + mp) {
#define W4S_MAPS(g, m)                                                                                            \
  case g * 64 + m:                                                                                                \
    ok = make_maps<g, m, C::BOX, C::KS, C::stages<m>()>(da, w, scales, zeros, act, asum, L, E, K, N, rows, \
                                                                 ld);                                             \
    break;
    W4S_MAPS(32, 16) W4S_MAPS(32, 32) W4S_MAPS(64, 16) W4S_MAPS(64, 32) W4S_MAPS(128, 16) W4S_MAPS(128, 32)
#undef W4S_MAPS
    default: return (int)cudaErrorInvalidValue;
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  Params& p = da.p;
  p.bias = bias;
  p.residual = residual;
  p.out = out;
  p.partial = (float*)partial;
  p.counters = (int*)counters;
  p.expert_ids = expert_ids;
  p.num_valid = num_valid;
  p.rows = rows, p.bm = bm, p.n_rb = expert_ids ? n_rb : 1;
  constexpr int BN = Layout<32, 16, C::BOX, C::KS, 1>::BN;  // 256
  p.N = N, p.n_kb = (K + C::KS - 1) / C::KS, p.tiles = (N + BN - 1) / BN;
  p.layer = layer, p.order = kOrderAuto, p.out_f32 = out_f32, p.zeros = zeros != nullptr;
  RowsParams rp;
  rp.a = a, rp.a2 = a2, rp.act = (bf16*)act, rp.asum = (float*)asum, rp.num_valid = expert_ids ? num_valid : nullptr;
  rp.rows = rows, rp.K = K, rp.k_valid = k_valid, rp.lda = lda, rp.lda2 = lda2, rp.group = group;
  rp.bm = bm, rp.ld = ld, rp.vec_a = vec_a;
  rows_kernel<<<(unsigned)(((long long)rows * (K / 16) + 255) / 256), 256, 0, st>>>(rp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch ((group * 64 + mp) * 2 + (mxfp4 ? 1 : 0)) {
#define W4S_LAUNCH(g, m, mx)                                                                                 \
  case (g * 64 + m) * 2 + mx:                                                                               \
    err = launch<g, m, mx, C::BOX, C::KS, C::stages<m>(), C::MINB, kConsume>(da, blocks, st); \
    break;
    W4S_LAUNCH(32, 16, 0) W4S_LAUNCH(32, 16, 1) W4S_LAUNCH(32, 32, 0) W4S_LAUNCH(32, 32, 1)
    W4S_LAUNCH(64, 16, 0) W4S_LAUNCH(64, 16, 1) W4S_LAUNCH(64, 32, 0) W4S_LAUNCH(64, 32, 1)
    W4S_LAUNCH(128, 16, 0) W4S_LAUNCH(128, 16, 1) W4S_LAUNCH(128, 32, 0) W4S_LAUNCH(128, 32, 1)
#undef W4S_LAUNCH
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace w4s
}  // namespace
