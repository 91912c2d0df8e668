// K13a: MLA paged decode: H query heads against one shared 576-wide latent
// row per cached token, read once as K (576) and as V (its first 512).
//
// Replaces mla_decode (sgl_kernel_tpu/ops/attention/mla.py:375, Pallas kernel
// _decode_kernel at :51, pallas_call at :474). Contract: q [B, H, 576] =
// [q_nope (latent) 512 | q_pe 64] bf16, any H, in groups of 16 heads; pool
// [L, P, page, W] (W 576, or 640 with 64 pad lanes) of bf16, int8, fp8 e4m3
// or fp8 e5m2, layer `layer`, any page size (1: NSA's one-row pages); page
// table [B, n_blocks]; lengths [B] (the tokens of each sequence in the pool,
// the current one included). out [B, H, 512] bf16; lse [B, H] float32 base 2
// when its pointer is not null. A sequence of length 0 gives o = 0 and lse
// -1e30 * log2(e) (the K7 convention), or -inf with empty_inf (a uniform
// flag: K13b, mla_decode(engine="dma"), replacing _mla_decode_dma at
// mla.py:287, pallas_call at :321, launches this kernel with it, as the
// TPU's dma engine gives -inf there, mla.py:275). The pad lanes of a
// 640-wide pool are not read. A latent scale enters only folded into
// sm_scale, by the caller.
//
// Numbers. bf16 pools: scores from exact bf16 products summed in float32, P
// in two bf16 terms (~2^-16), so the result matches a float32 P.V. 1-byte
// pools: their codes convert exactly to fp16 (every int8 and fp8 value is a
// half), not through the TPU's flush-to-zero upcast (paged_decode_dma.py:
// 41-70), q's bf16 values become halves (exactly for magnitudes from 2^-14
// to 65,504) and P enters as one fp16 term (2^-11): one product a tile where
// bf16 needs two. Softmax in float32 in the log2 domain; o rounded once.
//
// Bound: bytes. A call reads each sequence's cached rows once for each group
// of 16 heads (DeepSeek-V2-Lite has one group: at B=16 and contexts 1..1,056,
// 10 MB in bf16, half that from 1-byte pools), against 2 x 16 x (576 + 512)
// flops a row: ~30 flops a byte, far below the card's ridge.
//
// Design. The work is cut into units of 64 pool tokens of one (sequence,
// group of 16 heads); a sequence of length 0 has one empty unit, which writes
// its zeros. The grid is sized on the host from the SM count alone: each
// block reads the lengths, counts every sequence's units (a prefix sum in
// shared memory) and takes an equal share of all units, at least two (see
// kMinShare), so every SM streams the same bytes however ragged the lengths,
// and neither the lengths nor the table's capacity shape the launch. A
// producer warp keeps a ring of 64-row stages in flight on mbarriers: each
// lane brings rows by 1-D bulk copies (cp.async.bulk, complete_tx), one a row
// of 1,152 or 576 bytes through the page table, which serves dense pages,
// one-row pages and 640-wide rows alike (a TMA box a page streams dense pages
// a little faster but cannot take one-row pages); rows are padded in shared
// memory (584 bf16, or 592 bytes) against bank conflicts. Eight consumer
// warps run the 16 heads as the rows of mma.sync m16n8k16 tiles (warp w
// scores keys 8w..8w+7 over all 576 dims, then owns 64 of the 512 output
// columns of P.V); a 1-byte stage is first converted into one shared fp16
// tile, which frees the stage for the producer. Keys at or past the length
// are masked by a select on the score and an and on V's fragment, so
// whatever the stage holds there (NaN included) changes nothing. Two stages
// of bf16 rows, or three of 1-byte rows beside the tile, fit one block an SM.
// A run that one block holds whole is finished by it; otherwise each block
// writes its float32 partial (o normalized, and its lse) to a workspace and
// the last block to arrive (a counter in device memory that this block
// resets) merges the partials in block order: one launch a call,
// deterministic, and bit-equal from call to call.

#include <cuda_fp8.h>

#include <limits>

#include "mla_tile.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;
using skt::kMlaRow;
using skt::kMlaRows;

constexpr int kTok = skt::kMlaBN;           // pool tokens of a unit: one stage of the ring
constexpr int kWarps = skt::kMlaWarps;      // consumer warps: one a group of 8 keys
constexpr int kCThreads = 32 * kWarps;      // consumer threads
constexpr int kThreads = kCThreads + 32;    // and one producer warp
constexpr int kDV = 512;                    // output columns
constexpr int kPart = kMlaRows * kDV + kMlaRows;  // floats of a partial: o [16][512], lse [16]
// units a block takes at least: at few units a sequence (B=16 at contexts
// to ~1k) halving the blocks halves the partials a long run's merge reads,
// which costs more than the second unit a block streams
constexpr int kMinShare = 2;

struct Args {
  const bf16* q;
  const uint8_t* pool;
  const int *lengths, *table;
  bf16* out;
  float* lse;     // null: not written
  float* ws;      // partials: [gridDim.x][2][kPart]
  int* counters;  // [B][groups], zero between calls
  int batch, n_heads, n_groups, page, width, n_blocks;
  long long layer_rows;  // pool rows before the layer's
  float scale_log2;
  float empty_lse;  // the lse of a length-0 sequence
};

template <typename T>
struct Smem {
  static constexpr bool kByte = sizeof(T) == 1;
  static constexpr int kRowBytes = skt::kMlaD * (int)sizeof(T);          // a row's bytes read: 1,152 or 576
  static constexpr int kStageRow = kByte ? kRowBytes + 16 : kMlaRow * 2;  // its stride in a stage: 1,168 or 592
  static constexpr int kStage = kTok * kStageRow;
  static constexpr int kStages = kByte ? 3 : 2;
  static constexpr int kTile = kByte ? kTok * kMlaRow * 2 : 0;  // the fp16 copy of a 1-byte stage
  static constexpr int kQ = kMlaRows * kMlaRow * 2;
  static constexpr int kP = kMlaRows * skt::kMlaPRow * 2;  // each of P's terms (two bf16, or one fp16)
  static constexpr int kRed = 2 * kWarps * kMlaRows * 4;   // each warp's row max and sum
  // ring, tile, q, P, reductions, the merge's row max and sum, barriers; then the prefix
  static constexpr int kFixed = kStages * kStage + kTile + kQ + 2 * kP + kRed + 2 * kMlaRows * 4 + 2 * kStages * 8;
  static size_t bytes(int batch) { return kFixed + 4 * (size_t)(batch + 1); }
};

__device__ __forceinline__ int length_of(const Args& a, int b) {
  return max(0, min(a.lengths[b], a.n_blocks * a.page));
}

// A position in the unit order: sequence i, head group h, unit jj of the
// (i, h) run. Unit u of the launch is G * pre[i] + h * n_i + jj, pre the
// exclusive prefix of the sequences' unit counts n_i.
struct Cursor {
  int i, h, jj;
};

__device__ __forceinline__ Cursor locate(const int* pre, int n_items, int groups, long long u) {
  int lo = 0, hi = n_items - 1;  // the last sequence whose units start at or before u
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if ((long long)groups * pre[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  const long long r = u - (long long)groups * pre[lo];
  const int n = pre[lo + 1] - pre[lo];
  return Cursor{lo, (int)(r / n), (int)(r % n)};
}

__device__ __forceinline__ void advance(Cursor& c, const int* pre, int groups) {
  if (++c.jj == pre[c.i + 1] - pre[c.i]) {
    c.jj = 0;
    if (++c.h == groups) {
      c.h = 0;
      ++c.i;
    }
  }
}

__device__ __forceinline__ void csync() { skt::named_sync(1, kCThreads); }

// One unit: the 16 rows' q in sq against keys 0..63 of k (row stride ks;
// V is each row's first 512 columns), keys nv.. masked. mla_tile.cuh's
// arithmetic, with the consumers' own barrier (the producer warp never
// joins), q's A and the keys' B fragments by ldmatrix.x4 (two k-steps of the
// warp's 8 keys a load) into two accumulator chains, and V's fragments two
// n-tiles a load. F16 (1-byte pools): q and the tile in fp16 and P as one
// fp16 term (to 2^-11); else bf16 and P as two bf16 terms (to ~2^-16).
// Ends with a barrier, after which k and sq may be rewritten.
template <bool F16>
__device__ __forceinline__ void attend_unit(skt::MlaState<kDV>& st, const bf16* sq, const bf16* k, int ks,
                                            bf16* p_hi, bf16* p_lo, float* red, float scale_log2, int nv) {
  constexpr int NT = skt::MlaState<kDV>::NT;
  auto mma = [](float(&d)[4], const uint32_t(&a)[4], uint32_t b0, uint32_t b1) {
    if constexpr (F16) skt::mma_f16(d, a, b0, b1);
    else skt::mma_bf16(d, a, b0, b1);
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float c[4];
  {
    float c2[2][4] = {};
    const bf16* qa = sq + ((lane & 7) + 8 * ((lane >> 3) & 1)) * kMlaRow + 8 * (lane >> 4);
    const bf16* kb = k + (warp * 8 + (lane & 7)) * ks + 8 * (lane >> 3);
#pragma unroll 3
    for (int kk = 0; kk < skt::kMlaD / 16; kk += 2) {
      uint32_t a0[4], a1[4], bk[4];
      skt::ldsm_x4(a0, qa + kk * 16);
      skt::ldsm_x4(a1, qa + kk * 16 + 16);
      skt::ldsm_x4(bk, kb + kk * 16);
      mma(c2[0], a0, bk[0], bk[1]);
      mma(c2[1], a1, bk[2], bk[3]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) c[e] = c2[0][e] + c2[1][e];
  }
  // c[0], c[1]: row g, keys 8w + 2t, +1; c[2], c[3]: row g + 8
  const int key0 = warp * 8 + 2 * t;
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = key0 + (e & 1) < nv ? c[e] * scale_log2 : __int_as_float(0xff800000);  // -inf
  float* red_max = red;
  float* red_sum = red + kWarps * kMlaRows;
  float mx[2] = {fmaxf(s[0], s[1]), fmaxf(s[2], s[3])};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
  }
  if (t == 0) {
    red_max[warp * kMlaRows + g] = mx[0];
    red_max[warp * kMlaRows + g + 8] = mx[1];
  }
  csync();
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    float m_new = st.m[i];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, red_max[w * kMlaRows + row]);
    alpha[i] = exp2f(st.m[i] - m_new);
    st.m[i] = m_new;
    const float p0 = exp2f(s[2 * i] - m_new), p1 = exp2f(s[2 * i + 1] - m_new);
    const int off = row * skt::kMlaPRow + key0;
    if constexpr (F16) {
      *reinterpret_cast<__half2*>(p_hi + off) = __floats2half2_rn(p0, p1);
    } else {
      const bf16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
      __nv_bfloat162 hi, lo;
      hi.x = h0, hi.y = h1;
      lo.x = __float2bfloat16(p0 - __bfloat162float(h0));
      lo.y = __float2bfloat16(p1 - __bfloat162float(h1));
      *reinterpret_cast<__nv_bfloat162*>(p_hi + off) = hi;
      *reinterpret_cast<__nv_bfloat162*>(p_lo + off) = lo;
    }
    float rs = p0 + p1;
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    if (t == 0) red_sum[warp * kMlaRows + row] = rs;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }
  csync();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red_sum[w * kMlaRows + g + 8 * i];
    st.l[i] = st.l[i] * alpha[i] + sum;
  }
#pragma unroll
  for (int kk = 0; kk < kTok / 16; ++kk) {
    uint32_t ah[4], al[4];
    const int o0 = g * skt::kMlaPRow + kk * 16 + 2 * t, o1 = o0 + 8 * skt::kMlaPRow;
    ah[0] = skt::ld32(p_hi + o0), ah[1] = skt::ld32(p_hi + o1);
    ah[2] = skt::ld32(p_hi + o0 + 8), ah[3] = skt::ld32(p_hi + o1 + 8);
    if constexpr (!F16) {
      al[0] = skt::ld32(p_lo + o0), al[1] = skt::ld32(p_lo + o1);
      al[2] = skt::ld32(p_lo + o0 + 8), al[3] = skt::ld32(p_lo + o1 + 8);
    }
    // V's fragment holds keys 16 kk + 2t, +1 (b0) and 16 kk + 8 + 2t, +1 (b1)
    const int k0 = kk * 16 + 2 * t;
    const uint32_t m0 = (k0 < nv ? 0x0000ffffu : 0u) | (k0 + 1 < nv ? 0xffff0000u : 0u);
    const uint32_t m1 = (k0 + 8 < nv ? 0x0000ffffu : 0u) | (k0 + 9 < nv ? 0xffff0000u : 0u);
    // V's B fragments of two n-tiles a load: matrices (keys 0-7 | 8-15) x (n | n + 1)
    const bf16* vrow = k + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * ks + warp * NT * 8 + 8 * (lane >> 4);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t v[4];
      skt::ldsm_x4_trans(v, vrow + n * 8);
      v[0] &= m0;
      v[1] &= m1;
      v[2] &= m0;
      v[3] &= m1;
      mma(st.acc[n], ah, v[0], v[1]);
      mma(st.acc[n + 1], ah, v[2], v[3]);
      if constexpr (!F16) {
        mma(st.acc[n], al, v[0], v[1]);
        mma(st.acc[n + 1], al, v[2], v[3]);
      }
    }
  }
  csync();
}

// The merge of a run that several blocks share, by the last block to arrive:
// contributors cf, cf + 1, .. (n_c of them) in order; their weights 2^(lse -
// row max) go to wts ([n_c][16] floats, the q tile's space: the next run
// stages its q after this merge), each row's max and weight sum to mrg. Out
// of line: its loads in flight would otherwise take the main loop's registers.
__device__ __noinline__ void merge_run(const Args& a, float* wts, float* mrg, long long cf, int n_c, long long us,
                                       long long U, long long NB, long long row0, int n_rows) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  auto part_of = [&](long long cb) { return a.ws + (cb * 2 + (cb == cf && U * cb / NB < us ? 1 : 0)) * kPart; };
  for (int row = warp; row < kMlaRows; row += kWarps) {
    float m = skt::kMaxInit;
    for (int j = lane; j < n_c; j += 32) m = fmaxf(m, __ldcg(part_of(cf + j) + kMlaRows * kDV + row));
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float w = 0.f;
    for (int j = lane; j < n_c; j += 32) {
      const float x = exp2f(__ldcg(part_of(cf + j) + kMlaRows * kDV + row) - m);
      wts[j * kMlaRows + row] = x;
      w += x;
    }
    w = skt::warp_sum(w);
    if (lane == 0) {
      mrg[row] = m;
      mrg[kMlaRows + row] = w;
    }
  }
  csync();
  // thread tid: output columns 4 (tid % 128) .. + 3 of rows R (tid / 128)
  // .. + R - 1, the contributors in order (R float4 loads in flight; two
  // contributors at a time measured no faster, three slower)
  constexpr int R = kMlaRows * 128 / kCThreads;
  const int col = 4 * (tid % 128), r0 = R * (tid / 128);
  float4 acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int j = 0; j < n_c; ++j) {
    const float* pj = part_of(cf + j) + col;
    float4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = __ldcg(reinterpret_cast<const float4*>(pj + (r0 + r) * kDV));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float w = wts[j * kMlaRows + r0 + r];
      acc[r].x += w * v[r].x;
      acc[r].y += w * v[r].y;
      acc[r].z += w * v[r].z;
      acc[r].w += w * v[r].w;
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (r0 + r < n_rows) {
      const float inv = 1.f / mrg[kMlaRows + r0 + r];
      bf16* o = a.out + (row0 + r0 + r) * kDV + col;
      skt::mla_store_pair(o, acc[r].x * inv, acc[r].y * inv);
      skt::mla_store_pair(o + 2, acc[r].z * inv, acc[r].w * inv);
    }
  if (a.lse != nullptr && tid < n_rows) a.lse[row0 + tid] = mrg[tid] + log2f(mrg[kMlaRows + tid]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) mla_decode_kernel(const Args a) {
  using L = Smem<T>;
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  bf16* tile = reinterpret_cast<bf16*>(smem + L::kStages * L::kStage);
  bf16* sq = reinterpret_cast<bf16*>(smem + L::kStages * L::kStage + L::kTile);
  bf16* p_hi = sq + kMlaRows * kMlaRow;
  bf16* p_lo = p_hi + kMlaRows * skt::kMlaPRow;
  float* red = reinterpret_cast<float*>(p_lo + kMlaRows * skt::kMlaPRow);
  float* mrg = red + L::kRed / 4;  // the merge's row max [16] and weight sum [16]
  uint64_t* full = reinterpret_cast<uint64_t*>(mrg + 2 * kMlaRows);
  uint64_t* empty = full + L::kStages;
  int* pre = reinterpret_cast<int*>(empty + L::kStages);
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = a.n_groups;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      skt::mbar_init(&full[s], 1);   // the producer's expect_tx
      skt::mbar_init(&empty[s], 1);  // one consumer thread, after a barrier of all of them
    }
    skt::mbar_init_fence();
  }
  for (int b = tid; b < a.batch; b += kThreads) {
    const int n = length_of(a, b);
    pre[b + 1] = n > 0 ? (n + kTok - 1) / kTok : 1;  // a length-0 sequence: one empty unit
  }
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the unit counts: a chunk a lane, then a warp scan
    const int per = (a.batch + 31) / 32, i0 = min(a.batch, lane * per), i1 = min(a.batch, i0 + per);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += pre[i + 1];
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    int run = inc - sum;
    for (int i = i0; i < i1; ++i) {
      run += pre[i + 1];
      pre[i + 1] = run;
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();

  // this block's equal share [u0, u1) of all units: the first NB =
  // min(grid, ceil(units / kMinShare)) blocks take one each, the rest none
  const long long U = (long long)groups * pre[a.batch];
  const long long NB = min((long long)gridDim.x, (U + kMinShare - 1) / kMinShare);
  if (blockIdx.x >= NB) return;
  const long long u0 = U * blockIdx.x / NB, u1 = U * (blockIdx.x + 1) / NB;

  if (warp == kWarps) {
    // Producer: walks the share and brings each non-empty unit's rows into
    // the next free stage, one bulk copy a row, rows lane and lane + 32.
    Cursor c = locate(pre, a.batch, groups, u0);
    int k = 0;
    for (long long u = u0; u < u1; ++u, advance(c, pre, groups)) {
      const int len = length_of(a, c.i);
      if (len == 0) continue;
      const int j0 = c.jj * kTok, nv = min(kTok, len - j0);
      // the rows' addresses (rows lane and lane + 32) before the wait for a free stage
      const int* pt = a.table + (long long)c.i * a.n_blocks;
      const uint8_t* src[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int key = j0 + lane + 32 * h;
        const long long row =
            key < len ? a.layer_rows + (long long)pt[key / a.page] * a.page + key % a.page : 0;
        src[h] = a.pool + row * a.width * (long long)sizeof(T);
      }
      const int st = k % L::kStages;
      if (k >= L::kStages) skt::mbar_wait(&empty[st], ((k / L::kStages) - 1) & 1);
      ++k;
      if (lane == 0) skt::mbar_expect_tx(&full[st], (uint32_t)(nv * L::kRowBytes));
      __syncwarp();
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (lane + 32 * h < nv)
          skt::bulk_load(ring + st * L::kStage + (lane + 32 * h) * L::kStageRow, src[h], L::kRowBytes, &full[st]);
    }
    return;
  }

  // Consumers
  Cursor c = locate(pre, a.batch, groups, u0);
  int k = 0;
  skt::MlaState<kDV> st;
  auto block_of = [&](long long u) { return ((u + 1) * NB + U - 1) / U - 1; };
  for (long long u = u0; u < u1; ++u, advance(c, pre, groups)) {
    const int b = c.i, h0 = c.h * kMlaRows, n_i = pre[b + 1] - pre[b];
    const int n_rows = min(kMlaRows, a.n_heads - h0), len = length_of(a, b);
    if (u == u0 || c.jj == 0) {  // a new (sequence, head group) run: its q rows (zero past H)
      constexpr int CH = skt::kMlaD / 8, N = (kMlaRows * CH + kCThreads - 1) / kCThreads;
      uint4 v[N];  // every load issued first
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = tid + j * kCThreads, r = i / CH, d0 = (i % CH) * 8;
        v[j] = i < kMlaRows * CH && r < n_rows
                   ? *reinterpret_cast<const uint4*>(a.q + ((long long)b * a.n_heads + h0 + r) * skt::kMlaD + d0)
                   : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = tid + j * kCThreads, r = i / CH, d0 = (i % CH) * 8;
        if constexpr (L::kByte) {  // the 1-byte pools' product runs in fp16: q's bf16 values as halves
          uint32_t* w = reinterpret_cast<uint32_t*>(&v[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const __half2 h = __float22half2_rn(__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[e])));
            w[e] = *reinterpret_cast<const uint32_t*>(&h);
          }
        }
        if (i < kMlaRows * CH) *reinterpret_cast<uint4*>(sq + r * kMlaRow + d0) = v[j];
      }
      st.init();
      csync();
    }
    if (len > 0) {
      const int nv = min(kTok, len - c.jj * kTok);
      const int s = k % L::kStages;
      skt::mbar_wait(&full[s], (k / L::kStages) & 1);
      ++k;
      const uint8_t* stage = ring + s * L::kStage;
      if constexpr (L::kByte) {
        // the stage to fp16, exactly, rows nv.. as zeros; then the stage is free
        constexpr int CH = skt::kMlaD / 16, N = (kTok * CH + kCThreads - 1) / kCThreads;  // 16-code pieces: of a row, a thread
        uint4 raw[N];  // every load first
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int i = tid + j * kCThreads, r = i / CH, ch = i % CH;
          raw[j] = r < nv && i < kTok * CH ? *reinterpret_cast<const uint4*>(stage + r * L::kStageRow + ch * 16)
                                           : make_uint4(0u, 0u, 0u, 0u);
        }
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int i = tid + j * kCThreads, r = i / CH, ch = i % CH;
          if (i >= kTok * CH) break;
          uint4* dst = reinterpret_cast<uint4*>(tile + r * kMlaRow + ch * 16);
          dst[0] = skt::f16x8_of(reinterpret_cast<const T*>(&raw[j]));
          dst[1] = skt::f16x8_of(reinterpret_cast<const T*>(&raw[j]) + 8);
        }
        csync();
        if (tid == 0) skt::mbar_arrive(&empty[s]);
        attend_unit<true>(st, sq, tile, kMlaRow, p_hi, p_lo, red, a.scale_log2, nv);
      } else {
        attend_unit<false>(st, sq, reinterpret_cast<const bf16*>(stage), kMlaRow, p_hi, p_lo, red, a.scale_log2, nv);
        if (tid == 0) skt::mbar_arrive(&empty[s]);  // the tile's last barrier: every read of the stage is done
      }
    }
    if (u + 1 < u1 && c.jj + 1 < n_i) continue;

    // The end of this block's part of the (sequence, group) run.
    const long long us = (long long)groups * pre[b] + (long long)c.h * n_i;  // the run's units [us, us + n_i)
    const long long cf = block_of(us), cl = block_of(us + n_i - 1);
    const long long row0 = (long long)b * a.n_heads + h0;
    if (cf == cl) {  // (a length-0 sequence's one empty unit always is)
      skt::mla_store<kDV>(
          st, n_rows, [&](int row) { return a.out + (row0 + row) * kDV; },
          [&](int row) { return a.lse == nullptr ? nullptr : a.lse + row0 + row; }, a.empty_lse);
      continue;  // the next run starts with a barrier (q), or the loop ends
    }
    // Several blocks share the run: this block's partial (its first shared
    // run in slot 0, its last in slot 1); the last to arrive merges them.
    float* part = a.ws + ((long long)blockIdx.x * 2 + (us <= u0 ? 0 : 1)) * kPart;
    skt::mla_store<kDV>(
        st, kMlaRows, [&](int row) { return part + row * kDV; }, [&](int row) { return part + kMlaRows * kDV + row; });
    int* counter = a.counters + (long long)b * groups + c.h;
    __threadfence();
    csync();
    if (tid == 0) s_last = atomicAdd(counter, 1) == (int)(cl - cf);
    csync();
    if (!s_last) continue;
    __threadfence();
    merge_run(a, reinterpret_cast<float*>(sq), mrg, cf, (int)(cl - cf + 1), us, U, NB, row0, n_rows);
    if (tid == 0) *counter = 0;  // ready for the next call
    csync();                     // mrg and s_last are rewritten by the next shared run
  }
}

template <typename T>
cudaError_t launch(const Args& a, int ws_blocks, cudaStream_t stream) {
  using L = Smem<T>;
  const size_t smem = L::bytes(a.batch);
  static size_t smem_set = 0;  // the dynamic shared memory the kernel may take so far
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  // blocks an SM holds: shared memory binds (228 KB an SM, 1 KB of it reserved a block)
  const int per_sm = max(1, (int)((228 * 1024) / (smem + 1024)));
  // at most 292 blocks: a merge keeps each contributor's 16 weights in the q tile's 18,688 bytes
  const int grid = min(min(ws_blocks, per_sm * skt::sm_count()), L::kQ / (kMlaRows * 4));
  mla_decode_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// pool_type 0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2; width 576 or 640; the
// pool [n_layers][n_pages][page][width] 16-byte aligned; lse may be null.
// ws holds ws_blocks x 2 x (16 x 512 + 16) floats; counters batch x
// ceil(n_heads / 16) ints, zero before the first call (every call leaves
// them zero). batch <= 2048 (the prefix lives in shared memory). empty_inf:
// a length-0 sequence's lse is -inf, else -1e30 * log2(e).
extern "C" int skt_mla_decode(const void* q, const void* pool, const void* lengths, const void* table, void* out,
                              void* lse, void* ws, void* counters, int batch, int n_heads, int n_pages, int page,
                              int width, int n_blocks, int layer, int pool_type, float sm_scale, int empty_inf,
                              int ws_blocks, void* stream) {
  if ((width != 576 && width != 640) || batch > 2048 || n_heads < 1 || page < 1 || n_blocks < 1 || ws_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{(const bf16*)q, (const uint8_t*)pool, (const int*)lengths, (const int*)table, (bf16*)out,
               (float*)lse, (float*)ws, (int*)counters, batch, n_heads, (n_heads + kMlaRows - 1) / kMlaRows, page,
               width, n_blocks, (long long)layer * n_pages * page, sm_scale * skt::kLog2e,
               empty_inf ? -std::numeric_limits<float>::infinity() : -1e30f * skt::kLog2e};
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pool_type) {
    case 0: return (int)launch<bf16>(a, ws_blocks, st);
    case 1: return (int)launch<int8_t>(a, ws_blocks, st);
    case 2: return (int)launch<__nv_fp8_e4m3>(a, ws_blocks, st);
    case 3: return (int)launch<__nv_fp8_e5m2>(a, ws_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
