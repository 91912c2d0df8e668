// K5 and K8: one-token GQA decode attention over layer-stacked paged KV pools.
//
// Replaces paged_attention_decode_dma (sgl_kernel_tpu/ops/attention/
// paged_decode_dma.py:306, Pallas kernel _kernel, pallas_call at :461) and
// paged_attention_decode (ops/attention/paged_decode.py:158, pallas_call at
// :278): the same function over two pool layouts, page-major
// [L, P, Hkv, page, D] and head-major [L, Hkv, P, page, D]. The kernel takes
// the pool's layer, page and head strides, so one kernel reads both.
// Contract: q [B, Hq, D]; page table [B, n_blocks]; lengths [B] count the
// current token. With fresh K/V the pool holds length-1 tokens and the fresh
// row is merged last (paged_decode_dma.py:118-122, :246-271). Options:
// sinks (one logit a q head, in the denominator only, paged_decode.py:145-
// 146), a sliding window (pool position > length-1-window, :87-88), a soft
// cap on pool and fresh scores (:97-98, :131-132), the base-2 lse, and the
// caller's split-KV: split s takes the pool tokens [s T, (s+1) T) of each
// sequence (T = split_tokens, whole chunks of pages as in
// paged_decode_dma.py:383-384) and writes its partial (o rounded to bf16,
// lse); the fresh row and the sinks join the last split (:267-275), and the
// caller merges the partials. A row with no pool tokens and no fresh row
// gives o = 0 and lse = -inf (:277, :281). Pools are bf16, int8, fp8 e4m3 or
// fp8 e5m2; a quantized pool carries per-tensor k/v scales the JAX way
// (:392-405, :498-499): q * k_scale and fresh_k / k_scale, fresh_v / v_scale
// are rounded to bf16, and the bf16 output is multiplied by out_scale
// (v_scale, or 1 when the caller merges splits and scales after) and
// rounded again. 1-byte codes convert to bf16 exactly (no denormal flush,
// unlike the TPU's bit-twiddle upcast at :41-70).
//
// Bound: bytes. Every pool token of the batch is read once for K and once
// for V (about 2 x 8,440 x 8 x 128 x 2 B = 35 MB at the main path's ragged
// B=16), against 2 flops per byte (4 from 1-byte pools): far below the
// card's ridge. At B=16 x 8 KV heads there are only 128 (sequence, head)
// pairs for 132 SMs, and the longest sequence is 8x the mean.
//
// Design. The work is cut into units of 64 pool tokens of one (split,
// sequence, KV head): a whole page, or 64 / page whole pages. The grid is
// sized on the host from the SM count and the table width alone; each block
// reads the lengths, counts every item's units (a prefix sum in shared
// memory) and takes an equal share of all of them, so every SM streams the
// same bytes however ragged the lengths, and the lengths never leave the
// device. A producer warp brings each unit's K and V slabs into a three-stage
// mbarrier ring by TMA (two at head dim 256): one box a (page, 64 head dims) in 128-byte-swizzled
// rows (bf16), or one plain box a page of 1-byte codes, which each consumer
// warp converts to bf16 in registers on its way to a swizzled copy. Four
// consumer warps take 16 tokens each: scores S = Q K^T on mma.sync
// m16n8k16 (the G query heads of the KV head are the rows, padded to 16),
// the online softmax in registers in the log2 domain, and O^T = V^T P^T
// with P from the score registers in three bf16 terms (P keeps 24 bits)
// and V^T by transposed ldmatrix, which leaves no padded rows in the output
// accumulators; each unit's products start from zero and join the float32
// sums by rounded adds (the tensor cores' own accumulation truncates). Keys outside [start, length) are masked by a
// select on the score and an and on V's fragment, so whatever the pool
// holds there (NaN included) changes nothing. At the end of an item's run
// the four warps merge in order through shared memory; a run that one
// block holds whole is finished at once, otherwise each block writes its
// float32 partial (m, l, acc) to a workspace and the last block of the
// (split, sequence, head) to arrive (a counter in device memory, reset by
// that block) merges the partials in a fixed order (its four warps take
// every fourth block, then join in warp order), adds the fresh row and
// the sinks and writes o and lse: deterministic, and bit-identical from
// call to call. The window moves an item's first unit; the soft cap is a
// compile-time choice (a runtime select made the loop 1.5x slower).

#include <cuda_fp8.h>

#include "common.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;

constexpr int kTok = 64;                     // pool tokens of a unit: one stage of the ring
constexpr int kWarps = 4;                    // consumer warps, 16 tokens of a unit each
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp

struct Args {
  const bf16 *q, *fresh_k, *fresh_v;
  const float* sinks;  // [Hq] natural-log logits, or null
  const int *lengths, *table;
  bf16* out;      // [S, B, Hq, D] (S = n_splits)
  float* lse;     // [S, B, Hq] base 2, or null
  float* ws;      // partials: [gridDim.x][2][G * D + 2 G] float32
  int* counters;  // [S, B, Hkv], zero between calls
  int batch, n_kv_heads, page, n_blocks;
  long long layer_stride, page_stride, head_stride;  // pool elements
  int layer, n_splits, split_tokens, window;        // window < 0: none
  float q_mul;     // sm_scale, times log2(e) without a soft cap
  float soft_cap;  // 0: none
  float k_scale, v_scale, out_scale;
};

struct alignas(64) KArgs {
  CUtensorMap tk, tv;  // the K and V pools as [rows][D]
  Args a;
};

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// byte offset of 16-byte chunk c16 (along D) of row r in a bf16 tile of
// `rows` rows, stored as D / 64 swizzled [rows][64] sub-tiles
__device__ __forceinline__ uint32_t tile_off(int r, int c16, int rows) {
  return (uint32_t)((c16 >> 3) * rows * 128) + skt::sw128(r, c16 & 7);
}

// Item i = (split s, sequence b): its pool tokens [lo, hi), the first
// 64-token chunk j0 and its n >= 1 units (one empty unit when hi <= lo: the
// fresh row and the sinks still need a block).
struct Item {
  int lo, hi, j0, n;
};

__device__ __forceinline__ Item item_of(const Args& a, const int* lens, int i) {
  const int s = i / a.batch, length = lens[i % a.batch];
  int n = a.fresh_k ? length - 1 : length;
  n = max(0, min(n, a.n_blocks * a.page));
  Item it;
  it.lo = max(s * a.split_tokens, a.window >= 0 ? length - a.window : 0);
  it.hi = (int)min((long long)n, (long long)(s + 1) * a.split_tokens);
  it.j0 = it.hi > it.lo ? it.lo / kTok : 0;
  it.n = it.hi > it.lo ? (it.hi + kTok - 1) / kTok - it.j0 : 1;
  return it;
}

// A position in the unit order: item i, KV head h, unit jj of the (i, h)
// run. Unit u of the launch is Hkv * pre[i] + h * n_i + jj, pre the
// exclusive prefix of the items' unit counts.
struct Cursor {
  int i, h, jj;
};

__device__ __forceinline__ Cursor locate(const int* pre, int n_items, int hkv, long long u) {
  int lo = 0, hi = n_items - 1;  // the last item whose units start at or before u
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if ((long long)hkv * pre[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  const long long r = u - (long long)hkv * pre[lo];
  const int n = pre[lo + 1] - pre[lo];
  return Cursor{lo, (int)(r / n), (int)(r % n)};
}

__device__ __forceinline__ void advance(Cursor& c, const int* pre, int hkv) {
  if (++c.jj == pre[c.i + 1] - pre[c.i]) {
    c.jj = 0;
    if (++c.h == hkv) {
      c.h = 0;
      ++c.i;
    }
  }
}

// 16 rows of 1-byte codes (a [kTok][D] stage tile from row0) -> bf16 in a
// swizzled [16][D] tile, exactly
template <typename T, int D>
__device__ __forceinline__ void convert16(const uint8_t* src, int row0, uint8_t* dst, int lane) {
  constexpr int CPR = D / 16;  // 16-byte chunks of a row
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int r = c / CPR, cc = c % CPR;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + cc * 16);
    __align__(16) bf16 h[16];
    skt::to_bf16x16(reinterpret_cast<const T*>(&raw), h);
    *reinterpret_cast<uint4*>(dst + tile_off(r, 2 * cc, 16)) = *reinterpret_cast<const uint4*>(h);
    *reinterpret_cast<uint4*>(dst + tile_off(r, 2 * cc + 1, 16)) = *reinterpret_cast<const uint4*>(h + 8);
  }
}

// q of (b, h) as the A fragments of S = Q K^T: row gq is query head gq of
// the group (rows >= G and the upper 8 rows are zero), d pairs 2tq (+8) of
// each 16-deep step; q * k_scale rounded to bf16 as the JAX kernel does
template <int D, int G>
__device__ __forceinline__ void load_q(const Args& a, int b, int h, int lane, uint32_t (&qa)[D / 16][2]) {
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* qr = a.q + ((long long)b * a.n_kv_heads * G + h * G + gq) * D;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t v = 0u;
      if (gq < G) {
        const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(qr + 16 * ks + 2 * tq + 8 * hf);
        v = skt::pack_bf16x2(round_bf16(__low2float(x) * a.k_scale), round_bf16(__high2float(x) * a.k_scale));
      }
      qa[ks][hf] = v;
    }
}

// One warp's 16 keys (rows r0.. of the K and V tiles, keys [klo, khi)
// valid) into its online softmax state: m and l of query row gq (l is this
// thread's share of the row sum), o the O^T accumulators (o[dt][e] is
// O^T[16 dt + gq + 8 (e >> 1)][2 tq + (e & 1)]).
template <int D, int G, bool CAP>
__device__ __forceinline__ void attend16(const uint8_t* kt, const uint8_t* vt, int rows, int r0, int lane,
                                         const uint32_t (&qa)[D / 16][2], int klo, int khi, const Args& a, float& m,
                                         float& l, float (&o)[D / 16][4]) {
  const int gq = lane >> 2, tq = lane & 3;
  const int lr = r0 + (lane >> 4) * 8 + (lane & 7), lc = (lane >> 3) & 1;  // this lane's ldmatrix row, chunk
  // Each tensor-core product starts from zero and joins the float32 sums
  // by a rounded add: an mma's own accumulation truncates, and over a long
  // context that would bias o by ~1e-5 (enough to move split partials,
  // rounded to bf16, by an ulp).
  float s[2][4] = {};
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t kf[4];  // keys 0-7 / 8-15 of the warp, d 16 ks + 0-7 / 8-15
    skt::ldsm_x4(kf, kt + tile_off(lr, 2 * ks + lc, rows));
    const uint32_t af[4] = {qa[ks][0], 0u, qa[ks][1], 0u};
    float t[2][4] = {};
    skt::mma_bf16(t[0], af, kf[0], kf[1]);
    skt::mma_bf16(t[1], af, kf[2], kf[3]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[0][e] += t[0][e];
      s[1][e] += t[1][e];
    }
  }
  // s[j][e] (e < 2) is the score of query gq and key 8 j + 2 tq + e
  bool ok[2][2];
  float x[2][2], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int kk = 8 * j + 2 * tq + e;
      ok[j][e] = kk >= klo && kk < khi;
      const float v = CAP ? a.soft_cap * tanhf(s[j][e] * a.q_mul / a.soft_cap) * skt::kLog2e : s[j][e] * a.q_mul;
      x[j][e] = ok[j][e] && gq < G ? v : -INFINITY;  // a select: a masked key's NaN score drops out
      mx = fmaxf(mx, x[j][e]);
    }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);  // m starts finite (kMaxInit): alpha is never NaN
  const float alpha = exp2f(m - m_new);
  float p[2][2], ps = 0.f;
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      p[j][e] = exp2f(x[j][e] - m_new);
      ps += p[j][e];
    }
  l = l * alpha + ps;
  m = m_new;
  // O^T's columns 2 tq and 2 tq + 1 are query rows held by lanes 8 tq, 8 tq + 4
  const float alpha_a = __shfl_sync(0xffffffffu, alpha, 8 * tq), alpha_b = __shfl_sync(0xffffffffu, alpha, 8 * tq + 4);
  // P^T as mma B fragments, P = hi + mid + lo in bf16 (24 bits: o is an
  // average of many values and keeps P's relative error, which a caller's
  // split partials, rounded to bf16, would show)
  uint32_t ph[2], pm[2], pl[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float h0 = round_bf16(p[j][0]), h1 = round_bf16(p[j][1]);
    const float m0 = round_bf16(p[j][0] - h0), m1 = round_bf16(p[j][1] - h1);
    ph[j] = skt::pack_bf16x2(h0, h1);
    pm[j] = skt::pack_bf16x2(m0, m1);
    pl[j] = skt::pack_bf16x2(p[j][0] - h0 - m0, p[j][1] - h1 - m1);
  }
  // V^T's fragment holds keys 2 tq, 2 tq + 1 (regs 0, 1) and 8 + 2 tq, 9 + 2 tq (2, 3)
  const uint32_t mask0 = (ok[0][0] ? 0x0000ffffu : 0u) | (ok[0][1] ? 0xffff0000u : 0u);
  const uint32_t mask1 = (ok[1][0] ? 0x0000ffffu : 0u) | (ok[1][1] ? 0xffff0000u : 0u);
#pragma unroll
  for (int dt = 0; dt < D / 16; ++dt) {
    uint32_t va[4];  // V^T rows d 16 dt + 0-7 / 8-15, keys 0-7 / 8-15
    skt::ldsm_x4_trans(va, vt + tile_off(lr, 2 * dt + lc, rows));
    va[0] &= mask0;
    va[1] &= mask0;
    va[2] &= mask1;
    va[3] &= mask1;
    float t[4] = {};
    skt::mma_bf16(t, va, pl[0], pl[1]);
    skt::mma_bf16(t, va, pm[0], pm[1]);
    skt::mma_bf16(t, va, ph[0], ph[1]);
    o[dt][0] = o[dt][0] * alpha_a + t[0];
    o[dt][1] = o[dt][1] * alpha_b + t[1];
    o[dt][2] = o[dt][2] * alpha_a + t[2];
    o[dt][3] = o[dt][3] * alpha_b + t[3];
  }
}

template <typename T, int D, int G>
struct Smem {
  static constexpr bool kByte = sizeof(T) == 1;
  static constexpr int TILE = kTok * D * (int)sizeof(T);  // a unit's K (or V) slab
  static constexpr int STAGE = 2 * TILE;
  static constexpr int kStages = STAGE <= 32768 ? 3 : 2;  // ring depth: two blocks an SM at D = 128 bf16
  static constexpr int CONV_WARP = 2 * 16 * D * 2;        // a warp's bf16 copies of its K and V rows
  static constexpr int CONV = kByte ? kWarps * CONV_WARP : 0;
  static constexpr int PART = G * D + 2 * G;              // floats of a partial: acc [G][D], m [G], l [G]
  // ring, conversion tiles, the merge (o, m, l of each warp, fresh logits),
  // barriers; then lengths and the prefix (sized per launch)
  static constexpr int FIXED = kStages * STAGE + CONV + (kWarps * G * D + 2 * kWarps * G + 8) * 4 + 2 * kStages * 8;
  static size_t bytes(int batch, int n_items) { return 1024 + FIXED + 4 * (size_t)(batch + n_items + 1); }
};

template <typename T, int D, int G, bool CAP>
__global__ void __launch_bounds__(kThreads) decode_kernel(const __grid_constant__ KArgs ka) {
  using L = Smem<T, D, G>;
  const Args& a = ka.a;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* sm_o = reinterpret_cast<float*>(smem + L::kStages * L::STAGE + L::CONV);  // [kWarps][G][D]
  float* sm_m = sm_o + kWarps * G * D;                                           // [kWarps][G]
  float* sm_l = sm_m + kWarps * G;
  float* sm_f = sm_l + kWarps * G;  // [G] the fresh row's logits
  uint64_t* full = reinterpret_cast<uint64_t*>(sm_f + 8);
  uint64_t* empty = full + L::kStages;
  int* lens = reinterpret_cast<int*>(empty + L::kStages);
  int* pre = lens + a.batch;
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_items = a.n_splits * a.batch, hkv = a.n_kv_heads;

  if (tid == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      skt::mbar_init(&full[s], 1);            // the producer's expect_tx
      skt::mbar_init(&empty[s], kWarps);      // one arrival a consumer warp
    }
    skt::mbar_init_fence();
  }
  for (int b = tid; b < a.batch; b += kThreads) lens[b] = a.lengths[b];
  __syncthreads();
  for (int i = tid; i < n_items; i += kThreads) pre[i + 1] = item_of(a, lens, i).n;
  __syncthreads();
  if (warp == 0) {  // exclusive prefix of the unit counts: a chunk a lane, then a warp scan
    const int per = (n_items + 31) / 32, i0 = min(n_items, lane * per), i1 = min(n_items, i0 + per);
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

  // this block's equal share [u0, u1) of all units: the first NB = min(grid,
  // units) blocks take at least one unit each, the rest have none
  const long long U = (long long)hkv * pre[n_items], NB = min((long long)gridDim.x, U);
  if (blockIdx.x >= NB) return;
  const long long u0 = U * blockIdx.x / NB, u1 = U * (blockIdx.x + 1) / NB;

  if (warp == kWarps) {
    // Producer: one thread walks the share and brings each non-empty unit's
    // K and V slabs into the next free stage, one TMA box a page (and 64
    // head dims for bf16); past the pool's end a box reads zeros.
    if (lane != 0) return;
    Cursor c = locate(pre, n_items, hkv, u0);
    const int box = min(a.page, kTok);
    const uint32_t box_bytes = (uint32_t)(box * D * (int)sizeof(T));
    int k = 0;
    for (long long u = u0; u < u1; ++u, advance(c, pre, hkv)) {
      const Item it = item_of(a, lens, c.i);
      if (it.hi <= it.lo) continue;
      const int j = it.j0 + c.jj, t0 = max(it.lo, j * kTok), t1 = min(it.hi, j * kTok + kTok);
      const int st = k % L::kStages;
      if (k >= L::kStages) skt::mbar_wait(&empty[st], ((k / L::kStages) - 1) & 1);
      ++k;
      uint8_t* kd = smem + st * L::STAGE;
      uint8_t* vd = kd + L::TILE;
      const int* pt = a.table + (long long)(c.i % a.batch) * a.n_blocks;
      const long long head = (long long)a.layer * a.layer_stride + (long long)c.h * a.head_stride;
      const int pa = t0 / a.page, pb = (t1 - 1) / a.page;
      skt::mbar_expect_tx(&full[st], 2u * (uint32_t)(pb - pa + 1) * box_bytes);
      for (int pi = pa; pi <= pb; ++pi) {
        const int start = max(pi * a.page, j * kTok);  // first token of the box
        const int row = (int)((head + (long long)pt[pi] * a.page_stride) / D) + start - pi * a.page;
        const int r = start - j * kTok;                // its row in the stage
        if constexpr (L::kByte) {
          skt::tma_load_2d(kd + r * D, &ka.tk, 0, row, &full[st]);
          skt::tma_load_2d(vd + r * D, &ka.tv, 0, row, &full[st]);
        } else {
#pragma unroll
          for (int sub = 0; sub < D / 64; ++sub) {
            skt::tma_load_2d(kd + sub * kTok * 128 + r * 128, &ka.tk, 64 * sub, row, &full[st]);
            skt::tma_load_2d(vd + sub * kTok * 128 + r * 128, &ka.tv, 64 * sub, row, &full[st]);
          }
        }
      }
    }
    return;
  }

  // Consumers: warp w takes tokens 16 w .. 16 w + 15 of each unit.
  const int gq = lane >> 2, tq = lane & 3;
  uint8_t* conv = smem + L::kStages * L::STAGE + warp * L::CONV_WARP;
  auto block_of = [&](long long u) { return ((u + 1) * NB + U - 1) / U - 1; };
  Cursor c = locate(pre, n_items, hkv, u0);
  int k = 0;
  uint32_t qa[D / 16][2];
  float m = skt::kMaxInit, l = 0.f, o[D / 16][4];
  for (long long u = u0; u < u1; ++u, advance(c, pre, hkv)) {
    const Item it = item_of(a, lens, c.i);
    const int b = c.i % a.batch, s = c.i / a.batch, n_i = pre[c.i + 1] - pre[c.i];
    if (u == u0 || c.jj == 0) {  // a new (item, head) run
      load_q<D, G>(a, b, c.h, lane, qa);
      m = skt::kMaxInit;
      l = 0.f;
#pragma unroll
      for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
    }
    if (it.hi > it.lo) {
      const int j = it.j0 + c.jj, t0 = max(it.lo, j * kTok), t1 = min(it.hi, j * kTok + kTok);
      const int st = k % L::kStages;
      skt::mbar_wait(&full[st], (k / L::kStages) & 1);
      ++k;
      const uint8_t* kt = smem + st * L::STAGE;
      const int w0 = j * kTok + 16 * warp;  // the warp's first token
      const int klo = max(0, t0 - w0), khi = min(16, t1 - w0);
      if (klo >= khi) {
        __syncwarp();
        if (lane == 0) skt::mbar_arrive(&empty[st]);
      } else if constexpr (L::kByte) {
        __syncwarp();  // the last unit's reads of the conversion tiles are done
        convert16<T, D>(kt, 16 * warp, conv, lane);
        convert16<T, D>(kt + L::TILE, 16 * warp, conv + 16 * D * 2, lane);
        __syncwarp();
        if (lane == 0) skt::mbar_arrive(&empty[st]);  // copied: the stage can refill now
        attend16<D, G, CAP>(conv, conv + 16 * D * 2, 16, 0, lane, qa, klo, khi, a, m, l, o);
      } else {
        attend16<D, G, CAP>(kt, kt + L::TILE, kTok, 16 * warp, lane, qa, klo, khi, a, m, l, o);
        __syncwarp();
        if (lane == 0) skt::mbar_arrive(&empty[st]);
      }
    }
    if (u + 1 < u1 && c.jj + 1 < n_i) continue;

    // The end of this block's part of the (item, head) run: the warps'
    // states to shared memory, with the fresh row's logits (last split).
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (tq == 0 && gq < G) {
      sm_m[warp * G + gq] = m;
      sm_l[warp * G + gq] = l;
    }
#pragma unroll
    for (int dt = 0; dt < D / 16; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 2 * tq + (e & 1);
        if (g < G) sm_o[(warp * G + g) * D + 16 * dt + gq + 8 * (e >> 1)] = o[dt][e];
      }
    const bool last_split = s == a.n_splits - 1;
    if (last_split && a.fresh_k) {
      const bf16* fk = a.fresh_k + ((long long)b * hkv + c.h) * D;
      for (int g = warp; g < G; g += kWarps) {
        const bf16* qr = a.q + ((long long)b * hkv * G + c.h * G + g) * D;
        float dot = 0.f;
        for (int d = lane; d < D; d += 32)
          dot += round_bf16(__bfloat162float(qr[d]) * a.k_scale) * round_bf16(__bfloat162float(fk[d]) / a.k_scale);
        dot = skt::warp_sum(dot);
        if (lane == 0)
          sm_f[g] = CAP ? a.soft_cap * tanhf(dot * a.q_mul / a.soft_cap) * skt::kLog2e : dot * a.q_mul;
      }
    }
    skt::named_sync(1, 32 * kWarps);

    // o and lse from the merged state: the fresh row, then the sinks (last split)
    const int hq = hkv * G;
    auto finalize = [&](int g, int d, float mt, float lt, float at) {
      if (last_split && a.fresh_k) {
        const float sf = sm_f[g], m_new = fmaxf(mt, sf);
        const float alpha = exp2f(mt - m_new), pf = exp2f(sf - m_new);
        const float vf = round_bf16(__bfloat162float(a.fresh_v[((long long)b * hkv + c.h) * D + d]) / a.v_scale);
        lt = lt * alpha + pf;
        at = at * alpha + pf * vf;
        mt = m_new;
      }
      if (last_split && a.sinks) {  // a logit with no value: the running max and the denominator
        const float sk = a.sinks[c.h * G + g] * skt::kLog2e, m_new = fmaxf(mt, sk);
        const float alpha = exp2f(mt - m_new);
        lt = lt * alpha + exp2f(sk - m_new);
        at = at * alpha;
        mt = m_new;
      }
      const long long row = ((long long)s * a.batch + b) * hq + c.h * G + g;
      a.out[row * D + d] = __float2bfloat16(round_bf16(lt == 0.f ? 0.f : at / lt) * a.out_scale);
      if (a.lse && d == 0) a.lse[row] = lt == 0.f ? -INFINITY : mt + log2f(lt);
    };

    const long long us = (long long)hkv * pre[c.i] + (long long)c.h * n_i;  // the run's units [us, us + n_i)
    const long long cf = block_of(us), cl = block_of(us + n_i - 1);
    float* part = a.ws + ((long long)blockIdx.x * 2 + (us <= u0 ? 0 : 1)) * L::PART;
    for (int idx = tid; idx < G * D; idx += 32 * kWarps) {  // the four warps in order
      const int g = idx / D, d = idx % D;
      float mt = skt::kMaxInit, lt = 0.f, at = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w * G + g]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float cw = exp2f(sm_m[w * G + g] - mt);
        lt += sm_l[w * G + g] * cw;
        at += sm_o[(w * G + g) * D + d] * cw;
      }
      if (cf == cl) {
        finalize(g, d, mt, lt, at);
      } else {
        part[idx] = at;
        if (d == 0) {
          part[G * D + g] = mt;
          part[G * D + G + g] = lt;
        }
      }
    }
    if (cf != cl) {
      // several blocks share the run: the last to arrive merges their
      // partials in block order
      int* counter = a.counters + (long long)c.i * hkv + c.h;
      __threadfence();
      skt::named_sync(1, 32 * kWarps);
      if (tid == 0) s_last = atomicAdd(counter, 1) == (int)(cl - cf);
      skt::named_sync(1, 32 * kWarps);
      if (s_last) {
        __threadfence();
        // The merge: warp w takes contributors w, w + 4, .. in order, the
        // warps' sums join in warp order, all against the run's max.
        auto part_of = [&](long long cb) {
          return a.ws + (cb * 2 + (cb == cf && U * cb / NB < us ? 1 : 0)) * L::PART;
        };
        const int n_c = (int)(cl - cf + 1);
        if (lane < G) {
          float mw = skt::kMaxInit;
          for (int j = warp; j < n_c; j += kWarps) mw = fmaxf(mw, __ldcg(part_of(cf + j) + G * D + lane));
          sm_m[warp * G + lane] = mw;
        }
        skt::named_sync(1, 32 * kWarps);
        float mrow[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          mrow[g] = skt::kMaxInit;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) mrow[g] = fmaxf(mrow[g], sm_m[w * G + g]);
        }
        constexpr int PER = G * D / 32;  // elements a lane: element lane + 32 e is of query row 32 e / D
        float acc[PER], lw = 0.f;
#pragma unroll
        for (int e = 0; e < PER; ++e) acc[e] = 0.f;
        float ml = skt::kMaxInit;  // the run's max of query row `lane` (lane < G)
#pragma unroll
        for (int w = 0; w < kWarps; ++w) ml = fmaxf(ml, lane < G ? sm_m[w * G + lane] : skt::kMaxInit);
#pragma unroll 2
        for (int j = warp; j < n_c; j += kWarps) {
          const float* pc = part_of(cf + j);
          float cw[G];
#pragma unroll
          for (int g = 0; g < G; ++g) cw[g] = exp2f(__ldcg(pc + G * D + g) - mrow[g]);
          if (lane < G) lw += __ldcg(pc + G * D + G + lane) * exp2f(__ldcg(pc + G * D + lane) - ml);
#pragma unroll
          for (int e = 0; e < PER; ++e) acc[e] += __ldcg(pc + lane + 32 * e) * cw[32 * e / D];
        }
        skt::named_sync(1, 32 * kWarps);  // every warp has read sm_m
#pragma unroll
        for (int e = 0; e < PER; ++e) sm_o[warp * G * D + lane + 32 * e] = acc[e];
        if (lane < G) sm_l[warp * G + lane] = lw;
        skt::named_sync(1, 32 * kWarps);
        for (int idx = tid; idx < G * D; idx += 32 * kWarps) {
          const int g = idx / D, d = idx % D;
          float mt = skt::kMaxInit, lt = 0.f, at = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) {
            mt = fmaxf(mt, sm_m[w * G + g]);
            lt += sm_l[w * G + g];
            at += sm_o[w * G * D + idx];
          }
          finalize(g, d, mt, lt, at);
        }
        if (tid == 0) *counter = 0;  // ready for the next call
      }
    }
    skt::named_sync(1, 32 * kWarps);  // the next run rewrites sm_o, sm_m, sm_l, sm_f
  }
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a, const void* k_pool, const void* v_pool, long long pool_rows, int ws_blocks,
                   cudaStream_t st) {
  using L = Smem<T, D, G>;
  KArgs ka;
  ka.a = a;
  const int box = min(a.page, kTok);
  const int cols = L::kByte ? D : 64;
  if (!skt::map_2d(&ka.tk, k_pool, sizeof(T), pool_rows, D, D, cols, box, !L::kByte) ||
      !skt::map_2d(&ka.tv, v_pool, sizeof(T), pool_rows, D, D, cols, box, !L::kByte))
    return cudaErrorInvalidValue;
  const void* kernel = a.soft_cap > 0.f ? (const void*)decode_kernel<T, D, G, true>
                                        : (const void*)decode_kernel<T, D, G, false>;
  const int n_items = a.n_splits * a.batch;
  const size_t smem = L::bytes(a.batch, n_items);
  static size_t smem_set[2] = {0, 0};  // the dynamic shared memory each kernel may take so far
  size_t& set = smem_set[a.soft_cap > 0.f];
  if (smem > set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    set = smem;
  }
  // the grid: as many blocks as fit the card at once, at most one per unit
  // the table could hold
  const int span = (int)min((long long)a.split_tokens, (long long)a.n_blocks * a.page);
  const long long units_max = (long long)n_items * a.n_kv_heads * ((span + kTok - 1) / kTok + 1);
  // blocks an SM holds: shared memory binds (228 KB an SM, 1 KB of it reserved a block)
  const int per_sm = max(1, (int)((228 * 1024) / (smem + 1024)));
  const int grid = (int)min((long long)min(ws_blocks, per_sm * skt::sm_count()), units_max);
  void* params[] = {&ka};
  return cudaLaunchKernel(kernel, dim3(grid), dim3(kThreads), params, smem, st);
}

template <typename T, int D>
cudaError_t dispatch_group(int group, const Args& a, const void* kp, const void* vp, long long rows, int wsb,
                           cudaStream_t st) {
  switch (group) {
    case 1: return launch<T, D, 1>(a, kp, vp, rows, wsb, st);
    case 2: return launch<T, D, 2>(a, kp, vp, rows, wsb, st);
    case 4: return launch<T, D, 4>(a, kp, vp, rows, wsb, st);
    case 8: return launch<T, D, 8>(a, kp, vp, rows, wsb, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, int group, const Args& a, const void* kp, const void* vp, long long rows,
                         int wsb, cudaStream_t st) {
  switch (head_dim) {
    case 64: return dispatch_group<T, 64>(group, a, kp, vp, rows, wsb, st);
    case 128: return dispatch_group<T, 128>(group, a, kp, vp, rows, wsb, st);
    case 256: return dispatch_group<T, 256>(group, a, kp, vp, rows, wsb, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fresh_k/fresh_v, sinks and lse may be null. The pools are [pool_rows][D]
// row-major in all (both layouts), 16-byte aligned; strides are in pool
// elements: page-major pools have head_stride = page * D, page_stride =
// Hkv * page * D; head-major ones page_stride = page * D, head_stride =
// P * page * D. out is [n_splits, B, Hq, D] and lse [n_splits, B, Hq]
// (required when n_splits > 1), split s covering the pool tokens
// [s split_tokens, (s + 1) split_tokens). ws holds ws_blocks x 2 x
// (group * head_dim + 2 group) floats; counters n_splits x B x Hkv ints,
// zero before the first call (every call leaves them zero). Supported:
// head_dim 64, 128, 256; group 1, 2, 4, 8; page a multiple of 8 that
// divides 64 or is a multiple of 64; pool_type 0 bf16, 1 int8, 2 fp8 e4m3,
// 3 fp8 e5m2 (q, fresh rows and output bf16); window < 0 and soft_cap = 0
// turn those options off; scales of 1 for unscaled pools.
extern "C" int skt_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* fresh_k, const void* fresh_v,
    const void* sinks, const void* lengths, const void* table, void* out, void* lse, void* ws, void* counters,
    int batch, int n_kv_heads, int page, int n_blocks, int head_dim, int group, int pool_type,
    long long pool_rows, long long layer_stride, long long page_stride, long long head_stride, int layer,
    int n_splits, int split_tokens, int window, float sm_scale, float soft_cap, float k_scale, float v_scale,
    float out_scale, int ws_blocks, void* stream) {
  if (n_splits < 1 || (n_splits > 1 && (!lse || split_tokens < 1)) || batch < 1 || ws_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (page < 8 || page % 8 || (page % kTok && kTok % page) || pool_rows >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const Args a{(const bf16*)q, (const bf16*)fresh_k, (const bf16*)fresh_v, (const float*)sinks,
               (const int*)lengths, (const int*)table, (bf16*)out, (float*)lse, (float*)ws, (int*)counters,
               batch, n_kv_heads, page, n_blocks, layer_stride, page_stride, head_stride, layer, n_splits,
               n_splits > 1 ? split_tokens : (1 << 30), window,
               soft_cap > 0.f ? sm_scale : sm_scale * skt::kLog2e, soft_cap, k_scale, v_scale, out_scale};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (pool_type) {
    case 0: err = dispatch_dim<bf16>(head_dim, group, a, k_pool, v_pool, pool_rows, ws_blocks, st); break;
    case 1: err = dispatch_dim<int8_t>(head_dim, group, a, k_pool, v_pool, pool_rows, ws_blocks, st); break;
    case 2: err = dispatch_dim<__nv_fp8_e4m3>(head_dim, group, a, k_pool, v_pool, pool_rows, ws_blocks, st); break;
    case 3: err = dispatch_dim<__nv_fp8_e5m2>(head_dim, group, a, k_pool, v_pool, pool_rows, ws_blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
