// The flash-attention tile shared by K7 (flash_prefill.cu) and K9
// (flash_packed.cu) at head dims 64 and 128, and K7 at 256: one warpgroup (4 warps, 128
// threads) computes 64 query rows of one head against the key rows they may
// see, on Hopper's warpgroup MMA (wgmma) with float32 accumulators. The two
// kernels differ only in how a block finds its rows (a padded [B, S, H, D]
// batch, or block-aligned packed tokens with per-block metadata). Its steps
// (flash_scores, flash_softmax_pv, flash_store over a FlashAcc) are also
// K16's tile (sparse_vs.cu), there fed by a producer warp.
//
// Shared memory (dynamic, FlashSmem<D>::kBytes): the q tile and two slots
// each of K and V tiles, 64 keys a tile, every tile [64][D] bf16 stored as
// D/64 swizzled [64][64] sub-tiles (common.cuh), so wgmma reads them without
// bank conflicts through matrix descriptors. At D=128 that is 16 KB +
// 2 x 2 x 16 KB: two blocks fit an SM.
//
// D=256 (hybrid GDN's attention layers, 16 heads of 256 over 2): 32 KB + 2 x
// 2 x 32 KB, about 161 KB with the slack, one block an SM. One warpgroup
// would hold O in 128 float32 registers a thread beside S's 32 and P's two
// bf16 terms (32): ptxas spilled it at the 255-register cap (a register an
// asynchronous wgmma uses must not spill). So a block runs two warpgroups
// (256 threads) on the same 64 rows: each computes S = q K^T over all 256
// dims and the same softmax, and P V for its own 128 columns of O (64
// registers). The scores are computed twice, a third more tensor work. Tiles are filled by cp.async, whose
// zero-fill keeps every key row at or past kv_len unread, and zero in
// shared memory (so 0 x NaN never reaches P V).
//
// Key tile j: S = q K_j^T is D/16 wgmma m64n64k16 with both operands in
// shared memory (K stored [key][d] is the K-major B). Each thread then holds
// 2 rows x 16 keys of S in registers; softmax runs on them in the log2
// domain (scale folded into scale_log2), the row max reduced over the 4
// lanes that share a row, the row sums per-thread partials until the end.
// Only a tile that needs the mask builds it: the one that holds kv_len and,
// causal, those past row 0's position. O += P V is wgmma with A = P from
// registers (the S accumulator packed into bf16 pairs is wgmma's register-A
// layout) and B = the V tile read N-major (the transpose-B form), one n64
// slice of the output a sub-tile. Tile j+1 loads into the other slots
// meanwhile. Issuing S_{j+1} beside P_j V_j, so that the softmax runs while
// the product is in flight (FlashAttention-3's intra-warpgroup overlap),
// measured slower on the H100 than this order with two blocks an SM.
//
// Options (gpt-oss's prefill, flash_prefill.py:39-82 of the JAX package):
// a tanh soft cap, s = cap tanh(s / cap) on the scaled score before the
// running max; a sliding window, key positions > the row's - window; sinks,
// one natural-log logit a head added to a row's denominator once, at the
// store, so the lse includes it. Under a window a block visits only the key
// tiles that hold a key some row may see (the TPU kernel's run predicate,
// flash_prefill.py:125-126): from the tile holding row 0's first visible key
// to the causal limit, so a windowed layer costs O(S window) and not O(S^2).
// Every visited tile builds the mask then. tanhf is the accurate one: its
// cost sits in the softmax step, which holds the tensor cores idle.
//
// Numbers. Scores are exact bf16 products summed in float32. P enters P V
// as two bf16 terms, p = hi + lo (hi = bf16(p), lo = bf16(p - hi)), two
// wgmmas each, so P is carried to ~2^-16 and the result matches a float32
// P V, as in mla_tile.cuh; the TPU kernel rounds P to bf16 once
// (flash_prefill.py:63-64), which the plain twins do not copy. The output is
// rounded to bf16 once, after the last tile.
#pragma once

#include "common.cuh"

namespace skt {

constexpr int kFlashBQ = 64;        // query rows of a block: wgmma's M
constexpr int kFlashBK = 64;        // keys of a K/V tile
constexpr int kFlashThreads = 128;  // one warpgroup
constexpr int kFlashStages = 2;     // slots each of K and V tiles
// base-2 lse of a row that sees no key: the plain versions clamp the
// running max at -1e30 (natural log) and the sum at 1e-38, so
// (-1e30 + ln 1e-38) * log2(e), which is -1e30 * log2(e) in float32. Finite,
// so merging two such rows gives weights of 1 and a zero row, never NaN.
constexpr float kEmptyLse = -1e30f * kLog2e;

// The options of a call: window 0 is none; cap_in 0 is no soft cap, else
// scores map to cap_out tanh(s cap_in) (cap_in = scale / cap, cap_out = cap
// log2(e)); sinks [Hq] natural-log logits a head, or null.
struct FlashOpts {
  int window;
  float cap_in, cap_out;
  const float* sinks;
};

// Dynamic shared memory of a block: q, then the stages' K and V tiles, and
// 1 KB of slack to start the first tile on a 1024-byte boundary.
template <int D>
struct FlashSmem {
  static_assert(D == 64 || D == 128 || D == 256, "the wgmma flash tile takes head dims 64, 128 and 256");
  static constexpr int kGroups = D == 256 ? 2 : 1;   // warpgroups a block, each its D / kGroups columns of O
  static constexpr int kThreads = kFlashThreads * kGroups;
  static constexpr int kSub = 64 * 128;              // bytes of one swizzled [64][64] sub-tile
  static constexpr int kTile = (D / 64) * kSub;      // bytes of a [64][D] tile
  static constexpr size_t kBytes = (size_t)kTile * (1 + 2 * kFlashStages) + 1024;
};

// Rows [0, 64) of a bf16 array (row stride `stride` elements) into a
// swizzled [64][D] tile by cp.async, by the block's NT threads; rows at or
// past n_valid are written as zeros and not read.
template <int D, int NT = kFlashThreads>
__device__ __forceinline__ void flash_load_tile(unsigned char* tile, const bf16* __restrict__ src, long long stride,
                                                int n_valid) {
  constexpr int CH = D / 8;  // 16-byte chunks of a row
#pragma unroll
  for (int it = 0; it < 64 * CH / NT; ++it) {
    const int e = it * NT + threadIdx.x, r = e / CH, ch = e % CH;
    const bool ok = r < n_valid;
    cp_async16(tile + (ch / 8) * FlashSmem<D>::kSub + sw128(r, ch % 8), src + (ok ? r * stride : 0) + ch * 8, ok);
  }
}

// The running state of one 64-row tile: each thread's slice of O (rows r0
// and r0 + 8, one n64 slice a 64-column sub-tile of the output; o[n][4c + e]
// at column 64n + 8c + 2t + (e & 1), the lower row for e < 2), and the two
// rows' running max (log2 domain) and partial sums.
template <int D>
struct FlashAcc {
  float o[D / 64][32];
  float m[2], l[2];
  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
    m[0] = m[1] = kMaxInit;
    l[0] = l[1] = 0.f;
  }
};

// S = q K^T for one 64-key tile, both operands K-major swizzled [64][D]
// tiles in shared memory. s[4c + e]: row r0 + 8 ((e >> 1) & 1), key 8c +
// 2t + (e & 1).
template <int D>
__device__ __forceinline__ void flash_scores(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
  constexpr int SUB = FlashSmem<D>::kSub;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * SUB + (kk % 4) * 32;  // 16 columns: 32 bytes along the row
    wgmma_m64n64k16_ss(s, wgmma_desc(q_addr + off, 16, 1024), wgmma_desc(k_addr + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// The same with q as wgmma's register A: qf[kk] holds columns 16kk .. 16kk +
// 15 of the thread's rows (flash_q_frags), so only K is read from shared
// memory.
template <int D>
__device__ __forceinline__ void flash_scores(float (&s)[32], uint32_t (&qf)[D / 16][4], uint32_t k_addr) {
  constexpr int SUB = FlashSmem<D>::kSub;
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) fence_regs(qf[kk]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_m64n64k16_rs<false>(s, qf[kk], wgmma_desc(k_addr + (kk / 4) * SUB + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) fence_regs(qf[kk]);
}

// wgmma's register A fragments of a swizzled [64][D] q tile (warp w: rows
// 16w .. 16w + 15), by ldmatrix
template <int D>
__device__ __forceinline__ void flash_q_frags(uint32_t (&qf)[D / 16][4], const unsigned char* tile) {
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32 % 4) * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c16 = 2 * kk + (lane >> 4);  // 16-byte chunk of the row
    ldsm_x4(qf[kk], tile + (c16 / 8) * FlashSmem<D>::kSub + sw128(r, c16 % 8));
  }
}

// One key tile into the running state: s holds its scores in the log2
// domain, -inf where masked. Online softmax (row max over the 4 lanes that
// share a row, partial sums per thread), then O += P V with P from
// registers in two bf16 terms and the V tile (swizzled [64][D] at v_addr)
// read N-major. Returns once the products are done: the V tile may then be
// refilled.
template <int D>
__device__ __forceinline__ void flash_softmax_pv(FlashAcc<D>& a, float (&s)[32], uint32_t v_addr) {
  constexpr int NS = D / 64, SUB = FlashSmem<D>::kSub;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = kMaxInit;
#pragma unroll
    for (int c = 0; c < 8; ++c) mx = fmaxf(mx, fmaxf(s[4 * c + 2 * i], s[4 * c + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(a.m[i], mx);
    const float alpha = exp2f(a.m[i] - m_new);
    a.m[i] = m_new;
    float rs = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      s[4 * c + 2 * i] = exp2f(s[4 * c + 2 * i] - m_new);
      s[4 * c + 2 * i + 1] = exp2f(s[4 * c + 2 * i + 1] - m_new);
      rs += s[4 * c + 2 * i] + s[4 * c + 2 * i + 1];
    }
    a.l[i] = a.l[i] * alpha + rs;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        a.o[n][4 * c + 2 * i] *= alpha;
        a.o[n][4 * c + 2 * i + 1] *= alpha;
      }
  }

  // P as A fragments of the four k16 steps, keys 16kk..16kk+15: {s[8kk],
  // s[8kk+1]}, {s[8kk+2], s[8kk+3]} (row + 8), {s[8kk+4], s[8kk+5]} (keys
  // + 8), {s[8kk+6], s[8kk+7]}; hi = bf16(p), lo = bf16(p - hi)
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x0 = s[8 * kk + 2 * i], x1 = s[8 * kk + 2 * i + 1];
      ph[kk][i] = pack_bf16x2(x0, x1);
      const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&ph[kk][i]);
      pl[kk][i] = pack_bf16x2(x0 - __low2float(h), x1 - __high2float(h));
    }

  // O += P V: 16 keys a step (two 8-row groups of the tile, 2 KB), one n64
  // slice of the output a 64-column sub-tile, the hi and the lo term
#pragma unroll
  for (int n = 0; n < NS; ++n) fence_regs(a.o[n]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ph[kk]);
    fence_regs(pl[kk]);
  }
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const uint64_t dv = wgmma_desc(v_addr + n * SUB + kk * 2048, SUB, 1024);
      wgmma_m64n64k16_rs_tb(a.o[n], ph[kk], dv);
      wgmma_m64n64k16_rs_tb(a.o[n], pl[kk], dv);
    }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < NS; ++n) fence_regs(a.o[n]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(ph[kk]);
    fence_regs(pl[kk]);
  }
}

// The tile's rows out: out and lse at row 0 (out's row stride q_stride, lse
// rows contiguous, lse may be null); rows r < rows are written, those r <
// see_rows with a nonzero sum as O / l and lse (m + log2 l) * lse_scale, the
// others as zeros and empty_lse. sink (a natural-log logit, or null) joins
// the sum of a row with one: l + 2^(sink log2(e) - m).
template <int D>
__device__ __forceinline__ void flash_store(FlashAcc<D>& a, bf16* __restrict__ out, long long q_stride,
                                            float* __restrict__ lse, int rows, int see_rows, float lse_scale,
                                            float empty_lse, const float* __restrict__ sink = nullptr) {
  constexpr int NS = D / 64;
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int r0 = (threadIdx.x / 32 % 4) * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    a.l[i] += __shfl_xor_sync(0xffffffffu, a.l[i], 1);
    a.l[i] += __shfl_xor_sync(0xffffffffu, a.l[i], 2);
    const int r = r0 + 8 * i;
    if (r >= rows) continue;
    const bool seen = r < see_rows && a.l[i] != 0.f;
    if (seen && sink != nullptr) a.l[i] += exp2f(__ldg(sink) * kLog2e - a.m[i]);
    const float inv = seen ? 1.f / a.l[i] : 0.f;
    bf16* orow = out + r * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float x = seen ? a.o[n][4 * c + 2 * i] * inv : 0.f, y = seen ? a.o[n][4 * c + 2 * i + 1] * inv : 0.f;
        *reinterpret_cast<uint32_t*>(orow + n * 64 + c * 8) = pack_bf16x2(x, y);
      }
    if (lse != nullptr && t == 0) lse[r] = seen ? (a.m[i] + log2f(a.l[i])) * lse_scale : empty_lse;
  }
}

// smem: the block's dynamic shared memory (FlashSmem<D>::kBytes).
// q: row 0 of the tile (row stride q_stride elements); k/v: key row 0
// (stride kv_stride); out: output row 0 (stride q_stride); lse: the tile's
// row-0 lse entry, rows contiguous, or nullptr.
// rows: query rows present in memory (loaded and written, <= 64).
// see_rows: rows r < see_rows may see keys; the others get o = 0 and
// kEmptyLse. kv_len: key rows c < kv_len may be seen. q_pos0 / kv_pos0:
// global positions of query row 0 / key row 0 for the causal mask and the
// window. o: the options, its sinks already at this head's (or null).
// Run by FlashSmem<D>::kThreads threads: at D=256 warpgroup g computes O's
// columns [128 g, 128 g + 128) and warpgroup 0 writes the lse.
template <int D>
__device__ __forceinline__ void flash_rows(unsigned char* smem, const bf16* __restrict__ q, long long q_stride,
                                           const bf16* __restrict__ k, const bf16* __restrict__ v,
                                           long long kv_stride, bf16* __restrict__ out, float* __restrict__ lse,
                                           int rows, int see_rows, int kv_len, int q_pos0, int kv_pos0, int causal,
                                           float scale_log2, const FlashOpts& o) {
  constexpr int BK = kFlashBK;
  constexpr int KT = FlashSmem<D>::kTile;
  constexpr int NT = FlashSmem<D>::kThreads, DO = D / FlashSmem<D>::kGroups;
  unsigned char* sq = smem + ((1024u - (smem_u32(smem) & 1023u)) & 1023u);
  const uint32_t q_addr = smem_u32(sq);
  const int lane = threadIdx.x % 32, t = lane % 4;
  const int wg = threadIdx.x / kFlashThreads;  // the warpgroup: O's columns [DO wg, DO wg + DO)
  const int r0 = (threadIdx.x / 32 % 4) * 16 + lane / 4;  // the thread's rows: r0 and r0 + 8
  see_rows = min(see_rows, rows);

  // visible keys for this tile: the last row that sees keys sets the causal limit
  int kv_end = see_rows > 0 ? kv_len : 0;
  if (causal && kv_end > 0) kv_end = min(kv_end, max(0, q_pos0 + see_rows - 1 - kv_pos0 + 1));
  const int n_tiles = (kv_end + BK - 1) / BK;
  // under a window, the first tile holding a key row 0 may see (later rows see later keys)
  const int t0 = o.window > 0 ? max(0, q_pos0 - o.window + 1 - kv_pos0) / BK : 0;

  // smem: q | K slots 0, 1 | V slots 0, 1; tile j in slots j % 2
  auto k_slot = [&](int j) { return sq + KT * (1 + (j & 1)); };
  auto v_slot = [&](int j) { return sq + KT * (3 + (j & 1)); };

  FlashAcc<DO> acc;
  acc.init();

  if (n_tiles > t0) {
    const long long off = (long long)t0 * BK * kv_stride;
    flash_load_tile<D, NT>(sq, q, q_stride, rows);
    flash_load_tile<D, NT>(k_slot(t0), k + off, kv_stride, kv_len - t0 * BK);
    flash_load_tile<D, NT>(v_slot(t0), v + off, kv_stride, kv_len - t0 * BK);
    cp_async_commit();
  }
  for (int j = t0; j < n_tiles; ++j) {
    const int j0 = j * BK;
    if (j + 1 < n_tiles) {  // the next tile into the other slots
      const long long off = (long long)(j0 + BK) * kv_stride;
      flash_load_tile<D, NT>(k_slot(j + 1), k + off, kv_stride, kv_len - j0 - BK);
      flash_load_tile<D, NT>(v_slot(j + 1), v + off, kv_stride, kv_len - j0 - BK);
    }
    cp_async_commit();
    cp_async_wait<1>();  // tile j (and q) landed
    fence_proxy_async();
    __syncthreads();

    float s[32];
    flash_scores<D>(s, q_addr, smem_u32(k_slot(j)));

    // The soft cap on the scaled scores; the mask only where the tile holds
    // kv_len or (causal) keys past row 0's position, or under a window
    if (o.cap_in != 0.f) {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = o.cap_out * tanhf(s[e] * o.cap_in);
    } else {
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] *= scale_log2;
    }
    if (j0 + BK > kv_len || (causal && kv_pos0 + j0 + BK - 1 > q_pos0) || o.window > 0) {
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + ((e >> 1) & 1) * 8, col = j0 + (e >> 2) * 8 + 2 * t + (e & 1);
        const int kp = kv_pos0 + col, qp = q_pos0 + row;
        if (!(col < kv_len && (!causal || kp <= qp) && (o.window <= 0 || kp > qp - o.window)))
          s[e] = __int_as_float(0xff800000);
      }
    }
    flash_softmax_pv<DO>(acc, s, smem_u32(v_slot(j)) + wg * (DO / 64) * FlashSmem<D>::kSub);
    __syncthreads();  // these slots may be refilled
  }
  flash_store<DO>(acc, out + wg * DO, q_stride, wg == 0 ? lse : nullptr, rows, see_rows, 1.f, kEmptyLse, o.sinks);
}

}  // namespace skt
