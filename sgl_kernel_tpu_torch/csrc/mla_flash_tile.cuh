// The 576-wide flash tile of K7 (flash_prefill.cu) and K9 (flash_packed.cu):
// DeepSeek's MLA prefill, q = [q_nope W_UK | q_pe] of 16 heads against one
// latent KV head, K the 576-wide latent row, V its first 512 columns
// (sgl_kernel_tpu/ops/attention/mla.py:520-557), or a caller's own
// 576-wide V.
//
// Rows. A block takes 64 query rows, consecutive (position, head) pairs of
// one KV head: four positions' 16 heads on the main path (16 positions at
// group 4), so each key tile crosses from L2 once for four positions. Each
// row's causal limit is its own, through its position.
//
// Warps: two warpgroups, 256 threads, one block an SM. Warpgroup 0
// computes every key tile's scores S = q K^T (wgmma m64n64k16 over 36 k16
// steps, q and K from 128-byte-swizzled shared memory), the online softmax
// in registers, and O's columns 0..255 (P as wgmma's register A in two bf16
// terms, V read N-major: the transpose-B form). It hands P, as those
// register fragments, and the rows' rescale factors to warpgroup 1 through
// shared memory and two named barriers (P ready, P read), and warpgroup 1
// computes O's columns 256..511 (256..575 for a caller's V) from the same
// fragments: 128 or 160 float32 accumulators a thread, O split by columns
// as FlashMLA splits it. The choice: warpgroup 0 computes every S, so the
// softmax state has one owner and a tile one hand-off. The two warpgroups
// taking turns at S by key tile (each publishing its P as swizzled tiles
// and its rows' max, the other reading P as wgmma's shared-memory A) was
// built three ways and ran 3.4-4.8 us a key tile on the H100 against this
// tile's 2.7 (tools/mla_flash_probe.py). There is no producer warp:
// a ninth warp puts three warps on one of the SM's four register files and
// caps every thread at 168 registers, where warpgroup 0 needs ~200.
//
// Feed. A ring of 17 box slots behind full mbarriers, a slot one swizzled
// [64 keys][64 columns] box (8 KB). A key tile is nine boxes, each issued
// by one lane as a TMA box of a 2-D map over the keys as [rows][Hkv * 576];
// a tile that holds kv_len comes by 16-byte cp.async pieces from a whole
// warp, zero-filled past it, so no key row at or past kv_len is read and 0
// x NaN never reaches P V. Warpgroup 1's first warp issues every box, the
// first 17 at the start and then each slot 17 entries on once its readers
// are done: P_j tells warpgroup 1 that warpgroup 0 is done with S_j, an
// mbarrier that it is done with P_j V_j, and a named barrier of its own
// warps that they are done with their V boxes; warpgroup 0, on the
// critical path, issues none.
// In the MLA form V is the tile's first eight boxes, so nothing else is
// loaded; the boxes go in the order rope box, then 0..7, and the rope box
// is free as soon as S is done, so the next tile's nine boxes land while
// this tile's P V still reads its V boxes. Two whole tiles beside q (72 KB)
// and P (16 KB) would need 237,568 bytes of the 232,448 a block may have;
// 17 boxes fit (231,576 bytes with the barriers). With a caller's V each
// tile is its nine K boxes, then nine V boxes, through the same ring.
// Every barrier wait comes before a batch of wgmmas, never between two of
// them (a wait inside a batch made ptxas serialize the wgmmas).
//
// Numbers: scores are exact bf16 products summed in float32; softmax in the
// log2 domain; P enters P V as two bf16 terms, p = hi + lo, two wgmmas each
// (flash_tile.cuh); the output is rounded to bf16 once; a row that sees no
// key gets o = 0 and lse -1e30 * log2(e).
#pragma once

#include "flash_tile.cuh"

namespace skt {

constexpr int kMfD = 576;                // q / k width: 512 latent + 64 rope columns
constexpr int kMfBoxes = kMfD / 64;      // 64-column boxes of a row
constexpr int kMfRows = 64;              // query rows of a block: wgmma's M
constexpr int kMfKeys = 64;              // keys of a tile
constexpr int kMfSlots = 17;             // box slots of the ring
constexpr int kMfThreads = 2 * 128;      // two warpgroups
constexpr int kMfBox = 64 * 128;         // bytes of a swizzled [64][64] bf16 box
constexpr int kMfStageRow = 512 + 16;    // bytes of an output row staged in shared memory (256 bf16 + pad)

// Byte offsets in the block's dynamic shared memory (after rounding its
// start up to 1024): q's nine boxes, the ring, P's fragments (32 words a
// thread of warpgroup 0), the rows' rescale factors (or, at the end, their
// sums), the ring's full barriers, two barriers of warpgroup 0's P V.
struct MfSmem {
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + kMfBoxes * kMfBox;
  static constexpr int kP = kRing + kMfSlots * kMfBox;
  static constexpr int kRow = kP + 128 * 32 * 4;
  static constexpr int kBar = kRow + 128 * 8;
  static constexpr size_t kBytes = 1024 + kBar + (kMfSlots + 2) * 8;
};
static_assert(MfSmem::kBytes <= 232448, "the 576 tile's shared memory");
static_assert(2 * kMfRows * kMfStageRow <= kMfBoxes * kMfBox, "the output is staged in q's boxes");

// The keys of a block. Key c is at row key_row0 + c of the maps (the
// [rows][Hkv * 576] view of k / v), columns col0.. (its KV head's), and at
// k + c * kv_stride for cp.async (v likewise; v null in the MLA form).
struct MfKeys {
  int n_tiles;  // key tiles to visit: the block's largest row limit, in tiles
  int kv_len;   // keys at or past kv_len are not read
  int key_row0, col0;
  const bf16* k;
  const bf16* v;
  long long kv_stride;
};

// 8 q values of row `row` from column 8 ch: one 576-wide q, or (SPLIT_Q,
// the MLA form) the latent's 512 columns in q and the rope's 64 in q_pe, so
// that the caller builds no 576-wide copy
template <bool SPLIT_Q>
__device__ __forceinline__ const bf16* mf_q_chunk(const bf16* q, const bf16* q_pe, long long row, int ch) {
  if constexpr (!SPLIT_Q) return q + row * kMfD + ch * 8;
  return ch < 64 ? q + row * 512 + ch * 8 : q_pe + row * 64 + (ch - 64) * 8;
}

// A block's rows as four callables of the row index (mla_flash_block).
template <class Q, class Lim, class Out, class Lse>
struct MfRows {
  Q q;
  Lim limit;
  Out out;
  Lse lse;
};

template <class Q, class Lim, class Out, class Lse>
__device__ __forceinline__ MfRows<Q, Lim, Out, Lse> mf_rows(Q q, Lim limit, Out out, Lse lse) {
  return {q, limit, out, lse};
}

// The block's body. SEP_V: V is the caller's (576 wide, boxes through the
// ring after K's) and O is 576 wide; else V is K's first 512 columns and O
// 512 wide. tk / tv: the maps of k / v (tv unused without SEP_V). Rows r of
// 0..63 through `rows`: rows.q(r, ch) the row's q values 8 ch .. 8 ch + 7
// of 576 (null: no such row, nothing read or written), rows.limit(r) the
// keys it sees (c < limit), rows.out(r) its output row, rows.lse(r) its lse
// entry or null.
template <bool SEP_V, typename Rows>
__device__ __forceinline__ void mla_flash_block(unsigned char* smem_raw, const void* tk, const void* tv,
                                                const MfKeys& keys, const Rows& rows, float scale_log2) {
  constexpr int E = SEP_V ? 2 * kMfBoxes : kMfBoxes;  // ring entries a tile
  constexpr int NV1 = (SEP_V ? kMfBoxes : 8) - 4;      // warpgroup 1's 64-column slices of O
  unsigned char* sm = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = sm + MfSmem::kRing;
  uint4* pbuf = reinterpret_cast<uint4*>(sm + MfSmem::kP);
  float2* rowbuf = reinterpret_cast<float2*>(sm + MfSmem::kRow);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + MfSmem::kBar);
  uint64_t* pv0_done = full + kMfSlots;  // [j % 2]: warpgroup 0 is done with P_j V_j
  const int tid = threadIdx.x, lane = tid % 32;
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // warp-uniform to the compiler
  const int wg = warp / 4, t = lane % 4;
  const int n_tiles = keys.n_tiles, n_entries = n_tiles * E;
  // ring entry of K box x and of V box n within a tile: the rope box first
  // in the MLA form; K's nine boxes, then V's, with a caller's V
  auto k_entry = [](int x) { return SEP_V ? x : (x == kMfBoxes - 1 ? 0 : x + 1); };
  auto v_entry = [](int n) { return SEP_V ? kMfBoxes + n : n + 1; };
  auto slot = [&](int g) { return ring + (g % kMfSlots) * kMfBox; };
  // entry g's box into its slot, by a whole warp: one TMA box, or at the
  // tile that holds kv_len 16 cp.async pieces a lane, zero-filled past it
  auto fill = [&](int g) {
    if (g >= n_entries) return;
    const int j0 = g / E * kMfKeys, i = g % E;
    const bool is_v = SEP_V && i >= kMfBoxes;
    const int x = SEP_V ? i % kMfBoxes : (i == 0 ? kMfBoxes - 1 : i - 1);
    uint64_t* bar = &full[g % kMfSlots];
    unsigned char* dst = slot(g);
    if (j0 + kMfKeys <= keys.kv_len) {
      if (lane == 0) {
        mbar_expect_tx(bar, kMfBox);
        tma_load_2d(dst, is_v ? tv : tk, keys.col0 + 64 * x, keys.key_row0 + j0, bar);
      }
    } else {
      const bf16* src = (is_v ? keys.v : keys.k) + 64 * x;
#pragma unroll
      for (int it = 0; it < 64 * 8 / 32; ++it) {
        const int c = it * 32 + lane, r = c / 8, ch = c % 8;
        const bool ok = j0 + r < keys.kv_len;
        cp_async16(dst + sw128(r, ch), src + (ok ? (long long)(j0 + r) * keys.kv_stride + ch * 8 : 0), ok);
      }
      if (lane == 0) mbar_arrive(bar);
    }
    cp_async_mbar_arrive(bar);
  };
  // warpgroup 1's first warp refills the slots of entries g .. g + n - 1,
  // 17 entries on, once every reader is done with them
  auto refill = [&](int g, int n) {
    if (warp == 4)
      for (int i = 0; i < n; ++i) fill(g + i + kMfSlots);
  };
  auto wait_box = [&](int g) { mbar_wait(&full[g % kMfSlots], (g / kMfSlots) & 1); };

  if (tid == 0) {
    for (int s = 0; s < kMfSlots; ++s) mbar_init(&full[s], 33);  // lane 0's arrival (with the TMA bytes), 32 cp.async arrivals
    mbar_init(&pv0_done[0], 4);  // each warp of warpgroup 0
    mbar_init(&pv0_done[1], 4);
    mbar_init_fence();
  }
  __syncthreads();
  refill(-kMfSlots, kMfSlots);  // the first 17 entries

  // q's rows into nine swizzled boxes (absent rows as zeros) while the
  // first boxes land
  if (n_tiles > 0) {
    for (int c = tid; c < kMfRows * (kMfD / 8); c += kMfThreads) {
      const int r = c / (kMfD / 8), ch = c % (kMfD / 8);
      const bf16* src = rows.q(r, ch);
      unsigned char* dst = sm + MfSmem::kQ + (ch / 8) * kMfBox + sw128(r, ch % 8);
      if (src != nullptr) cp_async16(dst, src);
      else *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
  }
  __syncthreads();

  const int r0 = (warp % 4) * 16 + lane / 4;  // the thread's rows: r0 and r0 + 8
  // the warpgroup's O columns c0 .. c0 + 255 (its slices 0..3) out: scaled
  // by the rows' 1 / l (0 where l = 0), rounded to bf16 once, staged in q's
  // boxes (free once the last S is done; rows of 528 bytes, so a warp's
  // 4-byte stores hit 32 banks), then written by 16-byte stores, a row's
  // 512 bytes a warp instruction (4-byte stores straight from the
  // accumulators took longer than a key tile)
  auto store256 = [&](const auto& o, const float (&inv)[2], int c0) {
    unsigned char* stage = sm + MfSmem::kQ + wg * kMfRows * kMfStageRow;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          *reinterpret_cast<uint32_t*>(stage + (r0 + 8 * i) * kMfStageRow + (64 * n + 8 * c + 2 * t) * 2) =
              pack_bf16x2(o[n][4 * c + 2 * i] * inv[i], o[n][4 * c + 2 * i + 1] * inv[i]);
    named_sync(2 + wg, 128);
#pragma unroll 4
    for (int it = 0; it < kMfRows * 32 / 128; ++it) {
      const int c = it * 128 + tid % 128, r = c / 32, k = c % 32;
      bf16* orow = rows.out(r);
      if (orow != nullptr)
        *reinterpret_cast<uint4*>(orow + c0 + 8 * k) = *reinterpret_cast<const uint4*>(stage + r * kMfStageRow + 16 * k);
    }
  };

  if (wg == 0) {
    const int lim[2] = {rows.limit(r0), rows.limit(r0 + 8)};
    float o[4][32];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
    float m[2] = {kMaxInit, kMaxInit}, l[2] = {0.f, 0.f};
    const uint32_t q_addr = smem_u32(sm + MfSmem::kQ);
    for (int j = 0; j < n_tiles; ++j) {
      const int j0 = j * kMfKeys, g0 = j * E;
      const bool edge = j0 + kMfKeys > keys.kv_len;
      // S = q K_j^T once the tile's boxes have landed
#pragma unroll
      for (int x = 0; x < kMfBoxes; ++x) wait_box(g0 + k_entry(x));
      if (edge) fence_proxy_async();  // cp.async writes, to wgmma's async proxy
      float s[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) s[e] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int x = 0; x < kMfBoxes; ++x) {
        const uint32_t k_addr = smem_u32(slot(g0 + k_entry(x)));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss(s, wgmma_desc(q_addr + x * kMfBox + kk * 32, 16, 1024),
                             wgmma_desc(k_addr + kk * 32, 16, 1024), x + kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in the log2 domain; s[4c + e]: row r0 + 8 ((e >> 1) & 1), key j0 + 8c + 2t + (e & 1)
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const bool masked = j0 + kMfKeys > lim[i];
        float mx = kMaxInit;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float& x = s[4 * c + 2 * i + b];
            x = masked && j0 + 8 * c + 2 * t + b >= lim[i] ? __int_as_float(0xff800000) : x * scale_log2;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            float& x = s[4 * c + 2 * i + b];
            x = exp2f(x - m_new);
            rs += x;
          }
        l[i] = l[i] * alpha[i] + rs;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            o[n][4 * c + 2 * i] *= alpha[i];
            o[n][4 * c + 2 * i + 1] *= alpha[i];
          }
      }
      // P as register A fragments of the four k16 steps (flash_softmax_pv's
      // packing), hi = bf16(p), lo = bf16(p - hi)
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
      // hand P_j and the rescale factors to warpgroup 1, once it has read P_{j-1}
      if (j > 0) named_sync(5, 256);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pbuf[kk * 128 + tid] = make_uint4(ph[kk][0], ph[kk][1], ph[kk][2], ph[kk][3]);
        pbuf[(4 + kk) * 128 + tid] = make_uint4(pl[kk][0], pl[kk][1], pl[kk][2], pl[kk][3]);
      }
      rowbuf[tid] = make_float2(alpha[0], alpha[1]);
      named_arrive(4, 256);

      // O[:, 0:256] += P V_j
      if (SEP_V) {
#pragma unroll
        for (int n = 0; n < 4; ++n) wait_box(g0 + v_entry(n));
        if (edge) fence_proxy_async();
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) fence_regs(o[n]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint64_t dv = wgmma_desc(smem_u32(slot(g0 + v_entry(n))) + kk * 2048, kMfBox, 1024);
          wgmma_m64n64k16_rs_tb(o[n], ph[kk], dv);
          wgmma_m64n64k16_rs_tb(o[n], pl[kk], dv);
        }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int n = 0; n < 4; ++n) fence_regs(o[n]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&pv0_done[j & 1]);
    }

    // the rows' sums to warpgroup 1, then O[:, 0:256] and the lse
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
    if (n_tiles > 0) named_sync(5, 256);
    rowbuf[tid] = make_float2(l[0], l[1]);
    named_arrive(4, 256);
    const float inv[2] = {l[0] != 0.f ? 1.f / l[0] : 0.f, l[1] != 0.f ? 1.f / l[1] : 0.f};
    store256(o, inv, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* lp = rows.out(r0 + 8 * i) != nullptr ? rows.lse(r0 + 8 * i) : nullptr;
      if (lp != nullptr && t == 0) *lp = l[i] != 0.f ? m[i] + log2f(l[i]) : kEmptyLse;
    }
    return;
  }

  // warpgroup 1: O[:, 256:] from warpgroup 0's P
  const int tw = tid - 128;
  float o[NV1][32];
#pragma unroll
  for (int n = 0; n < NV1; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int g0 = j * E;
    const bool edge = j * kMfKeys + kMfKeys > keys.kv_len;
    named_sync(4, 256);  // P_j is ready
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint4 h = pbuf[kk * 128 + tw], lo = pbuf[(4 + kk) * 128 + tw];
      ph[kk][0] = h.x, ph[kk][1] = h.y, ph[kk][2] = h.z, ph[kk][3] = h.w;
      pl[kk][0] = lo.x, pl[kk][1] = lo.y, pl[kk][2] = lo.z, pl[kk][3] = lo.w;
    }
    const float2 alpha = rowbuf[tw];
    named_arrive(5, 256);  // P_j is read
    // P_j means warpgroup 0 is done with S_j: the boxes only S reads (the
    // rope box, or all of K's) are free
    refill(g0, SEP_V ? kMfBoxes : 1);
#pragma unroll
    for (int n = 0; n < NV1; ++n)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        o[n][4 * c] *= alpha.x;
        o[n][4 * c + 1] *= alpha.x;
        o[n][4 * c + 2] *= alpha.y;
        o[n][4 * c + 3] *= alpha.y;
      }
#pragma unroll
    for (int n = 0; n < NV1; ++n) wait_box(g0 + v_entry(4 + n));
    if (edge) fence_proxy_async();
#pragma unroll
    for (int n = 0; n < NV1; ++n) fence_regs(o[n]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      fence_regs(ph[kk]);
      fence_regs(pl[kk]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < NV1; ++n) {
        const uint64_t dv = wgmma_desc(smem_u32(slot(g0 + v_entry(4 + n))) + kk * 2048, kMfBox, 1024);
        wgmma_m64n64k16_rs_tb(o[n], ph[kk], dv);
        wgmma_m64n64k16_rs_tb(o[n], pl[kk], dv);
      }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < NV1; ++n) fence_regs(o[n]);
    named_sync(3, 128);  // the warpgroup's reads of its V boxes are done
    refill(g0 + v_entry(4), NV1);
    if (warp == 4) {  // and, once warpgroup 0 is done with P_j V_j, its V boxes
      mbar_wait(&pv0_done[j & 1], (j >> 1) & 1);
      refill(g0 + v_entry(0), 4);
    }
  }
  named_sync(4, 256);  // the rows' sums
  const float2 lv = rowbuf[tw];
  const float inv[2] = {lv.x != 0.f ? 1.f / lv.x : 0.f, lv.y != 0.f ? 1.f / lv.y : 0.f};
  store256(o, inv, 256);
  if constexpr (SEP_V) {  // a caller's V: O's last 64 columns straight from the accumulators
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bf16* orow = rows.out(r0 + 8 * i);
      if (orow == nullptr) continue;
#pragma unroll
      for (int c = 0; c < 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 512 + 8 * c + 2 * t) =
            pack_bf16x2(o[NV1 - 1][4 * c + 2 * i] * inv[i], o[NV1 - 1][4 * c + 2 * i + 1] * inv[i]);
    }
  }
}

}  // namespace skt
