// The 576-wide attention tile shared by K13a (mla_decode.cu) and the D=576
// forms of K7 (flash_prefill.cu) and K9 (flash_packed.cu): 16 query rows
// against 64-key tiles of 576-wide keys, on mma.sync m16n8k16 bf16 tensor-core
// tiles with float32 accumulators, eight warps a block.
//
// Why 16 rows. At 576 wide, K7's 64-row tile would need ~152 KB of static
// shared memory and 288 accumulator registers a thread. Sixteen rows fill
// exactly one m16 MMA tile, and in MLA they are the 16 heads of one query
// position against one shared latent "KV head", so each key tile is read once
// for all of them. Warp w computes the scores of keys 8w..8w+7 of the tile
// over all 576 dims (36 MMAs), the softmax row statistics meet in shared
// memory, and for P.V warp w owns an eighth of the output columns (64 or 72
// of 512 or 576: 32 or 36 accumulators a thread). V's B fragments come from
// the row-major tile by ldmatrix.trans.
//
// Numbers. Scores are exact bf16 products summed in float32; softmax runs in
// the log2 domain in float32. P enters the P.V product as two bf16 terms,
// p = hi + lo (hi = bf16(p), lo = bf16(p - hi)), two MMAs each, so P is
// carried to ~2^-16 and the result matches a float32 P.V; the TPU kernel
// rounds P to bf16 once (mla.py:99-101), which the plain twins do not copy.
//
// Shared-memory rows are padded to 584 bf16 (292 words: rows 4 banks apart),
// which makes every fragment load and every ldmatrix row conflict-free.
#pragma once

#include "common.cuh"

namespace skt {

constexpr int kMlaD = 576;            // q / k width (512 latent + 64 rope)
constexpr int kMlaRow = kMlaD + 8;    // shared-memory row stride (bf16)
constexpr int kMlaRows = 16;          // query rows of a block
constexpr int kMlaBN = 64;            // keys of a tile
constexpr int kMlaWarps = 8;
constexpr int kMlaThreads = 32 * kMlaWarps;
constexpr int kMlaPRow = kMlaBN + 8;  // P row stride (bf16)

// Shared memory of a block, carved from one dynamic buffer.
template <bool SEP_V>
struct MlaSmem {
  static constexpr int kQ = kMlaRows * kMlaRow;       // bf16
  static constexpr int kK = kMlaBN * kMlaRow;         // bf16
  static constexpr int kP = kMlaRows * kMlaPRow;      // bf16, each of hi and lo
  static constexpr int kRed = 2 * kMlaWarps * kMlaRows;  // float
  static constexpr size_t kBytes = 2 * (size_t)(kQ + kK * (SEP_V ? 2 : 1) + 2 * kP) + 4 * (size_t)kRed;
  bf16 *q, *k, *v, *p_hi, *p_lo;
  float* red;
  __device__ explicit MlaSmem(unsigned char* base) {
    q = reinterpret_cast<bf16*>(base);
    k = q + kQ;
    v = SEP_V ? k + kK : k;
    p_hi = k + kK * (SEP_V ? 2 : 1);
    p_lo = p_hi + kP;
    red = reinterpret_cast<float*>(p_lo + kP);
  }
};

// Running state of a thread: accumulator rows g and g+8 (g = lane / 4) over
// its warp's NT n8 output tiles, and the rows' running max / sum (log2).
template <int DV>
struct MlaState {
  static constexpr int NT = DV / 8 / kMlaWarps;
  float acc[NT][4];
  float m[2], l[2];
  __device__ void init() {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    m[0] = m[1] = kMaxInit;
    l[0] = l[1] = 0.f;
  }
};

// One key tile: the 16 rows' q in sm.q against keys 0..63 of sm.k (V rows in
// sm.v, the first DV columns); visible(row, key) says which scores count.
// Ends with a barrier, after which sm.k / sm.v may be refilled.
template <int DV, bool SEP_V, typename Visible>
__device__ __forceinline__ void mla_tile(MlaState<DV>& st, const MlaSmem<SEP_V>& sm, float scale_log2,
                                         Visible visible) {
  constexpr int NT = MlaState<DV>::NT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  {
    const bf16* qa = sm.q + g * kMlaRow + 2 * t;
    const bf16* kb = sm.k + (warp * 8 + g) * kMlaRow + 2 * t;
#pragma unroll 6
    for (int kk = 0; kk < kMlaD / 16; ++kk) {
      uint32_t a[4];
      a[0] = ld32(qa + kk * 16);
      a[1] = ld32(qa + 8 * kMlaRow + kk * 16);
      a[2] = ld32(qa + kk * 16 + 8);
      a[3] = ld32(qa + 8 * kMlaRow + kk * 16 + 8);
      mma_bf16(c, a, ld32(kb + kk * 16), ld32(kb + kk * 16 + 8));
    }
  }
  // c[0], c[1]: row g, keys 8w + 2t, +1; c[2], c[3]: row g + 8
  float s[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int row = g + (e >> 1) * 8, key = warp * 8 + 2 * t + (e & 1);
    s[e] = visible(row, key) ? c[e] * scale_log2 : __int_as_float(0xff800000);  // -inf
  }
  float* red_max = sm.red;
  float* red_sum = sm.red + kMlaWarps * kMlaRows;
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
  __syncthreads();
  float alpha[2], rs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    float m_new = st.m[i];
#pragma unroll
    for (int w = 0; w < kMlaWarps; ++w) m_new = fmaxf(m_new, red_max[w * kMlaRows + row]);
    alpha[i] = exp2f(st.m[i] - m_new);
    st.m[i] = m_new;
    const float p0 = exp2f(s[2 * i] - m_new), p1 = exp2f(s[2 * i + 1] - m_new);
    const bf16 h0 = __float2bfloat16(p0), h1 = __float2bfloat16(p1);
    __nv_bfloat162 hi, lo;
    hi.x = h0, hi.y = h1;
    lo.x = __float2bfloat16(p0 - __bfloat162float(h0));
    lo.y = __float2bfloat16(p1 - __bfloat162float(h1));
    const int off = row * kMlaPRow + warp * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(sm.p_hi + off) = hi;
    *reinterpret_cast<__nv_bfloat162*>(sm.p_lo + off) = lo;
    rs[i] = p0 + p1;
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
    rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
  }
  if (t == 0) {
    red_sum[warp * kMlaRows + g] = rs[0];
    red_sum[warp * kMlaRows + g + 8] = rs[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    st.acc[n][0] *= alpha[0];
    st.acc[n][1] *= alpha[0];
    st.acc[n][2] *= alpha[1];
    st.acc[n][3] *= alpha[1];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kMlaWarps; ++w) sum += red_sum[w * kMlaRows + g + 8 * i];
    st.l[i] = st.l[i] * alpha[i] + sum;
  }
#pragma unroll
  for (int kk = 0; kk < kMlaBN / 16; ++kk) {
    uint32_t ah[4], al[4];
    const int o0 = g * kMlaPRow + kk * 16 + 2 * t, o1 = o0 + 8 * kMlaPRow;
    ah[0] = ld32(sm.p_hi + o0), ah[1] = ld32(sm.p_hi + o1);
    ah[2] = ld32(sm.p_hi + o0 + 8), ah[3] = ld32(sm.p_hi + o1 + 8);
    al[0] = ld32(sm.p_lo + o0), al[1] = ld32(sm.p_lo + o1);
    al[2] = ld32(sm.p_lo + o0 + 8), al[3] = ld32(sm.p_lo + o1 + 8);
    const bf16* vrow = sm.v + (kk * 16 + (lane & 15)) * kMlaRow + warp * NT * 8;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t b0, b1;
      ldsm_x2_trans(b0, b1, vrow + n * 8);
      mma_bf16(st.acc[n], ah, b0, b1);
      mma_bf16(st.acc[n], al, b0, b1);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void mla_store_pair(bf16* p, float a, float b) {
  __nv_bfloat162 v;
  v.x = __float2bfloat16(a);
  v.y = __float2bfloat16(b);
  *reinterpret_cast<__nv_bfloat162*>(p) = v;
}

__device__ __forceinline__ void mla_store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// o = acc / l for the rows < n_rows at out_row(row) (a pointer to the row's
// DV outputs: bf16, rounded once, or float32); lse (base 2, empty_lse for a
// row that saw no key) at lse_ptr(row) when lse_ptr gives non-null.
template <int DV, typename OutRow, typename LsePtr>
__device__ __forceinline__ void mla_store(const MlaState<DV>& st, int n_rows, OutRow out_row, LsePtr lse_ptr,
                                          float empty_lse = -1e30f * kLog2e) {
  constexpr int NT = MlaState<DV>::NT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = g + 8 * i;
    if (row >= n_rows) continue;
    const float inv = st.l[i] == 0.f ? 0.f : 1.f / st.l[i];
    auto o = out_row(row);
#pragma unroll
    for (int n = 0; n < NT; ++n)
      mla_store_pair(o + (warp * NT + n) * 8 + 2 * t, st.acc[n][2 * i] * inv, st.acc[n][2 * i + 1] * inv);
    float* lp = lse_ptr(row);
    if (lp != nullptr && warp == 0 && t == 0) *lp = st.l[i] == 0.f ? empty_lse : st.m[i] + log2f(st.l[i]);
  }
}

// The D=576 flash-attention body of K7 and K9: 16 query rows (row r at
// q_row(r), or absent when q_row gives null) against the keys c < kv_end of
// dense bf16 k / v arrays (key c at k + c * kv_stride), row r seeing key c
// when row_ok(r), c < kv_len and, causal, kv_pos0 + c <= q_pos(r). Output
// rows (all 576 columns) at out_row(r) for present rows, lse at lse_ptr(r).
template <typename QRow, typename QPos, typename RowOk, typename OutRow, typename LsePtr>
__device__ __forceinline__ void mla_flash_rows(unsigned char* smem, QRow q_row, const bf16* __restrict__ k,
                                               const bf16* __restrict__ v, long long kv_stride, int kv_len,
                                               int kv_end, int kv_pos0, int causal, QPos q_pos, RowOk row_ok,
                                               OutRow out_row, LsePtr lse_ptr, float scale_log2) {
  const MlaSmem<true> sm(smem);
  constexpr int CH = kMlaD / 8;  // 16-byte pieces of a bf16 row
  int n_rows = 0;
  for (int r = 0; r < kMlaRows; ++r) n_rows += q_row(r) != nullptr;
  for (int c = threadIdx.x; c < kMlaRows * CH; c += kMlaThreads) {
    const int r = c / CH, d0 = (c % CH) * 8;
    const bf16* src = q_row(r);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (src != nullptr) val = *reinterpret_cast<const uint4*>(src + d0);
    *reinterpret_cast<uint4*>(sm.q + r * kMlaRow + d0) = val;
  }
  MlaState<kMlaD> st;
  st.init();
  for (int j0 = 0; j0 < kv_end; j0 += kMlaBN) {
    for (int c = threadIdx.x; c < kMlaBN * CH; c += kMlaThreads) {
      const int r = c / CH, ch = c % CH;
      const bool ok = j0 + r < kv_len;
      const long long off = (ok ? (long long)(j0 + r) * kv_stride : 0) + ch * 8;
      cp_async16(sm.k + r * kMlaRow + ch * 8, k + off, ok);
      cp_async16(sm.v + r * kMlaRow + ch * 8, v + off, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    mla_tile<kMlaD, true>(st, sm, scale_log2, [&](int row, int key) {
      const int c = j0 + key;
      return row_ok(row) && c < kv_len && (!causal || kv_pos0 + c <= q_pos(row));
    });
  }
  mla_store<kMlaD>(st, n_rows, out_row, lse_ptr);
}

}  // namespace skt
