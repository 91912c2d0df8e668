// The 576-wide attention state of K13a (mla_decode.cu): 16 query rows on
// mma.sync m16n8k16 bf16 tensor-core tiles with float32 accumulators, eight
// warps a block. In MLA the 16 rows are the 16 heads of one query position
// against one shared latent "KV head", so each key tile is read once for
// all of them. Warp w computes the scores of keys 8w..8w+7 of a 64-key tile
// over all 576 dims (36 MMAs), the softmax row statistics meet in shared
// memory, and for P V warp w owns an eighth of the 512 output columns (32
// accumulators a thread); V's B fragments come from the row-major tile by
// ldmatrix.trans. (K7 and K9 at head dim 576 run the wgmma tile of
// mla_flash_tile.cuh.)
//
// Numbers. Scores are exact bf16 products summed in float32; softmax runs in
// the log2 domain in float32. P enters the P V product as two bf16 terms,
// p = hi + lo (hi = bf16(p), lo = bf16(p - hi)), two MMAs each, so P is
// carried to ~2^-16 and the result matches a float32 P V; the TPU kernel
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

}  // namespace skt
