// The flash-attention tile loop shared by K7 (flash_prefill.cu) and K9
// (flash_packed.cu): one block of 128 threads computes up to 64 query rows
// of one head against the key rows it may see. The two kernels differ only
// in how a block finds its rows (a padded [B, S, H, D] batch, or
// block-aligned packed tokens with per-block metadata).
//
// Design (first version, no tensor cores): q and each 32-row K/V tile sit
// in shared memory as bf16, q and K transposed so that a thread's four
// query rows and four key columns are each one 8-byte read without bank
// conflicts. Each thread computes a 4x4 block of scores in f32, takes the
// row max and sum over the 8 lanes that share its rows, and keeps a 4-row
// by D/8-column slice of the output accumulator in registers; the
// probability tile passes through shared memory (rows padded to 33 floats)
// into the P.V product. Softmax runs in the log2 domain. KV tiles past the
// last causal position are skipped, and key rows past kv_len are neither
// read nor attended. The output is rounded to bf16 once, after the last
// tile. Later work: mma.sync/wgmma tiles and a TMA-fed pipeline.
#pragma once

#include "common.cuh"

namespace skt {

constexpr int kFlashBQ = 64;
constexpr int kFlashBK = 32;
constexpr int kFlashThreads = 128;
// base-2 lse of a row that sees no key: the plain versions clamp the
// running max at -1e30 (natural log) and the sum at 1e-38, so
// (-1e30 + ln 1e-38) * log2(e), which is -1e30 * log2(e) in float32. Finite,
// so merging two such rows gives weights of 1 and a zero row, never NaN.
constexpr float kEmptyLse = -1e30f * kLog2e;

// q: row 0 of the tile (row stride q_stride elements); k/v: key row 0
// (stride kv_stride); out: output row 0 (stride q_stride); lse: the tile's
// row-0 lse entry, rows contiguous, or nullptr.
// rows: query rows present in memory (loaded and written, <= 64).
// see_rows: rows r < see_rows may see keys; the others get o = 0 and
// kEmptyLse. kv_len: key rows c < kv_len may be seen. q_pos0 / kv_pos0:
// global positions of query row 0 / key row 0 for the causal mask.
template <int D>
__device__ __forceinline__ void flash_rows(
    const bf16* __restrict__ q, long long q_stride, const bf16* __restrict__ k,
    const bf16* __restrict__ v, long long kv_stride, bf16* __restrict__ out,
    float* __restrict__ lse, int rows, int see_rows, int kv_len, int q_pos0,
    int kv_pos0, int causal, float scale_log2) {
  constexpr int BQ = kFlashBQ, BK = kFlashBK, kThreads = kFlashThreads;
  constexpr int DC = D / 8;  // output columns per thread
  __shared__ __align__(16) bf16 qT[D][BQ];
  __shared__ __align__(16) bf16 kT[D][BK];
  __shared__ __align__(16) bf16 vs[BK][D];
  __shared__ float ps[BQ][BK + 1];

  const int tid = threadIdx.x;
  const int rg = tid / 8;  // rows rg*4 .. rg*4+3
  const int cg = tid % 8;  // score cols cg*4 .. +3, output cols cg*DC .. +DC-1
  see_rows = min(see_rows, rows);

  float o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaxInit;
    l[i] = 0.f;
  }

  // visible keys for this tile: the last row that sees keys sets the causal limit
  int kv_end = see_rows > 0 ? kv_len : 0;
  if (causal && kv_end > 0) kv_end = min(kv_end, max(0, q_pos0 + see_rows - 1 - kv_pos0 + 1));

  if (kv_end > 0) {
    // q tile -> qT[d][r] (8 bf16 per thread-step)
    for (int e = tid; e < BQ * D / 8; e += kThreads) {
      const int r = e / (D / 8), d0 = (e % (D / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < rows) raw = *reinterpret_cast<const uint4*>(q + r * q_stride + d0);
      const bf16* hv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) qT[d0 + j][r] = hv[j];
    }
  }

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    __syncthreads();  // previous tile's readers are done
    for (int e = tid; e < BK * D / 8; e += kThreads) {
      const int r = e / (D / 8), d0 = (e % (D / 8)) * 8;
      uint4 kraw = make_uint4(0, 0, 0, 0), vraw = make_uint4(0, 0, 0, 0);
      if (j0 + r < kv_len) {
        kraw = *reinterpret_cast<const uint4*>(k + (j0 + r) * kv_stride + d0);
        vraw = *reinterpret_cast<const uint4*>(v + (j0 + r) * kv_stride + d0);
      }
      const bf16* hk8 = reinterpret_cast<const bf16*>(&kraw);
#pragma unroll
      for (int j = 0; j < 8; ++j) kT[d0 + j][r] = hk8[j];
      *reinterpret_cast<uint4*>(&vs[r][d0]) = vraw;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
      load_bf16<4>(&qT[d][rg * 4], qv);
      load_bf16<4>(&kT[d][cg * 4], kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg * 4 + i;
      const int qpos = q_pos0 + r;
      float mx = kMaxInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + cg * 4 + j;
        const bool ok = col < kv_len && r < see_rows && (!causal || kv_pos0 + col <= qpos);
        s[i][j] = ok ? s[i][j] * scale_log2 : __int_as_float(0xff800000);  // -inf
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        ps[r][cg * 4 + j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[rg * 4 + i][j];
#pragma unroll
      for (int c8 = 0; c8 < DC; c8 += 8) {
        float vv[8];
        load_bf16<8>(&vs[j][cg * DC + c8], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c8 + c] += pv[i] * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    if (r >= rows) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int c8 = 0; c8 < DC; c8 += 8) {
      float ov[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) ov[c] = o[i][c8 + c] * inv;
      store_bf16<8>(out + r * q_stride + cg * DC + c8, ov);
    }
    if (lse != nullptr && cg == 0) lse[r] = l[i] == 0.f ? kEmptyLse : m[i] + log2f(l[i]);
  }
}

}  // namespace skt
