// K7: causal flash-attention prefill with GQA and ragged lengths.
//
// Replaces flash_attention (sgl_kernel_tpu/ops/attention/flash_prefill.py:165,
// Pallas kernel _kernel, pallas_call at :260). Contract: q [B, Sq, Hq, D],
// k/v [B, Skv, Hkv, D], out [B, Sq, Hq, D], all bf16. lens [B, 4] int32 holds
// (q_len, kv_len, q_start, kv_start) as in the TPU kernel's scalar prefetch:
// query row r sits at global position q_start + r, key row c at kv_start + c;
// a key is visible when c < kv_len and (not causal or its position <= the
// query's) (flash_prefill.py:119-139). Rows at or past q_len are padding:
// a q tile wholly past q_len is written as zeros, other padding rows get the
// formula's value; all stay finite.
//
// Bound: operations. At the main path's S=1024 causal prefill with 32 heads
// of 128 the kernel does ~9 GFLOP per layer against ~17 MB of q/k/v/o, far
// past the ridge. Design (first version, no tensor cores): one block of 128
// threads per (q tile of 64 rows, q head, sequence). q and each 32-row K/V
// tile sit in shared memory as bf16, q and K transposed so that a thread's
// four query rows and four key columns are each one 8-byte read without
// bank conflicts. Each thread computes a 4x4 block of scores in f32, takes
// the row max and sum over the 8 lanes that share its rows, and keeps a 4-row
// by D/8-column slice of the output accumulator in registers; the
// probability tile passes through shared memory (rows padded to 33 floats)
// into the P.V product. Softmax runs in the log2 domain. KV tiles past the
// tile's last causal position are skipped. The TPU kernel's head-major
// transpose is not needed: the kernel reads the [B, S, H, D] layout with
// strides. Later work: mma.sync/wgmma tiles and a TMA-fed pipeline.

#include "common.cuh"

namespace {

using skt::bf16;

constexpr int BQ = 64;
constexpr int BK = 32;
constexpr int kThreads = 128;

template <int D>
__global__ void __launch_bounds__(kThreads) flash_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lens,
    bf16* __restrict__ out, int sq, int skv, int n_q_heads, int n_kv_heads,
    int causal, float scale_log2) {
  constexpr int DC = D / 8;  // output columns per thread
  __shared__ __align__(16) bf16 qT[D][BQ];
  __shared__ __align__(16) bf16 kT[D][BK];
  __shared__ __align__(16) bf16 vs[BK][D];
  __shared__ float ps[BQ][BK + 1];

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (n_q_heads / n_kv_heads);
  const int tid = threadIdx.x;
  const int rg = tid / 8;  // rows rg*4 .. rg*4+3
  const int cg = tid % 8;  // score cols cg*4 .. +3, output cols cg*DC .. +DC-1

  const int q_len = lens[b * 4 + 0];
  const int kv_len = min(lens[b * 4 + 1], skv);
  const int q_start = lens[b * 4 + 2];
  const int kv_start = lens[b * 4 + 3];

  const long long q_row_stride = (long long)n_q_heads * D;
  const long long kv_row_stride = (long long)n_kv_heads * D;
  const bf16* qb = q + (long long)b * sq * q_row_stride + (long long)h * D;
  const bf16* kb = k + (long long)b * skv * kv_row_stride + (long long)hk * D;
  const bf16* vb = v + (long long)b * skv * kv_row_stride + (long long)hk * D;
  bf16* ob = out + (long long)b * sq * q_row_stride + (long long)h * D;

  float o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = skt::kMaxInit;
    l[i] = 0.f;
  }

  // visible keys for this tile: the last query row's causal limit
  int kv_end = q0 < q_len ? kv_len : 0;
  if (causal && kv_end > 0)
    kv_end = min(kv_end, max(0, q_start + min(q0 + BQ, sq) - 1 - kv_start + 1));

  if (kv_end > 0) {
    // q tile -> qT[d][r] (8 bf16 per thread-step)
    for (int e = tid; e < BQ * D / 8; e += kThreads) {
      const int r = e / (D / 8), d0 = (e % (D / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (q0 + r < sq) raw = *reinterpret_cast<const uint4*>(qb + (q0 + r) * q_row_stride + d0);
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
      if (j0 + r < skv) {
        kraw = *reinterpret_cast<const uint4*>(kb + (j0 + r) * kv_row_stride + d0);
        vraw = *reinterpret_cast<const uint4*>(vb + (j0 + r) * kv_row_stride + d0);
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
      skt::load_bf16<4>(&qT[d][rg * 4], qv);
      skt::load_bf16<4>(&kT[d][cg * 4], kv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + q0 + rg * 4 + i;
      float mx = skt::kMaxInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + cg * 4 + j;
        const bool ok = col < kv_len && (!causal || kv_start + col <= qpos);
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
        ps[rg * 4 + i][cg * 4 + j] = p;
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
        skt::load_bf16<8>(&vs[j][cg * DC + c8], vv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 8; ++c) o[i][c8 + c] += pv[i] * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + rg * 4 + i;
    if (r >= sq) continue;
    const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
#pragma unroll
    for (int c8 = 0; c8 < DC; c8 += 8) {
      float ov[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) ov[c] = o[i][c8 + c] * inv;
      skt::store_bf16<8>(ob + r * q_row_stride + cg * DC + c8, ov);
    }
  }
}

}  // namespace

// Supported: head_dim 64 or 128, bf16, Hq a multiple of Hkv.
extern "C" int skt_flash_prefill(
    const void* q, const void* k, const void* v, const void* lens, void* out,
    int batch, int sq, int skv, int n_q_heads, int n_kv_heads, int head_dim,
    int causal, float sm_scale, void* stream) {
  dim3 grid((sq + BQ - 1) / BQ, n_q_heads, batch);
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
      flash_kernel<64><<<grid, kThreads, 0, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lens, (bf16*)out, sq, skv, n_q_heads, n_kv_heads, causal, sl);
      break;
    case 128:
      flash_kernel<128><<<grid, kThreads, 0, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lens, (bf16*)out, sq, skv, n_q_heads, n_kv_heads, causal, sl);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
