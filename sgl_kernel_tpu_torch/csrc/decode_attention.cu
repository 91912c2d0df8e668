// K5: one-token GQA decode attention over layer-stacked paged KV pools.
//
// Replaces paged_attention_decode_dma (sgl_kernel_tpu/ops/attention/
// paged_decode_dma.py:306, Pallas kernel _kernel, pallas_call at :461).
// Contract: q [B, Hq, D]; pools [L, P, Hkv, page, D]; page table
// [B, n_blocks]; lengths [B] count the current token. With fresh K/V the
// pool holds length-1 tokens and the fresh row is merged last
// (paged_decode_dma.py:118-122, :246-271); a row with no pool tokens and
// no fresh row gives 0 (:277). Padding rows (length 0) read nothing.
//
// Bound: bytes. Every pool token of the batch is read once for K and once
// for V (about 2 x 16 x 1056 x 8 x 128 x 2 B = 69 MB at the main path's
// ragged B=16), against 2 flops per byte: far below the card's ridge.
// Design: one block per (KV head, sequence), so each K/V row is read once
// for the whole group of G query heads (the TPU kernel's page DMA reads
// all heads of a page; here the block reads one head's rows, 256 B each,
// as one coalesced warp load). Four warps take interleaved groups of four
// tokens, start all eight row loads of a group before using any (more
// bytes in flight per warp), and keep a per-warp f32 online softmax in
// the log2 domain. The warps' states merge through shared memory, and the
// fresh row joins the merge. The TPU's manual double-buffered DMA and its
// sequence folding (one core must never wait) have no counterpart: the
// card hides latency with many resident warps instead.

#include "common.cuh"

namespace {

using skt::bf16;

constexpr int kWarps = 4;
constexpr int kUnroll = 4;

template <int D, int G>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
    const bf16* __restrict__ v_pool, const bf16* __restrict__ fresh_k,
    const bf16* __restrict__ fresh_v, const int* __restrict__ lengths,
    const int* __restrict__ table, bf16* __restrict__ out, int n_pages,
    int n_kv_heads, int page, int n_blocks, int layer, float scale_log2) {
  constexpr int N = D / 32;  // elements of a row per lane
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_q_heads = n_kv_heads * G;

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    skt::load_bf16<N>(q + ((long long)b * n_q_heads + h * G + g) * D + lane * N, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] *= scale_log2;
  }

  const int length = lengths[b];
  int n = fresh_k ? length - 1 : length;
  n = min(n, n_blocks * page);
  const int* pt = table + (long long)b * n_blocks;
  const long long layer_base = (long long)layer * n_pages;

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = skt::kMaxInit;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = warp * kUnroll; t0 < n; t0 += kWarps * kUnroll) {
    float kr[kUnroll][N], vr[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < n) {
        const long long pid = pt[t / page];
        const long long row =
            (((layer_base + pid) * n_kv_heads + h) * page + t % page) * D + lane * N;
        skt::load_bf16<N>(k_pool + row, kr[u]);
        skt::load_bf16<N>(v_pool + row, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= n) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) s += qr[g][i] * kr[u][i];
        s = skt::warp_sum(s);
        const float m_new = fmaxf(m[g], s);
        const float alpha = exp2f(m[g] - m_new);
        const float p = exp2f(s - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[g][i] = acc[g][i] * alpha + p * vr[u][i];
        m[g] = m_new;
      }
    }
  }

  __shared__ float sm_m[kWarps][G], sm_l[kWarps][G], sm_fresh[G];
  __shared__ float sm_acc[kWarps][G][D];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      sm_m[warp][g] = m[g];
      sm_l[warp][g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) sm_acc[warp][g][lane * N + i] = acc[g][i];
  }
  if (fresh_k) {
    float fk[N];
    skt::load_bf16<N>(fresh_k + ((long long)b * n_kv_heads + h) * D + lane * N, fk);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g % kWarps != warp) continue;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) s += qr[g][i] * fk[i];
      s = skt::warp_sum(s);
      if (lane == 0) sm_fresh[g] = s;
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += kWarps * 32) {
    const int g = idx / D, d = idx % D;
    float mt = skt::kMaxInit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mt = fmaxf(mt, sm_m[w][g]);
    float lt = 0.f, at = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(sm_m[w][g] - mt);
      lt += sm_l[w][g] * c;
      at += sm_acc[w][g][d] * c;
    }
    if (fresh_k) {
      const float sf = sm_fresh[g];
      const float m_new = fmaxf(mt, sf);
      const float alpha = exp2f(mt - m_new);
      const float pf = exp2f(sf - m_new);
      const float vf = __bfloat162float(fresh_v[((long long)b * n_kv_heads + h) * D + d]);
      lt = lt * alpha + pf;
      at = at * alpha + pf * vf;
    }
    const float o = lt == 0.f ? 0.f : at / lt;
    out[((long long)b * n_q_heads + h * G + g) * D + d] = __float2bfloat16(o);
  }
}

template <int D, int G>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* fresh_k, const void* fresh_v, const void* lengths,
                   const void* table, void* out, int batch, int n_pages,
                   int n_kv_heads, int page, int n_blocks, int layer,
                   float scale_log2, cudaStream_t stream) {
  dim3 grid(n_kv_heads, batch);
  decode_kernel<D, G><<<grid, kWarps * 32, 0, stream>>>(
      (const bf16*)q, (const bf16*)k_pool, (const bf16*)v_pool,
      (const bf16*)fresh_k, (const bf16*)fresh_v, (const int*)lengths,
      (const int*)table, (bf16*)out, n_pages, n_kv_heads, page, n_blocks,
      layer, scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_group(int group, const void* q, const void* kp, const void* vp,
                           const void* fk, const void* fv, const void* lens,
                           const void* table, void* out, int batch, int n_pages,
                           int hkv, int page, int n_blocks, int layer, float sl,
                           cudaStream_t st) {
  switch (group) {
    case 1: return launch<D, 1>(q, kp, vp, fk, fv, lens, table, out, batch, n_pages, hkv, page, n_blocks, layer, sl, st);
    case 2: return launch<D, 2>(q, kp, vp, fk, fv, lens, table, out, batch, n_pages, hkv, page, n_blocks, layer, sl, st);
    case 4: return launch<D, 4>(q, kp, vp, fk, fv, lens, table, out, batch, n_pages, hkv, page, n_blocks, layer, sl, st);
    case 8: return launch<D, 8>(q, kp, vp, fk, fv, lens, table, out, batch, n_pages, hkv, page, n_blocks, layer, sl, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fresh_k/fresh_v may be null (no fresh row). Supported: head_dim 64, 128,
// 256; group 1, 2, 4, 8; bf16 pools.
extern "C" int skt_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* fresh_k,
    const void* fresh_v, const void* lengths, const void* table, void* out,
    int batch, int n_pages, int n_kv_heads, int page, int n_blocks,
    int head_dim, int group, int layer, float sm_scale, void* stream) {
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (head_dim) {
    case 64: err = dispatch_group<64>(group, q, k_pool, v_pool, fresh_k, fresh_v, lengths, table, out, batch, n_pages, n_kv_heads, page, n_blocks, layer, sl, st); break;
    case 128: err = dispatch_group<128>(group, q, k_pool, v_pool, fresh_k, fresh_v, lengths, table, out, batch, n_pages, n_kv_heads, page, n_blocks, layer, sl, st); break;
    case 256: err = dispatch_group<256>(group, q, k_pool, v_pool, fresh_k, fresh_v, lengths, table, out, batch, n_pages, n_kv_heads, page, n_blocks, layer, sl, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
