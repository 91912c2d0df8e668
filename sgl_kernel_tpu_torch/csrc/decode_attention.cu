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
// cap on pool and fresh scores (:97-98, :131-132), the base-2 lse, and
// split-KV: block (h, b, s) takes the pool tokens [s T, (s+1) T) of the
// sequence (T = split_tokens, whole chunks of pages as in
// paged_decode_dma.py:383-384) and writes its partial (o rounded to bf16,
// lse); the fresh row and the sinks join the last split (:267-275), and
// the caller merges the partials. A row with no pool tokens and no fresh
// row gives o = 0 and lse = -inf (:277, :281). Pools are bf16, int8, fp8
// e4m3 or fp8 e5m2; a quantized pool carries per-tensor k/v scales the JAX
// way (:392-405, :498-499): q * k_scale and fresh_k / k_scale, fresh_v /
// v_scale are rounded to bf16, and the bf16 output is multiplied by
// out_scale (v_scale, or 1 when the caller merges splits and scales after)
// and rounded again. 1-byte rows load as one 4-byte word a lane at D=128
// and are converted in registers, exactly (no denormal flush, unlike the
// TPU's bit-twiddle upcast at :41-70).
//
// Bound: bytes. Every pool token of the batch is read once for K and once
// for V (about 2 x 16 x 1056 x 8 x 128 x 2 B = 69 MB at the main path's
// ragged B=16; half that from 1-byte pools), against 2 flops per byte (4
// from 1-byte pools): far below the card's ridge.
// Design: one block per (KV head, sequence, split), so each K/V row is read
// once for the whole group of G query heads (the TPU kernel's page DMA reads
// all heads of a page; here the block reads one head's rows, 256 B each,
// as one coalesced warp load, and the strides make the two layouts the
// same loop). Four warps take interleaved groups of four tokens, start all
// eight row loads of a group before using any (more bytes in flight per
// warp), and keep a per-warp f32 online softmax in the log2 domain. The
// warps' states merge through shared memory, and the fresh row and the
// sinks join the merge. The split adds blocks for a small batch over a long
// context and leaves the per-block loop as it is. The TPU's manual
// double-buffered DMA and its sequence folding (one core must never wait)
// have no counterpart: the card hides latency with many resident warps.

#include <cuda_fp8.h>

#include "common.cuh"

namespace {

using skt::bf16;

// N consecutive pool elements -> float, one vector load, exact
template <int N>
__device__ __forceinline__ void load_row(const bf16* p, float (&out)[N]) {
  skt::load_bf16<N>(p, out);
}

template <int N> struct ByteVec;
template <> struct ByteVec<2> { typedef uint16_t T; };
template <> struct ByteVec<4> { typedef uint32_t T; };
template <> struct ByteVec<8> { typedef uint2 T; };

template <int N>
__device__ __forceinline__ void load_row(const int8_t* p, float (&out)[N]) {
  typename ByteVec<N>::T raw = *reinterpret_cast<const typename ByteVec<N>::T*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = (float)b[i];
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_fp8_e4m3* p, float (&out)[N]) {
  typename ByteVec<N>::T raw = *reinterpret_cast<const typename ByteVec<N>::T*>(p);
  const __nv_fp8_e4m3* b = reinterpret_cast<const __nv_fp8_e4m3*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = float(b[i]);
}

template <int N>
__device__ __forceinline__ void load_row(const __nv_fp8_e5m2* p, float (&out)[N]) {
  typename ByteVec<N>::T raw = *reinterpret_cast<const typename ByteVec<N>::T*>(p);
  const __nv_fp8_e5m2* b = reinterpret_cast<const __nv_fp8_e5m2*>(&raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = float(b[i]);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

constexpr int kWarps = 4;
constexpr int kUnroll = 4;

struct Args {
  const void *q, *k_pool, *v_pool, *fresh_k, *fresh_v;
  const float* sinks;  // [Hq] natural-log logits, or null
  const int *lengths, *table;
  void* out;           // [S, B, Hq, D] bf16 (S = n_splits)
  float* lse;          // [S, B, Hq] base 2, or null
  int batch, n_kv_heads, page, n_blocks;
  long long layer_stride, page_stride, head_stride;  // pool elements
  int layer, n_splits, split_tokens, window;        // window < 0: none
  float q_mul;     // sm_scale, times log2(e) without a soft cap
  float soft_cap;  // 0: none
  float k_scale, v_scale, out_scale;
  cudaStream_t stream;
};

// CAP: the soft cap, a compile-time choice so the uncapped loop carries no
// tanh or division
template <typename T, int D, int G, bool CAP>
__global__ void __launch_bounds__(kWarps * 32) decode_kernel(const Args a) {
  constexpr int N = D / 32;  // elements of a row per lane
  const int h = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_q_heads = a.n_kv_heads * G;
  const bf16* q = (const bf16*)a.q;
  const T* k_pool = (const T*)a.k_pool;
  const T* v_pool = (const T*)a.v_pool;
  const bf16* fresh_k = (const bf16*)a.fresh_k;
  const bf16* fresh_v = (const bf16*)a.fresh_v;
  const bool last_split = split == a.n_splits - 1;
  const bool has_fresh = fresh_k != nullptr && last_split;

  float qr[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    skt::load_bf16<N>(q + ((long long)b * n_q_heads + h * G + g) * D + lane * N, qr[g]);
#pragma unroll
    for (int i = 0; i < N; ++i) qr[g][i] = round_bf16(qr[g][i] * a.k_scale) * a.q_mul;
  }

  // the score of a dot product: the log2-domain logit, soft-capped first
  auto logit = [&](float s) { return CAP ? a.soft_cap * tanhf(s / a.soft_cap) * skt::kLog2e : s; };

  const int length = a.lengths[b];
  int n = fresh_k ? length - 1 : length;
  n = min(n, a.n_blocks * a.page);
  const int t_begin = max(split * a.split_tokens, a.window >= 0 ? length - a.window : 0);
  const int t_end = min(n, (split + 1) * a.split_tokens);
  const int* pt = a.table + (long long)b * a.n_blocks;
  const long long base = (long long)a.layer * a.layer_stride + (long long)h * a.head_stride + lane * N;

  float m[G], l[G], acc[G][N];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = skt::kMaxInit;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = t_begin + warp * kUnroll; t0 < t_end; t0 += kWarps * kUnroll) {
    float kr[kUnroll][N], vr[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < t_end) {
        const long long row = base + (long long)pt[t / a.page] * a.page_stride + (long long)(t % a.page) * D;
        load_row<N>(k_pool + row, kr[u]);
        load_row<N>(v_pool + row, vr[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (t0 + u >= t_end) break;  // uniform across the warp
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) s += qr[g][i] * kr[u][i];
        s = logit(skt::warp_sum(s));
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
  if (has_fresh) {
    float fk[N];
    skt::load_bf16<N>(fresh_k + ((long long)b * a.n_kv_heads + h) * D + lane * N, fk);
#pragma unroll
    for (int i = 0; i < N; ++i) fk[i] = round_bf16(fk[i] / a.k_scale);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g % kWarps != warp) continue;
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) s += qr[g][i] * fk[i];
      s = logit(skt::warp_sum(s));
      if (lane == 0) sm_fresh[g] = s;
    }
  }
  __syncthreads();

  bf16* out = (bf16*)a.out;
  const long long row0 = ((long long)split * a.batch + b) * n_q_heads + h * G;
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
    if (has_fresh) {
      const float sf = sm_fresh[g];
      const float m_new = fmaxf(mt, sf);
      const float alpha = exp2f(mt - m_new);
      const float pf = exp2f(sf - m_new);
      const float vf =
          round_bf16(__bfloat162float(fresh_v[((long long)b * a.n_kv_heads + h) * D + d]) / a.v_scale);
      lt = lt * alpha + pf;
      at = at * alpha + pf * vf;
      mt = m_new;
    }
    if (a.sinks && last_split) {
      // a logit with no value: it joins the running max and the denominator
      const float sk = a.sinks[h * G + g] * skt::kLog2e;
      const float m_new = fmaxf(mt, sk);
      const float alpha = exp2f(mt - m_new);
      lt = lt * alpha + exp2f(sk - m_new);
      at = at * alpha;
      mt = m_new;
    }
    const float o = round_bf16(lt == 0.f ? 0.f : at / lt);
    out[(row0 + g) * D + d] = __float2bfloat16(o * a.out_scale);
    if (a.lse && d == 0) a.lse[row0 + g] = lt == 0.f ? -INFINITY : mt + log2f(lt);
  }
}

template <typename T, int D, int G>
cudaError_t launch(const Args& a) {
  dim3 grid(a.n_kv_heads, a.batch, a.n_splits);
  if (a.soft_cap > 0.f)
    decode_kernel<T, D, G, true><<<grid, kWarps * 32, 0, a.stream>>>(a);
  else
    decode_kernel<T, D, G, false><<<grid, kWarps * 32, 0, a.stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int group, const Args& a) {
  switch (group) {
    case 1: return launch<T, D, 1>(a);
    case 2: return launch<T, D, 2>(a);
    case 4: return launch<T, D, 4>(a);
    case 8: return launch<T, D, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t dispatch_dim(int head_dim, int group, const Args& a) {
  switch (head_dim) {
    case 64: return dispatch_group<T, 64>(group, a);
    case 128: return dispatch_group<T, 128>(group, a);
    case 256: return dispatch_group<T, 256>(group, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// fresh_k/fresh_v, sinks and lse may be null. Strides are in pool elements:
// page-major pools have head_stride = page * D, page_stride = Hkv * page * D;
// head-major ones page_stride = page * D, head_stride = P * page * D.
// With n_splits > 1, out is [n_splits, B, Hq, D] and lse [n_splits, B, Hq]
// (required), each split covering split_tokens pool tokens. Supported:
// head_dim 64, 128, 256; group 1, 2, 4, 8; pool_type 0 bf16, 1 int8, 2 fp8
// e4m3, 3 fp8 e5m2 (q, fresh rows and output bf16); window < 0 and
// soft_cap = 0 turn those options off; scales of 1 for unscaled pools.
extern "C" int skt_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const void* fresh_k,
    const void* fresh_v, const void* sinks, const void* lengths, const void* table, void* out,
    void* lse, int batch, int n_kv_heads, int page, int n_blocks, int head_dim, int group,
    int pool_type, long long layer_stride, long long page_stride, long long head_stride,
    int layer, int n_splits, int split_tokens, int window, float sm_scale, float soft_cap,
    float k_scale, float v_scale, float out_scale, void* stream) {
  if (n_splits < 1 || (n_splits > 1 && (!lse || split_tokens < 1))) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, fresh_k, fresh_v, (const float*)sinks, (const int*)lengths,
               (const int*)table, out, (float*)lse, batch, n_kv_heads, page, n_blocks,
               layer_stride, page_stride, head_stride, layer, n_splits,
               n_splits > 1 ? split_tokens : (1 << 30), window,
               soft_cap > 0.f ? sm_scale : sm_scale * skt::kLog2e, soft_cap, k_scale, v_scale,
               out_scale, (cudaStream_t)stream};
  cudaError_t err;
  switch (pool_type) {
    case 0: err = dispatch_dim<bf16>(head_dim, group, a); break;
    case 1: err = dispatch_dim<int8_t>(head_dim, group, a); break;
    case 2: err = dispatch_dim<__nv_fp8_e4m3>(head_dim, group, a); break;
    case 3: err = dispatch_dim<__nv_fp8_e5m2>(head_dim, group, a); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
