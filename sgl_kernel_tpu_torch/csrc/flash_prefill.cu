// K7: causal flash-attention prefill with GQA, ragged lengths and an
// optional base-2 lse.
//
// Replaces flash_attention (sgl_kernel_tpu/ops/attention/flash_prefill.py:165,
// Pallas kernel _kernel, pallas_call at :260). Contract: q [B, Sq, Hq, D],
// k/v [B, Skv, Hkv, D], out [B, Sq, Hq, D], all bf16; lse [B, Hq, Sq] float32
// base 2 (flash_prefill.py:286-287) when its pointer is not null. lens [B, 4]
// int32 holds (q_len, kv_len, q_start, kv_start) as in the TPU kernel's
// scalar prefetch: query row r sits at global position q_start + r, key row c
// at kv_start + c; a key is visible when c < kv_len and (not causal or its
// position <= the query's) (flash_prefill.py:119-139). Rows at or past q_len
// are padding: a q tile wholly past q_len is written as zeros (lse of a row
// that sees no key), other padding rows get the formula's value; all stay
// finite. A row that sees no key gets o = 0 and the twin's lse, -1e30 * log2(e).
// At head dims 64 / 128 the options of flash_prefill.py:39-82 too (gpt-oss):
// a sliding window (key position > query position - window; key tiles wholly
// outside it are not visited), a tanh soft cap and per-head sinks [Hq]
// float32 (natural log, in the denominator once; the lse includes them).
// Head dim 256 (hybrid GDN's GQA layers, Qwen3-Next's 16 heads of 256 over
// 2) runs the same tile with two warpgroups a block, each its 128 columns of
// O (flash_tile.cuh), one block an SM, with no option.
//
// Bound: operations, 4 * Hq * D per visible (query, key) pair at the bf16
// tensor-core peak (989 TFLOP/s): at the main path's S=1024 causal prefill
// with 32 heads of 128, ~8.2 GFLOP against ~17 MB of q/k/v/o, far past the
// ridge. Design, D = 64 and 128: one warpgroup of 128 threads per (q head,
// 64-row q tile, sequence) runs the wgmma tile of flash_tile.cuh, shared
// with K9: S = q K^T and O += P V on wgmma m64n64k16 from 128-byte-swizzled
// shared memory, K/V in two cp.async slots of 64-key tiles, the mask built
// only on the tiles that need it. Causal balance: blockIdx.x is the head
// and blockIdx.y the q tile in reverse, so blocks start with the tiles
// that have the most keys, over every head, and the short ones fill the
// tail (longest first; running two tiles T-1-x and x a block evened the
// work but measured slower wherever the grid runs more than one wave).
// The TPU kernel's head-major transpose is not needed: the kernel reads the
// [B, S, H, D] layout with strides.
//
// Head dim 576 (DeepSeek's MLA prefill: q [B, S, 16, 576] against one
// latent KV head, V its first 512 columns, mla.py:520-557) takes the tile of
// mla_flash_tile.cuh: a block's 64 rows are consecutive (position, head)
// pairs of one KV head, each row's causal limit its own position's. A null
// v is the MLA form: V is K's first 512 columns and out is [B, Sq, Hq, 512];
// else v is the caller's and out 576 wide. Grid: the KV head fastest, then
// the row tiles in reverse (longest first), then the sequence; a tile wholly
// past q_len visits no key and writes its zeros and lse.

#include "flash_tile.cuh"
#include "mla_flash_tile.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;

template <int D>
__global__ void __launch_bounds__(skt::FlashSmem<D>::kThreads) flash_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lens,
    bf16* __restrict__ out, float* __restrict__ lse, int sq, int skv,
    int n_q_heads, int n_kv_heads, int causal, float scale_log2, skt::FlashOpts opts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  if (opts.sinks != nullptr) opts.sinks += h;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * skt::kFlashBQ;  // the tiles with the most keys first
  const int b = blockIdx.z;
  const int hk = h / (n_q_heads / n_kv_heads);

  const int q_len = lens[b * 4 + 0];
  const int kv_len = min(lens[b * 4 + 1], skv);
  const int q_start = lens[b * 4 + 2];
  const int kv_start = lens[b * 4 + 3];

  const long long q_row_stride = (long long)n_q_heads * D;
  const long long kv_row_stride = (long long)n_kv_heads * D;
  const long long q_off = ((long long)b * sq + q0) * q_row_stride + (long long)h * D;
  const long long kv_off = (long long)b * skv * kv_row_stride + (long long)hk * D;
  const int rows = min(skt::kFlashBQ, sq - q0);
  // padding rows of a tile that starts before q_len attend like valid rows
  const int see_rows = q0 < q_len ? rows : 0;
  skt::flash_rows<D>(smem, q + q_off, q_row_stride, k + kv_off, v + kv_off, kv_row_stride, out + q_off,
                     lse == nullptr ? nullptr : lse + ((long long)b * n_q_heads + h) * sq + q0,
                     rows, see_rows, kv_len, q_start + q0, kv_start, causal, scale_log2, opts);
}

struct alignas(64) Args576 {
  CUtensorMap tk, tv;  // k / v as [B * Skv][Hkv * 576], boxes of 64 columns x 64 keys, 128-byte swizzle
  const bf16 *q, *q_pe, *k, *v;  // q_pe: q's rope columns in the MLA form (v null), else null
  const int* lens;
  bf16* out;
  float* lse;
  int sq, skv, n_q_heads, n_kv_heads, causal;
  float scale_log2;
};

template <bool SEP_V>
__global__ void __launch_bounds__(skt::kMfThreads, 1) flash576_kernel(const __grid_constant__ Args576 a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int D = skt::kMfD, DV = SEP_V ? D : 512;
  const int group = a.n_q_heads / a.n_kv_heads;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * skt::kMfRows;  // first (position, head) row: longest first
  const int n_rows = min(skt::kMfRows, a.sq * group - r0);
  const int q_len = a.lens[b * 4 + 0];
  const int kv_len = min(a.lens[b * 4 + 1], a.skv);
  const int q_start = a.lens[b * 4 + 2];
  const int kv_start = a.lens[b * 4 + 3];
  // padding rows of a tile that starts before q_len attend like valid rows
  const bool see = r0 / group < q_len;
  auto limit = [&](int r) {
    if (!see) return 0;
    return a.causal ? min(kv_len, max(0, q_start + (r0 + r) / group - kv_start + 1)) : kv_len;
  };
  const int kv_end = limit(n_rows - 1);  // the last row's limit is the largest
  const long long kv_stride = (long long)a.n_kv_heads * D;
  const long long kv_off = (long long)b * a.skv * kv_stride + (long long)hk * D;
  const skt::MfKeys keys{(kv_end + skt::kMfKeys - 1) / skt::kMfKeys, kv_len, b * a.skv, hk * D, a.k + kv_off,
                         SEP_V ? a.v + kv_off : nullptr, kv_stride};
  auto row_of = [&](int r) {  // (position, head) of row r, as a row of [B * Sq * Hq]
    return ((long long)b * a.sq + (r0 + r) / group) * a.n_q_heads + hk * group + (r0 + r) % group;
  };
  const auto rows = skt::mf_rows(
      [&](int r, int ch) -> const bf16* { return r < n_rows ? skt::mf_q_chunk<!SEP_V>(a.q, a.q_pe, row_of(r), ch) : nullptr; },
      limit,
      [&](int r) -> bf16* { return r < n_rows ? a.out + row_of(r) * DV : nullptr; },
      [&](int r) -> float* {
        if (a.lse == nullptr || r >= n_rows) return nullptr;
        return a.lse + ((long long)b * a.n_q_heads + hk * group + (r0 + r) % group) * a.sq + (r0 + r) / group;
      });
  skt::mla_flash_block<SEP_V>(smem, &a.tk, &a.tv, keys, rows, a.scale_log2);
}

template <bool SEP_V>
int launch576(cudaStream_t st, Args576& a, int batch) {
  constexpr size_t bytes = skt::MfSmem::kBytes;
  const long long rows = (long long)batch * a.skv, cols = (long long)a.n_kv_heads * skt::kMfD;
  if (!skt::map_2d(&a.tk, a.k, 2, rows, cols, cols, 64, skt::kMfKeys, true) ||
      (SEP_V && !skt::map_2d(&a.tv, a.v, 2, rows, cols, cols, 64, skt::kMfKeys, true)))
    return (int)cudaErrorInvalidValue;
  if (!SEP_V) a.tv = a.tk;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(flash576_kernel<SEP_V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int group = a.n_q_heads / a.n_kv_heads;
  dim3 grid(a.n_kv_heads, (a.sq * group + skt::kMfRows - 1) / skt::kMfRows, batch);
  flash576_kernel<SEP_V><<<grid, skt::kMfThreads, bytes, st>>>(a);
  return (int)cudaSuccess;
}

template <int D>
int launch_flash(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* out,
                 float* lse, int batch, int sq, int skv, int n_q_heads, int n_kv_heads, int causal,
                 float scale_log2, const skt::FlashOpts& opts) {
  constexpr size_t bytes = skt::FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads fastest: blocks start in order, so the grid runs longest-first over every head
  dim3 grid(n_q_heads, (sq + skt::kFlashBQ - 1) / skt::kFlashBQ, batch);
  flash_kernel<D><<<grid, skt::FlashSmem<D>::kThreads, bytes, st>>>(q, k, v, lens, out, lse, sq, skv, n_q_heads, n_kv_heads,
                                                           causal, scale_log2, opts);
  return (int)cudaSuccess;
}

}  // namespace

// Supported: head_dim 64, 128, 256 or 576 (576: Hq / Hkv dividing 16 or a
// multiple of 16; the MLA form: v null, V = K's first 512 columns, out
// [B, Sq, Hq, 512], q the latent's 512 columns and q_pe [B, Sq, Hq, 64] the
// rope's; otherwise q_pe null), bf16, Hq a multiple of Hkv. lse may be
// null. window (0: none), softcap (0: none) and sinks ([Hq] float32, or
// null) at head dims 64 / 128 only.
extern "C" int skt_flash_prefill(
    const void* q, const void* q_pe, const void* k, const void* v, const void* lens, void* out, void* lse,
    int batch, int sq, int skv, int n_q_heads, int n_kv_heads, int head_dim,
    int causal, float sm_scale, int window, float softcap, const void* sinks, void* stream) {
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  if (window < 0 || softcap < 0.f || (head_dim == 576 && (window || softcap != 0.f || sinks)))
    return (int)cudaErrorInvalidValue;
  const skt::FlashOpts opts{window, softcap > 0.f ? sm_scale / softcap : 0.f, softcap * skt::kLog2e,
                            (const float*)sinks};
  switch (head_dim) {
    case 64:
    case 128:
    case 256: {
      if (head_dim == 256 && (window || softcap != 0.f || sinks)) return (int)cudaErrorInvalidValue;
      auto launch = head_dim == 64 ? launch_flash<64> : head_dim == 128 ? launch_flash<128> : launch_flash<256>;
      const int err = launch(st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lens, (bf16*)out,
                             (float*)lse, batch, sq, skv, n_q_heads, n_kv_heads, causal, sl, opts);
      if (err != 0) return err;
      break;
    }
    case 576: {
      const int group = n_q_heads / n_kv_heads;
      if ((16 % group && group % 16) || (v == nullptr) != (q_pe != nullptr)) return (int)cudaErrorInvalidValue;
      Args576 a{};
      a.q = (const bf16*)q, a.q_pe = (const bf16*)q_pe, a.k = (const bf16*)k, a.v = (const bf16*)v;
      a.lens = (const int*)lens;
      a.out = (bf16*)out, a.lse = (float*)lse;
      a.sq = sq, a.skv = skv, a.n_q_heads = n_q_heads, a.n_kv_heads = n_kv_heads, a.causal = causal;
      a.scale_log2 = sl;
      const int err = v == nullptr ? launch576<false>(st, a, batch) : launch576<true>(st, a, batch);
      if (err != 0) return err;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
