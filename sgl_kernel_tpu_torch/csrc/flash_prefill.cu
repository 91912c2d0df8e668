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
// Head dim 576 (DeepSeek MLA prefill: q [B, S, 16, 576], one latent K/V
// head, V zero past 512, mla.py:520-557) takes another tile: the 16 query
// rows of a block are the (position, head) pairs of one KV head in order,
// which for 16 heads over one KV head is one position's heads, so each K/V
// tile is read once for all of them (mla_tile.cuh, mma.sync). Grid: one
// block per 16 such rows, per KV head and sequence; the causal limit is the
// block's last position.

#include "flash_tile.cuh"
#include "mla_tile.cuh"

namespace {

using skt::bf16;

template <int D>
__global__ void __launch_bounds__(skt::kFlashThreads) flash_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ lens,
    bf16* __restrict__ out, float* __restrict__ lse, int sq, int skv,
    int n_q_heads, int n_kv_heads, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
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
                     rows, see_rows, kv_len, q_start + q0, kv_start, causal, scale_log2);
}

__global__ void __launch_bounds__(skt::kMlaThreads) flash576_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ lens, bf16* __restrict__ out, float* __restrict__ lse, int sq, int skv,
    int n_q_heads, int n_kv_heads, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int D = skt::kMlaD;
  const int group = n_q_heads / n_kv_heads;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * skt::kMlaRows;  // first (position, head) row of the KV head
  const int total = sq * group;
  const int q_len = lens[b * 4 + 0];
  const int kv_len = min(lens[b * 4 + 1], skv);
  const int q_start = lens[b * 4 + 2];
  const int kv_start = lens[b * 4 + 3];
  const int last_pos = (min(total, r0 + skt::kMlaRows) - 1) / group;
  // padding rows of a block that starts before q_len attend like valid rows
  const bool see = r0 / group < q_len;
  int kv_end = see ? kv_len : 0;
  if (causal && kv_end > 0) kv_end = min(kv_end, max(0, q_start + last_pos - kv_start + 1));
  auto offset = [&](int r) {
    const int pos = (r0 + r) / group, head = hk * group + (r0 + r) % group;
    return ((long long)b * sq + pos) * n_q_heads * D + (long long)head * D;
  };
  const long long kv_off = (long long)b * skv * n_kv_heads * D + (long long)hk * D;
  skt::mla_flash_rows(
      smem, [&](int r) { return r0 + r < total ? q + offset(r) : nullptr; }, k + kv_off, v + kv_off,
      (long long)n_kv_heads * D, kv_len, kv_end, kv_start, causal,
      [&](int r) { return q_start + (r0 + r) / group; }, [&](int) { return see; },
      [&](int r) { return out + offset(r); },
      [&](int r) -> float* {
        if (lse == nullptr) return nullptr;
        const int pos = (r0 + r) / group, head = hk * group + (r0 + r) % group;
        return lse + ((long long)b * n_q_heads + head) * sq + pos;
      },
      scale_log2);
}

template <int D>
int launch_flash(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, const int* lens, bf16* out,
                 float* lse, int batch, int sq, int skv, int n_q_heads, int n_kv_heads, int causal,
                 float scale_log2) {
  constexpr size_t bytes = skt::FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads fastest: blocks start in order, so the grid runs longest-first over every head
  dim3 grid(n_q_heads, (sq + skt::kFlashBQ - 1) / skt::kFlashBQ, batch);
  flash_kernel<D><<<grid, skt::kFlashThreads, bytes, st>>>(q, k, v, lens, out, lse, sq, skv, n_q_heads, n_kv_heads,
                                                           causal, scale_log2);
  return (int)cudaSuccess;
}

}  // namespace

// Supported: head_dim 64, 128 or 576 (576: Hq / Hkv dividing 16 or a
// multiple of 16), bf16, Hq a multiple of Hkv. lse may be null.
extern "C" int skt_flash_prefill(
    const void* q, const void* k, const void* v, const void* lens, void* out, void* lse,
    int batch, int sq, int skv, int n_q_heads, int n_kv_heads, int head_dim,
    int causal, float sm_scale, void* stream) {
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
    case 128: {
      auto launch = head_dim == 64 ? launch_flash<64> : launch_flash<128>;
      const int err = launch(st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lens, (bf16*)out,
                             (float*)lse, batch, sq, skv, n_q_heads, n_kv_heads, causal, sl);
      if (err != 0) return err;
      break;
    }
    case 576: {
      const int group = n_q_heads / n_kv_heads;
      if (skt::kMlaRows % group && group % skt::kMlaRows) return (int)cudaErrorInvalidValue;
      constexpr size_t bytes = skt::MlaSmem<true>::kBytes;
      cudaError_t err = cudaFuncSetAttribute(flash576_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      dim3 grid576((sq * group + skt::kMlaRows - 1) / skt::kMlaRows, n_kv_heads, batch);
      flash576_kernel<<<grid576, skt::kMlaThreads, bytes, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)lens, (bf16*)out, (float*)lse, sq, skv, n_q_heads, n_kv_heads, causal, sl);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
