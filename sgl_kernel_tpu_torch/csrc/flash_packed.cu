// K9: flash-attention prefill over block-aligned packed tokens.
//
// Replaces flash_attention_packed (sgl_kernel_tpu/ops/attention/
// flash_packed.py:195, Pallas kernel _kernel, pallas_call at :292).
// Contract: q [TPq, Hq, D], k/v [TPkv, Hkv, D] bf16, each sequence starting
// at a multiple of `block` tokens; blk_seq / blk_q0 [NQB] int32 give each
// q block's sequence and in-sequence row 0; seq_meta [B, 6] int32 rows
// (q_len, kv_len, q_start, kv_start, kv_blk0, kv_blks). Query row r of a
// sequence sits at global position q_start + r and sees key c (packed row
// kv_blk0 * block + c, position kv_start + c) when r < q_len,
// c < min(kv_len, kv_blks * block, max_kvb * block) and, causal, the key's
// position <= the query's (flash_packed.py:141-160). out [TPq, Hq, D]; lse
// [Hq, TPq] float32 base 2 when its pointer is not null. A row that sees no
// key (past q_len, or a padding block whose sequence has q_len 0) gets
// o = 0 and the twin's lse, -1e30 * log2(e), and reads nothing.
//
// Bound: operations, 4 * Hq * D * sum_i len_i (len_i + 1) / 2 at the bf16
// tensor-core peak (989 TFLOP/s) for a causal self-attention batch. Design:
// the 256-token alignment stays the contract, not the tile. One warpgroup of
// 128 threads per (q head, 64-row q tile) reads its sequence id and offsets
// from the metadata itself (there is no scalar prefetch) and runs the wgmma
// tile of flash_tile.cuh, shared with K7, over that sequence's keys up to
// the tile's causal limit: the work follows each sequence's length, and
// max_kvb (a power-of-two pad in the engine) only caps it as the TPU grid's
// kv extent does. blockIdx.x is the head and blockIdx.y the packed tile in
// reverse, so each sequence's last tiles (the most keys) start first, over
// every head. The TPU kernel's clamped index maps, which made skipped steps
// re-fetch nothing, have no counterpart: skipped tiles are never visited,
// and key rows past kv_len are never read.
//
// Head dim 576 (DeepSeek MLA packed prefill, deepseek.py:444-459: q
// [TP, 16, 576] against one latent K/V head) takes K7's 576 tile
// (mla_tile.cuh): a block's 16 rows are consecutive (position, head) pairs
// of one packed q block and KV head, one position's 16 heads for MLA.

#include "flash_tile.cuh"
#include "mla_tile.cuh"

namespace {

using skt::bf16;

template <int D>
__global__ void __launch_bounds__(skt::kFlashThreads) packed_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ blk_seq,
    const int* __restrict__ blk_q0, const int* __restrict__ seq_meta,
    bf16* __restrict__ out, float* __restrict__ lse, int tp, int block,
    int n_q_heads, int n_kv_heads, int max_kvb, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = block / skt::kFlashBQ;
  const int h = blockIdx.x;
  const int by = gridDim.y - 1 - blockIdx.y;  // a sequence's last tiles (the most keys) first
  const int nb = by / tiles;
  const int sub = (by % tiles) * skt::kFlashBQ;
  const int hk = h / (n_q_heads / n_kv_heads);

  const int* meta = seq_meta + blk_seq[nb] * 6;
  const int q0 = blk_q0[nb] + sub;  // in-sequence index of the tile's row 0
  const int q_len = meta[0];
  const int kv_len = min(min(meta[1], meta[5] * block), max_kvb * block);
  const int q_start = meta[2];
  const int kv_start = meta[3];

  const long long q_row_stride = (long long)n_q_heads * D;
  const long long kv_row_stride = (long long)n_kv_heads * D;
  const long long row0 = (long long)nb * block + sub;  // packed row of the tile
  const long long q_off = row0 * q_row_stride + (long long)h * D;
  const long long kv_off = (long long)meta[4] * block * kv_row_stride + (long long)hk * D;
  skt::flash_rows<D>(smem, q + q_off, q_row_stride, k + kv_off, v + kv_off, kv_row_stride, out + q_off,
                     lse == nullptr ? nullptr : lse + (long long)h * tp + row0,
                     skt::kFlashBQ, q_len - q0, kv_len, q_start + q0, kv_start, causal, scale_log2);
}

__global__ void __launch_bounds__(skt::kMlaThreads) packed576_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const int* __restrict__ blk_seq, const int* __restrict__ blk_q0, const int* __restrict__ seq_meta,
    bf16* __restrict__ out, float* __restrict__ lse, int tp, int block, int n_q_heads, int n_kv_heads,
    int max_kvb, int causal, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int D = skt::kMlaD;
  const int group = n_q_heads / n_kv_heads;
  const int tiles = block * group / skt::kMlaRows;
  const int nb = blockIdx.x / tiles;
  const int r0 = (blockIdx.x % tiles) * skt::kMlaRows;  // first (position, head) row in the q block
  const int hk = blockIdx.y;
  const int* meta = seq_meta + blk_seq[nb] * 6;
  const int q0 = blk_q0[nb];
  const int q_len = meta[0];
  const int kv_len = min(min(meta[1], meta[5] * block), max_kvb * block);
  const int q_start = meta[2];
  const int kv_start = meta[3];
  // the last row that sees keys sets the causal limit
  const int last_vis = min((r0 + skt::kMlaRows - 1) / group, q_len - q0 - 1);
  int kv_end = last_vis >= r0 / group ? kv_len : 0;
  if (causal && kv_end > 0) kv_end = min(kv_end, max(0, q_start + q0 + last_vis - kv_start + 1));
  auto offset = [&](int r) {
    const long long row = (long long)nb * block + (r0 + r) / group;
    return row * n_q_heads * D + (long long)(hk * group + (r0 + r) % group) * D;
  };
  const long long kv_off = (long long)meta[4] * block * n_kv_heads * D + (long long)hk * D;
  skt::mla_flash_rows(
      smem, [&](int r) { return q + offset(r); }, k + kv_off, v + kv_off, (long long)n_kv_heads * D, kv_len,
      kv_end, kv_start, causal, [&](int r) { return q_start + q0 + (r0 + r) / group; },
      [&](int r) { return q0 + (r0 + r) / group < q_len; }, [&](int r) { return out + offset(r); },
      [&](int r) -> float* {
        if (lse == nullptr) return nullptr;
        return lse + (long long)(hk * group + (r0 + r) % group) * tp + (long long)nb * block + (r0 + r) / group;
      },
      scale_log2);
}

template <int D>
int launch_packed(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, const int* blk_seq,
                  const int* blk_q0, const int* seq_meta, bf16* out, float* lse, int nqb, int block, int n_q_heads,
                  int n_kv_heads, int max_kvb, int causal, float scale_log2) {
  constexpr size_t bytes = skt::FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads fastest: blocks start in order, so each sequence's long tiles start together over every head
  dim3 grid(n_q_heads, nqb * (block / skt::kFlashBQ));
  packed_kernel<D><<<grid, skt::kFlashThreads, bytes, st>>>(q, k, v, blk_seq, blk_q0, seq_meta, out, lse,
                                                            nqb * block, block, n_q_heads, n_kv_heads, max_kvb,
                                                            causal, scale_log2);
  return (int)cudaSuccess;
}

}  // namespace

// Supported: head_dim 64, 128 or 576 (576: Hq / Hkv dividing 16 or a
// multiple of 16), bf16, Hq a multiple of Hkv, block a
// multiple of 64. tp = NQB * block. lse may be null.
extern "C" int skt_flash_packed(
    const void* q, const void* k, const void* v, const void* blk_seq, const void* blk_q0,
    const void* seq_meta, void* out, void* lse, int nqb, int block, int n_q_heads,
    int n_kv_heads, int head_dim, int max_kvb, int causal, float sm_scale, void* stream) {
  if (block % skt::kFlashBQ != 0) return (int)cudaErrorInvalidValue;
  const int tp = nqb * block;
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
    case 128: {
      auto launch = head_dim == 64 ? launch_packed<64> : launch_packed<128>;
      const int err = launch(st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)blk_seq,
                             (const int*)blk_q0, (const int*)seq_meta, (bf16*)out, (float*)lse, nqb, block, n_q_heads,
                             n_kv_heads, max_kvb, causal, sl);
      if (err != 0) return err;
      break;
    }
    case 576: {
      const int group = n_q_heads / n_kv_heads;
      if (skt::kMlaRows % group && group % skt::kMlaRows) return (int)cudaErrorInvalidValue;
      constexpr size_t bytes = skt::MlaSmem<true>::kBytes;
      cudaError_t err = cudaFuncSetAttribute(packed576_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
      if (err != cudaSuccess) return (int)err;
      dim3 grid576(nqb * (block * group / skt::kMlaRows), n_kv_heads);
      packed576_kernel<<<grid576, skt::kMlaThreads, bytes, st>>>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)blk_seq, (const int*)blk_q0, (const int*)seq_meta, (bf16*)out, (float*)lse, tp, block, n_q_heads, n_kv_heads, max_kvb, causal, sl);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
