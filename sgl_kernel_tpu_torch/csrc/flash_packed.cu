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
// o = 0 and the twin's lse, -1e30 * log2(e), and reads nothing. At head
// dims 64 / 128 the options of flash_packed.py:146-168 too (gpt-oss's packed
// admission): a sliding window (each 64-row block visits only the key tiles
// that hold a key one of its rows may see), a tanh soft cap and per-head
// sinks [Hq] float32 (natural log, in the denominator once).
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
// Head dim 576 (DeepSeek's MLA packed prefill, deepseek.py:444-459: q
// [TP, 16, 576] against one latent K/V head) takes K7's 576 tile
// (mla_flash_tile.cuh): a block's 64 rows are consecutive (position, head)
// pairs of one packed q block and KV head; a null v is the MLA form (V is
// K's first 512 columns, out [TPq, Hq, 512]).

#include "flash_tile.cuh"
#include "mla_flash_tile.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;

template <int D>
__global__ void __launch_bounds__(skt::kFlashThreads) packed_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const int* __restrict__ blk_seq,
    const int* __restrict__ blk_q0, const int* __restrict__ seq_meta,
    bf16* __restrict__ out, float* __restrict__ lse, int tp, int block,
    int n_q_heads, int n_kv_heads, int max_kvb, int causal, float scale_log2, skt::FlashOpts opts) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tiles = block / skt::kFlashBQ;
  const int h = blockIdx.x;
  if (opts.sinks != nullptr) opts.sinks += h;
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
                     skt::kFlashBQ, q_len - q0, kv_len, q_start + q0, kv_start, causal, scale_log2, opts);
}

struct alignas(64) Args576 {
  CUtensorMap tk, tv;  // k / v as [TPkv][Hkv * 576], boxes of 64 columns x 64 keys, 128-byte swizzle
  const bf16 *q, *q_pe, *k, *v;  // q_pe: q's rope columns in the MLA form (v null), else null
  const int *blk_seq, *blk_q0, *seq_meta;
  bf16* out;
  float* lse;
  int tp, block, n_q_heads, n_kv_heads, max_kvb, causal;
  float scale_log2;
};

template <bool SEP_V>
__global__ void __launch_bounds__(skt::kMfThreads, 1) packed576_kernel(const __grid_constant__ Args576 a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int D = skt::kMfD, DV = SEP_V ? D : 512;
  const int group = a.n_q_heads / a.n_kv_heads;
  const int tiles = a.block * group / skt::kMfRows;
  const int by = gridDim.y - 1 - blockIdx.y;  // a sequence's last tiles (the most keys) first
  const int nb = by / tiles, r0 = (by % tiles) * skt::kMfRows;  // first (position, head) row in the q block
  const int hk = blockIdx.x;
  const int* meta = a.seq_meta + a.blk_seq[nb] * 6;
  const int q0 = a.blk_q0[nb];
  const int q_len = meta[0];
  const int kv_len = min(min(meta[1], meta[5] * a.block), a.max_kvb * a.block);
  const int q_start = meta[2];
  const int kv_start = meta[3];
  auto limit = [&](int r) {  // rows past q_len see no key
    const int pos = q0 + (r0 + r) / group;
    if (pos >= q_len) return 0;
    return a.causal ? min(kv_len, max(0, q_start + pos - kv_start + 1)) : kv_len;
  };
  // the last row that sees keys has the largest limit
  const int last = min(skt::kMfRows - 1, (q_len - q0) * group - 1 - r0);
  const int kv_end = last >= 0 ? limit(last) : 0;
  const long long kv_stride = (long long)a.n_kv_heads * D;
  const int key_row0 = meta[4] * a.block;
  const long long kv_off = (long long)key_row0 * kv_stride + (long long)hk * D;
  const skt::MfKeys keys{(kv_end + skt::kMfKeys - 1) / skt::kMfKeys, kv_len, key_row0, hk * D,
                         a.k + kv_off, SEP_V ? a.v + kv_off : nullptr, kv_stride};
  auto row_of = [&](int r) {  // (packed token, head) of row r, as a row of [TPq * Hq]
    return ((long long)nb * a.block + (r0 + r) / group) * a.n_q_heads + hk * group + (r0 + r) % group;
  };
  const auto rows = skt::mf_rows(
      [&](int r, int ch) { return skt::mf_q_chunk<!SEP_V>(a.q, a.q_pe, row_of(r), ch); }, limit,
      [&](int r) -> bf16* { return a.out + row_of(r) * DV; },
      [&](int r) -> float* {
        if (a.lse == nullptr) return nullptr;
        return a.lse + (long long)(hk * group + (r0 + r) % group) * a.tp + (long long)nb * a.block + (r0 + r) / group;
      });
  skt::mla_flash_block<SEP_V>(smem, &a.tk, &a.tv, keys, rows, a.scale_log2);
}

template <bool SEP_V>
int launch576(cudaStream_t st, Args576& a, int nqb, int tp_kv) {
  constexpr size_t bytes = skt::MfSmem::kBytes;
  const long long cols = (long long)a.n_kv_heads * skt::kMfD;
  if (!skt::map_2d(&a.tk, a.k, 2, tp_kv, cols, cols, 64, skt::kMfKeys, true) ||
      (SEP_V && !skt::map_2d(&a.tv, a.v, 2, tp_kv, cols, cols, 64, skt::kMfKeys, true)))
    return (int)cudaErrorInvalidValue;
  if (!SEP_V) a.tv = a.tk;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(packed576_kernel<SEP_V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int group = a.n_q_heads / a.n_kv_heads;
  dim3 grid(a.n_kv_heads, nqb * (a.block * group / skt::kMfRows));
  packed576_kernel<SEP_V><<<grid, skt::kMfThreads, bytes, st>>>(a);
  return (int)cudaSuccess;
}

template <int D>
int launch_packed(cudaStream_t st, const bf16* q, const bf16* k, const bf16* v, const int* blk_seq,
                  const int* blk_q0, const int* seq_meta, bf16* out, float* lse, int nqb, int block, int n_q_heads,
                  int n_kv_heads, int max_kvb, int causal, float scale_log2, const skt::FlashOpts& opts) {
  constexpr size_t bytes = skt::FlashSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(packed_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  // heads fastest: blocks start in order, so each sequence's long tiles start together over every head
  dim3 grid(n_q_heads, nqb * (block / skt::kFlashBQ));
  packed_kernel<D><<<grid, skt::kFlashThreads, bytes, st>>>(q, k, v, blk_seq, blk_q0, seq_meta, out, lse,
                                                            nqb * block, block, n_q_heads, n_kv_heads, max_kvb,
                                                            causal, scale_log2, opts);
  return (int)cudaSuccess;
}

}  // namespace

// Supported: head_dim 64, 128 or 576 (576: Hq / Hkv dividing 16 or a
// multiple of 16; the MLA form: v null, V = K's first 512 columns, out
// [TPq, Hq, 512], q the latent's 512 columns and q_pe [TPq, Hq, 64] the
// rope's; otherwise q_pe null), bf16, Hq a multiple of Hkv, block a
// multiple of 64. tp = NQB * block; tp_kv = k's packed rows. lse may be
// null. window (0: none), softcap (0: none) and sinks ([Hq] float32, or
// null) at head dims 64 / 128 only.
extern "C" int skt_flash_packed(
    const void* q, const void* q_pe, const void* k, const void* v, const void* blk_seq, const void* blk_q0,
    const void* seq_meta, void* out, void* lse, int nqb, int block, int n_q_heads,
    int n_kv_heads, int head_dim, int max_kvb, int causal, float sm_scale, int tp_kv, int window, float softcap,
    const void* sinks, void* stream) {
  if (block % skt::kFlashBQ != 0 || window < 0 || softcap < 0.f ||
      (head_dim == 576 && (window || softcap != 0.f || sinks)))
    return (int)cudaErrorInvalidValue;
  const skt::FlashOpts opts{window, softcap > 0.f ? sm_scale / softcap : 0.f, softcap * skt::kLog2e,
                            (const float*)sinks};
  const int tp = nqb * block;
  const float sl = sm_scale * skt::kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  switch (head_dim) {
    case 64:
    case 128: {
      auto launch = head_dim == 64 ? launch_packed<64> : launch_packed<128>;
      const int err = launch(st, (const bf16*)q, (const bf16*)k, (const bf16*)v, (const int*)blk_seq,
                             (const int*)blk_q0, (const int*)seq_meta, (bf16*)out, (float*)lse, nqb, block, n_q_heads,
                             n_kv_heads, max_kvb, causal, sl, opts);
      if (err != 0) return err;
      break;
    }
    case 576: {
      const int group = n_q_heads / n_kv_heads;
      if ((16 % group && group % 16) || tp_kv <= 0 || (v == nullptr) != (q_pe != nullptr))
        return (int)cudaErrorInvalidValue;
      Args576 a{};
      a.q = (const bf16*)q, a.q_pe = (const bf16*)q_pe, a.k = (const bf16*)k, a.v = (const bf16*)v;
      a.blk_seq = (const int*)blk_seq, a.blk_q0 = (const int*)blk_q0, a.seq_meta = (const int*)seq_meta;
      a.out = (bf16*)out, a.lse = (float*)lse;
      a.tp = tp, a.block = block, a.n_q_heads = n_q_heads, a.n_kv_heads = n_kv_heads, a.max_kvb = max_kvb;
      a.causal = causal, a.scale_log2 = sl;
      const int err = v == nullptr ? launch576<false>(st, a, nqb, tp_kv) : launch576<true>(st, a, nqb, tp_kv);
      if (err != 0) return err;
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
