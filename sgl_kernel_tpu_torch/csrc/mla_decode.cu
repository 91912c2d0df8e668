// K13a: MLA paged decode: H query heads against one shared 576-wide latent
// row per cached token, read once as K (576) and as V (its first 512).
//
// Replaces mla_decode (sgl_kernel_tpu/ops/attention/mla.py:375, Pallas kernel
// _decode_kernel, pallas_call at :474). Contract: q [B, H, 576] =
// [q_nope (latent) 512 | q_pe 64] bf16; pool [L, P, page, W] (W 576, or 640
// with 64 zero lanes) of bf16, int8, fp8 e4m3 or fp8 e5m2, layer `layer`;
// page table [B, n_blocks]; lengths [B] (the tokens of each sequence in the
// pool, the current one included). out [B, H, 512] bf16; lse [B, H] float32
// base 2 when its pointer is not null. A sequence of length 0 gives o = 0
// and lse -1e30 * log2(e) (the K7 convention). Pool values convert to bf16
// exactly (int8 and both fp8 formats fit bf16), not through the TPU's
// flush-to-zero upcast (paged_decode_dma.py:41-70); a latent scale enters
// only folded into sm_scale, by the caller. The pad lanes of a 640-wide pool
// are not read (the TPU kernel multiplies them by zero q lanes).
//
// Bound: bytes. A step reads each sequence's cached rows once: at the
// DeepSeek-V2-Lite decode batch (B=16, contexts up to ~1k) a few MB per layer
// in bf16, half that from 1-byte pools, against 2 x 16 x (576 + 512) flops a
// row: ~35 flops a byte, far below the card's ridge.
//
// Design: one block of 256 threads per (sequence, group of 16 heads, split);
// the 16 heads are the rows of one m16 MMA tile (mla_tile.cuh), so each row
// is read from the pool once for all of them, as the TPU kernel folds the
// heads into its matmul rows. A block walks its share of the sequence's
// pages in 64-row tiles, each row a 1152-byte (bf16) or 576-byte (1-byte
// pool) read in 16-byte pieces, converted to bf16 into shared memory (bf16
// rows by cp.async), and runs the tile. One block per sequence would fill
// only B of the 132 SMs and let the longest context set the time, so when
// the grid is small each sequence's keys split into spans of split_keys
// (the TPU grid walks pages in order on one core and needs no split): a
// split writes its normalized float32 partial and its lse, and a second
// pass merges the splits a sequence's length uses by their lse (the
// merge_states formula) and rounds once to bf16. A split past the length
// returns at once and is never read.

#include <cuda_fp8.h>

#include "mla_tile.cuh"

namespace {

using skt::bf16;
using skt::to_bf16x16;

// split_keys 0: one block per (head group, sequence) writes out / lse;
// else block z takes keys [z * split_keys, (z + 1) * split_keys) and writes
// part_o [B, Z, H, 512] / part_lse [B, Z, H] float32
template <typename T>
__global__ void __launch_bounds__(skt::kMlaThreads) mla_decode_kernel(
    const bf16* __restrict__ q, const T* __restrict__ pool, const int* __restrict__ lengths,
    const int* __restrict__ table, bf16* __restrict__ out, float* __restrict__ lse, float* __restrict__ part_o,
    float* __restrict__ part_lse, int n_heads, int n_pages, int page, int width, int n_blocks, int layer,
    int split_keys, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const skt::MlaSmem<false> sm(smem_raw);
  const int b = blockIdx.y, h0 = blockIdx.x * skt::kMlaRows;
  const int tid = threadIdx.x;
  const int n_rows = min(skt::kMlaRows, n_heads - h0);
  const int len = min(lengths[b], n_blocks * page);
  const int j_begin = split_keys ? blockIdx.z * split_keys : 0;
  if (split_keys && j_begin >= len) return;  // past the length: never merged
  const int n = split_keys ? min(len, j_begin + split_keys) : len;

  // q rows of the 16 heads (rows past H are zero)
  for (int c = tid; c < skt::kMlaRows * (skt::kMlaD / 8); c += skt::kMlaThreads) {
    const int r = c / (skt::kMlaD / 8), d0 = (c % (skt::kMlaD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) v = *reinterpret_cast<const uint4*>(q + ((long long)b * n_heads + h0 + r) * skt::kMlaD + d0);
    *reinterpret_cast<uint4*>(sm.q + r * skt::kMlaRow + d0) = v;
  }

  const int* pt = table + (long long)b * n_blocks;
  const long long layer_rows = (long long)layer * n_pages * page;
  skt::MlaState<512> st;
  st.init();

  for (int j0 = j_begin; j0 < n; j0 += skt::kMlaBN) {
    if constexpr (sizeof(T) == 2) {
      constexpr int CH = skt::kMlaD / 8;  // 16-byte pieces of a bf16 row
      for (int c = tid; c < skt::kMlaBN * CH; c += skt::kMlaThreads) {
        const int r = c / CH, ch = c % CH, key = j0 + r;
        const bool ok = key < n;
        const long long row = ok ? layer_rows + (long long)pt[key / page] * page + key % page : 0;
        skt::cp_async16(sm.k + r * skt::kMlaRow + ch * 8,
                        reinterpret_cast<const bf16*>(pool) + row * width + ch * 8, ok);
      }
      skt::cp_async_commit();
      skt::cp_async_wait<0>();
    } else {
      constexpr int CH = skt::kMlaD / 16;  // 16-byte pieces of a 1-byte row
      for (int c = tid; c < skt::kMlaBN * CH; c += skt::kMlaThreads) {
        const int r = c / CH, ch = c % CH, key = j0 + r;
        alignas(16) bf16 vals[16];
        if (key < n) {
          const long long row = layer_rows + (long long)pt[key / page] * page + key % page;
          const uint4 raw = *reinterpret_cast<const uint4*>(pool + row * width + ch * 16);
          to_bf16x16(reinterpret_cast<const T*>(&raw), vals);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) vals[i] = __float2bfloat16(0.f);
        }
        uint4* dst = reinterpret_cast<uint4*>(sm.k + r * skt::kMlaRow + ch * 16);
        dst[0] = reinterpret_cast<const uint4*>(vals)[0];
        dst[1] = reinterpret_cast<const uint4*>(vals)[1];
      }
    }
    __syncthreads();
    skt::mla_tile<512, false>(st, sm, scale_log2, [&](int, int key) { return j0 + key < n; });
  }

  if (!split_keys) {
    skt::mla_store<512>(
        st, n_rows, [&](int row) { return out + ((long long)b * n_heads + h0 + row) * 512; },
        [&](int row) { return lse == nullptr ? nullptr : lse + (long long)b * n_heads + h0 + row; });
    return;
  }
  const long long base = ((long long)b * gridDim.z + blockIdx.z) * n_heads + h0;
  skt::mla_store<512>(
      st, n_rows, [&](int row) { return part_o + (base + row) * 512; },
      [&](int row) { return part_lse + base + row; });
}

// The second pass of a split decode: for each (head, sequence) the splits
// its length used, weighed by 2^(lse_s - max lse), one bf16 rounding; a
// sequence of length 0 gives o = 0 and lse -1e30 * log2(e).
__global__ void __launch_bounds__(128) mla_merge_kernel(
    const float* __restrict__ part_o, const float* __restrict__ part_lse, const int* __restrict__ lengths,
    bf16* __restrict__ out, float* __restrict__ lse, int n_heads, int n_splits, int split_keys, int cap) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int used = (min(lengths[b], cap) + split_keys - 1) / split_keys;
  const float* pl = part_lse + (long long)b * n_splits * n_heads + h;
  float m = skt::kMaxInit;
  for (int s = 0; s < used; ++s) m = fmaxf(m, pl[(long long)s * n_heads]);
  float wsum = 0.f;
  for (int s = 0; s < used; ++s) wsum += exp2f(pl[(long long)s * n_heads] - m);
  for (int d = threadIdx.x; d < 512; d += blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < used; ++s)
      acc += exp2f(pl[(long long)s * n_heads] - m) *
             part_o[(((long long)b * n_splits + s) * n_heads + h) * 512 + d];
    out[((long long)b * n_heads + h) * 512 + d] = __float2bfloat16(used ? acc / wsum : 0.f);
  }
  if (lse != nullptr && threadIdx.x == 0)
    lse[(long long)b * n_heads + h] = used ? m + log2f(wsum) : -1e30f * skt::kLog2e;
}

struct Args {
  const void *q, *pool, *lengths, *table;
  void *out, *lse, *part_o, *part_lse;
  int batch, n_heads, n_pages, page, width, n_blocks, layer, split_keys;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr size_t bytes = skt::MlaSmem<false>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(mla_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int cap = a.n_blocks * a.page;
  const int n_splits = a.split_keys ? (cap + a.split_keys - 1) / a.split_keys : 1;
  dim3 grid((a.n_heads + skt::kMlaRows - 1) / skt::kMlaRows, a.batch, n_splits);
  mla_decode_kernel<T><<<grid, skt::kMlaThreads, bytes, a.stream>>>(
      (const bf16*)a.q, (const T*)a.pool, (const int*)a.lengths, (const int*)a.table, (bf16*)a.out,
      (float*)a.lse, (float*)a.part_o, (float*)a.part_lse, a.n_heads, a.n_pages, a.page, a.width, a.n_blocks,
      a.layer, a.split_keys, a.scale_log2);
  if ((err = cudaGetLastError()) != cudaSuccess || !a.split_keys) return err;
  mla_merge_kernel<<<dim3(a.n_heads, a.batch), 128, 0, a.stream>>>(
      (const float*)a.part_o, (const float*)a.part_lse, (const int*)a.lengths, (bf16*)a.out, (float*)a.lse,
      a.n_heads, n_splits, a.split_keys, cap);
  return cudaGetLastError();
}

}  // namespace

// pool_type 0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2; width 576 or 640; lse
// may be null. split_keys 0, or a multiple of 64 with part_o
// [B, ceil(n_blocks * page / split_keys), H, 512] and part_lse [B, .., H]
// float32 workspaces.
extern "C" int skt_mla_decode(const void* q, const void* pool, const void* lengths, const void* table, void* out,
                              void* lse, void* part_o, void* part_lse, int batch, int n_heads, int n_pages, int page,
                              int width, int n_blocks, int layer, int pool_type, int split_keys, float sm_scale,
                              void* stream) {
  if ((width != 576 && width != 640) || split_keys % skt::kMlaBN || (split_keys && !(part_o && part_lse)))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{q, pool, lengths, table, out, lse, part_o, part_lse, batch, n_heads, n_pages, page, width, n_blocks,
               layer, split_keys, sm_scale * skt::kLog2e, (cudaStream_t)stream};
  switch (pool_type) {
    case 0: return (int)launch<bf16>(a);
    case 1: return (int)launch<int8_t>(a);
    case 2: return (int)launch<__nv_fp8_e4m3>(a);
    case 3: return (int)launch<__nv_fp8_e5m2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
