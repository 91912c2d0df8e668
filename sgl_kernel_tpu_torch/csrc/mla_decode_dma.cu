// K13b: MLA paged decode on the streaming engine, mla_decode(engine="dma"):
// K13a's function (H query heads against one shared 576-wide latent row per
// cached token, read once as K and as its first 512 as V).
//
// Replaces _mla_decode_dma (sgl_kernel_tpu/ops/attention/mla.py:287, Pallas
// kernel _dma_kernel, pallas_call at :321), which JAX takes for pools of 2
// bytes or more and for 640-wide pools (mla.py:451). Contract: q [B, H, 576]
// bf16; pool [L, P, page, W] (W 576, or 640 with 64 unread pad lanes) of
// bf16, int8, fp8 e4m3 or fp8 e5m2, layer `layer`; page table [B, n_blocks];
// lengths [B]. out [B, H, 512] bf16; lse [B, H] float32 base 2 when its
// pointer is not null. A sequence of length 0 gives o = 0 and lse -inf (the
// TPU engine's convention, mla.py:275; K13a gives -1e30 * log2(e)). One-byte
// values convert to bf16 exactly.
//
// Bound: bytes, as K13a: each cached row read once, ~35 flops a byte.
//
// Design: the TPU kernel folds several sequences into one grid step and
// streams their pages through a double-buffered VMEM window with manual DMAs.
// Here one block of eight warps takes one (sequence, group of 16 heads), with
// no split, and streams its 64-key tiles through a two-stage cp.async ring in
// shared memory: tile i + 1 is in flight while tile i runs the 576-wide MMA
// tile of mla_tile.cuh (online softmax in float32, P as two bf16 terms). A
// bf16 tile lands in the ring as the tile's rows; a one-byte tile lands raw
// and is converted to bf16 rows before its tile runs. ~173 KB of shared
// memory: one block per SM.

#include "mla_tile.cuh"

namespace {

using skt::bf16;
using skt::to_bf16x16;

constexpr int kRawRow = skt::kMlaD;  // bytes of a one-byte row's 576 read lanes

template <typename T>
constexpr size_t ring_bytes() {
  // bf16: a second tile of rows beside MlaSmem's own; one byte: two raw tiles
  return sizeof(T) == 2 ? (size_t)skt::kMlaBN * skt::kMlaRow * 2 : 2 * (size_t)skt::kMlaBN * kRawRow;
}

template <typename T>
__global__ void __launch_bounds__(skt::kMlaThreads) mla_decode_dma_kernel(
    const bf16* __restrict__ q, const T* __restrict__ pool, const int* __restrict__ lengths,
    const int* __restrict__ table, bf16* __restrict__ out, float* __restrict__ lse, int n_heads, int n_pages,
    int page, int width, int n_blocks, int layer, float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  skt::MlaSmem<false> sm(smem_raw);
  unsigned char* ring = smem_raw + skt::MlaSmem<false>::kBytes;
  bf16* const stage_rows[2] = {sm.k, reinterpret_cast<bf16*>(ring)};  // bf16 pools
  const int b = blockIdx.y, h0 = blockIdx.x * skt::kMlaRows;
  const int tid = threadIdx.x;
  const int n_rows = min(skt::kMlaRows, n_heads - h0);
  const int len = min(max(lengths[b], 0), n_blocks * page);

  for (int c = tid; c < skt::kMlaRows * (skt::kMlaD / 8); c += skt::kMlaThreads) {
    const int r = c / (skt::kMlaD / 8), d0 = (c % (skt::kMlaD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows) v = *reinterpret_cast<const uint4*>(q + ((long long)b * n_heads + h0 + r) * skt::kMlaD + d0);
    *reinterpret_cast<uint4*>(sm.q + r * skt::kMlaRow + d0) = v;
  }

  const int* pt = table + (long long)b * n_blocks;
  const long long layer_rows = (long long)layer * n_pages * page;
  // start the copies of tile `tile` into ring stage `s`: rows past the length are zero-filled
  auto fetch = [&](int tile, int s) {
    const int j0 = tile * skt::kMlaBN;
    constexpr int CH = skt::kMlaD * (int)sizeof(T) / 16;  // 16-byte pieces of a row's 576 lanes
    for (int c = tid; c < skt::kMlaBN * CH; c += skt::kMlaThreads) {
      const int r = c / CH, ch = c % CH, key = j0 + r;
      const bool ok = key < len;
      const long long row = ok ? layer_rows + (long long)pt[key / page] * page + key % page : 0;
      const unsigned char* src = reinterpret_cast<const unsigned char*>(pool) + (row * width) * sizeof(T) + ch * 16;
      void* dst = sizeof(T) == 2 ? (void*)(stage_rows[s] + r * skt::kMlaRow + ch * 8)
                                 : (void*)(ring + (size_t)s * skt::kMlaBN * kRawRow + r * kRawRow + ch * 16);
      skt::cp_async16(dst, src, ok);
    }
    skt::cp_async_commit();
  };

  skt::MlaState<512> st;
  st.init();
  const int n_tiles = (len + skt::kMlaBN - 1) / skt::kMlaBN;
  if (n_tiles > 0) fetch(0, 0);
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      fetch(i + 1, (i + 1) & 1);  // its stage was last read by tile i - 1, which ended with a barrier
      skt::cp_async_wait<1>();
    } else {
      skt::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (sizeof(T) == 2) {
      sm.k = sm.v = stage_rows[i & 1];
    } else {
      const unsigned char* raw = ring + (size_t)(i & 1) * skt::kMlaBN * kRawRow;
      for (int c = tid; c < skt::kMlaBN * (kRawRow / 16); c += skt::kMlaThreads) {
        const int r = c / (kRawRow / 16), ch = c % (kRawRow / 16);
        alignas(16) bf16 vals[16];
        const uint4 piece = *reinterpret_cast<const uint4*>(raw + r * kRawRow + ch * 16);
        to_bf16x16(reinterpret_cast<const T*>(&piece), vals);
        uint4* dst = reinterpret_cast<uint4*>(sm.k + r * skt::kMlaRow + ch * 16);
        dst[0] = reinterpret_cast<const uint4*>(vals)[0];
        dst[1] = reinterpret_cast<const uint4*>(vals)[1];
      }
      __syncthreads();
    }
    const int j0 = i * skt::kMlaBN;
    skt::mla_tile<512, false>(st, sm, scale_log2, [&](int, int key) { return j0 + key < len; });
  }
  skt::mla_store<512>(
      st, n_rows, [&](int row) { return out + ((long long)b * n_heads + h0 + row) * 512; },
      [&](int row) { return lse == nullptr ? nullptr : lse + (long long)b * n_heads + h0 + row; },
      __int_as_float(0xff800000));  // -inf
}

struct Args {
  const void *q, *pool, *lengths, *table;
  void *out, *lse;
  int batch, n_heads, n_pages, page, width, n_blocks, layer;
  float scale_log2;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch(const Args& a) {
  constexpr size_t bytes = skt::MlaSmem<false>::kBytes + ring_bytes<T>();
  cudaError_t err =
      cudaFuncSetAttribute(mla_decode_dma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((a.n_heads + skt::kMlaRows - 1) / skt::kMlaRows, a.batch);
  mla_decode_dma_kernel<T><<<grid, skt::kMlaThreads, bytes, a.stream>>>(
      (const bf16*)a.q, (const T*)a.pool, (const int*)a.lengths, (const int*)a.table, (bf16*)a.out, (float*)a.lse,
      a.n_heads, a.n_pages, a.page, a.width, a.n_blocks, a.layer, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace

// pool_type 0 bf16, 1 int8, 2 fp8 e4m3, 3 fp8 e5m2; width 576 or 640; lse
// may be null.
extern "C" int skt_mla_decode_dma(const void* q, const void* pool, const void* lengths, const void* table, void* out,
                                  void* lse, int batch, int n_heads, int n_pages, int page, int width, int n_blocks,
                                  int layer, int pool_type, float sm_scale, void* stream) {
  if (width != 576 && width != 640) return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const Args a{q, pool, lengths, table, out, lse, batch, n_heads, n_pages, page, width, n_blocks, layer,
               sm_scale * skt::kLog2e, (cudaStream_t)stream};
  switch (pool_type) {
    case 0: return (int)launch<bf16>(a);
    case 1: return (int)launch<int8_t>(a);
    case 2: return (int)launch<__nv_fp8_e4m3>(a);
    case 3: return (int)launch<__nv_fp8_e5m2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
