// K6: store one decode step's K/V for every layer into the paged pools.
//
// Replaces store_cache_all_layers (sgl_kernel_tpu/ops/kvcache.py:193,
// Pallas kernel _store_all_layers_kernel, pallas_call at :209). The TPU
// kernel DMAs an aligned 8-row page window in and out per token, because
// Mosaic cannot address one row of a tiled page; a GPU stores one row
// directly, so the window and its page % 8 condition are gone.
//
// Bound: bytes. The work is a copy of 2*L*T*H rows of D elements, each read
// once and written once where its slot is valid: 2 x 2 MB at Llama-3-8B's
// decode step (T = 16), 2 x 136 MB at a mixed step (T = 1,040).
//
// Design: a parallel row copy. A block takes a tile of kTokTile tokens of
// one layer's K or V (grid: token tiles x (layer, K|V)); each thread copies
// 16-byte lanes of the tile's rows, kUnroll loads in flight before their
// stores. No block walks the tokens in order: a token's rows are written
// only if no later token holds the same in-range slot, so the last writer
// wins (kvcache.py:146-156) without ordering the stores. That flag is set
// once per token, in a short prologue: the tile's slots in shared memory,
// each thread comparing the later tokens' slots it reads (coalesced, from
// L2) against them, T / 256 loads and kTokTile compares a thread. loc < 0
// and loc >= P*page are dropped (kvcache.py:131-135).

#include "common.cuh"

namespace {

constexpr int kTokTile = 8;    // tokens a block: 128 blocks at 32 layers and T = 16, 8,320 at T = 1,040
constexpr int kThreads = 256;
constexpr int kUnroll = 8;     // 16-byte loads a thread keeps in flight

__global__ void __launch_bounds__(kThreads) store_all_layers_kernel(
    const uint4* __restrict__ k_all, const uint4* __restrict__ v_all,
    uint4* __restrict__ k_pool, uint4* __restrict__ v_pool,
    const int* __restrict__ loc, int n_tokens, int n_heads, int n_pages,
    int page, int vecs) {
  __shared__ int slot[kTokTile];  // the tile's slots; -1 where dropped or a later token wins
  const int t0 = blockIdx.x * kTokTile, nt = min(kTokTile, n_tokens - t0);
  const int layer = blockIdx.y >> 1;
  const long long limit = (long long)n_pages * page;
  if (threadIdx.x < kTokTile) {
    const int s = threadIdx.x < nt ? loc[t0 + threadIdx.x] : -1;
    slot[threadIdx.x] = (s < 0 || s >= limit) ? -1 : s;
  }
  __syncthreads();
  // token u drops every earlier token of the tile with its slot (every
  // thread that finds one writes the same -1, so the race is benign)
  for (int u = t0 + 1 + threadIdx.x; u < n_tokens; u += kThreads) {
    const int s = loc[u];
    for (int i = 0; i < nt && t0 + i < u; ++i)
      if (slot[i] == s) slot[i] = -1;
  }
  __syncthreads();

  const uint4* src = (blockIdx.y & 1 ? v_all : k_all) + ((long long)layer * n_tokens + t0) * n_heads * vecs;
  uint4* dst = blockIdx.y & 1 ? v_pool : k_pool;
  const int per_tok = n_heads * vecs, total = nt * per_tok;
  for (int e0 = 0; e0 < total; e0 += kThreads * kUnroll) {
    uint4 v[kUnroll];
    long long d[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int e = e0 + j * kThreads + threadIdx.x;
      d[j] = -1;
      if (e >= total) continue;
      const int s = slot[e / per_tok];
      if (s < 0) continue;
      const int h = (e % per_tok) / vecs, c = e % vecs;
      d[j] = ((((long long)layer * n_pages + s / page) * n_heads + h) * page + s % page) * vecs + c;
      v[j] = src[e];
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      if (d[j] >= 0) dst[d[j]] = v[j];
  }
}

}  // namespace

// row_bytes (head_dim x element size) must be a multiple of 16.
extern "C" int skt_store_cache_all_layers(
    const void* k_all, const void* v_all, void* k_pool, void* v_pool,
    const void* loc, int n_layers, int n_tokens, int n_heads, int n_pages,
    int page, int row_bytes, void* stream) {
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  const int tiles = (n_tokens + kTokTile - 1) / kTokTile;
  dim3 grid(tiles > 0 ? tiles : 1, 2 * n_layers);  // T = 0: one idle tile, still one launch
  store_all_layers_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)k_all, (const uint4*)v_all, (uint4*)k_pool,
      (uint4*)v_pool, (const int*)loc, n_tokens, n_heads, n_pages, page,
      row_bytes / 16);
  return (int)cudaGetLastError();
}
