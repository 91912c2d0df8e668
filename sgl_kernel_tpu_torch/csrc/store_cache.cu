// K6: store one decode step's K/V for every layer into the paged pools.
//
// Replaces store_cache_all_layers (sgl_kernel_tpu/ops/kvcache.py:193,
// Pallas kernel _store_all_layers_kernel, pallas_call at :209). The TPU
// kernel DMAs an aligned 8-row page window in and out per token, because
// Mosaic cannot address one row of a tiled page; a GPU stores one row
// directly, so the window and its page % 8 condition are gone.
//
// Bound: bytes. The work is a copy of L*T*H rows of D elements (2 x 2 MB at
// Llama-3-8B, B=16); the pools are only written where a slot is valid.
// Design: one block per (layer, head, K-or-V). The block walks the tokens
// in order and each thread always copies the same 16-byte lanes of a row,
// so two tokens that share a slot land in token order (a later token
// overwrites an earlier one, as kvcache.py:146-156 requires) without a
// barrier. loc < 0 and loc >= P*page are dropped (kvcache.py:131-135).

#include "common.cuh"

namespace {

__global__ void store_all_layers_kernel(
    const uint8_t* __restrict__ k_all, const uint8_t* __restrict__ v_all,
    uint8_t* __restrict__ k_pool, uint8_t* __restrict__ v_pool,
    const int* __restrict__ loc, int n_tokens, int n_heads, int n_pages,
    int page, int row_bytes) {
  const int layer = blockIdx.x;
  const int h = blockIdx.y;
  const uint8_t* src = blockIdx.z ? v_all : k_all;
  uint8_t* dst = blockIdx.z ? v_pool : k_pool;
  const long long limit = (long long)n_pages * page;
  const int vecs = row_bytes / 16;
  for (int t = 0; t < n_tokens; ++t) {
    const int slot = loc[t];
    if (slot < 0 || slot >= limit) continue;
    const long long pid = slot / page, off = slot % page;
    const uint8_t* s = src + (((long long)layer * n_tokens + t) * n_heads + h) * row_bytes;
    uint8_t* d = dst + ((((long long)layer * n_pages + pid) * n_heads + h) * page + off) * row_bytes;
    for (int i = threadIdx.x; i < vecs; i += blockDim.x)
      reinterpret_cast<uint4*>(d)[i] = reinterpret_cast<const uint4*>(s)[i];
  }
}

}  // namespace

// row_bytes (head_dim x element size) must be a multiple of 16.
extern "C" int skt_store_cache_all_layers(
    const void* k_all, const void* v_all, void* k_pool, void* v_pool,
    const void* loc, int n_layers, int n_tokens, int n_heads, int n_pages,
    int page, int row_bytes, void* stream) {
  if (row_bytes % 16) return (int)cudaErrorInvalidValue;
  dim3 grid(n_layers, n_heads, 2);
  store_all_layers_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)k_all, (const uint8_t*)v_all, (uint8_t*)k_pool,
      (uint8_t*)v_pool, (const int*)loc, n_tokens, n_heads, n_pages, page,
      row_bytes);
  return (int)cudaGetLastError();
}
