// K15: the NSA indexer's scores over a paged key cache,
//   logits[b, t] = sum_h w[b, h] * relu(q[b, h] . k[t]) * s[t],  -inf at t >= len[b].
//
// Replaces fp8_paged_mqa_logits (sgl_kernel_tpu/ops/attention/nsa.py:141,
// Pallas kernel _mqa_logits_kernel, pallas_call at :222). Contract: q
// [B, H, 128] bf16; keys [P, page, 128] of fp8 e4m3, fp8 e5m2 or bf16;
// weights [B, H] float32; scales [P, page] float32 or null; lengths [B];
// page table [B, n_blocks]; out [B, n_blocks * page] float32. fp8 keys
// convert to bf16 exactly (denormals included), not through the TPU's
// flush-to-zero upcast (paged_decode_dma.py:41-70).
//
// Bound: bytes. Each cached key is read once (128 B in fp8, plus its 4-byte
// scale) for 2 x H x 128 multiply-adds: at H = 64, ~125 flops a byte, below
// the card's ridge (~295 for bf16).
//
// Design: the TPU kernel is one grid step that folds every (sequence, chunk)
// into one double-buffered DMA loop, because a TPU core walks its grid in
// order. Here the grid is the parallelism: one block of eight warps per
// (sequence, span of span_tiles x 64 keys). A block whose span starts at or
// past the sequence's length only writes -inf; the others stage the
// sequence's q [H, 128] (rows past H zero) and its head weights in shared
// memory once, then walk their 64-key tiles: the tile's rows are read
// through the page table in 16-byte pieces, fp8 decoded to bf16 in registers
// (bf16 rows by cp.async), into shared memory; warp w computes the [H x 8]
// scores of keys 8w..8w+7 on mma.sync m16n8k16 with float32 accumulators,
// takes relu, weighs each head, sums the heads (in registers, then across
// the eight lanes that share a key), multiplies by the key's scale and
// stores one float per key.

#include "common.cuh"

namespace {

using skt::bf16;
using skt::cp_async16;
using skt::ld32;
using skt::mma_bf16;
using skt::to_bf16x16;

constexpr int kD = 128;           // indexer head dim
constexpr int kRow = kD + 8;      // shared-memory row stride (bf16): rows 4 banks apart
constexpr int kBN = 64;           // keys of a tile
constexpr int kThreads = 256;     // eight warps, one n8 slice of the tile each

// MT m16 tiles of heads (H <= 16 * MT); keys of type T
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads) mqa_logits_kernel(
    const bf16* __restrict__ q, const T* __restrict__ keys, const float* __restrict__ weights,
    const float* __restrict__ scales, const int* __restrict__ lengths, const int* __restrict__ table,
    float* __restrict__ out, int n_heads, int page, int n_blocks, int span_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [16 MT][kRow]
  bf16* sk = sq + 16 * MT * kRow;                  // [kBN][kRow]
  float* sw = reinterpret_cast<float*>(sk + kBN * kRow);  // [16 MT]
  const int b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int cap = n_blocks * page;
  const int len = min(max(lengths[b], 0), cap);
  const int j_begin = blockIdx.x * span_tiles * kBN;
  const int j_end = min(cap, j_begin + span_tiles * kBN);
  float* orow = out + (long long)b * cap;
  for (int j = max(j_begin, len) + tid; j < j_end; j += kThreads) orow[j] = __int_as_float(0xff800000);  // -inf
  if (j_begin >= len) return;

  for (int c = tid; c < 16 * MT * (kD / 8); c += kThreads) {
    const int r = c / (kD / 8), d0 = (c % (kD / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_heads) v = *reinterpret_cast<const uint4*>(q + ((long long)b * n_heads + r) * kD + d0);
    *reinterpret_cast<uint4*>(sq + r * kRow + d0) = v;
  }
  for (int r = tid; r < 16 * MT; r += kThreads) sw[r] = r < n_heads ? weights[(long long)b * n_heads + r] : 0.f;

  const int* pt = table + (long long)b * n_blocks;
  const int n = min(len, j_end);
  for (int j0 = j_begin; j0 < n; j0 += kBN) {
    if constexpr (sizeof(T) == 2) {
      constexpr int CH = kD / 8;  // 16-byte pieces of a bf16 row
      for (int c = tid; c < kBN * CH; c += kThreads) {
        const int r = c / CH, ch = c % CH, key = j0 + r;
        const bool ok = key < n;
        const long long row = ok ? (long long)pt[key / page] * page + key % page : 0;
        cp_async16(sk + r * kRow + ch * 8, reinterpret_cast<const bf16*>(keys) + row * kD + ch * 8, ok);
      }
      skt::cp_async_commit();
      skt::cp_async_wait<0>();
    } else {
      constexpr int CH = kD / 16;  // 16-byte pieces of a one-byte row
      for (int c = tid; c < kBN * CH; c += kThreads) {
        const int r = c / CH, ch = c % CH, key = j0 + r;
        alignas(16) bf16 vals[16];
        if (key < n) {
          const long long row = (long long)pt[key / page] * page + key % page;
          const uint4 raw = *reinterpret_cast<const uint4*>(keys + row * kD + ch * 16);
          to_bf16x16(reinterpret_cast<const T*>(&raw), vals);
        } else {
#pragma unroll
          for (int i = 0; i < 16; ++i) vals[i] = __float2bfloat16(0.f);
        }
        uint4* dst = reinterpret_cast<uint4*>(sk + r * kRow + ch * 16);
        dst[0] = reinterpret_cast<const uint4*>(vals)[0];
        dst[1] = reinterpret_cast<const uint4*>(vals)[1];
      }
    }
    __syncthreads();

    // scores of heads [16 mt, 16 mt + 16) against keys 8 warp .. 8 warp + 7
    float c[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) c[m][0] = c[m][1] = c[m][2] = c[m][3] = 0.f;
    const bf16* kb = sk + (warp * 8 + g) * kRow + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      const uint32_t b0 = ld32(kb + kk * 16), b1 = ld32(kb + kk * 16 + 8);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const bf16* qa = sq + (16 * m + g) * kRow + 2 * t + kk * 16;
        const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * kRow), ld32(qa + 8), ld32(qa + 8 * kRow + 8)};
        mma_bf16(c[m], a, b0, b1);
      }
    }
    // c[m][0], c[m][1]: head 16m + g, keys 2t, 2t + 1 of the slice; c[m][2], c[m][3]: head 16m + g + 8
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float w0 = sw[16 * m + g], w1 = sw[16 * m + g + 8];
      s0 += w0 * fmaxf(c[m][0], 0.f) + w1 * fmaxf(c[m][2], 0.f);
      s1 += w0 * fmaxf(c[m][1], 0.f) + w1 * fmaxf(c[m][3], 0.f);
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {  // the eight lanes (g) that share the two keys
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    if (g == 0) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = j0 + warp * 8 + 2 * t + e;
        if (key < n) {
          float v = e ? s1 : s0;
          if (scales != nullptr) v *= scales[(long long)pt[key / page] * page + key % page];
          orow[key] = v;
        }
      }
    }
    __syncthreads();  // the tile's rows are read: the next tile may overwrite them
  }
}

struct Args {
  const void *q, *keys, *weights, *scales, *lengths, *table;
  void* out;
  int batch, n_heads, n_pages, page, n_blocks, span_tiles;
  cudaStream_t stream;
};

template <typename T, int MT>
cudaError_t launch(const Args& a) {
  const size_t bytes = (size_t)(16 * MT + kBN) * kRow * 2 + 16 * MT * 4;
  cudaError_t err = cudaFuncSetAttribute(mqa_logits_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const int span = a.span_tiles * kBN;
  dim3 grid((a.n_blocks * a.page + span - 1) / span, a.batch);
  mqa_logits_kernel<T, MT><<<grid, kThreads, bytes, a.stream>>>(
      (const bf16*)a.q, (const T*)a.keys, (const float*)a.weights, (const float*)a.scales, (const int*)a.lengths,
      (const int*)a.table, (float*)a.out, a.n_heads, a.page, a.n_blocks, a.span_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_heads(const Args& a) {
  if (a.n_heads <= 16) return launch<T, 1>(a);
  if (a.n_heads <= 32) return launch<T, 2>(a);
  if (a.n_heads <= 64) return launch<T, 4>(a);
  return launch<T, 8>(a);
}

}  // namespace

// key_type 0 bf16, 2 fp8 e4m3, 3 fp8 e5m2; n_heads 1..128; scales may be
// null; span_tiles >= 1 (64-key tiles a block walks).
extern "C" int skt_fp8_paged_mqa_logits(const void* q, const void* keys, const void* weights, const void* scales,
                                        const void* lengths, const void* table, void* out, int batch, int n_heads,
                                        int n_pages, int page, int n_blocks, int key_type, int span_tiles,
                                        void* stream) {
  if (n_heads < 1 || n_heads > 128 || span_tiles < 1 || page < 1) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_blocks == 0) return (int)cudaSuccess;
  const Args a{q, keys, weights, scales, lengths, table, out, batch, n_heads, n_pages, page, n_blocks, span_tiles,
               (cudaStream_t)stream};
  switch (key_type) {
    case 0: return (int)dispatch_heads<bf16>(a);
    case 2: return (int)dispatch_heads<__nv_fp8_e4m3>(a);
    case 3: return (int)dispatch_heads<__nv_fp8_e5m2>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}
