// K11: grouped W4A16 GEMM over expert-sorted, block-aligned rows (MoE).
//
// Replaces w4a16_grouped_mm (sgl_kernel_tpu/ops/moe/grouped_gemm.py:259,
// Pallas entry _w4_kernel_entry over the dense kernel's _kernel /
// _kernel_inner bodies, pallas_call at :419). Contract: x [cap, K] bf16, rows
// sorted by expert and aligned so that row block i (block_rows rows) belongs
// to expert block_expert_ids[i]; w [E, K/2, N] uint8 in K1's K-paired nibble
// layout and scales [E, K/G, N] (zeros, the z*s pre-product, likewise), one
// layer of a stacked [L, E, ...] bank picked by the caller's pointer offset,
// never by a copy of the bank. Row blocks at or past num_valid_blocks are
// alignment padding: nothing is fetched or computed for them and their output
// rows are left unwritten (undefined by contract, grouped_gemm.py:279-282).
// out [cap, N] bf16 or float32.
//
// Bound: bytes at decode. At the DeepSeek-V2-Lite decode step (B=16, top-6
// of 64 experts) one call streams the routed experts' packed banks, about
// 51 of 64 experts x 2.9 MB (gate_up, K 2048 -> N 2816) or x 1.4 MB (down,
// K 1408 -> N 2048), against 16 activation rows per expert: a few flops a
// byte. At prefill (bm 128, hundreds of rows an expert) operations bound it.
//
// Design: K1's tile code (w4a16_tile.cuh), unchanged in its inner loop, with
// the expert chosen per row block: each block reads expert_ids[m0 /
// block_rows] and *num_valid itself (the TPU's scalar prefetch becomes two
// loads a block) and offsets its weight, scale and zero pointers by the
// expert. The launch grid covers all cap rows, so the host never reads the
// valid count; blocks past it return at once. The row tile divides the
// alignment block (16 rows for bm 16, 32 for 32, 64 for 64 and 128), so a
// tile never spans two experts. K splits across blocks nowhere: the routed
// row blocks times the column tiles give hundreds of blocks at decode.

#include "w4a16_tile.cuh"

// Group size 32, 64 or 128; x, scales and zeros bf16; out bf16 or f32
// (out_f32). tile: 0 = 16 x 128, 1 = 32 x 128, 2 = 64 x 64 (K1's tiles);
// block_rows a multiple of the tile's rows. w_estride: bytes of one
// expert's codes (K/2 * N); s_estride: elements of one expert's scales.
// Returns cudaGetLastError() after the launch.
extern "C" int skt_w4a16_grouped_mm(
    const void* x, const void* w, const void* scales, const void* zeros, const void* expert_ids,
    const void* num_valid, void* out, int M, int N, int K, int k_valid, int lda, int group, int tile,
    int block_rows, long long w_estride, long long s_estride, int mxfp4, int out_f32, int vec_a,
    int vec_w, void* stream) {
  static const int kTileRows[3] = {16, 32, 64};
  if (K % group || tile < 0 || tile > 2 || block_rows % kTileRows[tile]) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = (const bf16*)x;
  p.w = (const uint8_t*)w;
  p.scales = (const bf16*)scales;
  p.zeros = (const bf16*)zeros;
  p.out = out;
  p.M = M, p.N = N, p.k_valid = k_valid, p.lda = lda;
  p.n_groups = K / group, p.groups_per_split = K / group, p.split = 1;
  p.prologue = kPrologueNone, p.mxfp4 = mxfp4, p.out_f32 = out_f32;
  p.vec_a = vec_a, p.vec_w = vec_w;
  p.expert_ids = (const int*)expert_ids;
  p.num_valid = (const int*)num_valid;
  p.block_rows = block_rows;
  p.w_estride = w_estride, p.s_estride = s_estride;
  cudaStream_t st = (cudaStream_t)stream;
  switch (group) {
    case 32: return (int)dispatch_tile<32>(tile, p, st);
    case 64: return (int)dispatch_tile<64>(tile, p, st);
    case 128: return (int)dispatch_tile<128>(tile, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
