// K11 at decode: grouped W4A16 GEMM over expert-sorted row blocks of 16 or
// 32 rows (MoE decode), on the W4A16 streaming core (w4a16_stream.cuh).
//
// Replaces w4a16_grouped_mm (sgl_kernel_tpu/ops/moe/grouped_gemm.py:259,
// pallas_call at :419) for bm 16 / 32; bm 64 / 128 (prefill) and the
// per-channel form keep grouped_gemm.cu's tile. Contract unchanged: x [cap,
// K] bf16, rows sorted by expert, row block i (bm rows) of expert
// block_expert_ids[i]; w [E, K/2, N] or a stacked [L, E, K/2, N] bank in K1's
// K-paired layout; scales and zeros (z*s) [.., E, K/G, N]; int4 or e2m1; out
// bf16 or float32. Rows of blocks at or past *num_valid are neither read nor
// written (undefined by contract).
//
// Bound: bytes. At Mixtral-8x7B's B=16 decode one call streams the 8 routed
// experts' codes (gate_up 470 MB, down 235 MB) against 16 rows an expert.
//
// Design: the core's units are (valid row block, column tile, k block),
// counted on the device from *num_valid; the grid is sized from the SM count,
// so Mixtral's down (8 row blocks x 16 tiles x 56 k blocks) spreads over
// every SM rather than one long block a tile. The rows pass writes the valid
// blocks' rows once in the core's k order with their group sums; one map per
// bank, 4-D, with layer and expert as coordinates: no step encodes a map.

#include "w4a16_stream.cuh"

// One call. x [cap, lda] bf16 (k_valid <= K real columns); w [layers,
// experts, K/2, N] uint8, scales / zeros (or null) [layers, experts, K/G, N]
// bf16, 16-byte aligned, N % 16 == 0; expert_ids [cap / bm] and num_valid
// (one int) int32 on the device; out [cap, N] bf16 or f32 (out_f32). act: a
// [cap, K] bf16 and asum a [K/G][cap] float32 workspace; partial blocks x 2 x
// bm x 256 floats; counters (cap / bm) x (N / 256) ints, zero before the
// first call (every call leaves them zero). Returns cudaGetLastError() after
// the two launches.
extern "C" int skt_w4a16_grouped_decode(const void* x, const void* w, const void* scales, const void* zeros,
                                        const void* expert_ids, const void* num_valid, void* out, void* act,
                                        void* asum, void* partial, void* counters, int cap, int N, int K,
                                        int k_valid, int lda, int layers, int experts, int layer, int group, int bm,
                                        int blocks, int mxfp4, int out_f32, int vec_a, void* stream) {
  if ((bm != 16 && bm != 32) || cap % bm) return (int)cudaErrorInvalidValue;
  return w4s::run((const skt::bf16*)x, nullptr, lda, 0, cap, k_valid, K, N, w, scales, zeros, layers, experts, layer,
                  (const int*)expert_ids, (const int*)num_valid, bm, cap / bm, nullptr, nullptr, out, out_f32, act,
                  asum, cap, partial, counters, blocks, group, mxfp4, vec_a, (cudaStream_t)stream);
}
