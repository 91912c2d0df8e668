// K10: decode-bucket W4A16 GEMM with streamed weights,
// out[M,N] = prologue(A)[M,K] @ dequant(W)[K,N] (+bias) (+residual), M <= 32.
//
// Replaces w4a16_gemm_dma (sgl_kernel_tpu/ops/gemm/w4a16_dma.py:170, Pallas
// kernel _kernel, pallas_call at :266). Contract and rounding points are
// K1's (w4a16_gemm.cu): W uint8 [K/2, N] (or a stacked [L, K/2, N] bank and a
// layer) with rows 2r / 2r+1 in the low / high nibble, two's-complement int4
// or e2m1 (mxfp4); scales bf16 [K/G, N]; zeros the z*s pre-product; the
// silu_mul prologue rounded to bf16 before the product; each scale group's
// partial product in f32, scaled per column; bias and residual added in f32
// before the one cast. No norm prologue and no fused gate/up (the JAX kernel
// has neither).
//
// Bound: bytes. At M=16 a decode GEMM reads 0.5 byte of codes per weight and
// does 32 flops on it: 8-270 MB of codes per call at Llama-3-8B widths, far
// below the card's ridge. The TPU kernel exists because its BlockSpec
// pipeline fell behind a weight stream issued by hand (w4a16_dma.py:1-16).
//
// Design: the W4A16 streaming core (w4a16_stream.cuh) with one row block of
// M rows and one expert: the silu_mul prologue runs once in the rows pass,
// which the GEMM overlaps by programmatic dependent launch; the GEMM's units
// are (column tile, k block), an equal share a block over a grid sized from
// the SM count; one map per bank, encoded once (the bank [L][K/2][N] is the
// core's [L][1][K/2][N], the layer a coordinate). Weights TMA cannot map
// (N % 16 != 0, unaligned) take the tile kernel of w4a16_gemm.cu.

#include "w4a16_stream.cuh"

// One call. a, a2 (null without the silu_mul prologue), scales, zeros (or
// null) and residual bf16; bias f32; out bf16 or f32 (out_f32); w [layers,
// K/2, N] uint8 (layers 1 for one weight), scales / zeros [layers, K/G, N],
// all 16-byte aligned with N % 16 == 0; group 32, 64 or 128. act: an [M, K]
// bf16 and asum a [K/G][32] float32 workspace; partial blocks x 2 x MP x 256
// floats (MP = 16 for M <= 16, else 32); counters one int a 256-column tile,
// zero before the first call (every call leaves them zero). vec_a: a's and
// a2's rows allow 16-byte loads. Returns cudaGetLastError() after the two
// launches.
extern "C" int skt_w4a16_gemm_dma(const void* a, const void* a2, const void* w, const void* scales,
                                  const void* zeros, const void* bias, const void* residual, void* out, void* act,
                                  void* asum, void* partial, void* counters, int M, int N, int K, int lda, int lda2,
                                  int layers, int layer, int group, int blocks, int mxfp4, int out_f32, int vec_a,
                                  void* stream) {
  if (M < 1 || M > 32) return (int)cudaErrorInvalidValue;
  return w4s::run((const skt::bf16*)a, (const skt::bf16*)a2, lda, lda2, M, K, K, N, w, scales, zeros, layers, 1,
                  layer, nullptr, nullptr, M, 1, (const float*)bias, (const skt::bf16*)residual, out, out_f32, act,
                  asum, 32, partial, counters, blocks, group, mxfp4, vec_a, (cudaStream_t)stream);
}
