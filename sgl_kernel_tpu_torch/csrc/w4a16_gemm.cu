// K1: W4A16 GEMM, out[M,N] = prologue(A)[M,K] @ dequant(W)[K,N] (+bias) (+residual).
//
// Replaces w4a16_gemm (sgl_kernel_tpu/ops/gemm/w4a16.py:301, Pallas kernels
// _kernel / _kernel_inner, pallas_call at :539 and :551). Contract: W is
// uint8 [K/2, N], byte (r, n) holding the 4-bit codes of rows 2r (low
// nibble) and 2r+1 (high nibble), two's-complement int4 or an e2m1 bit
// pattern (mxfp4); scales bf16 [K/G, N]; zeros the z*s pre-product
// [K/G, N]. Rounding points mirror the TPU kernel: the prologue's result
// (rmsnorm with norm_weight, or silu(a)*a2) is rounded to bf16 before the
// product (w4a16.py:184, :187); each scale group's partial product is taken
// in f32 and then scaled per output column (:226-236); zeros subtract
// sum_k(a_g) * (z*s); bias and residual are added in f32 before the one
// cast to the output type (:239-246).
//
// Bound. Decode (M <= 32) streams the weights: 16 rows of activations
// against 8-272 MB of packed codes per call, about 1 flop per weight byte at
// M=16, so bytes bound it. Prefill (M = batch x prompt, up to 1024+) is
// bound by operations: a 1024-row gate_up is 240 GFLOP.
//
// Design. One path for both regimes, on mma.sync m16n8k16 bf16 tensor-core
// tiles with f32 accumulators; what differs is the tile: 16 or 32 rows x
// 128 columns for decode, 64 x 64 for prefill, four warps a block. Per
// scale group the block copies the group's [G/2, BN] packed bytes and its
// scale and zero rows into a three- or four-stage shared-memory ring with 16-byte
// cp.async loads along N (the contiguous axis); the group's [BM, G]
// activation slice travels one group ahead in registers and lands in
// shared memory after its prologue. A thread's mma B fragment comes from
// two 32-bit shared-memory words (its bytes of four n8 tiles in two packed
// rows) and is decoded in registers into exact bf16 integers (int4: a byte
// permute, two masks and two bf16x2 subtractions per four codes) or e2m1
// values (mxfp4); k and n are taken in the orders that make this possible
// (see w4a16_kernel). The group's partial product is scaled once per column
// into the accumulator, the TPU's output-side group scaling. Decode shapes give too
// few column tiles to fill 132 SMs (o and down: 32), so K is split across
// blocks by whole groups; the f32 partials land in a workspace and a second
// pass sums them in a fixed order and applies bias, residual and the cast.
// The norm prologue needs the mean square of the whole K row, which no block
// sees: a first small pass writes rsqrt(mean(x^2) + eps) per row. At the
// prefill tile, where every column block would repeat the prologue over its
// rows, that pass writes the prologue's bf16 rows instead. wgmma, TMA and
// warp specialisation are not used yet.

#include "w4a16_tile.cuh"

// One call: the prologue pass (the norm's row factors; with the prefill
// tile also the prologue's rows, into act_ws [M, k_valid]), the main kernel,
// and the split-K reduction (split > 1). Group size 32, 64 or 128; a, a2,
// norm_w, residual, scales and zeros bf16; bias f32; out bf16 or f32
// (out_f32). vec_a / vec_w say that the activation rows / the weight,
// scale and zero rows allow 16-byte loads.
extern "C" int skt_w4a16_gemm(
    const void* a, const void* a2, const void* norm_w, void* rms, void* act_ws, const void* w,
    const void* scales, const void* zeros, const void* bias, const void* residual, void* out,
    void* partial, int M, int N, int K, int k_valid, int lda, int lda2, int group, int tile,
    int split, int groups_per_split, int prologue, int mxfp4, int out_f32, int vec_a,
    int vec_w, float eps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const bool rows_pass = prologue != kPrologueNone && tile == 2;
  if (K % group || split < 1 || (prologue == kPrologueNorm && !rms) || (rows_pass && !act_ws))
    return (int)cudaErrorInvalidValue;
  Params p{};  // zero: no expert_ids (the dense form)
  p.a = (const bf16*)a;
  p.a2 = (const bf16*)a2;
  p.norm_w = (const bf16*)norm_w;
  p.rms = (const float*)rms;
  p.w = (const uint8_t*)w;
  p.scales = (const bf16*)scales;
  p.zeros = (const bf16*)zeros;
  p.bias = (const float*)bias;
  p.residual = (const bf16*)residual;
  p.out = out;
  p.partial = (float*)partial;
  p.M = M, p.N = N, p.k_valid = k_valid, p.lda = lda, p.lda2 = lda2;
  p.n_groups = K / group, p.groups_per_split = groups_per_split;
  p.prologue = prologue, p.mxfp4 = mxfp4, p.out_f32 = out_f32, p.split = split;
  p.vec_a = vec_a, p.vec_w = vec_w, p.norm_eps = eps;
  cudaError_t err;
  if (prologue == kPrologueNorm || rows_pass) {
    row_prologue_kernel<<<M, kThreads, 0, st>>>(p, (float*)rms, rows_pass ? (bf16*)act_ws : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  if (rows_pass) {  // the main kernel reads the finished rows
    p.a = (const bf16*)act_ws;
    p.lda = k_valid;
    p.vec_a = k_valid % 8 == 0;
    p.prologue = kPrologueNone;
  }
  switch (group) {
    case 32: err = dispatch_tile<32>(tile, p, st); break;
    case 64: err = dispatch_tile<64>(tile, p, st); break;
    case 128: err = dispatch_tile<128>(tile, p, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || split == 1) return (int)err;
  const long long total = (long long)M * N;
  split_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}
