// K1 at decode (M <= 32): W4A16 GEMM, out[M,N] = prologue(A)[M,K] @ dequant(W)[K,N]
// (+bias) (+residual), as two launches that overlap: a rows pass and the GEMM.
//
// Replaces w4a16_gemm (sgl_kernel_tpu/ops/gemm/w4a16.py:301, Pallas kernels
// _kernel / _kernel_inner, pallas_call at :539 and :551) for decode rows;
// w4a16_gemm.cu keeps the prefill tile and weights whose rows TMA cannot
// map. The contract and rounding points are w4a16_gemm.cu's: W uint8
// [K/2, N] with rows 2r (low nibble) and 2r+1 (high) in byte (r, n), int4
// or e2m1 (mxfp4) codes, scales [K/G, N], zeros the z*s pre-product; the
// prologue's result (rmsnorm, or silu(a) * a2) rounded to bf16 before the
// product, each group's partial product in f32 scaled per column, zeros
// subtracting sum_k(a_g) * (z*s), bias and residual added in f32 before the
// one cast. No repacked copy of the weights is kept.
//
// Bound: bytes. At M=16 the call streams 8-262 MB of codes against 64 flop
// a byte; the tensor rate is never the limit, and decoding the codes
// costs about one instruction a weight.
//
// Design. A rows pass (one block a row) applies the prologue once, rounds
// to bf16 and writes the rows in the GEMM's k order (below), with each
// scale group's activation sum, to workspaces; the GEMM is launched behind
// it by programmatic dependent launch, so its producer streams weights
// while the rows pass runs and waits (griddepcontrol.wait) only before it
// loads the rows. The GEMM's work is the (column tile of 128, 256-deep k
// block) stages, tile-major: each of two blocks an SM takes an equal
// share of them (stream-K), so every SM streams the same bytes however the
// tiles divide. A block's producer warp brings each stage by TMA into a
// two- or three-stage mbarrier ring: one [128 rows][128 bytes] box of codes
// (16 KB, 256 k), the stage's activations (128-byte-swizzled [MP][64]
// tiles, L2-resident), scale and zero rows and group sums. Eight consumer
// warps wait on a stage's barrier, never on each other: four column slices
// of 32, each stage's scale groups split between two halves, which add
// their sums at the end of a tile. The product is taken with the operands
// swapped, out^T = W^T a^T: the weights are mma.sync's A operand straight
// from registers, so a decoded code never returns to shared memory, and
// the activation rows are its n8 columns (B, by ldmatrix). One 32-bit load
// of packed rows 2t and 2t+1 (t = 4 k-step + lane % 4) gives a thread its
// byte of four adjacent columns; the low nibbles of the two rows are one A
// register after one byte permute and one and-xor (int4, as 136 + c, exact
// in bf16: the 136 comes off the group's float32 sum as 136 times the
// group's activation sum) or a table-free bit build (e2m1), the high
// nibbles another, so each 16 k are taken even k first, then odd k, the
// order the rows pass writes. A tile one block holds whole is stored at
// once; a shared tile's blocks leave float32 partials in a workspace and
// the last to arrive (a counter it resets) sums them in block order and
// applies bias, residual and the cast: deterministic, bit-identical from
// call to call.

#include "tma_map.cuh"
#include "w4a16_tile.cuh"

namespace {

constexpr int kDecBN = 128;        // columns of a tile, 32 a consumer warp
constexpr int kDecKB = 256;        // k of a stage: 128 packed rows of codes, 16 KB
constexpr int kDecConsumers = 8;   // two halves of four column slices
constexpr int kDecThreads = 32 * (kDecConsumers + 1);  // and a producer warp
constexpr int kDecSumLd = 32;      // floats a group's row of activation sums (rows >= M unread)

struct DParams {
  const bf16 *a, *a2, *norm_w, *residual;  // a [M, lda]; a2 [M, lda2]; norm_w [K]; residual [M, N]
  const float* bias;                       // [N]
  float* asum;                             // [K / G][32]: each group's activation sum a row (rows pass)
  void* out;                               // [M, N] bf16 or f32
  float* partial;                          // [blocks][2][MP][128]: a block's first and last shared tile
  int* counters;                           // [tiles], zero between calls
  int M, N, K, group, k_valid, lda, lda2, n_kb, tiles, prologue, out_f32, zeros, vec_a;
  float eps;
};

struct alignas(64) DArgs {
  CUtensorMap tw, ts, tz;  // codes [K/2][N] (128-byte swizzle), scales and zeros [K/G][N]
  CUtensorMap ta, tsum;    // the rows pass's activations [M][K] (128-byte swizzle) and group sums
  DParams p;
};

// A stage: one tile's codes for 256 k, then the activations of those k
// (4 swizzled [MP][64] sub-tiles), the scale and zero rows and the group
// sums; the ring, then the halves' reduction buffer and the barriers.
template <int G, int MP>
struct DSmem {
  static constexpr int kStages = MP == 16 ? 3 : 2;          // two blocks an SM
  static constexpr int SROWS = kDecKB / G;                   // scale groups of a stage
  static constexpr int CODES = (kDecKB / 2) * kDecBN;        // 16 KB
  static constexpr int ACT = MP * kDecKB * 2;
  static constexpr int SC = SROWS * kDecBN * 2;
  static constexpr int SUM = SROWS * MP * 4;
  static constexpr int STAGE = (CODES + ACT + 2 * SC + SUM + 1023) / 1024 * 1024;
  static constexpr int RED = 2 * (MP / 8) * 4 * 128 * 4;
  static constexpr int BYTES = 1024 + kStages * STAGE + RED + 2 * kStages * 8;
};

// byte offset of 16-byte chunk ch (8 k slots) of activation row m: tiles of
// [MP][64] bf16, 128-byte swizzled
template <int MP>
__device__ __forceinline__ uint32_t act_off(int m, int ch) {
  return (uint32_t)((ch >> 3) * MP * 128) + skt::sw128(m, ch & 7);
}

// An int4 nibble pair (bits 0-3 and 16-19) -> bf16 136 + c, exact: 0x4300
// is 128.0 with a mantissa unit of 1, and a two's-complement nibble c has
// c ^ 8 == c + 8, so one and-xor builds both (int4_pair's fma that takes
// the 136 off is left to the group's f32 sum, kInt4Bias * sum(a)).
constexpr float kInt4Bias = 136.f;
__device__ __forceinline__ uint32_t int4_biased_pair(uint32_t v) { return (v & 0x000F000Fu) ^ 0x43084308u; }

// bytes [w0.b, w0.b, w1.b, w1.b]: low nibbles of the two bytes at bits 0-3
// and 16-19, high nibbles at 4-7 and 20-23
__device__ __forceinline__ uint32_t pair_bytes(uint32_t w0, uint32_t w1, int b) {
  return __byte_perm(w0, w1, b | (b << 4) | ((4 + b) << 8) | ((4 + b) << 12));
}

// The rows pass: row m of prologue(a), rounded to bf16, zero past the true
// K, each 16 k as k 0, 2, .., 14, 1, 3, .., 15. It lets the GEMM launch at
// once (programmatic dependent launch).
__global__ void __launch_bounds__(256) act_rows_kernel(const DParams p, bf16* __restrict__ act) {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int m = blockIdx.x, tid = threadIdx.x;
  __shared__ float part[8];
  float r = 0.f;
  if (p.prologue == kPrologueNorm) {  // rsqrt(mean(x^2) + eps) over the true K (w4a16.py:181)
    float sq = 0.f;
    for (int k = 8 * tid; k < p.k_valid; k += 8 * 256) {
      float x[8];
      unpack8(load8(p.a, m, p.M, p.lda, k, p.k_valid, p.vec_a), x);
#pragma unroll
      for (int e = 0; e < 8; ++e) sq += x[e] * x[e];
    }
    sq = skt::warp_sum(sq);
    if (tid % 32 == 0) part[tid / 32] = sq;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) t += part[w];
    r = 1.f / sqrtf(t / p.k_valid + p.eps);
  }
  bf16* row = act + (long long)m * p.K;
  const int gw = p.group / 16;  // chunks of 16 k a group: 2, 4 or 8 neighbouring lanes
  for (int c0 = 0; c0 < p.K / 16; c0 += 256) {
    const int c = c0 + tid, k = 16 * c;
    float sum = 0.f;
    if (c < p.K / 16) {
      uint4 v[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) v[h] = load8(p.a, m, p.M, p.lda, k + 8 * h, p.k_valid, p.vec_a);
      if (p.prologue != kPrologueNone) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 y = p.prologue == kPrologueNorm ? load8(p.norm_w, 0, 1, 0, k + 8 * h, p.k_valid, p.vec_a)
                                                      : load8(p.a2, m, p.M, p.lda2, k + 8 * h, p.k_valid, p.vec_a);
          float x[8], yy[8];
          unpack8(v[h], x);
          unpack8(y, yy);
          bf16* hv = reinterpret_cast<bf16*>(&v[h]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            hv[e] = __float2bfloat16(p.prologue == kPrologueNorm ? prologue_norm(x[e], yy[e], r)
                                                                 : prologue_silu(x[e], yy[e]));
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x[8];
        unpack8(v[h], x);
#pragma unroll
        for (int e = 0; e < 8; ++e) sum += x[e];
      }
      uint4 lo, hi;  // k 0, 2, .., 14 and k 1, 3, .., 15
      lo.x = __byte_perm(v[0].x, v[0].y, 0x5410);
      lo.y = __byte_perm(v[0].z, v[0].w, 0x5410);
      lo.z = __byte_perm(v[1].x, v[1].y, 0x5410);
      lo.w = __byte_perm(v[1].z, v[1].w, 0x5410);
      hi.x = __byte_perm(v[0].x, v[0].y, 0x7632);
      hi.y = __byte_perm(v[0].z, v[0].w, 0x7632);
      hi.z = __byte_perm(v[1].x, v[1].y, 0x7632);
      hi.w = __byte_perm(v[1].z, v[1].w, 0x7632);
      *reinterpret_cast<uint4*>(row + k) = lo;
      *reinterpret_cast<uint4*>(row + k + 8) = hi;
    }
    // the group's sum of the rounded activations: a butterfly over its lanes
    for (int o = 1; o < gw; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (c < p.K / 16 && c % gw == 0) p.asum[(long long)(c / gw) * kDecSumLd + m] = sum;
  }
}

template <int G, int MP, bool MX>
__global__ void __launch_bounds__(kDecThreads, 2) w4a16_decode_kernel(const __grid_constant__ DArgs da) {
  using L = DSmem<G, MP>;
  constexpr int S = L::kStages;
  const DParams& p = da.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  float* red = reinterpret_cast<float*>(smem + S * L::STAGE);  // [2 (MP / 8) 4][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S * L::STAGE + L::RED);
  uint64_t* empty = full + S;
  __shared__ int s_last;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // this block's equal share [u0, u1) of the (tile, k block) stages, tile-major
  const long long W = (long long)p.tiles * p.n_kb, NB = min((long long)gridDim.x, W);
  if (blockIdx.x >= NB) return;
  const long long u0 = W * blockIdx.x / NB, u1 = W * (blockIdx.x + 1) / NB;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      skt::mbar_init(&full[s], 1);
      skt::mbar_init(&empty[s], kDecConsumers);
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kDecConsumers) {
    // Producer: one thread streams the share, a stage at a time: codes,
    // scales and zeros (past K and N the boxes read zeros), and the rows
    // pass's activations and group sums. The weights of the first stages go
    // out before the wait for the rows pass (griddepcontrol.wait), since
    // they do not depend on it.
    if (lane != 0) return;
    const uint32_t bytes = L::CODES + L::ACT + (p.zeros ? 2 : 1) * L::SC + L::SUM;
    auto weights = [&](long long u, int st) {
      uint8_t* dst = smem + st * L::STAGE;
      const int n0 = (int)(u / p.n_kb) * kDecBN, kb = (int)(u % p.n_kb);
      skt::tma_load_2d(dst, &da.tw, n0, kb * (kDecKB / 2), &full[st]);
      skt::tma_load_2d(dst + L::CODES + L::ACT, &da.ts, n0, kb * L::SROWS, &full[st]);
      if (p.zeros) skt::tma_load_2d(dst + L::CODES + L::ACT + L::SC, &da.tz, n0, kb * L::SROWS, &full[st]);
    };
    auto rows = [&](long long u, int st) {
      uint8_t* dst = smem + st * L::STAGE;
      const int kb = (int)(u % p.n_kb);
#pragma unroll
      for (int sub = 0; sub < kDecKB / 64; ++sub)
        skt::tma_load_2d(dst + L::CODES + sub * MP * 128, &da.ta, kb * kDecKB + 64 * sub, 0, &full[st]);
      skt::tma_load_2d(dst + L::CODES + L::ACT + 2 * L::SC, &da.tsum, 0, kb * L::SROWS, &full[st]);
    };
    const int first = (int)min((long long)S, u1 - u0);
    for (int k = 0; k < first; ++k) {
      skt::mbar_expect_tx(&full[k], bytes);
      weights(u0 + k, k);
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int k = 0; k < first; ++k) rows(u0 + k, k);
    for (int k = first; u0 + k < u1; ++k) {
      const int st = k % S;
      skt::mbar_wait(&empty[st], ((k / S) - 1) & 1);
      skt::mbar_expect_tx(&full[st], bytes);
      weights(u0 + k, st);
      rows(u0 + k, st);
    }
    return;
  }

  // Consumers: warp w takes columns 32 (w % 4) .. + 31 of the tile and the
  // stage's scale groups of half w / 4.
  const int gq = lane >> 2, tq = lane & 3;
  const int ws = warp % 4, half = warp / 4;
  const int lr = (lane >> 4) * 8 + (lane & 7), lc = (lane >> 3) & 1;  // this lane's ldmatrix row and chunk
  const int cw = 2 * ws + (gq >> 2), cb = (4 * gq) & 15;            // its codes' 16-byte chunk and byte
  constexpr int kHalf = L::SROWS / 2;                                // scale groups a half takes a stage
  auto block_of = [&](long long u) { return ((u + 1) * NB + W - 1) / W - 1; };
  long long k = 0;  // stages consumed
  for (long long u = u0; u < u1;) {
    const int tile = (int)(u / p.n_kb);
    const long long us = (long long)tile * p.n_kb, ue = min(u1, us + p.n_kb);  // this block's part of the tile
    // acc[c][j][e]: column 128 tile + 32 ws + 4 gq + 2 (e >> 1) + c, activation row 8 j + 2 tq + (e & 1)
    float acc[2][MP / 8][4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;
    for (; u < ue; ++u, ++k) {
      const int st = (int)(k % S);
      skt::mbar_wait(&full[st], (int)(k / S) & 1);
      const uint8_t* codes = smem + st * L::STAGE;
      const uint8_t* sact = codes + L::CODES;
      const bf16* srow = reinterpret_cast<const bf16*>(codes + L::CODES + L::ACT);
      const float* ssum = reinterpret_cast<const float*>(codes + L::CODES + L::ACT + 2 * L::SC);
#pragma unroll
      for (int gh = 0; gh < kHalf; ++gh) {
        const int gi = half * kHalf + gh;
        float part[2][MP / 8][4];
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int j = 0; j < MP / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[c][j][e] = 0.f;
#pragma unroll
        for (int kq = 0; kq < G / 16; ++kq) {
          const int ks = gi * (G / 16) + kq;
          // packed rows 8 ks + 2 tq and + 1: k slots (2 tq, 2 tq + 1) are the
          // two rows' low nibbles, (2 tq + 8, 2 tq + 9) their high nibbles
          const int r0 = 8 * ks + 2 * tq;
          const uint32_t w0 = *reinterpret_cast<const uint32_t*>(codes + r0 * 128 + ((cw ^ (r0 & 7)) << 4) + cb);
          const uint32_t w1 =
              *reinterpret_cast<const uint32_t*>(codes + (r0 + 1) * 128 + ((cw ^ ((r0 + 1) & 7)) << 4) + cb);
          uint32_t af[2][4];  // A rows gq and gq + 8 of set c: bytes c and 2 + c
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t xa = pair_bytes(w0, w1, c), xb = pair_bytes(w0, w1, 2 + c);
            if (MX) {
              af[c][0] = mxfp4_pair(xa);
              af[c][2] = mxfp4_pair(xa >> 4);
              af[c][1] = mxfp4_pair(xb);
              af[c][3] = mxfp4_pair(xb >> 4);
            } else {  // 136 + c: the offset comes off per group, 136 sum(a)
              af[c][0] = int4_biased_pair(xa);
              af[c][2] = int4_biased_pair(xa >> 4);
              af[c][1] = int4_biased_pair(xb);
              af[c][3] = int4_biased_pair(xb >> 4);
            }
          }
#pragma unroll
          for (int mt = 0; mt < MP / 16; ++mt) {
            uint32_t bfr[4];  // activation rows 16 mt + 0-7 / 8-15, slots 0-7 / 8-15
            skt::ldsm_x4(bfr, sact + act_off<MP>(16 * mt + lr, 2 * ks + lc));
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              mma_bf16(part[c][2 * mt], af[c], bfr[0], bfr[1]);
              mma_bf16(part[c][2 * mt + 1], af[c], bfr[2], bfr[3]);
            }
          }
        }
        // the group's output-side scaling (and zero-point term) per column
        const uint2 sv = *reinterpret_cast<const uint2*>(srow + gi * kDecBN + 32 * ws + 4 * gq);
        const bf16* sh = reinterpret_cast<const bf16*>(&sv);
        float sc[4], zc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[q] = __bfloat162float(sh[q]);
        if (p.zeros) {
          const uint2 zv = *reinterpret_cast<const uint2*>(srow + (L::SROWS + gi) * kDecBN + 32 * ws + 4 * gq);
          const bf16* zh = reinterpret_cast<const bf16*>(&zv);
#pragma unroll
          for (int q = 0; q < 4; ++q) zc[q] = __bfloat162float(zh[q]);
        }
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float am = ssum[gi * MP + 8 * j + 2 * tq + r];
#pragma unroll
            for (int c = 0; c < 2; ++c)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int q = 2 * h + c, e = 2 * h + r;
                acc[c][j][e] += (MX ? part[c][j][e] : part[c][j][e] - kInt4Bias * am) * sc[q] - am * zc[q];
              }
          }
      }
      __syncwarp();
      if (lane == 0) skt::mbar_arrive(&empty[st]);
    }

    // The tile's part is done: the second half's sums join the first's.
    skt::named_sync(1, 32 * kDecConsumers);
    if (half == 1) {
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int j = 0; j < MP / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) red[((c * (MP / 8) + j) * 4 + e) * 128 + tid - 128] = acc[c][j][e];
    }
    skt::named_sync(1, 32 * kDecConsumers);
    if (half == 1) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][j][e] += red[((c * (MP / 8) + j) * 4 + e) * 128 + tid];

    // Epilogue: a thread holds 4 adjacent columns of rows 8 j + 2 tq + r.
    const int col = tile * kDecBN + 32 * ws + 4 * gq;
    auto store = [&](int m, float (&v)[4]) {
      if (m >= p.M || col >= p.N) return;  // N % 16 == 0: 4 columns wholly in or out
      const long long idx = (long long)m * p.N + col;
      if (p.bias) {
        const float4 bv = *reinterpret_cast<const float4*>(p.bias + col);
        v[0] += bv.x, v[1] += bv.y, v[2] += bv.z, v[3] += bv.w;
      }
      if (p.residual) {
        const uint2 rv = *reinterpret_cast<const uint2*>(p.residual + idx);
        const bf16* rh = reinterpret_cast<const bf16*>(&rv);
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] += __bfloat162float(rh[q]);
      }
      if (p.out_f32) {
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(p.out) + idx) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        __align__(8) bf16 o[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) o[q] = __float2bfloat16(v[q]);
        *reinterpret_cast<uint2*>(reinterpret_cast<bf16*>(p.out) + idx) = *reinterpret_cast<const uint2*>(o);
      }
    };
    const long long cf = block_of(us), cl = block_of(us + p.n_kb - 1);
    if (cf == cl) {  // the whole tile is this block's
#pragma unroll
      for (int j = 0; j < MP / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float v[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) v[q] = acc[q & 1][j][2 * (q >> 1) + r];
          store(8 * j + 2 * tq + r, v);
        }
      continue;
    }
    // Shared: this block's partial (slot 0 if the tile is its first, else
    // its last), then the last block to arrive sums every sharer's in block
    // order.
    auto slot = [&](long long cb) {
      const int which = cb == cf && W * cb / NB < us ? 1 : 0;
      return p.partial + (cb * 2 + which) * (MP * kDecBN);
    };
    float* mine = p.partial + ((long long)blockIdx.x * 2 + (us <= u0 ? 0 : 1)) * (MP * kDecBN);
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 8 * j + 2 * tq + r;
        if (m >= p.M) continue;
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) v[q] = acc[q & 1][j][2 * (q >> 1) + r];
        *reinterpret_cast<float4*>(mine + m * kDecBN + 32 * ws + 4 * gq) = make_float4(v[0], v[1], v[2], v[3]);
      }
    __threadfence();
    skt::named_sync(2, 128);
    if (tid == 0) s_last = atomicAdd(&p.counters[tile], 1) == (int)(cl - cf);
    skt::named_sync(2, 128);
    if (!s_last) continue;
    __threadfence();
    const int n_c = (int)(cl - cf + 1);
#pragma unroll
    for (int j = 0; j < MP / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = 8 * j + 2 * tq + r;
        if (m >= p.M) continue;
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < n_c; c0 += 8) {  // eight loads in flight, then the sums in block order
          float4 pv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float4* src = reinterpret_cast<const float4*>(slot(cf + c0 + i) + m * kDecBN + 32 * ws + 4 * gq);
            pv[i] = c0 + i < n_c ? __ldcg(src) : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (c0 + i >= n_c) break;
            v[0] += pv[i].x, v[1] += pv[i].y, v[2] += pv[i].z, v[3] += pv[i].w;
          }
        }
        store(m, v);
      }
    if (tid == 0) p.counters[tile] = 0;  // ready for the next call
  }
}

template <int G, int MP, bool MX>
cudaError_t launch_decode(const DArgs& da, int blocks, cudaStream_t st) {
  using L = DSmem<G, MP>;
  auto kernel = w4a16_decode_kernel<G, MP, MX>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kDecThreads);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cfg.attrs = attr;  // behind the rows pass, which it overlaps
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, da);
}

template <int G>
cudaError_t dispatch(int mp, int mxfp4, const DArgs& da, int blocks, cudaStream_t st) {
  if (mp == 16) return mxfp4 ? launch_decode<G, 16, true>(da, blocks, st) : launch_decode<G, 16, false>(da, blocks, st);
  if (mp == 32) return mxfp4 ? launch_decode<G, 32, true>(da, blocks, st) : launch_decode<G, 32, false>(da, blocks, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// One decode call (M <= 32). w uint8 [K/2, N], scales / zeros bf16 [K/G, N]
// (zeros may be null), N % 16 == 0 and all three 16-byte aligned (TMA's
// rule); a, a2, norm_w, residual bf16, bias f32, out bf16 or f32 (out_f32);
// group 32, 64 or 128. act: an [M, K] bf16 workspace and asum a
// [K / group][32] float32 one, 16-byte aligned, which the rows pass fills
// and the GEMM reads. The GEMM runs `blocks` blocks, each an equal share of
// the (N / 128 tiles) x (K / 256) stages; partial holds blocks x 2 x MP x
// 128 floats (MP = 16 for M <= 16, else 32); counters: N / 128 ints, zero
// before the first call (every call leaves them zero). vec_a: a's rows (and
// a2's, norm_w) allow 16-byte loads.
extern "C" int skt_w4a16_decode(const void* a, const void* a2, const void* norm_w, void* act, void* asum,
                                const void* w, const void* scales, const void* zeros, const void* bias,
                                const void* residual, void* out, void* partial, void* counters, int M, int N, int K,
                                int k_valid, int lda, int lda2, int group, int blocks, int prologue, int mxfp4,
                                int out_f32, int vec_a, float eps, void* stream) {
  const int mp = M <= 16 ? 16 : 32;
  if (M < 1 || M > 32 || N % 16 || K % group || K % 16 || blocks < 1 || !partial || !counters || !act || !asum)
    return (int)cudaErrorInvalidValue;
  DArgs da;
  const bool ok = skt::map_2d(&da.tw, w, 1, K / 2, N, N, kDecBN, kDecKB / 2, true) &&
                  skt::map_2d(&da.ts, scales, 2, K / group, N, N, kDecBN, kDecKB / group, false) &&
                  (!zeros || skt::map_2d(&da.tz, zeros, 2, K / group, N, N, kDecBN, kDecKB / group, false)) &&
                  skt::map_2d(&da.ta, act, 2, M, K, K, 64, mp, true) &&
                  skt::map_2d(&da.tsum, asum, 4, K / group, kDecSumLd, kDecSumLd, mp, kDecKB / group, false);
  if (!ok) return (int)cudaErrorInvalidValue;
  if (!zeros) da.tz = da.ts;  // never read
  DParams& p = da.p;
  p.a = (const bf16*)a;
  p.a2 = (const bf16*)a2;
  p.norm_w = (const bf16*)norm_w;
  p.residual = (const bf16*)residual;
  p.bias = (const float*)bias;
  p.asum = (float*)asum;
  p.out = out;
  p.partial = (float*)partial;
  p.counters = (int*)counters;
  p.M = M, p.N = N, p.K = K, p.group = group, p.k_valid = k_valid, p.lda = lda, p.lda2 = lda2;
  p.n_kb = (K + kDecKB - 1) / kDecKB, p.tiles = (N + kDecBN - 1) / kDecBN;
  p.prologue = prologue, p.out_f32 = out_f32, p.zeros = zeros != nullptr, p.vec_a = vec_a, p.eps = eps;
  const cudaStream_t st = (cudaStream_t)stream;
  act_rows_kernel<<<M, 256, 0, st>>>(p, (bf16*)act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (group) {
    case 32: err = dispatch<32>(mp, mxfp4, da, blocks, st); break;
    case 64: err = dispatch<64>(mp, mxfp4, da, blocks, st); break;
    case 128: err = dispatch<128>(mp, mxfp4, da, blocks, st); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
