// The W4A16 tile code shared by K1 (w4a16_gemm.cu) and K11 (grouped_gemm.cu):
// the Params of a launch, the main kernel over scale groups on mma.sync,
// the split-K reduction and the prologue's row pass, and the tile dispatch.
// The design is described in w4a16_gemm.cu. With expert_ids set, row block
// m0 / block_rows of the launch takes that expert's weights (the grouped
// form, K11): a block at or past *num_valid returns before any load.
#pragma once

#include "common.cuh"

namespace {

using skt::bf16;
using skt::cp_async16;
using skt::cp_async_commit;
using skt::cp_async_wait;
using skt::mma_bf16;
using skt::smem_u32;

constexpr int kThreads = 128;  // four warps

enum { kPrologueNone = 0, kPrologueNorm = 1, kPrologueSiluMul = 2 };

struct Params {
  const bf16* a;        // [M, lda]
  const bf16* a2;       // [M, lda2] (silu_mul's second operand) or null
  const bf16* norm_w;   // [K] or null
  const float* rms;     // [M] row factors of the norm prologue
  const uint8_t* w;     // [K/2, N]
  const bf16* scales;   // [K/G, N]
  const bf16* zeros;    // [K/G, N] or null
  const float* bias;    // [N] or null
  const bf16* residual; // [M, N] or null
  void* out;            // [M, N] bf16 or f32
  float* partial;       // [split, M, N] when split > 1
  int M, N, k_valid, lda, lda2, n_groups, groups_per_split;
  int prologue, mxfp4, out_f32, split, vec_a, vec_w;
  float norm_eps;
  // grouped form (K11), expert_ids null otherwise: row block m0 / block_rows
  // takes expert expert_ids[m0 / block_rows], whose codes start w_estride
  // bytes and whose scales and zeros start s_estride elements after the
  // previous expert's; blocks at or past *num_valid do nothing
  const int* expert_ids;
  const int* num_valid;
  int block_rows;
  long long w_estride, s_estride;
};

// The nibbles at bits 0-3 and 16-19 of v -> two bf16 (low half first).
// int4: bf16 0x4300 is 128.0 with a mantissa unit of 1, so 0x4300 | u is
// 128 + u; a two's-complement nibble c has c ^ 8 == c + 8, so one
// and-xor gives 128 + c + 8 and one bf16x2 fma, x * 1 - 136, gives c, exact
// (one instruction; the __hsub2 intrinsic is not one on this target).
__device__ __forceinline__ uint32_t int4_pair(uint32_t v) {
  const uint32_t r = (v & 0x000F000Fu) ^ 0x43084308u;
  uint32_t c;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(c) : "r"(r), "r"(0x3F803F80u), "r"(0xC308C308u));
  return c;
}

// e2m1 nibble (sign in bit 3, w4a16.py:159-165) -> bf16 bits
__device__ __forceinline__ uint32_t e2m1_bits(uint32_t x) {
  const uint32_t e = (x >> 1) & 3u, m = x & 1u;
  const uint32_t mag = e ? (((e + 126u) << 7) | (m << 6)) : (m ? 0x3F00u : 0u);
  return mag | ((x & 8u) << 12);
}

__device__ __forceinline__ uint32_t mxfp4_pair(uint32_t v) {
  return e2m1_bits(v & 0xFu) | (e2m1_bits((v >> 16) & 0xFu) << 16);
}

// 8 bf16 from column k of row m (row stride ld) as one 16-byte word; zero
// past M or past the true K (the zero-padded tail, w4a16.py:392)
__device__ __forceinline__ uint4 load8(const bf16* base, int m, int M, long long ld, int k,
                                       int k_valid, int vec) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (m >= M) return out;
  const bf16* src = base + (long long)m * ld + k;
  if (vec && k + 8 <= k_valid) return *reinterpret_cast<const uint4*>(src);
  bf16* h = reinterpret_cast<bf16*>(&out);
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (k + i < k_valid) h[i] = src[i];
  return out;
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&x)[8]) {
  const bf16* h = reinterpret_cast<const bf16*>(&v);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
}

// the prologue on one element, rounded to bf16 (w4a16.py:184, :187)
__device__ __forceinline__ float prologue_norm(float x, float nw, float r) { return x * nw * r; }
__device__ __forceinline__ float prologue_silu(float g, float u) {
  return g * (1.f / (1.f + expf(-g))) * u;
}

__device__ __forceinline__ void store_out(const Params& p, int row, int col, float v) {
  const long long idx = (long long)row * p.N + col;
  if (p.bias) v += p.bias[col];
  if (p.residual) v += __bfloat162float(p.residual[idx]);
  if (p.out_f32)
    reinterpret_cast<float*>(p.out)[idx] = v;
  else
    reinterpret_cast<bf16*>(p.out)[idx] = __float2bfloat16(v);
}

// The k and n orders inside a tile. A thread's mma B fragment is two bf16
// pairs of one column: mma k slots (2t, 2t+1) and (2t+8, 2t+9) of a 16-deep
// step. Packed row r of a step holds k = 2r (low nibble) and 2r+1 (high),
// so the low nibbles of rows t and t+4 are k = 2t and 2t+8: the slots are
// taken in the order slot(2t) = k 2t, slot(2t+1) = k 2t+8, slot(2t+8) =
// k 2t+1, slot(2t+9) = k 2t+9, and the activations are written to shared
// memory in the same order, so every pair of nibbles decodes with one mask.
// Along n, a warp's 32 columns are read as 4-byte words: lane column c of
// n8 tile j is column 4c + j of the warp's range, so one 32-bit load gives
// a thread its byte of all four tiles.
//
// G: group size; a warp owns MT m16 tiles x 4 n8 tiles; WM x WN warps;
// S: ring depth; PRO: the prologue runs here (decode tiles) rather than in
// the rows pass; MX: mxfp4 codes; ZR: zero points. Both are compile-time
// choices: a runtime branch inside the unrolled step loop keeps the
// compiler from interleaving the decode with the loads and products, and
// measured far slower.
template <int G, int MT, int NT, int WM, int WN, int S, bool PRO, bool MX, bool ZR>
__global__ void __launch_bounds__(kThreads) w4a16_kernel(const Params p) {
  static_assert(WM * WN * 32 == kThreads, "four warps");
  static_assert(NT == 4, "a warp reads its 32 columns as 4-byte words");
  constexpr int kStages = S;
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  constexpr int A_STRIDE = G + 8;    // bf16 per smem row: conflict-free fragment loads
  constexpr int W_ROWS = G / 2;      // packed rows of one group
  // bytes per smem row: the 4 rows x 8 words a warp's fragment loads touch
  // fall in distinct banks (stride of 8 or 24 words mod 32), 16-byte aligned
  constexpr int W_STRIDE = BN + 32;
  constexpr int W_BYTES = W_ROWS * W_STRIDE;
  constexpr int STAGE = W_BYTES + 2 * BN * 2;  // codes, then the scale and zero rows
  constexpr int A_CHUNKS = BM * (G / 16);      // 16-element activation chunks of a group
  constexpr int A_PER = (A_CHUNKS + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint8_t ring[kStages][STAGE];
  __shared__ __align__(16) bf16 sa[BM * A_STRIDE];
  __shared__ float s_asum[BM];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int g_begin = blockIdx.z * p.groups_per_split;
  const int n_iter = min(p.n_groups, g_begin + p.groups_per_split) - g_begin;

  const uint8_t* w_base = p.w;
  const bf16* s_base = p.scales;
  const bf16* z_base = p.zeros;
  if (p.expert_ids != nullptr) {  // grouped: the row block's expert (uniform over the block)
    const int blk = m0 / p.block_rows;
    if (blk >= *p.num_valid) return;
    const long long e = p.expert_ids[blk];
    w_base += e * p.w_estride;
    s_base += e * p.s_estride;
    if (ZR) z_base += e * p.s_estride;
  }

  // a group's packed codes, scales and zeros into ring slot `stage`
  auto load_stage = [&](int g, int stage) {
    constexpr int CPR = BN / 16;  // 16-byte chunks per row
    for (int c = tid; c < W_ROWS * CPR; c += kThreads) {
      const int r = c / CPR, cc = (c % CPR) * 16, col = n0 + cc;
      const uint8_t* src = w_base + (long long)(g * W_ROWS + r) * p.N + col;
      uint8_t* dst = ring[stage] + r * W_STRIDE + cc;
      if (p.vec_w && col + 16 <= p.N) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 16; ++e) dst[e] = col + e < p.N ? src[e] : (uint8_t)0;
      }
    }
    bf16* srow = reinterpret_cast<bf16*>(ring[stage] + W_BYTES);
    for (int c = tid; c < (ZR ? 2 : 1) * (BN / 8); c += kThreads) {
      const int which = c / (BN / 8), cc = (c % (BN / 8)) * 8, col = n0 + cc;
      const bf16* src = (which ? z_base : s_base) + (long long)g * p.N + col;
      bf16* dst = srow + which * BN + cc;
      if (p.vec_w && col + 8 <= p.N) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 8; ++e) dst[e] = col + e < p.N ? src[e] : __float2bfloat16(0.f);
      }
    }
  };

  // activations travel one group ahead in registers: raw a, and a2
  // (silu_mul) or the norm weight; the prologue runs on the way to smem
  uint4 ra[A_PER][2], rb[A_PER][2];
  float rrow[A_PER];
#pragma unroll
  for (int i = 0; i < A_PER; ++i) {
    const int m = m0 + (tid + i * kThreads) / (G / 16);
    rrow[i] = (PRO && p.prologue == kPrologueNorm && m < p.M) ? p.rms[m] : 0.f;
  }
  auto fetch_a = [&](int g) {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * kThreads;
      if (c >= A_CHUNKS) break;
      const int m = m0 + c / (G / 16), k = g * G + (c % (G / 16)) * 16;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ra[i][h] = load8(p.a, m, p.M, p.lda, k + 8 * h, p.k_valid, p.vec_a);
        if (PRO && p.prologue == kPrologueSiluMul)
          rb[i][h] = load8(p.a2, m, p.M, p.lda2, k + 8 * h, p.k_valid, p.vec_a);
        else if (PRO && p.prologue == kPrologueNorm)
          rb[i][h] = load8(p.norm_w, 0, 1, 0, k + 8 * h, p.k_valid, p.vec_a);
      }
    }
  };
  auto store_a = [&]() {
#pragma unroll
    for (int i = 0; i < A_PER; ++i) {
      const int c = tid + i * kThreads;
      if (c >= A_CHUNKS) break;
      uint4 v[2] = {ra[i][0], ra[i][1]};
      if (PRO && p.prologue != kPrologueNone) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float x[8], y[8];
          unpack8(ra[i][h], x);
          unpack8(rb[i][h], y);
          bf16* hv = reinterpret_cast<bf16*>(&v[h]);
#pragma unroll
          for (int e = 0; e < 8; ++e)
            hv[e] = __float2bfloat16(p.prologue == kPrologueNorm ? prologue_norm(x[e], y[e], rrow[i])
                                                                 : prologue_silu(x[e], y[e]));
        }
      }
      // k 0..15 of the chunk into the slot order: slots 0-7 take k 0, 8, 2,
      // 10, 4, 12, 6, 14 and slots 8-15 take k 1, 9, 3, 11, 5, 13, 7, 15
      uint4 lo, hi;
      lo.x = __byte_perm(v[0].x, v[1].x, 0x5410);
      lo.y = __byte_perm(v[0].y, v[1].y, 0x5410);
      lo.z = __byte_perm(v[0].z, v[1].z, 0x5410);
      lo.w = __byte_perm(v[0].w, v[1].w, 0x5410);
      hi.x = __byte_perm(v[0].x, v[1].x, 0x7632);
      hi.y = __byte_perm(v[0].y, v[1].y, 0x7632);
      hi.z = __byte_perm(v[0].z, v[1].z, 0x7632);
      hi.w = __byte_perm(v[0].w, v[1].w, 0x7632);
      bf16* dst = sa + (c / (G / 16)) * A_STRIDE + (c % (G / 16)) * 16;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 8) = hi;
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load_stage(g_begin + s, s);
    cp_async_commit();
  }
  if (n_iter > 0) fetch_a(g_begin);

  for (int it = 0; it < n_iter; ++it) {
    const int g = g_begin + it;
    if (it + kStages - 1 < n_iter) load_stage(g + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    store_a();
    if (it + 1 < n_iter) fetch_a(g + 1);  // in flight while this group computes
    cp_async_wait<kStages - 1>();
    __syncthreads();
    if (ZR) {
      for (int r = tid; r < BM; r += kThreads) {
        float s = 0.f;
        for (int k = 0; k < G; ++k) s += __bfloat162float(sa[r * A_STRIDE + k]);
        s_asum[r] = s;
      }
      __syncthreads();
    }

    const uint8_t* wt = ring[it % kStages];
    const bf16* srow = reinterpret_cast<const bf16*>(wt + W_BYTES);
    float part[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;

#pragma unroll
    for (int ks = 0; ks < G / 16; ++ks) {
      uint32_t af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* base = sa + (wm * MT * 16 + i * 16 + gq) * A_STRIDE + ks * 16 + tq * 2;
        af[i][0] = *reinterpret_cast<const uint32_t*>(base);
        af[i][1] = *reinterpret_cast<const uint32_t*>(base + 8 * A_STRIDE);
        af[i][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(base + 8 * A_STRIDE + 8);
      }
      // packed rows t and t+4 of this step, the thread's byte of each n8 tile
      const uint8_t* wb = wt + (ks * 8 + tq) * W_STRIDE + wn * 32 + 4 * gq;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wb);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wb + 4 * W_STRIDE);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // byte j of row t in bits 0-7, byte j of row t+4 in bits 16-23
        const uint32_t x = __byte_perm(w0, w1, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12));
        uint32_t b0, b1;  // low nibbles: slots 2t, 2t+1; high nibbles: 2t+8, 2t+9
        if (MX) {
          b0 = mxfp4_pair(x);
          b1 = mxfp4_pair(x >> 4);
        } else {
          b0 = int4_pair(x);
          b1 = int4_pair(x >> 4);
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], af[i], b0, b1);
      }
    }

    // output-side group scaling and the zero-point correction; the lane
    // columns 2t and 2t+1 of tile j are block columns 8t + j and 8t + 4 + j
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int cl = wn * 32 + 8 * tq + j;
      const float s0 = __bfloat162float(srow[cl]), s1 = __bfloat162float(srow[cl + 4]);
      const float z0 = ZR ? __bfloat162float(srow[BN + cl]) : 0.f;
      const float z1 = ZR ? __bfloat162float(srow[BN + cl + 4]) : 0.f;
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        acc[i][j][0] += part[i][j][0] * s0;
        acc[i][j][1] += part[i][j][1] * s1;
        acc[i][j][2] += part[i][j][2] * s0;
        acc[i][j][3] += part[i][j][3] * s1;
        if (ZR) {
          const int r = wm * MT * 16 + i * 16 + gq;
          acc[i][j][0] -= s_asum[r] * z0;
          acc[i][j][1] -= s_asum[r] * z1;
          acc[i][j][2] -= s_asum[r + 8] * z0;
          acc[i][j][3] -= s_asum[r + 8] * z1;
        }
      }
    }
    __syncthreads();  // the next group overwrites sa, s_asum and this ring slot
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm * MT * 16 + i * 16 + gq + (e >> 1) * 8;
        const int col = n0 + wn * 32 + 8 * tq + 4 * (e & 1) + j;
        if (row >= p.M || col >= p.N) continue;
        if (p.split > 1)
          p.partial[((long long)blockIdx.z * p.M + row) * p.N + col] = acc[i][j][e];
        else
          store_out(p, row, col, acc[i][j][e]);
      }
}

// second pass of split-K: the splits' partials summed in split order, then
// bias, residual and the cast
__global__ void split_reduce_kernel(const Params p) {
  const long long total = (long long)p.M * p.N;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  float v = 0.f;
  for (int s = 0; s < p.split; ++s) v += p.partial[s * total + idx];
  store_out(p, (int)(idx / p.N), (int)(idx % p.N), v);
}

// first pass of a prologue, one block a row. The norm needs the mean
// square of the whole K row, which no block of the main kernel sees: it
// writes rsqrt(mean(x^2) + eps) to rms (w4a16.py:181). With act_out (the
// prefill tile, where many column blocks would repeat the prologue) it also
// writes the prologue's bf16 rows, and the main kernel reads those.
__global__ void row_prologue_kernel(const Params p, float* __restrict__ rms,
                                    bf16* __restrict__ act_out) {
  const int m = blockIdx.x;
  const bf16* ar = p.a + (long long)m * p.lda;
  __shared__ float part[kThreads / 32];
  float r = 0.f;
  if (p.prologue == kPrologueNorm) {
    float s = 0.f;
    for (int k = threadIdx.x; k < p.k_valid; k += kThreads) {
      const float x = __bfloat162float(ar[k]);
      s += x * x;
    }
    s = skt::warp_sum(s);
    if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
    __syncthreads();
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) t += part[w];
    r = 1.f / sqrtf(t / p.k_valid + p.norm_eps);
    if (threadIdx.x == 0) rms[m] = r;
  }
  if (!act_out) return;
  bf16* dst = act_out + (long long)m * p.k_valid;
  const bf16* a2r = p.a2 + (long long)m * p.lda2;
  for (int k = threadIdx.x; k < p.k_valid; k += kThreads) {
    const float x = __bfloat162float(ar[k]);
    dst[k] = __float2bfloat16(p.prologue == kPrologueNorm
                                  ? prologue_norm(x, __bfloat162float(p.norm_w[k]), r)
                                  : prologue_silu(x, __bfloat162float(a2r[k])));
  }
}

template <int G, int MT, int NT, int WM, int WN, int S, bool PRO>
cudaError_t launch_main(const Params& p, cudaStream_t st) {
  constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN;
  dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.split);
  if (p.mxfp4 && p.zeros)
    w4a16_kernel<G, MT, NT, WM, WN, S, PRO, true, true><<<grid, kThreads, 0, st>>>(p);
  else if (p.mxfp4)
    w4a16_kernel<G, MT, NT, WM, WN, S, PRO, true, false><<<grid, kThreads, 0, st>>>(p);
  else if (p.zeros)
    w4a16_kernel<G, MT, NT, WM, WN, S, PRO, false, true><<<grid, kThreads, 0, st>>>(p);
  else
    w4a16_kernel<G, MT, NT, WM, WN, S, PRO, false, false><<<grid, kThreads, 0, st>>>(p);
  return cudaGetLastError();
}

// tile: 0 = decode, M <= 16 (16 x 128); 1 = decode, M <= 32 (32 x 128);
// 2 = prefill (64 x 64)
template <int G>
cudaError_t dispatch_tile(int tile, const Params& p, cudaStream_t st) {
  switch (tile) {
    case 0: return launch_main<G, 1, 4, 1, 4, 4, true>(p, st);
    case 1: return launch_main<G, 2, 4, 1, 4, 3, true>(p, st);
    case 2: return launch_main<G, 2, 4, 2, 2, 4, false>(p, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
