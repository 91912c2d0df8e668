// K19: QServe W4A8 GEMM with progressive per-group dequantization.
//
// Replaces qserve_w4a8_per_group_gemm (sgl_kernel_tpu/ops/gemm/qserve.py:61,
// Pallas kernel _per_group_kernel :34, pallas_call at :102). Contract: A
// [M, K] int8 (row-major), W [N, K] uint4 codes one a byte (K contiguous),
// s2 and zs2 [N, K/G] (the group scale and zero * scale), wscales [N] and
// ascales [M]; the scales int8, f16, bf16 or float32, read in their own type:
//
//   W8[n, k] = bf16(code * s2[n, k/G] - zs2[n, k/G])     (product and
//              difference each rounded in float32, then one bf16 rounding)
//   out[m, n] = (sum_k A[m, k] * W8[n, k]) * ascales[m] * wscales[n]
//
// as the TPU kernel rounds it (qserve.py:46-51), the output rounded once to
// f16, bf16 or float32.
//
// Bound: bytes at decode (Llama-3-8B's gate_up at M=16 streams 117 MB of
// one-byte codes for 3.8 GFLOP), int8 operations at prefill.
//
// The int8 route. Where every W8 is an integer in [-128, 127] (QServe's
// progressive quantization keeps W8 within +-119 before its 4-bit step),
// int8 x int8 products summed in int32 give JAX's function exactly: the
// int32 sum is exact for K < 2^17 (|a w| <= 2^14), finer than JAX's float32
// sum. The tile computes out^T = W8 A^T on wgmma m64nNk32 .s32.s8.s8: the
// weights are wgmma's M (64 rows a consumer warpgroup, two warpgroups a
// 128-row block) and come from registers; the activation rows are its N (BM
// = 16, 32, 64 or 128, the row tile) and are read from shared memory by
// descriptor, K-major as they lie. A lane's A fragment holds four
// consecutive k bytes of a row a register, so it reads its code words
// straight from the swizzled stage (the eight rows of a k32 slab land on
// distinct 16-byte chunks: no bank conflict) and makes W8 there, once a
// block for each code byte: a byte permute spreads two codes into the
// 16-bit lanes of a word, and one integer multiply-add by s2 and (1024 -
// zs2) in both lanes gives 1024 + c * s2 - zs2, exact and free of carries
// between the lanes wherever s2 and zs2 are integers with 0 <= s2 <= 128
// and |zs2| <= 512 (then JAX's float32 product and difference are exact
// too: the fast form). A lane lies in [896, 1151] exactly where W8 is an
// int8, its low byte then being W8 in two's complement: a 32-bit
// subtraction of 0x03800380 leaves any lane outside with bits under
// 0xFF00FF00, and one byte permute packs four. A group whose scales are not
// of the fast form sends its block to the exact route (QServe's integer
// scales always are). G >= 32 divides K, so a k32 slab lies in one group.
// The four lanes of a quad, which make the same two rows, each read one of
// their four group scales (in the caller's type) two groups ahead and make
// that quarter of the constants; the quad shares them by shuffles at the
// group's first slab. One int32 accumulator runs the block's whole k range:
// nothing needs promoting, and the scales come in the epilogue.
//
// The exact route. The consumers vote at the end of their k range (a
// barrier reduction); a block where any W8 was not an int8 or any group's
// scales not of the fast form (or any block when K >= 2^17) recomputes its
// tile from device memory in the same launch on JAX's arithmetic,
// bf16(fsub(fmul(code, s2), zs2)) times the int8 activations in float32
// sums, a thread a weight row and half the activation rows. It is slow and
// counts itself in exact_blocks.
//
// Feeding. One producer warp keeps a ring of S stages full behind
// mbarriers: each stage 256 k deep, two 2-D TMA boxes side by side of the
// 128 weight rows' codes and two of the BM activation rows (256-byte runs
// a row in device memory; a 128-byte run streams slower), each box 128
// bytes of k with the 128-byte swizzle, zero-filled past N and M; a box
// wholly past K is not fetched, its codes meeting the zero scales read
// there (W8 = 0, an int8). Two blocks an SM at BM = 16, one at 32 - 128.
//
// Split K in one launch. Where the tiles cannot fill the SMs' block slots,
// K splits across blocks in whole 256-deep k-tiles (blockIdx.y,
// ops/gemm/qserve.py's split plan). A block on the int8 route adds its
// int32 partial into a kept int32 workspace by atomics (exact, so the bits
// do not depend on their order); one on the exact route writes its float32
// partial to a workspace of its own; each records its route beside the
// tile's arrival counter. The last block of a tile to arrive (a counter it
// resets to zero) reads the int32 sum once (and zeroes it), adds the
// float32 partials in split order, applies ascales[m] * wscales[n] and
// stores. On the int8 route the output bits do not depend on the split
// plan. A call is one launch, allocates nothing and reads nothing back.
//
// tools/k19_probe.py splits the kernel's time on the card into its stream
// (the consumers' dequantization and wgmmas folded away) and the rest.

#include "gemm_out.cuh"
#include "tma_map.cuh"

namespace {

constexpr int kBox = 128;                 // k of a box: one 128-byte swizzled row
constexpr int kBK = 2 * kBox;             // k of a stage: two boxes side by side, 256-byte runs a row
constexpr int kBN = 128;                  // weight rows a block: two consumer warpgroups of 64
constexpr int kCThreads = 256;            // the consumer warpgroups
constexpr int kThreads = kCThreads + 32;  // and the producer warp
constexpr int kWBox = kBN * kBox;         // a code box
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may take
constexpr int kSmSmem = 233472;           // shared memory of an SM (1 KB of it reserved a block)

enum { kI8 = 0, kF16 = 1, kBF16 = 2, kF32 = 3 };  // element types of the scale tensors

struct Params {
  const int8_t* a;     // [M, K]
  const uint8_t* w;    // [N, K] codes, one a byte
  const void* s2;      // [N, K/G]
  const void* zs2;     // [N, K/G]
  const void* ws;      // [N]
  const void* as;      // [M]
  void* out;           // [M, N]
  int* part;           // [split, M, N] the exact route's float32 partials when split > 1
  int* sums;           // [M, N] the int8 route's int32 sums when split > 1, zero between calls
  int* counters;       // [tiles] arrivals, zero between calls
  int* routes;         // [tiles, split] the route each split took (1: exact)
  int* exact_blocks;   // blocks that took the exact route, summed over calls
  int M, N, K, G, gsh, s_kind, z_kind, ws_kind, as_kind, out_kind, split, tiles_per_split, force_exact;
};

struct alignas(64) KParams {
  CUtensorMap tm_w;  // W [N][K] bytes: boxes of 128 k x 128 rows, 128-byte swizzle
  CUtensorMap tm_a;  // A [M][K] bytes: boxes of 128 k x BM rows, 128-byte swizzle
  Params p;
};

// A stage is the two code boxes then the two activation boxes; after the
// ring, S "full" and S "empty" barriers and two flags (this block is the
// tile's last; a split of the tile took the exact route).
template <int BM>
struct Cfg {
  static constexpr int A_BOX = BM * kBox, W_BYTES = 2 * kWBox, STAGE = W_BYTES + 2 * A_BOX;
  static constexpr int kPerSM = BM == 16 ? 2 : 1;  // blocks an SM (at 32 rows two would spill)
  static constexpr int S = BM == 16 ? 3 : (BM == 32 ? 5 : (BM == 64 ? 4 : 3));
  static constexpr int SMEM = 1024 + S * STAGE + 2 * S * 8 + 16;  // + slack to a 1024-byte boundary
  static_assert(SMEM <= kMaxSmem && kPerSM * (SMEM + 1024) <= kSmSmem, "stages");
};

// Element i of a scale tensor of element type `kind`, as a float.
__device__ __forceinline__ float ld_scale(const void* p, int kind, long long i) {
  if (kind == kI8) return (float)__ldg(reinterpret_cast<const signed char*>(p) + i);
  if (kind == kF32) return __ldg(reinterpret_cast<const float*>(p) + i);
  const uint32_t h = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
  return kind == kF16 ? __half2float(__ushort_as_half((unsigned short)h)) : __uint_as_float(h << 16);
}

// A scale's bits (at bit 0 of v) of element type `kind`, as a float.
__device__ __forceinline__ float decode_scale(uint32_t v, int kind) {
  const float h = __half2float(__ushort_as_half((unsigned short)(v & 0xFFFFu)));
  return kind == kI8 ? (float)(int8_t)(v & 0xFFu)
                     : (kind == kF16 ? h : (kind == kBF16 ? __uint_as_float(v << 16) : __uint_as_float(v)));
}

__device__ __forceinline__ float w8_f32(uint32_t code, float s, float z) {
  return __fsub_rn(__fmul_rn((float)code, s), z);  // no contraction: JAX rounds the product first
}

// One quarter of a group's constants of the fast form, made by one lane of
// a quad: s2 (is_z false) as an integer in [0, 128], or 1024 - zs2 (is_z)
// with zs2 an integer in [-512, 512]; kSlow where the value is neither.
constexpr uint32_t kSlow = 0x80000000u;
__device__ __forceinline__ uint32_t fast_part(float v, bool is_z) {
  const bool ok = v == rintf(v) && (is_z ? fabsf(v) <= 512.f : (v >= 0.f && v <= 128.f));
  return ok ? (uint32_t)(is_z ? 1024 - (int)v : (int)v) : kSlow;
}

// Four codes (the bytes of x) -> their four W8 bytes by the fast form; bad
// gains bits (read under 0xFF00FF00) where one is not an int8.
__device__ __forceinline__ uint32_t w8x4_fast(uint32_t x, uint32_t cs, uint32_t cz, uint32_t& bad) {
  const uint32_t u01 = __byte_perm(x, 0u, 0x4140) * cs + cz, u23 = __byte_perm(x, 0u, 0x4342) * cs + cz;
  bad |= (u01 - 0x03800380u) | (u23 - 0x03800380u);
  return __byte_perm(u01, u23, 0x6420);
}

// The four k32 wgmmas of a box: fragments f[q] against the BM activation
// rows 32 q bytes into the box at a_box, added to acc: one commit group.
template <int BM>
__device__ __forceinline__ void issue(uint32_t (&acc)[BM / 2], uint32_t (&f)[4][4], uint32_t a_box) {
#pragma unroll
  for (int q = 0; q < 4; ++q) skt::fence_regs(f[q]);
  skt::fence_regs(acc);
  skt::wgmma_fence();
#pragma unroll
  for (int q = 0; q < 4; ++q) skt::wgmma_s8_rs<BM>(acc, f[q], skt::wgmma_desc(a_box + 32 * q, 16, 1024), 1);
  skt::wgmma_commit();
}

// The exact route: weight row n against activation rows mb .. mb + BM/2 - 1
// over k in [kb, ke), from device memory in float32 sums, eight rows at a
// time; stores their outputs (split 1) or their float32 partials to part.
template <int BM>
__device__ __forceinline__ void exact_rows(const Params& p, int n, int mb, int kb, int ke, int* part) {
  if (n >= p.N) return;
  const uint8_t* wr = p.w + (long long)n * p.K;
  const long long gbase = (long long)n * (p.K >> p.gsh);
  const float wn = ld_scale(p.ws, p.ws_kind, n);
  for (int j0 = 0; j0 < BM / 2 && mb + j0 < p.M; j0 += 8) {
    float facc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) facc[j] = 0.f;
    float s = 0.f, z = 0.f;
    for (int k = kb; k < ke; k += 4) {
      if ((k & (p.G - 1)) == 0) {
        s = ld_scale(p.s2, p.s_kind, gbase + (k >> p.gsh));
        z = ld_scale(p.zs2, p.z_kind, gbase + (k >> p.gsh));
      }
      const uint32_t c = __ldg(reinterpret_cast<const unsigned int*>(wr + k));
      float wv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) wv[e] = __bfloat162float(__float2bfloat16_rn(w8_f32((c >> (8 * e)) & 0xFFu, s, z)));
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (mb + j0 + j < p.M) {
          const uint32_t a4 = __ldg(reinterpret_cast<const unsigned int*>(p.a + (long long)(mb + j0 + j) * p.K + k));
#pragma unroll
          for (int e = 0; e < 4; ++e) facc[j] = __fmaf_rn((float)(int8_t)(a4 >> (8 * e)), wv[e], facc[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = mb + j0 + j;
      if (m >= p.M) continue;
      const long long o = (long long)m * p.N + n;
      if (p.split == 1) skt::store1(p.out, p.out_kind, o, facc[j] * ld_scale(p.as, p.as_kind, m) * wn);
      else part[o] = __float_as_int(facc[j]);
    }
  }
}

template <int BM>
__global__ void __launch_bounds__(kThreads, Cfg<BM>::kPerSM) qserve_kernel(const __grid_constant__ KParams kp) {
  using C = Cfg<BM>;
  constexpr int S = C::S;
  const Params& p = kp.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring_w = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ring_a = ring_w + S * C::W_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_a + S * 2 * C::A_BOX);
  uint64_t* empty = full + S;
  int* flags = reinterpret_cast<int*>(empty + S);

  // row tiles of one weight tile side by side, so they read its codes from L2
  const int m_tiles = (p.M + BM - 1) / BM, tile = blockIdx.x;
  const int m0 = (tile % m_tiles) * BM, n0 = (tile / m_tiles) * kBN;
  const int t0 = blockIdx.y * p.tiles_per_split;
  const int n_k = min((p.K + kBK - 1) / kBK, t0 + p.tiles_per_split) - t0;
  const int n_ring = p.force_exact ? 0 : n_k;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      skt::mbar_init(&full[s], 1);                // the producer's expect_tx
      skt::mbar_init(&empty[s], kCThreads / 32);  // each consumer warp, once its wgmmas on the stage completed
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  const int n_groups = p.K >> p.gsh;
  if (warp == kCThreads / 32) {
    // Producer: k-tile t0 + i into stage i % S once every consumer warp has
    // released the stage's last use; a box wholly past K is not fetched
    // (its codes meet zero scales there: W8 = 0 whatever the stage held).
    if (lane == 0)
      for (int i = 0; i < n_ring; ++i) {
        const int s = i % S, k = (t0 + i) * kBK;
        const bool hi = k + kBox < p.K;
        if (i >= S) skt::mbar_wait(&empty[s], ((i / S) - 1) & 1);
        skt::mbar_expect_tx(&full[s], hi ? C::STAGE : C::STAGE / 2);
        uint8_t* wst = ring_w + s * C::W_BYTES;
        uint8_t* ast = ring_a + s * 2 * C::A_BOX;
        skt::tma_load_2d(wst, &kp.tm_w, k, n0, &full[s]);
        skt::tma_load_2d(ast, &kp.tm_a, k, m0, &full[s]);
        if (hi) {
          skt::tma_load_2d(wst + kWBox, &kp.tm_w, k + kBox, n0, &full[s]);
          skt::tma_load_2d(ast + C::A_BOX, &kp.tm_a, k + kBox, m0, &full[s]);
        }
      }
    return;
  }

  // Consumers: warp w holds tile rows 16w .. 16w + 15 (warpgroup w / 4's
  // wgmma rows 16 (w % 4) ..), every activation row of the tile as wgmma's N;
  // lane (g, t) makes rows g and g + 8 of them, k 4t .. 4t+3 and 16+4t ..
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  const int nrow[2] = {n0 + r0, n0 + r0 + 8};
  uint32_t acc[BM / 2];
#pragma unroll
  for (int x = 0; x < BM / 2; ++x) acc[x] = 0u;
  uint32_t fr[2][4][4];  // [box parity][k32 slab][register]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int x = 0; x < 4; ++x) fr[h][q][x] = 0u;
  uint32_t bad = 0u, cs[2] = {0u, 0u}, cz[2] = {0u, 0u};
  // Lane t of a quad reads one of its rows' four group scales (s2 of row
  // r0, zs2 of r0, s2 of r0 + 8, zs2 of r0 + 8) a group ahead of its use
  // and makes that quarter of the constants; the quad shares them.
  // The lane reads the aligned word holding its value (it never leaves the
  // tensor's 512-byte allocation granule) two groups ahead, and decodes it
  // by selects: the quad's lanes read tensors of other types without
  // diverging.
  const bool is_z = t & 1;
  const int my_row = (t & 2) ? nrow[1] : nrow[0];
  const int my_kind = is_z ? p.z_kind : p.s_kind, my_shift = my_kind == kI8 ? 0 : (my_kind == kF32 ? 2 : 1);
  const uint8_t* my_row_p =
      reinterpret_cast<const uint8_t*>(is_z ? p.zs2 : p.s2) + ((long long)my_row * n_groups << my_shift);
  auto load_word = [&](int k) -> uint32_t {  // its value's bits at bit 0; zero past N or K
    if (my_row >= p.N || k >= p.K) return 0u;
    const uintptr_t a = reinterpret_cast<uintptr_t>(my_row_p + ((long long)(k >> p.gsh) << my_shift));
    return __ldg(reinterpret_cast<const unsigned int*>(a & ~(uintptr_t)3)) >> (8 * (a & 3));
  };
  uint32_t nw0 = 0u, nw1 = 0u;  // the next two groups' words
  if (n_ring > 0) {
    nw0 = load_word(t0 * kBK);
    nw1 = load_word(t0 * kBK + p.G);
  }
  const uint8_t* wrow = ring_w + r0 * kBox + 4 * t;  // row r0 of stage 0's first box; row r0 + 8 is 8 rows on
  const uint32_t a_base = skt::smem_u32(ring_a);
  for (int i = 0; i < n_ring; ++i) {
    const int s = i % S, k0 = (t0 + i) * kBK;
    skt::mbar_wait(&full[s], (i / S) & 1);
    const uint8_t* wst = wrow + s * C::W_BYTES;
    const uint32_t a_s = a_base + s * 2 * C::A_BOX;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // box h: its four k32 slabs' fragments, then their four wgmmas
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int kk = 4 * h + q;
        if (kk == 0 || ((32 * kk) & (p.G - 1)) == 0) {  // a new group: its two rows' constants, then the next's load
          const float raw = decode_scale(nw0, my_kind);
          nw0 = nw1;
          nw1 = load_word(k0 + 32 * kk + 2 * p.G);
          const uint32_t part = fast_part(raw, is_z), base = lane & ~3;
          cs[0] = __shfl_sync(0xffffffffu, part, base);
          cz[0] = __shfl_sync(0xffffffffu, part, base + 1);
          cs[1] = __shfl_sync(0xffffffffu, part, base + 2);
          cz[1] = __shfl_sync(0xffffffffu, part, base + 3);
          // a group not of the fast form sends the block to the exact route
          bad |= (cs[0] | cz[0] | cs[1] | cz[1]) & kSlow;
          cz[0] *= 0x10001u;
          cz[1] *= 0x10001u;
        }
        const uint8_t* w0 = wst + h * kWBox;
        const uint8_t* w1 = w0 + 8 * kBox;
        const int c0 = ((2 * q) ^ g) << 4, c1 = ((2 * q + 1) ^ g) << 4;  // the swizzled 16-byte chunks
        const uint32_t x0 = *reinterpret_cast<const uint32_t*>(w0 + c0), x1 = *reinterpret_cast<const uint32_t*>(w1 + c0);
        const uint32_t x2 = *reinterpret_cast<const uint32_t*>(w0 + c1), x3 = *reinterpret_cast<const uint32_t*>(w1 + c1);
        uint32_t(&f)[4] = fr[h][q];
        f[0] = w8x4_fast(x0, cs[0], cz[0], bad);
        f[1] = w8x4_fast(x1, cs[1], cz[1], bad);
        f[2] = w8x4_fast(x2, cs[0], cz[0], bad);
        f[3] = w8x4_fast(x3, cs[1], cz[1], bad);
      }
      issue<BM>(acc, fr[h], a_s + h * C::A_BOX);
      skt::wgmma_wait<1>();  // the previous box's wgmmas have completed: its fragments and (h 0) its stage are free
      skt::fence_regs(acc);
#pragma unroll
      for (int q = 0; q < 4; ++q) skt::fence_regs(fr[h ^ 1][q]);
      if (h == 0 && i > 0) {
        __syncwarp();
        if (lane == 0) skt::mbar_arrive(&empty[(i - 1) % S]);
      }
    }
  }
  skt::wgmma_wait<0>();
  skt::fence_regs(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 4; ++q) skt::fence_regs(fr[h][q]);

  // the block's route: int8 unless a consumer made a W8 that is not an int8
  const bool exact = p.force_exact || skt::named_sync_or(1, kCThreads, (bad & 0xFF00FF00u) != 0u);
  int* part = p.part + (long long)blockIdx.y * p.M * p.N;
  if (exact) {
    if (tid == 0) atomicAdd(p.exact_blocks, 1);
    // a weight row and half the activation rows a thread
    exact_rows<BM>(p, n0 + (tid & (kBN - 1)), m0 + (tid / kBN) * (BM / 2), t0 * kBK, min(p.K, (t0 + n_k) * kBK),
                   part);
  } else {
    // acc[4j + e]: weight row r0 + 8 (e >> 1), activation row 8j + 2t + (e & 1)
    float wn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) wn[h] = nrow[h] < p.N ? ld_scale(p.ws, p.ws_kind, nrow[h]) : 0.f;
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int m = m0 + 8 * j + 2 * t + x;
        if (m >= p.M) continue;
        const float am = p.split == 1 ? ld_scale(p.as, p.as_kind, m) : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (nrow[h] >= p.N) continue;
          const long long o = (long long)m * p.N + nrow[h];
          const int v = (int)acc[4 * j + 2 * h + x];
          if (p.split == 1) skt::store1(p.out, p.out_kind, o, (float)v * am * wn[h]);
          else atomicAdd(p.sums + o, v);  // exact, so the sum's bits do not depend on the order
        }
      }
  }
  if (p.split == 1) return;

  // split K: the last block of the tile to arrive sums every split's partial
  __threadfence();
  skt::named_sync(1, kCThreads);
  int* routes = p.routes + (long long)tile * p.split;
  if (tid == 0) {
    routes[blockIdx.y] = exact ? 1 : 0;
    __threadfence();
    const int last = atomicAdd(p.counters + tile, 1) == p.split - 1;
    int mixed = 0;
    if (last) {
      __threadfence();
      for (int z = 0; z < p.split; ++z) mixed |= __ldcg(routes + z);
    }
    flags[0] = last;
    flags[1] = mixed;
  }
  skt::named_sync(1, kCThreads);
  if (!flags[0]) return;
  __threadfence();
  const bool mixed = flags[1] != 0;
  const long long mn = (long long)p.M * p.N;
#pragma unroll 4
  for (int idx = tid; idx < kBN * BM; idx += kCThreads) {
    const int n = n0 + (idx & (kBN - 1)), m = m0 + idx / kBN;
    if (n >= p.N || m >= p.M) continue;
    const long long o = (long long)m * p.N + n;
    float v = (float)__ldcg(p.sums + o);  // the int8 route's splits, summed exactly
    p.sums[o] = 0;                          // ready for the next call
    if (mixed)  // the exact route's, in split order
      for (int z = 0; z < p.split; ++z)
        if (__ldcg(routes + z)) v += __int_as_float(__ldcg(p.part + z * mn + o));
    skt::store1(p.out, p.out_kind, o, v * ld_scale(p.as, p.as_kind, m) * ld_scale(p.ws, p.ws_kind, n));
  }
  if (tid == 0) p.counters[tile] = 0;  // ready for the next call
}

template <int BM>
cudaError_t launch(const Params& p, cudaStream_t st) {
  using C = Cfg<BM>;
  KParams kp;
  if (!skt::map_2d(&kp.tm_w, p.w, 1, p.N, p.K, p.K, kBox, kBN, true) ||
      !skt::map_2d(&kp.tm_a, p.a, 1, p.M, p.K, p.K, kBox, BM, true))
    return cudaErrorInvalidValue;
  kp.p = p;
  auto kernel = qserve_kernel<BM>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long tiles = (long long)((p.M + BM - 1) / BM) * ((p.N + kBN - 1) / kBN);
  if (tiles > 0x7fffffffLL || p.split > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, (unsigned)p.split), kThreads, C::SMEM, st>>>(kp);
  return cudaGetLastError();
}

}  // namespace

// a [M, K] int8; w [N, K] uint8 codes (both 16-byte aligned); s2 / zs2 [N,
// K/G], wscales [N], ascales [M] of element types s_kind, z_kind, ws_kind,
// as_kind (0 int8, 1 f16, 2 bf16, 3 float32); out [M, N] (out_kind 0 bf16, 1
// f16, 2 float32). G 32, 64 or 128 dividing K; block_rows (16, 32, 64 or
// 128) the row tile. K splits over `split` blocks of tiles_per_split
// 256-deep k-tiles, every split non-empty; with split > 1, part holds split
// x M x N ints, sums M x N ints and counters one int a tile, both zero (the
// kernel leaves them so), and routes split ints a tile. exact_blocks (one int) gains the blocks that
// took the exact route. Returns cudaGetLastError().
extern "C" int skt_qserve_w4a8_per_group(const void* a, const void* w, const void* s2, const void* zs2,
                                         const void* wscales, const void* ascales, void* out, void* part, void* sums,
                                         void* counters, void* routes, void* exact_blocks, int M, int N, int K, int G,
                                         int s_kind, int z_kind, int ws_kind, int as_kind, int block_rows,
                                         int out_kind, int split, int tiles_per_split, void* stream) {
  const int k_tiles = (K + kBK - 1) / kBK;
  if (M < 1 || N < 1 || K < 1 || (G != 32 && G != 64 && G != 128) || K % G || split < 1 || tiles_per_split < 1 ||
      (long long)split * tiles_per_split < k_tiles || (long long)(split - 1) * tiles_per_split >= k_tiles ||
      exact_blocks == nullptr ||
      (split > 1 && (part == nullptr || sums == nullptr || counters == nullptr || routes == nullptr)))
    return (int)cudaErrorInvalidValue;
  for (const int kind : {s_kind, z_kind, ws_kind, as_kind})
    if (kind < kI8 || kind > kF32) return (int)cudaErrorInvalidValue;
  Params p{};
  p.a = (const int8_t*)a;
  p.w = (const uint8_t*)w;
  p.s2 = s2;
  p.zs2 = zs2;
  p.ws = wscales;
  p.as = ascales;
  p.out = out;
  p.part = (int*)part;
  p.sums = (int*)sums;
  p.counters = (int*)counters;
  p.routes = (int*)routes;
  p.exact_blocks = (int*)exact_blocks;
  p.M = M, p.N = N, p.K = K, p.G = G, p.gsh = G == 32 ? 5 : (G == 64 ? 6 : 7);
  p.s_kind = s_kind, p.z_kind = z_kind, p.ws_kind = ws_kind, p.as_kind = as_kind, p.out_kind = out_kind;
  p.split = split, p.tiles_per_split = tiles_per_split;
  p.force_exact = K >= (1 << 17);  // an int32 sum of K products of 2^14 could overflow
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_rows) {
    case 16: return (int)launch<16>(p, st);
    case 32: return (int)launch<32>(p, st);
    case 64: return (int)launch<64>(p, st);
    case 128: return (int)launch<128>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile of a launch at block_rows (16, 32, 64 or 128), for the host's
// split plan: out[0] weight rows a block, out[1] k of a stage, out[2]
// blocks an SM holds. Returns cudaErrorInvalidValue for other row tiles.
extern "C" int skt_qserve_tile(int block_rows, int* out) {
  int per_sm;
  switch (block_rows) {
    case 16: per_sm = Cfg<16>::kPerSM; break;
    case 32: per_sm = Cfg<32>::kPerSM; break;
    case 64: per_sm = Cfg<64>::kPerSM; break;
    case 128: per_sm = Cfg<128>::kPerSM; break;
    default: return (int)cudaErrorInvalidValue;
  }
  out[0] = kBN, out[1] = kBK, out[2] = per_sm;
  return 0;
}
