// K17 / K18: blockwise-scaled fp8 GEMM (DeepSeek 1x128 activation and
// 128x128 weight scale blocks), dense and grouped over experts.
//
// Replaces fp8_blockwise_scaled_mm (sgl_kernel_tpu/ops/gemm/blockwise_fp8.py:268,
// Pallas kernel _kernel :220, pallas_call at :310) and
// fp8_blockwise_scaled_grouped_mm (:362, _grouped_kernel :336, pallas_call at
// :403). Contract: A [M, K] e4m3 (row stride lda), B [K, N] e4m3 (N
// contiguous) or a bank [E, K, N] with one expert per row block of
// block_rows rows (expert_ids [M / block_rows]; an id outside [0, E) reads
// its nearest expert); sa [M, K/128] float32; sb [K/128, sb_ld] float32 (or
// [E, K/128, sb_ld]), the scale of column n being sb[g, n / sb_div] * sb_mul
// (compact: sb_div 128, sb_mul 1; the TPU's prepared rows: sb_div 1, sb_mul
// 2^-120). K and N multiples of 128.
//
//   out[m, n] = sum_g (A[m, g] @ B[g, n]) * (sa[m, g] * sb(g, n))
//
// over the 128-deep scale groups g, in float32, rounded once to bf16, f16 or
// float32. Every row block is computed: the TPU kernel has no valid-block
// count.
//
// Bound: bytes at decode, operations at prefill. A DeepSeek-V3 decode step's
// shared-expert gate_up at M=16 streams 29.4 MB of B for 0.94 GFLOP; at
// M=1,024 it does 60 GFLOP over ~37 MB. K18's routed gate_up streams the
// experts a batch hits (29.4 MB each); at a 1,024-token prefill (bm 128) it
// computes 40,704 rows, 2.39 TFLOP, over the whole 7.5 GB bank.
//
// Design. fp8 wgmma reads both operands K-major (it has no transpose form
// for 1-byte types), and B lies with N contiguous, so the tile computes
// out^T = B^T A^T at every row tile: the weights are wgmma's M (64 columns
// a consumer warpgroup) and come from registers; the activation rows are
// wgmma's N (BM = 16, 32, 64 or 128 tokens, the row tile) and are read from
// shared memory by descriptor, K-major as they lie. No tensor work pads a
// 16-row decode tile up to 64, and no transposed copy of a stage is
// written. A block is BN = 64 x NWG columns by BM rows over a range of
// 128-deep scale groups, one group a stage: BN 256 (four consumer
// warpgroups) at BM 16 / 32, BN 128 (two) at BM 64 / 128, where the two
// float32 accumulators of 64 x 128 a warpgroup take 128 registers a thread.
//
// One producer warp keeps a ring of up to six stages full behind mbarriers:
// B's [128 k][BN] slice as BN / 128 TMA boxes of 128 bytes x 128 k-rows side
// by side (256-byte runs a k-row at BN 256) through a 3-D map over [E, K,
// N] with the expert as a coordinate, A's [BM][128] rows as one box of a 2-D
// map (rows past M zero-filled), both with the 128-byte swizzle and encoded
// once per (pointer, shape) (tma_map.cuh). Every 32 groups it brings the
// next 32 groups' row scales, sa[m0 .. m0 + BM, g ..], a row's run by one
// bulk copy on the same barrier (by 4-byte cp.async, each lane signalling
// the barrier, where K/128 or the split is not a multiple of 4), into one
// of two chunks; a thread reads its two columns' scales from device memory
// a group ahead.
//
// Weight fragments. ldmatrix.x4.trans over 16-bit column pairs gives lane
// (g, t) k-rows 2t and 2t+1 of columns 2g and 2g+1 from each 8x8 matrix.
// The lanes' row addresses pick which k-rows a matrix holds: X rows k {0, 1,
// 4, 5, 10, 11, 14, 15}, Y rows {2, 3, 6, 7, 8, 9, 12, 13} (and both + 16),
// so lane t's X and Y together hold k 4t .. 4t+3, natural order, as the
// descriptor-read operand expects; the eight rows of a matrix are distinct
// mod 8, so the swizzled reads are free of bank conflicts. Two byte permutes
// a pair split them into column 2g's run (wgmma row g) and column 2g+1's
// (row g + 8); the store undoes that order of rows.
//
// Promotion (DeepSeek-V3's report: Hopper's fp8 MMA keeps ~14 bits in its
// running sum). Every k32 wgmma runs into its own partial (scale-d 0),
// which is added into the float32 result with sa[m, g] * sb(g, n) once the
// wgmma has completed. DeepSeek promotes every 128 k; on this card, partials
// chained over two or four k32 wgmmas missed chip_smoke.py's element-wise
// gate (2^-7 of |ref| and 2^-12 of the row's largest) against the float32
// plain version on uniformly drawn e4m3 codes, where one step a partial
// meets it as the parent's mma.sync did. Up to four partials are in flight
// a warpgroup (fewer where registers bind), and the consumer warpgroups
// interleave on the tensor cores.
//
// Order. Blocks walk an expert-aware raster (groups of 8 row tiles down each
// column tile), so the row tiles of one expert, consecutive in the sorted
// rows, read each slice of its bank at about the same time. Where the tiles
// cannot fill the SMs, K splits across blocks in whole groups (blockIdx.y):
// each block writes its float32 partial to a kept workspace, and the last
// block of a tile to arrive (a counter it resets to zero) sums the partials
// in split order and stores them. A call is one launch, the same bits call
// after call. ops/gemm/blockwise_fp8.py's work_order and split_plan are the
// raster and the split in plain Python.
//
// What holds it (H100, variants of this file timed in turns): at 128 rows
// the consumers, a group costing them well over the stage's stream alone:
// four wgmma / wait / promote rounds in series a group (a second 64-
// register partial does not fit), and with the rows as wgmma's N each
// thread's 64 accumulators span 32 rows, so a promotion needs a product of
// two scales an element (the non-transposed tile would need two a thread).
// At 16 rows the stream holds it.

#include "gemm_out.cuh"
#include "tma_map.cuh"

namespace {

constexpr int kGroup = 128;               // k of a scale group: one stage
constexpr int kBox = 128;                 // columns of a B box: 128 bytes, the swizzle's span
constexpr int kBoxBytes = kGroup * kBox;  // a box: 128 k-rows of 128 bytes
constexpr int kGroupRows = 8;             // row tiles a raster group walks down each column tile
constexpr int kChunk = 32;                // groups of row scales a chunk holds
constexpr int kSaPitch = 4 * kChunk + 16;  // bytes between a chunk's rows: conflict-free reads
constexpr int kMaxSmem = 232448;          // dynamic shared memory a block may take

struct Params {
  const float* sa;        // [M, K/128]
  const float* sb;        // [K/128, sb_ld] (+ expert * sb_estride)
  const int* expert_ids;  // [M / block_rows] or null
  void* out;              // [M, N]
  float* ws;              // [split, M, N] float32 partials when split > 1
  int* counters;          // [tiles] arrivals, zero between calls
  long long sb_estride;
  int M, N, K, n_experts, sb_ld, sb_div, out_kind, split, groups_per_split;
  int sa_bulk;  // sa's chunk rows come by bulk copies (16-byte aligned runs), else by cp.async
  float sb_mul;
};

struct alignas(64) KParams {
  CUtensorMap tm_a;   // A [M][lda] bytes: boxes of 128 k x BM rows, 128-byte swizzle
  CUtensorMap tm_b;   // B [E][K][N] bytes: boxes of 128 n x 128 k x 1 expert, 128-byte swizzle
  Params p;
};

// BM rows, NWG consumer warpgroups of 64 columns and a producer warp. A
// stage is B's BN / 128 boxes then A's [BM][128] box; after the ring, two
// chunks of row scales ([BM][32] float32, rows kSaPitch bytes apart), S
// "full" and S "empty" barriers and the last-block flag.
template <int BM, int NWG>
struct Cfg {
  static constexpr int BN = 64 * NWG, kBoxes = BN / kBox;
  static constexpr int kCThreads = 128 * NWG, kThreads = kCThreads + 32;
  static constexpr int B_BYTES = kBoxes * kBoxBytes, A_BYTES = BM * kGroup, SA_BYTES = BM * kSaPitch;
  static constexpr int STAGE = B_BYTES + A_BYTES;
  static constexpr int kFit = (kMaxSmem - 1024 - 2 * SA_BYTES - 256) / STAGE;
  static constexpr int S = kFit < 6 ? kFit : 6;
  static constexpr int SMEM = 1024 + S * STAGE + 2 * SA_BYTES + 2 * S * 8 + 16;  // + slack to a 1024-byte boundary
  static_assert(BN % kBox == 0 && S >= 2 && SMEM <= kMaxSmem, "tile shape");
};

// The warp's weight fragments of one stage: four k32 steps of its 16
// columns (module comment); src is the lane's row of the first step.
__device__ __forceinline__ void load_frags(uint32_t (&f)[4][4], const uint8_t* src, uint32_t sel_e, uint32_t sel_o) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t x[4];  // X and Y of k 0..15, then of k 16..31
    skt::ldsm_x4_trans(x, src + kk * 32 * 128);
    f[kk][0] = __byte_perm(x[0], x[1], sel_e);
    f[kk][1] = __byte_perm(x[0], x[1], sel_o);
    f[kk][2] = __byte_perm(x[2], x[3], sel_e);
    f[kk][3] = __byte_perm(x[2], x[3], sel_o);
  }
}

// One k32 wgmma, fragments f against N activation rows at a_addr, into
// part, which it overwrites (scale-d 0): one commit group.
template <int N>
__device__ __forceinline__ void issue(float (&part)[N / 2], uint32_t (&f)[4], uint32_t a_addr) {
  skt::fence_regs(f);
  skt::fence_regs(part);
  skt::wgmma_fence();
  skt::wgmma_e4m3_rs<N>(part, f, skt::wgmma_desc(a_addr, 16, 1024), 0);
  skt::wgmma_commit();
}

// until at most n (0..3, a constant once unrolled) wgmma groups are in flight
__device__ __forceinline__ void wgmma_wait_n(int n) {
  if (n >= 3) skt::wgmma_wait<3>();
  else if (n == 2) skt::wgmma_wait<2>();
  else if (n == 1) skt::wgmma_wait<1>();
  else skt::wgmma_wait<0>();
}

// acc += part * (sa * sb): part[4j + e] is column 2g + (e >> 1) of the
// warp's pair, row 8j + 2t + (e & 1) of the N; sar points at row 2t's scale
// of the group, se / so are the two columns' scales.
template <int N, bool kSame>
__device__ __forceinline__ void promote(float (&acc)[N / 2], float (&part)[N / 2], const uint8_t* sar, float se,
                                        float so) {
  skt::fence_regs(part);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float sa0 = *reinterpret_cast<const float*>(sar + 8 * j * kSaPitch);
    const float sa1 = *reinterpret_cast<const float*>(sar + (8 * j + 1) * kSaPitch);
    const float e0 = sa0 * se, e1 = sa1 * se;
    acc[4 * j] = fmaf(part[4 * j], e0, acc[4 * j]);
    acc[4 * j + 1] = fmaf(part[4 * j + 1], e1, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(part[4 * j + 2], kSame ? e0 : sa0 * so, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(part[4 * j + 3], kSame ? e1 : sa1 * so, acc[4 * j + 3]);
  }
}

template <int BM, int NWG>
__global__ void __launch_bounds__(Cfg<BM, NWG>::kThreads, 1) blockwise_fp8_kernel(const __grid_constant__ KParams kp) {
  using C = Cfg<BM, NWG>;
  constexpr int S = C::S, BN = C::BN;
  const Params& p = kp.p;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* ring_b = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* ring_a = ring_b + S * C::B_BYTES;
  uint8_t* sa_ring = ring_a + S * C::A_BYTES;  // two chunks of row scales
  uint64_t* full = reinterpret_cast<uint64_t*>(sa_ring + 2 * C::SA_BYTES);
  uint64_t* empty = full + S;
  int* last = reinterpret_cast<int*>(empty + S);

  // the raster: blockIdx.x -> (row tile, column tile)
  const int m_tiles = (p.M + BM - 1) / BM, n_tiles = (p.N + BN - 1) / BN;
  const int span = kGroupRows * n_tiles, first = (blockIdx.x / span) * kGroupRows;
  const int rows = min(kGroupRows, m_tiles - first), in = blockIdx.x % span;
  const int mt = first + in % rows, nt = in / rows;
  const int m0 = mt * BM, n0 = nt * BN;
  const int n_groups = p.K / kGroup, g0 = blockIdx.y * p.groups_per_split;
  const int n_k = min(n_groups, g0 + p.groups_per_split) - g0;
  const int e = p.expert_ids == nullptr ? 0 : min(max(p.expert_ids[mt], 0), p.n_experts - 1);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // the producer's expect_tx, and each lane's cp.async arrival where the row scales come that way
      skt::mbar_init(&full[s], p.sa_bulk ? 1 : 1 + 32);
      skt::mbar_init(&empty[s], 4 * NWG);  // each consumer warp, once the group's wgmmas have completed
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * NWG) {
    // Producer: group g0 + i into stage i % S once every consumer warp has
    // released the stage's last use; every kChunk groups, their row scales
    // into the other chunk (whose groups the consumers have finished: the
    // stage released last is at most S < kChunk groups back), a row's run
    // of groups a copy; rows past M read the last row's scales (their
    // outputs are never stored).
    for (int i = 0; i < n_k; ++i) {
      const int s = i % S, grp = g0 + i;
      const bool chunk = i % kChunk == 0;
      uint8_t* sa_dst = sa_ring + ((i / kChunk) & 1) * C::SA_BYTES;
      if (i >= S) skt::mbar_wait(&empty[s], ((i / S) - 1) & 1);
      // a chunk's run: whole 16-byte pieces (sa_bulk: K/128 and the split a multiple of 4)
      const uint32_t run = 16 * ((min(kChunk, n_k - i) + 3) / 4);
      if (lane == 0) {
        skt::mbar_expect_tx(&full[s], C::STAGE + (chunk && p.sa_bulk ? BM * run : 0));
#pragma unroll
        for (int bx = 0; bx < C::kBoxes; ++bx)
          skt::tma_load_3d(ring_b + s * C::B_BYTES + bx * kBoxBytes, &kp.tm_b, n0 + bx * kBox, grp * kGroup, e,
                           &full[s]);
        skt::tma_load_2d(ring_a + s * C::A_BYTES, &kp.tm_a, grp * kGroup, m0, &full[s]);
      }
      if (p.sa_bulk) {
        __syncwarp();  // the expect_tx first
        if (chunk)
          for (int r = lane; r < BM; r += 32)
            skt::bulk_load(sa_dst + r * kSaPitch, p.sa + (long long)min(m0 + r, p.M - 1) * n_groups + grp, run,
                           &full[s]);
      } else {
        if (chunk && lane < kChunk && i + lane < n_k)
          for (int r = 0; r < BM; ++r)
            skt::cp_async4(sa_dst + r * kSaPitch + 4 * lane,
                           p.sa + (long long)min(m0 + r, p.M - 1) * n_groups + grp + lane);
        skt::cp_async_mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // Consumers: warp w holds columns cb .. cb + 15 of the tile (warpgroup
  // w / 4's wgmma rows 16 (w % 4) ..), every row of the tile as wgmma's N.
  const int g = lane >> 2, t = lane & 3, cb = 16 * warp;
  // this lane's ldmatrix row: matrix lane / 8 (X, Y, X + 16, Y + 16), row lane % 8
  const int mi = lane >> 3, r = lane & 7, th = r >> 1;
  const int kl = 4 * th + (r & 1) + (((mi & 1) == 0) == (th >= 2) ? 2 : 0) + 16 * (mi >> 1);
  const int frag_off = (cb / kBox) * kBoxBytes + kl * 128 + ((((cb % kBox) >> 4) ^ (kl & 7)) << 4);
  const uint32_t sel_e = t < 2 ? 0x6420u : 0x2064u, sel_o = t < 2 ? 0x7531u : 0x3175u;
  const uint32_t a_base = skt::smem_u32(ring_a);
  // this thread's two columns' scales, read straight from device memory a
  // group ahead (columns past N read the last one's): the even column's,
  // then the odd one's sb_odd entries on
  const int col_e = min(n0 + cb + 2 * g, p.N - 1);
  const float* sb_e = p.sb + e * p.sb_estride + col_e / p.sb_div;
  const int sb_odd = min(col_e + 1, p.N - 1) / p.sb_div - col_e / p.sb_div;

  // NB partials in flight a warpgroup, one a k32 step: while one is
  // promoted the next steps' wgmmas run. kAhead: the next group's
  // fragments are loaded while this group's wgmmas run. Each as far as the
  // registers allow without a spill (a register an asynchronous wgmma uses
  // must never spill): 96 a thread at 544 threads, 168 at 288, where two
  // 64 x 128 accumulators take 128.
  constexpr bool kAhead = BM == 64;
  constexpr int NB = BM == 16 ? 4 : (BM == 64 ? 2 : 1);
  float acc[BM / 2], part[NB][BM / 2];
#pragma unroll
  for (int x = 0; x < BM / 2; ++x) acc[x] = 0.f;
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int x = 0; x < BM / 2; ++x) part[b][x] = 0.f;
  uint32_t cur[4][4], nxt[4][4];
  float sbe = __ldg(sb_e + (long long)g0 * p.sb_ld), sbo = __ldg(sb_e + (long long)g0 * p.sb_ld + sb_odd);
  skt::mbar_wait(&full[0], 0);
  load_frags(cur, ring_b + frag_off, sel_e, sel_o);
  for (int i = 0; i < n_k; ++i) {
    const int s = i % S, s1 = (i + 1) % S;
    const uint32_t a_s = a_base + s * C::A_BYTES;  // 32 k a step: 32 bytes along the activation rows
#pragma unroll
    for (int b = 0; b < NB; ++b) issue<BM>(part[b], cur[b], a_s + b * 32);
    float nbe = 0.f, nbo = 0.f;
    if (i + 1 < n_k) {  // the next group's column scales (and fragments) while this group's wgmmas run
      const float* sbg = sb_e + (long long)(g0 + i + 1) * p.sb_ld;
      nbe = __ldg(sbg);
      nbo = __ldg(sbg + sb_odd);
      if (kAhead) {
        skt::mbar_wait(&full[s1], ((i + 1) / S) & 1);
        load_frags(nxt, ring_b + s1 * C::B_BYTES + frag_off, sel_e, sel_o);
      }
    }
    // row scales of group i: rows 8j + 2t (+1) of its chunk
    const uint8_t* sar = sa_ring + ((i / kChunk) & 1) * C::SA_BYTES + 2 * t * kSaPitch + 4 * (i % kChunk);
    const float se = sbe * p.sb_mul, so = sbo * p.sb_mul;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_wait_n(NB - 1 < 3 - kk ? NB - 1 : 3 - kk);  // step kk's partial is done
      if (sb_odd == 0)  // the compact form: both columns' scale is one entry
        promote<BM, true>(acc, part[kk % NB], sar, se, so);
      else
        promote<BM, false>(acc, part[kk % NB], sar, se, so);
      if (kk + NB < 4) issue<BM>(part[kk % NB], cur[kk + NB], a_s + (kk + NB) * 32);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) skt::fence_regs(cur[kk]);
    __syncwarp();
    if (lane == 0) skt::mbar_arrive(&empty[s]);
    sbe = nbe, sbo = nbo;
    if (kAhead) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) cur[kk][x] = nxt[kk][x];
    } else if (i + 1 < n_k) {
      skt::mbar_wait(&full[s1], ((i + 1) / S) & 1);
      load_frags(cur, ring_b + s1 * C::B_BYTES + frag_off, sel_e, sel_o);
    }
  }

  // N is a multiple of 128, so a warp's 16 columns are wholly in or out;
  // acc[4j + e]: row 8j + 2t + (e & 1), column col + (e >> 1)
  const bool cols_in = n0 + cb < p.N;
  const long long col = n0 + cb + 2 * g;
  if (p.split == 1) {
    if (cols_in)
#pragma unroll
      for (int j = 0; j < BM / 8; ++j)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int row = m0 + 8 * j + 2 * t + x;
          if (row < p.M) skt::store2(p.out, p.out_kind, row * (long long)p.N + col, acc[4 * j + x], acc[4 * j + 2 + x]);
        }
    return;
  }
  // split K: this block's partial, then the last block of the tile sums all
  float* ws = p.ws + (long long)blockIdx.y * p.M * p.N;
  if (cols_in)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = m0 + 8 * j + 2 * t + x;
        if (row < p.M)
          *reinterpret_cast<float2*>(ws + row * (long long)p.N + col) = make_float2(acc[4 * j + x], acc[4 * j + 2 + x]);
      }
  __threadfence();
  skt::named_sync(1, C::kCThreads);
  const int tile = mt * n_tiles + nt;
  if (tid == 0) *last = atomicAdd(p.counters + tile, 1) == p.split - 1;
  skt::named_sync(1, C::kCThreads);
  if (!*last) return;
  __threadfence();
  if (cols_in)
#pragma unroll
    for (int j = 0; j < BM / 8; ++j)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int row = m0 + 8 * j + 2 * t + x;
        if (row >= p.M) continue;
        float2 v = make_float2(0.f, 0.f);
        for (int z = 0; z < p.split; ++z) {
          const float2 w = __ldcg(reinterpret_cast<const float2*>(p.ws + ((long long)z * p.M + row) * p.N + col));
          v.x += w.x;
          v.y += w.y;
        }
        skt::store2(p.out, p.out_kind, row * (long long)p.N + col, v.x, v.y);
      }
  if (tid == 0) p.counters[tile] = 0;  // ready for the next call
}

template <int BM, int NWG>
cudaError_t launch(Params p, const void* a, int lda, const void* b, cudaStream_t st) {
  using C = Cfg<BM, NWG>;
  KParams kp;
  const long long kn = (long long)p.K * p.N;
  // every chunk's row run starts on a 16-byte boundary
  p.sa_bulk = (p.K / kGroup) % 4 == 0 && (p.split == 1 || p.groups_per_split % 4 == 0) &&
              reinterpret_cast<uintptr_t>(p.sa) % 16 == 0;
  if (!skt::map_2d(&kp.tm_a, a, 1, p.M, p.K, lda, kBox, BM, true) ||
      !skt::map_tiled(&kp.tm_b, b, 1, 3, {p.N, p.K, p.n_experts, 1}, {p.N, kn, kn * p.n_experts}, kBox, kGroup,
                      true))
    return cudaErrorInvalidValue;
  kp.p = p;
  auto kernel = blockwise_fp8_kernel<BM, NWG>;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long tiles = (long long)((p.M + BM - 1) / BM) * ((p.N + C::BN - 1) / C::BN);
  if (tiles > 0x7fffffffLL || p.split > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3((unsigned)tiles, (unsigned)p.split), C::kThreads, C::SMEM, st>>>(kp);
  return cudaGetLastError();
}

}  // namespace

// a [M, lda] e4m3 (lda a multiple of 16); b [K, N] e4m3, or the expert bank
// [E, K, N] (E = n_experts) with expert_ids [M / block_rows]; both with
// 16-byte aligned starts; sa [M, K/128] float32; sb [K/128, sb_ld] float32
// (sb_estride per expert), column n's scale sb[g, n / sb_div] * sb_mul; out
// [M, N] (out_kind 0 bf16, 1 f16, 2 float32). block_rows is the row tile: 16,
// 32, 64 or 128 (with expert_ids, the alignment block). K splits over
// `split` blocks of groups_per_split 128-deep groups; with split > 1, ws
// holds split x M x N floats and counters one int a tile, zero (the kernel
// leaves them so). K and N multiples of 128. Returns cudaGetLastError().
extern "C" int skt_fp8_blockwise_mm(const void* a, const void* b, const void* sa, const void* sb,
                                    const void* expert_ids, void* out, void* ws, void* counters, int M, int N, int K,
                                    int lda, long long sb_estride, int sb_ld, int sb_div, float sb_mul,
                                    int block_rows, int n_experts, int out_kind, int split, int groups_per_split,
                                    void* stream) {
  if (M < 1 || K % kGroup || N % kBox || lda % 16 || n_experts < 1 || split < 1 || groups_per_split < 1 ||
      (long long)split * groups_per_split < K / kGroup || (split > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (expert_ids != nullptr && M % block_rows) return (int)cudaErrorInvalidValue;
  Params p{};
  p.sa = (const float*)sa;
  p.sb = (const float*)sb;
  p.expert_ids = (const int*)expert_ids;
  p.out = out;
  p.ws = (float*)ws;
  p.counters = (int*)counters;
  p.sb_estride = sb_estride;
  p.M = M, p.N = N, p.K = K, p.n_experts = n_experts;
  p.sb_ld = sb_ld, p.sb_div = sb_div, p.sb_mul = sb_mul;
  p.out_kind = out_kind, p.split = split, p.groups_per_split = groups_per_split;
  cudaStream_t st = (cudaStream_t)stream;
  switch (block_rows) {
    case 16: return (int)launch<16, 4>(p, a, lda, b, st);
    case 32: return (int)launch<32, 4>(p, a, lda, b, st);
    case 64: return (int)launch<64, 2>(p, a, lda, b, st);
    case 128: return (int)launch<128, 2>(p, a, lda, b, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
