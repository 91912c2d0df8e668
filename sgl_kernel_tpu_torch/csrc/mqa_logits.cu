// K15: the NSA indexer's scores over a paged key cache,
//   logits[b, t] = sum_h w[b, h] * relu(q[b, h] . k[t]) * s[t],  -inf at t >= len[b].
//
// Replaces fp8_paged_mqa_logits (sgl_kernel_tpu/ops/attention/nsa.py:141,
// Pallas kernel _mqa_logits_kernel at :31, pallas_call at :222). Contract: q
// [B, H, 128] bf16 (H 1..128); keys [P, page, 128] of fp8 e4m3, fp8 e5m2 or
// bf16, any page size; weights [B, H] float32; scales [P, page] float32 or
// null; lengths [B]; page table [B, n_blocks]; out [B, n_blocks * page]
// float32, -inf at every t >= length across the table's full width.
//
// Numbers. JAX computes q . k from bf16 operands in float32. bf16 keys do
// that here. fp8 keys convert exactly to fp16 (every fp8 value is a half;
// denormals kept, not flushed as the TPU's upcast does, paged_decode_dma.py:
// 41-70) and q's bf16 values become halves (exactly for magnitudes from
// 2^-14 to 65,504), so their products are the same exact products, summed
// in float32.
//
// Bound: bytes. Each cached key is read once (128 B in fp8, plus its 4-byte
// scale) for 2 x H x 128 flops: at H = 64, ~124 flops a byte, below the
// card's ridge (~295 for bf16), but streaming at 3.35 TB/s needs ~415
// TFLOP/s of 16-bit products, which only wgmma reaches; every logit is
// written once, the -inf past the lengths too.
//
// Design. The work is cut into units of 64 keys of one sequence, counted on
// the device from the lengths (a prefix sum in shared memory, the lengths
// read once into it); the grid is sized on the host from the SM count and
// the blocks an SM holds, and each block takes an equal share of all units,
// so neither the lengths nor the table's capacity shape the launch. Every
// thread of the grid first writes its share of the -inf tail (t >= length)
// in a grid-stride pass. A producer warp keeps a four-stage ring of key rows
// in flight on mbarriers: TMA boxes of 128 bytes by a page (or a unit, or a
// row: box_rows divides the page and 64) through a 2-D map of the pool, with
// the 128-byte swizzle, so eight rows' same columns sit in eight banks; the
// keys' scales come beside them by 4-byte cp.async, whose completion each
// lane also signals on the stage's barrier. One consumer warpgroup (four
// warps) stages q (64 heads a tile, rows past H zero) and the gates once per
// run of one sequence's units. The scores are computed transposed, keys x
// heads, on wgmma m64n64k16 (eight k-steps over D = 128; H > 64 takes a
// second head tile, MT = 2): warp w loads its 16 keys' rows straight from
// the stage into registers as wgmma's A fragments, converting fp8 on the
// way (four consecutive dims a load, taken as k-positions 2t, 2t+1, 2t+8,
// 2t+9; q's dims are stored in that order), which frees the stage with no
// pass through shared memory, and B is a q tile, K-major in shared memory.
// With the keys as rows each thread holds two keys' 16 heads a tile: relu,
// the gates, the sum over its heads and over the four lanes that share the
// keys, the keys' scales, one float a key stored. A key row past the length
// only feeds its own row of scores, which is never stored.

#include <type_traits>

#include "common.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;

constexpr int kD = 128;          // indexer head dim
constexpr int kTok = 64;         // keys of a unit: wgmma's M
constexpr int kStages = 4;       // ring depth
constexpr int kCWarps = 4;       // one consumer warpgroup
constexpr int kCThreads = 32 * kCWarps;
constexpr int kThreads = kCThreads + 32;  // and one producer warp
constexpr int kSub = 64 * 128;   // bytes of a swizzled [64][64] 16-bit sub-tile
constexpr int kTile = 2 * kSub;  // a [64][128] 16-bit tile: a stage of bf16 keys, or a q tile

struct Args {
  const bf16* q;
  const float *weights, *scales;  // scales may be null
  const int *lengths, *table;
  float* out;
  int batch, n_heads, page, n_blocks, box_rows;
};

struct alignas(64) KArgs {
  CUtensorMap keys;  // [P * page rows][128], boxes of 128 bytes x box_rows, 128-byte swizzle
  Args a;
};

template <typename T, int MT>
struct Smem {
  static constexpr int kStage = kTok * kD * (int)sizeof(T);  // a unit's keys: 8 or 16 KB
  // 1 KB to align the tiles, q tiles, the ring, its scales, the gates,
  // barriers; then the prefix and the lengths
  static constexpr int kFixed = 1024 + MT * kTile + kStages * (kStage + kTok * 4) + MT * 64 * 4 + 2 * kStages * 8;
  static size_t bytes(int batch) { return kFixed + 4 * (size_t)(2 * batch + 1); }
};

// the sequence whose units [pre[i], pre[i + 1]) hold unit u
__device__ __forceinline__ int locate(const int* pre, int n_items, long long u) {
  int lo = 0, hi = n_items - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (pre[mid] <= u) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Key row r's four dims 16 kk + 4t .. + 3 from a swizzled stage, as the
// product's operands (fp8 as fp16 pairs, exactly; bf16 as they are): x is
// dims (4t, 4t + 1), y dims (4t + 2, 4t + 3). The A fragment of k-step kk
// takes them as k-positions (2t, 2t + 1) and (2t + 8, 2t + 9); q's dims are
// stored in the same order, so the sums are the same.
template <typename T>
__device__ __forceinline__ void key_pairs(const uint8_t* stage, int r, int kk, int t, uint32_t& x, uint32_t& y) {
  if constexpr (sizeof(T) == 2) {
    const int o = 32 * (kk % 4) + 8 * t;  // the bytes within the row's 128-byte sub-tile row
    const uint2 v = *reinterpret_cast<const uint2*>(stage + (kk / 4) * kSub + skt::sw128(r, o >> 4) + (o & 15));
    x = v.x, y = v.y;
  } else {
    constexpr __nv_fp8_interpretation_t kind = std::is_same<T, __nv_fp8_e5m2>::value ? __NV_E5M2 : __NV_E4M3;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(stage + skt::sw128(r, kk) + 4 * t);
    const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v & 0xffffu), kind);
    const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(v >> 16), kind);
    x = (uint32_t)lo.x | ((uint32_t)lo.y << 16);
    y = (uint32_t)hi.x | ((uint32_t)hi.y << 16);
  }
}

// three blocks an SM with one head tile (~50 KB of shared memory each for
// fp8 keys), two with two
template <typename T, int MT>
__global__ void __launch_bounds__(kThreads, MT == 1 ? 3 : 2) mqa_logits_kernel(const __grid_constant__ KArgs ka) {
  using L = Smem<T, MT>;
  constexpr bool kF16 = sizeof(T) == 1;  // fp8 keys: fp16 operands
  const Args& a = ka.a;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sq = smem;                     // MT tiles [64 heads][128], dims permuted as key_pairs takes them
  uint8_t* ring = sq + MT * kTile;        // kStages x a unit's keys
  float* sscale = reinterpret_cast<float*>(ring + kStages * L::kStage);  // kStages x [64]
  float* sw = sscale + kStages * kTok;    // [MT * 64] gates
  uint64_t* full = reinterpret_cast<uint64_t*>(sw + MT * 64);
  uint64_t* empty = full + kStages;
  int* pre = reinterpret_cast<int*>(empty + kStages);
  int* lens = pre + a.batch + 1;  // min(length, capacity), read once
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cap = a.n_blocks * a.page;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      skt::mbar_init(&full[s], 1 + 32);    // the producer's expect_tx and each lane's cp.async arrival
      skt::mbar_init(&empty[s], kCWarps);  // each consumer warp, once it has its keys in registers
    }
    skt::mbar_init_fence();
  }
  for (int b = tid; b < a.batch; b += kThreads) {
    const int n = max(0, min(a.lengths[b], cap));
    lens[b] = n;
    pre[b + 1] = (n + kTok - 1) / kTok;
  }
  __syncthreads();
  // the -inf tail of every sequence, a grid-stride share a thread
  const long long gt = (long long)blockIdx.x * kThreads + tid, gn = (long long)gridDim.x * kThreads;
  for (int b = 0; b < a.batch; ++b)
    for (long long t = lens[b] + gt; t < cap; t += gn) a.out[(long long)b * cap + t] = __int_as_float(0xff800000);
  if (warp == 0) {  // exclusive prefix of the unit counts: a chunk a lane, then a warp scan
    const int per = (a.batch + 31) / 32, i0 = min(a.batch, lane * per), i1 = min(a.batch, i0 + per);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += pre[i + 1];
    int inc = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    int run = inc - sum;
    for (int i = i0; i < i1; ++i) {
      run += pre[i + 1];
      pre[i + 1] = run;
    }
    if (lane == 0) pre[0] = 0;
  }
  __syncthreads();

  const long long U = pre[a.batch], NB = min((long long)gridDim.x, U);
  if (blockIdx.x >= NB) return;
  const long long u0 = U * blockIdx.x / NB, u1 = U * (blockIdx.x + 1) / NB;

  if (warp == kCWarps) {
    // Producer: each unit's keys into the next free stage by TMA, a box of
    // box_rows rows (a page, a unit, or a row: box_rows divides the page and
    // 64) issued by the lane of its first row, and each key's scale by
    // cp.async (rows lane and lane + 32). A box may run past the length
    // inside its page; those rows are read and never stored.
    constexpr int kBoxes = sizeof(T) == 2 ? 2 : 1;  // 128-byte boxes a row: bf16 rows are two
    const uint32_t box_bytes = (uint32_t)(a.box_rows * 128 * kBoxes);
    int b = locate(pre, a.batch, u0), k = 0;
    for (long long u = u0; u < u1; ++u) {
      while (u >= pre[b + 1]) ++b;
      const int j0 = (int)(u - pre[b]) * kTok, nv = min(kTok, lens[b] - j0);
      const int st = k % kStages;
      if (k >= kStages) skt::mbar_wait(&empty[st], ((k / kStages) - 1) & 1);
      ++k;
      if (lane == 0) skt::mbar_expect_tx(&full[st], (uint32_t)((nv + a.box_rows - 1) / a.box_rows) * box_bytes);
      __syncwarp();
      const int* pt = a.table + (long long)b * a.n_blocks;
      uint8_t* dst = ring + st * L::kStage;
      for (int r = lane; r < nv; r += 32) {
        const int key = j0 + r;
        const int slot = pt[key / a.page] * a.page + key % a.page;
        if (r % a.box_rows == 0)
#pragma unroll
          for (int h = 0; h < kBoxes; ++h) skt::tma_load_2d(dst + h * kSub + r * 128, &ka.keys, 64 * h, slot, &full[st]);
        if (a.scales != nullptr) skt::cp_async4(sscale + st * kTok + r, a.scales + slot);
      }
      skt::cp_async_mbar_arrive(&full[st]);
    }
    return;
  }

  // Consumers: one warpgroup; warp w's keys 16w .. 16w + 15 are the rows of
  // its part of wgmma's A, read from the stage straight into registers
  const int g = lane >> 2, t = lane & 3, r0 = 16 * warp + g;
  const uint32_t q_addr = skt::smem_u32(sq);
  int b = locate(pre, a.batch, u0), k = 0, staged = -1;
  float wr[MT][8][2];  // the gates of this thread's heads 64 m + 8 c + 2 t (+1)
  for (long long u = u0; u < u1; ++u) {
    while (u >= pre[b + 1]) ++b;
    if (b != staged) {  // a new sequence's run: q (rows past H zero, dims permuted) and the gates
      constexpr int N = MT * 64 * (kD / 16) / kCThreads;  // 16-dim pieces a thread
      const float gate = tid < MT * 64 && tid < a.n_heads ? a.weights[(long long)b * a.n_heads + tid] : 0.f;
      uint4 v[N][2];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = tid + j * kCThreads, r = i / (kD / 16), c = i % (kD / 16);
        const uint4* src = reinterpret_cast<const uint4*>(a.q + ((long long)b * a.n_heads + r) * kD + 16 * c);
        v[j][0] = r < a.n_heads ? src[0] : make_uint4(0u, 0u, 0u, 0u);
        v[j][1] = r < a.n_heads ? src[1] : make_uint4(0u, 0u, 0u, 0u);
      }
      if (staged >= 0) skt::named_sync(1, kCThreads);  // every warp's products of the last run are done
#pragma unroll
      for (int j = 0; j < N; ++j) {
        const int i = tid + j * kCThreads, r = i / (kD / 16), c = i % (kD / 16);
        // dim pairs (0,1) (2,3) .. (14,15) as words w0..w7 -> k-positions: w0 w2 w4 w6 | w1 w3 w5 w7
        const uint32_t* w = reinterpret_cast<const uint32_t*>(v[j]);
        uint32_t o[8] = {w[0], w[2], w[4], w[6], w[1], w[3], w[5], w[7]};
        if constexpr (kF16) {  // fp8 keys' product runs in fp16: q's bf16 values as halves
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const __half2 h = __float22half2_rn(__bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&o[e])));
            o[e] = *reinterpret_cast<const uint32_t*>(&h);
          }
        }
        uint8_t* row = sq + (r / 64) * kTile + (c / 4) * kSub;
        *reinterpret_cast<uint4*>(row + skt::sw128(r % 64, 2 * (c % 4))) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(row + skt::sw128(r % 64, 2 * (c % 4) + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
      }
      if (tid < MT * 64) sw[tid] = gate;
      skt::fence_proxy_async();
      skt::named_sync(1, kCThreads);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          wr[m][c][0] = sw[64 * m + 8 * c + 2 * t];
          wr[m][c][1] = sw[64 * m + 8 * c + 2 * t + 1];
        }
      staged = b;
    }
    const int j0 = (int)(u - pre[b]) * kTok, nv = min(kTok, lens[b] - j0);
    const int st = k % kStages;
    skt::mbar_wait(&full[st], (k / kStages) & 1);
    ++k;
    // the warp's A fragments: rows r0 and r0 + 8, eight k-steps
    const uint8_t* stage = ring + st * L::kStage;
    uint32_t af[kD / 16][4];
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) {
      key_pairs<T>(stage, r0, kk, t, af[kk][0], af[kk][2]);
      key_pairs<T>(stage, r0 + 8, kk, t, af[kk][1], af[kk][3]);
    }
    const bool scaled = a.scales != nullptr;
    const float sc0 = scaled ? sscale[st * kTok + r0] : 1.f, sc1 = scaled ? sscale[st * kTok + r0 + 8] : 1.f;
    __syncwarp();
    if (lane == 0) skt::mbar_arrive(&empty[st]);  // the warp's keys are in registers

    // scores transposed, [64 keys][64 heads] a head tile: A the keys from
    // registers, B a q tile, eight k-steps of 16 over D
    float acc[MT][32];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
      skt::fence_regs(acc[m]);
    }
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk) skt::fence_regs(af[kk]);
    skt::wgmma_fence();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint64_t db = skt::wgmma_desc(q_addr + m * kTile + (kk / 4) * kSub + (kk % 4) * 32, 16, 1024);
        skt::wgmma_m64n64k16_rs<kF16>(acc[m], af[kk], db, kk > 0);
      }
    skt::wgmma_commit();
    skt::wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MT; ++m) skt::fence_regs(acc[m]);

    // acc[m][4c + e]: key r0 + 8 (e >> 1), head 64 m + 8c + 2t + (e & 1).
    // relu, the gates, the thread's 16 heads a tile, then the 4 lanes (t)
    // that share the key
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s0 += wr[m][c][0] * fmaxf(acc[m][4 * c], 0.f) + wr[m][c][1] * fmaxf(acc[m][4 * c + 1], 0.f);
        s1 += wr[m][c][0] * fmaxf(acc[m][4 * c + 2], 0.f) + wr[m][c][1] * fmaxf(acc[m][4 * c + 3], 0.f);
      }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, o);
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    }
    float* orow = a.out + (long long)b * cap + j0;
    if (t == 0 && r0 < nv) orow[r0] = s0 * sc0;
    if (t == 1 && r0 + 8 < nv) orow[r0 + 8] = s1 * sc1;
  }
}

template <typename T, int MT>
cudaError_t launch(const Args& a, const void* keys, long long pool_rows, cudaStream_t stream) {
  using L = Smem<T, MT>;
  KArgs ka;
  ka.a = a;
  // 128-byte boxes (a fp8 row, or half a bf16 row) of box_rows rows, swizzled
  if (!skt::map_2d(&ka.keys, keys, (int)sizeof(T), pool_rows, kD, kD, 128 / (int)sizeof(T), a.box_rows, true))
    return cudaErrorInvalidValue;
  const size_t smem = L::bytes(a.batch);
  static size_t smem_set = 0;  // the dynamic shared memory the kernel may take so far
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(mqa_logits_kernel<T, MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = smem;
  }
  // as many blocks as the card holds at once (shared memory and registers)
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mqa_logits_kernel<T, MT>, kThreads, smem);
  if (err != cudaSuccess) return err;
  mqa_logits_kernel<T, MT><<<max(1, per_sm) * skt::sm_count(), kThreads, smem, stream>>>(ka);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_heads(const Args& a, const void* keys, long long pool_rows, cudaStream_t stream) {
  return a.n_heads <= 64 ? launch<T, 1>(a, keys, pool_rows, stream) : launch<T, 2>(a, keys, pool_rows, stream);
}

}  // namespace

// key_type 0 bf16, 2 fp8 e4m3, 3 fp8 e5m2; n_heads 1..128; scales may be
// null; keys [n_pages][page][128] 16-byte aligned; batch <= 4096 (the prefix
// lives in shared memory).
extern "C" int skt_fp8_paged_mqa_logits(const void* q, const void* keys, const void* weights, const void* scales,
                                        const void* lengths, const void* table, void* out, int batch, int n_heads,
                                        int n_pages, int page, int n_blocks, int key_type, void* stream) {
  if (n_heads < 1 || n_heads > 128 || page < 1 || batch > 4096) return (int)cudaErrorInvalidValue;
  if (batch == 0 || n_blocks == 0) return (int)cudaSuccess;
  // rows a TMA box: a unit (pages of 64 or more), a page (pages dividing 64), else a row
  const int box_rows = page % kTok == 0 ? kTok : (kTok % page == 0 ? page : 1);
  const Args a{(const bf16*)q, (const float*)weights, (const float*)scales, (const int*)lengths, (const int*)table,
               (float*)out, batch, n_heads, page, n_blocks, box_rows};
  const long long rows = (long long)n_pages * page;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (key_type) {
    case 0: return (int)dispatch_heads<bf16>(a, keys, rows, st);
    case 2: return (int)dispatch_heads<__nv_fp8_e4m3>(a, keys, rows, st);
    case 3: return (int)dispatch_heads<__nv_fp8_e5m2>(a, keys, rows, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
