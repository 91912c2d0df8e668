// K16: vertical + slash block-sparse causal prefill attention (MInference).
//
// Replaces sparse_attn_func (sgl_kernel_tpu/ops/attention/sparse_vs.py:351,
// Pallas kernel _bs_kernel :240, pallas_call at :417). Contract: q [B, S, H,
// D], k / v [B, S, Hk, D] bf16 (head h reads kv head h / (H / Hk)); the
// schedule of row block r (64 queries) of (b, h): column_count cc and
// column_index [NV] (the exact vertical keys, the first cc of them counted),
// block_count nb and block_offset [NS] (slash blocks of bn keys starting
// there); kv_lens [B]. Key c is visible to query row i when 0 <= c < kv_len
// and, causal, c <= i. Scores are q.k * sm_scale, soft-capped (softcap *
// tanh(s / softcap)) when softcap > 0; one softmax runs over the columns and
// the blocks' keys together, a key listed twice counting twice. Out [B, S,
// H, D] bf16; lse [B, H, S] float32, natural log (m + log l), -inf for a row
// that sees no key (its o is 0).
//
// Bound: operations. At Llama-3-8B's widths (32 heads of 128) and S=32,768
// with NV=1,000 and NS=64, each row block attends to ~1,000 columns and up
// to 64 blocks of 128 keys: 5.5e9 visible pairs, 2.8e12 flops. Each 64-key
// tile's K and V (32 KB) serve only the block's 64 query rows (the schedule
// is per head), so the tiles also stream ~44 GB from L2 at that size.
//
// Design: one block per (row block, head, sequence): one consumer warpgroup
// (warps 0-3) runs the wgmma flash tile of flash_tile.cuh over the block's
// key tiles of 64 (the columns, 64 of column_index a tile, then the slash
// blocks split into 64-key halves when bn = 128), and one producer warp
// (warp 4) fills a ring of stages (three at D=128, six at D=64) behind
// mbarriers. Ring entry 0 of a block carries its q tile; each later entry
// one key tile's K and V, swizzled [64][D], with the tile's 64 column ids
// and flags beside them (a header in shared memory). A slash tile that lies
// wholly inside [0, kv_len) comes as D/64 2-D TMA boxes each of K and V
// (one lane, behind its expect_tx); the column tiles, a gather, and a slash
// tile that reaches past kv_len come by 16-byte cp.async pieces, two rows an
// instruction at D=128, zero-filled and not read for a key at or past
// kv_len or before 0. The producer never waits for its own copies: each
// lane arrives once its header stores are done and once more when its
// cp.async copies land (cp.async.mbarrier.arrive.noinc), so the ring is
// full ahead of the consumers; they make each landed stage visible to
// wgmma's async proxy with a fence (its cp.async writes are the generic
// proxy's). At D=128 q goes from its
// stage into registers as wgmma's A (S = q K^T then reads only K from
// shared memory); at D=64 q stays in a tile of its own (S from two shared operands: the
// register form gave wrong sums from the second key tile on at this width
// on the H100, a fault not understood, so it is not used there). A tile
// needs the mask only where one of its keys is missing (a slot past
// column_count, an id past kv_len) or, causal, its largest key passes the
// block's first row; a slash tile starting at or past the block's last
// visible key is not fetched. The soft cap is a template parameter: tanh
// from one exp2 and one reciprocal (~1e-7 absolute, where tanhf costs about
// twenty instructions a score; tanh.approx's 2^-11 would break the lse's
// 1e-5). Balance: blocks run in (sequence, kv head) order, within each the
// row blocks from the last (the most keys) to the first and the heads of
// the kv group side by side, so the blocks resident at a time read one kv
// head's keys, which fit in L2, and the light row blocks fill each head's
// tail (ops/attention/sparse_vs.py work_order). Two blocks fit an SM.
// Numbers: scores are exact bf16 products summed in float32, P enters P V
// in two bf16 terms (flash_tile.cuh), the output is rounded once.

#include "flash_tile.cuh"
#include "tma_map.cuh"

namespace {

using skt::bf16;

constexpr int kRows = skt::kFlashBQ;            // query rows of a block (block_size_M)
constexpr int kKeys = skt::kFlashBK;            // keys of a tile
constexpr int kCThreads = skt::kFlashThreads;   // one consumer warpgroup
constexpr int kThreads = kCThreads + 32;        // and one producer warp
constexpr int kHdr = kKeys + 2;                 // a stage's column ids (-1: none), its mask flag, a pad

template <int D>
struct Smem {
  static constexpr int kTile = skt::FlashSmem<D>::kTile;  // a swizzled [64][D] tile
  // D=128: q in registers (wgmma's A), taken from entry 0's stage; D=64: q
  // in a tile of its own for the block's life (S from two shared operands)
  static constexpr bool kQRegs = D == 128;
  static constexpr int kQ = kQRegs ? 0 : kTile;
  static constexpr int kStage = 2 * kTile;  // K, then V (entry 0: q in K's place at D=128)
  static constexpr int kStages = D == 64 ? 6 : 3;
  // 1 KB of slack to start on a 1024-byte boundary, q, the ring, its
  // barriers, the stages' headers
  static constexpr size_t kBytes = 1024 + kQ + (size_t)kStages * kStage + 2 * kStages * 8 + kStages * kHdr * 4;
};

struct Params {
  const bf16 *q, *k, *v;
  const int *block_count, *block_offset, *column_count, *column_index, *kv_lens;
  bf16* out;
  float* lse;
  int B, S, H, Hk, R, NS, NV, bn, causal;
  float sm_scale, softcap;
};

struct alignas(64) KArgs {
  // k and v as [B * S rows][Hk * D], boxes of 64 columns (128 bytes) x 64
  // rows, 128-byte swizzle: a slash tile's half of a head's row
  CUtensorMap tk, tv;
  Params p;
};

// tanh(x) = 1 - 2 / (e^(2x) + 1): saturates to +-1, ~1e-7 absolute
__device__ __forceinline__ float tanh_exp2(float x) {
  return 1.f - __fdividef(2.f, exp2f(x * (2.f * skt::kLog2e)) + 1.f);
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 2) sparse_vs_kernel(const __grid_constant__ KArgs ka) {
  const Params& p = ka.p;
  using L = Smem<D>;
  constexpr int S = L::kStages, CH = D / 8, SUB = skt::FlashSmem<D>::kSub;
  constexpr int KPI = 32 / CH;  // rows a copy instruction of the producer warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sq = smem_raw + ((1024u - (skt::smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* ring = sq + L::kQ;  // D=128: q lands in stage 0
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * L::kStage);
  uint64_t* empty = full + S;
  int* hdr = reinterpret_cast<int*>(empty + S);  // [S][kHdr]
  // the block's (sequence, head, row block): sparse_vs.py work_order
  const int G = p.H / p.Hk, gi = blockIdx.x % G, ri = blockIdx.x / G % p.R, hk = blockIdx.x / G / p.R % p.Hk;
  const int b = blockIdx.x / G / p.R / p.Hk, h = hk * G + gi, row0 = (p.R - 1 - ri) * kRows;
  const long long q_stride = (long long)p.H * D, kv_stride = (long long)p.Hk * D;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      // each producer lane twice: once its header stores are done (a
      // release), once its copies have landed (cp.async's own arrival)
      skt::mbar_init(&full[s], 64);
      skt::mbar_init(&empty[s], 4);  // each consumer warp, once it is done with the stage
    }
    skt::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4) {
    // Producer: entry 0 is q (its header's flag: the number of key tiles),
    // then the column tiles, then the live slash tiles.
    int e = 0;  // entries issued
    auto stage = [&]() {  // entry e's stage, once the consumers are done with it
      const int s = e % S;
      if (e >= S) skt::mbar_wait(&empty[s], ((e / S) - 1) & 1);
      return s;
    };
    auto publish = [&](int s) {  // the lane's header stores and copies of entry e are issued
      skt::mbar_arrive(&full[s]);
      skt::cp_async_mbar_arrive(&full[s]);
      ++e;
    };
    const long long sched = ((long long)b * p.H + h) * p.R + p.R - 1 - ri;
    const int nb = max(0, min(p.block_count[sched], p.NS)), cc = max(0, min(p.column_count[sched], p.NV));
    const int* offs = p.block_offset + sched * p.NS;
    const int* cols = p.column_index + sched * p.NV;
    const int kvl = min(p.kv_lens[b], p.S);
    // keys at or past kv_end are masked for every row of the block
    const int kv_end = p.causal ? min(kvl, min(row0 + kRows, p.S)) : kvl;
    const int halves = p.bn / kKeys, n_ct = (cc + kKeys - 1) / kKeys;
    {  // the q tile (rows past S as zeros), copied while the tiles are counted
      const bf16* qb = p.q + ((long long)b * p.S + row0) * q_stride + (long long)h * D;
#pragma unroll
      for (int i = 0; i < kRows / KPI; ++i) {
        const int j = i * KPI + lane / CH, ch = lane % CH;
        const bool ok = row0 + j < p.S;
        skt::cp_async16(sq + (ch / 8) * SUB + skt::sw128(j, ch % 8), qb + (ok ? j * q_stride + ch * 8 : 0), ok);
      }
      int n_live = 0;
      for (int j = lane; j < nb; j += 32)
        for (int hh = 0; hh < halves; ++hh) n_live += offs[j] + hh * kKeys < kv_end;
      n_live = __reduce_add_sync(0xffffffffu, n_live);
      if (lane == 0) hdr[kKeys] = n_ct + n_live;
      publish(stage());  // entry 0: stage 0, never waited for
    }
    const bf16* kb = p.k + (long long)b * p.S * kv_stride + (long long)hk * D;
    const bf16* vb = p.v + (long long)b * p.S * kv_stride + (long long)hk * D;
    // a key tile: lane holds the ids of keys lane and lane + 32 (-1: none)
    auto fill = [&](int ca, int cb, int flag) {
      const int s = stage();
      int* hd = hdr + s * kHdr;
      hd[lane] = ca;
      hd[lane + 32] = cb;
      if (lane == 0) hd[kKeys] = flag;
      unsigned char* kt = ring + s * L::kStage;
#pragma unroll
      for (int i = 0; i < kKeys / KPI; ++i) {
        const int j = i * KPI + lane / CH, ch = lane % CH;
        const int col = __shfl_sync(0xffffffffu, i * KPI < 32 ? ca : cb, j % 32);
        const bool ok = col >= 0;
        const long long off = ok ? (long long)col * kv_stride + ch * 8 : 0;
        const uint32_t d = (ch / 8) * SUB + skt::sw128(j, ch % 8);
        skt::cp_async16(kt + d, kb + off, ok);
        skt::cp_async16(kt + L::kTile + d, vb + off, ok);
      }
      publish(s);
    };
    for (int t = 0; t < n_ct; ++t) {
      const int s0 = t * kKeys + lane, s1 = s0 + 32;
      int ca = s0 < cc ? cols[s0] : -1, cb = s1 < cc ? cols[s1] : -1;
      ca = ca < kvl ? ca : -1;
      cb = cb < kvl ? cb : -1;
      const int mx = __reduce_max_sync(0xffffffffu, max(ca, cb));
      const bool missing = __any_sync(0xffffffffu, ca < 0 || cb < 0);
      fill(ca, cb, missing || (p.causal && mx > row0));
    }
    // a slash tile wholly inside [0, kv_len): D / 64 TMA boxes each of K and
    // V, issued by lane 0 behind its expect_tx
    auto fill_box = [&](int c0) {
      const int s = stage();
      int* hd = hdr + s * kHdr;
      hd[lane] = c0 + lane;
      hd[lane + 32] = c0 + lane + 32;
      unsigned char* kt = ring + s * L::kStage;
      if (lane == 0) {
        hd[kKeys] = p.causal && c0 + kKeys - 1 > row0;
        skt::mbar_expect_tx(&full[s], 2 * L::kTile);
        const int row = b * p.S + c0;
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          skt::tma_load_2d(kt + x * SUB, &ka.tk, hk * D + 64 * x, row, &full[s]);
          skt::tma_load_2d(kt + L::kTile + x * SUB, &ka.tv, hk * D + 64 * x, row, &full[s]);
        }
      } else {
        skt::mbar_arrive(&full[s]);
      }
      skt::cp_async_mbar_arrive(&full[s]);
      ++e;
    };
    for (int j = 0; j < nb; ++j) {
      const int o = offs[j];
      for (int hh = 0; hh < halves; ++hh) {
        const int c0 = o + hh * kKeys;
        if (c0 >= kv_end) continue;
        if (c0 >= 0 && c0 + kKeys <= kvl) {
          fill_box(c0);
          continue;
        }
        // a tile past kv_len (or before 0): cp.async, zero-filled past the edge
        const int ca = c0 + lane, cb = c0 + lane + 32;
        fill(ca >= 0 && ca < kvl ? ca : -1, cb >= 0 && cb < kvl ? cb : -1, 1);
      }
    }
    skt::cp_async_wait<0>();  // no copy outlives the block
    return;
  }

  // Consumers: q into registers, then each key tile through the flash tile.
  const int t = lane % 4;
  const int rows[2] = {row0 + warp * 16 + lane / 4, row0 + warp * 16 + lane / 4 + 8};
  int e = 0;  // entries taken
  auto take = [&]() {  // the next entry's stage, once its header and copies have landed
    const int s = e % S;
    skt::mbar_wait(&full[s], (e / S) & 1);
    skt::fence_proxy_async();  // its cp.async writes (generic proxy), to wgmma's async proxy
    ++e;
    return s;
  };
  auto release = [&](int s) {
    __syncwarp();
    if (lane == 0) skt::mbar_arrive(&empty[s]);
  };
  uint32_t qf[D / 16][4];
  skt::FlashAcc<D> acc;
  acc.init();
  take();
  const int n_tiles = hdr[kKeys];
  if (L::kQRegs && n_tiles > 0) skt::flash_q_frags<D>(qf, sq);
  release(0);
  const float scale_log2 = p.sm_scale * skt::kLog2e, cap_in = p.sm_scale / p.softcap,
              cap_out = p.softcap * skt::kLog2e;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = take();
    const unsigned char* kt = ring + s * L::kStage;
    const int* hd = hdr + s * kHdr;
    float sc[32];
    if constexpr (L::kQRegs) skt::flash_scores<D>(sc, qf, skt::smem_u32(kt));
    else skt::flash_scores<D>(sc, skt::smem_u32(sq), skt::smem_u32(kt));
    // sc[4c + x]: row rows[(x >> 1) & 1], key 8c + 2t + (x & 1)
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      if constexpr (SOFTCAP) sc[x] = cap_out * tanh_exp2(sc[x] * cap_in);
      else sc[x] *= scale_log2;
    }
    if (hd[kKeys]) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int2 col = *reinterpret_cast<const int2*>(hd + 8 * c + 2 * t);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int cx = (x & 1) ? col.y : col.x;
          if (cx < 0 || (p.causal && cx > rows[x >> 1])) sc[4 * c + x] = __int_as_float(0xff800000);  // -inf
        }
      }
    }
    skt::flash_softmax_pv<D>(acc, sc, skt::smem_u32(kt + L::kTile));
    release(s);
  }
  const int n_rows = min(kRows, p.S - row0);
  skt::flash_store<D>(acc, p.out + ((long long)b * p.S + row0) * q_stride + (long long)h * D, q_stride,
                      p.lse == nullptr ? nullptr : p.lse + ((long long)b * p.H + h) * p.S + row0, n_rows,
                      n_rows, 0.69314718055994531f, __int_as_float(0xff800000));
}

template <int D, bool SOFTCAP>
cudaError_t launch(const Params& p, cudaStream_t st) {
  constexpr size_t bytes = Smem<D>::kBytes;
  KArgs ka;
  ka.p = p;
  const long long rows = (long long)p.B * p.S, cols = (long long)p.Hk * D;
  if (!skt::map_2d(&ka.tk, p.k, 2, rows, cols, cols, 64, kKeys, true) ||
      !skt::map_2d(&ka.tv, p.v, 2, rows, cols, cols, 64, kKeys, true))
    return cudaErrorInvalidValue;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_vs_kernel<D, SOFTCAP>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  sparse_vs_kernel<D, SOFTCAP><<<(unsigned)((long long)p.B * p.H * p.R), kThreads, bytes, st>>>(ka);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const Params& p, cudaStream_t st) {
  return p.softcap > 0.f ? launch<D, true>(p, st) : launch<D, false>(p, st);
}

}  // namespace

// q [B, S, H, D], k / v [B, S, Hk, D] bf16 contiguous; block_count /
// column_count [B, H, R], block_offset [B, H, R, NS], column_index [B, H, R,
// NV], kv_lens [B] int32, R = ceil(S / 64); out [B, S, H, D] bf16; lse [B, H,
// S] float32 or null. D 64 or 128, bn 64 or 128, H a multiple of Hk. Returns
// cudaGetLastError().
extern "C" int skt_sparse_attn(const void* q, const void* k, const void* v, const void* block_count,
                               const void* block_offset, const void* column_count, const void* column_index,
                               const void* kv_lens, void* out, void* lse, int B, int S, int H, int Hk, int D, int NS,
                               int NV, int bn, int causal, float sm_scale, float softcap, void* stream) {
  if ((bn != 64 && bn != 128) || Hk <= 0 || H % Hk) return (int)cudaErrorInvalidValue;
  Params p{};
  p.q = (const bf16*)q, p.k = (const bf16*)k, p.v = (const bf16*)v;
  p.block_count = (const int*)block_count, p.block_offset = (const int*)block_offset;
  p.column_count = (const int*)column_count, p.column_index = (const int*)column_index;
  p.kv_lens = (const int*)kv_lens;
  p.out = (bf16*)out, p.lse = (float*)lse;
  p.B = B, p.S = S, p.H = H, p.Hk = Hk, p.R = (S + kRows - 1) / kRows, p.NS = NS, p.NV = NV, p.bn = bn;
  p.causal = causal, p.sm_scale = sm_scale, p.softcap = softcap;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return (int)launch_d<64>(p, st);
    case 128: return (int)launch_d<128>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
