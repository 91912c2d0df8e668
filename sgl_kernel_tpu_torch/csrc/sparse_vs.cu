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
// to 64 blocks of 128 keys.
//
// Design: one block of four warps per (row block, head, sequence); warp w
// owns query rows 16w .. 16w+15, whose bf16 fragments it keeps in registers.
// The block's keys come as tiles of 64: first the column tiles (64 of
// column_index each, read straight from k and v by cp.async, one 16-byte
// piece a thread at a time, never gathered into a copy), then the slash
// blocks, split into 64-key halves when bn = 128. Tiles stream through a
// double buffer: the next live tile's copies are in flight while the current
// one is computed. A tile of keys past the causal limit or past kv_len is
// skipped, and no key at or past kv_len is ever read (the TPU pads k and v to
// a multiple of bn instead). Each tile is two mma.sync m16n8k16 passes with
// float32 accumulators: S = Q K^T (K's rows are k-contiguous for the mma's
// column operand as they lie), the masks on each key's column id, an online
// softmax in the log2 domain, then O += P V with V's fragments from
// ldmatrix.trans. P enters P.V as two bf16 terms (p = hi + lo), so it is
// carried to ~2^-16, as in mla_tile.cuh; the TPU rounds P to the input type.

#include "common.cuh"

namespace {

using skt::bf16;

constexpr int kRows = 64;     // query rows of a block (block_size_M)
constexpr int kKeys = 64;     // keys of a tile
constexpr int kThreads = 128;

template <int D>
struct Smem {
  static constexpr int LD = D + 8;  // bf16 per row: rows 4 banks apart
  static constexpr int kTile = kKeys * LD;
  static constexpr size_t kBytes = 2 * (size_t)(kRows * LD + 4 * kTile) + 2 * kKeys * sizeof(int);
};

struct Params {
  const bf16 *q, *k, *v;
  const int *block_count, *block_offset, *column_count, *column_index, *kv_lens;
  bf16* out;
  float* lse;
  int B, S, H, Hk, NS, NV, bn, causal;
  float sm_scale, softcap;
};

// (p0, p1) -> bf16 pairs hi = bf16(p) and lo = bf16(p - hi)
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  const float h0 = __bfloat162float(__float2bfloat16(p0)), h1 = __bfloat162float(__float2bfloat16(p1));
  hi = skt::pack_bf16x2(h0, h1);
  lo = skt::pack_bf16x2(p0 - h0, p1 - h1);
}

template <int D>
__global__ void __launch_bounds__(kThreads) sparse_vs_kernel(const Params p) {
  using SM = Smem<D>;
  constexpr int LD = SM::LD, KT = D / 16, DT = D / 8, CH = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);       // [kRows][LD]
  bf16* sk = sq + kRows * LD;                      // [2][kKeys][LD]
  bf16* sv = sk + 2 * SM::kTile;                   // [2][kKeys][LD]
  int* scid = reinterpret_cast<int*>(sv + 2 * SM::kTile);  // [2][kKeys] column id of each key, -1 none

  const int r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.H / p.Hk);
  const int row0 = r * kRows;
  const long long sched = ((long long)b * p.H + h) * gridDim.x + r;
  const int nb = min(p.block_count[sched], p.NS), cc = min(p.column_count[sched], p.NV);
  const int* offs = p.block_offset + sched * p.NS;
  const int* cols = p.column_index + sched * p.NV;
  const int kvl = min(p.kv_lens[b], p.S);
  // keys at or past kv_end are masked for every row of the block
  const int kv_end = p.causal ? min(kvl, min(row0 + kRows, p.S)) : kvl;
  const int halves = p.bn / kKeys;
  const int n_ct = (cc + kKeys - 1) / kKeys;
  const int n_tiles = n_ct + nb * halves;

  const long long q_stride = (long long)p.H * D, kv_stride = (long long)p.Hk * D;
  const bf16* qb = p.q + (long long)b * p.S * q_stride + (long long)h * D;
  const bf16* kb = p.k + (long long)b * p.S * kv_stride + (long long)hk * D;
  const bf16* vb = p.v + (long long)b * p.S * kv_stride + (long long)hk * D;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;

  // first key column of a slash tile (column tiles are always live)
  auto tile_col0 = [&](int i) {
    const int j = i - n_ct;
    return offs[j / halves] + (j % halves) * kKeys;
  };
  auto next_live = [&](int i) {
    while (i < n_tiles && i >= n_ct && tile_col0(i) >= kv_end) ++i;
    return i;
  };
  auto load_tile = [&](int i, int stage) {
    bf16* kd = sk + stage * SM::kTile;
    bf16* vd = sv + stage * SM::kTile;
    int* cd = scid + stage * kKeys;
    const int base = i < n_ct ? 0 : tile_col0(i);
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int j = c / CH, ch = (c % CH) * 8;
      int col;
      if (i < n_ct) {
        const int slot = i * kKeys + j;
        col = slot < cc ? cols[slot] : -1;
      } else {
        col = base + j;
      }
      const bool ok = col >= 0 && col < kvl;
      const long long off = ok ? (long long)col * kv_stride + ch : 0;
      skt::cp_async16(kd + j * LD + ch, kb + off, ok);
      skt::cp_async16(vd + j * LD + ch, vb + off, ok);
      if (ch == 0) cd[j] = ok ? col : -1;
    }
  };

  // q rows -> shared -> each warp's A fragments
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int i = c / CH, ch = (c % CH) * 8;
    const bool ok = row0 + i < p.S;
    skt::cp_async16(sq + i * LD + ch, ok ? qb + (long long)(row0 + i) * q_stride + ch : qb, ok);
  }
  skt::cp_async_commit();
  int cur = next_live(0);
  if (cur < n_tiles) load_tile(cur, 0);
  skt::cp_async_commit();
  skt::cp_async_wait<1>();  // q has landed (the first tile may still be in flight)
  __syncthreads();
  uint32_t qf[KT][4];
  {
    const bf16* q0 = sq + (warp * 16 + g) * LD + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      qf[kk][0] = skt::ld32(q0 + kk * 16);
      qf[kk][1] = skt::ld32(q0 + 8 * LD + kk * 16);
      qf[kk][2] = skt::ld32(q0 + kk * 16 + 8);
      qf[kk][3] = skt::ld32(q0 + 8 * LD + kk * 16 + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {skt::kMaxInit, skt::kMaxInit}, l[2] = {0.f, 0.f};
  const int my_row[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};

  int stage = 0;
  while (cur < n_tiles) {
    const int nxt = next_live(cur + 1);
    if (nxt < n_tiles) load_tile(nxt, stage ^ 1);
    skt::cp_async_commit();
    skt::cp_async_wait<1>();  // tile cur has landed
    __syncthreads();
    const bf16* ks = sk + stage * SM::kTile;
    const bf16* vs = sv + stage * SM::kTile;
    const int* cid = scid + stage * kKeys;

    float s[kKeys / 8][4];
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const bf16* krow = ks + (nt * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
        skt::mma_bf16(s[nt], qf[kk], skt::ld32(krow + kk * 16), skt::ld32(krow + kk * 16 + 8));
    }
    float mx[2] = {skt::kMaxInit, skt::kMaxInit};
#pragma unroll
    for (int nt = 0; nt < kKeys / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = cid[nt * 8 + 2 * t + (e & 1)];
        const int row = my_row[e >> 1];
        float x = s[nt][e] * p.sm_scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        const bool vis = col >= 0 && row < p.S && (!p.causal || col <= row);
        x = vis ? x * skt::kLog2e : __int_as_float(0xff800000);  // -inf
        s[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = exp2f(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // O += P V over four 16-key steps; P as hi + lo bf16 A fragments
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      float pv[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pv[half][e] = exp2f(s[2 * kk + half][e] - m[e >> 1]);
          l[e >> 1] += pv[half][e];
        }
      // a0: row g keys 2t, 2t+1 (tile 2kk's c0, c1); a1: row g+8 (c2, c3); a2 / a3: tile 2kk+1
      uint32_t ah[4], al[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) split_bf16(pv[a >> 1][2 * (a & 1)], pv[a >> 1][2 * (a & 1) + 1], ah[a], al[a]);
      const bf16* vrow = vs + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < DT / 2; ++n2) {
        uint32_t bv[4];
        skt::ldsm_x4_trans(bv, vrow + n2 * 16);
        skt::mma_bf16(o[2 * n2], ah, bv[0], bv[1]);
        skt::mma_bf16(o[2 * n2], al, bv[0], bv[1]);
        skt::mma_bf16(o[2 * n2 + 1], ah, bv[2], bv[3]);
        skt::mma_bf16(o[2 * n2 + 1], al, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    cur = nxt;
    stage ^= 1;
  }
  skt::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = my_row[i];
    if (row >= p.S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* orow = p.out + ((long long)b * p.S + row) * q_stride + (long long)h * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(o[n][2 * i] * inv, o[n][2 * i + 1] * inv);
    if (p.lse != nullptr && t == 0)
      p.lse[((long long)b * p.H + h) * p.S + row] =
          l[i] > 0.f ? m[i] * 0.69314718055994531f + logf(l[i]) : __int_as_float(0xff800000);
  }
}

template <int D>
cudaError_t launch(const Params& p, int n_row_blocks, cudaStream_t st) {
  constexpr size_t bytes = Smem<D>::kBytes;
  static bool attr_set = false;  // dynamic shared memory above 48 KB needs the opt-in once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(sparse_vs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 (int)bytes);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  sparse_vs_kernel<D><<<dim3(n_row_blocks, p.H, p.B), kThreads, bytes, st>>>(p);
  return cudaGetLastError();
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
  p.B = B, p.S = S, p.H = H, p.Hk = Hk, p.NS = NS, p.NV = NV, p.bn = bn, p.causal = causal;
  p.sm_scale = sm_scale, p.softcap = softcap;
  const int n_row_blocks = (S + kRows - 1) / kRows;
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 64: return (int)launch<64>(p, n_row_blocks, st);
    case 128: return (int)launch<128>(p, n_row_blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
