// The W4A16 weight stream's ceiling on the card, for tools/w4a16_stream_probe.py.
// Measurement only: no model and no test calls it.
//
// (a) probe_read: a plain read of a buffer, 16 bytes a thread, four loads in
//     flight, summed so that nothing is elided.
// (b) the streaming core (sgl_kernel_tpu_torch/csrc/w4a16_stream.cuh) at one
//     stream shape (box, stages, blocks an SM, unit order) with consumers
//     that only release each stage: codes alone, or every box of a stage.
// (c) the same core with its real consumers.
// The bank [L][E][K/2][N] is passed as L x E experts of one layer, each row
// block one expert, so one launch streams all of it.

#include "w4a16_stream.cuh"

namespace {

__global__ void __launch_bounds__(512) read_kernel(const uint4* __restrict__ p, long long n,
                                                   unsigned int* __restrict__ sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  for (; i + 3 * stride < n; i += 4 * stride) {
    uint4 v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __ldg(p + i + j * stride);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc ^= v[j].x ^ v[j].y ^ v[j].z ^ v[j].w;
  }
  for (; i < n; i += stride) {
    const uint4 v = __ldg(p + i);
    acc ^= v.x ^ v.y ^ v.z ^ v.w;
  }
  if (acc == 0x9e3779b9u) sink[0] = acc;  // never true in practice; keeps the loads
}

// A stream shape: (MP, BOX, KS, S, MINB, MODE); G = 128, int4.
#define PROBE_VARIANTS(X)                                                                     \
  X(0, 16, 0, 256, 2, 2, w4s::kEmptyCodes) X(1, 16, 0, 256, 3, 2, w4s::kEmptyCodes)           \
  X(2, 16, 0, 256, 4, 2, w4s::kEmptyCodes) X(3, 16, 0, 256, 5, 2, w4s::kEmptyCodes)           \
  X(4, 16, 0, 256, 6, 2, w4s::kEmptyCodes) X(5, 16, 0, 256, 7, 2, w4s::kEmptyCodes)           \
  X(6, 16, 0, 256, 8, 2, w4s::kEmptyCodes) X(7, 16, 1, 128, 2, 2, w4s::kEmptyCodes)           \
  X(8, 16, 1, 128, 3, 2, w4s::kEmptyCodes) X(9, 16, 1, 128, 4, 2, w4s::kEmptyCodes)           \
  X(10, 16, 1, 128, 5, 2, w4s::kEmptyCodes) X(11, 16, 1, 128, 6, 2, w4s::kEmptyCodes)         \
  X(12, 16, 1, 128, 7, 2, w4s::kEmptyCodes) X(13, 16, 1, 128, 8, 2, w4s::kEmptyCodes)         \
  X(14, 16, 2, 128, 2, 2, w4s::kEmptyCodes) X(15, 16, 2, 128, 3, 2, w4s::kEmptyCodes)         \
  X(16, 16, 2, 128, 4, 2, w4s::kEmptyCodes) X(17, 16, 2, 128, 5, 2, w4s::kEmptyCodes)         \
  X(18, 16, 2, 128, 6, 2, w4s::kEmptyCodes) X(19, 16, 2, 128, 7, 2, w4s::kEmptyCodes)         \
  X(20, 16, 2, 128, 8, 2, w4s::kEmptyCodes) X(21, 16, 0, 256, 3, 2, w4s::kEmptyAll)           \
  X(22, 16, 0, 256, 4, 2, w4s::kEmptyAll) X(23, 16, 2, 128, 4, 2, w4s::kEmptyAll)             \
  X(24, 16, 2, 128, 6, 2, w4s::kEmptyAll) X(25, 16, 0, 256, 3, 2, w4s::kConsume)              \
  X(26, 16, 2, 128, 4, 2, w4s::kConsume) X(27, 16, 2, 256, 2, 2, w4s::kConsume)               \
  X(28, 16, 1, 128, 4, 2, w4s::kConsume) X(29, 32, 2, 128, 4, 2, w4s::kConsume)               \
  X(30, 32, 2, 256, 2, 2, w4s::kConsume) X(31, 16, 2, 256, 3, 1, w4s::kConsume)               \
  X(32, 16, 2, 256, 4, 1, w4s::kConsume) X(33, 16, 2, 256, 3, 1, w4s::kEmptyAll)              \
  X(34, 32, 2, 256, 3, 1, w4s::kConsume) X(35, 16, 2, 256, 4, 1, w4s::kEmptyAll)

struct Shape {
  int mp, box, ks, stages, minb, mode;
};

#define PROBE_SHAPE(id, mp, box, ks, s, minb, mode) {mp, box, ks, s, minb, mode},
constexpr Shape kShapes[] = {PROBE_VARIANTS(PROBE_SHAPE)};
#undef PROBE_SHAPE

template <int MP, int BOX, int KS, int S, int MINB, int MODE>
int run_shape(const void* w, const void* scales, const void* act, const void* asum, const int* expert_ids,
              const int* num_valid, void* out, void* partial, void* counters, int experts, int K, int N,
              int blocks_per_sm_req, int n_sm, int order, int* blocks_out, cudaStream_t st) {
  using Lay = w4s::Layout<128, MP, BOX, KS, S, MODE, w4s::consumers<MINB>()>;
  const int fit = w4s::blocks_per_sm<128, MP, false, BOX, KS, S, MINB, MODE>();
  const int per_sm = fit < blocks_per_sm_req ? fit : blocks_per_sm_req;
  *blocks_out = per_sm;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  w4s::Args da;
  const int rows = experts * MP;
  if (!w4s::make_maps<128, MP, BOX, KS, S>(da, w, scales, nullptr, act, asum, 1, experts, K, N, rows, rows))
    return (int)cudaErrorInvalidValue;
  w4s::Params& p = da.p;
  p.bias = nullptr;
  p.residual = nullptr;
  p.out = out;
  p.partial = (float*)partial;
  p.counters = (int*)counters;
  p.expert_ids = expert_ids;
  p.num_valid = num_valid;
  p.rows = rows, p.bm = MP, p.n_rb = experts;
  p.N = N, p.n_kb = (K + KS - 1) / KS, p.tiles = (N + Lay::BN - 1) / Lay::BN;
  p.layer = 0, p.order = order, p.out_f32 = 0, p.zeros = 0;
  const cudaError_t err = w4s::launch<128, MP, false, BOX, KS, S, MINB, MODE>(da, per_sm * n_sm, st);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_count() { return (int)(sizeof(kShapes) / sizeof(kShapes[0])); }

// mp, box, ks, stages, minb, mode of shape `id`
extern "C" void probe_shape(int id, int* out6) {
  const Shape& s = kShapes[id];
  out6[0] = s.mp, out6[1] = s.box, out6[2] = s.ks, out6[3] = s.stages, out6[4] = s.minb, out6[5] = s.mode;
}

extern "C" int probe_read(const void* buf, long long bytes, void* sink, int blocks, int threads, void* stream) {
  read_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>((const uint4*)buf, bytes / 16, (unsigned int*)sink);
  return (int)cudaGetLastError();
}

// One launch of shape `id` over the bank w [experts][K/2][N] (scales
// [experts][K/128][N]), row block e of expert e; act [experts * MP][K] and asum
// [K/128][experts * MP] stand in for the rows pass's output. Returns the
// launch's error; *blocks_out the blocks an SM it ran with.
extern "C" int probe_stream(int id, const void* w, const void* scales, const void* act, const void* asum,
                            const void* expert_ids, const void* num_valid, void* out, void* partial, void* counters,
                            int experts, int K, int N, int blocks_per_sm, int n_sm, int order, int* blocks_out,
                            void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  switch (id) {
#define PROBE_CASE(id_, mp, box, ks, s, minb, mode)                                                             \
  case id_:                                                                                                      \
    return run_shape<mp, box, ks, s, minb, mode>(w, scales, act, asum, (const int*)expert_ids,                  \
                                                 (const int*)num_valid, out, partial, counters, experts, K, N, \
                                                 blocks_per_sm, n_sm, order, blocks_out, st);
    PROBE_VARIANTS(PROBE_CASE)
#undef PROBE_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
