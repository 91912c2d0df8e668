// Host side of the TMA loads: a tensor map over a row-major tensor in device
// memory, encoded once per (pointer, shape, box, swizzle) and kept. The
// tensors mapped are a model's long-lived buffers (KV pools, weight banks),
// the same pointers call after call, so a step encodes no map once the model
// has run one. The device side is skt::tma_load_2d / tma_load_4d
// (common.cuh).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

namespace skt {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// One tiled map, encoded on first use and kept: `rank` (2 or 4) dims,
// innermost first, the strides of dims 1.. in elements, `elem` bytes an
// element (1, 2 or 4: uint8, bf16 or float32 maps), boxes of box0 x box1 x 1
// x 1; reads past the edges fill zeros. False if cuTensorMapEncodeTiled
// refuses the map (alignment: the pointer and each stride in bytes must be
// 16-byte multiples).
inline bool map_tiled(CUtensorMap* tm, const void* ptr, int elem, int rank, const long long (&dims)[4],
                      const long long (&strides)[3], int box0, int box1, bool swizzle128) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, int, long long, long long, long long, long long, long long,
                             long long, long long, int, int, bool>,
                  CUtensorMap>
      cache;
  static EncodeTiled encode = nullptr;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(ptr, elem, rank, dims[0], dims[1], dims[2], dims[3], strides[0], strides[1],
                                   strides[2], box0, box1, swizzle128);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *tm = hit->second;
    return true;
  }
  if (!encode) {  // cuTensorMapEncodeTiled through the runtime's entry-point query (no link against libcuda)
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  cuuint64_t d[4], st[3];
  for (int i = 0; i < 4; ++i) d[i] = (cuuint64_t)dims[i];
  for (int i = 0; i < 3; ++i) st[i] = (cuuint64_t)(strides[i] * elem);
  const cuuint32_t box[4] = {(cuuint32_t)box0, (cuuint32_t)box1, 1, 1}, elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapDataType type = elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (encode(tm, type, (cuuint32_t)rank, const_cast<void*>(ptr), d, st, box, elem_strides,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();  // buffers freed and made anew; never more than a few hundred live
  cache.emplace(key, *tm);
  return true;
}

// A [rows][cols] tensor, row stride `ld` elements, in boxes of box_cols x box_rows.
inline bool map_2d(CUtensorMap* tm, const void* ptr, int elem, long long rows, long long cols, long long ld,
                   int box_cols, int box_rows, bool swizzle128) {
  return map_tiled(tm, ptr, elem, 2, {cols, rows, 1, 1}, {ld, 0, 0}, box_cols, box_rows, swizzle128);
}

// A dense row-major [d3][d2][d1][d0] tensor in boxes of box0 x box1 x 1 x 1:
// the W4A16 streaming core's maps, a weight, scale or zero bank [L][E][rows][N]
// with layer and expert as coordinates, and 2-D workspaces as
// [1][1][rows][cols], so that every box of a stage is one instruction form.
inline bool map_4d(CUtensorMap* tm, const void* ptr, int elem, const long long (&dims)[4], int box0, int box1,
                   bool swizzle128) {
  return map_tiled(tm, ptr, elem, 4, dims, {dims[0], dims[0] * dims[1], dims[0] * dims[1] * dims[2]}, box0, box1,
                   swizzle128);
}

// streaming multiprocessors of the current device, read once
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace skt
