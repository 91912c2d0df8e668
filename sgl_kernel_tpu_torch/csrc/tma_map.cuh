// Host side of the 2-D TMA loads: a tensor map over a row-major [rows][cols]
// tensor in device memory, encoded once per (pointer, shape, box, swizzle)
// and kept. The tensors mapped are a model's long-lived buffers (KV pools,
// weight banks), the same pointers call after call, so a step encodes no map
// once the model has run one. The device side is skt::tma_load_2d
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

// `elem` bytes an element (1, 2 or 4: uint8, bf16 or float32 maps); row stride `ld`
// elements; boxes of box_cols x box_rows; reads past the edges fill zeros.
// False if cuTensorMapEncodeTiled refuses the map (alignment: the pointer and ld * elem
// must be 16-byte multiples).
inline bool map_2d(CUtensorMap* tm, const void* ptr, int elem, long long rows, long long cols, long long ld,
                   int box_cols, int box_rows, bool swizzle128) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, long long, long long, long long, int, int, bool>, CUtensorMap> cache;
  static EncodeTiled encode = nullptr;
  const std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(ptr, elem, rows, cols, ld, box_cols, box_rows, swizzle128);
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
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)(ld * elem)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows}, elem_strides[2] = {1, 1};
  const CUtensorMapDataType type = elem == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                               : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  if (encode(tm, type, 2,
             const_cast<void*>(ptr), dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();  // buffers freed and made anew; never more than a few hundred live
  cache.emplace(key, *tm);
  return true;
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
