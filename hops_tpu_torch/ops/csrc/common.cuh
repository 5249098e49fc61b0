// Helpers shared by the attention kernels of hops_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hops {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy an (nr, D) tile of T from global memory (rows D elements apart,
// 16-byte aligned) into fp32 shared memory with row stride
// `dst_stride`. Rows at or past `valid_rows` are zero-filled, so ragged
// tails never read out of bounds. 16-byte loads, neighbouring threads
// on neighbouring addresses.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int dst_stride,
                                          const T* __restrict__ src, int nr,
                                          int valid_rows, int tid, int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = tid; i < nr * VPR; i += nthreads) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float* d = dst + r * dst_stride + c;
    if (r < valid_rows) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (size_t)r * D + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = 0.f;
    }
  }
}

}  // namespace hops
