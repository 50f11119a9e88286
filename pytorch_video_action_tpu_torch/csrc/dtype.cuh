// Conversions between the kernels' storage dtypes (float, __nv_bfloat16)
// and their f32 arithmetic, shared by every kernel under csrc/.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v rounded to T and back
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

}  // namespace
