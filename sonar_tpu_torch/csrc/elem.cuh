// Element types of the kernels' tensors: float, __nv_bfloat16 and __half.
// Every element is loaded into float32, computed there and stored once,
// rounded to nearest even, in the tensor's type.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace sonar {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

}  // namespace sonar
