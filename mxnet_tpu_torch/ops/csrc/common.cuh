// Helpers shared by the kernels in this directory.
//
// Element types: every kernel reads and writes T = float, __nv_bfloat16
// or __half and computes in float. The C entry points take the type as
// an int `dtype`: 0 = float32, 1 = bfloat16, 2 = float16 (the table
// DTYPE_CODES in ops/_build.py).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace mxtt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void store(__half* p, float x) {
  *p = __float2half(x);
}

// round an f32 value to the type of the second argument and back
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half(x));
}

// Let `kern` take `smem` bytes of dynamic shared memory (above 48 KiB a
// kernel must opt in).
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace mxtt
