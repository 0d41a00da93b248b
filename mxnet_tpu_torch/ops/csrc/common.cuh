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

// ---- tensor-core products (mma.sync) ---------------------------------------
//
// f32 operands keep f32 accuracy on the TF32 tensor cores by a 3-term
// split: x = hi + lo, each TF32 (rounded to nearest by cvt.rna), and
// a . b = a_lo b_hi + a_hi b_lo + a_hi b_hi (a_lo b_lo, ~2^-22 of the
// product, is dropped). 16-bit operands go in as they are (m16n8k16).
// The tensor cores add into their accumulator rounding toward zero, so
// a sum carried through many mma drifts toward zero (~depth x 2^-24 of
// it): callers sum a short run of the depth into a fresh partial and
// add the partials with ordinary round-to-nearest f32 adds.

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each TF32 (the 3-term split's halves)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  const float f = __uint_as_float(x);
  hi = tf32_rna(f);
  lo = tf32_rna(f - __uint_as_float(hi));
}

// d += a (16 x 8, row) . b (8 x 8, col), TF32 in, f32 accumulation
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a . b (a fresh sum: the accumulator input is zero)
__device__ __forceinline__ void mma_tf32_0(float* d, const uint32_t* a,
                                           const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// d (+)= a . b in f32 with f32 accuracy from split operands: a_lo b_hi +
// a_hi b_lo + a_hi b_hi (the small terms first; a_lo b_lo, ~2^-22 of the
// product, is dropped). `fresh`: d starts from zero.
__device__ __forceinline__ void mma_tf32x3(float* d, const uint32_t* ah,
                                           const uint32_t* al,
                                           const uint32_t* bh,
                                           const uint32_t* bl, bool fresh) {
  if (fresh)
    mma_tf32_0(d, al, bh);
  else
    mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// d += a (16 x 16, row) . b (16 x 8, col), 16-bit in, f32 accumulation
template <typename T>
__device__ __forceinline__ void mma_16(float* d, const uint32_t* a,
                                       const uint32_t* b);
template <>
__device__ __forceinline__ void mma_16<__nv_bfloat16>(float* d,
                                                      const uint32_t* a,
                                                      const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma_16<__half>(float* d, const uint32_t* a,
                                               const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace mxtt
