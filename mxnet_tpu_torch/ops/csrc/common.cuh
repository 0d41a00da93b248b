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

// A 16-byte vector of T (4 f32 or 8 bf16/f16 values), as loaded from or
// stored to memory aligned to 16 bytes, unpacked to and packed from f32.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
  __device__ static void unpack(uint4 w, float (&out)[N]) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        out[i] = __uint_as_float(u[i]);
      } else {
        const T* h = reinterpret_cast<const T*>(&u[i]);
        out[2 * i] = to_f32(h[0]);
        out[2 * i + 1] = to_f32(h[1]);
      }
    }
  }
  __device__ static uint4 pack(const float (&v)[N]) {
    uint32_t u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        u[i] = __float_as_uint(v[i]);
      } else {
        T* h = reinterpret_cast<T*>(&u[i]);
        store(h, v[2 * i]);
        store(h + 1, v[2 * i + 1]);
      }
    }
    return make_uint4(u[0], u[1], u[2], u[3]);
  }
};

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


// TF32 operand words of f32 values: hi, and lo = x - hi when `split`
template <int N, bool SPLIT>
__device__ __forceinline__ void tf32_words(const float (&x)[N],
                                           uint32_t (&hi)[N],
                                           uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (SPLIT)
      split_tf32(__float_as_uint(x[i]), hi[i], lo[i]);
    else
      hi[i] = tf32_rna(x[i]);   // exact: a 16-bit input value
  }
}

// acc[j] += A (16 x 8) . B (8 x 8) at depth k0..k0+7, j < nt_live <= NT,
// for one warp: A(m, k) and B(k, n) read f32 from shared memory (B's n
// = 8 j + column), every B fragment loaded before the products. SA /
// SB: the operand is f32 data to split into TF32 hi + lo; otherwise it
// holds 16-bit input values, exact in TF32, and takes one term. The
// k-step goes into fresh partials, added round-to-nearest (the tensor
// cores' own adds round toward zero). acc[j]: rows gid (0, 1) and
// gid + 8 (2, 3), columns 8 j + 2 tig (+ 1).
template <int NT, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void mma_kstep(float (&acc)[NT][4], int k0, FA A,
                                          FB B, int nt_live) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const float av[4] = {A(gid, k0 + tig), A(gid + 8, k0 + tig),
                       A(gid, k0 + tig + 4), A(gid + 8, k0 + tig + 4)};
  float bv[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    bv[j][0] = j < nt_live ? B(k0 + tig, 8 * j + gid) : 0.f;
    bv[j][1] = j < nt_live ? B(k0 + tig + 4, 8 * j + gid) : 0.f;
  }
  uint32_t ah[4], al[4];
  tf32_words<4, SA>(av, ah, al);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt_live) {
      uint32_t bh[2], bl[2];
      tf32_words<2, SB>(bv[j], bh, bl);
      float p[4];
      if (SA) {
        mma_tf32_0(p, al, bh);
        if (SB) mma_tf32(p, ah, bl);
        mma_tf32(p, ah, bh);
      } else if (SB) {
        mma_tf32_0(p, ah, bl);
        mma_tf32(p, ah, bh);
      } else {
        mma_tf32_0(p, ah, bh);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += p[q];
    }
  }
}

// TF32 operand words without the conversion unit: hi = x rounded to
// TF32 (to nearest, ties away from zero) by an integer add and mask,
// lo = x - hi (exact) passed as its f32 bits: the tensor cores read a
// TF32 operand's top 19 bits, so lo is truncated to TF32 there (an error
// of at most 2^-21 |x|, below the dropped lo.lo term's order). Without
// `split`, x is a 16-bit input value, a TF32 value already.
template <int N, bool SPLIT>
__device__ __forceinline__ void tf32_words_int(const float (&x)[N],
                                               uint32_t (&hi)[N],
                                               uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t u = __float_as_uint(x[i]);
    if (SPLIT) {
      hi[i] = (u + 0x1000u) & 0xffffe000u;
      lo[i] = __float_as_uint(x[i] - __uint_as_float(hi[i]));
    } else {
      hi[i] = u;
    }
  }
}

// mma_kstep with the n-tiles' products interleaved: every n-tile's
// first term, then every second, then every third, so mma issued back
// to back are independent and a warp need not wait out each product's
// latency (4 NT more registers), and with the operands split by
// tf32_words_int: the conversion unit's rate would bound the products
// otherwise. A's words (ah, al: tf32_words_int of this lane's A values
// A(gid, k0 + tig), A(gid + 8, k0 + tig), A(gid, k0 + tig + 4),
// A(gid + 8, k0 + tig + 4)) are split once by the caller.
template <int NT, bool SA, bool SB, typename FB>
__device__ __forceinline__ void mma_kstep_il(float (&acc)[NT][4],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             int k0, FB B, int nt_live) {
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float bv[2] = {j < nt_live ? B(k0 + tig, 8 * j + gid) : 0.f,
                         j < nt_live ? B(k0 + tig + 4, 8 * j + gid) : 0.f};
    tf32_words_int<2, SB>(bv, bh[j], bl[j]);
  }
  float p[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < nt_live) {
      if (SA)
        mma_tf32_0(p[j], al, bh[j]);
      else if (SB)
        mma_tf32_0(p[j], ah, bl[j]);
      else
        mma_tf32_0(p[j], ah, bh[j]);
    }
  }
  if (SA && SB) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt_live) mma_tf32(p[j], ah, bl[j]);
  }
  if (SA || SB) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
      if (j < nt_live) mma_tf32(p[j], ah, bh[j]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
    if (j < nt_live)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] += p[j][q];
}

// acc += A (16 x K) . B (K x 8 NT), K a multiple of 8 (mma_kstep)
template <int NT, bool SA, bool SB, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[NT][4], int K, FA A,
                                         FB B) {
  for (int k0 = 0; k0 < K; k0 += 8)
    mma_kstep<NT, SA, SB>(acc, k0, A, B, NT);
}

// Two products of one depth in one loop (independent chains for the
// scheduler): acc0 += A0 . B0, acc1 += A1 . B1.
template <int NT, bool SA, bool SB, typename FA0, typename FB0,
          typename FA1, typename FB1>
__device__ __forceinline__ void warp_mma2(float (&acc0)[NT][4], FA0 A0,
                                          FB0 B0, float (&acc1)[NT][4],
                                          FA1 A1, FB1 B1, int K,
                                          int nt_live = NT) {
  for (int k0 = 0; k0 < K; k0 += 8) {
    mma_kstep<NT, SA, SB>(acc0, k0, A0, B0, nt_live);
    mma_kstep<NT, SA, SB>(acc1, k0, A1, B1, nt_live);
  }
}

// ---- asynchronous copies (cp.async) ----------------------------------------
//
// Global -> shared without a trip through registers. `src_bytes` of the
// copy's 16 (or 4) are read and the rest of the destination is zero-
// filled; with 0 nothing is read. Both addresses must be aligned to the
// copy's size. A thread's copies land when cp_async_wait lets them;
// other threads see them after a barrier.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace mxtt
