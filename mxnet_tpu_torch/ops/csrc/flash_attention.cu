// Flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py::
// _fwd_kernel (launched by _flash_fwd). Same function: for q (B, H, Sq,
// D) and k, v (B, H, Skv, D),
//     o[b,h,i]   = sum_j softmax_j(s[i, j]) v[b,h,j]
//     lse[b,h,i] = log sum_j exp(s[i, j])          (float32)
// with s[i, j] = q'[i] . k[j] over the VISIBLE (i, j) pairs only:
//     j < kv_len[b]                        (per-row length; Skv if none)
//     j <= i + q_offset                    (when causal)
//     seg[b, i] == seg[b, j]               (when packed; Sq == Skv)
// q' is q * sm_scale rounded back to q's type, as the TPU wrapper
// pre-scales it. A row with no visible key gives exact zeros and
// lse = -1e30 (the TPU kernel's `seen` guard and l_safe division). All
// math in float32 on CUDA cores, for f32 inputs as for bf16/f16 (the
// TPU kernel runs f32 at HIGHEST precision: no TF32 here either).
//
// Design. On the TPU the key-tile axis is a sequential grid dimension
// and m, l and acc live in VMEM scratch between grid steps. Here
// blocks run in no order, so one block owns one (batch*head, 64-query
// tile) and LOOPS over 64-key tiles itself, with the running max m and
// sum l per query row in shared memory and the output accumulator in
// registers. 256 threads; in the two products each thread owns a 4 x 4
// tile of scores and a 4-row x D/16 slice of the output (register
// tiling: 8 shared-memory reads per 16 FMAs). Q, K, V and the score
// tile are staged in shared memory as f32 (K rows padded by one word:
// no bank conflicts). Whole key tiles are skipped as _block_visible
// does: the loop never reaches tiles at or past kv_len or above the
// causal diagonal, and with segment ids a tile none of whose ids falls
// in the query tile's [min, max] id range is skipped after reading its
// 64 ids (one __syncthreads_or); the ids are compared in the kernel,
// so the TPU's host-side range pre-pass and its lane/sublane id
// broadcasts are not needed. The ragged edges (Sq, Skv and D not
// multiples of the tiles) are masked by index. q, k, v and o may be
// any views whose last axis is contiguous (strides are arguments), so
// heads sliced out of a fused QKV projection need no copy, and o can
// be written straight into a (B, S, H, D) buffer.
//
// Bound. Operations: 4 * D flops per visible (i, j) pair (QK^T and PV);
// at BERT-base's S = 512, D = 64 that is 256 flops per byte of q, k, v
// and o in f32, above the card's f32 CUDA-core balance (67 TFLOP/s over
// 3.35 TB/s = 20 flops per byte), so the kernel is bound by operations
// (in bf16 against the tensor cores' 989 TFLOP/s, it would be bytes).
//
// What this simple design leaves on the table: the products run on
// CUDA cores (no wgmma / mma.sync, which bf16 would need to approach
// its bound); K and V tiles are loaded synchronously (no cp.async/TMA
// double-buffering); 64-query tiles give only B * H * Sq / 64 blocks.

#include "common.cuh"

namespace {

using mxtt::round_to;
using mxtt::store;
using mxtt::to_f32;

constexpr int kBQ = 64;         // queries per block
constexpr int kBK = 64;         // keys per loop turn
constexpr int kThreads = 256;
constexpr int kPS = kBK + 1;    // score tile row stride (floats)
constexpr float kNegInf = -1e30f;   // as the TPU kernel's sentinel
constexpr int kSegPadQ = -2, kSegPadK = -3;   // never equal to each other

struct Strides {                // element strides of (b, h, s); d is 1
  long long q[3], k[3], v[3], o[3];
};

// DP = D rounded up to 16, 32, 64, 128 or 256; columns D..DP-1 are
// zeros. At DP = 256 the tiles take 210 KB of shared memory (one block
// an SM).
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int32_t* __restrict__ kv_lens,
                 const int32_t* __restrict__ seg, T* __restrict__ o,
                 float* __restrict__ lse, Strides st, int H, int Sq, int Skv,
                 int D, float scale, int causal, int q_offset) {
  constexpr int KS = DP + 1;          // K row stride (floats)
  constexpr int DPT = DP / 16;        // output dims per thread
  extern __shared__ float smem[];
  float* qs = smem;                   // kBQ x DP
  float* ks = qs + kBQ * DP;          // kBK x KS
  float* vs = ks + kBK * KS;          // kBK x DP
  float* ps = vs + kBK * DP;          // kBQ x kPS (scores, then p)
  float* m_s = ps + kBQ * kPS;        // kBQ running max
  float* l_s = m_s + kBQ;             // kBQ running sum
  float* a_s = l_s + kBQ;             // kBQ rescale of this turn
  int* segq = reinterpret_cast<int*>(a_s + kBQ);   // kBQ
  int* segk = segq + kBQ;                           // kBK

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int q0 = blockIdx.y * kBQ;
  const int rows_here = min(kBQ, Sq - q0);
  int kvl = kv_lens != nullptr ? kv_lens[b] : Skv;
  kvl = max(0, min(kvl, Skv));
  // columns past col_end are invisible to every row of this tile
  int col_end = kvl;
  if (causal) col_end = min(col_end, q0 + rows_here + q_offset);
  const int n_tiles = col_end > 0 ? (col_end + kBK - 1) / kBK : 0;

  const T* qb = q + b * st.q[0] + h * st.q[1];
  const T* kb = k + b * st.k[0] + h * st.k[1];
  const T* vb = v + b * st.v[0] + h * st.v[1];
  for (int i = tid; i < kBQ * DP; i += kThreads) {
    const int r = i / DP, d = i - r * DP;
    float x = 0.f;
    if (r < rows_here && d < D)
      x = round_to(to_f32(qb[(long long)(q0 + r) * st.q[2] + d]) * scale,
                   T());
    qs[i] = x;
  }
  if (tid < kBQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
    segq[tid] = (seg != nullptr && tid < rows_here)
                    ? seg[(long long)b * Sq + q0 + tid] : kSegPadQ;
  }
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff;
  if (seg != nullptr) {
    for (int r = 0; r < rows_here; ++r) {
      qmin = min(qmin, segq[r]);
      qmax = max(qmax, segq[r]);
    }
  }

  const int ty = tid / 16, tx = tid % 16;     // product-phase layout
  const int srow = tid / 4, ssub = tid % 4;   // softmax-phase layout
  float acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBK;
    __syncthreads();              // the last turn's readers are done
    if (seg != nullptr) {
      int hit = 0;
      if (tid < kBK) {
        const int c = c0 + tid;
        int sk = kSegPadK;
        if (c < col_end) {
          sk = seg[(long long)b * Skv + c];
          hit = sk >= qmin && sk <= qmax;
        }
        segk[tid] = sk;
      }
      if (!__syncthreads_or(hit)) continue;   // disjoint ids: skip
    }
    for (int i = tid; i < kBK * DP; i += kThreads) {
      const int c = i / DP, d = i - c * DP;
      const int col = c0 + c;
      float kx = 0.f, vx = 0.f;
      if (col < col_end && d < D) {
        kx = to_f32(kb[(long long)col * st.k[2] + d]);
        vx = to_f32(vb[(long long)col * st.v[2] + d]);
      }
      ks[c * KS + d] = kx;
      vs[i] = vx;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = c0 + c;
        bool ok = r < rows_here && col < kvl;
        if (causal) ok = ok && col <= row + q_offset;
        if (seg != nullptr) ok = ok && segk[c] == segq[r];
        ps[r * kPS + c] = ok ? sc[i][j] : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: 4 threads per row, 16 contiguous columns each
    {
      float* pr = ps + srow * kPS + ssub * 16;
      const float m_prev = m_s[srow];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, pr[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_cur = fmaxf(m_prev, mx);
      // rows with no visible key yet keep m at the sentinel: exp(s - m)
      // would be 1 there, so p and alpha are forced to 0 until a real
      // score lands (the TPU kernel's `seen` guard)
      const bool seen = m_cur > kNegInf * 0.5f;
      const float alpha = seen ? expf(m_prev - m_cur) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = seen ? expf(pr[c] - m_cur) : 0.f;
        pr[c] = p;
        psum += p;
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      psum += __shfl_xor_sync(0xffffffffu, psum, 2);
      if (ssub == 0) {
        m_s[srow] = m_cur;
        l_s[srow] = l_s[srow] * alpha + psum;
        a_s[srow] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: rows ty + 16 i, dims tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = vs[c * DP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  // epilogue: o = acc / l_safe; lse = m + log(l), or -1e30 when l == 0
  T* ob = o + b * st.o[0] + h * st.o[1];
  float* lb = lse + (long long)bh * Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_here) continue;
    const float l = l_s[r];
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = ob + (long long)(q0 + r) * st.o[2];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(orow + d, acc[i][j] / l_safe);
    }
    if (tx == 0) lb[q0 + r] = l == 0.f ? kNegInf : m_s[r] + logf(l_safe);
  }
}

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * DP + (size_t)kBK * (DP + 1) +
                          (size_t)kBK * DP + (size_t)kBQ * kPS + 3 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* kvl, const int32_t* seg, void* o,
                   float* lse, const Strides& st, int B, int H, int Sq,
                   int Skv, int D, float scale, int causal, int q_offset,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t e = mxtt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * H, (Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), kvl, seg, static_cast<T*>(o), lse, st, H,
      Sq, Skv, D, scale, causal, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     const int32_t* kvl, const int32_t* seg, void* o,
                     float* lse, const Strides& st, int B, int H, int Sq,
                     int Skv, int D, float scale, int causal, int q_offset,
                     cudaStream_t s) {
  if (D <= 16)
    return launch<T, 16>(q, k, v, kvl, seg, o, lse, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
  if (D <= 32)
    return launch<T, 32>(q, k, v, kvl, seg, o, lse, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
  if (D <= 64)
    return launch<T, 64>(q, k, v, kvl, seg, o, lse, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
  if (D <= 128)
    return launch<T, 128>(q, k, v, kvl, seg, o, lse, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
  if (D <= 256)
    return launch<T, 256>(q, k, v, kvl, seg, o, lse, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (q, k, v and o share it). kv_lens (B,) and
// seg (B, S) are int32 or null; lse is (B, H, Sq) float32, contiguous.
// strides holds 12 element strides: (b, h, s) of q, k, v, then o.
// Returns the launch's cudaError_t (0 = launched).
extern "C" int mxtt_flash_attention_fwd(
    const void* q, const void* k, const void* v, const void* kv_lens,
    const void* seg, void* o, void* lse, const long long* strides, int B,
    int H, int Sq, int Skv, int D, float scale, int causal, int q_offset,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || Skv < 0 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const int32_t* kvl = static_cast<const int32_t*>(kv_lens);
  const int32_t* sg = static_cast<const int32_t*>(seg);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch<float>(q, k, v, kvl, sg, o, ls, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
    case 1:
      return (int)dispatch<__nv_bfloat16>(q, k, v, kvl, sg, o, ls, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
    case 2:
      return (int)dispatch<__half>(q, k, v, kvl, sg, o, ls, st, B, H, Sq, Skv, D, scale, causal, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
