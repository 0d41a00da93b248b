// Fused softmax cross-entropy, forward and backward, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels mxnet_tpu/ops/pallas/softmax_xent.py::
// _xent_fwd_kernel (launched by _xent_fwd) and _xent_bwd_kernel
// (launched by _xent_bwd). Same functions, for logits x (N, V) and
// integer labels (N,):
//     forward:  lse[n]  = log sum_c exp(x[n, c])          (float32)
//               loss[n] = lse[n] - x[n, label[n]]         (float32)
//     backward: dx[n, c] = (exp(x[n, c] - lse[n]) - [c == label[n]]) g[n]
// all math in f32, dx in the logits' type. As on the TPU there is no
// ignore label: a label outside [0, V) picks nothing, so its row's loss
// is lse and its dx is softmax * g; callers mask rows before the call.
//
// Design. The TPU kernel streams (block_n, block_v) tiles of the
// logits through VMEM over a sequential vocab grid axis, carrying the
// running max, sum and picked logit in scratch. Here one block of 256
// threads owns one row: each thread walks the row with a stride of 256
// (neighbouring threads on neighbouring addresses) keeping its own
// running max and sum (the online log-sum-exp: a larger value rescales
// the sum once), then the block combines the 256 (max, sum) pairs with
// warp shuffles and one exchange through shared memory. The logit at
// the label is read directly. Only loss and lse (8 bytes per row) are
// written. V need not be a multiple of anything: the loops stop at V.
// The backward is one elementwise pass per row from the saved lse.
//
// Bound. Memory: the forward reads the logits once (N * V * sizeof(T)
// bytes; 800 MB at the BERT MLM shape 6541 x 30522 in f32); the
// backward reads them once and writes dx once, twice those bytes. One
// exponent per element is far below the f32 rate in the time the bytes
// take.
//
// What the forward leaves on the table: scalar (not 16-byte) loads. The
// backward (redesigned for Hopper: the comment above xent_bwd_kernel)
// re-reads the logits where a fused head could produce dx while the
// forward still holds them.

#include "common.cuh"

namespace {

using mxtt::store;
using mxtt::to_f32;

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;   // as the TPU kernel's sentinel

// merge the running (max, sum) pair (m2, l2) into (m, l)
__device__ __forceinline__ void lse_merge(float& m, float& l, float m2,
                                          float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse, int V) {
  __shared__ float sm[kThreads / 32], sl[kThreads / 32];
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  float m = kNegInf, l = 0.f;
  for (int c = threadIdx.x; c < V; c += kThreads) {
    const float v = to_f32(xr[c]);
    if (v > m) {
      l = l * expf(m - v) + 1.f;
      m = v;
    } else {
      l += expf(v - m);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    lse_merge(m, l, m2, l2);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sm[warp] = m;
    sl[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = sm[0];
    l = sl[0];
    for (int w = 1; w < kThreads / 32; ++w) lse_merge(m, l, sm[w], sl[w]);
    const float r = m + logf(l);
    const int lab = labels[row];
    const float picked = (lab >= 0 && lab < V) ? to_f32(xr[lab]) : 0.f;
    lse[row] = r;
    loss[row] = r - picked;
  }
}

// 2^x on the special-function unit (ex2.approx: relative error below
// 2^-22; results below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Backward (Hopper redesign): one block of 256 threads a row. The row's
// head, up to its first 16-byte boundary, and its tail past the last
// whole vector go element by element; the rest as 16-byte vectors (4
// f32, 8 bf16/f16), each thread keeping kInFlight of them loaded before
// it computes and stores any (streaming loads and stores: the logits
// are read once, dx is not read again here). x and dx rows share their
// offset from a 16-byte boundary (`vec`, checked by the entry point;
// otherwise the whole row goes element by element). p = 2^(x log2(e) -
// lse log2(e)) on the special-function unit: one FMA and one ex2 an
// element, where expf costs a range reduction and a polynomial. Its
// error against expf(x - lse): the FMA's rounding of the exponent (half
// an ulp of |x - lse| log2(e), 2^-19 at |x - lse| < 22) plus ex2's
// 2^-22, both relative to p: below 3e-6 of p, inside the kernel tests'
// 1e-5.
constexpr int kInFlight = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, int V, int vec) {
  using W = mxtt::Vec16<T>;
  constexpr int VEC = W::N;
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const float gr = g[row], nl = -lse[row] * kLog2e;
  const int lab = labels[row];
  auto grad = [&](int c, float xv) {
    const float p = ex2(fmaf(xv, kLog2e, nl));
    return (c == lab ? p - 1.f : p) * gr;
  };
  // [0, head) and [tail, V) element by element, [head, tail) in vectors
  int head = V, nvec = 0;
  if (vec) {
    const int mis = (int)(reinterpret_cast<uintptr_t>(xr) % 16 / sizeof(T));
    head = min(V, mis == 0 ? 0 : VEC - mis);
    nvec = (V - head) / VEC;
  }
  const int tail = head + nvec * VEC;
  for (int c = threadIdx.x; c < head; c += kThreads)
    store(dr + c, grad(c, to_f32(xr[c])));
  for (int c = tail + threadIdx.x; c < V; c += kThreads)
    store(dr + c, grad(c, to_f32(xr[c])));
  const uint4* xv = reinterpret_cast<const uint4*>(xr + head);
  uint4* dv = reinterpret_cast<uint4*>(dr + head);
  for (int v0 = threadIdx.x; v0 < nvec; v0 += kInFlight * kThreads) {
    uint4 w[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int vi = v0 + u * kThreads;
      if (vi < nvec) w[u] = __ldcs(xv + vi);
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const int vi = v0 + u * kThreads;
      if (vi < nvec) {
        float f[VEC];
        W::unpack(w[u], f);
        const int c0 = head + vi * VEC;
#pragma unroll
        for (int e = 0; e < VEC; ++e) f[e] = grad(c0 + e, f[e]);
        __stcs(dv + vi, W::pack(f));
      }
    }
  }
}

template <typename T>
cudaError_t launch_fwd(const void* x, const int32_t* lab, float* loss,
                       float* lse, int N, int V, cudaStream_t s) {
  xent_fwd_kernel<T><<<N, kThreads, 0, s>>>(static_cast<const T*>(x), lab,
                                            loss, lse, V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const int32_t* lab, const float* lse,
                       const float* g, void* dx, int N, int V,
                       cudaStream_t s) {
  // rows of x and dx equally far from a 16-byte boundary
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 ==
                  reinterpret_cast<uintptr_t>(dx) % 16;
  xent_bwd_kernel<T><<<N, kThreads, 0, s>>>(static_cast<const T*>(x), lab,
                                            lse, g, static_cast<T*>(dx), V,
                                            vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (the logits' and dx's type). x (N, V)
// contiguous; labels (N,) int32; loss, lse and g (N,) float32. Each
// returns its launch's cudaError_t (0 = launched).
extern "C" int mxtt_softmax_xent_fwd(const void* x, const void* labels,
                                     void* loss, void* lse, int N, int V,
                                     int dtype, void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int32_t* lab = static_cast<const int32_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_fwd<float>(x, lab, lo, ls, N, V, s);
    case 1: return (int)launch_fwd<__nv_bfloat16>(x, lab, lo, ls, N, V, s);
    case 2: return (int)launch_fwd<__half>(x, lab, lo, ls, N, V, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int mxtt_softmax_xent_bwd(const void* x, const void* labels,
                                     const void* lse, const void* g,
                                     void* dx, int N, int V, int dtype,
                                     void* stream) {
  if (N < 1 || V < 1) return (int)cudaErrorInvalidValue;
  const int32_t* lab = static_cast<const int32_t*>(labels);
  const float* ls = static_cast<const float*>(lse);
  const float* gr = static_cast<const float*>(g);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_bwd<float>(x, lab, ls, gr, dx, N, V, s);
    case 1: return (int)launch_bwd<__nv_bfloat16>(x, lab, ls, gr, dx, N, V, s);
    case 2: return (int)launch_bwd<__half>(x, lab, ls, gr, dx, N, V, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
