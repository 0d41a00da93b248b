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
// bytes; 750 MB at the BERT MLM shape 6144 x 30522 in f32); the
// backward reads them once and writes dx once, twice those bytes. One
// exponent per element is far below the f32 rate in the time the bytes
// take.
//
// What this simple design leaves on the table: scalar (not 16-byte)
// loads; the backward re-reads the logits where a fused head could
// produce dx while the forward still holds them.

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
xent_bwd_kernel(const T* __restrict__ x, const int32_t* __restrict__ labels,
                const float* __restrict__ lse, const float* __restrict__ g,
                T* __restrict__ dx, int V) {
  const long long row = blockIdx.x;
  const T* xr = x + row * V;
  T* dr = dx + row * V;
  const float r = lse[row], gr = g[row];
  const int lab = labels[row];
  for (int c = threadIdx.x; c < V; c += kThreads) {
    const float p = expf(to_f32(xr[c]) - r);
    store(dr + c, (c == lab ? p - 1.f : p) * gr);
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
  xent_bwd_kernel<T><<<N, kThreads, 0, s>>>(static_cast<const T*>(x), lab,
                                            lse, g, static_cast<T*>(dx), V);
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
