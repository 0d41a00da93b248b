// LayerNorm over the last axis, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/layer_norm.py::
// _ln_fwd_kernel (launched by _ln_fwd). Same function on x (R, D):
//     mean = sum(x) / D
//     var  = sum((x - mean)^2) / D        (the centred two-pass form)
//     rstd = 1 / sqrt(var + eps)
//     y    = (x - mean) * rstd * gamma + beta
// all in f32, y written in x's type, and (when asked) the f32 mean and
// rstd per row saved for the backward. Never E[x^2] - mean^2: BERT's
// eps is 1e-12, so the cancellation of that form would show.
//
// Design. The TPU kernel holds a (tile_r, D) block in VMEM. Here one
// WARP owns one row: the row is read once from device memory into
// registers (lane l holds columns l, l + 32, l + 64, ...: each load
// instruction of the warp reads 128 consecutive bytes), both sums are
// warp-shuffle reductions, and the output is written straight from the
// same registers. Nothing goes through shared memory and no row is
// read twice. 8 warps per block; rows are independent, so there is no
// cross-block reduction. D <= 1024 (32 values per lane at most).
//
// Bound. Memory: x is read once and y written once, 2 * R * D *
// sizeof(T) bytes, plus gamma and beta and 8 bytes of stats per row;
// about 10 flops per element, far below what the card computes in the
// time the bytes take. The bound is those bytes over HBM bandwidth.
//
// What this simple design leaves on the table: 4-byte (not 16-byte)
// loads for f32, 2-byte for bf16/f16; gamma and beta are re-read by
// every warp (they stay in L1/L2).

#include "common.cuh"

namespace {

using mxtt::store;
using mxtt::to_f32;

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// VPL = values per lane (>= ceil(D / 32)).
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const T* __restrict__ beta, T* __restrict__ y,
                      float* __restrict__ mean_out,
                      float* __restrict__ rstd_out, int R, int D,
                      float eps) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= R) return;
  const T* xr = x + row * D;
  float v[VPL];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = warp_sum(s) / (float)D;
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < D ? v[i] - mu : 0.f;
    s2 = fmaf(v[i], v[i], s2);
  }
  const float var = warp_sum(s2) / (float)D;
  const float rs = 1.f / sqrtf(var + eps);
  T* yr = y + row * D;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < D)
      store(yr + c, v[i] * rs * to_f32(gamma[c]) + to_f32(beta[c]));
  }
  if (lane == 0 && mean_out != nullptr) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

template <typename T, int VPL>
cudaError_t launch(const void* x, const void* g, const void* b, void* y,
                   float* mean, float* rstd, int R, int D, float eps,
                   cudaStream_t stream) {
  const int blocks = (R + kWarpsPerBlock - 1) / kWarpsPerBlock;
  layer_norm_fwd_kernel<T, VPL><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, R, D, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* b, void* y,
                     float* mean, float* rstd, int R, int D, float eps,
                     cudaStream_t s) {
  const int need = (D + 31) / 32;
  if (need <= 1) return launch<T, 1>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 2) return launch<T, 2>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 4) return launch<T, 4>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 8) return launch<T, 8>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 16) return launch<T, 16>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 24) return launch<T, 24>(x, g, b, y, mean, rstd, R, D, eps, s);
  if (need <= 32) return launch<T, 32>(x, g, b, y, mean, rstd, R, D, eps, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (x, gamma, beta and y share it). mean and
// rstd are (R,) float32 or both null. Returns the launch's cudaError_t.
extern "C" int mxtt_layer_norm_fwd(const void* x, const void* gamma,
                                   const void* beta, void* y, void* mean,
                                   void* rstd, int R, int D, float eps,
                                   int dtype, void* stream) {
  if (R < 1 || D < 1 || D > 1024) return (int)cudaErrorInvalidValue;
  float* mu = static_cast<float*>(mean);
  float* rs = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(x, gamma, beta, y, mu, rs, R, D, eps, s);
    case 1: return (int)dispatch<__nv_bfloat16>(x, gamma, beta, y, mu, rs, R, D, eps, s);
    case 2: return (int)dispatch<__half>(x, gamma, beta, y, mu, rs, R, D, eps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
