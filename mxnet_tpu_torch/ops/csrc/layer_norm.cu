// LayerNorm over the last axis, forward and backward, for Hopper
// (sm_90a).
//
// FORWARD. Replaces the TPU kernel mxnet_tpu/ops/pallas/layer_norm.py::
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
// cross-block reduction. That holds for D <= 1024 (32 values per lane
// at most). A longer row (GPT-sized widths, D = 2048 and up: the TPU
// kernel blocks any D) is one BLOCK's: its 256 threads walk the row in
// strides of 256, the sums are block reductions (warp shuffles, then
// the 8 warp sums in shared memory in a fixed order), and x is read
// three times (the sum, the centred sum, the write), the later reads
// mostly from L1/L2. Any D >= 1.
//
// Bound. Memory: x is read once and y written once, 2 * R * D *
// sizeof(T) bytes, plus gamma and beta and 8 bytes of stats per row;
// about 10 flops per element, far below what the card computes in the
// time the bytes take. The bound is those bytes over HBM bandwidth.
//
// Measured as device time alone (chip_smoke.py, torch.profiler; H100
// 80GB HBM3 at 700 W) at R = 4096, D = 768, f32: 9.28 us with the
// inputs cold in L2 against the 7.51 us HBM bound (81%), 6.49 us warm,
// both faster than F.layer_norm (14.49 / 12.46 us). The body is kept
// as it is. What it leaves: 4-byte (not 16-byte) loads for f32, 2-byte
// for bf16/f16, and gamma and beta re-read by every warp (they stay in
// L1/L2). At this size a call's cost is the host's: the wrapper
// (ops/layer_norm.py) keeps its Python to the checks and the launch.
//
// BACKWARD. Replaces _ln_bwd_kernel (launched by _ln_bwd). From x, dy
// (R, D), gamma and the forward's f32 mean and rstd per row:
//     xhat   = (x - mean) * rstd,  dxhat = dy * gamma
//     dx     = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))
//     dgamma = sum over rows of dy * xhat,  dbeta = sum over rows of dy
// dx in x's type, dgamma and dbeta in f32.
//
// Design. dx: one warp per row, in registers, as the forward (a block
// per row, walking it twice, past D = 1024). dgamma
// and dbeta reduce ACROSS rows, which the TPU accumulates over its
// sequential grid into one output block. Blocks here run in no order,
// so the reduction takes two passes and no float atomics (the result is
// the same run to run): each block walks a fixed set of rows (its warps
// stride over the rows by the grid's warp count), every lane keeps its
// columns' partial sums in registers, the block folds its 8 warps'
// partials through shared memory and writes one f32 row of partials
// per block; a second small kernel sums the partial rows per column.
// Past D = 1024 a block owns one row at a time and each thread a fixed
// set of columns, so the thread adds its columns' terms straight into
// the block's partial row in device memory (read and written by that
// thread alone, in row order: no race, the same sum every run).
//
// Bound. Memory: x and dy read once and dx written once, 3 * R * D *
// sizeof(T) bytes, plus gamma and 8 bytes of stats per row, plus the
// partials (2 * blocks * D f32, small beside the rows at R >> blocks).

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

constexpr int kLongThreads = kWarpsPerBlock * 32;   // a block per row

// Sum of v over the block's threads, the same in every thread: warp
// sums, then the 8 of them in a fixed order. `red` holds kWarpsPerBlock
// floats; the trailing barrier frees it for the next call.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w];
  __syncthreads();
  return s;
}

// D > 1024: block `row` normalises row `row`, walking it three times.
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
layer_norm_fwd_long_kernel(const T* __restrict__ x,
                           const T* __restrict__ gamma,
                           const T* __restrict__ beta, T* __restrict__ y,
                           float* __restrict__ mean_out,
                           float* __restrict__ rstd_out, int D, float eps) {
  __shared__ float red[kWarpsPerBlock];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  float s = 0.f;
  for (int c = threadIdx.x; c < D; c += kLongThreads) s += to_f32(xr[c]);
  const float mu = block_sum(s, red) / (float)D;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < D; c += kLongThreads) {
    const float v = to_f32(xr[c]) - mu;
    s2 = fmaf(v, v, s2);
  }
  const float rs = 1.f / sqrtf(block_sum(s2, red) / (float)D + eps);
  T* yr = y + row * D;
  for (int c = threadIdx.x; c < D; c += kLongThreads)
    store(yr + c,
          (to_f32(xr[c]) - mu) * rs * to_f32(gamma[c]) + to_f32(beta[c]));
  if (threadIdx.x == 0 && mean_out != nullptr) {
    mean_out[row] = mu;
    rstd_out[row] = rs;
  }
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, const void* b, void* y,
                     float* mean, float* rstd, int R, int D, float eps,
                     cudaStream_t s) {
  if (D > 1024) {
    layer_norm_fwd_long_kernel<T><<<R, kLongThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g),
        static_cast<const T*>(b), static_cast<T*>(y), mean, rstd, D, eps);
    return cudaGetLastError();
  }
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

// dx per row; each block's dgamma and dbeta partials (sums over the
// rows it walked) to part[0][block] and part[1][block], (2, blocks, D).
template <typename T, int VPL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                      const float* __restrict__ mean,
                      const float* __restrict__ rstd,
                      const T* __restrict__ dy, T* __restrict__ dx,
                      float* __restrict__ part, int R, int D) {
  extern __shared__ float red[];      // kWarpsPerBlock x D
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float g[VPL], pg[VPL], pb[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    g[i] = c < D ? to_f32(gamma[c]) : 0.f;
    pg[i] = pb[i] = 0.f;
  }
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  for (long long row = (long long)blockIdx.x * kWarpsPerBlock + warp;
       row < R; row += stride) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    const float mu = mean[row], rs = rstd[row];
    float xh[VPL], dxh[VPL];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      xh[i] = dxh[i] = 0.f;
      if (c < D) {
        const float dyv = to_f32(dyr[c]);
        xh[i] = (to_f32(xr[c]) - mu) * rs;
        dxh[i] = dyv * g[i];
        s1 += dxh[i];
        s2 = fmaf(dxh[i], xh[i], s2);
        pg[i] = fmaf(dyv, xh[i], pg[i]);
        pb[i] += dyv;
      }
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
    T* dxr = dx + row * D;
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) store(dxr + c, rs * (dxh[i] - m1 - xh[i] * m2));
    }
  }
  // fold the warps' partials: dgamma, then dbeta through the same buffer
  float* out = part + (long long)blockIdx.x * D;
  const long long plane = (long long)gridDim.x * D;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) red[warp * D + c] = k == 0 ? pg[i] : pb[i];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < D; c += kWarpsPerBlock * 32) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsPerBlock; ++w) s += red[w * D + c];
      out[k * plane + c] = s;
    }
    __syncthreads();
  }
}

// out[k][c] = sum over blocks of part[k][block][c]  (k: dgamma, dbeta)
__global__ void layer_norm_bwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ out,
                                             int blocks, int D) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= D) return;
  const float* p = part + (long long)blockIdx.y * blocks * D + c;
  float s = 0.f;
  for (int i = 0; i < blocks; ++i) s += p[(long long)i * D];
  out[blockIdx.y * D + c] = s;
}

// D > 1024: block b walks rows b, b + blocks, ...; thread t owns columns
// t, t + 256, ... and adds their dgamma and dbeta terms to the block's
// partial rows part[0][b] and part[1][b] (zeroed first).
template <typename T>
__global__ void __launch_bounds__(kLongThreads)
layer_norm_bwd_long_kernel(const T* __restrict__ x,
                           const T* __restrict__ gamma,
                           const float* __restrict__ mean,
                           const float* __restrict__ rstd,
                           const T* __restrict__ dy, T* __restrict__ dx,
                           float* __restrict__ part, int R, int D) {
  __shared__ float red[kWarpsPerBlock];
  float* pg = part + (long long)blockIdx.x * D;
  float* pb = pg + (long long)gridDim.x * D;
  for (int c = threadIdx.x; c < D; c += kLongThreads) pg[c] = pb[c] = 0.f;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = threadIdx.x; c < D; c += kLongThreads) {
      const float xh = (to_f32(xr[c]) - mu) * rs;
      const float dxh = to_f32(dyr[c]) * to_f32(gamma[c]);
      s1 += dxh;
      s2 = fmaf(dxh, xh, s2);
    }
    const float m1 = block_sum(s1, red) / (float)D;
    const float m2 = block_sum(s2, red) / (float)D;
    T* dxr = dx + row * D;
    for (int c = threadIdx.x; c < D; c += kLongThreads) {
      const float dyv = to_f32(dyr[c]);
      const float xh = (to_f32(xr[c]) - mu) * rs;
      store(dxr + c, rs * (dyv * to_f32(gamma[c]) - m1 - xh * m2));
      pg[c] = fmaf(dyv, xh, pg[c]);
      pb[c] += dyv;
    }
  }
}

template <typename T, int VPL>
cudaError_t launch_bwd(const void* x, const void* g, const float* mean,
                       const float* rstd, const void* dy, void* dx,
                       float* part, float* dgb, int R, int D, int blocks,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * kWarpsPerBlock * D;
  layer_norm_bwd_kernel<T, VPL>
      <<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
          static_cast<const T*>(dy), static_cast<T*>(dx), part, R, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_bwd_reduce_kernel<<<dim3((D + 255) / 256, 2), 256, 0, stream>>>(
      part, dgb, blocks, D);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* g, const float* mean,
                         const float* rstd, const void* dy, void* dx,
                         float* part, float* dgb, int R, int D, int blocks,
                         cudaStream_t s) {
  if (D > 1024) {
    layer_norm_bwd_long_kernel<T><<<blocks, kLongThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
        static_cast<const T*>(dy), static_cast<T*>(dx), part, R, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    layer_norm_bwd_reduce_kernel<<<dim3((D + 255) / 256, 2), 256, 0, s>>>(
        part, dgb, blocks, D);
    return cudaGetLastError();
  }
  const int need = (D + 31) / 32;
  if (need <= 1) return launch_bwd<T, 1>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 2) return launch_bwd<T, 2>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 4) return launch_bwd<T, 4>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 8) return launch_bwd<T, 8>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 16) return launch_bwd<T, 16>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 24) return launch_bwd<T, 24>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
  if (need <= 32) return launch_bwd<T, 32>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
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
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
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

// Plain C entry point (loaded with ctypes) of the backward. dtype as
// above (x, gamma, dy and dx share it); mean and rstd (R,) float32;
// part is (2, blocks, D) float32 scratch, dgb (2, D) float32 receives
// dgamma then dbeta. Launches the row kernel over `blocks` blocks (each
// 8 rows at a time up to D = 1024, one past it), then the reduction;
// returns the first failing launch's cudaError_t.
extern "C" int mxtt_layer_norm_bwd(const void* x, const void* gamma,
                                   const void* mean, const void* rstd,
                                   const void* dy, void* dx, void* part,
                                   void* dgb, int R, int D, int blocks,
                                   int dtype, void* stream) {
  if (R < 1 || D < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const float* mu = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  float* pt = static_cast<float*>(part);
  float* out = static_cast<float*>(dgb);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch_bwd<float>(x, gamma, mu, rs, dy, dx, pt, out, R, D, blocks, s);
    case 1: return (int)dispatch_bwd<__nv_bfloat16>(x, gamma, mu, rs, dy, dx, pt, out, R, D, blocks, s);
    case 2: return (int)dispatch_bwd<__half>(x, gamma, mu, rs, dy, dx, pt, out, R, D, blocks, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
