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
// Design (Hopper redesign of the first port). The backward moves 3 *
// R * D * sizeof(T) bytes (x, dy in, dx out) for about 11 flops an
// element, so it is bound by memory, and what keeps it from the bound is
// bytes not in flight. dx: one warp per row (a block per row past D =
// 1024). dgamma and dbeta reduce ACROSS rows, which the TPU accumulates
// over its sequential grid into one output block. Blocks here run in no
// order, so the reduction takes two passes and no float atomics (the
// same bits every run).
//  - Rows of whole 16-byte vectors (the BERT trunk's 768, any D * size
//    a multiple of 16 with aligned x, dy, dx: layer_norm_bwd_vec_kernel):
//    the grid is as many blocks of 8 warps as can be resident at once,
//    each warp walking rows warp, warp + all warps, ...; a warp's next S
//    - 1 rows (S = 2 or 3) are copied by cp.async into its ring in
//    shared memory while it computes on this one, 16 bytes a copy, so
//    each warp keeps one or two rows of x and dy in flight without
//    holding them in registers. A lane reads back only the vectors it
//    copied. dx goes out in 16-byte stores. Each lane keeps its columns'
//    dgamma and dbeta partials in registers in row order, and the block
//    folds its 8 warps' through shared memory in warp order into one
//    partial row a block (about 2 x 132 of them, not one per 8 rows).
//  - Other rows up to D = 1024 (odd widths, unaligned starts): one warp
//    per row in registers, element by element, the partials in registers
//    and folded the same way (layer_norm_bwd_kernel).
//  - Past D = 1024: a block per row at a time, 16-byte vectors where the
//    rows are whole aligned vectors, each thread adding its columns'
//    terms straight into the block's partial row in device memory (read
//    and written by that thread alone, in row order).
//  - The fold (layer_norm_bwd_fold_kernel): 8 columns a block, 2 x
//    ceil(D / 8) blocks (192 at D = 768, past the card's 132 SMs), each
//    thread summing every 32nd partial row of its column with 8 loads in
//    flight, then the 32 sums in order: the same order every run.
//
// Bound. Memory: x and dy read once and dx written once, 3 * R * D *
// sizeof(T) bytes, plus gamma and 8 bytes of stats per row, plus the
// partials (2 * blocks * D f32 written and read again: 1.6 MB at D =
// 768 on 264 blocks, 2% of the rows' bytes at R = 8192).

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

// Fold the block's warps' dgamma and dbeta partials into its partial
// rows part[0][block] and part[1][block] ((2, blocks, D)), through
// `red` (kWarpsPerBlock x D floats of shared memory): put(k, row) writes
// this lane's partials of kind k (0 dgamma, 1 dbeta) into its warp's
// row, then each column is summed in warp order.
template <typename Put>
__device__ __forceinline__ void fold_warps(float* red, float* part, int D,
                                           Put put) {
  const int warp = threadIdx.x >> 5;
  float* out = part + (long long)blockIdx.x * D;
  const long long plane = (long long)gridDim.x * D;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    put(k, red + warp * D);
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

// dx per row; each block's dgamma and dbeta partials (sums over the
// rows it walked) to part[0][block] and part[1][block], (2, blocks, D).
// Any D <= 1024 and row start: element by element (lane l holds
// columns l, l + 32, ...).
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
  fold_warps(red, part, D, [&](int k, float* row) {
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int c = lane + 32 * i;
      if (c < D) row[c] = k == 0 ? pg[i] : pb[i];
    }
  });
}

// The same function on rows of whole 16-byte vectors (D * sizeof(T) a
// multiple of 16, x, dy and dx 16-byte aligned), D <= 1024, S >= 2
// stages. Each warp walks rows warp, warp + warps, ... of the grid and
// keeps a ring of S rows (x and dy, raw T) in its slice of shared
// memory, filled by cp.async: the copies of the next S - 1 rows are in
// flight while the warp computes on this one, and a lane reads back only
// the vectors it copied itself (vector vi = lane + 32 i of a row), so no
// barrier is needed between them. The lane keeps its columns' dgamma and
// dbeta partials in registers, in row order; the block folds its warps'
// in a fixed order as above.
template <typename T, int NV, int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_bwd_vec_kernel(const T* __restrict__ x,
                          const T* __restrict__ gamma,
                          const float* __restrict__ mean,
                          const float* __restrict__ rstd,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ part, int R, int D) {
  using V = mxtt::Vec16<T>;
  constexpr int VEC = V::N;
  extern __shared__ __align__(16) unsigned char lsm[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nvec = D / VEC;
  T* ring = reinterpret_cast<T*>(lsm) + (size_t)warp * S * 2 * D;
  float g[NV][VEC], pg[NV][VEC], pb[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int vi = lane + 32 * i;
    if (vi < nvec) {
      V::unpack(__ldg(reinterpret_cast<const uint4*>(gamma) + vi), g[i]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[i][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) pg[i][e] = pb[i][e] = 0.f;
  }
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  const long long row0 = (long long)blockIdx.x * kWarpsPerBlock + warp;
  // copies of row `row` into stage `st`; a group even when there is no
  // row, so that the groups count rows one to one
  auto prefetch = [&](long long row, int st) {
    if (row < R) {
      T* sx = ring + (size_t)st * 2 * D;
      T* sd = sx + D;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int vi = lane + 32 * i;
        if (vi < nvec) {
          mxtt::cp_async16(sx + vi * VEC, x + row * D + vi * VEC, 16);
          mxtt::cp_async16(sd + vi * VEC, dy + row * D + vi * VEC, 16);
        }
      }
    }
    mxtt::cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < S - 1; ++st) prefetch(row0 + st * stride, st);
  int k = 0;
  for (long long row = row0; row < R; row += stride, ++k) {
    prefetch(row + (S - 1) * stride, (k + S - 1) % S);
    mxtt::cp_async_wait<S - 1>();       // this row's copies have landed
    const T* sx = ring + (size_t)(k % S) * 2 * D;
    const T* sd = sx + D;
    const float mu = mean[row], rs = rstd[row];
    float xh[NV][VEC], dxh[NV][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float xv[VEC], dyv[VEC];
        V::unpack(*reinterpret_cast<const uint4*>(sx + vi * VEC), xv);
        V::unpack(*reinterpret_cast<const uint4*>(sd + vi * VEC), dyv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          xh[i][e] = (xv[e] - mu) * rs;
          dxh[i][e] = dyv[e] * g[i][e];
          s1 += dxh[i][e];
          s2 = fmaf(dxh[i][e], xh[i][e], s2);
          pg[i][e] = fmaf(dyv[e], xh[i][e], pg[i][e]);
          pb[i][e] += dyv[e];
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) xh[i][e] = dxh[i][e] = 0.f;
      }
    }
    const float m1 = warp_sum(s1) / (float)D;
    const float m2 = warp_sum(s2) / (float)D;
    uint4* dxr = reinterpret_cast<uint4*>(dx + row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec) {
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          v[e] = rs * (dxh[i][e] - m1 - xh[i][e] * m2);
        dxr[vi] = V::pack(v);
      }
    }
  }
  mxtt::cp_async_wait<0>();
  __syncthreads();                      // every warp is off its ring
  // the rings' memory holds the fold's kWarpsPerBlock x D floats
  fold_warps(reinterpret_cast<float*>(lsm), part, D, [&](int k, float* row) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int vi = lane + 32 * i;
      if (vi < nvec)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          row[vi * VEC + e] = k == 0 ? pg[i][e] : pb[i][e];
    }
  });
}

// out[k][c] = sum over the `blocks` partial rows of part[k][.][c] (k:
// dgamma, dbeta). Block (cg, k) takes 8 columns, so that 2 ceil(D / 8)
// blocks share the work (192 at D = 768): thread t sums column t % 8 of
// the partial rows t / 8, t / 8 + 32, ... (8 loads in flight; a warp
// reads four 32-byte pieces a step), then the 32 row groups' sums are
// added in order. The same order every run.
constexpr int kFoldCols = 8;
constexpr int kFoldGroups = kWarpsPerBlock * 32 / kFoldCols;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_bwd_fold_kernel(const float* __restrict__ part,
                           float* __restrict__ out, int blocks, int D) {
  __shared__ float red[kFoldGroups][kFoldCols];
  const int col = threadIdx.x % kFoldCols, grp = threadIdx.x / kFoldCols;
  const int c = blockIdx.x * kFoldCols + col;
  const float* p = part + (long long)blockIdx.y * blocks * D + c;
  float s = 0.f;
  if (c < D) {
    int i = grp;
    for (; i + 7 * kFoldGroups < blocks; i += 8 * kFoldGroups) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = p[(long long)(i + u * kFoldGroups) * D];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; i < blocks; i += kFoldGroups) s += p[(long long)i * D];
  }
  red[grp][col] = s;
  __syncthreads();
  if (threadIdx.x < kFoldCols && c < D) {
    float t = 0.f;
#pragma unroll 8
    for (int g = 0; g < kFoldGroups; ++g) t += red[g][col];
    out[(long long)blockIdx.y * D + c] = t;
  }
}

// D > 1024: block b walks rows b, b + blocks, ...; thread t owns the
// vectors (VEC elements; 1 where rows are not whole aligned 16-byte
// vectors) t, t + 256, ... of a row and adds their dgamma and dbeta
// terms to the block's partial rows part[0][b] and part[1][b] (zeroed
// first; each element read and written by its one thread, in row order).
// x and dy are read twice: the sums, then dx (the second time mostly
// from L1/L2).
template <typename T, int VEC>
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
  const int nvec = D / VEC;
  // VEC elements at e of a row (a 16-byte load where VEC > 1)
  auto ld = [&](const T* row, int vi, float (&out)[VEC]) {
    if constexpr (VEC == 1) {
      out[0] = to_f32(row[vi]);
    } else {
      mxtt::Vec16<T>::unpack(__ldg(reinterpret_cast<const uint4*>(row) + vi), out);
    }
  };
  for (int c = threadIdx.x; c < D; c += kLongThreads) pg[c] = pb[c] = 0.f;
  for (long long row = blockIdx.x; row < R; row += gridDim.x) {
    const T* xr = x + row * D;
    const T* dyr = dy + row * D;
    const float mu = mean[row], rs = rstd[row];
    float s1 = 0.f, s2 = 0.f;
    for (int vi = threadIdx.x; vi < nvec; vi += kLongThreads) {
      float xv[VEC], dyv[VEC], gv[VEC];
      ld(xr, vi, xv);
      ld(dyr, vi, dyv);
      ld(gamma, vi, gv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float xh = (xv[e] - mu) * rs;
        const float dxh = dyv[e] * gv[e];
        s1 += dxh;
        s2 = fmaf(dxh, xh, s2);
      }
    }
    const float m1 = block_sum(s1, red) / (float)D;
    const float m2 = block_sum(s2, red) / (float)D;
    T* dxr = dx + row * D;
    for (int vi = threadIdx.x; vi < nvec; vi += kLongThreads) {
      float xv[VEC], dyv[VEC], gv[VEC], v[VEC];
      ld(xr, vi, xv);
      ld(dyr, vi, dyv);
      ld(gamma, vi, gv);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const int c = vi * VEC + e;
        const float xh = (xv[e] - mu) * rs;
        v[e] = rs * (dyv[e] * gv[e] - m1 - xh * m2);
        pg[c] = fmaf(dyv[e], xh, pg[c]);
        pb[c] += dyv[e];
      }
      if constexpr (VEC == 1) {
        store(dxr + vi, v[0]);
      } else {
        reinterpret_cast<uint4*>(dxr)[vi] = mxtt::Vec16<T>::pack(v);
      }
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the blocks of `kern` that can be resident at once, at `smem` dynamic
// bytes a block (0 on error)
template <typename K>
int resident_blocks(K kern, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, kWarpsPerBlock * 32, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// the dgamma/dbeta fold over `blocks` partial rows
cudaError_t launch_fold(const float* part, float* dgb, int blocks, int D,
                        cudaStream_t s) {
  layer_norm_bwd_fold_kernel<<<dim3((D + kFoldCols - 1) / kFoldCols, 2),
                               kWarpsPerBlock * 32, 0, s>>>(part, dgb,
                                                            blocks, D);
  return cudaGetLastError();
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
  return launch_fold(part, dgb, blocks, D, stream);
}

// The ring kernel over at most `cap` blocks: as many as can be resident
// at once (each walks its share of the rows), not more than the rows
// need.
template <typename T, int NV, int S>
cudaError_t launch_bwd_vec(const void* x, const void* g, const float* mean,
                           const float* rstd, const void* dy, void* dx,
                           float* part, float* dgb, int R, int D, int cap,
                           cudaStream_t stream) {
  auto kern = layer_norm_bwd_vec_kernel<T, NV, S>;
  const size_t smem = (size_t)kWarpsPerBlock * S * 2 * D * sizeof(T);
  // the opt-in and the occupancy of the widest ring asked for so far
  // (the device's numbers: every card of a run is alike)
  static size_t allowed = 0;
  static int resident = 0, resident_d = 0;
  cudaError_t e = cudaSuccess;
  if (smem > allowed) {
    e = mxtt::allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  if (resident_d != D) {
    resident = resident_blocks(kern, smem);
    resident_d = D;
  }
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int blocks = min(cap, min(resident, (R + kWarpsPerBlock - 1) /
                                                kWarpsPerBlock));
  kern<<<blocks, kWarpsPerBlock * 32, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
      static_cast<const T*>(dy), static_cast<T*>(dx), part, R, D);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_fold(part, dgb, blocks, D, stream);
}

// stages of the ring: three where 8 warps' rings of three rows fit
// twice an SM (two blocks resident), else two
template <typename T, int NV>
cudaError_t dispatch_vec(const void* x, const void* g, const float* mean,
                         const float* rstd, const void* dy, void* dx,
                         float* part, float* dgb, int R, int D, int cap,
                         cudaStream_t s) {
  if ((size_t)kWarpsPerBlock * 3 * 2 * D * sizeof(T) <= 110 * 1024)
    return launch_bwd_vec<T, NV, 3>(x, g, mean, rstd, dy, dx, part, dgb, R,
                                    D, cap, s);
  return launch_bwd_vec<T, NV, 2>(x, g, mean, rstd, dy, dx, part, dgb, R, D,
                                  cap, s);
}

template <typename T>
cudaError_t dispatch_bwd(const void* x, const void* g, const float* mean,
                         const float* rstd, const void* dy, void* dx,
                         float* part, float* dgb, int R, int D, int blocks,
                         cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool vec = D % VEC == 0 && aligned16(x) && aligned16(dy) &&
                   aligned16(dx) && aligned16(g);
  if (D > 1024) {
    const int nb = min(blocks, R);
    if (vec)
      layer_norm_bwd_long_kernel<T, VEC><<<nb, kLongThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
          static_cast<const T*>(dy), static_cast<T*>(dx), part, R, D);
    else
      layer_norm_bwd_long_kernel<T, 1><<<nb, kLongThreads, 0, s>>>(
          static_cast<const T*>(x), static_cast<const T*>(g), mean, rstd,
          static_cast<const T*>(dy), static_cast<T*>(dx), part, R, D);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    return launch_fold(part, dgb, nb, D, s);
  }
  if (vec) {
    const int nv = (D / VEC + 31) / 32;   // vectors a lane
    if (nv <= 1) return dispatch_vec<T, 1>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
    if (nv <= 2) return dispatch_vec<T, 2>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
    if (nv <= 4) return dispatch_vec<T, 4>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
    if (nv <= 6) return dispatch_vec<T, 6>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
    if (nv <= 8) return dispatch_vec<T, 8>(x, g, mean, rstd, dy, dx, part, dgb, R, D, blocks, s);
    return cudaErrorInvalidValue;
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
// dgamma then dbeta. Launches the row kernel over at most `blocks`
// blocks (8 rows at a time up to D = 1024, one past it; the ring kernel
// no more than can be resident at once), then the fold; returns the
// first failing launch's cudaError_t.
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
