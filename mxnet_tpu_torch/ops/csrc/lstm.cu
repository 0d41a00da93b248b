// Whole-sequence LSTM recurrence, forward and backward, for Hopper
// (sm_90a).
//
// FORWARD. Replaces the TPU kernel mxnet_tpu/ops/pallas/lstm.py::
// _lstm_fwd_kernel (launched by _lstm_fwd). One layer and direction
// over the whole sequence. With gin (T, N, 4H) the input-side gate
// projections, W (H, 4H) the recurrent weight and (h0, c0) (N, H):
//     z      = gin[t] + round(h) @ W            f32 products and sums
//     i, f, o = sigmoid(z[i|f|o]),  g = tanh(z[g])   (gate order i,f,g,o)
//     c      = f * c + i * g,   h = o * tanh(c)      f32 carry
//     out[t] = h, cseq[t] = c, gates[t] = [i|f|g|o]  in gin's type
// where round(h) is h in W's type (the TPU kernel rounds the carry to
// W's type before the product).
//
// BACKWARD. Replaces _lstm_bwd_kernel (launched by _lstm_bwd). Walks
// time in reverse from the saved gates, cseq and out:
//     dh   = dout[t] + dh_carry
//     dc   = dh * o * (1 - tanh(c_t)^2) + dc_carry + dcseq[t]
//     dgin = [dc*g*i(1-i) | dc*c_{t-1}*f(1-f) | dc*i(1-g^2) |
//             dh*tanh(c_t)*o(1-o)]                  (written in gates' type)
//     dh_carry = round(dgin) @ W^T,  dc_carry = dc * f
//     dW      += round(h_{t-1})^T @ round(dgin)     f32
// with h_{-1}, c_{-1} = h0, c0. dh0, dc0 (the carries after step 0) and
// dW come out in f32.
//
// Design. The TPU kernel keeps all of W (6.8 MB at H = 650 in f32) in
// VMEM for the T sequential grid steps. An SM has at most 227 KB of
// shared memory, so here ONE persistent cooperative grid splits the
// hidden units: block j owns u consecutive units and their four gate
// columns (k, H+k, 2H+k, 3H+k), u = ceil(H / SMs). Its slice of W
// (H x 4u) stays in shared memory for all T steps, and the gate
// nonlinearities and the c carry are local to the block. Only h crosses
// blocks, once a step: each block writes its units of out[t], the grid
// syncs (cooperative_groups::grid_group::sync), and every block reads
// all of out[t] back (ld.global.cg, never through L1) as the next
// step's h. Reading h back in out's type is exactly the TPU kernel's
// rounding of h to W's type. Within a block, rows of the batch go in
// passes of P rows staged in shared memory; each thread takes one row
// and a 1/KS share of the H-long dot products for all 4u columns, and
// the KS partial sums meet in shared memory, summed in a fixed order by
// all threads at once. Tiles are staged with 16 loads in flight per
// thread before any store, so a pass waits out one memory latency per
// 16 values, not per value; each step's gin is fetched under its dot
// products.
//
// The backward splits the same way. Block j computes dgin for its own
// units (all it needs is local: the carries, the saved gates, c_t and
// c_{t-1}), writes them to dgin[t] and syncs the grid; then it reads
// all of dgin[t] back to form dh_{t-1} for its units from W's rows of
// those units (4H x u, in shared memory), and adds h_{t-1}^T times its
// own dgin columns into its columns of dW (H x 4u, f32, in shared
// memory, written once at the end). No atomics anywhere: the same bits
// every run. W is taken by strides, so MXNet's (4H, H) h2h weight is
// read as it is and dW is written in the same layout.
//
// Bound. Operations: 2*T*N*H*4H flops forward, twice that backward, on
// the CUDA cores in f32 (67 TFLOP/s); bytes: gin, out, cseq, gates and
// W once each. At the word LM's N = 32 the flops win; the recurrence
// itself (T grid syncs, each step's h or dgin re-read by every block)
// is what this simple design pays on top.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxtt::store;
using mxtt::to_f32;

constexpr int kThreads = 256;
constexpr int kMaxUnits = 8;      // units per block at most
constexpr int kMaxSplit = 32;     // KS at most
constexpr int kNoFit = 1001;      // the shape does not fit (see plan)

// a value written by another block in this launch: read through L2
__device__ __forceinline__ float ldcg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}
__device__ __forceinline__ float ldcg(const __half* p) {
  return __half2float(
      __ushort_as_half(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// Fill `count` shared-memory slots, slot e with src(e) at dst(e). Each
// thread has kInFlight loads outstanding before it stores any, so a
// tile costs one memory latency per kInFlight values, not per value.
constexpr int kInFlight = 16;
template <typename Src, typename Dst>
__device__ __forceinline__ void stage(int count, Src src, Dst dst) {
  for (int e0 = threadIdx.x; e0 < count; e0 += kInFlight * blockDim.x) {
    float v[kInFlight];
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int e = e0 + b * blockDim.x;
      v[b] = e < count ? src(e) : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kInFlight; ++b) {
      const int e = e0 + b * blockDim.x;
      if (e < count) *dst(e) = v[b];
    }
  }
}

// Shared memory of the forward, in floats: W slice H x 4U, the h tile
// P x (H | 1) (odd row stride: rows fall in different banks) and the
// partial sums KS x P x 4U.
__host__ __device__ inline size_t fwd_smem_floats(int H, int U, int P,
                                                  int KS) {
  return (size_t)H * 4 * U + (size_t)P * (H | 1) +
         (KS > 1 ? (size_t)KS * P * 4 * U : 0);
}

// Backward: W rows 4H x UP (UP = U rounded up to 4, float4 reads), dW
// H x 4U, the dgin tile P x (4H | 1), the h_{t-1} tile P x (H | 1) and
// the partial sums KS x P x UP.
__host__ __device__ inline int pad4(int u) { return (u + 3) & ~3; }
__host__ __device__ inline size_t bwd_smem_floats(int H, int U, int P,
                                                  int KS) {
  return (size_t)4 * H * pad4(U) + (size_t)H * 4 * U +
         (size_t)P * ((4 * H) | 1) + (size_t)P * (H | 1) +
         (KS > 1 ? (size_t)KS * P * pad4(U) : 0);
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_kernel(const T* __restrict__ gin, const T* __restrict__ w,
                long long sk, long long sg, const T* __restrict__ h0,
                const T* __restrict__ c0, T* out, T* __restrict__ cseq,
                T* __restrict__ gates, float* __restrict__ cbuf, int steps,
                int N, int H, int P, int KS) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C = 4 * U;                 // columns of the slice
  const int G = 4 * H;
  const int unit0 = blockIdx.x * U;
  const int nu = min(U, H - unit0);
  const int hs = H | 1;
  float* w_s = smem;                       // [k][gate * U + j]
  float* h_s = w_s + (size_t)H * C;        // [row][k], stride hs
  float* red_s = h_s + (size_t)P * hs;     // [s][row][c]

  stage(H * C,
        [&](int e) {
          const int k = e / C, c = e % C, gate = c / U, j = c % U;
          return j < nu ? to_f32(w[k * sk + (long long)(gate * H + unit0 + j) * sg])
                        : 0.f;
        },
        [&](int e) { return w_s + e; });
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int row = threadIdx.x % P;
  const int s = threadIdx.x / P;
  for (int t = 0; t < steps; ++t) {
    const T* hsrc = t == 0 ? h0 : out + (size_t)(t - 1) * N * H;
    for (int r0 = 0; r0 < N; r0 += P) {
      const int rows = min(P, N - r0);
      const T* tile = hsrc + (size_t)r0 * H;     // rows x H, contiguous
      stage(rows * H, [&](int e) { return ldcg(tile + e); },
            [&](int e) { return h_s + (e / H) * hs + e % H; });
      __syncthreads();
      const bool head = s == 0 && row < rows;
      float gz[C];           // this row's gin, fetched under the products
      if (head) {
        const size_t zb = ((size_t)t * N + r0 + row) * G + unit0;
#pragma unroll
        for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
          for (int j = 0; j < U; ++j)
            gz[gate * U + j] = j < nu ? to_f32(gin[zb + gate * H + j]) : 0.f;
        }
      }
      float acc[C];
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] = 0.f;
      const bool mine = s < KS && row < rows;
      if (mine) {
        const float* hr = h_s + row * hs;
        for (int k = s; k < H; k += KS) {
          const float hv = hr[k];
          const float4* wr = reinterpret_cast<const float4*>(w_s + k * C);
#pragma unroll
          for (int q = 0; q < U; ++q) {
            const float4 w4 = wr[q];
            acc[4 * q + 0] = fmaf(hv, w4.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(hv, w4.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(hv, w4.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(hv, w4.w, acc[4 * q + 3]);
          }
        }
      }
      if (KS > 1) {
        if (mine) {
#pragma unroll
          for (int c = 0; c < C; ++c) red_s[(s * P + row) * C + c] = acc[c];
        }
        __syncthreads();
        // every (row, column) sum in the split order 0..KS-1, in place
        for (int e = threadIdx.x; e < rows * C; e += blockDim.x) {
          float v = red_s[e];
          for (int q = 1; q < KS; ++q) v += red_s[q * P * C + e];
          red_s[e] = v;
        }
        __syncthreads();
        if (head) {
#pragma unroll
          for (int c = 0; c < C; ++c) acc[c] = red_s[row * C + c];
        }
      }
      if (head) {
        const int n = r0 + row;
        const size_t zb = ((size_t)t * N + n) * G;
        const size_t hb = ((size_t)t * N + n) * H;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          if (j < nu) {
            const int unit = unit0 + j;
            const float zi = gz[0 * U + j] + acc[0 * U + j];
            const float zf = gz[1 * U + j] + acc[1 * U + j];
            const float zg = gz[2 * U + j] + acc[2 * U + j];
            const float zo = gz[3 * U + j] + acc[3 * U + j];
            const float i = sigmoid_f(zi), f = sigmoid_f(zf);
            const float g = tanhf(zg), o = sigmoid_f(zo);
            const float cp = t == 0 ? to_f32(c0[(size_t)n * H + unit])
                                    : cbuf[(size_t)n * H + unit];
            const float cn = f * cp + i * g;
            const float hn = o * tanhf(cn);
            cbuf[(size_t)n * H + unit] = cn;
            store(out + hb + unit, hn);
            store(cseq + hb + unit, cn);
            store(gates + zb + unit, i);
            store(gates + zb + H + unit, f);
            store(gates + zb + 2 * H + unit, g);
            store(gates + zb + 3 * H + unit, o);
          }
        }
      }
      __syncthreads();   // the tile is reloaded by the next pass
    }
    if (t + 1 < steps) grid.sync();   // out[t] complete for every block
  }
}

template <typename T, int U>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cseq,
                const T* __restrict__ out, const T* __restrict__ w,
                long long sk, long long sg, const T* __restrict__ h0,
                const T* __restrict__ c0, const T* __restrict__ dout,
                const T* __restrict__ dcseq, T* dgin, float* dh_c,
                float* dc_c, float* __restrict__ dw, int steps, int N, int H,
                int P, int KS) {
  extern __shared__ __align__(16) float smem[];
  constexpr int C = 4 * U;
  constexpr int UP = (U + 3) & ~3;
  const int G = 4 * H;
  const int unit0 = blockIdx.x * U;
  const int nu = min(U, H - unit0);
  const int hs = H | 1, gs = G | 1;
  float* wr_s = smem;                          // [g][UP]: W[unit0 + j][g]
  float* dw_s = wr_s + (size_t)G * UP;         // [k][gate * U + j]
  float* dg_s = dw_s + (size_t)H * C;          // [row][g], stride gs
  float* hp_s = dg_s + (size_t)P * gs;         // [row][k], stride hs
  float* red_s = hp_s + (size_t)P * hs;        // [s][row][UP]

  stage(G * UP,
        [&](int e) {
          const int g = e / UP, j = e % UP;
          return j < nu ? to_f32(w[(long long)(unit0 + j) * sk + (long long)g * sg])
                        : 0.f;
        },
        [&](int e) { return wr_s + e; });
  for (int e = threadIdx.x; e < H * C; e += blockDim.x) dw_s[e] = 0.f;
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const int row = threadIdx.x % P;
  const int s = threadIdx.x / P;
  for (int t = steps - 1; t >= 0; --t) {
    // A: dgin[t] for this block's units, from local values only
    for (int p = threadIdx.x; p < N * nu; p += blockDim.x) {
      const int n = p / nu, unit = unit0 + p % nu;
      const size_t zb = ((size_t)t * N + n) * G;
      const size_t hb = ((size_t)t * N + n) * H;
      const size_t sb = (size_t)n * H + unit;
      const float i = to_f32(gates[zb + unit]);
      const float f = to_f32(gates[zb + H + unit]);
      const float g = to_f32(gates[zb + 2 * H + unit]);
      const float o = to_f32(gates[zb + 3 * H + unit]);
      const float ct = to_f32(cseq[hb + unit]);
      const float cp = t == 0 ? to_f32(c0[sb]) : to_f32(cseq[hb - (size_t)N * H + unit]);
      const float tc = tanhf(ct);
      const float dh = to_f32(dout[hb + unit]) + dh_c[sb];
      const float dc = dh * o * (1.f - tc * tc) + dc_c[sb] + to_f32(dcseq[hb + unit]);
      store(dgin + zb + unit, dc * g * i * (1.f - i));
      store(dgin + zb + H + unit, dc * cp * f * (1.f - f));
      store(dgin + zb + 2 * H + unit, dc * i * (1.f - g * g));
      store(dgin + zb + 3 * H + unit, dh * tc * o * (1.f - o));
      dc_c[sb] = dc * f;
    }
    grid.sync();   // dgin[t] complete for every block
    // B: dh_{t-1} = dgin[t] @ W^T for this block's units; dW += h^T dgin
    const T* hsrc = t == 0 ? h0 : out + (size_t)(t - 1) * N * H;
    const T* dsrc = dgin + (size_t)t * N * G;
    for (int r0 = 0; r0 < N; r0 += P) {
      const int rows = min(P, N - r0);
      const T* dtile = dsrc + (size_t)r0 * G;    // rows x 4H, contiguous
      const T* htile = hsrc + (size_t)r0 * H;    // rows x H, contiguous
      stage(rows * G, [&](int e) { return ldcg(dtile + e); },
            [&](int e) { return dg_s + (e / G) * gs + e % G; });
      stage(rows * H, [&](int e) { return to_f32(htile[e]); },
            [&](int e) { return hp_s + (e / H) * hs + e % H; });
      __syncthreads();
      float acc[UP];
#pragma unroll
      for (int j = 0; j < UP; ++j) acc[j] = 0.f;
      const bool mine = s < KS && row < rows;
      if (mine) {
        const float* dr = dg_s + row * gs;
        for (int g = s; g < G; g += KS) {
          const float dv = dr[g];
          const float4* wr = reinterpret_cast<const float4*>(wr_s + g * UP);
#pragma unroll
          for (int q = 0; q < UP / 4; ++q) {
            const float4 w4 = wr[q];
            acc[4 * q + 0] = fmaf(dv, w4.x, acc[4 * q + 0]);
            acc[4 * q + 1] = fmaf(dv, w4.y, acc[4 * q + 1]);
            acc[4 * q + 2] = fmaf(dv, w4.z, acc[4 * q + 2]);
            acc[4 * q + 3] = fmaf(dv, w4.w, acc[4 * q + 3]);
          }
        }
      }
      if (KS > 1) {
        if (mine) {
#pragma unroll
          for (int j = 0; j < UP; ++j) red_s[(s * P + row) * UP + j] = acc[j];
        }
        __syncthreads();
        for (int e = threadIdx.x; e < rows * UP; e += blockDim.x) {
          float v = red_s[e];
          for (int q = 1; q < KS; ++q) v += red_s[q * P * UP + e];
          red_s[e] = v;
        }
        __syncthreads();
        if (s == 0 && row < rows) {
#pragma unroll
          for (int j = 0; j < UP; ++j) acc[j] = red_s[row * UP + j];
        }
      }
      if (s == 0 && row < rows) {
        const size_t sb = (size_t)(r0 + row) * H + unit0;
#pragma unroll
        for (int j = 0; j < U; ++j)
          if (j < nu) dh_c[sb + j] = acc[j];
      }
      // dW[k][cols] += sum over the tile's rows of h[row][k] * dgin[row][cols]
      for (int k = threadIdx.x; k < H; k += blockDim.x) {
        float a[C];
#pragma unroll
        for (int c = 0; c < C; ++c) a[c] = dw_s[k * C + c];
        for (int n = 0; n < rows; ++n) {
          const float hv = hp_s[n * hs + k];
          const float* dr = dg_s + n * gs + unit0;
#pragma unroll
          for (int gate = 0; gate < 4; ++gate) {
#pragma unroll
            for (int j = 0; j < U; ++j)
              if (j < nu)
                a[gate * U + j] = fmaf(hv, dr[gate * H + j], a[gate * U + j]);
          }
        }
#pragma unroll
        for (int c = 0; c < C; ++c) dw_s[k * C + c] = a[c];
      }
      __syncthreads();   // the tiles are reloaded by the next pass
    }
  }
  for (int e = threadIdx.x; e < H * C; e += blockDim.x) {
    const int k = e / C, c = e % C, gate = c / U, j = c % U;
    if (j < nu) dw[k * sk + (long long)(gate * H + unit0 + j) * sg] = dw_s[e];
  }
}

template <typename T, int U>
const void* fwd_fn() { return reinterpret_cast<const void*>(&lstm_fwd_kernel<T, U>); }
template <typename T, int U>
const void* bwd_fn() { return reinterpret_cast<const void*>(&lstm_bwd_kernel<T, U>); }

template <typename T>
const void* kernel_for(int bwd, int u) {
  switch (u) {
#define MXTT_LSTM_U(n) \
  case n: return bwd ? bwd_fn<T, n>() : fwd_fn<T, n>();
    MXTT_LSTM_U(1) MXTT_LSTM_U(2) MXTT_LSTM_U(3) MXTT_LSTM_U(4)
    MXTT_LSTM_U(5) MXTT_LSTM_U(6) MXTT_LSTM_U(7) MXTT_LSTM_U(8)
#undef MXTT_LSTM_U
    default: return nullptr;
  }
}

const void* kernel_for(int bwd, int u, int dtype) {
  switch (dtype) {
    case 0: return kernel_for<float>(bwd, u);
    case 1: return kernel_for<__nv_bfloat16>(bwd, u);
    case 2: return kernel_for<__half>(bwd, u);
    default: return nullptr;
  }
}

int pow2_floor(int x) {
  int p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

}  // namespace

// Plan the grid of one launch (plain C entry point, loaded with
// ctypes). bwd: 0 forward, 1 backward; dtype as in common.cuh. Fills
// plan[0..7] = {blocks, units per block u, rows per pass P, dot splits
// KS, dynamic shared bytes, resident blocks per SM, SMs, shared bytes a
// block may have}. Returns 0, kNoFit (1001) when the shape cannot run
// co-resident with its W slice in shared memory (plan then holds the
// numbers that failed), or a cudaError_t.
extern "C" int mxtt_lstm_plan(int bwd, int N, int H, int dtype, void* plan_out,
                              void* stream) {
  (void)stream;
  int* plan = static_cast<int*>(plan_out);
  for (int i = 0; i < 8; ++i) plan[i] = 0;
  if (N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, optin = 0, coop = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err) return (int)err;
  if (!coop) return (int)cudaErrorNotSupported;
  const int u = (H + sms - 1) / sms;
  const int blocks = (H + u - 1) / u;
  plan[0] = blocks; plan[1] = u; plan[6] = sms; plan[7] = optin;
  // rows per pass: as many as shared memory takes, at most one per thread
  const size_t base = bwd ? bwd_smem_floats(H, u, 0, 1) : fwd_smem_floats(H, u, 0, 1);
  const size_t per_row = bwd ? (size_t)(((4 * H) | 1) + (H | 1)) : (size_t)(H | 1);
  const size_t per_row_red = (size_t)kMaxSplit * (bwd ? pad4(u) : 4 * u);
  long long avail = (long long)optin / 4 - (long long)base;
  int P = avail > 0 ? (int)(avail / (long long)(per_row + per_row_red)) : 0;
  P = P < N ? P : N;
  P = P < kThreads ? P : kThreads;
  if (u > kMaxUnits || P < 1) {
    plan[4] = (int)(4 * (base + per_row + per_row_red));   // one row's need
    return kNoFit;
  }
  int KS = pow2_floor(kThreads / P);
  KS = KS < kMaxSplit ? KS : kMaxSplit;
  const size_t smem = 4 * (bwd ? bwd_smem_floats(H, u, P, KS) : fwd_smem_floats(H, u, P, KS));
  plan[2] = P; plan[3] = KS; plan[4] = (int)smem;
  const void* fn = kernel_for(bwd, u, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  err = mxtt::allow_smem(fn, smem);
  int per_sm = 0;
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, smem);
  if (err) return (int)err;
  plan[5] = per_sm;
  if (per_sm * sms < blocks) return kNoFit;
  return 0;
}

// Plain C entry point of the forward (loaded with ctypes): one
// cooperative launch over the planned grid. gin (T, N, 4H), h0 and c0
// (N, H), out and cseq (T, N, H), gates (T, N, 4H): contiguous, of type
// `dtype`; w (H, 4H) of the same type at strides (sk, sg) in elements;
// cbuf (N, H) float32 scratch (the c carry). Returns the launch's
// cudaError_t.
extern "C" int mxtt_lstm_fwd(const void* gin, const void* w, long long sk,
                             long long sg, const void* h0, const void* c0,
                             void* out, void* cseq, void* gates, void* cbuf,
                             int T, int N, int H, int dtype, int blocks, int u,
                             int P, int KS, int smem, void* stream) {
  if (T < 1 || N < 1 || H < 1 || u < 1 || u > kMaxUnits || blocks * u < H ||
      (blocks - 1) * u >= H || P < 1 || KS < 1 || P * KS > kThreads)
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(0, u, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* cb = static_cast<float*>(cbuf);
  void* args[] = {(void*)&gin, (void*)&w, &sk, &sg, (void*)&h0, (void*)&c0,
                  &out, &cseq, &gates, &cb, &T, &N, &H, &P, &KS};
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err)
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                      (size_t)smem,
                                      static_cast<cudaStream_t>(stream));
  if (!err) err = cudaGetLastError();
  return (int)err;
}

// Plain C entry point of the backward. gates, dgin (T, N, 4H); cseq,
// out, dout, dcseq (T, N, H); h0, c0 (N, H): contiguous, of type
// `dtype`; w at strides (sk, sg). dh0 and dc0 (N, H) float32 must hold
// zeros (they are the carries and end as dh0, dc0); dw float32 at the
// same strides as w receives dW. Returns the launch's cudaError_t.
extern "C" int mxtt_lstm_bwd(const void* gates, const void* cseq,
                             const void* out, const void* w, long long sk,
                             long long sg, const void* h0, const void* c0,
                             const void* dout, const void* dcseq, void* dgin,
                             void* dh0, void* dc0, void* dw, int T, int N,
                             int H, int dtype, int blocks, int u, int P,
                             int KS, int smem, void* stream) {
  if (T < 1 || N < 1 || H < 1 || u < 1 || u > kMaxUnits || blocks * u < H ||
      (blocks - 1) * u >= H || P < 1 || KS < 1 || P * KS > kThreads)
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(1, u, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  float* dwp = static_cast<float*>(dw);
  void* args[] = {(void*)&gates, (void*)&cseq, (void*)&out, (void*)&w, &sk,
                  &sg, (void*)&h0, (void*)&c0, (void*)&dout, (void*)&dcseq,
                  &dgin, &dh, &dc, &dwp, &T, &N, &H, &P, &KS};
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err)
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                      (size_t)smem,
                                      static_cast<cudaStream_t>(stream));
  if (!err) err = cudaGetLastError();
  return (int)err;
}
