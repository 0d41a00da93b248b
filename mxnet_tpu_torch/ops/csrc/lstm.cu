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
//     dW      = sum over t of round(h_{t-1})^T @ round(dgin[t])   f32
// with h_{-1}, c_{-1} = h0, c0. dh0, dc0 (the carries after step 0) and
// dW come out in f32.
//
// Forward design. The TPU kernel keeps all of W (6.8 MB at H = 650 in
// f32) in VMEM for the T sequential grid steps. An SM has at most 227 KB
// of shared memory, so here ONE persistent cooperative grid splits the
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
// thread before any store; each step's gin is fetched under its dot
// products. The grid (u, P, KS, shared bytes) is planned in Python
// (ops/lstm.py::plan_grid); this file checks occupancy.
//
// Backward design. Two kernels, both deterministic (no atomics, the
// same bits every run), W read and dW written by strides, so MXNet's
// (4H, H) h2h weight is taken as it is.
//  1. The recurrence (lstm_bwd_kernel): one persistent cooperative grid,
//     ONE grid sync a step. Block b owns u <= 16 units (two mma n-tiles
//     of 8; one where W's rows for two do not fit) and a group of the
//     batch's m16 row tiles: unit group b % UG, row group b / UG, UG =
//     ceil(H / u), RG = min(m-tiles, SMs / UG). Phase A: the block
//     computes dgin for its rows and units from local values (the
//     carries, the saved gates, c_t, c_{t-1}) and writes dgin[t]; the
//     grid syncs. Phase B: dh_{t-1}[own rows, own units] = dgin[t][own
//     rows] (4H deep) . W[own units, :]^T on the tensor cores with
//     mma.sync, in chunks of 64 bytes a row. W's rows (16 x 4H, W's
//     type) sit in shared memory for all T steps; A fragments come
//     straight from L2 (ld.global.cg, 16 bytes a lane, in batches, the
//     next batch in flight under this one's products), not staged: each
//     lane's 16 bytes are two mma k-steps' worth of its fragment slots
//     (the k order inside a chunk is permuted, the same way for A and
//     B). f32: m16n8k8 TF32 with a 3-term split (a_hi b_hi + a_hi b_lo +
//     a_lo b_hi, hi/lo rounded to nearest by cvt.rna, split on the fly,
//     A once for both n-tiles) and f32 accumulation, which keeps f32
//     accuracy; bf16/f16: m16n8k16 with f32 accumulation, the loaded
//     words used as they are. The tensor cores round their own adds
//     toward zero, so each chunk sums into a fresh partial and the
//     partials into the running sum with round-to-nearest f32 adds. A
//     block with fewer than 8 m-tiles splits the depth across its 8
//     warps; the partials meet in shared memory, summed in a fixed order.
//     Every step, dgin[t] crosses L2 once per unit group (41 at H = 650),
//     not once per block: at the word LM's N = 32 that is 13.6 MB a step
//     instead of 43 MB.
//  2. dW (lstm_bwd_dw_kernel), after the loop: no step depends on it, so
//     it leaves the serial path. dW = hp^T . dgin with hp = [h0; out[0..
//     T-2]] (T*N x H) and dgin (T*N x 4H): one tiled product, 64 x 128
//     output tiles over (H, 4H) so that every SM works, register-staged
//     double buffering, TF32 mma (3-term split for f32, split once as a
//     value is staged; bf16/f16 values are exact in TF32, one term), f32
//     accumulation.

// Bound. Operations: 2*T*N*H*4H flops forward, twice that backward.
// The forward runs on the CUDA cores (67 TFLOP/s f32); the backward's
// products on the tensor cores, at 495 TFLOP/s TF32 over 3 terms for
// f32. Bytes: gin, out, cseq, gates and W once each. What the
// recurrence pays on top: a grid sync and a short chain of L2 round
// trips every step (about 10 us a step on an H100 whatever N), and
// dgin[t] re-read from L2 by every unit group; the forward still runs
// on the CUDA cores and every block re-reads all of h each step.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxtt::store;
using mxtt::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxUnits = 8;      // forward: units a block at most; one n8 tile

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
      if (e < count) store(dst(e), v[b]);
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

// ---- backward: tensor-core helpers ----------------------------------------

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

// 16 bytes of row `p` at k = kk..kk+KG-1 from L2 (written by other blocks
// in this launch), zero past G. `vec`: G is a multiple of KG, so rows
// start 16-byte aligned and a group is all in or all out.
template <typename T>
__device__ __forceinline__ uint4 ld_group(const T* p, int kk, int G,
                                          bool vec) {
  if (vec)
    return kk < G ? __ldcg(reinterpret_cast<const uint4*>(p + kk))
                  : make_uint4(0, 0, 0, 0);
  uint32_t w[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = kk + i < G ? __float_as_uint(__ldcg(
                              reinterpret_cast<const float*>(p) + kk + i))
                        : 0u;
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = kk + 2 * i;
      const uint32_t lo = k < G ? __ldcg(q + k) : 0u;
      const uint32_t hi = k + 1 < G ? __ldcg(q + k + 1) : 0u;
      w[i] = lo | (hi << 16);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// One lane's share of one chunk of the recurrent product, for NT n-tiles
// of 8 units. Lane (gid = lane / 4, tig = lane % 4) holds 16 bytes of A
// row gid (a0), of A row gid + 8 (a1) and of B column gid of each n-tile
// (b[j]), at the same KG = 16 / sizeof(T) consecutive k: words 0, 1 are
// the slots of mma k-step 0, words 2, 3 of step 1 (f32: slots tig, tig +
// 4 of an m16n8k8; 16-bit: the pairs 2tig, 2tig + 1 and 2tig + 8, 2tig +
// 9 of an m16n8k16). A and B see the same permutation of k, so the sum
// is the product's. The tensor cores add into their accumulator
// rounding toward zero, so a sum carried through hundreds of mma drifts
// toward zero (~depth x 2^-24 of it, past f32 accuracy at 4H = 2600);
// each chunk goes into a fresh partial that is added to d with an
// ordinary (round-to-nearest) f32 add. f32 splits A once for all
// n-tiles.
template <typename T, int NT>
__device__ __forceinline__ void mma_chunk(float (&d)[NT][4], uint4 a0,
                                          uint4 a1, const uint4 (&b)[NT]) {
  const uint32_t as[2][4] = {{a0.x, a1.x, a0.y, a1.y},
                             {a0.z, a1.z, a0.w, a1.w}};
  float p[NT][4];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if constexpr (sizeof(T) == 4) {
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(as[s][i], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t bs[2] = {s ? b[j].z : b[j].x, s ? b[j].w : b[j].y};
        uint32_t bh[2], bl[2];
        split_tf32(bs[0], bh[0], bl[0]);
        split_tf32(bs[1], bh[1], bl[1]);
        mma_tf32x3(p[j], ah, al, bh, bl, s == 0);
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint32_t bs[2] = {s ? b[j].z : b[j].x, s ? b[j].w : b[j].y};
        if (s == 0) {
#pragma unroll
          for (int q = 0; q < 4; ++q) p[j][q] = 0.f;
        }
        mma_16<T>(p[j], as[s], bs);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) d[j][q] += p[j][q];
}

// The 16-byte groups of the chunks [c, c + B) of rows r0 (a0) and r1
// (a1) of dgin[t], zeros past c1 or N.
template <typename T, int KG, int KC, int B>
__device__ __forceinline__ void load_batch(uint4 (&a0)[B], uint4 (&a1)[B],
                                           const T* p0, const T* p1, int c,
                                           int c1, int tig, bool ok0,
                                           bool ok1, int G, bool vec) {
#pragma unroll
  for (int b = 0; b < B; ++b) {
    const int kk = (c + b) * KC + tig * KG;
    const bool in = c + b < c1;
    a0[b] = in && ok0 ? ld_group(p0, kk, G, vec) : make_uint4(0, 0, 0, 0);
    a1[b] = in && ok1 ? ld_group(p1, kk, G, vec) : make_uint4(0, 0, 0, 0);
  }
}

// the products of a loaded batch; wrow: this lane's W row of n-tile 0,
// n-tile j lies 8 rows (8 * ldw elements) further
template <typename T, int KC, int NT, int B>
__device__ __forceinline__ void mma_batch(float (&acc)[NT][4],
                                          const uint4 (&a0)[B],
                                          const uint4 (&a1)[B],
                                          const T* wrow, int ldw, int c,
                                          int c1) {
#pragma unroll
  for (int b = 0; b < B; ++b)
    if (c + b < c1) {
      uint4 bw[NT];
#pragma unroll
      for (int j = 0; j < NT; ++j)
        bw[j] = *reinterpret_cast<const uint4*>(wrow + j * 8 * ldw +
                                                (c + b) * KC);
      mma_chunk<T, NT>(acc, a0[b], a1[b], bw);
    }
}

// chunks of the depth in one batch of loads (2 x kBatch 16-byte loads a
// lane); a warp keeps two batches, one loading while the other multiplies
constexpr int kBatch = 4;

// The recurrence for blocks of U <= 8 NT units and a group of the batch's
// m16 row tiles: block b owns unit group b % UG (units [ug U, ug U + U))
// and row group b / UG (m-tiles [mt RG_i / RG, ...)), so dgin[t] crosses
// L2 once per unit group and row, not once per block. Shared memory:
// w_s [8 NT][ldw] of T, row j = W[unit0 + j][0..4H) then zeros (ldw *
// sizeof(T) = 64 mod 128 bytes: the 8 lanes of a 16-byte access phase
// hit distinct banks); then red_s [8 work items][16][8 NT] f32 partial
// sums when the depth is split across warps (a block with fewer than 8
// m-tiles: KS = 8 / m-tiles).
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cseq,
                const T* __restrict__ w, long long sk, long long sg,
                const T* __restrict__ c0, const T* __restrict__ dout,
                const T* __restrict__ dcseq, T* dgin, float* dh_c,
                float* dc_c, int steps, int N, int H, int U, int RG,
                int ldw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KG = 16 / (int)sizeof(T);   // k of one lane's 16 bytes
  constexpr int KC = 4 * KG;                // k of one warp chunk
  constexpr int UN = 8 * NT;                // units of the n-tiles
  T* w_s = reinterpret_cast<T*>(smem_raw);
  float* red_s = reinterpret_cast<float*>(smem_raw +
                                          (size_t)UN * ldw * sizeof(T));
  const int G = 4 * H;
  const int UG = (H + U - 1) / U;
  const int ug = blockIdx.x % UG, rg = blockIdx.x / UG;
  const int unit0 = ug * U;
  const int nu = min(U, H - unit0);
  const int mt = (N + 15) / 16;
  const int mt0 = mt * rg / RG, mt1 = mt * (rg + 1) / RG;
  const int row0 = 16 * mt0, rows = min(N, 16 * mt1) - row0;
  const int my_mt = mt1 - mt0;
  const int KS = my_mt >= kWarps ? 1 : kWarps / max(my_mt, 1);
  const int items = my_mt * KS;
  const int chunks = (G + KC - 1) / KC;
  const bool vec = G % KG == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  stage(UN * ldw,
        [&](int e) {
          const int j = e / ldw, g = e % ldw;
          return j < nu && g < G
                     ? to_f32(w[(long long)(unit0 + j) * sk + (long long)g * sg])
                     : 0.f;
        },
        [&](int e) { return w_s + e; });
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  const T* wrow = w_s + gid * ldw + tig * KG;
  for (int t = steps - 1; t >= 0; --t) {
    // A: dgin[t] for this block's rows and units, from local values only
    for (int p = threadIdx.x; p < rows * nu; p += blockDim.x) {
      const int n = row0 + p / nu, unit = unit0 + p % nu;
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
    // B: dh_{t-1}[own rows, own units] = dgin[t][own rows] . W[own units]^T
    const T* dsrc = dgin + (size_t)t * N * G;
    for (int item = warp; item < items; item += kWarps) {
      const int m = mt0 + item / KS, split = item % KS;
      const int c0_ = (int)((long long)chunks * split / KS);
      const int c1_ = (int)((long long)chunks * (split + 1) / KS);
      const int r0 = m * 16 + gid, r1 = r0 + 8;
      const T* p0 = dsrc + (size_t)min(r0, N - 1) * G;
      const T* p1 = dsrc + (size_t)min(r1, N - 1) * G;
      float acc[NT][4] = {};
      // two batches in registers: the next one loads under this one's
      // products
      uint4 x0[kBatch], x1[kBatch], y0[kBatch], y1[kBatch];
      const bool ok0 = r0 < N, ok1 = r1 < N;
      load_batch<T, KG, KC>(x0, x1, p0, p1, c0_, c1_, tig, ok0, ok1, G, vec);
      for (int c = c0_; c < c1_; c += 2 * kBatch) {
        load_batch<T, KG, KC>(y0, y1, p0, p1, c + kBatch, c1_, tig, ok0, ok1,
                              G, vec);
        mma_batch<T, KC>(acc, x0, x1, wrow, ldw, c, c1_);
        load_batch<T, KG, KC>(x0, x1, p0, p1, c + 2 * kBatch, c1_, tig, ok0,
                              ok1, G, vec);
        mma_batch<T, KC>(acc, y0, y1, wrow, ldw, c + kBatch, c1_);
      }
      // acc[j]: rows r0 (0, 1) and r1 (2, 3), units 8 j + 2 tig (+ 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int r = gid + (q < 2 ? 0 : 8), u = 8 * j + 2 * tig + (q & 1);
          if (KS == 1) {
            if (m * 16 + r < N && u < nu)
              dh_c[(size_t)(m * 16 + r) * H + unit0 + u] = acc[j][q];
          } else {
            red_s[(item * 16 + r) * UN + u] = acc[j][q];
          }
        }
    }
    if (KS > 1) {
      __syncthreads();
      // each (row, unit): the KS partials in split order 0..KS-1
      for (int e = threadIdx.x; e < my_mt * 16 * UN; e += blockDim.x) {
        const int mi = e / (16 * UN), r = (e / UN) % 16, u = e % UN;
        const int row = (mt0 + mi) * 16 + r;
        if (row < N && u < nu) {
          float v = 0.f;
          for (int q = 0; q < KS; ++q) v += red_s[((mi * KS + q) * 16 + r) * UN + u];
          dh_c[(size_t)row * H + unit0 + u] = v;
        }
      }
    }
    __syncthreads();   // dh_c is read by other threads in the next phase A
  }
}

// dW = hp^T . dgin: (H x TN) . (TN x 4H), hp row q = h_{t-1}[n] for q =
// t*N + n (h0 for t = 0, else out[t-1]), all in T; written as f32 at W's
// strides. Block tile 64 (H) x 128 (4H); 8 warps as 2 x 4, each 32 x 32
// (2 m16 x 4 n8 tiles); depth in steps of 16, staged in shared memory as
// TF32 hi (and, for f32, lo) halves split once as they are stored (rows
// padded by 8 floats: fragment reads hit distinct banks), the next
// step's values loaded to registers under this step's products.
constexpr int kDwBM = 64, kDwBN = 128, kDwBK = 16;
constexpr int kDwA = kDwBK * kDwBM / kThreads;   // A values a thread stages
constexpr int kDwB = kDwBK * kDwBN / kThreads;   // B values a thread stages
constexpr int kDwAS = kDwBK * (kDwBM + 8);       // floats of an A stage
constexpr int kDwBS = kDwBK * (kDwBN + 8);       // floats of a B stage

// dynamic shared bytes of the dW kernel: 2 buffers of A and B, hi and
// (f32) lo halves
constexpr size_t dw_smem_bytes(bool split) {
  return sizeof(float) * 2 * (kDwAS + kDwBS) * (split ? 2 : 1);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
lstm_bwd_dw_kernel(const T* __restrict__ out, const T* __restrict__ h0,
                   const T* __restrict__ dgin, float* __restrict__ dw,
                   long long sk, long long sg, int K, int N, int H) {
  constexpr bool kSplit = sizeof(T) == 4;   // 16-bit values are exact TF32
  extern __shared__ __align__(16) uint32_t dw_smem[];
  // [buf][half] stages: half 0 hi, half 1 lo
  uint32_t* a_s = dw_smem;                          // [2][halves][BK][BM+8]
  uint32_t* b_s = dw_smem + 2 * kDwAS * (kSplit ? 2 : 1);
  const int G = 4 * H;
  const int m0 = blockIdx.y * kDwBM, n0 = blockIdx.x * kDwBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = (warp >> 2) * 32, wn = (warp & 3) * 32;
  float acc[2][4][4] = {};
  float ra[kDwA], rb[kDwB];

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kDwA; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int q = k0 + e / kDwBM, m = m0 + e % kDwBM;
      ra[i] = 0.f;
      if (q < K && m < H)
        ra[i] = to_f32(q < N ? h0[(size_t)q * H + m]
                             : out[(size_t)(q - N) * H + m]);
    }
#pragma unroll
    for (int i = 0; i < kDwB; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int q = k0 + e / kDwBN, g = n0 + e % kDwBN;
      rb[i] = q < K && g < G ? to_f32(dgin[(size_t)q * G + g]) : 0.f;
    }
  };
  // store one half pair: hi at `base`, lo one stage further
  auto put1 = [&](uint32_t* base, int stage_floats, int idx, float v) {
    if constexpr (kSplit) {
      uint32_t hi, lo;
      split_tf32(__float_as_uint(v), hi, lo);
      base[idx] = hi;
      base[stage_floats + idx] = lo;
    } else {
      base[idx] = __float_as_uint(v);
    }
  };
  auto put = [&](int buf) {
    uint32_t* ab = a_s + buf * kDwAS * (kSplit ? 2 : 1);
    uint32_t* bb = b_s + buf * kDwBS * (kSplit ? 2 : 1);
#pragma unroll
    for (int i = 0; i < kDwA; ++i) {
      const int e = threadIdx.x + i * kThreads;
      put1(ab, kDwAS, (e / kDwBM) * (kDwBM + 8) + e % kDwBM, ra[i]);
    }
#pragma unroll
    for (int i = 0; i < kDwB; ++i) {
      const int e = threadIdx.x + i * kThreads;
      put1(bb, kDwBS, (e / kDwBN) * (kDwBN + 8) + e % kDwBN, rb[i]);
    }
  };

  load(0);
  put(0);
  __syncthreads();
  const int tiles = (K + kDwBK - 1) / kDwBK;
  for (int kt = 0; kt < tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < tiles) load((kt + 1) * kDwBK);
    const uint32_t* ab = a_s + buf * kDwAS * (kSplit ? 2 : 1);
    const uint32_t* bb = b_s + buf * kDwBS * (kSplit ? 2 : 1);
#pragma unroll
    for (int k8 = 0; k8 < kDwBK; k8 += 8) {
      // fragments: [half][tile][register]
      uint32_t a[2][2][4], b[2][4][2];
#pragma unroll
      for (int h = 0; h < (kSplit ? 2 : 1); ++h) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const uint32_t* ar = ab + h * kDwAS + wm + i * 16 + gid;
          a[h][i][0] = ar[(k8 + tig) * (kDwBM + 8)];
          a[h][i][1] = ar[(k8 + tig) * (kDwBM + 8) + 8];
          a[h][i][2] = ar[(k8 + tig + 4) * (kDwBM + 8)];
          a[h][i][3] = ar[(k8 + tig + 4) * (kDwBM + 8) + 8];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t* br = bb + h * kDwBS + wn + j * 8 + gid;
          b[h][j][0] = br[(k8 + tig) * (kDwBN + 8)];
          b[h][j][1] = br[(k8 + tig + 4) * (kDwBN + 8)];
        }
      }
      // each k-step into a fresh partial, added round-to-nearest (as
      // mma_chunk: the tensor cores' own adds round toward zero)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float p[4];
          if constexpr (kSplit)
            mma_tf32x3(p, a[0][i], a[1][i], b[0][j], b[1][j], true);
          else
            mma_tf32_0(p, a[0][i], b[0][j]);   // exact products: one term
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] += p[q];
        }
    }
    if (kt + 1 < tiles) {
      put(buf ^ 1);   // the other buffer: last read a step ago, synced since
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = m0 + wm + i * 16 + gid + (q < 2 ? 0 : 8);
        const int c = n0 + wn + j * 8 + 2 * tig + (q & 1);
        if (r < H && c < G) dw[r * sk + c * sg] = acc[i][j][q];
      }
}

template <typename T, int U>
const void* fwd_fn() { return reinterpret_cast<const void*>(&lstm_fwd_kernel<T, U>); }

template <typename T>
const void* fwd_for(int u) {
  switch (u) {
#define MXTT_LSTM_U(n) \
  case n: return fwd_fn<T, n>();
    MXTT_LSTM_U(1) MXTT_LSTM_U(2) MXTT_LSTM_U(3) MXTT_LSTM_U(4)
    MXTT_LSTM_U(5) MXTT_LSTM_U(6) MXTT_LSTM_U(7) MXTT_LSTM_U(8)
#undef MXTT_LSTM_U
    default: return nullptr;
  }
}

// the recurrence for u <= 16 units a block (one n-tile of 8 or two)
template <typename T>
const void* bwd_for(int u) {
  if (u < 1 || u > 2 * kMaxUnits) return nullptr;
  return u <= kMaxUnits ? reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 1>)
                        : reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 2>);
}

// the recurrence kernel (bwd = 1) or the forward (bwd = 0) for u units
const void* kernel_for(int bwd, int u, int dtype) {
  switch (dtype) {
    case 0: return bwd ? bwd_for<float>(u) : fwd_for<float>(u);
    case 1: return bwd ? bwd_for<__nv_bfloat16>(u) : fwd_for<__nv_bfloat16>(u);
    case 2: return bwd ? bwd_for<__half>(u) : fwd_for<__half>(u);
    default: return nullptr;
  }
}

int item_size(int dtype) { return dtype == 0 ? 4 : 2; }

// the recurrence's shared bytes: W rows of ldw elements for the n-tiles
// of u units, and the split partial sums (8 work items x 16 rows)
size_t bwd_smem_bytes(int dtype, int ldw, int u) {
  const int un = u <= kMaxUnits ? kMaxUnits : 2 * kMaxUnits;
  return (size_t)un * ldw * item_size(dtype) +
         (size_t)kWarps * 16 * un * sizeof(float);
}

bool grid_ok(int H, int blocks, int u) {
  return u >= 1 && u <= kMaxUnits && blocks * u >= H && (blocks - 1) * u < H;
}

cudaError_t launch_coop(const void* fn, int blocks, void** args, int smem,
                        void* stream) {
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err)
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks), dim3(kThreads), args,
                                      (size_t)smem,
                                      static_cast<cudaStream_t>(stream));
  if (!err) err = cudaGetLastError();
  return err;
}

}  // namespace

// The current device's numbers the grid is planned from (plain C entry
// point, loaded with ctypes): out[0..2] = {SMs, shared bytes a block may
// opt in to, cooperative launch supported}. Returns a cudaError_t.
extern "C" int mxtt_lstm_device(void* out_, void* stream) {
  (void)stream;
  int* out = static_cast<int*>(out_);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(out, cudaDevAttrMultiProcessorCount, dev);
  if (!err) err = cudaDeviceGetAttribute(out + 1, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (!err) err = cudaDeviceGetAttribute(out + 2, cudaDevAttrCooperativeLaunch, dev);
  return (int)err;
}

// Blocks of the forward or of the backward's recurrence (bwd = 1), for
// u units a block, that can be resident on one SM with `smem` bytes
// of dynamic shared memory each, to out[0]. A cooperative grid must not
// have more than that times the SMs. Returns a cudaError_t.
extern "C" int mxtt_lstm_occupancy(int bwd, int u, int dtype, int smem,
                                   void* out_, void* stream) {
  (void)stream;
  int* out = static_cast<int*>(out_);
  out[0] = 0;
  const void* fn = kernel_for(bwd, u, dtype);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, kThreads, (size_t)smem);
  return (int)err;
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
  if (T < 1 || N < 1 || H < 1 || !grid_ok(H, blocks, u) || P < 1 ||
      KS < 1 || P * KS > kThreads ||
      (size_t)smem < 4 * fwd_smem_floats(H, u, P, KS))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(0, u, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* cb = static_cast<float*>(cbuf);
  void* args[] = {(void*)&gin, (void*)&w, &sk, &sg, (void*)&h0, (void*)&c0,
                  &out, &cseq, &gates, &cb, &T, &N, &H, &P, &KS};
  return (int)launch_coop(fn, blocks, args, smem, stream);
}

// Plain C entry point of the backward's recurrence. gates, dgin (T, N,
// 4H); cseq, dout, dcseq (T, N, H); c0 (N, H): contiguous, of type
// `dtype`; w at strides (sk, sg). dh0 and dc0 (N, H) float32 must hold
// zeros (they are the carries and end as dh0, dc0). The grid: blocks =
// ceil(H / u) unit groups x RG row groups (RG <= the m16 tiles of N), u
// <= 16. ldw: elements of a W row in shared memory (at least 4H rounded
// up to 64 bytes, ldw * itemsize = 64 mod 128). Returns the launch's
// cudaError_t.
extern "C" int mxtt_lstm_bwd(const void* gates, const void* cseq,
                             const void* w, long long sk, long long sg,
                             const void* c0, const void* dout,
                             const void* dcseq, void* dgin, void* dh0,
                             void* dc0, int T, int N, int H, int dtype,
                             int blocks, int u, int RG, int ldw, int smem,
                             void* stream) {
  const int chunk = 64 / item_size(dtype);
  if (T < 1 || N < 1 || H < 1 || u < 1 || u > 2 * kMaxUnits || RG < 1 ||
      RG > (N + 15) / 16 || blocks != (H + u - 1) / u * RG ||
      ldw < (4 * H + chunk - 1) / chunk * chunk ||
      ldw * item_size(dtype) % 128 != 64 ||
      (size_t)smem < bwd_smem_bytes(dtype, ldw, u))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(1, u, dtype);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  void* args[] = {(void*)&gates, (void*)&cseq, (void*)&w, &sk, &sg,
                  (void*)&c0, (void*)&dout, (void*)&dcseq, &dgin, &dh, &dc,
                  &T, &N, &H, &u, &RG, &ldw};
  return (int)launch_coop(fn, blocks, args, smem, stream);
}

// Plain C entry point of the backward's dW product: dw (H, 4H) float32
// at strides (sk, sg) receives sum over t, n of h_{t-1}[n]^T dgin[t][n],
// with h_{-1} = h0. out (T, N, H), h0 (N, H), dgin (T, N, 4H):
// contiguous, of type `dtype`. Returns the launch's cudaError_t.
extern "C" int mxtt_lstm_bwd_dw(const void* out, const void* h0,
                                const void* dgin, void* dw, long long sk,
                                long long sg, int T, int N, int H, int dtype,
                                void* stream) {
  if (T < 1 || N < 1 || H < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((4 * H + kDwBN - 1) / kDwBN, (H + kDwBM - 1) / kDwBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(dw);
  const int K = T * N;
  cudaError_t err = cudaSuccess;
  switch (dtype) {
#define MXTT_LSTM_DW(code, T_)                                              \
  case code: {                                                              \
    const size_t smem = dw_smem_bytes(sizeof(T_) == 4);                     \
    err = mxtt::allow_smem(&lstm_bwd_dw_kernel<T_>, smem);                  \
    if (err) return (int)err;                                               \
    lstm_bwd_dw_kernel<T_><<<grid, kThreads, smem, s>>>(                    \
        static_cast<const T_*>(out), static_cast<const T_*>(h0),            \
        static_cast<const T_*>(dgin), d, sk, sg, K, N, H);                  \
    break;                                                                  \
  }
    MXTT_LSTM_DW(0, float)
    MXTT_LSTM_DW(1, __nv_bfloat16)
    MXTT_LSTM_DW(2, __half)
#undef MXTT_LSTM_DW
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
