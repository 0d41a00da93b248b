// Flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py::
// _flash_bwd: _bwd_fused_kernel (one pass, nk <= 2) and the split pair
// _bwd_dq_kernel / _bwd_dkv_kernel. All three compute one function:
// from q, k, v (B, H, S, D), the forward's lse (B, H, Sq) f32, the
// output gradient do (B, H, Sq, D) and delta = rowsum(do * o) - dlse
// (B, H, Sq) f32,
//     p[i, j]  = exp(s[i, j] - lse[i])     over the VISIBLE pairs, else 0
//     ds[i, j] = p[i, j] * (do[i] . v[j] - delta[i])
//     dq[i]    = sm_scale * sum_j ds[i, j] k[j]
//     dk[j]    = sum_i ds[i, j] q'[i]
//     dv[j]    = sum_i p[i, j] do[i]
// with s = q' k^T and q' = q * sm_scale rounded back to q's type (the
// forward's pre-scaling: ds is the gradient of the UNSCALED scores, so
// dk = ds^T q' is already the true dk and dq is rescaled once at the
// write). Visibility is the forward's: j < kv_len[b], j <= i + q_offset
// when causal, seg[b, i] == seg[b, j] when packed. The mask is applied
// BEFORE the exponent: a query row with no visible key has lse = -1e30,
// where exp(s - lse) would overflow to inf and inf * 0 is NaN.
//
// Design: two kernels that recompute p from the saved lse, like the
// TPU's split path; deterministic, no atomics. On the TPU the inner
// tile axis is a sequential grid dimension with accumulators in VMEM
// scratch; here a block loops over it itself with its accumulators in
// registers:
//   dkv: one block per (batch*head, 64-key tile) loops over 64-query
//        tiles; each of 256 threads owns a 4-key x D/16 slice of dk and
//        of dv.
//   dq:  one block per (batch*head, 64-query tile) loops over 64-key
//        tiles (K1's loop); each thread owns a 4-query x D/16 slice of
//        dq.
// In each turn the two score-shaped products (q' k^T and do v^T) give
// every thread a 4 x 4 tile of s and dp (register tiling, as K1); p and
// ds go through shared memory to the accumulating products. Tiles are
// staged in shared memory as f32 (K and V rows padded by one word: no
// bank conflicts). Whole tiles are skipped as K1 skips them: the loops
// never reach tiles past kv_len or across the causal diagonal, and with
// segment ids a tile pair whose id ranges are disjoint is skipped after
// reading the ids (one __syncthreads_or). q, k, v, do and the three
// gradients may be any views whose last axis is contiguous (strides
// are arguments): q, k, v are head views of the fused QKV projection.
// One C call launches both kernels on the caller's stream.
//
// Bound. Operations: 4 products of 2 * D flops per visible pair in the
// dkv kernel (q'k^T, do v^T, p^T do, ds^T q') and 3 in the dq kernel
// (q'k^T, do v^T, ds k) as written, of which the function needs 5 (s,
// dp, dq, dk, dv): 10 * D flops per visible pair. At BERT-base's S = 128
// and D = 64 that is far above the card's f32 CUDA-core balance, so the
// bound is the f32 rate (on tensor cores in bf16 it would be bytes).
//
// What this simple design leaves on the table: the products run on CUDA
// cores in f32 (no mma/wgmma); s and dp are computed twice (once per
// kernel, 7 products instead of the fused TPU kernel's 5); tiles are
// loaded synchronously (no cp.async/TMA double-buffering).

#include "common.cuh"

namespace {

using mxtt::round_to;
using mxtt::store;
using mxtt::to_f32;

constexpr int kBQ = 64;         // queries per tile
constexpr int kBK = 64;         // keys per tile
constexpr int kThreads = 256;
constexpr int kPS = 65;         // p / ds tile row stride (floats)
constexpr int kSegPadQ = -2, kSegPadK = -3;   // never equal to each other

struct Strides {                // element strides of (b, h, s); d is 1
  long long q[3], k[3], v[3], dO[3], dq[3], dk[3], dv[3];
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* lse;             // (B, H, Sq), contiguous
  const float* delta;           // (B, H, Sq), contiguous
  const int32_t* kv_lens;       // (B,) or null
  const int32_t* seg;           // (B, S) or null
  void* dq;
  void* dk;
  void* dv;
  Strides st;
  int H, Sq, Skv, D;
  float scale;
  int causal, q_offset;
};

__device__ __forceinline__ int clamp_kvl(const Args& a, int b) {
  const int kvl = a.kv_lens != nullptr ? a.kv_lens[b] : a.Skv;
  return max(0, min(kvl, a.Skv));
}

// Stage rows [r0, r0 + 64) of a (S, D) slice as f32 into `dst` (row
// stride `ld`), q pre-scaled and rounded when `scale_q`; rows past
// `rows` and columns past D are zeros. Each thread issues its loads in
// groups of 8 before it stores any: a loop that stored each value
// before loading the next would wait out one device-memory latency per
// element.
template <typename T, int DP>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long rs, int r0, int rows, int D,
                                      bool scale_q, float scale) {
  constexpr int kPer = 64 * DP / kThreads;      // elements per thread
  constexpr int kGroup = kPer < 8 ? kPer : 8;
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kGroup) {
    float x[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int r = i / DP, d = i - r * DP;
      x[u] = 0.f;
      if (r < rows && d < D) {
        x[u] = to_f32(src[(long long)(r0 + r) * rs + d]);
        if (scale_q) x[u] = round_to(x[u] * scale, T());
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int r = i / DP, d = i - r * DP;
      dst[r * ld + d] = x[u];
    }
  }
}

// s (= q' k^T) and dp (= do v^T) for the 4 x 4 pairs (ty + 16 i,
// tx + 16 j) of a 64 x 64 tile: rows from qs/dos (stride DP), columns
// from ks/vs (stride KS).
template <int DP>
__device__ __forceinline__ void score_tiles(const float* qs, const float* dos,
                                            const float* ks, const float* vs,
                                            int ty, int tx, float sc[4][4],
                                            float dp[4][4]) {
  constexpr int KS = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(ty + 16 * i) * DP + d];
      ov[i] = dos[(ty + 16 * i) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(tx + 16 * j) * KS + d];
      vv[j] = vs[(tx + 16 * j) * KS + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// dk, dv: one block per (b*h, 64-key tile), looping over query tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Args a) {
  constexpr int KS = DP + 1;
  constexpr int DPT = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // 64 x DP   q' of this query tile
  float* dos = qs + kBQ * DP;         // 64 x DP   do
  float* ks = dos + kBQ * DP;         // 64 x KS   k (this block's keys)
  float* vs = ks + kBK * KS;          // 64 x KS   v
  float* ps = vs + kBK * KS;          // 64 x kPS  p  [query][key]
  float* dss = ps + kBQ * kPS;        // 64 x kPS  ds [query][key]
  float* lse_s = dss + kBQ * kPS;     // 64
  float* del_s = lse_s + kBQ;         // 64
  int* segq = reinterpret_cast<int*>(del_s + kBQ);   // 64
  int* segk = segq + kBQ;                             // 64

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int k0 = blockIdx.y * kBK;
  const int cols_here = min(kBK, a.Skv - k0);
  const int kvl = clamp_kvl(a, b);
  const T* qb = static_cast<const T*>(a.q) + b * a.st.q[0] + h * a.st.q[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.st.k[0] + h * a.st.k[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.st.v[0] + h * a.st.v[1];
  const T* ob = static_cast<const T*>(a.dO) + b * a.st.dO[0] +
                h * a.st.dO[1];
  const float* lseb = a.lse + (long long)bh * a.Sq;
  const float* delb = a.delta + (long long)bh * a.Sq;

  // keys of this tile that any query can see: none when the tile starts
  // at/after kv_len; under causal only rows >= k0 - q_offset see key k0
  const int keys_live = max(0, min(cols_here, kvl - k0));
  int row_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  const int t_begin = keys_live > 0 ? row_begin / kBQ : n_qt;

  stage<T, DP>(ks, KS, kb, a.st.k[2], k0, keys_live, a.D, false, 0.f);
  stage<T, DP>(vs, KS, vb, a.st.v[2], k0, keys_live, a.D, false, 0.f);
  if (tid < kBK)
    segk[tid] = (a.seg != nullptr && tid < keys_live)
                    ? a.seg[(long long)b * a.Skv + k0 + tid] : kSegPadK;
  __syncthreads();
  int kmin = 0x7fffffff, kmax = -0x7fffffff;
  if (a.seg != nullptr) {
    for (int c = 0; c < keys_live; ++c) {
      kmin = min(kmin, segk[c]);
      kmax = max(kmax, segk[c]);
    }
  }

  const int ty = tid / 16, tx = tid % 16;
  float dk_acc[4][DPT], dv_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  for (int t = t_begin; t < n_qt; ++t) {
    const int q0 = t * kBQ;
    const int rows_here = min(kBQ, a.Sq - q0);
    __syncthreads();              // the last turn's readers are done
    if (a.seg != nullptr) {
      int hit = 0;
      if (tid < kBQ) {
        int sq = kSegPadQ;
        if (tid < rows_here) {
          sq = a.seg[(long long)b * a.Sq + q0 + tid];
          hit = sq >= kmin && sq <= kmax;
        }
        segq[tid] = sq;
      }
      if (!__syncthreads_or(hit)) continue;   // disjoint ids: skip
    }
    stage<T, DP>(qs, DP, qb, a.st.q[2], q0, rows_here, a.D, true, a.scale);
    stage<T, DP>(dos, DP, ob, a.st.dO[2], q0, rows_here, a.D, false, 0.f);
    if (tid < kBQ) {
      lse_s[tid] = tid < rows_here ? lseb[q0 + tid] : 0.f;
      del_s[tid] = tid < rows_here ? delb[q0 + tid] : 0.f;
    }
    __syncthreads();

    float sc[4][4], dp[4][4];
    score_tiles<DP>(qs, dos, ks, vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = k0 + c;
        bool ok = r < rows_here && c < keys_live;
        if (a.causal) ok = ok && col <= row + a.q_offset;
        if (a.seg != nullptr) ok = ok && segk[c] == segq[r];
        // masked BEFORE the exponent (lse = -1e30 on empty rows)
        const float p = ok ? expf(sc[i][j] - lse_s[r]) : 0.f;
        ps[r * kPS + c] = p;
        dss[r * kPS + c] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();

    // dv += p^T do, dk += ds^T q': keys ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int r = 0; r < kBQ; ++r) {
      float pv[4], dv4[4], ov[DPT], qv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[r * kPS + ty + 16 * i];
        dv4[i] = dss[r * kPS + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        ov[j] = dos[r * DP + tx + 16 * j];
        qv[j] = qs[r * DP + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j) {
          dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dv4[i], qv[j], dk_acc[i][j]);
        }
    }
  }

  // every key row of the tile is written: zeros where no query sees it
  T* dkb = static_cast<T*>(a.dk) + b * a.st.dk[0] + h * a.st.dk[1];
  T* dvb = static_cast<T*>(a.dv) + b * a.st.dv[0] + h * a.st.dv[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= cols_here) continue;
    T* dkr = dkb + (long long)(k0 + c) * a.st.dk[2];
    T* dvr = dvb + (long long)(k0 + c) * a.st.dv[2];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) {
        store(dkr + d, dk_acc[i][j]);
        store(dvr + d, dv_acc[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dq: one block per (b*h, 64-query tile), looping over key tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Args a) {
  constexpr int KS = DP + 1;
  constexpr int DPT = DP / 16;
  extern __shared__ float smem[];
  float* qs = smem;                   // 64 x DP   q'
  float* dos = qs + kBQ * DP;         // 64 x DP   do
  float* ks = dos + kBQ * DP;         // 64 x KS   k of this key tile
  float* vs = ks + kBK * KS;          // 64 x KS   v
  float* dss = vs + kBK * KS;         // 64 x kPS  ds [query][key]
  float* lse_s = dss + kBQ * kPS;     // 64
  float* del_s = lse_s + kBQ;         // 64
  int* segq = reinterpret_cast<int*>(del_s + kBQ);   // 64
  int* segk = segq + kBQ;                             // 64

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * kBQ;
  const int rows_here = min(kBQ, a.Sq - q0);
  const int kvl = clamp_kvl(a, b);
  // columns past col_end are invisible to every row of this tile
  int col_end = kvl;
  if (a.causal) col_end = min(col_end, q0 + rows_here + a.q_offset);
  const int n_tiles = col_end > 0 ? (col_end + kBK - 1) / kBK : 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.st.q[0] + h * a.st.q[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.st.k[0] + h * a.st.k[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.st.v[0] + h * a.st.v[1];
  const T* ob = static_cast<const T*>(a.dO) + b * a.st.dO[0] +
                h * a.st.dO[1];

  stage<T, DP>(qs, DP, qb, a.st.q[2], q0, rows_here, a.D, true, a.scale);
  stage<T, DP>(dos, DP, ob, a.st.dO[2], q0, rows_here, a.D, false, 0.f);
  if (tid < kBQ) {
    const long long o = (long long)bh * a.Sq + q0 + tid;
    lse_s[tid] = tid < rows_here ? a.lse[o] : 0.f;
    del_s[tid] = tid < rows_here ? a.delta[o] : 0.f;
    segq[tid] = (a.seg != nullptr && tid < rows_here)
                    ? a.seg[(long long)b * a.Sq + q0 + tid] : kSegPadQ;
  }
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff;
  if (a.seg != nullptr) {
    for (int r = 0; r < rows_here; ++r) {
      qmin = min(qmin, segq[r]);
      qmax = max(qmax, segq[r]);
    }
  }

  const int ty = tid / 16, tx = tid % 16;
  float dq_acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DPT; ++j) dq_acc[i][j] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kBK;
    const int cols = min(kBK, col_end - c0);
    __syncthreads();              // the last turn's readers are done
    if (a.seg != nullptr) {
      int hit = 0;
      if (tid < kBK) {
        int sk = kSegPadK;
        if (tid < cols) {
          sk = a.seg[(long long)b * a.Skv + c0 + tid];
          hit = sk >= qmin && sk <= qmax;
        }
        segk[tid] = sk;
      }
      if (!__syncthreads_or(hit)) continue;   // disjoint ids: skip
    }
    stage<T, DP>(ks, KS, kb, a.st.k[2], c0, cols, a.D, false, 0.f);
    stage<T, DP>(vs, KS, vb, a.st.v[2], c0, cols, a.D, false, 0.f);
    __syncthreads();

    float sc[4][4], dp[4][4];
    score_tiles<DP>(qs, dos, ks, vs, ty, tx, sc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int col = c0 + c;
        bool ok = r < rows_here && c < cols;
        if (a.causal) ok = ok && col <= row + a.q_offset;
        if (a.seg != nullptr) ok = ok && segk[c] == segq[r];
        const float p = ok ? expf(sc[i][j] - lse_s[r]) : 0.f;
        dss[r * kPS + c] = p * (dp[i][j] - del_s[r]);
      }
    }
    __syncthreads();

    // dq += ds k: queries ty + 16 i, dims tx + 16 j
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float dv4[4], kv[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) dv4[i] = dss[(ty + 16 * i) * kPS + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) kv[j] = ks[c * KS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DPT; ++j)
          dq_acc[i][j] = fmaf(dv4[i], kv[j], dq_acc[i][j]);
    }
  }

  // dq is wrt the ORIGINAL q: rescale once at the write
  T* dqb = static_cast<T*>(a.dq) + b * a.st.dq[0] + h * a.st.dq[1];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows_here) continue;
    T* dqr = dqb + (long long)(q0 + r) * a.st.dq[2];
#pragma unroll
    for (int j = 0; j < DPT; ++j) {
      const int d = tx + 16 * j;
      if (d < a.D) store(dqr + d, dq_acc[i][j] * a.scale);
    }
  }
}

template <int DP>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (size_t)kBQ * DP + 2 * (size_t)kBK * (DP + 1) +
                          2 * (size_t)kBQ * kPS + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <int DP>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (size_t)kBQ * DP + 2 * (size_t)kBK * (DP + 1) +
                          (size_t)kBQ * kPS + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  auto dq_kern = flash_bwd_dq_kernel<T, DP>;
  auto dkv_kern = flash_bwd_dkv_kernel<T, DP>;
  constexpr size_t s_dq = dq_smem<DP>(), s_dkv = dkv_smem<DP>();
  cudaError_t e = mxtt::allow_smem(dq_kern, s_dq);
  if (e != cudaSuccess) return e;
  e = mxtt::allow_smem(dkv_kern, s_dkv);
  if (e != cudaSuccess) return e;
  if (a.Sq > 0) {
    dim3 grid(B * a.H, (a.Sq + kBQ - 1) / kBQ);
    dq_kern<<<grid, kThreads, s_dq, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv > 0) {
    dim3 grid(B * a.H, (a.Skv + kBK - 1) / kBK);
    dkv_kern<<<grid, kThreads, s_dkv, stream>>>(a);
    e = cudaGetLastError();
  }
  return e;
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 16) return launch<T, 16>(a, B, s);
  if (a.D <= 32) return launch<T, 32>(a, B, s);
  if (a.D <= 64) return launch<T, 64>(a, B, s);
  if (a.D <= 128) return launch<T, 128>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (q, k, v, do, dq, dk, dv share it).
// lse and delta are (B, H, Sq) float32, contiguous; kv_lens (B,) and
// seg (B, S) int32 or null. strides holds 21 element strides: (b, h, s)
// of q, k, v, do, dq, dk, then dv. Launches the dq and the dk/dv kernel
// and returns the first failing launch's cudaError_t (0 = launched).
extern "C" int mxtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dO,
    const void* lse, const void* delta, const void* kv_lens, const void* seg,
    void* dq, void* dk, void* dv, const long long* strides, int B, int H,
    int Sq, int Skv, int D, float scale, int causal, int q_offset,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 0 || Skv < 0 || D < 1 || D > 128)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.seg = static_cast<const int32_t*>(seg);
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.dO[i] = strides[9 + i];
    a.st.dq[i] = strides[12 + i];
    a.st.dk[i] = strides[15 + i];
    a.st.dv[i] = strides[18 + i];
  }
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(a, B, s);
    case 1: return (int)dispatch<__nv_bfloat16>(a, B, s);
    case 2: return (int)dispatch<__half>(a, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
