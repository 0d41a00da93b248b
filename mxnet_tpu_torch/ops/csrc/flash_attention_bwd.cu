// Flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU kernels of mxnet_tpu/ops/pallas/flash_attention.py::
// _flash_bwd: _bwd_fused_kernel (one pass, nk <= 2) and the split pair
// _bwd_dq_kernel / _bwd_dkv_kernel. All three compute one function:
// from q, k, v (B, H, S, D), the forward's lse (B, H, Sq) f32, the
// output gradient do (B, H, Sq, D) and delta = rowsum(do * o) - dlse
// (B, H, Sq) f32 (computed here from o, do and dlse),
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
// Design. Every block works on pairs of a 64-query tile and a key tile
// staged in shared memory as f32 (q' scaled and rounded as it is
// staged; rows past the live ones and columns past D zero). For a pair
// the warps compute s and dp ONCE on the tensor cores (a warp: 16
// queries x a share of the keys), mask, and leave p and ds in shared
// memory; then the gradient products read them: dq = ds k (a warp: 16
// queries x a share of D), dk += ds^T q' and dv += p^T do (a warp: 16
// keys x a share of D), each sum kept in registers. No atomics: the
// same bits every run.
//  - Fused (Skv <= 128 and D <= 64; the reference's nk <= 2 case, and
//    BERT training's S = 128): one block of 16 warps per (batch, head)
//    stages all of K and V once (a 128-key tile) and walks the query
//    tiles: every key is in the block, so each tile's dq is written
//    whole and dk, dv accumulate over the tiles: 5 products a pair, the
//    function's own. Its 173 KB of shared memory allow one block an
//    SM, so the block has 16 warps to hide the latency of the products'
//    operand loads and chains. K, V, q', do, p and ds for 128 keys at
//    D = 128 would not fit the 227 KB of shared memory, so wider heads
//    take the split path.
//  - Split (otherwise: packed and causal S = 512, ring attention, heads
//    past 64): a dq kernel, one block of 8 warps per (batch*head,
//    64-query tile) looping over the key tiles, and a dk/dv kernel, one
//    block per (batch*head, key tile) looping over the query tiles: s
//    and dp computed in each (7 products a pair). Key tiles are 64
//    keys, 32 at head dims past 128 (214 KB of shared memory then).
// The C entry point picks the path from Skv and D.
// Every block computes delta for a query tile as it stages it (in the
// dk/dv kernel once for each key tile: measured faster on an H100 than
// one pass before, or reading a copy the dq kernel kept).
// Products: mma.sync m16n8k8 TF32 on f32 operands read from shared
// memory, each f32 operand split into TF32 hi + lo (the 3-term product,
// common.cuh) and each k-step of 8 summed into a fresh partial added
// round-to-nearest. 16-bit inputs (bf16/f16) are exact in TF32, so
// their operands take one term; p and ds are f32 and always split, so
// every product keeps f32 accuracy whatever the input type (a 16-bit
// mma would round p and ds to 16 bits). Whole tiles are skipped as K1
// skips them: the loops never reach tiles past kv_len or across the
// causal diagonal (the fused kernel writes such tiles' dq as zeros),
// and in the split kernels a tile pair whose segment-id ranges are
// disjoint is skipped after reading the ids (one __syncthreads_or). q,
// k, v, do and the three gradients may be any views whose last axis is
// contiguous (strides are arguments): q, k, v are head views of the
// fused QKV projection. One C call launches the kernels on the caller's
// stream.
//
// Bound. Operations: 5 products of 2 * D flops per visible pair (s, dp,
// dq, dk, dv), at 495 TFLOP/s TF32 over 3 terms for f32. Bytes: q, k,
// v, do, o and lse read once, dq, dk and dv written once. At BERT's
// S = 128, D = 64 in f32 the bytes bound it.
//
// What this design leaves on the table: tiles are staged through
// registers synchronously (no cp.async/TMA double buffering), mma.sync
// rather than wgmma, 16-bit inputs still take f32 staging and TF32, and
// fragment reads of the transposed operands meet 2-way bank conflicts.

#include "common.cuh"

namespace {

using mxtt::mma_tf32;
using mxtt::mma_tf32_0;
using mxtt::round_to;
using mxtt::split_tf32;
using mxtt::store;
using mxtt::to_f32;

constexpr int kQT = 64;         // queries per tile
constexpr int kFusedKT = 128;   // keys per tile (all of them), fused
constexpr int kSplitWarps = 8;  // warps a block, split kernels
constexpr int kFusedWarps = 16; // warps a block, fused kernel
constexpr int kSegPadQ = -2, kSegPadK = -3;   // never equal to each other

// keys per tile of the split kernels at head dim DP (shared memory)
template <int DP>
__host__ __device__ constexpr int split_kt() {
  return DP <= 128 ? 64 : 32;
}

struct Strides {                // element strides of (b, h, s); d is 1
  long long q[3], k[3], v[3], dO[3], o[3], dq[3], dk[3], dv[3];
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const void* o;                // the forward's output
  const float* lse;             // (B, H, Sq), contiguous
  const float* dlse;            // (B, H, Sq), contiguous, or null
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

// How a block of NW warps shares the work of a (64-query, KT-key) pair
// at head dim DP:
//  - s, dp: warp -> query m-tile warp % 4, key part warp / 4 (SP parts,
//    SNT n-tiles each);
//  - dq: query m-tile warp % 4, D part warp / 4 (QP parts of QNT
//    n-tiles; warps past QP parts idle);
//  - dk, dv: key m-tile warp % KM, D part warp / KM (KP parts of KNT
//    n-tiles).
template <int DP, int KT, int NW>
struct Work {
  static constexpr int kThreads = 32 * NW;
  static constexpr int SP = NW / 4;
  static constexpr int SNT = KT / 8 / SP;
  static constexpr int QNT = DP / 8 / SP > 0 ? DP / 8 / SP : 1;
  static constexpr int QP = DP / 8 / QNT;
  static constexpr int KM = KT / 16;
  static constexpr int KP = NW / KM;
  static constexpr int KNT = DP / 8 / KP;
  static_assert(SNT >= 1 && KNT >= 1 && KP * KM == NW, "work split");
};

// Stage rows [r0, r0 + ROWS) of two (S, D) slices as f32 into dst0 and
// dst1 (row stride DP + 4), the first pre-scaled and rounded when
// `scale0` (q'); rows past `rows` and columns past D are zeros. Each
// thread issues up to 16 loads of each slice before it stores any: a
// loop that stored each value before loading the next would wait out
// one device-memory latency per element.
template <typename T, int DP, int ROWS, int THREADS>
__device__ __forceinline__ void stage2(float* dst0, const T* src0,
                                       long long rs0, float* dst1,
                                       const T* src1, long long rs1, int r0,
                                       int rows, int D, bool scale0,
                                       float scale) {
  constexpr int kPer = ROWS * DP / THREADS;     // elements per thread
  constexpr int kGroup = kPer < 16 ? kPer : 16;
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kGroup) {
    float x[kGroup], y[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * THREADS;
      const int r = i / DP, d = i - r * DP;
      x[u] = y[u] = 0.f;
      if (r < rows && d < D) {
        x[u] = to_f32(src0[(long long)(r0 + r) * rs0 + d]);
        y[u] = to_f32(src1[(long long)(r0 + r) * rs1 + d]);
      }
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * THREADS;
      const int r = i / DP, d = i - r * DP;
      dst0[r * (DP + 4) + d] = scale0 ? round_to(x[u] * scale, T()) : x[u];
      dst1[r * (DP + 4) + d] = y[u];
    }
  }
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
      hi[i] = mxtt::tf32_rna(x[i]);   // exact: a 16-bit input value
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

// Shared memory of a block with key tiles of KT: K, V (KT rows), q', do
// (64 rows), all f32 at row stride DP + 4; p, ds [64][KT + 4] f32;
// lse, delta (64 f32); query and key segment ids (64 + KT int).
template <int DP, int KT>
struct Tiles {
  static constexpr int LD = DP + 4, LP = KT + 4;
  float* ks;
  float* vs;
  float* qs;
  float* dos;
  float* ps;
  float* dss;
  float* lse;
  float* del;
  int* segq;
  int* segk;
  __device__ explicit Tiles(float* s)
      : ks(s), vs(ks + KT * LD), qs(vs + KT * LD), dos(qs + kQT * LD),
        ps(dos + kQT * LD), dss(ps + kQT * LP), lse(dss + kQT * LP),
        del(lse + kQT), segq(reinterpret_cast<int*>(del + kQT)),
        segk(segq + kQT) {}
  static constexpr size_t bytes() {
    return sizeof(float) * (2 * (size_t)KT * LD + 2 * (size_t)kQT * LD +
                            2 * (size_t)kQT * LP + 2 * kQT) +
           sizeof(int) * (kQT + KT);
  }
};

template <typename T>
struct Heads {                  // this (batch, head)'s slices
  const T *q, *k, *v, *dout, *out;
  T *dq, *dk, *dv;
  __device__ Heads(const Args& a, int b, int h)
      : q(static_cast<const T*>(a.q) + b * a.st.q[0] + h * a.st.q[1]),
        k(static_cast<const T*>(a.k) + b * a.st.k[0] + h * a.st.k[1]),
        v(static_cast<const T*>(a.v) + b * a.st.v[0] + h * a.st.v[1]),
        dout(static_cast<const T*>(a.dO) + b * a.st.dO[0] +
             h * a.st.dO[1]),
        out(static_cast<const T*>(a.o) + b * a.st.o[0] + h * a.st.o[1]),
        dq(static_cast<T*>(a.dq) + b * a.st.dq[0] + h * a.st.dq[1]),
        dk(static_cast<T*>(a.dk) + b * a.st.dk[0] + h * a.st.dk[1]),
        dv(static_cast<T*>(a.dv) + b * a.st.dv[0] + h * a.st.dv[1]) {}
};

// Stage the query tile: q' and do (rows_here rows from q0), lse, the
// query segment ids (pads where none), and delta = rowsum(do * o) -
// dlse, 4 threads a row, each D / 4 products, in a fixed order.
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void stage_queries(const Tiles<DP, KT>& sm,
                                              const Args& a, int b, int bh,
                                              const Heads<T>& x, int q0,
                                              int rows_here) {
  stage2<T, DP, kQT, 32 * NW>(sm.qs, x.q, a.st.q[2], sm.dos, x.dout,
                              a.st.dO[2], q0, rows_here, a.D, true,
                              a.scale);
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  const long long o = (long long)bh * a.Sq + q0 + r;
  const bool live = r < rows_here;
  float sum = 0.f;
  if (live) {
    const T* dr = x.dout + (long long)(q0 + r) * a.st.dO[2];
    const T* orow = x.out + (long long)(q0 + r) * a.st.o[2];
#pragma unroll 4
    for (int d = part; d < a.D; d += 4)
      sum += to_f32(dr[d]) * to_f32(orow[d]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  if (part == 0 && r < kQT) {
    sm.del[r] = live ? sum - (a.dlse != nullptr ? a.dlse[o] : 0.f) : 0.f;
    sm.lse[r] = live ? a.lse[o] : 0.f;
    sm.segq[r] = (a.seg != nullptr && live)
                     ? a.seg[(long long)b * a.Sq + q0 + r] : kSegPadQ;
  }
}

// Stage the key tile: k and v (cols live rows from k0, the rest zeros)
// and the key segment ids (pads past the live keys).
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void stage_keys(const Tiles<DP, KT>& sm,
                                           const Args& a, int b,
                                           const Heads<T>& x, int k0,
                                           int cols) {
  stage2<T, DP, KT, 32 * NW>(sm.ks, x.k, a.st.k[2], sm.vs, x.v, a.st.v[2],
                             k0, cols, a.D, false, 0.f);
  for (int c = threadIdx.x; c < KT; c += 32 * NW)
    sm.segk[c] = (a.seg != nullptr && c < cols)
                     ? a.seg[(long long)b * a.Skv + k0 + c] : kSegPadK;
}

// s = q' k^T and dp = do v^T for the staged pair (Work's split), masked,
// then p and ds into shared memory. `cols`: live keys of the tile;
// visibility as the header says.
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void scores(const Tiles<DP, KT>& sm,
                                       const Args& a, int q0, int rows_here,
                                       int k0, int cols) {
  using W = Work<DP, KT, NW>;
  constexpr bool kSplit = sizeof(T) == 4;
  constexpr int NT = W::SNT;
  constexpr int LD = Tiles<DP, KT>::LD, LP = Tiles<DP, KT>::LP;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = warp % 4, c0 = (warp / 4) * (8 * NT);
  const float* qr = sm.qs + 16 * mi * LD;
  const float* orow = sm.dos + 16 * mi * LD;
  const float* kr = sm.ks + c0 * LD;
  const float* vr = sm.vs + c0 * LD;
  // n-tiles of live keys; none for a warp past the live rows (every
  // pair it skips is masked below)
  const int nt_live = 16 * mi < rows_here
                          ? max(0, min(NT, (cols - c0 + 7) / 8)) : 0;
  float s[NT][4] = {}, dp[NT][4] = {};
  warp_mma2<NT, kSplit, kSplit>(
      s, [&](int m, int k) { return qr[m * LD + k]; },
      [&](int k, int n) { return kr[n * LD + k]; }, dp,
      [&](int m, int k) { return orow[m * LD + k]; },
      [&](int k, int n) { return vr[n * LD + k]; }, DP, nt_live);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * mi + gid + (q < 2 ? 0 : 8);
      const int c = c0 + 8 * j + 2 * tig + (q & 1);
      bool ok = r < rows_here && c < cols;
      if (a.causal) ok = ok && k0 + c <= q0 + r + a.q_offset;
      if (a.seg != nullptr) ok = ok && sm.segk[c] == sm.segq[r];
      // masked BEFORE the exponent (lse = -1e30 on empty rows)
      const float p = ok ? expf(s[j][q] - sm.lse[r]) : 0.f;
      sm.ps[r * LP + c] = p;
      sm.dss[r * LP + c] = p * (dp[j][q] - sm.del[r]);
    }
}

// dq += ds k for the staged pair (Work's split), as deep as the tile's
// `cols` live keys (ds is zero past them).
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void dq_product(
    const Tiles<DP, KT>& sm, int rows_here, int cols,
    float (&acc)[Work<DP, KT, NW>::QNT][4]) {
  using W = Work<DP, KT, NW>;
  constexpr int LD = Tiles<DP, KT>::LD, LP = Tiles<DP, KT>::LP;
  const int warp = threadIdx.x >> 5;
  if (16 * (warp % 4) >= rows_here || warp / 4 >= W::QP) return;
  const float* dsr = sm.dss + 16 * (warp % 4) * LP;
  const float* kc = sm.ks + (warp / 4) * (8 * W::QNT);
  warp_mma<W::QNT, true, sizeof(T) == 4>(
      acc, (cols + 7) / 8 * 8, [&](int m, int k) { return dsr[m * LP + k]; },
      [&](int k, int n) { return kc[k * LD + n]; });
}

// dk += ds^T q' and dv += p^T do for the staged pair (Work's split), as
// deep as the tile's `rows_here` queries; a warp past the `cols` live
// keys has only zeros to add.
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void dkv_product(
    const Tiles<DP, KT>& sm, int rows_here, int cols,
    float (&dk)[Work<DP, KT, NW>::KNT][4],
    float (&dv)[Work<DP, KT, NW>::KNT][4]) {
  using W = Work<DP, KT, NW>;
  constexpr int LD = Tiles<DP, KT>::LD, LP = Tiles<DP, KT>::LP;
  const int warp = threadIdx.x >> 5;
  const int key0 = 16 * (warp % W::KM), d0 = (warp / W::KM) * W::KNT * 8;
  if (key0 >= cols) return;
  const float* dsc = sm.dss + key0;
  const float* pc = sm.ps + key0;
  const float* qc = sm.qs + d0;
  const float* oc = sm.dos + d0;
  warp_mma2<W::KNT, true, sizeof(T) == 4>(
      dk, [&](int m, int k) { return dsc[k * LP + m]; },
      [&](int k, int n) { return qc[k * LD + n]; }, dv,
      [&](int m, int k) { return pc[k * LP + m]; },
      [&](int k, int n) { return oc[k * LD + n]; }, (rows_here + 7) / 8 * 8);
}

// Write a warp's dq rows (scaled to the ORIGINAL q) for the tile at q0.
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void write_dq(
    const Args& a, T* dqb, int q0, int rows_here,
    const float (&acc)[Work<DP, KT, NW>::QNT][4]) {
  using W = Work<DP, KT, NW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  if (warp / 4 >= W::QP) return;
#pragma unroll
  for (int j = 0; j < W::QNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * (warp % 4) + gid + (q < 2 ? 0 : 8);
      const int d = (warp / 4) * (8 * W::QNT) + 8 * j + 2 * tig + (q & 1);
      if (r < rows_here && d < a.D)
        store(dqb + (long long)(q0 + r) * a.st.dq[2] + d,
              acc[j][q] * a.scale);
    }
}

// Write a warp's dk, dv rows of the key tile at k0 (`rows` of them).
template <typename T, int DP, int KT, int NW>
__device__ __forceinline__ void write_dkv(
    const Args& a, T* dkb, T* dvb, int k0, int rows,
    const float (&dk)[Work<DP, KT, NW>::KNT][4],
    const float (&dv)[Work<DP, KT, NW>::KNT][4]) {
  using W = Work<DP, KT, NW>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int j = 0; j < W::KNT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = 16 * (warp % W::KM) + gid + (q < 2 ? 0 : 8);
      const int d = (warp / W::KM) * W::KNT * 8 + 8 * j + 2 * tig + (q & 1);
      if (c < rows && d < a.D) {
        store(dkb + (long long)(k0 + c) * a.st.dk[2] + d, dk[j][q]);
        store(dvb + (long long)(k0 + c) * a.st.dv[2] + d, dv[j][q]);
      }
    }
}

// ---------------------------------------------------------------------------
// Fused: one block per (b*h), all keys (Skv <= 128) in one tile.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kFusedWarps)
flash_bwd_fused_kernel(Args a) {
  constexpr int NW = kFusedWarps, KT = kFusedKT;
  using W = Work<DP, KT, NW>;
  extern __shared__ float smem[];
  const Tiles<DP, KT> sm(smem);
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const Heads<T> x(a, b, h);
  const int kvl = clamp_kvl(a, b);
  stage_keys<T, DP, KT, NW>(sm, a, b, x, 0, kvl);
  float dk[W::KNT][4] = {}, dv[W::KNT][4] = {};
  const int n_qt = (a.Sq + kQT - 1) / kQT;
  for (int t = 0; t < n_qt; ++t) {
    const int q0 = t * kQT, rows_here = min(kQT, a.Sq - q0);
    // a tile where no row sees a key: every row's dq is zero
    if (kvl == 0 || (a.causal && q0 + rows_here - 1 + a.q_offset < 0)) {
      for (int e = threadIdx.x; e < rows_here * a.D; e += W::kThreads)
        store(x.dq + (long long)(q0 + e / a.D) * a.st.dq[2] + e % a.D, 0.f);
      continue;
    }
    __syncthreads();              // the last turn's readers are done
    stage_queries<T, DP, KT, NW>(sm, a, b, bh, x, q0, rows_here);
    __syncthreads();
    scores<T, DP, KT, NW>(sm, a, q0, rows_here, 0, kvl);
    __syncthreads();
    float dq[W::QNT][4] = {};
    dq_product<T, DP, KT, NW>(sm, rows_here, kvl, dq);
    write_dq<T, DP, KT, NW>(a, x.dq, q0, rows_here, dq);
    dkv_product<T, DP, KT, NW>(sm, rows_here, kvl, dk, dv);
  }
  // every key row is written: zeros where no query sees it
  write_dkv<T, DP, KT, NW>(a, x.dk, x.dv, 0, a.Skv, dk, dv);
}

// ---------------------------------------------------------------------------
// Split dq: one block per (b*h, 64-query tile), looping over key tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kSplitWarps)
flash_bwd_dq_kernel(Args a) {
  constexpr int NW = kSplitWarps, KT = split_kt<DP>();
  using W = Work<DP, KT, NW>;
  extern __shared__ float smem[];
  const Tiles<DP, KT> sm(smem);
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const Heads<T> x(a, b, h);
  const int q0 = blockIdx.y * kQT;
  const int rows_here = min(kQT, a.Sq - q0);
  // columns past col_end are invisible to every row of this tile
  int col_end = clamp_kvl(a, b);
  if (a.causal) col_end = min(col_end, q0 + rows_here + a.q_offset);
  const int n_tiles = col_end > 0 ? (col_end + KT - 1) / KT : 0;
  stage_queries<T, DP, KT, NW>(sm, a, b, bh, x, q0, rows_here);
  __syncthreads();
  int qmin = 0x7fffffff, qmax = -0x7fffffff;
  if (a.seg != nullptr) {
    for (int r = 0; r < rows_here; ++r) {
      qmin = min(qmin, sm.segq[r]);
      qmax = max(qmax, sm.segq[r]);
    }
  }
  float dq[W::QNT][4] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * KT, cols = min(KT, col_end - c0);
    __syncthreads();              // the last turn's readers are done
    if (a.seg != nullptr) {
      int hit = 0;
      if (threadIdx.x < cols) {
        const int sk = a.seg[(long long)b * a.Skv + c0 + threadIdx.x];
        hit = sk >= qmin && sk <= qmax;
      }
      if (!__syncthreads_or(hit)) continue;   // disjoint ids: skip
    }
    stage_keys<T, DP, KT, NW>(sm, a, b, x, c0, cols);
    __syncthreads();
    scores<T, DP, KT, NW>(sm, a, q0, rows_here, c0, cols);
    __syncthreads();
    dq_product<T, DP, KT, NW>(sm, rows_here, cols, dq);
  }
  write_dq<T, DP, KT, NW>(a, x.dq, q0, rows_here, dq);
}

// ---------------------------------------------------------------------------
// Split dk, dv: one block per (b*h, key tile), looping over query
// tiles.
template <typename T, int DP>
__global__ void __launch_bounds__(32 * kSplitWarps)
flash_bwd_dkv_kernel(Args a) {
  constexpr int NW = kSplitWarps, KT = split_kt<DP>();
  using W = Work<DP, KT, NW>;
  extern __shared__ float smem[];
  const Tiles<DP, KT> sm(smem);
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const Heads<T> x(a, b, h);
  const int k0 = blockIdx.y * KT;
  const int cols_here = min(KT, a.Skv - k0);
  // keys of this tile that any query can see: none when the tile starts
  // at/after kv_len; under causal only rows >= k0 - q_offset see key k0
  const int keys_live = max(0, min(cols_here, clamp_kvl(a, b) - k0));
  const int row_begin = a.causal ? max(0, k0 - a.q_offset) : 0;
  const int n_qt = (a.Sq + kQT - 1) / kQT;
  const int t_begin = keys_live > 0 ? row_begin / kQT : n_qt;
  stage_keys<T, DP, KT, NW>(sm, a, b, x, k0, keys_live);
  __syncthreads();
  int kmin = 0x7fffffff, kmax = -0x7fffffff;
  if (a.seg != nullptr) {
    for (int c = 0; c < keys_live; ++c) {
      kmin = min(kmin, sm.segk[c]);
      kmax = max(kmax, sm.segk[c]);
    }
  }
  float dk[W::KNT][4] = {}, dv[W::KNT][4] = {};
  for (int t = t_begin; t < n_qt; ++t) {
    const int q0 = t * kQT, rows_here = min(kQT, a.Sq - q0);
    __syncthreads();              // the last turn's readers are done
    if (a.seg != nullptr) {
      int hit = 0;
      if (threadIdx.x < rows_here) {
        const int sq = a.seg[(long long)b * a.Sq + q0 + threadIdx.x];
        hit = sq >= kmin && sq <= kmax;
      }
      if (!__syncthreads_or(hit)) continue;   // disjoint ids: skip
    }
    stage_queries<T, DP, KT, NW>(sm, a, b, bh, x, q0, rows_here);
    __syncthreads();
    scores<T, DP, KT, NW>(sm, a, q0, rows_here, k0, keys_live);
    __syncthreads();
    dkv_product<T, DP, KT, NW>(sm, rows_here, keys_live, dk, dv);
  }
  // every key row of the tile is written: zeros where no query sees it
  write_dkv<T, DP, KT, NW>(a, x.dk, x.dv, k0, cols_here, dk, dv);
}

template <typename K>
cudaError_t launch1(K kern, dim3 grid, int threads, size_t smem,
                    const Args& a, cudaStream_t stream) {
  cudaError_t e = mxtt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// the fused kernel where every key fits its tile (Skv <= 128) and its
// tiles fit shared memory (D <= 64), else the split pair
template <typename T, int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  if constexpr (DP <= 64) {
    if (a.Skv <= kFusedKT)
      return launch1(flash_bwd_fused_kernel<T, DP>, dim3(B * a.H),
                     32 * kFusedWarps, Tiles<DP, kFusedKT>::bytes(), a,
                     stream);
  }
  constexpr int KT = split_kt<DP>();
  constexpr size_t smem = Tiles<DP, KT>::bytes();
  cudaError_t e = cudaSuccess;
  if (a.Sq > 0)
    e = launch1(flash_bwd_dq_kernel<T, DP>,
                dim3(B * a.H, (a.Sq + kQT - 1) / kQT), 32 * kSplitWarps,
                smem, a, stream);
  if (e == cudaSuccess && a.Skv > 0)
    e = launch1(flash_bwd_dkv_kernel<T, DP>,
                dim3(B * a.H, (a.Skv + KT - 1) / KT),
                32 * kSplitWarps, smem, a, stream);
  return e;
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 16) return launch<T, 16>(a, B, s);
  if (a.D <= 32) return launch<T, 32>(a, B, s);
  if (a.D <= 64) return launch<T, 64>(a, B, s);
  if (a.D <= 128) return launch<T, 128>(a, B, s);
  if (a.D <= 256) return launch<T, 256>(a, B, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16, 2 = float16 (q, k, v, do, o, dq, dk, dv share it). o is
// the forward's output; lse and dlse (the lse's gradient, or null) are
// (B, H, Sq) float32, contiguous; kv_lens (B,) and seg (B, S) int32 or
// null. strides holds 24 element strides: (b, h, s) of q, k,
// v, do, o, dq, dk, then dv. Skv <= 128 with D <= 64 launches the
// one-pass kernel, anything else the dq and the dk/dv kernel. Returns
// the first failing launch's cudaError_t (0 = launched).
extern "C" int mxtt_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* dO,
    const void* o, const void* lse, const void* dlse, const void* kv_lens, const void* seg, void* dq, void* dk, void* dv,
    const long long* strides, int B, int H, int Sq, int Skv, int D,
    float scale, int causal, int q_offset, int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 0 || Skv < 0 || D < 1 || D > 256)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dO = dO;
  a.o = o;
  a.lse = static_cast<const float*>(lse);
  a.dlse = static_cast<const float*>(dlse);
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
    a.st.o[i] = strides[12 + i];
    a.st.dq[i] = strides[15 + i];
    a.st.dk[i] = strides[18 + i];
    a.st.dv[i] = strides[21 + i];
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
