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
// lse = -1e30 (the TPU kernel's `seen` guard and l_safe division). The
// TPU kernel runs f32 at HIGHEST precision; so does this one.
//
// Bound. Operations: 4 * D flops per visible (i, j) pair (QK^T and PV).
// On the tensor cores an f32 product kept to f32 accuracy takes three
// TF32 products (495 / 3 TFLOP/s); at BERT-base's S = 512, D = 64 that
// is about 85 flops per byte of q, k, v and o, above the card's balance
// of 49 at that rate, so operations bound f32; 16-bit inputs take one
// TF32 term for QK^T and two for PV, and move half the bytes.
//
// Design. On the TPU the key-tile axis is a sequential grid dimension
// and m, l and acc live in VMEM scratch between grid steps. Here one
// block of 8 warps owns one (batch*head, 64-query tile) and LOOPS over
// key tiles (64 keys, 32 past D = 128). A warp owns 16 query rows and
// one half of each key tile, with its own (m, l, acc); the two halves
// are folded once, at the end, through shared memory. Two warps a row
// group (16 an SM at two blocks) keep the tensor cores fed where one
// warp would wait out its products' latency.
//  - Both products run on mma.sync m16n8k8 TF32 (common.cuh's
//    mma_kstep_il): f32 operands split into TF32 hi + lo (3 terms),
//    16-bit ones exact in one term, each k-step summed into a fresh
//    partial added round-to-nearest; the n-tiles' products interleaved,
//    so mma issued back to back are independent.
//  - Scores stay in registers: the warp's S fragment (16 x 32) is
//    masked, its row max taken with quad shuffles, exponentiated, and
//    used in place as the A operand of P.V: accumulator columns
//    (2 tig, 2 tig + 1) serve as depth indices (tig, tig + 4), and V's
//    rows are read in that order. No score tile in shared memory, no
//    block-wide sync for the softmax; the row sum l is kept per lane
//    and summed over the quad once, at the end.
//  - q' is staged once as f32 (scaled and rounded as it is staged); K
//    and V tiles are raw in shared memory (f32 or 16-bit), double
//    buffered: cp.async brings the next live tile while the warps
//    compute on this one, one __syncthreads a tile. Rows are padded
//    (4 words in f32, 8 halves in 16 bits) so the fragment reads are
//    free of bank conflicts. Tiles not 16-byte aligned (odd widths or
//    strides) are staged through registers instead.
//  - Whole key tiles are skipped as _block_visible does: the loop never
//    reaches tiles at or past kv_len or above the causal diagonal, and
//    with segment ids a pre-pass over the visible keys' ids marks the
//    tiles holding an id in the query tile's [min, max] range (one
//    bit a tile in shared memory; skipped where the keys fit one tile);
//    the rest are never loaded.
//  - The ragged edges (Sq, Skv and D not multiples of the tiles) are
//    zero-filled and masked. q, k, v and o may be any views whose last
//    axis is contiguous (strides are arguments), so heads sliced out of
//    a fused QKV projection need no copy, and o can be written straight
//    into a (B, S, H, D) buffer. No atomics: the same bits every run.
//
// What it still leaves: mma.sync rather than wgmma, and cp.async rather
// than TMA with mbarriers; 16-bit inputs still take TF32 (not the
// m16n8k16 16-bit mma) and P.V keeps p in f32 (two TF32 terms), so bf16
// does not reach its tensor-core rate; the f32 split of each K and V
// fragment is redone by every warp that reads it; head dims past 128
// hold a 32-key tile and 128 accumulator registers a lane. Past 256 the
// head dim is cut into chunks (flash_fwd_wide_kernel, below).

#include "common.cuh"

namespace {

using mxtt::cp_async16;
using mxtt::cp_async4;
using mxtt::cp_async_commit;
using mxtt::cp_async_wait;
using mxtt::mma_kstep_il;
using mxtt::round_to;
using mxtt::store;
using mxtt::tf32_words_int;
using mxtt::to_f32;

constexpr int kRowGroups = 4;           // warps along the queries
constexpr int kWarps = 2 * kRowGroups;  // and two along each key tile
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kRowGroups;    // queries a block: 16 a warp
constexpr float kNegInf = -1e30f;       // as the TPU kernel's sentinel
constexpr int kSegPadQ = -2;            // no key holds it

struct Strides {                // element strides of (b, h, s); d is 1
  long long q[3], k[3], v[3], o[3];
};

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* kv_lens;       // (B,) or null
  const int32_t* seg;           // (B, S) or null
  void* o;
  float* lse;                   // (B, H, Sq), contiguous
  Strides st;
  int H, Sq, Skv, D;
  float scale;
  int causal, q_offset;
  int vec;                      // k, v tiles may be copied 16 bytes at once
};

// Shared memory of a block at padded head dim DP: q' (kBQ rows, f32),
// two stages of K and V (KT rows each, T), two stages of key segment
// ids, the query ids, then one bit a key tile (live tiles, packed rows).
// After the loop the stages hold the second key half's o for the merge
// and q's rows its m and l.
template <typename T, int DP>
struct Tiles {
  static constexpr int KT = DP <= 128 ? 64 : 32;       // keys a tile
  static constexpr int LDQ = DP + 4;                   // f32
  static constexpr int LDK = DP + (sizeof(T) == 4 ? 4 : 8);
  static constexpr size_t q_bytes = sizeof(float) * kBQ * LDQ;
  static constexpr size_t stage = 2 * (size_t)KT * LDK;   // elements
  static constexpr size_t fixed =
      q_bytes + 2 * stage * sizeof(T) + sizeof(int) * (2 * KT + kBQ);
  static_assert(2 * stage * sizeof(T) >= sizeof(float) * kBQ * LDQ,
                "the merge's o fits the stages");
  static size_t bytes(int mask_words) {
    return fixed + sizeof(unsigned) * mask_words;
  }
};

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads, DP <= 64 ? 2 : 1)
flash_fwd_kernel(Args a) {
  using S = Tiles<T, DP>;
  constexpr int KT = S::KT, LDQ = S::LDQ, LDK = S::LDK;
  constexpr int KH = KT / 2;            // keys of a tile a warp takes
  constexpr int NT = KH / 8;            // score n-tiles (keys) a warp
  constexpr int ND = DP / 8;            // output n-tiles (dims) a warp
  constexpr int OC = ND < 4 ? ND : 4;   // output n-tiles a P.V step
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int VEC = 16 / sizeof(T);   // elements a 16-byte copy
  constexpr int CPR = DP / VEC;         // copies a padded row
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  T* kv = reinterpret_cast<T*>(smem + S::q_bytes);   // [stage][K, V]
  int* segk = reinterpret_cast<int*>(kv + 2 * S::stage);   // [stage][KT]
  int* segq = segk + 2 * KT;                               // kBQ
  unsigned* live = reinterpret_cast<unsigned*>(segq + kBQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int rg = warp % kRowGroups, kh = warp / kRowGroups;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * kBQ;
  const int rows_here = min(kBQ, a.Sq - q0);
  int kvl = a.kv_lens != nullptr ? a.kv_lens[b] : a.Skv;
  kvl = max(0, min(kvl, a.Skv));
  // columns past col_end are invisible to every row of this tile
  int col_end = kvl;
  if (a.causal) col_end = min(col_end, q0 + rows_here + a.q_offset);
  const int n_tiles = col_end > 0 ? (col_end + KT - 1) / KT : 0;

  const T* qb = static_cast<const T*>(a.q) + b * a.st.q[0] + h * a.st.q[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.st.k[0] + h * a.st.k[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.st.v[0] + h * a.st.v[1];
  const int32_t* segrow =
      a.seg != nullptr ? a.seg + (long long)b * a.Skv : nullptr;

  // packed rows: mark the key tiles holding an id of this query tile's
  // [min, max] range (one tile needs no mark: if none of its ids
  // matches, every pair is masked)
  auto stage_segq = [&]() {
    if (tid < kBQ)
      segq[tid] = tid < rows_here ? segrow[q0 + tid] : kSegPadQ;
  };
  if (segrow != nullptr && n_tiles > 1) {
    stage_segq();
    for (int i = tid; i < (n_tiles + 31) / 32; i += kThreads) live[i] = 0u;
    __syncthreads();
    int qmin = 0x7fffffff, qmax = -0x7fffffff;
    for (int r = 0; r < rows_here; ++r) {
      qmin = min(qmin, segq[r]);
      qmax = max(qmax, segq[r]);
    }
    for (int c0 = 0; c0 < col_end; c0 += 4 * kThreads) {
      int sk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * kThreads + tid;
        sk[u] = c < col_end ? segrow[c] : 0;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int c = c0 + u * kThreads + tid;
        if (c < col_end && sk[u] >= qmin && sk[u] <= qmax)
          atomicOr(&live[(c / KT) >> 5], 1u << ((c / KT) & 31));
      }
    }
    __syncthreads();
  }
  // the first live tile at or after t (n_tiles when none)
  auto next_tile = [&](int t) {
    if (segrow == nullptr || n_tiles == 1) return min(t, n_tiles);
    while (t < n_tiles) {
      const unsigned w = live[t >> 5] >> (t & 31);
      if (w != 0u) return t + __ffs(w) - 1;
      t = (t | 31) + 1;
    }
    return n_tiles;
  };
  // start the copies of key tile t into stage s: rows past the live
  // keys and columns past D are zeros
  auto stage = [&](int t, int s) {
    const int c0 = t * KT, cols = min(KT, col_end - c0);
    T* ks = kv + s * S::stage;
    T* vs = ks + KT * LDK;
    for (int i = tid; i < KT * CPR; i += kThreads) {
      const int r = i / CPR, d0 = (i - r * CPR) * VEC;
      const int n = r < cols ? max(0, min(VEC, a.D - d0)) : 0;
      const T* gk = kb + (long long)(c0 + r) * a.st.k[2] + d0;
      const T* gv = vb + (long long)(c0 + r) * a.st.v[2] + d0;
      T* dk = ks + r * LDK + d0;
      T* dv = vs + r * LDK + d0;
      if (a.vec) {
        cp_async16(dk, n > 0 ? gk : kb, n * (int)sizeof(T));
        cp_async16(dv, n > 0 ? gv : vb, n * (int)sizeof(T));
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          if (e < n) {
            dk[e] = gk[e];
            dv[e] = gv[e];
          } else {
            store(dk + e, 0.f);
            store(dv + e, 0.f);
          }
        }
      }
    }
    if (segrow != nullptr)
      for (int c = tid; c < KT; c += kThreads)
        cp_async4(segk + s * KT + c, c < cols ? segrow + c0 + c : segrow,
                  c < cols ? 4 : 0);
    cp_async_commit();
  };

  int t = next_tile(0), s = 0;
  if (t < n_tiles) stage(t, 0);

  // q', scaled and rounded to T as the TPU wrapper does; rows past the
  // tile and columns past D are zeros. Up to 16 loads a thread in
  // flight before any store.
  for (int i0 = 0; i0 < kBQ * DP; i0 += 16 * kThreads) {
    float x[16];
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int r = i / DP, d = i - r * DP;
      x[u] = i < kBQ * DP && r < rows_here && d < a.D
                 ? to_f32(qb[(long long)(q0 + r) * a.st.q[2] + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 16; ++u) {
      const int i = i0 + u * kThreads + tid;
      const int r = i / DP, d = i - r * DP;
      if (i < kBQ * DP) qs[r * LDQ + d] = round_to(x[u] * a.scale, T());
    }
  }

  // with one key tile the ids were not needed before its copies
  if (segrow != nullptr && n_tiles == 1) stage_segq();

  const int wr = 16 * rg;                   // the warp's first row
  const bool warp_live = wr < rows_here;
  const int ra = wr + gid, rb = ra + 8;     // this lane's two rows
  // the columns a row sees lie below its limit: kv_len, the causal
  // diagonal; none for a row past the tile
  auto row_limit = [&](int r) {
    int lim = r < rows_here ? kvl : 0;
    if (a.causal) lim = min(lim, q0 + r + a.q_offset + 1);
    return lim;
  };
  const int lim[2] = {row_limit(ra), row_limit(rb)};
  const int dk8 = (a.D + 7) / 8;            // k-steps / n-tiles over D
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[j][q] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  while (t < n_tiles) {
    cp_async_wait<0>();
    __syncthreads();            // tile t landed; tile t-1's readers done
    const int tn = next_tile(t + 1);
    if (tn < n_tiles) stage(tn, s ^ 1);
    const int c0 = t * KT + kh * KH;          // this warp's first key
    const int nt_live = min(NT, max(0, (min(KT, col_end - t * KT) -
                                        kh * KH + 7) / 8));
    if (warp_live && nt_live > 0) {
      const T* ks = kv + s * S::stage + kh * KH * LDK;
      const T* vs = ks + KT * LDK;
      const int* sk = segk + s * KT + kh * KH;
      const float* qw = qs + wr * LDQ;
      const int sqa = segrow != nullptr ? segq[ra] : 0;
      const int sqb = segrow != nullptr ? segq[rb] : 0;
      // s = q' k^T (16 x KH)
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) sc[j][q] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < ND; ++kk) {
        if (kk < dk8) {
          const int k0 = 8 * kk;
          const float av[4] = {qw[gid * LDQ + k0 + tig],
                               qw[(gid + 8) * LDQ + k0 + tig],
                               qw[gid * LDQ + k0 + tig + 4],
                               qw[(gid + 8) * LDQ + k0 + tig + 4]};
          uint32_t ah[4], al[4];
          tf32_words_int<4, F32>(av, ah, al);
          mma_kstep_il<NT, F32, F32>(
              sc, ah, al, k0,
              [&](int k, int n) { return to_f32(ks[n * LDK + k]); },
              nt_live);
        }
      }
      // mask, then the online softmax of the two rows, in registers
      float tmax[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = 8 * j + 2 * tig + (q & 1);
          bool ok = c0 + c < lim[q >> 1];
          if (segrow != nullptr) ok = ok && sk[c] == (q < 2 ? sqa : sqb);
          sc[j][q] = ok ? sc[j][q] : kNegInf;
          tmax[q >> 1] = fmaxf(tmax[q >> 1], sc[j][q]);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 1));
        tmax[i] = fmaxf(tmax[i], __shfl_xor_sync(0xffffffffu, tmax[i], 2));
        const float mn = fmaxf(m[i], tmax[i]);
        // rows with no visible key yet keep m at the sentinel: exp(s - m)
        // would be 1 there, so p and alpha are forced to 0 until a real
        // score lands (the TPU kernel's `seen` guard)
        alpha[i] = mn > kNegInf * 0.5f ? __expf(m[i] - mn) : 0.f;
        m[i] = mn;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int i = q >> 1;
          const float p = m[i] > kNegInf * 0.5f ? __expf(sc[j][q] - m[i])
                                                : 0.f;
          sc[j][q] = p;
          l[i] += p;
        }
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) o[j][q] *= alpha[q >> 1];
      // o += p v: p's columns (2 tig, 2 tig + 1) of key step j are the
      // depth indices (tig, tig + 4), so V's rows are read in that order
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt_live) {
          const float av[4] = {sc[j][0], sc[j][2], sc[j][1], sc[j][3]};
          uint32_t ah[4], al[4];
          tf32_words_int<4, true>(av, ah, al);
#pragma unroll
          for (int c = 0; c < ND / OC; ++c) {
            auto& oc = *reinterpret_cast<float(*)[OC][4]>(&o[c * OC][0]);
            mma_kstep_il<OC, true, F32>(
                oc, ah, al, 8 * j,
                [&](int k, int n) {
                  const int key = (k & ~7) | ((k & 3) << 1) | ((k >> 2) & 1);
                  return to_f32(vs[key * LDK + c * 8 * OC + n]);
                },
                dk8 - c * OC);
          }
        }
      }
    }
    t = tn;
    s ^= 1;
  }

  // the row sums over the quad; then the second key half's (m, l, o)
  // go through shared memory to the first, which folds them in and
  // writes o = acc / l_safe and lse = m + log(l) (-1e30 when l == 0)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  __syncthreads();              // every warp is done with the stages
  float* om = reinterpret_cast<float*>(kv);   // kBQ x LDQ
  float* ml = qs;                             // kBQ x (m, l)
  if (kh == 1 && warp_live) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = i == 0 ? ra : rb;
#pragma unroll
      for (int j = 0; j < ND; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          om[r * LDQ + 8 * j + 2 * tig + e] = o[j][2 * i + e];
      if (tig == 0) {
        ml[2 * r] = m[i];
        ml[2 * r + 1] = l[i];
      }
    }
  }
  __syncthreads();
  if (kh == 1 || !warp_live) return;
  T* ob = static_cast<T*>(a.o) + b * a.st.o[0] + h * a.st.o[1];
  float* lb = a.lse + (long long)bh * a.Sq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = i == 0 ? ra : rb;
    if (r >= rows_here) continue;
    const float m1 = ml[2 * r], mx = fmaxf(m[i], m1);
    const float s0 = __expf(m[i] - mx), s1 = __expf(m1 - mx);
    const float lt = l[i] * s0 + ml[2 * r + 1] * s1;
    const float l_safe = lt == 0.f ? 1.f : lt;
    const float inv = 1.f / l_safe;
    T* orow = ob + (long long)(q0 + r) * a.st.o[2];
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * tig + e;
        if (d < a.D)
          store(orow + d, (o[j][2 * i + e] * s0 + om[r * LDQ + d] * s1) * inv);
      }
    if (tig == 0) lb[q0 + r] = lt == 0.f ? kNegInf : mx + logf(l_safe);
  }
}

// ---------------------------------------------------------------------------
// Head dims past 256 (flash_fwd_wide_kernel). Grid (B * H, 64-query
// tiles, chunks of kWideDC = 128 columns of the head dim); block z
// writes o's columns [z DC, z DC + DC). 8 warps: warp w takes the query
// m-tile w % 4 and, of a 64-key tile, the key half w / 4 for the scores
// and the column half w / 4 of the chunk for o. For each live key tile:
//  - s = q' k^T summed over the whole head dim, chunk after chunk: q'
//    (f32, scaled and rounded as it is staged) and k (f32) through
//    shared memory in chunk order, so every block of a query tile gets
//    the same scores and lse, bit for bit;
//  - the masked scores go to a tile in shared memory, where 4 threads a
//    row take the online-softmax step (m, l and o's rescale alpha, kept
//    per row) and leave p, while v's chunk z is staged;
//  - each warp rescales its o (16 rows x 64 columns, registers) by
//    alpha and adds p v.
// Products on mma.sync TF32 (common.cuh's mma_kstep: f32 operands in 3
// terms, p always; 16-bit q' and k exact in one). Staging is synchronous
// and the scores are recomputed by each of a query tile's ceil(D / 128)
// blocks: the price of any head dim, paid only past 256.
constexpr int kWideDC = 128;            // head-dim columns a chunk
constexpr int kWideKT = 64;             // keys a tile
constexpr int kWideLD = kWideDC + 4;    // f32 row stride of q', k, v
constexpr int kWideLS = kWideKT + 4;    // f32 row stride of the scores
constexpr int kSegPadK = -3;            // never equal to kSegPadQ

struct WideTiles {
  float* qs;          // [kBQ][LD]  q' chunk
  float* kvs;         // [KT][LD]   k chunk, then v chunk z
  float* ss;          // [kBQ][LS]  scores, then p
  float* alpha;       // [kBQ]      o's rescale of the step
  float* lrow;        // [kBQ]      the rows' l at the end
  int* segq;          // [kBQ]
  int* segk;          // [KT]
  __device__ explicit WideTiles(float* s)
      : qs(s), kvs(qs + kBQ * kWideLD), ss(kvs + kWideKT * kWideLD),
        alpha(ss + kBQ * kWideLS), lrow(alpha + kBQ),
        segq(reinterpret_cast<int*>(lrow + kBQ)), segk(segq + kBQ) {}
  static constexpr size_t bytes() {
    return sizeof(float) * ((size_t)(kBQ + kWideKT) * kWideLD +
                            (size_t)kBQ * kWideLS + 2 * kBQ) +
           sizeof(int) * (kBQ + kWideKT);
  }
};

// Rows [r0, r0 + ROWS) x columns [d0, d0 + kWideDC) of a (S, D) slice as
// f32 into dst (row stride kWideLD), scaled and rounded to T when
// `scaled` (q'); rows past `rows` and columns past dn are zeros. Up to
// 16 loads a thread in flight before any store.
template <typename T, int ROWS>
__device__ __forceinline__ void stage_wide(float* dst, const T* src,
                                           long long rs, int r0, int rows,
                                           int d0, int dn, bool scaled,
                                           float scale) {
  constexpr int kPer = ROWS * kWideDC / kThreads;
  constexpr int kGroup = kPer < 16 ? kPer : 16;
#pragma unroll
  for (int u0 = 0; u0 < kPer; u0 += kGroup) {
    float x[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int r = i / kWideDC, d = i - r * kWideDC;
      x[u] = r < rows && d < dn
                 ? to_f32(src[(long long)(r0 + r) * rs + d0 + d]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int i = threadIdx.x + (u0 + u) * kThreads;
      const int r = i / kWideDC, d = i - r * kWideDC;
      dst[r * kWideLD + d] = scaled ? round_to(x[u] * scale, T()) : x[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_wide_kernel(Args a) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int NT = kWideKT / 2 / 8;   // score n-tiles a warp: 32 keys
  constexpr int ON = kWideDC / 2 / 8;   // o n-tiles a warp: 64 columns
  extern __shared__ __align__(16) float wsmem[];
  const WideTiles sm(wsmem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int mi = warp % kRowGroups, half = warp / kRowGroups;
  const int bh = blockIdx.x;
  const int b = bh / a.H, h = bh - b * a.H;
  const int q0 = blockIdx.y * kBQ;
  const int rows_here = min(kBQ, a.Sq - q0);
  const int nc = (a.D + kWideDC - 1) / kWideDC;
  const int dz = blockIdx.z * kWideDC, dnz = min(kWideDC, a.D - dz);
  int kvl = a.kv_lens != nullptr ? a.kv_lens[b] : a.Skv;
  kvl = max(0, min(kvl, a.Skv));
  int col_end = kvl;
  if (a.causal) col_end = min(col_end, q0 + rows_here + a.q_offset);
  const int n_tiles = col_end > 0 ? (col_end + kWideKT - 1) / kWideKT : 0;
  const T* qb = static_cast<const T*>(a.q) + b * a.st.q[0] + h * a.st.q[1];
  const T* kb = static_cast<const T*>(a.k) + b * a.st.k[0] + h * a.st.k[1];
  const T* vb = static_cast<const T*>(a.v) + b * a.st.v[0] + h * a.st.v[1];
  const int32_t* segrow =
      a.seg != nullptr ? a.seg + (long long)b * a.Skv : nullptr;
  if (tid < kBQ)
    sm.segq[tid] =
        segrow != nullptr && tid < rows_here ? segrow[q0 + tid] : kSegPadQ;

  // the softmax step: 4 threads a row, 16 keys each; m and l of row
  // srow, the same in its 4 threads
  const int srow = tid >> 2, spart = tid & 3;
  float m = kNegInf, l = 0.f;
  float o[ON][4];
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) o[j][q] = 0.f;
  const bool warp_live = 16 * mi < rows_here;

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * kWideKT, cols = min(kWideKT, col_end - c0);
    const int nt_live = max(0, min(NT, (cols - 32 * half + 7) / 8));
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) s[j][q] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const int d0 = c * kWideDC, dn = min(kWideDC, a.D - d0);
      __syncthreads();            // the last readers of the tiles are done
      stage_wide<T, kBQ>(sm.qs, qb, a.st.q[2], q0, rows_here, d0, dn, true,
                         a.scale);
      stage_wide<T, kWideKT>(sm.kvs, kb, a.st.k[2], c0, cols, d0, dn, false,
                             0.f);
      if (c == 0 && segrow != nullptr)
        for (int i = tid; i < kWideKT; i += kThreads)
          sm.segk[i] = i < cols ? segrow[c0 + i] : kSegPadK;
      __syncthreads();
      if (warp_live) {
        const float* qr = sm.qs + 16 * mi * kWideLD;
        const float* kr = sm.kvs + 32 * half * kWideLD;
        for (int k0 = 0; k0 < kWideDC; k0 += 8)
          mxtt::mma_kstep<NT, F32, F32>(
              s, k0, [&](int r, int k) { return qr[r * kWideLD + k]; },
              [&](int k, int n) { return kr[n * kWideLD + k]; }, nt_live);
      }
    }
    // the masked scores into the tile
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = 16 * mi + gid + (q < 2 ? 0 : 8);
        const int cc = 32 * half + 8 * j + 2 * tig + (q & 1);
        bool ok = r < rows_here && cc < cols;
        if (a.causal) ok = ok && c0 + cc <= q0 + r + a.q_offset;
        if (segrow != nullptr) ok = ok && sm.segk[cc] == sm.segq[r];
        sm.ss[r * kWideLS + cc] = ok ? s[j][q] : kNegInf;
      }
    __syncthreads();              // the scores are in; k is read
    stage_wide<T, kWideKT>(sm.kvs, vb, a.st.v[2], c0, cols, dz, dnz, false,
                           0.f);
    {
      // rows with no visible key yet keep m at the sentinel: p and
      // alpha are forced to 0 there (the TPU kernel's `seen` guard)
      float* sr = sm.ss + srow * kWideLS + 16 * spart;
      float tmax = kNegInf;
#pragma unroll
      for (int e = 0; e < 16; ++e) tmax = fmaxf(tmax, sr[e]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mn = fmaxf(m, tmax);
      const bool seen = mn > kNegInf * 0.5f;
      const float al = seen ? __expf(m - mn) : 0.f;
      float ls = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const float p = seen ? __expf(sr[e] - mn) : 0.f;
        sr[e] = p;
        ls += p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      l = l * al + ls;
      m = mn;
      if (spart == 0) sm.alpha[srow] = al;
    }
    __syncthreads();              // p, alpha and v's chunk are in
    if (warp_live) {
      const float a0 = sm.alpha[16 * mi + gid];
      const float a1 = sm.alpha[16 * mi + gid + 8];
#pragma unroll
      for (int j = 0; j < ON; ++j) {
        o[j][0] *= a0;
        o[j][1] *= a0;
        o[j][2] *= a1;
        o[j][3] *= a1;
      }
      const float* pr = sm.ss + 16 * mi * kWideLS;
      const float* vc = sm.kvs + 64 * half;
      for (int k0 = 0; k0 < cols; k0 += 8)
        mxtt::mma_kstep<ON, true, F32>(
            o, k0, [&](int r, int k) { return pr[r * kWideLS + k]; },
            [&](int k, int n) { return vc[k * kWideLD + n]; }, ON);
    }
  }
  // o = acc / l_safe, and (chunk 0's block) lse = m + log(l), -1e30
  // where l == 0
  if (spart == 0) {
    sm.lrow[srow] = l;
    if (blockIdx.z == 0 && srow < rows_here)
      a.lse[(long long)bh * a.Sq + q0 + srow] =
          l == 0.f ? kNegInf : m + logf(l);
  }
  __syncthreads();
  if (!warp_live) return;
  T* ob = static_cast<T*>(a.o) + b * a.st.o[0] + h * a.st.o[1];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * mi + gid + 8 * i;
    if (r >= rows_here) continue;
    const float lr = sm.lrow[r];
    const float inv = 1.f / (lr == 0.f ? 1.f : lr);
    T* orow = ob + (long long)(q0 + r) * a.st.o[2] + dz;
#pragma unroll
    for (int j = 0; j < ON; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 64 * half + 8 * j + 2 * tig + e;
        if (d < dnz) store(orow + d, o[j][2 * i + e] * inv);
      }
  }
}

template <typename T>
cudaError_t launch_wide(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = WideTiles::bytes();
  auto kern = flash_fwd_wide_kernel<T>;
  cudaError_t e = mxtt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * a.H, (a.Sq + kBQ - 1) / kBQ,
            (a.D + kWideDC - 1) / kWideDC);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using S = Tiles<T, DP>;
  const int n_tiles = (a.Skv + S::KT - 1) / S::KT;
  const int mask_words = a.seg != nullptr ? (n_tiles + 31) / 32 : 0;
  const size_t smem = S::bytes(mask_words);
  auto kern = flash_fwd_kernel<T, DP>;
  cudaError_t e = mxtt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B * a.H, (a.Sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int B, cudaStream_t s) {
  if (a.D <= 16) return launch<T, 16>(a, B, s);
  if (a.D <= 32) return launch<T, 32>(a, B, s);
  if (a.D <= 64) return launch<T, 64>(a, B, s);
  if (a.D <= 128) return launch<T, 128>(a, B, s);
  if (a.D <= 256) return launch<T, 256>(a, B, s);
  return launch_wide<T>(a, B, s);
}

bool aligned16(const void* p, const long long* st, int esize) {
  if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  for (int i = 0; i < 3; ++i)
    if (st[i] * esize % 16 != 0) return false;
  return true;
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
  if (B < 1 || H < 1 || Sq < 1 || Skv < 0 || D < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.kv_lens = static_cast<const int32_t*>(kv_lens);
  a.seg = static_cast<const int32_t*>(seg);
  a.o = o;
  a.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    a.st.q[i] = strides[i];
    a.st.k[i] = strides[3 + i];
    a.st.v[i] = strides[6 + i];
    a.st.o[i] = strides[9 + i];
  }
  a.H = H;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.q_offset = q_offset;
  const int esize = dtype == 0 ? 4 : 2;
  a.vec = aligned16(k, a.st.k, esize) && aligned16(v, a.st.v, esize);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)dispatch<float>(a, B, s);
    case 1: return (int)dispatch<__nv_bfloat16>(a, B, s);
    default: return (int)dispatch<__half>(a, B, s);
  }
}
