// Paged flash attention, forward only, for Hopper (sm_90a).
//
// Replaces the TPU kernel mxnet_tpu/ops/pallas/flash_attention.py::
// _paged_fwd_kernel (launched by paged_flash_attention). Same function:
// q (B, H, Sq, D) attends over each row's KV history, which lives in a
// shared page pool k/v (P, H, page_size, D) and is read THROUGH the
// row's page table (B, NP). Row b's query i sits at position
// kv_len[b] - Sq + i, so the mask is
//     col <= kv_len - Sq + i   and   col < kv_len
// (causal within a prefill chunk, plain length mask for Sq = 1
// decode). Table slots at/after ceil(kv_len / page_size) are padding
// and are never read. A row with nothing to attend to (kv_len = 0, or
// a chunk row before the history starts) gives exactly 0. Inputs f32
// or bf16, any head dim (past 256 in chunks of 256: see WIDE below);
// all math in f32. q is scaled by
// sm_scale and rounded back to q's type as it is loaded, where the TPU
// wrapper pre-scales it.
//
// Bound. Memory: each (row, head) reads its live K and V history once,
// 2 * B * H * kv_len * D * sizeof(T) bytes per call; the arithmetic is
// 4 * Sq * kv_len * D flops per (row, head), far below the card's f32
// rate for Sq <= 64. So the time is the bytes over HBM bandwidth, and
// what keeps a kernel from it is bytes not in flight: blocks too few to
// fill 132 SMs, or loads issued one after another.
//
// Design: split-KV (flash-decoding). On the TPU the page axis is a
// sequential grid dimension with m, l and acc in VMEM between steps.
// Here a (row, head, query tile)'s history is cut into chunks and one
// block takes one chunk; the chunks' partial (m, l, acc) are folded by
// the usual rescaling. Grid (B * H, n_split, query tiles), all from
// shapes the host knows (no read of kv_lens on the host):
//  - A chunk is a whole number of kSub = 64-key steps (whole pages for
//    page sizes that divide 64): 64 keys while the row's kv_len needs
//    at most kMaxSplit chunks, else the least multiple of 64 that keeps
//    it to kMaxSplit. Its boundaries depend on the row's own kv_len
//    and these constants only, never on B, the table's width or the
//    SM count, so a row gives the same bits alone and in any batch.
//  - n_split = min(kMaxSplit, ceil(NP * page_size / 64)); blocks past a
//    row's last live chunk exit at once.
//  - A tile with one live chunk writes its output directly. Otherwise
//    each block writes its partial to a scratch buffer (allocated by
//    the wrapper) and takes a ticket from a per-tile counter
//    (__threadfence, then atomicAdd); the block that draws the last
//    ticket resets the counter to 0 for the next call and combines the
//    partials in chunk order: one launch a call, the same bits every
//    run. Calls that may overlap must not share counters: the wrapper
//    keeps one counter buffer a (device, stream).
//  - Inside a chunk every warp works: 4 warps, and a key group of LPK
//    lanes per key, LPK = the lanes one key's row fills at 16 bytes a
//    lane (16 lanes at D = 64 in f32, 8 in bf16; 32 lanes of two
//    vectors at D = 256 in f32). Groups take interleaved keys, so a
//    warp's loads at one step are neighbouring rows of a page. A lane
//    holds its slice of q (in registers for the whole block) and of
//    each key's K and V row, loaded as 16-byte vectors; dot products
//    are summed over the group with shuffles. A group loads U keys'
//    K and V before it uses any (the chunk's whole share at D <= 128:
//    one memory round trip a chunk), keeps its own (m, l, acc) for
//    every query of the tile, and the groups merge at the chunk's end,
//    in the warp by shuffles, across warps in shared memory, all in a
//    fixed order.
//  - Query tiles: 1 row at Sq = 1 (decode), 4 rows otherwise (chunked
//    prefill), so q and acc stay in registers. Head dims pad to a
//    template width DP (16, 32, 64, 128, 256), the lanes past D read
//    zeros; rows whose width or base is not 16-byte aligned are read
//    element by element.
//
// What it still leaves: the chunked-prefill tile (4 queries) re-reads a
// chunk's K and V for every 4 queries (from L2) and scores on CUDA
// cores, not mma/wgmma; no TMA or cp.async pipeline past the first
// round trip for chunks longer than one load batch (D = 256, or
// histories past kMaxSplit * 64 keys); the page-table read sits between
// kv_len and the K/V loads (three dependent round trips a block);
// 16-bit K/V are widened to f32 in registers.

#include "common.cuh"

namespace {

using mxtt::round_to;
using mxtt::store;
using mxtt::to_f32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSub = 64;          // keys a block steps over at once
constexpr int kMaxSplit = 32;     // chunks of a (row, head, tile) at most
constexpr float kNegInf = -1e30f; // as the TPU kernel

// The layout of a block for element type T, padded head dim DP and a
// query tile of QT rows (see the header).
template <typename T, int DP, int QT>
struct Cfg {
  static constexpr int VEC = 16 / sizeof(T);      // elements a vector
  static constexpr int NV = DP / VEC;             // vectors a padded row
  static constexpr int LPK = NV < 32 ? NV : 32;   // lanes a key
  static constexpr int VPL = NV / LPK;            // vectors a lane
  static constexpr int DPL = VPL * VEC;           // dims a lane
  static constexpr int KG = 32 / LPK;             // key groups a warp
  static constexpr int G = kWarps * KG;           // key groups a block
  static constexpr int KPG = kSub / G;            // keys a group a step
  // keys loaded before use: K and V take 64 (decode) or 32 registers
  static constexpr int U0 = (QT == 1 ? 32 : 16) / DPL;
  static constexpr int U = U0 < 1 ? 1 : (U0 > KPG ? KPG : U0);
  static_assert(NV >= 1 && NV % LPK == 0 && kSub % G == 0 &&
                    KPG % U == 0,
                "paged attention block layout");
};

struct Params {
  const void* q;                // (B, H, Sq, D)
  const void* k;                // (P, H, page_size, D)
  const void* v;
  const int32_t* table;         // (B, n_table)
  const int32_t* kv_lens;       // (B,)
  void* out;                    // (B, H, Sq, D)
  float* part;                  // (B*H*Sq, n_split) x (m, l), then acc
  int* tickets;                 // (B*H*tiles,) zeros
  int H, Sq, D, page_size, n_table, vec;
  float scale;                  // sm_scale
};

// VEC elements of row[d0..] as f32 (zeros past D): one 16-byte load
// when `vec` (rows 16-byte aligned, D a whole number of vectors), else
// element by element.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* row, int d0, int D,
                                         bool vec, float* out) {
  if (vec && d0 + VEC <= D) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(row + d0));
    if constexpr (sizeof(T) == 4) {
      out[0] = __uint_as_float(w.x);
      out[1] = __uint_as_float(w.y);
      out[2] = __uint_as_float(w.z);
      out[3] = __uint_as_float(w.w);
    } else {
      const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&u[i]));
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      out[e] = d0 + e < D ? to_f32(row[d0 + e]) : 0.f;
  }
}

// Fold (mo, lo, ao) into (m, l, a): the flash rescaling.
template <int N>
__device__ __forceinline__ void fold(float& m, float& l, float (&a)[N],
                                     float mo, float lo,
                                     const float (&ao)[N]) {
  const float mx = fmaxf(m, mo);
  const float s = __expf(m - mx), so = __expf(mo - mx);
  l = l * s + lo * so;
#pragma unroll
  for (int e = 0; e < N; ++e) a[e] = a[e] * s + ao[e] * so;
  m = mx;
}

// WIDE (head dims past 256): DP = 256 and blockIdx.z = tile * nz + z,
// nz = ceil(D / 256): the block writes the output's dims [z DP, z DP +
// DP) of its tile. The scores still run over the whole head dim: for
// each batch of U keys, the lanes' partial dots are summed over the
// chunks of 256 dims (q's and K's slices of each chunk loaded in turn,
// q from L1), then over the key group; V is loaded for chunk z only.
// Every block of a tile takes the same scores, bit for bit; each keeps
// its own (m, l) partials and tickets.
template <typename T, int DP, int QT, bool WIDE>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Params p) {
  using C = Cfg<T, DP, QT>;
  __shared__ float wm[kWarps][QT], wl[kWarps][QT];
  __shared__ float wacc[kWarps][QT][DP];
  __shared__ int last_block;

  const int nz = WIDE ? (p.D + DP - 1) / DP : 1;
  const int bh = blockIdx.x, j = blockIdx.y;
  const int tile = WIDE ? blockIdx.z / nz : blockIdx.z;
  const int z = WIDE ? blockIdx.z - tile * nz : 0;
  // the output dims of this block: [d_base, d_base + dn)
  const int d_base = z * DP, dn = WIDE ? min(DP, p.D - d_base) : p.D;
  const int n_split = gridDim.y;
  const int b = bh / p.H, h = bh - b * p.H;
  const int r0 = tile * QT;
  const int rows = min(QT, p.Sq - r0);
  const int kvl = max(0, p.kv_lens[b]);
  // keys the tile's last row sees (never past the table)
  const int n_live =
      max(0, min(kvl - p.Sq + r0 + rows, p.n_table * p.page_size));
  // the row's chunk length, from its kv_len and the constants only
  const int steps = (kvl + kSub - 1) / kSub;
  const int chunk = kSub * max(1, (steps + kMaxSplit - 1) / kMaxSplit);
  const int nc = (n_live + chunk - 1) / chunk;   // live chunks (<= n_split)
  if (j >= max(nc, 1)) return;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gw = lane / C::LPK, li = lane % C::LPK;
  const int g = warp * C::KG + gw;
  const bool vec = p.vec != 0;
  const T* qb = static_cast<const T*>(p.q) + ((size_t)bh * p.Sq + r0) * p.D;

  // this lane's slice of q' (dims c DP..c DP + DP of the head dim),
  // scaled and rounded to T: vector vi covers dims (vi * LPK + li) * VEC..
  float qv[QT][C::DPL];
  auto load_q = [&](int c) {
#pragma unroll
    for (int r = 0; r < QT; ++r)
#pragma unroll
      for (int vi = 0; vi < C::VPL; ++vi) {
        float* dst = &qv[r][vi * C::VEC];
        if (r < rows) {
          load_vec<T, C::VEC>(qb + (size_t)r * p.D + c * DP,
                              (vi * C::LPK + li) * C::VEC, p.D - c * DP, vec,
                              dst);
#pragma unroll
          for (int e = 0; e < C::VEC; ++e)
            dst[e] = round_to(dst[e] * p.scale, T());
        } else {
#pragma unroll
          for (int e = 0; e < C::VEC; ++e) dst[e] = 0.f;
        }
      }
  };
  if constexpr (!WIDE) load_q(0);

  float m[QT], l[QT], acc[QT][C::DPL];
#pragma unroll
  for (int r = 0; r < QT; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < C::DPL; ++e) acc[r][e] = 0.f;
  }

  const int c_begin = j * chunk, c_end = min(c_begin + chunk, n_live);
  const int32_t* trow = p.table + (size_t)b * p.n_table;
  const T* kp = static_cast<const T*>(p.k);
  const T* vp = static_cast<const T*>(p.v);
  // position of the tile's row 0: row r sees columns <= pos0 + r
  const int pos0 = kvl - p.Sq + r0;
  for (int s0 = c_begin; s0 < c_end; s0 += kSub) {
#pragma unroll 1
    for (int i0 = 0; i0 < C::KPG; i0 += C::U) {
      int col[C::U];
      float vx[C::U][C::DPL];
      float sc[QT][C::U];
      if constexpr (!WIDE) {
        // U keys' K and V rows (zeros for keys past the chunk), all
        // loads issued before any is used
        float kx[C::U][C::DPL];
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          col[u] = s0 + g + C::G * (i0 + u);
          if (col[u] < c_end) {
            const int slot = col[u] / p.page_size;
            const size_t row =
                ((size_t)trow[slot] * p.H + h) * p.page_size +
                (col[u] - slot * p.page_size);
            const T* kr = kp + row * p.D;
            const T* vr = vp + row * p.D;
#pragma unroll
            for (int vi = 0; vi < C::VPL; ++vi) {
              const int d0 = (vi * C::LPK + li) * C::VEC;
              load_vec<T, C::VEC>(kr, d0, p.D, vec, &kx[u][vi * C::VEC]);
              load_vec<T, C::VEC>(vr, d0, p.D, vec, &vx[u][vi * C::VEC]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < C::DPL; ++e) kx[u][e] = vx[u][e] = 0.f;
          }
        }
        // scores: each lane's partial dot, summed over the key group
#pragma unroll
        for (int r = 0; r < QT; ++r)
#pragma unroll
          for (int u = 0; u < C::U; ++u) {
            float d = 0.f;
#pragma unroll
            for (int e = 0; e < C::DPL; ++e) d = fmaf(qv[r][e], kx[u][e], d);
#pragma unroll
            for (int o = C::LPK / 2; o > 0; o >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, o);
            sc[r][u] = d;
          }
      } else {
        // the U keys' rows, then the dots over the head dim chunk by
        // chunk, then V's chunk z
        const T* kr[C::U];
        const T* vr[C::U];
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          col[u] = s0 + g + C::G * (i0 + u);
          kr[u] = vr[u] = nullptr;
          if (col[u] < c_end) {
            const int slot = col[u] / p.page_size;
            const size_t row =
                ((size_t)trow[slot] * p.H + h) * p.page_size +
                (col[u] - slot * p.page_size);
            kr[u] = kp + row * p.D;
            vr[u] = vp + row * p.D;
          }
        }
#pragma unroll
        for (int r = 0; r < QT; ++r)
#pragma unroll
          for (int u = 0; u < C::U; ++u) sc[r][u] = 0.f;
        for (int c = 0; c < nz; ++c) {
          float kx[C::U][C::DPL];
#pragma unroll
          for (int u = 0; u < C::U; ++u) {
#pragma unroll
            for (int vi = 0; vi < C::VPL; ++vi) {
              const int d0 = (vi * C::LPK + li) * C::VEC;
              if (kr[u] != nullptr) {
                load_vec<T, C::VEC>(kr[u] + c * DP, d0, p.D - c * DP, vec,
                                    &kx[u][vi * C::VEC]);
              } else {
#pragma unroll
                for (int e = 0; e < C::VEC; ++e) kx[u][vi * C::VEC + e] = 0.f;
              }
            }
          }
          load_q(c);
#pragma unroll
          for (int r = 0; r < QT; ++r)
#pragma unroll
            for (int u = 0; u < C::U; ++u) {
              float d = sc[r][u];
#pragma unroll
              for (int e = 0; e < C::DPL; ++e)
                d = fmaf(qv[r][e], kx[u][e], d);
              sc[r][u] = d;
            }
        }
#pragma unroll
        for (int r = 0; r < QT; ++r)
#pragma unroll
          for (int u = 0; u < C::U; ++u) {
            float d = sc[r][u];
#pragma unroll
            for (int o = C::LPK / 2; o > 0; o >>= 1)
              d += __shfl_xor_sync(0xffffffffu, d, o);
            sc[r][u] = d;
          }
#pragma unroll
        for (int u = 0; u < C::U; ++u)
#pragma unroll
          for (int vi = 0; vi < C::VPL; ++vi) {
            const int d0 = (vi * C::LPK + li) * C::VEC;
            if (vr[u] != nullptr) {
              load_vec<T, C::VEC>(vr[u] + d_base, d0, dn, vec,
                                  &vx[u][vi * C::VEC]);
            } else {
#pragma unroll
              for (int e = 0; e < C::VEC; ++e) vx[u][vi * C::VEC + e] = 0.f;
            }
          }
      }
      // online softmax over the U keys, row by row
#pragma unroll
      for (int r = 0; r < QT; ++r) {
        if (r >= rows) continue;
        const int lim = min(c_end, pos0 + r + 1);   // visible: col < lim
        float mx = m[r];
#pragma unroll
        for (int u = 0; u < C::U; ++u)
          if (col[u] < lim) mx = fmaxf(mx, sc[r][u]);
        // 1 while nothing was seen; 0 when m was the sentinel
        const float alpha = __expf(m[r] - mx);
        l[r] *= alpha;
#pragma unroll
        for (int e = 0; e < C::DPL; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int u = 0; u < C::U; ++u) {
          if (col[u] < lim) {
            const float pr = __expf(sc[r][u] - mx);
            l[r] += pr;
#pragma unroll
            for (int e = 0; e < C::DPL; ++e)
              acc[r][e] = fmaf(pr, vx[u][e], acc[r][e]);
          }
        }
        m[r] = mx;
      }
    }
  }

  // merge the warp's key groups (lanes li of each group hold one slice)
#pragma unroll
  for (int o = C::LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      float ao[C::DPL];
#pragma unroll
      for (int e = 0; e < C::DPL; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      fold(m[r], l[r], acc[r], mo, lo, ao);
    }
  }
  if (gw == 0) {
#pragma unroll
    for (int r = 0; r < QT; ++r) {
      if (li == 0) {
        wm[warp][r] = m[r];
        wl[warp][r] = l[r];
      }
#pragma unroll
      for (int vi = 0; vi < C::VPL; ++vi)
#pragma unroll
        for (int e = 0; e < C::VEC; ++e)
          wacc[warp][r][(vi * C::LPK + li) * C::VEC + e] =
              acc[r][vi * C::VEC + e];
    }
  }
  __syncthreads();

  // merge the warps, warp 0 first; one element (row, dim) a thread.
  // The partials: (m, l) at [row][chunk][z], then the D sums of each
  // (row, chunk)
  T* ob = static_cast<T*>(p.out) + ((size_t)bh * p.Sq + r0) * p.D + d_base;
  const size_t prow0 = (size_t)bh * p.Sq + r0;    // partial row of r = 0
  float* pml = p.part;
  float* pacc = p.part + (size_t)gridDim.x * p.Sq * n_split * 2 * nz;
  for (int i = tid; i < rows * dn; i += kThreads) {
    const int r = i / dn, d = i - r * dn;
    float mm = wm[0][r], ll = wl[0][r];
    float a[1] = {wacc[0][r][d]};
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const float ao[1] = {wacc[w][r][d]};
      fold(mm, ll, a, wm[w][r], wl[w][r], ao);
    }
    if (nc <= 1) {
      store(ob + (size_t)r * p.D + d, a[0] / (ll == 0.f ? 1.f : ll));
    } else {
      const size_t pi = (prow0 + r) * n_split + j;
      pacc[pi * p.D + d_base + d] = a[0];
      if (d == 0) {
        pml[2 * (pi * nz + z)] = mm;
        pml[2 * (pi * nz + z) + 1] = ll;
      }
    }
  }
  if (nc <= 1) return;

  // the last of the tile's nc blocks to finish combines the partials
  __threadfence();
  __syncthreads();
  int* ticket = p.tickets + (size_t)bh * gridDim.z + blockIdx.z;
  if (tid == 0) {
    const int t = atomicAdd(ticket, 1);
    last_block = t == nc - 1;
    if (last_block) *ticket = 0;    // ready for the next call
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  for (int i = tid; i < rows * dn; i += kThreads) {
    const int r = i / dn, d = i - r * dn;
    const size_t pi0 = (prow0 + r) * n_split;
    float mm = kNegInf;
    for (int c = 0; c < nc; ++c)
      mm = fmaxf(mm, __ldcg(pml + 2 * ((pi0 + c) * nz + z)));
    float ll = 0.f, a = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* ml = pml + 2 * ((pi0 + c) * nz + z);
      const float w = __expf(__ldcg(ml) - mm);
      ll = fmaf(__ldcg(ml + 1), w, ll);
      a = fmaf(__ldcg(pacc + (pi0 + c) * p.D + d_base + d), w, a);
    }
    store(ob + (size_t)r * p.D + d, a / (ll == 0.f ? 1.f : ll));
  }
}

template <typename T, int DP, int QT, bool WIDE = false>
cudaError_t launch(const Params& p, int B, int n_split, cudaStream_t s) {
  const int nz = WIDE ? (p.D + DP - 1) / DP : 1;
  dim3 grid(B * p.H, n_split, (p.Sq + QT - 1) / QT * nz);
  paged_attention_kernel<T, DP, QT, WIDE><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
}

template <typename T, int DP, bool WIDE = false>
cudaError_t launch_qt(const Params& p, int B, int n_split, cudaStream_t s) {
  return p.Sq == 1 ? launch<T, DP, 1, WIDE>(p, B, n_split, s)
                   : launch<T, DP, 4, WIDE>(p, B, n_split, s);
}

template <typename T>
cudaError_t dispatch(const Params& p, int B, int n_split, cudaStream_t s) {
  if (p.D <= 16) return launch_qt<T, 16>(p, B, n_split, s);
  if (p.D <= 32) return launch_qt<T, 32>(p, B, n_split, s);
  if (p.D <= 64) return launch_qt<T, 64>(p, B, n_split, s);
  if (p.D <= 128) return launch_qt<T, 128>(p, B, n_split, s);
  if (p.D <= 256) return launch_qt<T, 256>(p, B, n_split, s);
  return launch_qt<T, 256, true>(p, B, n_split, s);
}

// Blocks of the grid along a row's keys: one a 64-key chunk (more keys
// a chunk past kMaxSplit chunks), as many as the table's width can
// hold, at least one. Only the grid and the scratch depend on it.
int split_for(int n_table, int page_size) {
  const long long steps = ((long long)n_table * page_size + kSub - 1) / kSub;
  return steps < 1 ? 1 : steps > kMaxSplit ? kMaxSplit : (int)steps;
}

}  // namespace

// The n_split of a call with this table width and page size (loaded
// with ctypes, so the wrapper sizes the scratch from the kernel's own
// policy); 0 for a negative width or page size.
extern "C" int mxtt_paged_attention_split(int n_table, int page_size) {
  return n_table < 0 || page_size < 1 ? 0 : split_for(n_table, page_size);
}

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16; scale = sm_scale. `part` holds B*H*Sq*n_split*(D +
// 2 nz) floats of scratch, n_split = mxtt_paged_attention_split(n_table,
// page_size), nz = ceil(D / 256) past D = 256 and 1 up to it; `tickets`
// B*H*Sq*nz int32 zeros, which the kernel leaves at zero, owned by the
// calls of one stream. vec: q, k and v are 16-byte
// aligned and D a whole number of 16-byte vectors. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int mxtt_paged_attention_fwd(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, void* out, void* part, void* tickets, int B, int H,
    int Sq, int D, int page_size, int n_table, int vec, float scale,
    int dtype, void* stream) {
  if (B < 1 || H < 1 || Sq < 1 || D < 1 || page_size < 1 || n_table < 0)
    return (int)cudaErrorInvalidValue;
  const int n_split = split_for(n_table, page_size);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.table = static_cast<const int32_t*>(table);
  p.kv_lens = static_cast<const int32_t*>(kv_lens);
  p.out = out;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.H = H;
  p.Sq = Sq;
  p.D = D;
  p.page_size = page_size;
  p.n_table = n_table;
  p.vec = vec;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, B, n_split, s);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, B, n_split, s);
  return (int)cudaErrorInvalidValue;
}
