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
// Design. Both directions run ONE persistent cooperative grid with ONE
// grid sync a step, the recurrent product on the tensor cores, and no
// atomics (the same bits every run). The TPU kernel keeps all of W (6.8
// MB at H = 650 in f32) in VMEM for the T sequential grid steps; an SM
// has at most 227 KB of shared memory, so here the hidden units are
// split: block b owns u <= 16 units and a group of the batch's m16 row
// tiles (unit group b % UG, row group b / UG, UG = ceil(H / u), RG =
// min(m-tiles, SMs / UG)), and W's part for its units stays in shared
// memory for all T steps. W is read (and dW written) by strides, so
// MXNet's (4H, H) h2h weight is taken as it is. The products: the
// block's W part is the mma's B operand, held in shared memory as rows
// of the depth (W's type; ldw elements a row, 64 mod 128 bytes so the 8
// lanes of a 16-byte access phase hit distinct banks); A fragments come
// straight from L2 (ld.global.cg, 16 bytes a lane, in batches, the next
// batch in flight under this one's products), not staged: each lane's
// 16 bytes are two mma k-steps' worth of its fragment slots (the k order
// inside a chunk of 64 bytes is permuted, the same way for A and B).
// f32: m16n8k8 TF32 with the 3-term split (common.cuh), A split once
// for all n-tiles; bf16/f16: m16n8k16, the loaded words used as they
// are; f32 accumulation, each chunk into a fresh partial added
// round-to-nearest (the tensor cores' own adds round toward zero). A
// block with fewer than 8 m-tiles splits the depth across its 8 warps;
// the partials meet in shared memory, summed in a fixed order. The grid
// (u, RG, ldw, shared bytes) is planned in Python (ops/lstm.py::
// plan_grid); this file checks occupancy. Where W's part does not fit
// shared memory at a grid of one block an SM (f32 past H = 1056, e.g.
// the word LM's --nhid 1500: 94 groups of 16 units, 385 KB of W rows a
// block forward), each block stages the same rows into its own slice of
// a scratch in device memory (`wg`) instead, and the products read B
// from there through L1/L2, at the cost of those bytes every step;
// shared memory then holds only the partial sums. Any H: past one unit
// group an SM (H > 2112 on an H100: 157 groups of 16 units at H = 2500)
// the grid keeps one block an SM and block b walks the work blocks (unit
// group x row group) b, b + blocks, ... every step, each with its own
// slice of `wg`, still one grid sync a step; a step then costs the
// walk's length in products.
//
// Forward design (lstm_fwd_kernel). The block's W part is the four gate
// columns of each of its units (16 units: 64 columns, eight n8 tiles;
// 164 KB at H = 650 in f32), each column a row of depth H in shared
// memory, ordered so that one warp's item holds all four gates of its
// units: n-tile 4 hf + q is gate q of units [8 hf, 8 hf + 8). A warp
// item is one m16 tile of rows x one half of the units (and one share of
// the depth when the depth is split); a block has 16 warps, twice the
// backward's, since its products' latency (the load, the split, the
// three mma) is hidden only by other warps. The step: z[own rows, own
// 64 columns] = h_{t-1}[own rows] (H deep) . W part; then each lane
// holds i, f, g, o of its (row,
// unit) pairs in registers (or, with a split depth, the threads of the
// block sum the partials from shared memory), adds gin[t], and updates
// the c carry (f32, in a scratch the same thread reads back next step),
// writing out[t], cseq[t] and the gates. h_{t-1} is read from a scratch
// of two buffers of N x hp in gin's type (hp: H rounded up to whole
// 64-byte chunks, zero past H, so every row is whole aligned chunks):
// step t reads buffer (t + 1) % 2 and writes buffer t % 2, which no
// block reads again before the next grid sync. Reading h back in gin's
// type is exactly the TPU kernel's rounding of h to W's type. h0 goes
// into buffer 1 before one grid sync ahead of step 0. Every step, h
// crosses L2 once per unit group (41 at H = 650), and the gate
// nonlinearities and the c carry stay in the block.
//
// Backward design. Two kernels, both deterministic.
//  1. The recurrence (lstm_bwd_kernel). The block's W part is W's row
//     (4H deep) for each of its units: two n-tiles of 8 units, one where
//     W's rows for two do not fit. Phase A: the block computes dgin for
//     its rows and units from local values (the carries, the saved
//     gates, c_t, c_{t-1}) and writes dgin[t]; the grid syncs. Phase B:
//     dh_{t-1}[own rows, own units] = dgin[t][own rows] (4H deep) .
//     W[own units, :]^T. Every step, dgin[t] crosses L2 once per unit
//     group, not once per block: at the word LM's N = 32 that is 13.6
//     MB a step instead of 43 MB.
//  2. dW (lstm_bwd_dw_kernel), after the loop: no step depends on it, so
//     it leaves the serial path. dW = hp^T . dgin with hp = [h0; out[0..
//     T-2]] (T*N x H) and dgin (T*N x 4H): one tiled product, 64 x 128
//     output tiles over (H, 4H) so that every SM works, register-staged
//     double buffering, TF32 mma (3-term split for f32, split once as a
//     value is staged; bf16/f16 values are exact in TF32, one term), f32
//     accumulation.

// Bound. Operations: 2*T*N*H*4H flops forward, twice that backward,
// all on the tensor cores, at 495 TFLOP/s TF32 over 3 terms for f32.
// Bytes: gin, out, cseq, gates and W once each. What the recurrence
// pays on top: a grid sync and a short chain of L2 round trips every
// step (about 10 us a step on an H100 whatever N), and h (forward) or
// dgin[t] (backward) re-read from L2 by every unit group.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using mxtt::mma_16;
using mxtt::mma_tf32_0;
using mxtt::mma_tf32x3;
using mxtt::split_tf32;
using mxtt::store;
using mxtt::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;   // the backward's warps a block
constexpr int kFwdWarps = 16;           // the forward's warps a block
constexpr int kTile = 8;          // units (backward) of one mma n-tile

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

// chunks of the depth in one batch of loads (2 x B 16-byte loads a
// lane); a warp keeps two batches, one loading while the other multiplies
constexpr int kBatch = 4;

// A warp's share of a product: acc = rows [16 m, 16 m + 16) of `src`
// (row stride ld, G deep, rows past N zero) over the chunks [c0, c1),
// times the NT n-tiles of W rows at wrow (this lane's row of n-tile 0;
// n-tile j lies 8 rows further). acc[j]: rows 16 m + gid (0, 1) and
// + 8 (2, 3), columns 8 j + 2 tig (+ 1).
template <typename T, int NT, int B>
__device__ __forceinline__ void tile_product(float (&acc)[NT][4],
                                             const T* src, size_t ld, int m,
                                             int N, int c0, int c1,
                                             const T* wrow, int ldw, int G,
                                             bool vec) {
  constexpr int KG = 16 / (int)sizeof(T);   // k of one lane's 16 bytes
  constexpr int KC = 4 * KG;                // k of one warp chunk
  const int lane = threadIdx.x & 31, gid = lane >> 2, tig = lane & 3;
  const int r0 = m * 16 + gid, r1 = r0 + 8;
  const T* p0 = src + (size_t)min(r0, N - 1) * ld;
  const T* p1 = src + (size_t)min(r1, N - 1) * ld;
  const bool ok0 = r0 < N, ok1 = r1 < N;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  uint4 x0[B], x1[B], y0[B], y1[B];
  load_batch<T, KG, KC>(x0, x1, p0, p1, c0, c1, tig, ok0, ok1, G, vec);
  for (int c = c0; c < c1; c += 2 * B) {
    load_batch<T, KG, KC>(y0, y1, p0, p1, c + B, c1, tig, ok0, ok1, G, vec);
    mma_batch<T, KC>(acc, x0, x1, wrow, ldw, c, c1);
    load_batch<T, KG, KC>(x0, x1, p0, p1, c + 2 * B, c1, tig, ok0, ok1, G,
                          vec);
    mma_batch<T, KC>(acc, y0, y1, wrow, ldw, c + B, c1);
  }
}

// Depth-split work of a block with fewer tiles than warps: KS shares of
// the depth a tile, so that every warp has one item.
__device__ __forceinline__ int depth_split(int tiles, int warps) {
  return tiles >= warps ? 1 : warps / max(tiles, 1);
}

// What the cell of (row n, unit) at step t reads besides its products:
// gin[t]'s four gates and the c carry (cbuf; c0 at t = 0).
struct CellIn {
  float z[4];
  float c;
};

template <typename T>
__device__ __forceinline__ CellIn cell_in(const T* gin, const T* c0,
                                          const float* cbuf, int t, int N,
                                          int H, int n, int unit) {
  const size_t zb = ((size_t)t * N + n) * 4 * H + unit;
  const size_t sb = (size_t)n * H + unit;
  CellIn in;
#pragma unroll
  for (int g = 0; g < 4; ++g) in.z[g] = to_f32(gin[zb + g * H]);
  in.c = t == 0 ? to_f32(c0[sb]) : cbuf[sb];
  return in;
}

// The cell of one (row n, unit) at step t from its recurrent products z:
// the gates from gin[t] + z, the f32 c carry, and the writes of out[t],
// cseq[t], the gates, the carry and h's scratch row.
template <typename T>
__device__ __forceinline__ void lstm_cell(const CellIn& in, const float* z,
                                          T* out, T* cseq, T* gates,
                                          float* cbuf, T* hdst, int t,
                                          int N, int H, int hp, int n,
                                          int unit) {
  const size_t zb = ((size_t)t * N + n) * 4 * H + unit;
  const size_t hb = ((size_t)t * N + n) * H + unit;
  const float i = sigmoid_f(in.z[0] + z[0]);
  const float f = sigmoid_f(in.z[1] + z[1]);
  const float g = tanhf(in.z[2] + z[2]);
  const float o = sigmoid_f(in.z[3] + z[3]);
  const float cn = f * in.c + i * g;
  const float hn = o * tanhf(cn);
  cbuf[(size_t)n * H + unit] = cn;
  store(out + hb, hn);
  store(cseq + hb, cn);
  store(gates + zb, i);
  store(gates + zb + H, f);
  store(gates + zb + 2 * H, g);
  store(gates + zb + 3 * H, o);
  store(hdst + (size_t)n * hp + unit, hn);
}

// The work of block wb of a grid of UG unit groups x RG row groups:
// unit group wb % UG (units [unit0, unit0 + nu)) and row group wb / UG
// (m-tiles [mt0, mt1), rows [row0, row0 + rows)), and its split of the
// product: `per_tile` work items a m-tile (the forward's unit halves)
// times KS shares of the depth, `items` in all, over `warps` warps. The
// kernels compute their own block's once, before the steps: its
// divisions would otherwise sit on every step's serial path.
struct Share {
  int unit0, nu, mt0, mt1, row0, rows, KS, items;
  bool last_units;              // the last unit group
  __device__ Share(int wb, int UG, int U, int RG, int N, int H, int per_tile,
                   int warps) {
    const int ug = wb % UG, rg = wb / UG;
    const int mt = (N + 15) / 16;
    unit0 = ug * U;
    nu = min(U, H - unit0);
    mt0 = mt * rg / RG;
    mt1 = mt * (rg + 1) / RG;
    row0 = 16 * mt0;
    rows = min(N, 16 * mt1) - row0;
    KS = depth_split((mt1 - mt0) * per_tile, warps);
    items = (mt1 - mt0) * per_tile * KS;
    last_units = ug == UG - 1;
  }
};

// The forward for blocks of U <= 8 NH units (the header's layout), NH
// halves of 8 units, kFwdWarps warps: a work item is one m16 tile x one
// half (four n-tiles: its units' four gates) x one share of the depth.
// Shared memory: w_s [32 NH][ldw] of T, row 32 hf + 8 g + r = column
// (gate g, unit 8 hf + r) of W's part, W[0..H) then zeros (in wg's
// slice of the work block instead when WG); then red_s [16 work
// items][16][32] f32 partial sums when the depth is split. WG is a
// template argument so that the resident variant's W reads stay
// shared-memory loads. With WALK (W in device memory, a grid smaller
// than UG x RG) block b does work blocks b, b + gridDim.x, ... every
// step; without, block b is work block b, and the step is straight-line
// code as before the walk existed.
template <typename T, int NH, bool WG, bool WALK>
__global__ void __launch_bounds__(32 * kFwdWarps, 1)
lstm_fwd_kernel(const T* __restrict__ gin, const T* __restrict__ w,
                long long sk, long long sg, const T* __restrict__ h0,
                const T* __restrict__ c0, T* __restrict__ out,
                T* __restrict__ cseq, T* __restrict__ gates,
                float* __restrict__ cbuf, T* hbuf, T* wg, int steps, int N,
                int H, int U, int RG, int ldw, int hp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KG = 16 / (int)sizeof(T);
  constexpr int KC = 4 * KG;
  constexpr int WR = 32 * NH;               // W columns of the block
  // W's part in shared memory, or in work block wb's slice of wg
  auto w_part = [&](int wb) {
    return WG ? wg + (size_t)wb * WR * ldw : reinterpret_cast<T*>(smem_raw);
  };
  float* red_s = reinterpret_cast<float*>(
      smem_raw + (WG ? 0 : (size_t)WR * ldw * sizeof(T)));
  const int UG = (H + U - 1) / U;
  const int work = UG * RG;
  const int chunks = hp / KC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const size_t buf = (size_t)N * hp;        // elements of one h buffer
  const Share own(blockIdx.x, UG, U, RG, N, H, NH, kFwdWarps);
  auto share = [&](int wb) {
    return wb == (int)blockIdx.x ? own
                                 : Share(wb, UG, U, RG, N, H, NH, kFwdWarps);
  };

  for (int wb = blockIdx.x; wb < work; wb += gridDim.x) {
    const Share sh = share(wb);
    stage(WR * ldw,
          [&](int e) {
            const int r = e / ldw, k = e % ldw;
            const int unit = 8 * (r / 32) + r % 8, g = (r / 8) % 4;
            return unit < sh.nu && k < H
                       ? to_f32(w[(long long)k * sk +
                                  (long long)(g * H + sh.unit0 + unit) * sg])
                       : 0.f;
          },
          [&](int e) { return w_part(wb) + e; });
    // h0 into buffer 1 (read at step 0); the last unit group zeroes the
    // columns past H of both buffers for its rows
    for (int p = threadIdx.x; p < sh.rows * sh.nu; p += blockDim.x) {
      const int n = sh.row0 + p / sh.nu, unit = sh.unit0 + p % sh.nu;
      hbuf[buf + (size_t)n * hp + unit] = h0[(size_t)n * H + unit];
    }
    if (sh.last_units) {
      const int pad = hp - H;
      for (int p = threadIdx.x; p < 2 * sh.rows * pad; p += blockDim.x) {
        const int b = p / (sh.rows * pad), n = sh.row0 + (p / pad) % sh.rows;
        store(hbuf + b * buf + (size_t)n * hp + H + p % pad, 0.f);
      }
    }
  }
  __syncthreads();

  // step t of one work block: its products, then its cells
  auto step = [&](int t, const T* hsrc, T* hdst, const Share& sh,
                  const T* w_s) {
    const int KS = sh.KS;
    // a split depth's cells: this thread's first (row, unit) reads its
    // gin and c under the products
    CellIn first;
    if (KS > 1 && threadIdx.x < sh.rows * sh.nu)
      first = cell_in(gin, c0, cbuf, t, N, H, sh.row0 + threadIdx.x / sh.nu,
                      sh.unit0 + threadIdx.x % sh.nu);
    for (int item = warp; item < sh.items; item += kFwdWarps) {
      const int pair = item / KS, split = item % KS;
      const int m = sh.mt0 + pair / NH, hf = pair % NH;
      float acc[4][4];
      tile_product<T, 4, 1>(acc, hsrc, hp, m, N,
                            (int)((long long)chunks * split / KS),
                            (int)((long long)chunks * (split + 1) / KS),
                            w_s + (32 * hf + gid) * ldw + tig * KG, ldw, hp,
                            true);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = gid + (q < 2 ? 0 : 8), u = 8 * hf + 2 * tig + (q & 1);
        if (KS == 1) {
          if (m * 16 + r < N && u < sh.nu) {
            const float z[4] = {acc[0][q], acc[1][q], acc[2][q], acc[3][q]};
            lstm_cell(cell_in(gin, c0, cbuf, t, N, H, m * 16 + r,
                              sh.unit0 + u),
                      z, out, cseq, gates, cbuf, hdst, t, N, H, hp,
                      m * 16 + r, sh.unit0 + u);
          }
        } else {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            red_s[(item * 16 + r) * 32 + g * 8 + 2 * tig + (q & 1)] =
                acc[g][q];
        }
      }
    }
    if (KS > 1) {
      __syncthreads();
      // each (row, unit): the KS partials of its four gates in split
      // order 0..KS-1
      for (int p = threadIdx.x; p < sh.rows * sh.nu; p += blockDim.x) {
        const int rl = p / sh.nu, u = p % sh.nu;
        const int pair = (rl / 16) * NH + u / 8, r = rl % 16;
        float z[4];
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          float v = 0.f;
          for (int sp = 0; sp < KS; ++sp)
            v += red_s[((pair * KS + sp) * 16 + r) * 32 + g * 8 + u % 8];
          z[g] = v;
        }
        lstm_cell(p == threadIdx.x
                      ? first
                      : cell_in(gin, c0, cbuf, t, N, H, sh.row0 + rl,
                                sh.unit0 + u),
                  z, out, cseq, gates, cbuf, hdst, t, N, H, hp,
                  sh.row0 + rl, sh.unit0 + u);
      }
    }
  };

  cg::grid_group grid = cg::this_grid();
  grid.sync();   // h0 and the zeros visible to every block
  for (int t = 0; t < steps; ++t) {
    const T* hsrc = hbuf + ((t + 1) & 1) * buf;
    T* hdst = hbuf + (t & 1) * buf;
    if constexpr (WALK) {
      for (int wb = blockIdx.x; wb < work; wb += gridDim.x) {
        if (wb != (int)blockIdx.x) __syncthreads();   // red_s is free
        step(t, hsrc, hdst, share(wb), w_part(wb));
      }
    } else {
      step(t, hsrc, hdst, own, w_part(blockIdx.x));
    }
    if (t + 1 < steps) grid.sync();   // h_t complete for every block
  }
}

// The recurrence for blocks of U <= 8 NT units and a group of the batch's
// m16 row tiles: work block wb owns unit group wb % UG (units [ug U, ug U
// + U)) and row group wb / UG (m-tiles [mt RG_i / RG, ...)), so dgin[t]
// crosses L2 once per unit group and row, not once per block. Shared
// memory: w_s [8 NT][ldw] of T, row j = W[unit0 + j][0..4H) then zeros
// (ldw * sizeof(T) = 64 mod 128 bytes: the 8 lanes of a 16-byte access
// phase hit distinct banks; in wg's slice of the work block instead when
// WG); then red_s [8 work items][16][8 NT] f32 partial sums when the
// depth is split across warps (a block with fewer than 8 m-tiles: KS =
// 8 / m-tiles). Block b does work blocks b, b + gridDim.x, ... (a grid
// smaller than UG x RG only when WG), each phase for all of them.
template <typename T, int NT, bool WG>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_kernel(const T* __restrict__ gates, const T* __restrict__ cseq,
                const T* __restrict__ w, long long sk, long long sg,
                const T* __restrict__ c0, const T* __restrict__ dout,
                const T* __restrict__ dcseq, T* dgin, float* dh_c,
                float* dc_c, T* wg, int steps, int N, int H, int U, int RG,
                int ldw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int KG = 16 / (int)sizeof(T);   // k of one lane's 16 bytes
  constexpr int KC = 4 * KG;                // k of one warp chunk
  constexpr int UN = 8 * NT;                // units of the n-tiles
  // W's part in shared memory, or in work block wb's slice of wg
  auto w_part = [&](int wb) {
    return WG ? wg + (size_t)wb * UN * ldw : reinterpret_cast<T*>(smem_raw);
  };
  float* red_s = reinterpret_cast<float*>(
      smem_raw + (WG ? 0 : (size_t)UN * ldw * sizeof(T)));
  const int G = 4 * H;
  const int UG = (H + U - 1) / U;
  const int work = UG * RG;
  const int chunks = (G + KC - 1) / KC;
  const bool vec = G % KG == 0;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;

  const Share own(blockIdx.x, UG, U, RG, N, H, 1, kWarps);
  for (int wb = blockIdx.x; wb < work; wb += gridDim.x) {
    const Share sh = wb == (int)blockIdx.x
                         ? own : Share(wb, UG, U, RG, N, H, 1, kWarps);
    stage(UN * ldw,
          [&](int e) {
            const int j = e / ldw, g = e % ldw;
            return j < sh.nu && g < G
                       ? to_f32(w[(long long)(sh.unit0 + j) * sk +
                                  (long long)g * sg])
                       : 0.f;
          },
          [&](int e) { return w_part(wb) + e; });
  }
  __syncthreads();
  cg::grid_group grid = cg::this_grid();
  for (int t = steps - 1; t >= 0; --t) {
    // A: dgin[t] for this block's rows and units, from local values only
    for (int wb = blockIdx.x; wb < work; wb += gridDim.x) {
      const Share sh = wb == (int)blockIdx.x
                           ? own : Share(wb, UG, U, RG, N, H, 1, kWarps);
      for (int p = threadIdx.x; p < sh.rows * sh.nu; p += blockDim.x) {
        const int n = sh.row0 + p / sh.nu, unit = sh.unit0 + p % sh.nu;
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
    }
    grid.sync();   // dgin[t] complete for every block
    // B: dh_{t-1}[own rows, own units] = dgin[t][own rows] . W[own units]^T
    const T* dsrc = dgin + (size_t)t * N * G;
    for (int wb = blockIdx.x; wb < work; wb += gridDim.x) {
      const Share sh = wb == (int)blockIdx.x
                           ? own : Share(wb, UG, U, RG, N, H, 1, kWarps);
      const T* wrow = w_part(wb) + gid * ldw + tig * KG;
      const int my_mt = sh.mt1 - sh.mt0;
      const int KS = sh.KS, items = sh.items;
      for (int item = warp; item < items; item += kWarps) {
        const int m = sh.mt0 + item / KS, split = item % KS;
        const int c0_ = (int)((long long)chunks * split / KS);
        const int c1_ = (int)((long long)chunks * (split + 1) / KS);
        float acc[NT][4];
        tile_product<T, NT, kBatch>(acc, dsrc, G, m, N, c0_, c1_, wrow, ldw,
                                    G, vec);
        // acc[j]: rows 16 m + gid (0, 1) and + 8 (2, 3), units 8 j + 2 tig
        // (+ 1)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int r = gid + (q < 2 ? 0 : 8), u = 8 * j + 2 * tig + (q & 1);
            if (KS == 1) {
              if (m * 16 + r < N && u < sh.nu)
                dh_c[(size_t)(m * 16 + r) * H + sh.unit0 + u] = acc[j][q];
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
          const int row = (sh.mt0 + mi) * 16 + r;
          if (row < N && u < sh.nu) {
            float v = 0.f;
            for (int q = 0; q < KS; ++q) v += red_s[((mi * KS + q) * 16 + r) * UN + u];
            dh_c[(size_t)row * H + sh.unit0 + u] = v;
          }
        }
        // the next work block writes red_s again
        if (wb + (int)gridDim.x < work) __syncthreads();
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

// the forward for u <= 16 units a block (four n-tiles of 8 gate columns
// a unit half: one half or two), W's part in device memory when wg,
// blocks walking several work blocks when walk (only with wg)
template <typename T>
const void* fwd_for(int u, bool wg, bool walk) {
  if (u < 1 || u > 2 * kTile || (walk && !wg)) return nullptr;
  const bool one = u <= kTile;
  if (walk)
    return one ? reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 1, true, true>)
               : reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 2, true, true>);
  if (wg)
    return one ? reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 1, true, false>)
               : reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 2, true, false>);
  return one ? reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 1, false, false>)
             : reinterpret_cast<const void*>(&lstm_fwd_kernel<T, 2, false, false>);
}

// the recurrence for u <= 16 units a block (one n-tile of 8 or two), W's
// rows in device memory when wg (its blocks walk work blocks whenever
// the grid is smaller than UG x RG)
template <typename T>
const void* bwd_for(int u, bool wg) {
  if (u < 1 || u > 2 * kTile) return nullptr;
  if (wg)
    return u <= kTile
               ? reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 1, true>)
               : reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 2, true>);
  return u <= kTile
             ? reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 1, false>)
             : reinterpret_cast<const void*>(&lstm_bwd_kernel<T, 2, false>);
}

// the recurrence kernel (bwd = 1) or the forward (bwd = 0, its walking
// variant when walk) for u units
const void* kernel_for(int bwd, int u, int dtype, bool wg, bool walk) {
  switch (dtype) {
    case 0: return bwd ? bwd_for<float>(u, wg) : fwd_for<float>(u, wg, walk);
    case 1: return bwd ? bwd_for<__nv_bfloat16>(u, wg) : fwd_for<__nv_bfloat16>(u, wg, walk);
    case 2: return bwd ? bwd_for<__half>(u, wg) : fwd_for<__half>(u, wg, walk);
    default: return nullptr;
  }
}

int item_size(int dtype) { return dtype == 0 ? 4 : 2; }

// Shared bytes of either kernel: W rows of ldw elements (the forward's
// four gate columns a unit, the backward's one row a unit, padded to
// whole n-tiles of u <= 8 or u <= 16 units; none when they are in device
// memory, `wg`) and the split partial sums (f32: the backward's 8 work
// items x 16 rows x those rows, the forward's 16 items x 16 rows x 32
// columns).
size_t smem_bytes(int bwd, int dtype, int ldw, int u, bool wg) {
  const int rows = (bwd ? 1 : 4) * (u <= kTile ? kTile : 2 * kTile);
  return (wg ? 0 : (size_t)rows * ldw * item_size(dtype)) +
         (bwd ? (size_t)kWarps * 16 * rows : (size_t)kFwdWarps * 16 * 32) *
             sizeof(float);
}

// threads a block of the forward (bwd = 0) or the backward's recurrence
int block_threads(int bwd) { return bwd ? kThreads : 32 * kFwdWarps; }

// the grid both kernels take: UG = ceil(H / u) unit groups x RG row
// groups (RG <= the m16 tiles of N) of work blocks, u <= 16, on `blocks`
// blocks: all of them, or (W's part in device memory, `wg`) fewer, each
// walking several; ldw elements a W row of `depth` (at least depth
// rounded up to 64 bytes, 64 mod 128 bytes)
bool grid_ok(int N, int H, int dtype, int blocks, int u, int RG, int ldw,
             int depth, int smem, int bwd, bool wg) {
  const int chunk = 64 / item_size(dtype);
  if (N < 1 || H < 1 || u < 1 || u > 2 * kTile || RG < 1 ||
      RG > (N + 15) / 16)
    return false;
  const long long work = (long long)((H + u - 1) / u) * RG;
  return blocks >= 1 && blocks <= work && (blocks == work || wg) &&
         ldw >= (depth + chunk - 1) / chunk * chunk &&
         ldw * item_size(dtype) % 128 == 64 &&
         (size_t)smem >= smem_bytes(bwd, dtype, ldw, u, wg);
}

cudaError_t launch_coop(const void* fn, int bwd, int blocks, void** args,
                        int smem, void* stream) {
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err)
    err = cudaLaunchCooperativeKernel(fn, dim3(blocks),
                                      dim3(block_threads(bwd)), args,
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
// u units a block and W's part in shared memory (wg = 0) or device
// memory (wg = 1), blocks walking several work blocks (walk = 1, with
// wg only), that can be resident on one SM with `smem` bytes of
// dynamic shared memory each, to out[0]. A cooperative grid must not
// have more than that times the SMs. Returns a cudaError_t.
extern "C" int mxtt_lstm_occupancy(int bwd, int u, int dtype, int wg,
                                   int walk, int smem, void* out_,
                                   void* stream) {
  (void)stream;
  int* out = static_cast<int*>(out_);
  out[0] = 0;
  const void* fn = kernel_for(bwd, u, dtype, wg != 0, walk != 0);
  if (fn == nullptr || smem < 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = mxtt::allow_smem(fn, (size_t)smem);
  if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   out, fn, block_threads(bwd), (size_t)smem);
  return (int)err;
}

// Plain C entry point of the forward (loaded with ctypes): one
// cooperative launch over the planned grid. gin (T, N, 4H), h0 and c0
// (N, H), out and cseq (T, N, H), gates (T, N, 4H): contiguous, of type
// `dtype`; w (H, 4H) of the same type at strides (sk, sg) in elements;
// cbuf (N, H) float32 scratch (the c carry); hbuf (2, N, hp) scratch of
// type `dtype`, hp = H rounded up to 64 bytes; wg null (W's part in
// shared memory) or scratch of type `dtype` for ceil(H / u) x RG work
// blocks x 64 (32 where u <= 8) rows of ldw elements. The grid as the
// backward's
// (mxtt_lstm_bwd), ldw elements a W column (depth H). Returns the
// launch's cudaError_t.
extern "C" int mxtt_lstm_fwd(const void* gin, const void* w, long long sk,
                             long long sg, const void* h0, const void* c0,
                             void* out, void* cseq, void* gates, void* cbuf,
                             void* hbuf, void* wg, int T, int N, int H,
                             int dtype, int blocks, int u, int RG, int ldw,
                             int hp, int smem, void* stream) {
  const int chunk = 64 / item_size(dtype);
  if (T < 1 || hp != (H + chunk - 1) / chunk * chunk ||
      !grid_ok(N, H, dtype, blocks, u, RG, ldw, H, smem, 0, wg != nullptr))
    return (int)cudaErrorInvalidValue;
  const bool walk = blocks < (H + u - 1) / u * RG;
  const void* fn = kernel_for(0, u, dtype, wg != nullptr, walk);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* cb = static_cast<float*>(cbuf);
  void* args[] = {(void*)&gin, (void*)&w, &sk, &sg, (void*)&h0, (void*)&c0,
                  &out, &cseq, &gates, &cb, &hbuf, &wg, &T, &N, &H, &u,
                  &RG, &ldw, &hp};
  return (int)launch_coop(fn, 0, blocks, args, smem, stream);
}

// Plain C entry point of the backward's recurrence. gates, dgin (T, N,
// 4H); cseq, dout, dcseq (T, N, H); c0 (N, H): contiguous, of type
// `dtype`; w at strides (sk, sg). dh0 and dc0 (N, H) float32 must hold
// zeros (they are the carries and end as dh0, dc0). The grid: ceil(H /
// u) unit groups x RG row groups (RG <= the m16 tiles of N) of work
// blocks, u <= 16, on `blocks` blocks (all of them, or fewer when wg:
// block b walks work blocks b, b + blocks, ...). ldw: elements of a W
// row in shared memory (at least 4H rounded up to 64 bytes, ldw *
// itemsize = 64 mod 128). wg: null (W's rows in shared memory) or
// scratch of type `dtype` for the work blocks x 16 (8 where u <= 8) rows
// of ldw elements. Returns the launch's cudaError_t.
extern "C" int mxtt_lstm_bwd(const void* gates, const void* cseq,
                             const void* w, long long sk, long long sg,
                             const void* c0, const void* dout,
                             const void* dcseq, void* dgin, void* dh0,
                             void* dc0, void* wg, int T, int N, int H,
                             int dtype, int blocks, int u, int RG, int ldw,
                             int smem, void* stream) {
  if (T < 1 ||
      !grid_ok(N, H, dtype, blocks, u, RG, ldw, 4 * H, smem, 1, wg != nullptr))
    return (int)cudaErrorInvalidValue;
  const void* fn = kernel_for(1, u, dtype, wg != nullptr, false);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  float* dh = static_cast<float*>(dh0);
  float* dc = static_cast<float*>(dc0);
  void* args[] = {(void*)&gates, (void*)&cseq, (void*)&w, &sk, &sg,
                  (void*)&c0, (void*)&dout, (void*)&dcseq, &dgin, &dh, &dc,
                  &wg, &T, &N, &H, &u, &RG, &ldw};
  return (int)launch_coop(fn, 1, blocks, args, smem, stream);
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
