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
// or bf16; all math in f32. The wrapper has already scaled q by
// sm_scale and cast it back to q's type, as the TPU wrapper does.
//
// Design. On the TPU the page axis is a sequential grid dimension and
// the running max / sum / accumulator sit in VMEM between grid steps.
// Here blocks run in no order, so a LOOP inside the block walks the
// live pages instead. Grid (B, H, ceil(Sq / QT)); each block holds QT
// query rows, reads its row's kv_len and page-table row itself (there
// is no scalar prefetch on the card), stages one K and one V page in
// shared memory per loop turn, computes the QT x page_size scores,
// and folds them into an online softmax. 128 threads: 8 per query
// row, each owning D / 8 output dims (interleaved, so the V reads of
// one row group hit 8 consecutive words); every thread of a row group
// keeps its own copy of the row's m and l, so no shuffles are needed.
//
// Bound. Memory: each (row, head) reads its live K and V history once,
// 2 * B * H * kv_len * D * sizeof(T) bytes per call; the arithmetic is
// 4 * Sq * kv_len * D flops per (row, head), far below the card's
// f32 rate for Sq <= 64. The bound is those bytes over HBM bandwidth.
//
// What this simple design leaves on the table: for Sq = 1 decode only
// 8 of 128 threads do the softmax and PV work, and B * H blocks (96 at
// the decode shape) do not fill 132 SMs; pages are loaded
// synchronously one at a time (no cp.async / TMA double-buffering);
// dot products run on CUDA cores, not wgmma; no split-KV across blocks
// (flash-decoding) for long histories. Those come in later changes.

#include "common.cuh"

namespace {

using mxtt::store;
using mxtt::to_f32;

constexpr int kThreads = 128;
constexpr int kThreadsPerRow = 8;
constexpr int kRowsPerBlock = kThreads / kThreadsPerRow;   // QT = 16
constexpr float kNegInf = -1e30f;                          // as the TPU kernel

// DPT = D / kThreadsPerRow output dims per thread.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int32_t* __restrict__ table,
                       const int32_t* __restrict__ kv_lens,
                       T* __restrict__ out, int H, int Sq, int page_size,
                       int n_table) {
  constexpr int D = DPT * kThreadsPerRow;
  constexpr int KS = D + 1;       // padded K row stride: no bank conflicts
  extern __shared__ float smem[];
  float* qs = smem;                                   // QT x D
  float* ks = qs + kRowsPerBlock * D;                 // page x KS
  float* vs = ks + page_size * KS;                    // page x D
  float* ss = vs + page_size * D;                     // QT x page

  const int b = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int lr = tid / kThreadsPerRow;    // local query row of this thread
  const int g = tid % kThreadsPerRow;     // its lane in the row group
  const int row = r0 + lr;
  const bool row_ok = row < Sq;
  const int rows_here = min(kRowsPerBlock, Sq - r0);

  const int kvl = kv_lens[b];
  // live pages: never past ceil(kv_len / page_size) nor the table, and
  // never past the last column any row of this tile can see
  const int last_col = kvl - Sq + r0 + rows_here - 1;   // inclusive
  int n_pages = 0;
  if (kvl > 0 && last_col >= 0) {
    const int need = (min(kvl - 1, last_col)) / page_size + 1;
    n_pages = min(need, n_table);
  }

  const size_t head_q = ((size_t)b * H + h) * Sq;
  for (int i = tid; i < rows_here * D; i += kThreads) {
    qs[i] = to_f32(q[(head_q + r0) * D + i]);
  }

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;
  const int32_t* trow = table + (size_t)b * n_table;
  const int page_elems = page_size * D;

  for (int j = 0; j < n_pages; ++j) {
    const size_t base = ((size_t)trow[j] * H + h) * page_elems;
    __syncthreads();          // previous page's readers are done
    for (int i = tid; i < page_elems; i += kThreads) {
      const int c = i / D, d = i - c * D;
      ks[c * KS + d] = to_f32(k[base + i]);
      vs[i] = to_f32(v[base + i]);
    }
    __syncthreads();
    const int col0 = j * page_size;
    for (int i = tid; i < rows_here * page_size; i += kThreads) {
      const int r = i / page_size, c = i - r * page_size;
      const int col = col0 + c;
      float s = kNegInf;
      if (col < kvl && col <= kvl - Sq + r0 + r) {
        const float* qr = qs + r * D;
        const float* kr = ks + c * KS;
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot;
      }
      ss[i] = s;
    }
    __syncthreads();
    if (row_ok) {
      const float* sr = ss + lr * page_size;
      float mx = m;
      for (int c = 0; c < page_size; ++c) mx = fmaxf(mx, sr[c]);
      const bool seen = mx > kNegInf * 0.5f;
      const float alpha = seen ? expf(m - mx) : 0.f;
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
      for (int c = 0; c < page_size; ++c) {
        const float p = seen ? expf(sr[c] - mx) : 0.f;
        psum += p;
        const float* vr = vs + c * D + g;
#pragma unroll
        for (int i = 0; i < DPT; ++i)
          acc[i] = fmaf(p, vr[i * kThreadsPerRow], acc[i]);
      }
      l = l * alpha + psum;
      m = mx;
    }
  }
  if (row_ok) {
    const float l_safe = l == 0.f ? 1.f : l;
    T* orow = out + (head_q + row) * D + g;
#pragma unroll
    for (int i = 0; i < DPT; ++i)
      store(orow + i * kThreadsPerRow, acc[i] / l_safe);
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* table, const int32_t* kv_lens, void* out,
                   int B, int H, int Sq, int page_size, int n_table,
                   cudaStream_t stream) {
  constexpr int D = DPT * kThreadsPerRow;
  const size_t smem = sizeof(float) *
      ((size_t)kRowsPerBlock * D + (size_t)page_size * (D + 1) +
       (size_t)page_size * D + (size_t)kRowsPerBlock * page_size);
  auto kern = paged_attention_kernel<T, DPT>;
  cudaError_t e = mxtt::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(B, H, (Sq + kRowsPerBlock - 1) / kRowsPerBlock);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), table, kv_lens, static_cast<T*>(out), H, Sq,
      page_size, n_table);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v,
                       const int32_t* table, const int32_t* kv_lens,
                       void* out, int B, int H, int Sq, int D,
                       int page_size, int n_table, cudaStream_t stream) {
  switch (D) {
    case 8: return launch<T, 1>(q, k, v, table, kv_lens, out, B, H, Sq, page_size, n_table, stream);
    case 16: return launch<T, 2>(q, k, v, table, kv_lens, out, B, H, Sq, page_size, n_table, stream);
    case 32: return launch<T, 4>(q, k, v, table, kv_lens, out, B, H, Sq, page_size, n_table, stream);
    case 64: return launch<T, 8>(q, k, v, table, kv_lens, out, B, H, Sq, page_size, n_table, stream);
    case 128: return launch<T, 16>(q, k, v, table, kv_lens, out, B, H, Sq, page_size, n_table, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). dtype: 0 = float32,
// 1 = bfloat16. Returns the launch's cudaError_t (0 = launched).
extern "C" int mxtt_paged_attention_fwd(
    const void* q, const void* k, const void* v, const void* table,
    const void* kv_lens, void* out, int B, int H, int Sq, int D,
    int page_size, int n_table, int dtype, void* stream) {
  const int32_t* tbl = static_cast<const int32_t*>(table);
  const int32_t* kvl = static_cast<const int32_t*>(kv_lens);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(q, k, v, tbl, kvl, out, B, H, Sq, D,
                                  page_size, n_table, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(q, k, v, tbl, kvl, out, B, H, Sq,
                                          D, page_size, n_table, s);
  return (int)cudaErrorInvalidValue;
}
