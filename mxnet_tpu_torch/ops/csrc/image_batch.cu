// The native image batcher's device side: JPEG decode through nvJPEG
// and one hand-written kernel that resizes every decoded image of a
// batch bilinearly, turns HWC into CHW and writes it into its slot of
// the (B, 3, H, W) uint8 batch, all in one pass.
//
// It replaces no TPU kernel: the JAX package decodes, resizes and
// assembles its batches on C++ threads with libjpeg
// (src/cc/image_batcher.cc: DecodeJpeg :75, ResizeBilinear :103-136,
// the CHW copy :255-262), and the card's machine has no libjpeg. The
// kernel computes ResizeBilinear exactly: float32 arithmetic in the
// same order, each product and sum rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction, which the C++ does not do either),
// the same clamps, (uint8)(v + 0.5f) by truncation, and the plain copy
// when the image already has the output size. So the kernel, its plain
// version (ops/image.py: resize_bilinear_reference) and the C++ give
// the same bytes for the same decoded pixels.
//
// Bound: bytes. Each output byte is written once and reads 4 source
// pixels of 3 bytes (mostly from L1/L2: neighbouring threads share
// them); the least traffic is every source image read once and the
// batch written once. One thread an output pixel, its 3 channels; a
// block of 256 threads over a row-major run of pixels of one image
// (grid.y the image), so the stores of a channel plane coalesce.
//
// C entry points (loaded with ctypes by ops/image.py):
//   mxtt_nvjpeg_create / _destroy: a decoder (handle + state) on the
//     current device;
//   mxtt_nvjpeg_info: the width and height of a JPEG stream;
//   mxtt_nvjpeg_decode: decode into an interleaved RGB (h, w, 3) uint8
//     device buffer on a stream;
//   mxtt_image_resize: the kernel, on a stream.
// The nvJPEG calls return nvjpegStatus_t, or -1 for a stream nvJPEG
// cannot read (not a JPEG, corrupt, truncated or of a kind it does not
// decode); the kernel's entry point returns its cudaError_t.

#include <cuda_runtime.h>
#include <nvjpeg.h>
#include <stdint.h>

namespace {

struct Decoder {
  nvjpegHandle_t handle = nullptr;
  nvjpegJpegState_t state = nullptr;
};

// table: B source pointers (as int64), then B widths, then B heights
__global__ void resize_assemble_kernel(const long long* table,
                                       uint8_t* __restrict__ out, int batch,
                                       int out_h, int out_w) {
  const int b = blockIdx.y;
  const int plane = out_h * out_w;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= plane) return;
  const uint8_t* src = reinterpret_cast<const uint8_t*>(table[b]);
  const int w0 = static_cast<int>(table[batch + b]);
  const int h0 = static_cast<int>(table[2 * batch + b]);
  uint8_t* dst = out + static_cast<size_t>(b) * 3 * plane;
  const int y = p / out_w;
  const int x = p - y * out_w;
  if (w0 == out_w && h0 == out_h) {
    const uint8_t* q = src + static_cast<size_t>(p) * 3;
    dst[p] = q[0];
    dst[plane + p] = q[1];
    dst[2 * plane + p] = q[2];
    return;
  }
  const float sx = __fdiv_rn(static_cast<float>(w0), static_cast<float>(out_w));
  const float sy = __fdiv_rn(static_cast<float>(h0), static_cast<float>(out_h));
  const float fy = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sy), 0.5f);
  const int y0 = max(0, __float2int_rz(fy));
  const int y1 = min(h0 - 1, y0 + 1);
  float wy = __fsub_rn(fy, static_cast<float>(y0));
  if (wy < 0) wy = 0;
  const float fx = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sx), 0.5f);
  const int x0 = max(0, __float2int_rz(fx));
  const int x1 = min(w0 - 1, x0 + 1);
  float wx = __fsub_rn(fx, static_cast<float>(x0));
  if (wx < 0) wx = 0;
  const float ay = __fsub_rn(1.0f, wy);
  const float ax = __fsub_rn(1.0f, wx);
  const uint8_t* r0 = src + static_cast<size_t>(y0) * w0 * 3;
  const uint8_t* r1 = src + static_cast<size_t>(y1) * w0 * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float v00 = r0[x0 * 3 + c];
    const float v01 = r0[x1 * 3 + c];
    const float v10 = r1[x0 * 3 + c];
    const float v11 = r1[x1 * 3 + c];
    // v00*(1-wy)*(1-wx) + v01*(1-wy)*wx + v10*wy*(1-wx) + v11*wy*wx,
    // left to right, as the C++ evaluates it
    float v = __fmul_rn(__fmul_rn(v00, ay), ax);
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v01, ay), wx));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v10, wy), ax));
    v = __fadd_rn(v, __fmul_rn(__fmul_rn(v11, wy), wx));
    dst[c * plane + p] = static_cast<uint8_t>(__float2uint_rz(__fadd_rn(v, 0.5f)));
  }
}

int status(nvjpegStatus_t st) {
  switch (st) {
    case NVJPEG_STATUS_INVALID_PARAMETER:
    case NVJPEG_STATUS_BAD_JPEG:
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
      return -1;
    default:
      return static_cast<int>(st);
  }
}

}  // namespace

extern "C" int mxtt_nvjpeg_create(void** out) {
  auto* d = new Decoder();
  nvjpegStatus_t st = nvjpegCreateSimple(&d->handle);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(d->handle, &d->state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    if (d->handle) nvjpegDestroy(d->handle);
    delete d;
    return static_cast<int>(st);
  }
  *out = d;
  return 0;
}

extern "C" int mxtt_nvjpeg_destroy(void* dec) {
  auto* d = static_cast<Decoder*>(dec);
  nvjpegStatus_t st = nvjpegJpegStateDestroy(d->state);
  nvjpegStatus_t st2 = nvjpegDestroy(d->handle);
  delete d;
  return static_cast<int>(st != NVJPEG_STATUS_SUCCESS ? st : st2);
}

extern "C" int mxtt_nvjpeg_info(void* dec, const unsigned char* data,
                                size_t len, int* width, int* height) {
  auto* d = static_cast<Decoder*>(dec);
  int components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st = nvjpegGetImageInfo(d->handle, data, len, &components,
                                         &subsampling, widths, heights);
  *width = widths[0];
  *height = heights[0];
  return status(st);
}

extern "C" int mxtt_nvjpeg_decode(void* dec, const unsigned char* data,
                                  size_t len, void* out, int pitch,
                                  void* stream) {
  auto* d = static_cast<Decoder*>(dec);
  nvjpegImage_t img = {};
  img.channel[0] = static_cast<unsigned char*>(out);
  img.pitch[0] = static_cast<size_t>(pitch);
  return status(nvjpegDecode(d->handle, d->state, data, len,
                             NVJPEG_OUTPUT_RGBI, &img,
                             static_cast<cudaStream_t>(stream)));
}

// out: (batch, 3, out_h, out_w) uint8; table: device int64 (3 * batch)
extern "C" int mxtt_image_resize(const void* table, void* out, int batch,
                                 int out_h, int out_w, void* stream) {
  if (batch < 1 || out_h < 1 || out_w < 1 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int plane = out_h * out_w;
  dim3 grid((plane + threads - 1) / threads, batch);
  resize_assemble_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(table), static_cast<uint8_t*>(out), batch,
      out_h, out_w);
  return static_cast<int>(cudaGetLastError());
}
