"""The native image batcher's device side: nvJPEG decode, and the
resize-and-assemble kernel with its plain PyTorch version.

The kernel (``csrc/image_batch.cu``) replaces no TPU kernel: the JAX
package resizes and assembles its batches on C++ threads
(``src/cc/image_batcher.cc``: ``ResizeBilinear`` :103-136, the CHW copy
:255-262). :func:`resize_assemble` takes a batch of decoded HWC uint8
images of any sizes and writes the (B, 3, H, W) uint8 batch in one
launch; :func:`resize_bilinear_reference` is ``ResizeBilinear`` in
torch float32 ops, one image at a time, each product and sum rounded
on its own as the C++ and the kernel round them, so the three agree
bit for bit on the same pixels. CUDA images launch the kernel (or
raise); CPU images take the plain version.

:class:`JpegDecoder` decodes JPEG streams on the card with nvJPEG (the
CUDA toolkit's library; ``csrc/image_batch.cu`` holds its C entry
points) into (h, w, 3) uint8 device tensors, on the current stream.
nvJPEG is a library, not a kernel of this package: its calls are not
counted as launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["JpegDecoder", "LAUNCHES", "resize_assemble",
           "resize_bilinear_reference"]

#: kernel launches by kernel name (the main-path proof counts these)
LAUNCHES = {"image_resize": 0}
#: the operand code the launch passes on (uint8 pixels)
_CODE = _build.OTHER_CODES[torch.uint8]
# mxtt_image_resize(table, out, batch, out_h, out_w)
_ARGS = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3


def resize_bilinear_reference(img, out_h, out_w):
    """Plain PyTorch version of one image: ``ResizeBilinear`` of an
    (h, w, 3) uint8 image to (3, out_h, out_w) uint8, on the image's
    device. The output pixel (y, x) samples ``fy = (y + 0.5) * h / out_h
    - 0.5`` (likewise x), clamped to the image, and rounds ``v + 0.5``
    down; an image of the output size is copied."""
    h0, w0 = int(img.shape[0]), int(img.shape[1])
    if (h0, w0) == (out_h, out_w):
        return img.permute(2, 0, 1).contiguous()
    f32, dev = torch.float32, img.device
    # the float32 quotients, rounded once (a CUDA tensor divided by a
    # scalar multiplies by its reciprocal, which rounds twice)
    sx = float(np.float32(w0) / np.float32(out_w))
    sy = float(np.float32(h0) / np.float32(out_h))

    def axis(n, scale, size):
        f = (torch.arange(n, dtype=f32, device=dev) + 0.5) * scale - 0.5
        i0 = f.to(torch.int64).clamp_min(0)       # truncation, then 0
        i1 = (i0 + 1).clamp_max(size - 1)
        w = (f - i0.to(f32)).clamp_min(0.0)
        return i0, i1, w

    y0, y1, wy = axis(out_h, sy, h0)
    x0, x1, wx = axis(out_w, sx, w0)
    src = img.to(f32)
    v00 = src[y0[:, None], x0[None, :]]
    v01 = src[y0[:, None], x1[None, :]]
    v10 = src[y1[:, None], x0[None, :]]
    v11 = src[y1[:, None], x1[None, :]]
    ay, ax = (1.0 - wy)[:, None, None], (1.0 - wx)[None, :, None]
    wy, wx = wy[:, None, None], wx[None, :, None]
    v = v00 * ay * ax + v01 * ay * wx + v10 * wy * ax + v11 * wy * wx
    return (v + 0.5).to(torch.uint8).permute(2, 0, 1).contiguous()


def resize_assemble(images, out_h, out_w):
    """(B, 3, out_h, out_w) uint8 batch of ``images`` (a list of (h, w,
    3) uint8 tensors of any sizes, on one device), each resized as
    :func:`resize_bilinear_reference` does: one kernel launch for CUDA
    images, the plain version for CPU ones."""
    if not images:
        raise ValueError("resize_assemble: no images")
    dev = images[0].device
    for im in images:
        if im.device != dev or im.dtype != torch.uint8 or im.ndim != 3 \
                or im.shape[2] != 3 or not im.is_contiguous():
            raise ValueError(f"resize_assemble takes contiguous (h, w, 3) "
                             f"uint8 images on one device; got "
                             f"{tuple(im.shape)} {im.dtype} on {im.device}")
    if _build.plain(images[0]):
        return torch.stack([resize_bilinear_reference(im, out_h, out_w)
                            for im in images])
    b = len(images)
    out = torch.empty((b, 3, out_h, out_w), dtype=torch.uint8, device=dev)
    table = torch.tensor([im.data_ptr() for im in images]
                         + [im.shape[1] for im in images]
                         + [im.shape[0] for im in images],
                         dtype=torch.int64).to(dev)
    _build.launch("image_batch", "mxtt_image_resize", _ARGS, dev,
                  table.data_ptr(), out.data_ptr(), b, out_h, out_w,
                  count=(LAUNCHES, "image_resize", _CODE))
    return out


class JpegDecoder:
    """nvJPEG on one card: :meth:`info` reads a stream's size,
    :meth:`decode` decodes it into a new (h, w, 3) uint8 RGB tensor on
    the current stream. A stream nvJPEG cannot parse raises
    ``ValueError``; any other failure ``RuntimeError``."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"JpegDecoder decodes on a card, not on "
                             f"{self.device}")
        lib = _build.load("image_batch")
        self._lib = lib
        for name, args in (
                ("mxtt_nvjpeg_create", [ctypes.POINTER(ctypes.c_void_p)]),
                ("mxtt_nvjpeg_destroy", [ctypes.c_void_p]),
                ("mxtt_nvjpeg_info", [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_size_t,
                                      ctypes.POINTER(ctypes.c_int),
                                      ctypes.POINTER(ctypes.c_int)]),
                ("mxtt_nvjpeg_decode", [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_size_t, ctypes.c_void_p,
                                        ctypes.c_int, ctypes.c_void_p])):
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        h = ctypes.c_void_p()
        with torch.cuda.device(self.device):
            st = lib.mxtt_nvjpeg_create(ctypes.byref(h))
        if st != 0:
            raise RuntimeError(f"nvjpegCreateSimple failed: nvjpegStatus "
                               f"{st}")
        self._h = h

    def info(self, data):
        """(height, width) of the JPEG stream ``data`` (bytes)."""
        w, h = ctypes.c_int(), ctypes.c_int()
        st = self._lib.mxtt_nvjpeg_info(self._h, data, len(data),
                                        ctypes.byref(w), ctypes.byref(h))
        if st == -1:
            raise ValueError("not a JPEG stream nvJPEG decodes")
        if st != 0:
            raise RuntimeError(f"nvjpegGetImageInfo failed: nvjpegStatus "
                               f"{st}")
        return h.value, w.value

    def decode(self, data):
        """The JPEG stream ``data`` (bytes, kept alive by the caller
        until the stream has run) as an (h, w, 3) uint8 RGB tensor on
        the card."""
        h, w = self.info(data)
        out = torch.empty((h, w, 3), dtype=torch.uint8, device=self.device)
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            st = self._lib.mxtt_nvjpeg_decode(self._h, data, len(data),
                                              out.data_ptr(), 3 * w, stream)
        if st == -1:
            raise ValueError("corrupt JPEG stream")
        if st != 0:
            raise RuntimeError(f"nvjpegDecode failed: nvjpegStatus {st}")
        return out

    def close(self):
        if getattr(self, "_h", None) is not None:
            self._lib.mxtt_nvjpeg_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, TypeError):
            pass                # interpreter shutdown: ctypes is gone
