"""The native RecordIO reader and image batcher (``io.native``).

Port of ``mxnet_tpu/io/native.py``. The records are read on C++
threads (``io/csrc/recordio.cc``, the port's copy of the JAX package's
framing, index, shuffle and part split, with no jpeglib), built with
``g++`` at first use into ``mxnet_tpu_torch/_build/`` and bound with
``ctypes``. The JAX batcher decodes and resizes on those threads with
libjpeg; here the C++ side hands each batch's JPEG streams and labels
over, and :class:`NativeImageBatcher` decodes them on the card with
nvJPEG and resizes and assembles the batch in one hand-written kernel
(``ops/image.py``), or, for ``device="cpu"``, decodes with PIL and runs
the kernel's plain version. A record that is no JPEG is skipped and the
batch compacted, as in the JAX batcher; any other failure raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import warnings

import torch

from ..context import resolve_device
from ..ops import _build, image

__all__ = ["NativeBatcher", "NativeIOUnavailable", "NativeImageBatcher",
           "NativeRecordReader", "available", "decode_jpeg"]

_LIB = None
_LOCK = threading.Lock()
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "recordio.cc")
_CXXFLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-Wall", "-shared")


class NativeIOUnavailable(RuntimeError):
    pass


def _build_lib():
    """``g++`` of ``csrc/recordio.cc`` into ``_build/`` (named by the
    source's hash, so an edited source rebuilds); returns its path."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(_CXXFLAGS).encode())
    lib = os.path.join(_build.BUILD_DIR,
                       f"libmxio-{digest.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeIOUnavailable("no C++ compiler (g++) to build "
                                  "io/csrc/recordio.cc")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeIOUnavailable(f"g++ failed for io/csrc/recordio.cc "
                                  f"(exit {proc.returncode}):\n"
                                  f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)        # atomic: concurrent builds agree
    return lib


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build_lib())
        p, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name, res, args in (
                ("mxio_reader_open", p, [ctypes.c_char_p]),
                ("mxio_reader_next", i64, [p, ctypes.POINTER(
                    ctypes.c_char_p)]),
                ("mxio_reader_close", None, [p]),
                ("mxio_batcher_create", p, [
                    ctypes.c_char_p, ctypes.c_char_p, i64, c_int, c_int,
                    ctypes.c_uint64, i64, i64]),
                ("mxrec_img_create", p, [
                    ctypes.c_char_p, ctypes.c_char_p, i64, c_int, c_int,
                    ctypes.c_uint64, i64, i64]),
                ("mxio_batcher_num_batches", i64, [p]),
                ("mxio_batcher_next", i64, [
                    p, ctypes.POINTER(p), ctypes.POINTER(ctypes.c_char_p),
                    ctypes.POINTER(ctypes.POINTER(i64)),
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]),
                ("mxio_batcher_free_batch", None, [p]),
                ("mxio_batcher_reset", None, [p]),
                ("mxio_batcher_close", None, [p])):
            fn = getattr(lib, name)
            fn.restype = res
            fn.argtypes = args
        _LIB = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except NativeIOUnavailable:
        return False


class NativeRecordReader:
    """Sequential reader over a RecordIO file (native framing)."""

    def __init__(self, path):
        self._lib = _load()
        self._h = self._lib.mxio_reader_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")

    def read(self):
        buf = ctypes.c_char_p()
        n = self._lib.mxio_reader_next(self._h, ctypes.byref(buf))
        if n < 0:
            return None
        return ctypes.string_at(buf, n)

    def close(self):
        if self._h:
            self._lib.mxio_reader_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


class _Records:
    """A C++ batcher handle: each :meth:`next` is one batch's payloads
    (a list of bytes) and labels (image batches), or None at the
    epoch's end."""

    def __init__(self, create, rec_path, idx_path, batch_size, num_threads,
                 shuffle, seed, num_parts, part_index, error):
        self._lib = _load()
        self._h = getattr(self._lib, create)(
            rec_path.encode(), (idx_path or "").encode(), batch_size,
            num_threads, int(shuffle), seed, num_parts, part_index)
        if not self._h:
            raise IOError(error)

    @property
    def num_batches(self):
        return self._lib.mxio_batcher_num_batches(self._h)

    def next(self):
        batch = ctypes.c_void_p()
        data = ctypes.c_char_p()
        offsets = ctypes.POINTER(ctypes.c_int64)()
        labels = ctypes.POINTER(ctypes.c_float)()
        n = self._lib.mxio_batcher_next(
            self._h, ctypes.byref(batch), ctypes.byref(data),
            ctypes.byref(offsets), ctypes.byref(labels))
        if n < 0:
            return None
        base = ctypes.cast(data, ctypes.c_void_p).value
        records = [ctypes.string_at(base + offsets[i],
                                    offsets[i + 1] - offsets[i])
                   for i in range(n)]
        lab = [labels[i] for i in range(n)] if labels else []
        self._lib.mxio_batcher_free_batch(batch)
        return records, lab

    def reset(self):
        self._lib.mxio_batcher_reset(self._h)

    def close(self):
        if self._h:
            self._lib.mxio_batcher_close(self._h)
            self._h = None


class NativeBatcher:
    """Threaded prefetching record batcher (``iter_image_recordio_2``
    analog): each :meth:`next` is one batch's records (bytes), the last
    batch short, or None at the epoch's end."""

    def __init__(self, rec_path, idx_path=None, batch_size=32, num_threads=4,
                 shuffle=False, seed=0, num_parts=1, part_index=0):
        self._rec = _Records("mxio_batcher_create", rec_path, idx_path,
                             batch_size, num_threads, shuffle, seed,
                             num_parts, part_index, f"cannot open {rec_path}")

    @property
    def num_batches(self):
        return self._rec.num_batches

    def next(self):
        """list[bytes] for one batch, or None at the epoch's end."""
        out = self._rec.next()
        return None if out is None else out[0]

    def reset(self):
        self._rec.reset()

    def close(self):
        if getattr(self, "_rec", None) is not None:
            self._rec.close()

    def __del__(self):
        self.close()


def _decode_pil(data):
    """(h, w, 3) uint8 RGB CPU tensor of a JPEG stream (PIL); raises
    ``ValueError`` for a stream that is no JPEG."""
    import io as _io

    import numpy as np
    from PIL import Image, UnidentifiedImageError

    try:
        with Image.open(_io.BytesIO(data)) as im:
            if im.format != "JPEG":
                raise ValueError(f"not a JPEG stream ({im.format})")
            rgb = np.asarray(im.convert("RGB"))
    except (UnidentifiedImageError, OSError) as e:
        raise ValueError(f"corrupt JPEG stream: {e}") from e
    return torch.from_numpy(rgb.copy())


def _decode_all(streams, decode):
    """The decoded (h, w, 3) uint8 images of ``streams`` (``decode``:
    PIL's or a :class:`~..ops.image.JpegDecoder`'s) and the indices of
    those that decoded (a stream that is no JPEG is skipped)."""
    images, kept = [], []
    for i, s in enumerate(streams):
        try:
            images.append(decode(s))
        except ValueError:
            continue
        kept.append(i)
    return images, kept


class NativeImageBatcher:
    """The native image pipeline (``iter_image_recordio_2`` analog):
    RecordIO framing, IRHeader parse, shuffle and the part split on C++
    threads; JPEG decode (nvJPEG on the card, PIL on the CPU) and one
    resize-and-assemble kernel a batch into a (B, 3, H, W) uint8 tensor
    on ``device`` (the current context's by default). Each :meth:`next`
    gives (data, labels float32 (B,)) on that device, or None at the
    epoch's end; a partial final batch is discarded (last_batch=
    'discard')."""

    def __init__(self, rec_path, idx_path, batch_size=32,
                 data_shape=(3, 224, 224), num_threads=4, shuffle=False,
                 seed=0, num_parts=1, part_index=0, device=None):
        c, h, w = data_shape
        if c != 3:
            raise ValueError("the native image pipeline decodes RGB "
                             "(3 channels)")
        self.device = resolve_device(device)
        self._decoder = image.JpegDecoder(self.device) \
            if self.device.type == "cuda" else None
        self._shape = (batch_size, c, h, w)
        self._rec = _Records(
            "mxrec_img_create", rec_path, idx_path, batch_size,
            num_threads, shuffle, seed, num_parts, part_index,
            f"cannot open {rec_path} (or fewer records than one batch)")
        self._pending = None

    @property
    def num_batches(self):
        return self._rec.num_batches

    def next(self):
        """(data uint8 (n, 3, H, W), labels float32 (n,)) on the device,
        or None at the epoch's end; n < batch_size when records that
        are no JPEG were skipped (the batch is compacted)."""
        self._release()
        out = self._rec.next()
        if out is None:
            return None
        streams, labels = out
        b, _, h, w = self._shape
        images, kept = _decode_all(
            streams, self._decoder.decode if self._decoder else _decode_pil)
        lab = torch.tensor([labels[i] for i in kept], dtype=torch.float32)
        if len(kept) < b:
            warnings.warn(f"native image batcher: {b - len(kept)} corrupt "
                          f"record(s) skipped in batch")
        if not images:
            return (torch.empty((0, 3, h, w), dtype=torch.uint8,
                                device=self.device),
                    lab.to(self.device))
        data = image.resize_assemble(images, h, w)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._pending = (streams, done)
        return data, lab.to(self.device)

    def _release(self):
        """Drop the last batch's JPEG streams once its decode has run
        on the card (nvJPEG reads them from the host)."""
        if self._pending is not None:
            self._pending[1].synchronize()
            self._pending = None

    def reset(self):
        self._release()
        self._rec.reset()

    def close(self):
        if getattr(self, "_rec", None) is not None:
            self._release()
            self._rec.close()
        if getattr(self, "_decoder", None) is not None:
            self._decoder.close()

    def __del__(self):
        self.close()


def decode_jpeg(buf, out_h, out_w, device=None):
    """One image decoded and resized → uint8 (3, out_h, out_w) on
    ``device`` (nvJPEG and the kernel on the card, PIL and the plain
    version on the CPU)."""
    dev = resolve_device(device)
    dec = image.JpegDecoder(dev) if dev.type == "cuda" else None
    try:
        images, kept = _decode_all([bytes(buf)],
                                   dec.decode if dec else _decode_pil)
        if not kept:
            raise ValueError("corrupt JPEG")
        return image.resize_assemble(images, out_h, out_w)[0]
    finally:
        if dec is not None:
            torch.cuda.current_stream(dev).synchronize()
            dec.close()
