"""NDArray files: the ``.params`` / ``mx.nd.save`` format.

Port of ``mxnet_tpu/ndarray/serialization.py``, byte for byte: a list
header (magic ``0x112``, a reserved word, the array count), then each
array as a V2 blob (magic ``0xF993FAC9``, storage type 0, the shape as
u32 words, the context always written as cpu(0), the MXNet dtype code,
the raw little-endian data), or V3 (``0xF993FACA``, the shape as i64)
when a dimension does not fit in 31 bits, then the names. A scalar is
written with shape (1,), as the JAX package writes it. V1 blobs
(no storage type) load too. bfloat16 (code 12) is written as its raw
16-bit words, so a file holds float32 and bfloat16 arrays side by side.
A file written on the card is the same bytes as one written on the CPU
or by the JAX package for the same values.

:func:`load` places the arrays on ``ctx``, by default the current
context. Paths go through ``filesystem.open_uri``: local paths,
``file://`` and ``memory://``, and any scheme a caller registers
(``filesystem.register_scheme``). The sharded checkpoints of the JAX package
(``save_sharded``/``load_sharded``) wait for ROADMAP 'Multi-GPU'.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from ..filesystem import open_uri
from .ndarray import (DTYPE_CODES, DTYPE_OF_CODE, NDArray, _tdtype, as_nd,
                      raw_numpy)

__all__ = ["load", "load_bytes", "load_sharded", "save", "save_bytes",
           "save_sharded"]

LIST_MAGIC = 0x112
NDARRAY_V1_MAGIC = 0xF993FAC8
NDARRAY_V2_MAGIC = 0xF993FAC9
NDARRAY_V3_MAGIC = 0xF993FACA


def _save_ndarray(arr):
    if not isinstance(arr, torch.Tensor):
        raise MXNetError(f"cannot save {type(arr).__name__}: NDArrays or "
                         f"tensors only")
    code = DTYPE_CODES.get(_tdtype(arr))
    if code is None:
        raise MXNetError(f"cannot serialize dtype {arr.dtype}")
    # at least 1-d, as the JAX package writes (a scalar as shape (1,))
    npv = np.ascontiguousarray(raw_numpy(arr)[0])
    int64_shape = any(d > 0x7FFFFFFF for d in npv.shape)
    fmt = "<q" if int64_shape else "<I"
    buf = bytearray(struct.pack(
        "<Ii", NDARRAY_V3_MAGIC if int64_shape else NDARRAY_V2_MAGIC, 0))
    buf += struct.pack("<I", npv.ndim)
    for d in npv.shape:
        buf += struct.pack(fmt, d)
    buf += struct.pack("<iii", 1, 0, code)   # dev_type=kCPU, dev_id=0
    buf += npv.astype(npv.dtype.newbyteorder("<"), copy=False).tobytes()
    return bytes(buf)


def _entries(data):
    if isinstance(data, torch.Tensor):
        return [data], []
    if isinstance(data, dict):
        names = list(data)
        return [data[k] for k in names], names
    if isinstance(data, (list, tuple)):
        return list(data), []
    raise MXNetError("save expects an NDArray, a list or a dict")


def save_bytes(data):
    """The file's bytes for ``data`` (an array, a list or a dict of
    name to array)."""
    arrays, names = _entries(data)
    buf = bytearray(struct.pack("<QQQ", LIST_MAGIC, 0, len(arrays)))
    for a in arrays:
        buf += _save_ndarray(a)
    buf += struct.pack("<Q", len(names))
    for nm in names:
        b = nm.encode("utf-8")
        buf += struct.pack("<Q", len(b)) + b
    return bytes(buf)


def save(fname, data):
    """``mx.nd.save``: write an array, a list or a dict to ``fname``."""
    payload = save_bytes(data)
    with open_uri(fname, "wb") as f:
        f.write(payload)


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def read(self, fmt):
        vals = struct.unpack_from(fmt, self.data, self.pos)
        self.pos += struct.calcsize(fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n):
        if self.pos + n > len(self.data):
            raise MXNetError("truncated NDArray file")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out


def _load_ndarray(r, device):
    magic = r.read("<I")
    if magic not in (NDARRAY_V1_MAGIC, NDARRAY_V2_MAGIC, NDARRAY_V3_MAGIC):
        raise MXNetError(f"bad NDArray magic {magic:#x}")
    if magic != NDARRAY_V1_MAGIC:
        stype = r.read("<i")
        if stype != 0:
            raise MXNetError(f"storage type {stype}: the port loads dense "
                             f"arrays only")
    ndim = r.read("<I")
    fmt = "<q" if magic == NDARRAY_V3_MAGIC else "<I"
    shape = tuple(r.read(fmt) for _ in range(ndim))
    r.read("<ii")               # saved context: ignored, placed on ctx
    code = r.read("<i")
    if code not in DTYPE_OF_CODE:
        raise MXNetError(f"unknown dtype code {code}")
    dt = DTYPE_OF_CODE[code]
    n = int(np.prod(shape)) if shape else 1
    raw = r.read_bytes(n * dt.itemsize)
    t = torch.frombuffer(bytearray(raw), dtype=dt) if n else \
        torch.empty(0, dtype=dt)
    return as_nd(t.reshape(shape).to(device))


def load_bytes(data, ctx=None):
    """Arrays from a file's bytes: a list, or a dict when the file has
    names."""
    device = resolve_device(ctx)
    r = _Reader(data)
    magic, _ = r.read("<QQ")
    if magic != LIST_MAGIC:
        raise MXNetError(f"invalid NDArray file (magic {magic:#x})")
    arrays = [_load_ndarray(r, device) for _ in range(r.read("<Q"))]
    n_names = r.read("<Q")
    if n_names == 0:
        return arrays
    names = [bytes(r.read_bytes(r.read("<Q"))).decode("utf-8")
             for _ in range(n_names)]
    return dict(zip(names, arrays))


def load(fname, ctx=None):
    """``mx.nd.load``: a list, or a dict as the file was saved; the
    arrays on ``ctx`` (default: the current context)."""
    with open_uri(fname, "rb") as f:
        data = f.read()
    try:
        return load_bytes(data, ctx)
    except MXNetError as err:
        raise MXNetError(f"{fname!r}: {err}") from None


def save_sharded(prefix, data):
    raise NotImplementedError(
        "save_sharded: sharded checkpoints span several devices (ROADMAP "
        "'Multi-GPU'); use save")


def load_sharded(prefix, ctx=None):
    raise NotImplementedError(
        "load_sharded: sharded checkpoints span several devices (ROADMAP "
        "'Multi-GPU'); use load")
