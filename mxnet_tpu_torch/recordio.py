"""RecordIO read/write (python/mxnet/recordio.py + dmlc-core recordio).

The PyTorch port's copy of ``mxnet_tpu/recordio.py`` (numpy and the
stdlib), byte for byte compatible with it: a ``.rec``/``.idx`` pair
written by either package reads in the other.

Binary-compatible with the reference format: records framed by the
kMagic marker 0xced7230a with a length-or-continue control word, padded
to 4 bytes; IndexedRecordIO keeps a text ``.idx`` of key→offset.
``IRHeader``/``pack``/``unpack``/``pack_img``/``unpack_img`` match
python/mxnet/recordio.py so ``im2rec``-produced datasets load directly.
"""
from __future__ import annotations

import collections
import numbers
import os
import struct

import numpy as np

from . import filesystem as _fs
from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "image_codec",
           "pack", "unpack", "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
# control word: upper 3 bits = cflag, lower 29 = length
_LFLAG_BITS = 29
_LFLAG_MASK = (1 << _LFLAG_BITS) - 1


def _encode_lrec(cflag, length):
    return (cflag << _LFLAG_BITS) | length


def _decode_lrec(rec):
    return rec >> _LFLAG_BITS, rec & _LFLAG_MASK


class MXRecordIO:
    """Sequential RecordIO reader/writer (dmlc::RecordIOWriter/Reader)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        if flag == "w":
            self.fhandle = _fs.open_uri(uri, "wb")
            self.writable = True
        elif flag == "r":
            self.fhandle = _fs.open_uri(uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % flag)
        self.is_open = True
        self.pid = os.getpid()

    def __del__(self):
        self.close()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["is_open"] = False
        d.pop("fhandle", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()

    def open(self):
        if getattr(self, "is_open", False):
            return
        self.fhandle = _fs.open_uri(self.uri,
                                    "wb" if self.flag == "w" else "rb")
        self.is_open = True
        self.pid = os.getpid()

    def close(self):
        if getattr(self, "is_open", False):
            self.fhandle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def _check_pid(self, allow_reset=False):
        # reference guards against fork reusing handles
        if self.pid != os.getpid():
            if allow_reset:
                self.reset()
                self.pid = os.getpid()
            else:
                raise MXNetError(
                    "RecordIO handle used across fork; call reset()")

    def write(self, buf):
        assert self.writable
        self._check_pid(allow_reset=False)
        self.fhandle.write(struct.pack("<II", _MAGIC,
                                       _encode_lrec(0, len(buf))))
        self.fhandle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.fhandle.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        self._check_pid(allow_reset=True)
        hdr = self.fhandle.read(8)
        if len(hdr) < 8:
            return None
        magic, lrec = struct.unpack("<II", hdr)
        if magic != _MAGIC:
            raise MXNetError(
                f"invalid RecordIO magic {magic:#x} in {self.uri}")
        cflag, length = _decode_lrec(lrec)
        buf = self.fhandle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.fhandle.read(pad)
        # multi-part records (cflag 1=begin 2=middle 3=end)
        while cflag in (1, 2):
            hdr = self.fhandle.read(8)
            magic, lrec = struct.unpack("<II", hdr)
            cflag, length = _decode_lrec(lrec)
            part = self.fhandle.read(length)
            pad = (4 - (length % 4)) % 4
            if pad:
                self.fhandle.read(pad)
            buf += part
        return buf

    def tell(self):
        return self.fhandle.tell()

    def seek(self, pos):
        assert not self.writable
        self.fhandle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """RecordIO + .idx sidecar for random access (python/mxnet
    IndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if not self.writable and _fs.exists(idx_path):
            with _fs.open_uri(idx_path, "r") as fin:
                for line in fin:
                    line = line.strip().split("\t")
                    key = key_type(line[0])
                    self.idx[key] = int(line[1])
                    self.keys.append(key)

    def close(self):
        if not getattr(self, "is_open", False):
            return
        if self.writable:
            with _fs.open_uri(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


# header packed as: uint32 flag, float label, uint64 id, uint64 id2
IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    header = IRHeader(*header)
    if isinstance(header.label, numbers.Number):
        header = header._replace(flag=0)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, *header) + s


def unpack(s):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    encoded = _encode_image(img, quality, img_fmt)
    return pack(header, encoded)


def unpack_img(s, iscolor=-1):
    header, s = unpack(s)
    img = _decode_image(np.frombuffer(s, dtype=np.uint8), iscolor)
    return header, img


def image_codec():
    """The codec :func:`pack_img` writes with: ``"PIL"`` (JPEG or PNG)
    when PIL imports, else ``"NPY0"`` (raw ``.npy`` records). A codec
    choice, as in the JAX package: both packages read both."""
    try:
        import PIL.Image  # noqa: F401
        return "PIL"
    except ImportError:
        return "NPY0"


def _encode_image(img, quality, img_fmt):
    """PNG/JPEG encode without OpenCV: PIL if available, else raw npy."""
    import io as _io
    try:
        from PIL import Image
        buf = _io.BytesIO()
        fmt = "JPEG" if img_fmt.lower() in (".jpg", ".jpeg") else "PNG"
        Image.fromarray(np.asarray(img).astype(np.uint8)).save(
            buf, fmt, quality=quality)
        return buf.getvalue()
    except ImportError:
        buf = _io.BytesIO()
        np.save(buf, np.asarray(img))
        return b"NPY0" + buf.getvalue()


def _decode_image(raw, iscolor=-1):
    import io as _io
    b = raw.tobytes()
    if b[:4] == b"NPY0":
        return np.load(_io.BytesIO(b[4:]))
    try:
        from PIL import Image
        img = Image.open(_io.BytesIO(b))
        return np.asarray(img)
    except ImportError as e:
        raise MXNetError("image decoding requires PIL (not installed) "
                         "or NPY0-packed records") from e
