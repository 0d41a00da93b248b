"""The ONNX IR subset of ``onnx_minimal.proto``, encoded by hand.

Port of ``mxnet_tpu/contrib/onnx/onnx_minimal_pb2.py``, which protoc
generates for ``google.protobuf``. This module writes and reads the
same protobuf wire format with the standard library alone: the
messages and field numbers of ``mxnet_tpu/contrib/onnx/
onnx_minimal.proto`` (the public ``onnx.proto``'s layout, so the files
are real ONNX), with proto3's rules:

- fields are written in field-number order; a singular scalar is left
  out at its default (0, 0.0, empty), a singular message when it
  encodes to nothing, and repeated scalars are packed;
- the reader takes packed and unpacked repeated scalars alike, keeps
  the last value of a singular field, merges a singular message given
  twice, and skips fields it does not know by their wire type.

The classes take the generated module's attribute API where the ONNX
code uses it: fields as attributes, ``extend``/``append``/``add()`` on
repeated fields, ``SerializeToString`` and ``ParseFromString``, and the
enums as class attributes (``TensorProto.FLOAT``,
``AttributeProto.INTS``).
"""
from __future__ import annotations

import struct
import sys

__all__ = ["AttributeProto", "GraphProto", "ModelProto", "NodeProto",
           "OperatorSetIdProto", "TensorProto", "TensorShapeProto",
           "TypeProto", "ValueInfoProto"]

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
# each field kind's wire type; the kinds whose repeated fields pack
_WIRE = {"int64": _VARINT, "int32": _VARINT, "enum": _VARINT,
         "float": _I32, "string": _LEN, "bytes": _LEN, "message": _LEN}
_PACKED = ("int64", "int32", "enum", "float")
_DEFAULT = {"int64": 0, "int32": 0, "enum": 0, "float": 0.0, "string": "",
            "bytes": b""}


def _varint(n):
    out = bytearray()
    n &= (1 << 64) - 1          # negative ints: 64-bit two's complement
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field, wire):
    return _varint(field << 3 | wire)


def _read_varint(buf, pos):
    n = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed(n):
    return n - (1 << 64) if n >= 1 << 63 else n


def _scalar(kind, v):
    """The encoding of one scalar value of ``kind`` (no tag)."""
    if kind == "float":
        return struct.pack("<f", v)
    if kind == "string":
        v = v.encode()
    if kind in ("string", "bytes"):
        return _varint(len(v)) + bytes(v)
    return _varint(int(v))


def _is_default(kind, v):
    if kind == "float":             # -0.0 is written, as protobuf does
        return struct.pack("<f", v) == b"\0\0\0\0"
    return not v


class _Repeated(list):
    """A repeated field: a list, with ``add()`` for message fields."""

    def __init__(self, cls=None):
        super().__init__()
        self._cls = cls

    def add(self, **kwargs):
        m = self._cls(**kwargs)
        self.append(m)
        return m


class _Message:
    """A protobuf message: ``FIELDS`` holds ``(number, name, kind,
    repeated, message class name)``."""

    FIELDS = ()

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        cls._BY_NAME = {f[1]: f for f in cls.FIELDS}
        cls._BY_NUMBER = {f[0]: f for f in cls.FIELDS}
        cls._ORDER = sorted(cls.FIELDS)

    def __init__(self, **kwargs):
        self._clear()
        for k, v in kwargs.items():
            setattr(self, k, v)

    def _clear(self):
        d = self.__dict__
        for _, name, kind, repeated, cls in self.FIELDS:
            if repeated:
                d[name] = _Repeated(_message_class(cls) if cls else None)
            elif kind == "message":
                d.pop(name, None)
            else:
                d[name] = _DEFAULT[kind]

    def __getattr__(self, name):
        # a singular message field reads as an empty message, made on
        # first access (as the generated classes do)
        f = type(self)._BY_NAME.get(name)
        if f is None or f[2] != "message":
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        m = _message_class(f[4])()
        self.__dict__[name] = m
        return m

    def __setattr__(self, name, value):
        f = type(self)._BY_NAME.get(name)
        if f is None:
            raise AttributeError(
                f"{type(self).__name__} has no field {name!r}")
        if f[3] or f[2] == "message":
            raise AttributeError(f"{type(self).__name__}.{name}: assign "
                                 f"into the field, not over it")
        self.__dict__[name] = value

    def SerializeToString(self):
        out = bytearray()
        d = self.__dict__
        for number, name, kind, repeated, _ in self._ORDER:
            v = d.get(name)
            if repeated:
                if not v:
                    continue
                if kind == "float":
                    body = struct.pack(f"<{len(v)}f", *v)
                    out += _tag(number, _LEN) + _varint(len(body)) + body
                elif kind in _PACKED:
                    body = b"".join(_varint(int(x)) for x in v)
                    out += _tag(number, _LEN) + _varint(len(body)) + body
                elif kind == "message":
                    for m in v:
                        b = m.SerializeToString()
                        out += _tag(number, _LEN) + _varint(len(b)) + b
                else:
                    for x in v:
                        out += _tag(number, _LEN) + _scalar(kind, x)
            elif kind == "message":
                b = v.SerializeToString() if v is not None else b""
                if b:
                    out += _tag(number, _LEN) + _varint(len(b)) + b
            elif not _is_default(kind, v):
                out += _tag(number, _WIRE[kind]) + _scalar(kind, v)
        return bytes(out)

    def ParseFromString(self, data):
        """Clear the message, then read ``data``; returns its length."""
        self._clear()
        self._merge(memoryview(data), 0, len(data))
        return len(data)

    def _merge(self, buf, pos, end):
        d = self.__dict__
        by_number = self._BY_NUMBER
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wire = key >> 3, key & 7
            if wire == _VARINT:
                raw, pos = _read_varint(buf, pos)
            elif wire == _I64:
                raw, pos = buf[pos:pos + 8], pos + 8
            elif wire == _LEN:
                n, pos = _read_varint(buf, pos)
                raw, pos = buf[pos:pos + n], pos + n
            elif wire == _I32:
                raw, pos = buf[pos:pos + 4], pos + 4
            else:
                raise ValueError(f"{type(self).__name__}: wire type {wire} "
                                 f"(groups) is not supported")
            if pos > end:
                raise ValueError(f"{type(self).__name__}: truncated field "
                                 f"{number}")
            f = by_number.get(number)
            if f is None or (wire != _WIRE[f[2]] and not (
                    f[3] and wire == _LEN and f[2] in _PACKED)):
                continue                # unknown field: skipped
            _, name, kind, repeated, cls = f
            if kind == "message":
                if repeated:
                    m = d[name].add()
                else:
                    m = getattr(self, name)
                m._merge(raw, 0, len(raw))
                continue
            if repeated and wire == _LEN and kind in _PACKED:
                d[name].extend(_unpack(kind, raw))
                continue
            val = _decode(kind, wire, raw)
            if repeated:
                d[name].append(val)
            else:
                d[name] = val
        return pos


def _decode(kind, wire, raw):
    if kind == "float":
        return struct.unpack("<f", raw)[0]
    if kind == "string":
        return bytes(raw).decode()
    if kind == "bytes":
        return bytes(raw)
    return _signed(raw)


def _unpack(kind, raw):
    if kind == "float":
        return list(struct.unpack(f"<{len(raw) // 4}f", raw))
    out, pos = [], 0
    while pos < len(raw):
        n, pos = _read_varint(raw, pos)
        out.append(_signed(n))
    return out


def _message_class(name):
    return getattr(sys.modules[__name__], name)


class AttributeProto(_Message):
    UNDEFINED, FLOAT, INT, STRING, TENSOR, GRAPH = range(6)
    FLOATS, INTS, STRINGS, TENSORS, GRAPHS = range(6, 11)
    FIELDS = ((1, "name", "string", False, None),
              (2, "f", "float", False, None),
              (3, "i", "int64", False, None),
              (4, "s", "bytes", False, None),
              (5, "t", "message", False, "TensorProto"),
              (6, "g", "message", False, "GraphProto"),
              (7, "floats", "float", True, None),
              (8, "ints", "int64", True, None),
              (9, "strings", "bytes", True, None),
              (10, "tensors", "message", True, "TensorProto"),
              (11, "graphs", "message", True, "GraphProto"),
              (20, "type", "enum", False, None))


class ValueInfoProto(_Message):
    FIELDS = ((1, "name", "string", False, None),
              (2, "type", "message", False, "TypeProto"),
              (3, "doc_string", "string", False, None))


class NodeProto(_Message):
    FIELDS = ((1, "input", "string", True, None),
              (2, "output", "string", True, None),
              (3, "name", "string", False, None),
              (4, "op_type", "string", False, None),
              (5, "attribute", "message", True, "AttributeProto"),
              (6, "doc_string", "string", False, None),
              (7, "domain", "string", False, None))


class ModelProto(_Message):
    FIELDS = ((1, "ir_version", "int64", False, None),
              (2, "producer_name", "string", False, None),
              (3, "producer_version", "string", False, None),
              (4, "domain", "string", False, None),
              (5, "model_version", "int64", False, None),
              (6, "doc_string", "string", False, None),
              (7, "graph", "message", False, "GraphProto"),
              (8, "opset_import", "message", True, "OperatorSetIdProto"))


class GraphProto(_Message):
    FIELDS = ((1, "node", "message", True, "NodeProto"),
              (2, "name", "string", False, None),
              (5, "initializer", "message", True, "TensorProto"),
              (10, "doc_string", "string", False, None),
              (11, "input", "message", True, "ValueInfoProto"),
              (12, "output", "message", True, "ValueInfoProto"),
              (13, "value_info", "message", True, "ValueInfoProto"))


class TensorProto(_Message):
    (UNDEFINED, FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64, STRING,
     BOOL, FLOAT16, DOUBLE, UINT32, UINT64, COMPLEX64, COMPLEX128,
     BFLOAT16) = range(17)
    FIELDS = ((1, "dims", "int64", True, None),
              (2, "data_type", "int32", False, None),
              (4, "float_data", "float", True, None),
              (5, "int32_data", "int32", True, None),
              (6, "string_data", "bytes", True, None),
              (7, "int64_data", "int64", True, None),
              (8, "name", "string", False, None),
              (9, "raw_data", "bytes", False, None),
              (12, "doc_string", "string", False, None))


class _Dimension(_Message):
    FIELDS = ((1, "dim_value", "int64", False, None),
              (2, "dim_param", "string", False, None))


class TensorShapeProto(_Message):
    FIELDS = ((1, "dim", "message", True, "_Dimension"),)


class _TensorType(_Message):
    FIELDS = ((1, "elem_type", "int32", False, None),
              (2, "shape", "message", False, "TensorShapeProto"))


class TypeProto(_Message):
    FIELDS = ((1, "tensor_type", "message", False, "_TensorType"),)


class OperatorSetIdProto(_Message):
    FIELDS = ((1, "domain", "string", False, None),
              (2, "version", "int64", False, None))
