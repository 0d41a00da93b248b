"""TensorBoard scalar logging: MXNet's ``contrib/tensorboard.py``.

Port of ``mxnet_tpu/contrib/tensorboard.py``, a copy (standard library
only). MXNet wraps the external tensorboard package's
``SummaryWriter``; this one writes the event-file format itself
(TFRecord framing with masked CRC32C around the Event/Summary protobuf
fields that scalars need), so ``tensorboard --logdir`` reads it with no
extra dependency.
"""
from __future__ import annotations

import os
import socket
import struct
import time

__all__ = ["SummaryWriter", "LogMetricsCallback"]

# -- crc32c (Castagnoli), table-driven — TFRecord framing needs it -----
_CRC_TABLE = []


def _crc_table():
    if not _CRC_TABLE:
        poly = 0x82F63B78
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def _crc32c(data: bytes) -> int:
    tab = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = tab[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- minimal protobuf writers ------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _event(wall_time: float, step: int | None = None,
           file_version: str | None = None, summary: bytes | None = None):
    out = _pb_double(1, wall_time)
    if step is not None:
        out += _pb_int(2, step)
    if file_version is not None:
        out += _pb_bytes(3, file_version.encode())
    if summary is not None:
        out += _pb_bytes(5, summary)
    return out


class SummaryWriter:
    """Write scalar summaries TensorBoard can read.

    >>> sw = SummaryWriter("/tmp/logs/run1")
    >>> sw.add_scalar("loss", 0.5, step)
    """

    _SEQ = [0]  # per-process uniquifier

    def __init__(self, logdir, filename_suffix=""):
        os.makedirs(logdir, exist_ok=True)
        # pid + sequence uniquify concurrent writers in one logdir (two
        # writers in the same second would otherwise truncate each
        # other — real tensorboard embeds pid for the same reason)
        SummaryWriter._SEQ[0] += 1
        fname = (f"events.out.tfevents.{int(time.time())}."
                 f"{socket.gethostname()}.{os.getpid()}."
                 f"{SummaryWriter._SEQ[0]}{filename_suffix}")
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "wb")
        self._write_record(_event(time.time(), file_version="brain.Event:2"))

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag, value, global_step=0, walltime=None):
        value_pb = _pb_bytes(1, str(tag).encode()) + _pb_float(2, float(value))
        summary = _pb_bytes(1, value_pb)
        self._write_record(_event(walltime if walltime is not None
                                  else time.time(),
                                  step=int(global_step), summary=summary))

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    @property
    def path(self):
        return self._path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LogMetricsCallback:
    """Batch-end callback streaming eval metrics to TensorBoard
    (reference contrib/tensorboard.py LogMetricsCallback — same
    constructor contract, no external dependency)."""

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.summary_writer = SummaryWriter(logging_dir)
        self._step = 0

    def __call__(self, param):
        if param.eval_metric is None:
            return
        self._step += 1
        for name, value in param.eval_metric.get_name_value():
            if self.prefix is not None:
                name = f"{self.prefix}-{name}"
            self.summary_writer.add_scalar(name, value, self._step)
        # live tensorboard must see scalars as they land; a crashed run
        # must not lose its history to the file buffer
        self.summary_writer.flush()
