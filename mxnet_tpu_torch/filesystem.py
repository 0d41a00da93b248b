"""URI-routed filesystem layer — the dmlc-core filesystem abstraction.

The PyTorch port's copy of ``mxnet_tpu/filesystem.py`` (stdlib only).

Reference analog: ``3rdparty/dmlc-core/src/io/`` (`LocalFileSystem`,
`S3FileSystem`, `HDFSFileSystem` behind ``dmlc::Stream::Create`` URI
routing) — the layer that lets every reference IO surface (RecordIO,
NDArray save/load, checkpoints) read ``s3://...`` the same way it reads
a local path. The design: a small scheme registry instead of
C++ virtual streams; schemes are pluggable so cloud backends register
without the core importing their SDKs.

Built-in schemes:

- local paths (no scheme, or ``file://``) — plain ``open``;
- ``memory://`` — an in-process byte store (the dmlc ``MemoryFileSystem``
  test backend; also handy for CI without a writable disk).

``s3://`` / ``hdfs:// `` / ``gs://`` raise a clear error unless a
handler is registered with :func:`register_scheme` (this build runs in
a zero-egress environment; shipping stub clients that cannot work
would be worse than an honest error naming the extension point).
"""
from __future__ import annotations

import io
import os
import threading

from .base import MXNetError

__all__ = ["open_uri", "exists", "list_prefix", "register_scheme",
           "MemoryFileSystem"]

_LOCK = threading.Lock()


def _split_scheme(uri):
    if "://" in str(uri):
        scheme, rest = str(uri).split("://", 1)
        return scheme.lower(), rest
    return "", str(uri)


class _MemWriter(io.BytesIO):
    def __init__(self, store, path, initial=b""):
        super().__init__()
        self._store = store
        self._path = path
        if initial:
            self.write(initial)

    def close(self):
        if not self.closed:  # idempotent, like real file objects
            self._store[self._path] = self.getvalue()
        super().close()


class _MemTextWriter(io.StringIO):
    def __init__(self, store, path, initial=""):
        super().__init__()
        self._store = store
        self._path = path
        if initial:
            self.write(initial)

    def close(self):
        if not self.closed:
            self._store[self._path] = self.getvalue().encode()
        super().close()


class MemoryFileSystem:
    """In-process byte store behind ``memory://`` URIs."""

    def __init__(self):
        self._files: dict[str, bytes] = {}

    def open(self, path, mode):
        if "+" in mode:
            raise MXNetError(
                f"memory:// does not support update mode {mode!r}")
        if "r" in mode:
            if path not in self._files:
                raise FileNotFoundError(f"memory://{path}")
            data = self._files[path]
            return io.BytesIO(data) if "b" in mode \
                else io.StringIO(data.decode())
        initial = self._files.get(path, b"") if "a" in mode else b""
        if "b" in mode:
            return _MemWriter(self._files, path, initial)
        return _MemTextWriter(self._files, path, initial.decode())

    def exists(self, path):
        return path in self._files

    def list(self, prefix):
        return sorted(p for p in self._files if p.startswith(prefix))

    def clear(self):
        self._files.clear()


_MEMORY = MemoryFileSystem()

_SCHEMES: dict = {}


def register_scheme(scheme, opener, exists_fn=None, list_fn=None):
    """Register a URI scheme handler.

    ``opener(path, mode) -> file-like``; optional ``exists_fn(path)``
    and ``list_fn(prefix) -> [path, ...]`` (sharded-checkpoint
    discovery needs listing). This is how an S3/HDFS/GCS client plugs
    in (dmlc registered its cloud filesystems the same way).
    """
    with _LOCK:
        _SCHEMES[scheme.lower()] = (opener, exists_fn, list_fn)


register_scheme("memory", _MEMORY.open, _MEMORY.exists, _MEMORY.list)


def open_uri(uri, mode="rb"):
    """Open ``uri`` — local path, ``file://``, ``memory://`` or any
    registered scheme (dmlc ``Stream::Create`` analog)."""
    scheme, path = _split_scheme(uri)
    if scheme in ("", "file"):
        return open(path, mode)
    with _LOCK:
        entry = _SCHEMES.get(scheme)
    if entry is None:
        raise MXNetError(
            f"no filesystem registered for scheme {scheme!r} (uri {uri!r}); "
            "register one with mxnet_tpu_torch.filesystem.register_scheme — "
            "cloud filesystems (s3/hdfs/gs) need their client installed "
            "and registered, this environment has no network egress")
    return entry[0](path, mode)


def _scheme_entry(scheme, uri, capability, idx):
    with _LOCK:
        entry = _SCHEMES.get(scheme)
    if entry is None:
        raise MXNetError(
            f"no filesystem registered for scheme {scheme!r} (uri {uri!r}); "
            "register one with mxnet_tpu_torch.filesystem.register_scheme")
    if entry[idx] is None:
        # a silent False/[] would make existence-gated loads skip REAL
        # data — signal the capability gap instead
        raise MXNetError(
            f"filesystem for scheme {scheme!r} registered no "
            f"{capability} handler (uri {uri!r})")
    return entry[idx]


def exists(uri):
    scheme, path = _split_scheme(uri)
    if scheme in ("", "file"):
        return os.path.exists(path)
    return _scheme_entry(scheme, uri, "exists", 1)(path)


def list_prefix(uri_prefix):
    """All URIs under a prefix (sharded-checkpoint discovery; the
    local scheme globs ``prefix*``)."""
    scheme, path = _split_scheme(uri_prefix)
    if scheme in ("", "file"):
        import glob as _glob
        return sorted(_glob.glob(path + "*"))
    lister = _scheme_entry(scheme, uri_prefix, "list", 2)
    return [f"{scheme}://{p}" for p in lister(path)]
