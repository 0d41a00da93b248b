"""Structured JSONL run-event log.

One line per lifecycle event — engine start/stop/abort, per-shape
compile begin/end, request shed/expiry, wire-frame refusal, kvstore
optimizer updates, watchdog anomalies — so a run leaves a
machine-readable record next to the human stderr stream. Every record
carries::

    {"ts": <wall unix s>, "mono": <monotonic s>, "pid": <pid>,
     "event": <type>, "trace_id": <active trace id or null>, ...fields}

Wall time orders events across machines; the monotonic stamp orders
them exactly within a process (wall clocks step, monotonic doesn't).

Cost discipline: when no log is configured and no tap is attached,
:func:`emit` is one global read + two truthiness checks — the
instrumented hot paths pay nothing (guarded by the disabled-path
microbenchmark in tests/test_telemetry.py).

Configuration: :func:`configure` in code, or the
``MXNET_TPU_EVENT_LOG`` env var (read once, on first emit). If the
value names a DIRECTORY, each process writes its own
``events-<pid>.jsonl`` inside it — exactly what a multi-process
dist_async launch needs (one env var in the launcher, one log per
process, no interleaved writes).

Rotation: a long-lived server's JSONL must not grow unbounded. Set
``MXNET_TPU_EVENT_LOG_MAX_MB`` (or pass ``max_bytes``) and the log
rotates in place once it crosses the cap — ``events.jsonl`` becomes
``events.jsonl.1`` (older shift to ``.2``, ``.3``, …), bounded by
``MXNET_TPU_EVENT_LOG_KEEP`` rotated files (default 3; the oldest is
deleted). Rotation happens under the writer lock (thread-safe reopen);
:func:`read_events` transparently reads across all rotations, oldest
first.

Taps: the flight recorder (:mod:`.recorder`) registers an in-memory
tap via :func:`add_tap` so the last N events are available in a crash
bundle even when no file log is configured.
"""
from __future__ import annotations

import json
import os
import threading
import time

from .. import envvars
from .trace import current_trace_id

__all__ = ["EventLog", "configure", "emit", "get_log", "read_events",
           "add_tap", "remove_tap"]

_ROTATE_SCAN_MAX = 64      # read_events looks this far for .N siblings


def _make_record(event, fields, component=None):
    rec = {"ts": round(time.time(), 6),
           "mono": round(time.monotonic(), 6),
           "pid": os.getpid(),
           "event": event,
           "trace_id": fields.pop("trace_id", None)
           or current_trace_id()}
    if component:
        rec["component"] = component
    rec.update(fields)
    return rec


class EventLog:
    """Append-only JSONL writer (thread-safe, line-buffered: every
    event is durable on its own ``write`` — a crashed process keeps
    its log up to the last event). Rotates in place at ``max_bytes``
    keeping ``keep`` older files."""

    def __init__(self, path, component=None, max_bytes=None, keep=None):
        self.path = str(path)
        self.component = component
        if max_bytes is None:
            mb = envvars.get("MXNET_TPU_EVENT_LOG_MAX_MB")
            max_bytes = int(mb * 1024 * 1024) if mb else None
        self.max_bytes = max_bytes
        self.keep = (int(keep) if keep is not None
                     else envvars.get("MXNET_TPU_EVENT_LOG_KEEP"))
        self._lock = threading.Lock()
        self._f = open(self.path, "a", buffering=1)
        try:
            self._size = os.path.getsize(self.path)
        except OSError:
            self._size = 0

    def emit(self, event, **fields):
        self.write_record(_make_record(event, fields, self.component))

    def write_record(self, rec):
        """Serialize + append one already-built record (the module
        :func:`emit` builds the record once and shares it with the
        flight-recorder taps)."""
        line = json.dumps(rec, default=str)
        with self._lock:
            try:
                if self._f is None:
                    # a failed rotation reopen left the log dark; keep
                    # trying — the transient (fd pressure, a replaced
                    # directory) may have cleared
                    self._reopen_locked()
                self._f.write(line + "\n")
                self._size += len(line) + 1
                if self.max_bytes and self._size >= self.max_bytes:
                    self._rotate_locked()
            except (ValueError, OSError):
                # a concurrent configure()/close() or a full disk must
                # never take an instrumented hot path down — telemetry
                # loses one line, the serving batch survives
                pass

    def _reopen_locked(self):
        self._f = open(self.path, "a", buffering=1)
        try:
            self._size = os.path.getsize(self.path)
        except OSError:
            self._size = 0

    def _rotate_locked(self):
        """Shift path → path.1 → … → path.keep (oldest dropped) and
        reopen; called with the writer lock held so no line is torn
        across the swap."""
        try:
            self._f.close()
        except OSError:
            pass
        self._f = None
        try:
            if self.keep >= 1:
                oldest = f"{self.path}.{self.keep}"
                if os.path.exists(oldest):
                    os.remove(oldest)
                for i in range(self.keep - 1, 0, -1):
                    src = f"{self.path}.{i}"
                    if os.path.exists(src):
                        os.replace(src, f"{self.path}.{i + 1}")
                os.replace(self.path, f"{self.path}.1")
            else:
                # keep=0: rotate-without-retention still enforces the
                # size cap — truncate the live file in place
                os.remove(self.path)
        except OSError:
            pass            # rotation failure must not kill the writer
        # reopen failure leaves _f None; write_record retries per emit
        self._reopen_locked()

    def close(self):
        with self._lock:
            try:
                if self._f is not None:
                    self._f.close()
            except OSError:
                pass


_global = None
_env_checked = False
_lock = threading.Lock()
_taps = []


def _resolve_path(value):
    if os.path.isdir(value):
        return os.path.join(value, f"events-{os.getpid()}.jsonl")
    return value


def configure(path=None, component=None, max_bytes=None, keep=None):
    """Install (or with ``path=None`` remove) the process event log.
    Returns the :class:`EventLog` (or None)."""
    global _global, _env_checked
    with _lock:
        if _global is not None:
            _global.close()
        _global = (EventLog(_resolve_path(path), component,
                            max_bytes=max_bytes, keep=keep)
                   if path is not None else None)
        _env_checked = True          # explicit config outranks the env
    return _global


def get_log():
    """The active process log, auto-configuring from
    ``MXNET_TPU_EVENT_LOG`` on first call. None when logging is off."""
    global _global, _env_checked
    if _global is None and not _env_checked:
        with _lock:
            if _global is None and not _env_checked:
                env = envvars.get("MXNET_TPU_EVENT_LOG")
                if env:
                    try:
                        _global = EventLog(_resolve_path(env))
                    except OSError:
                        _global = None
                _env_checked = True
    return _global


def add_tap(fn):
    """Register ``fn(record_dict)`` called on every emitted event
    (flight-recorder ring). Taps run even with no file log."""
    if fn not in _taps:
        _taps.append(fn)


def remove_tap(fn):
    try:
        _taps.remove(fn)
    except ValueError:
        pass


def emit(event, **fields):
    """Emit to the process log + any taps; a no-op (one None check and
    one truthiness check after the first call) when neither is
    attached. The record is built ONCE and shared — taps (the
    flight-recorder ring) see the same timestamps and component tag
    the on-disk log carries."""
    log = get_log()
    if log is None and not _taps:
        return
    rec = _make_record(event, fields,
                       log.component if log is not None else None)
    for tap in list(_taps):
        try:
            tap(rec)
        except Exception:
            pass
    if log is not None:
        log.write_record(rec)


def read_events(path, event=None, skipped=None):
    """Parse an events JSONL file — including its rotated ``.N``
    siblings, oldest first — tolerating torn lines from a live writer
    or a hard kill; optionally filter by event type.

    A process killed mid-``write`` leaves a truncated final line —
    possibly cut inside a multi-byte UTF-8 sequence, which a strict
    decode would raise on MID-POSTMORTEM. Unparseable lines are
    skipped and counted instead: pass a dict as ``skipped`` to get
    per-file skip counts back (only files with skips appear)."""
    rotated = []
    for i in range(1, _ROTATE_SCAN_MAX + 1):
        p = f"{path}.{i}"
        if os.path.exists(p):
            rotated.append(p)
    paths = list(reversed(rotated))          # highest .N = oldest
    if os.path.exists(path) or not paths:
        paths.append(str(path))
    out = []
    for p in paths:
        # errors="replace": a line torn inside a multi-byte sequence
        # must land in the json.loads skip path, not raise on decode
        with open(p, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    if skipped is not None:
                        skipped[p] = skipped.get(p, 0) + 1
                    continue
                if not isinstance(rec, dict):
                    if skipped is not None:
                        skipped[p] = skipped.get(p, 0) + 1
                    continue
                if event is None or rec.get("event") == event:
                    out.append(rec)
    return out
