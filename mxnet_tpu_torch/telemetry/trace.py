"""Request-trace propagation: one id, minted once, visible everywhere.

A trace id is a short opaque string minted at a request's front door
(``ServingEngine.submit``; a kvstore RPC mints one per call when none
is active). It rides a :mod:`contextvars` context variable through
queue → batcher → dispatch inside a process, is stamped into
Chrome-trace/xprof spans by ``profiler.Scope``, and crosses the
dist_async wire as a frame field so the worker's and server's event
logs correlate on the same push.

contextvar (not a thread-local): the serving worker adopts the trace
context of the batch it dispatches, and any future async reshuffle of
the worker loop inherits the right ids for free.
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading

__all__ = ["new_trace_id", "current_trace_id", "set_trace_id",
           "reset_trace_id", "trace_context"]

_trace_id = contextvars.ContextVar("mxnet_tpu_trace_id", default=None)
_counter = itertools.count()
_salt_lock = threading.Lock()
_salt = None


def _process_salt():
    """Random per-process prefix so ids from different processes (the
    dist_async worker fleet) never collide in a merged event log."""
    global _salt
    if _salt is None:
        with _salt_lock:
            if _salt is None:
                _salt = os.urandom(3).hex()
    return _salt


def new_trace_id(prefix="t"):
    """Mint a process-unique id: ``<prefix><salt>-<pid>-<seq>``."""
    return f"{prefix}{_process_salt()}-{os.getpid():x}-{next(_counter):x}"


def current_trace_id():
    """The active trace id, or None outside any trace context."""
    return _trace_id.get()


def set_trace_id(trace_id):
    """Set the active id; returns a token for ``_trace_id.reset``."""
    return _trace_id.set(trace_id)


def reset_trace_id(token):
    """Undo a :func:`set_trace_id` (spans.py uses the pair to scope a
    minted trace id to one local-root span)."""
    _trace_id.reset(token)


@contextlib.contextmanager
def trace_context(trace_id):
    """``with trace_context(tid):`` — scoped trace id."""
    token = _trace_id.set(trace_id)
    try:
        yield trace_id
    finally:
        _trace_id.reset(token)
