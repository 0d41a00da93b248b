"""Hierarchical spans with tail-based sampling — the trace id grows a tree.

``trace.py`` gives every request one flat trace id; this module decomposes a
traced request into Dapper-style spans (Sigelman et al., 2010): each
span has an id, a parent id, the trace id, a start stamp, a duration,
attributes, and an ok/error status. Parentage propagates through the
same contextvar machinery as the trace id (``span(...)`` nests), and
crosses the dist_async wire as a frame field so the server's handle
span parents under the worker's RPC span across processes.

Completed spans land in a bounded in-process ring buffer with
**tail-based sampling**: the keep/drop decision is made when a trace's
local-root span finishes, so only traces that turned out SLOW
(``slow_ms`` threshold), ERRORED, or explicitly forced (shed requests)
are retained in full — the rest are counted and dropped. At high QPS
the buffer therefore holds exactly the traces an operator wants to
open, not a random head sample.

Cost discipline: with spans disabled (``MXNET_TPU_SPANS=0`` or
``configure(enabled=False)``) every entry point is one global check
returning a shared no-op span — the instrumented hot paths stay inside
the disabled-path microbench guard (tests/test_spans.py). Enabled,
a span is a small object + one locked append at end.

Consumption: ``/traces`` + ``/traces/<id>`` on the exposition server
(:mod:`.expo`), Chrome-trace events merged into ``profiler.dump()``'s
stream, ``tools/telemetry_dump.py --traces / --trace <id>``, and the
flight-recorder bundle (:mod:`.recorder`).
"""
from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
import threading
import time
from collections import OrderedDict

from .. import envvars
from .registry import REGISTRY
from .trace import (current_trace_id, new_trace_id, reset_trace_id,
                    set_trace_id)

__all__ = ["Span", "SpanRecorder", "RECORDER", "span", "start_span",
           "record_span", "use_span", "current_span", "current_span_id",
           "configure", "enabled", "traces_summary", "get_trace",
           "slowest_traces", "export_chrome_events", "reset",
           "merge_trace_records", "merge_trace_summaries",
           "mono_to_us", "perf_to_mono"]

_current_span = contextvars.ContextVar("mxnet_tpu_span", default=None)
_counter = itertools.count()

# perf_counter is the span clock (matches profiler.py's Chrome-trace
# microseconds); request timestamps are time.monotonic() — capture the
# offset once so synthesized spans land on the same axis
_MONO_OFFSET_US = (time.perf_counter_ns() // 1000
                   - int(time.monotonic() * 1e6))


def _now_us():
    return time.perf_counter_ns() // 1000


def mono_to_us(mono_s):
    """Map a ``time.monotonic()`` stamp onto the span/profiler
    microsecond axis."""
    return int(mono_s * 1e6) + _MONO_OFFSET_US


def perf_to_mono(perf_s):
    """Map a ``time.perf_counter()`` stamp onto the ``time.monotonic()``
    axis, in seconds. The two clocks share CLOCK_MONOTONIC on Linux
    but differ elsewhere (Windows < 3.13), so intervals timed with
    perf_counter must cross through this before being compared against
    monotonic wall endpoints."""
    return perf_s - _MONO_OFFSET_US / 1e6


def _new_span_id():
    from .trace import _process_salt
    return f"s{_process_salt()}-{os.getpid():x}-{next(_counter):x}"


class Span:
    """One timed operation in a trace tree.

    ``local_root=True`` marks the span whose completion triggers this
    process's tail-sampling decision for the trace — a span with no
    in-process parent (its ``parent_id`` may still name a REMOTE span,
    e.g. the worker RPC span a server handle parents under).
    """

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "ts_us",
                 "dur_us", "wall", "attrs", "status", "error", "pid",
                 "tid", "local_root", "forced", "_ended")

    def __init__(self, name, trace_id, parent_id=None, local_root=False,
                 attrs=None, forced=False, ts_us=None, wall=None):
        self.name = name
        self.trace_id = trace_id
        self.span_id = _new_span_id()
        self.parent_id = parent_id
        self.local_root = local_root
        self.forced = forced
        self.attrs = dict(attrs) if attrs else {}
        self.ts_us = ts_us if ts_us is not None else _now_us()
        self.wall = wall if wall is not None else time.time()
        self.dur_us = None
        self.status = "ok"
        self.error = None
        self.pid = os.getpid()
        self.tid = threading.get_ident()
        self._ended = False
        if local_root:
            RECORDER.on_root_start(trace_id)

    def set_attr(self, **kv):
        self.attrs.update(kv)
        return self

    def force_keep(self):
        """Mark this span's trace keep-regardless (shed requests)."""
        self.forced = True
        return self

    def end(self, status=None, error=None, end_us=None):
        """Close the span (idempotent: first end wins) and hand it to
        the recorder for the tail-sampling bookkeeping."""
        if self._ended:
            return self
        self._ended = True
        self.dur_us = max(0, (end_us if end_us is not None else _now_us())
                          - self.ts_us)
        if status is not None:
            self.status = status
        if error is not None:
            self.error = error
            self.status = "error"
        RECORDER.record(self)
        return self

    @property
    def duration_ms(self):
        return None if self.dur_us is None else self.dur_us / 1e3

    def to_dict(self):
        d = {"trace_id": self.trace_id, "span_id": self.span_id,
             "parent_id": self.parent_id, "name": self.name,
             "ts_us": self.ts_us, "dur_us": self.dur_us,
             "wall": round(self.wall, 6), "status": self.status,
             "pid": self.pid, "tid": self.tid}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.error:
            d["error"] = self.error
        return d

    def __repr__(self):
        return (f"Span({self.name!r}, trace={self.trace_id}, "
                f"id={self.span_id}, parent={self.parent_id})")


class _NoopSpan:
    """Shared do-nothing span handed out when spans are disabled — the
    instrumented paths call the same methods either way."""

    trace_id = None
    span_id = None
    parent_id = None
    name = None
    dur_us = None
    duration_ms = None
    status = "ok"

    def set_attr(self, **kv):
        return self

    def force_keep(self):
        return self

    def end(self, status=None, error=None, end_us=None):
        return self

    def to_dict(self):
        return {}


NOOP = _NoopSpan()


class SpanRecorder:
    """Bounded ring buffer of kept traces + the tail-sampling logic.

    Per trace this process accumulates finished spans in an ACTIVE
    buffer; when a local-root span finishes, the trace is KEPT (moved
    into the ring, evicting the oldest) if that root was slow, errored
    or forced — otherwise, once no local roots remain open, the spans
    are dropped and only a counter remembers them. Both buffers are
    bounded (``max_traces`` kept, ``max_active`` in flight,
    ``max_spans`` per trace) so a leaked trace can never grow the
    process.
    """

    def __init__(self, max_traces=None, slow_ms=None, max_spans=None,
                 max_active=None, registry=None):
        self.max_traces = int(max_traces
                              or envvars.get("MXNET_TPU_TRACE_BUFFER"))
        self.slow_ms = float(slow_ms if slow_ms is not None
                             else envvars.get("MXNET_TPU_TRACE_SLOW_MS"))
        self.max_spans = int(max_spans
                             or envvars.get("MXNET_TPU_TRACE_MAX_SPANS"))
        self.max_active = int(max_active
                              or envvars.get("MXNET_TPU_TRACE_MAX_ACTIVE"))
        self._lock = threading.Lock()
        self._active = OrderedDict()   # trace_id -> buf dict
        self._kept = OrderedDict()     # trace_id -> kept-trace dict
        self._dropped = 0
        reg = registry if registry is not None else REGISTRY
        self._c_traces = reg.counter(
            "mxnet_tpu_traces_total",
            "tail-sampling decisions on completed traces", ("decision",))
        self._c_spans = reg.counter(
            "mxnet_tpu_trace_spans_total", "spans recorded")

    # -- bookkeeping -------------------------------------------------------
    def _buf(self, trace_id):
        buf = self._active.get(trace_id)
        if buf is None:
            while len(self._active) >= self.max_active:
                self._active.popitem(last=False)   # evict oldest partial
            buf = {"spans": [], "open_roots": 0, "dropped_spans": 0,
                   "forced": False}
            self._active[trace_id] = buf
        return buf

    def on_root_start(self, trace_id):
        with self._lock:
            self._buf(trace_id)["open_roots"] += 1

    def record(self, sp):
        self._c_spans.inc()
        with self._lock:
            buf = self._buf(sp.trace_id)
            if len(buf["spans"]) < self.max_spans:
                buf["spans"].append(sp.to_dict())
            else:
                buf["dropped_spans"] += 1
            if sp.forced:
                buf["forced"] = True
            if not sp.local_root:
                return
            buf["open_roots"] -= 1
            slow = (sp.dur_us or 0) / 1e3 >= self.slow_ms
            err = sp.status == "error"
            keep = slow or err or sp.forced or buf["forced"]
            if keep:
                reason = ("error" if err else
                          "slow" if slow else "forced")
                self._keep(sp, buf, reason)
            if buf["open_roots"] <= 0:
                self._active.pop(sp.trace_id, None)
                if not keep:
                    rec = self._kept.get(sp.trace_id)
                    if rec is not None:
                        # an earlier root already KEPT this trace:
                        # late siblings merge into the kept record
                        # (bounded) instead of vanishing unaccounted
                        room = self.max_spans - len(rec["spans"])
                        if room > 0:
                            rec["spans"].extend(buf["spans"][:room])
                        rec["dropped_spans"] += (buf["dropped_spans"]
                                                 + max(0, len(buf["spans"])
                                                       - max(room, 0)))
                    else:
                        self._dropped += 1
                        self._c_traces.labels(decision="dropped").inc()

    def _keep(self, root, buf, reason):
        # called with the lock held
        rec = self._kept.pop(root.trace_id, None)
        if rec is None:
            rec = {"trace_id": root.trace_id, "spans": [],
                   "dropped_spans": 0, "status": "ok",
                   "duration_ms": 0.0, "root": root.name,
                   "wall": root.wall, "keep_reason": reason}
            self._c_traces.labels(decision="kept").inc()
        rec["spans"].extend(buf["spans"])
        rec["dropped_spans"] += buf["dropped_spans"]
        buf["spans"] = []              # a later root keep must not dup
        buf["dropped_spans"] = 0
        if root.status == "error":
            rec["status"] = "error"
        rec["duration_ms"] = max(rec["duration_ms"],
                                 round((root.dur_us or 0) / 1e3, 3))
        rec["root"] = root.name
        self._kept[root.trace_id] = rec          # refresh recency
        while len(self._kept) > self.max_traces:
            self._kept.popitem(last=False)

    # -- read side ---------------------------------------------------------
    def summary(self):
        """The /traces payload: config + per-kept-trace summaries
        (slowest first) + drop accounting."""
        with self._lock:
            kept = [{k: v for k, v in rec.items() if k != "spans"}
                    | {"spans": len(rec["spans"])}
                    for rec in self._kept.values()]
            active = len(self._active)
        kept.sort(key=lambda r: -r["duration_ms"])
        return {"slow_ms": self.slow_ms, "max_traces": self.max_traces,
                "kept": kept, "dropped_traces": self._dropped,
                "active_traces": active}

    def get(self, trace_id):
        """Full span list for one trace — kept ring first, then the
        in-flight buffer (flagged ``partial``)."""
        with self._lock:
            rec = self._kept.get(trace_id)
            if rec is not None:
                return dict(rec, spans=list(rec["spans"]))
            buf = self._active.get(trace_id)
            if buf is not None and buf["spans"]:
                return {"trace_id": trace_id, "partial": True,
                        "spans": list(buf["spans"]),
                        "dropped_spans": buf["dropped_spans"]}
        return None

    def slowest(self, n=3):
        """[(trace_id, root name, duration_ms)] — the per-leg bench
        summary and loadgen exit hint."""
        return [(r["trace_id"], r["root"], r["duration_ms"])
                for r in self.summary()["kept"][:n]]

    def chrome_events(self):
        """Kept (and in-flight) spans as Chrome trace-event dicts, on
        the same microsecond axis as profiler.py's stream."""
        with self._lock:
            spans = [s for rec in self._kept.values()
                     for s in rec["spans"]]
            spans += [s for buf in self._active.values()
                      for s in buf["spans"]]
        out = []
        for s in spans:
            ev = {"name": s["name"], "cat": "span", "ph": "X",
                  "ts": s["ts_us"], "dur": s["dur_us"] or 0,
                  "pid": s["pid"], "tid": s["tid"],
                  "args": {"trace_id": s["trace_id"],
                           "span_id": s["span_id"],
                           "parent_id": s["parent_id"],
                           "status": s["status"],
                           **s.get("attrs", {})}}
            out.append(ev)
        return out

    def dump_state(self):
        """Everything (kept + active) for the flight-recorder bundle."""
        with self._lock:
            return {"kept": [dict(r, spans=list(r["spans"]))
                             for r in self._kept.values()],
                    "active": {tid: {"spans": list(b["spans"]),
                                     "open_roots": b["open_roots"],
                                     "dropped_spans": b["dropped_spans"]}
                               for tid, b in self._active.items()},
                    "dropped_traces": self._dropped}

    def clear(self):
        with self._lock:
            self._active.clear()
            self._kept.clear()
            self._dropped = 0


#: process-wide recorder every instrumented layer records into
RECORDER = SpanRecorder()

_enabled = envvars.get("MXNET_TPU_SPANS")


def enabled():
    return _enabled


def configure(enabled=None, slow_ms=None, max_traces=None, max_spans=None,
              max_active=None):
    """Adjust span recording at runtime (tests, operators). Only the
    arguments given change; returns the active :class:`SpanRecorder`."""
    global _enabled
    if enabled is not None:
        _enabled = bool(enabled)
    if slow_ms is not None:
        RECORDER.slow_ms = float(slow_ms)
    if max_traces is not None:
        RECORDER.max_traces = int(max_traces)
    if max_spans is not None:
        RECORDER.max_spans = int(max_spans)
    if max_active is not None:
        RECORDER.max_active = int(max_active)
    return RECORDER


def reset():
    """Drop all recorded traces (test isolation)."""
    RECORDER.clear()


def current_span():
    """The innermost active Span on this context, or None."""
    return _current_span.get()


def current_span_id():
    sp = _current_span.get()
    return sp.span_id if sp is not None else None


def start_span(name, trace_id=None, parent_id=None, attrs=None,
               local_root=None, forced=False):
    """Start a MANUAL span (caller must ``.end()`` it — possibly from
    another thread; the serving request root crosses submit→worker).

    Parentage: explicit ``parent_id`` wins (pass the REMOTE span id
    from a wire frame with ``local_root=True``); otherwise the ambient
    context span. ``local_root`` defaults to "no in-process parent".
    """
    if not _enabled:
        return NOOP
    ctx_parent = _current_span.get()
    if (parent_id is None and ctx_parent is not None
            and (trace_id is None or trace_id == ctx_parent.trace_id)):
        # ambient parenting only within ONE trace: a request root
        # minted with its own trace id must not parent under an
        # unrelated ambient span (a fit step submitting requests)
        parent_id = ctx_parent.span_id
        trace_id = ctx_parent.trace_id
        root = False
    else:
        root = parent_id is None or ctx_parent is None
    if local_root is not None:
        root = local_root
    if trace_id is None:
        trace_id = current_trace_id() or new_trace_id("t")
    return Span(name, trace_id, parent_id=parent_id, local_root=root,
                attrs=attrs, forced=forced)


@contextlib.contextmanager
def span(name, **attrs):
    """``with span("stage", k=v) as sp:`` — scoped span parented under
    the ambient one; an exception ends it with error status (and
    re-raises). Mints + scopes a trace id when none is active, so
    events emitted inside correlate."""
    if not _enabled:
        yield NOOP
        return
    parent = _current_span.get()
    had_tid = current_trace_id()
    if parent is not None:
        sp = Span(name, parent.trace_id, parent_id=parent.span_id,
                  attrs=attrs)
    else:
        sp = Span(name, had_tid or new_trace_id("t"), local_root=True,
                  attrs=attrs)
    tok = _current_span.set(sp)
    ttok = set_trace_id(sp.trace_id) if had_tid is None else None
    try:
        yield sp
    except BaseException as e:
        sp.end(error=repr(e))
        raise
    else:
        sp.end()
    finally:
        _current_span.reset(tok)
        if ttok is not None:
            reset_trace_id(ttok)


@contextlib.contextmanager
def use_span(sp):
    """Adopt an existing span (and its trace id) as the ambient
    context WITHOUT ending it on exit — the server-side handle span
    wraps ``_handle`` this way so optimizer-update spans parent under
    it."""
    if sp is None or sp is NOOP or sp.span_id is None:
        yield sp
        return
    tok = _current_span.set(sp)
    ttok = set_trace_id(sp.trace_id)
    try:
        yield sp
    finally:
        _current_span.reset(tok)
        reset_trace_id(ttok)


def record_span(name, trace_id, parent_id=None, start_us=None, end_us=None,
                mono_start=None, mono_end=None, attrs=None, status="ok",
                error=None):
    """Record an already-timed interval as a completed span (the
    engine synthesizes per-request queue/pack/forward spans from stage
    stamps this way — batch stages time once, every member request's
    tree shows them). ``mono_*`` accept ``time.monotonic()`` stamps."""
    if not _enabled:
        return NOOP
    if start_us is None:
        start_us = mono_to_us(mono_start)
    if end_us is None:
        end_us = (mono_to_us(mono_end) if mono_end is not None
                  else _now_us())
    # deriving the wall STAMP of a past mono point (not a duration):
    # wall-now minus the mono offset since start is the only way to
    # wall-stamp a span recorded after the fact
    wall = time.time() - (_now_us() - start_us) / 1e6  # mxlint: disable=wall-clock-delta
    sp = Span(name, trace_id, parent_id=parent_id, local_root=False,
              attrs=attrs, ts_us=start_us, wall=wall)
    sp.end(status=status, error=error, end_us=end_us)
    return sp


# -- cross-ring merge (the router's fleet-wide /traces view) --------------
def _reanchor_spans(spans_out):
    """Re-anchor cross-PROCESS spans onto one time axis.

    Each process records ``ts_us`` on its own perf_counter axis —
    exact within the process, meaningless across processes. Every span
    also carries a ``wall`` stamp. Per process group we estimate that
    process's axis offset as the median of ``wall*1e6 - ts_us`` over
    its spans, then shift every foreign group's spans onto the
    REFERENCE axis (the group owning the trace's root span — the
    router's, for router-front traces) by the offset difference.
    Groups key on ``(source ring, pid)``, not pid alone: two remote
    engines that are each pid 1 inside their own container must not
    pool their unrelated perf_counter axes (nor silently share the
    reference axis). A ring only ever holds spans recorded in its own
    process, so the source disambiguates pid collisions; the same
    process split across keys just computes the same offset twice.
    Intra-process timing stays perf_counter-exact (one rigid shift per
    group); cross-process alignment is as good as the hosts' wall
    clocks — sub-millisecond on one machine, which is what makes the
    merged tree render on one monotonic axis with no negative gaps.
    Returns the pids shifted (empty when everything already shared the
    reference axis)."""
    import statistics

    groups = {}
    for s in spans_out:
        if s.get("ts_us") is None or s.get("wall") is None:
            continue
        groups.setdefault((s.get("_src"), s.get("pid")), []).append(s)
    if len(groups) <= 1:
        return []
    ids = {s.get("span_id") for s in spans_out}
    roots = [s for s in spans_out
             if s.get("parent_id") not in ids and s.get("wall") is not None]
    if roots:
        root = min(roots, key=lambda s: s["wall"])
        ref = (root.get("_src"), root.get("pid"))
    else:
        ref = min(groups, key=str)
    if ref not in groups:
        ref = min(groups, key=str)
    offsets = {key: statistics.median(s["wall"] * 1e6 - s["ts_us"]
                                      for s in group)
               for key, group in groups.items()}
    shifted = set()
    for key, group in groups.items():
        if key == ref:
            continue
        shift = int(offsets[key] - offsets[ref])
        for s in group:
            s["ts_us"] += shift
        shifted.add(key[1])
    return sorted(shifted, key=str)


def merge_trace_records(parts):
    """Merge per-ring ``/traces/<id>`` records for ONE trace into a
    single span tree — the router's cross-engine trace aggregation.

    ``parts`` is ``[(tag, record_or_None), ...]``: each record is a
    :meth:`SpanRecorder.get`-shaped dict from one span ring (the
    router's own process ring, then each REMOTE engine's, scraped over
    its ``/traces/<id>`` endpoint). A non-None ``tag`` (the engine id)
    is stamped into each span's ``attrs.engine`` when the span doesn't
    already carry one, so the merged tree names the engine that served
    every span. Spans are deduped by span id (a request that visited
    the same ring twice must not double-render), statuses/durations
    combine pessimistically, and the record's ``engines`` lists every
    engine that contributed a span. Returns None when no part had the
    trace."""
    spans_out, seen = [], set()
    merged = None
    engines = set()
    for src_idx, (tag, rec) in enumerate(parts):
        if not rec:
            continue
        if merged is None:
            merged = {"trace_id": rec.get("trace_id"), "status": "ok",
                      "duration_ms": 0.0, "dropped_spans": 0,
                      "sources": 0}
        merged["sources"] += 1
        for s in rec.get("spans", ()):
            sid = s.get("span_id")
            if sid in seen:
                continue
            seen.add(sid)
            s = dict(s)
            s["_src"] = src_idx     # re-anchor group key; stripped below
            attrs = dict(s.get("attrs") or {})
            if tag and "engine" not in attrs:
                attrs["engine"] = tag
                s["attrs"] = attrs
            if attrs.get("engine"):
                engines.add(str(attrs["engine"]))
            spans_out.append(s)
        if rec.get("status") == "error":
            merged["status"] = "error"
        merged["duration_ms"] = max(merged["duration_ms"],
                                    rec.get("duration_ms") or 0.0)
        merged["dropped_spans"] += rec.get("dropped_spans", 0) or 0
        if rec.get("partial"):
            merged["partial"] = True
        if rec.get("keep_reason") and "keep_reason" not in merged:
            merged["keep_reason"] = rec["keep_reason"]
    if merged is None:
        return None
    # per-process perf_counter axes are re-anchored onto the ROOT
    # process's axis via wall stamps, so a merged cross-process tree
    # (and telemetry_dump's render of it) reads on ONE monotonic axis
    reanchored = _reanchor_spans(spans_out)
    if reanchored:
        merged["reanchored_pids"] = reanchored
    for s in spans_out:
        s.pop("_src", None)
    spans_out.sort(key=lambda s: (s.get("ts_us") or 0))
    ids = {s.get("span_id") for s in spans_out}
    roots = [s for s in spans_out if s.get("parent_id") not in ids]
    merged["root"] = roots[0]["name"] if roots else None
    merged["spans"] = spans_out
    merged["engines"] = sorted(engines)
    return merged


def merge_trace_summaries(parts):
    """Merge per-ring ``/traces`` summaries into one fleet summary:
    kept records union by trace id (a cross-engine trace appears once,
    with every contributing engine listed), drop/active counts sum.
    ``parts`` is ``[(tag, summary_or_None), ...]`` like
    :func:`merge_trace_records`."""
    by_tid = OrderedDict()
    out = {"slow_ms": None, "max_traces": None, "dropped_traces": 0,
           "active_traces": 0, "sources": 0}
    for tag, summary in parts:
        if not summary:
            continue
        out["sources"] += 1
        if out["slow_ms"] is None:
            out["slow_ms"] = summary.get("slow_ms")
            out["max_traces"] = summary.get("max_traces")
        out["dropped_traces"] += summary.get("dropped_traces", 0) or 0
        out["active_traces"] += summary.get("active_traces", 0) or 0
        for kept in summary.get("kept", ()):
            rec = by_tid.get(kept["trace_id"])
            if rec is None:
                rec = dict(kept)
                rec["engines"] = []
                by_tid[kept["trace_id"]] = rec
            else:
                rec["spans"] = (rec.get("spans") or 0) \
                    + (kept.get("spans") or 0)
                rec["duration_ms"] = max(rec.get("duration_ms") or 0.0,
                                         kept.get("duration_ms") or 0.0)
                if kept.get("status") == "error":
                    rec["status"] = "error"
                # the front door's root names the trace in a fleet view
                if kept.get("root") == "router/request":
                    rec["root"] = kept["root"]
            if tag and tag not in rec["engines"]:
                rec["engines"].append(tag)
    kept = sorted(by_tid.values(),
                  key=lambda r: -(r.get("duration_ms") or 0.0))
    out["kept"] = kept
    return out


# -- module-level read helpers (the expo server + tools consume these) ----
def traces_summary():
    return RECORDER.summary()


def get_trace(trace_id):
    return RECORDER.get(trace_id)


def slowest_traces(n=3):
    return RECORDER.slowest(n)


def export_chrome_events():
    return RECORDER.chrome_events()
