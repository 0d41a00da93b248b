"""Tail-latency attribution: per-request critical paths + /whyslow.

A firing latency page that says "p99 blown" is a question, not an
answer. A decode request's wall time is smeared across WFQ admission
wait, chunked-prefill interleaving, iteration-boundary scheduling
gaps, KV copy-on-write copies, page-exhaustion defer episodes, wire
transit and HA-journal acks — and until each of those is a *named
stage* with per-request numbers, every page ends in guesswork. This
module is the attribution layer the rest of the serving stack stamps
into:

- :data:`STAGES` — the one canonical stage-name registry. Every
  ``stage=`` label value and every ``stage/<name>`` span anywhere in
  the tree must come from here (mxlint's ``stage-name-registry``
  check fails the build otherwise), so engine, router, dashboards and
  the pager can never drift apart on what a stage is called.
- :func:`stamp` — the hot-path primitive: record one stage interval
  on a live request. It appends a ``(stage, t0, t1)`` monotonic tuple
  to the request's stamp list (the exact per-request record the
  breakdown is computed from), synthesizes a ``stage/<name>`` child
  span under the request's root span (the trace-tree view), and —
  when the scheduler left the request idle since its last stamp —
  backfills the hole as an explicit ``sched_gap`` interval so
  admitted-but-not-in-cohort time is attributed, not smeared.
- :func:`critical_path` / :func:`breakdown_from_stamps` — the
  extractor: an ordered, *gap-free* decomposition of a finished
  request's wall time. Overlapping child intervals are resolved
  innermost-wins (a COW copy inside a decode iteration bills to
  ``cow_copy``, the remainder of the iteration to ``decode_iter``),
  uncovered wall is reported as the explicit ``unattributed`` stage,
  and ``sum(stages) + unattributed == wall`` holds by construction.
  The result rides ``InferenceFuture.breakdown`` and the streamed
  final RESULT frame, so the router and loadgen see the same numbers
  the engine measured.
- :class:`StageBreakdown` — the fleet aggregator behind ``/whyslow``:
  per-stage latency histograms labeled ``(engine_id, stage,
  tenant_class, model)``, a windowed per-stage p99, the slowest
  RETRIEVABLE exemplar trace per stage, and a ``top`` ranking by
  share of attributed time. Routers merge engine snapshots with
  :func:`merge_whyslow`; firing latency alerts attach
  :func:`top_stages_for` to their payload and flight bundle.

``MXNET_TPU_ATTRIBUTION=0`` (or spans off) disables the subsystem:
no stamp tuples, no extra spans, no metric families, no threads —
the disabled hot path is one attribute check per call site.
"""
from __future__ import annotations

import heapq
import threading
from collections import deque

from .. import envvars
from . import spans as _spans
from .registry import REGISTRY

__all__ = ["STAGES", "SPAN_PREFIX", "enabled", "stamp",
           "stamp_interval", "critical_path", "breakdown_from_stamps",
           "StageBreakdown", "aggregator", "get_aggregator",
           "top_stages_for", "merge_whyslow", "reset", "configure"]

#: The canonical stage registry. Includes the legacy encoder-path
#: stage labels (queue/pack/compute/compile/total — the
#: ``mxnet_tpu_serving_latency_ms`` axis that predates this module)
#: so one tuple governs every ``stage=`` literal in the tree.
STAGES = (
    "wfq_wait",        # submit -> WFQ drain, stamped by the queue
    "defer",           # KV page-exhaustion defer episode (requeue wait)
    "sched_gap",       # admitted but not in the running cohort
    "prefill_chunk",   # one chunked-prefill step
    "prefill",         # dense (single-shot) prefill
    "decode_iter",     # decode-iteration residency
    "cow_copy",        # KV copy-on-write page copies
    "dispatch",        # router -> seat transit (rt minus engine wall)
    "ha_ack",          # HA-journal replication ack wait
    # legacy encoder-path latency axis (ServingStats / router)
    "queue", "pack", "compute", "compile", "total",
    # the explicit remainder every decomposition carries
    "unattributed",
)

_STAGESET = frozenset(STAGES)

#: Stage spans are named ``stage/<stage>`` in the trace tree.
SPAN_PREFIX = "stage/"

#: Legacy synthesized child spans mapped onto canonical stages, so
#: :func:`critical_path` decomposes pre-attribution encoder traces too.
_LEGACY_SPAN_STAGES = {
    "serving/queue": "queue",
    "serving/pack": "pack",
    "serving/forward": "compute",
    "serving/compile": "compile",
}

#: sched_gap holes narrower than this are left to ``unattributed``
#: rather than minted as spans — sub-100µs loop bookkeeping is not a
#: scheduling decision.
_GAP_MIN_S = 100e-6

_enabled_cache = None
_lock = threading.Lock()


def enabled():
    """True when stage stamping is on: ``MXNET_TPU_ATTRIBUTION`` AND
    span recording (stamps parent under the request root span; with
    spans off there is no tree to attribute)."""
    global _enabled_cache
    if _enabled_cache is None:
        _enabled_cache = bool(envvars.get("MXNET_TPU_ATTRIBUTION"))
    return _enabled_cache and _spans.enabled()


def configure(enabled=None):
    """Test/tool override (None = re-read the env on next check)."""
    global _enabled_cache
    _enabled_cache = enabled


# -- stamping ----------------------------------------------------------------
def stamp(req, stage, mono_start, mono_end, attrs=None, span=True):
    """Record one stage interval on a live request.

    ``req`` is any object with ``stages`` (list or None), ``span``
    (the root :class:`~.spans.Span`), ``trace_id`` and ``t_activity``
    slots — i.e. a serving :class:`~..serving.queue.Request`. No-op
    (one attribute check) when attribution is off for the request.

    Idle time since the request's previous stamp is backfilled as an
    explicit ``sched_gap`` interval first, so the decomposition stays
    gap-free without every call site reasoning about holes.
    """
    stamps = getattr(req, "stages", None)
    if stamps is None:
        return
    if stage not in _STAGESET:
        raise ValueError(f"stage {stage!r} not in attribution.STAGES")
    last = req.t_activity
    if (last is not None and stage != "sched_gap"
            and mono_start - last > _GAP_MIN_S):
        stamps.append(("sched_gap", last, mono_start))
        if span and len(stamps) <= _span_cap():
            _spans.record_span(SPAN_PREFIX + "sched_gap", req.trace_id,
                               parent_id=req.span.span_id,
                               mono_start=last, mono_end=mono_start)
    stamps.append((stage, mono_start, mono_end))
    # never rewinds: a nested stamp (cow_copy inside an iteration)
    # must not reopen already-covered wall as a phantom gap
    req.t_activity = mono_end if last is None else max(last, mono_end)
    if span and len(stamps) <= _span_cap():
        _spans.record_span(SPAN_PREFIX + stage, req.trace_id,
                           parent_id=req.span.span_id,
                           mono_start=mono_start, mono_end=mono_end,
                           attrs=attrs)


def stamp_interval(req, stage, interval, attrs=None):
    """:func:`stamp` from a ``(t0, t1)`` pair (both monotonic)."""
    stamp(req, stage, interval[0], interval[1], attrs=attrs)


def _span_cap():
    # per-request stage spans ride the same per-trace cap as everything
    # else; stop minting span dicts once the trace would drop them
    # anyway (the stamp TUPLES keep accumulating — the breakdown must
    # stay exact even for 10k-token generations)
    return envvars.get("MXNET_TPU_TRACE_MAX_SPANS")


# -- critical-path extraction ------------------------------------------------
def _decompose(intervals, w0, w1):
    """Sweep ``(stage, t0, t1)`` intervals over the wall ``[w0, w1]``
    into an ordered, gap-free decomposition. Overlaps resolve
    innermost-wins (latest start; ties: latest in list order), holes
    bill to ``unattributed``. Returns (ordered stage->seconds dict,
    unattributed seconds)."""
    clipped = []
    for i, (stage, t0, t1) in enumerate(intervals):
        t0, t1 = max(t0, w0), min(t1, w1)
        if t1 > t0:
            clipped.append((t0, t1, i, stage))
    totals = {}
    first_seen = {}
    unattributed = 0.0
    edges = sorted({w0, w1, *(c[0] for c in clipped),
                    *(c[1] for c in clipped)})
    # single O(n log n) sweep: intervals enter a max-heap keyed
    # (start, stamp order) as the edge walk reaches their start and
    # are lazily expired once it passes their end, so the slice owner
    # ("innermost wins": latest start, then latest stamped) is the
    # heap top. A decode request stamps one decode_iter per generated
    # token — a per-slice rescan is O(n^2) and froze the decode loop
    # for seconds on 10k-token generations.
    clipped.sort(key=lambda c: (c[0], c[2]))
    active = []                   # (-t0, -i, t1, stage)
    nxt = 0
    for a, b in zip(edges, edges[1:]):
        while nxt < len(clipped) and clipped[nxt][0] <= a:
            t0, t1, i, stage = clipped[nxt]
            heapq.heappush(active, (-t0, -i, t1, stage))
            nxt += 1
        while active and active[0][2] <= a:
            heapq.heappop(active)
        if not active:
            unattributed += b - a
        else:
            stage = active[0][3]
            totals[stage] = totals.get(stage, 0.0) + (b - a)
            first_seen.setdefault(stage, a)
    ordered = dict(sorted(totals.items(),
                          key=lambda kv: first_seen[kv[0]]))
    return ordered, unattributed


def _breakdown_dict(ordered_s, unattributed_s, wall_s, trace_id=None):
    wall_ms = wall_s * 1e3
    stages = [{"stage": s, "ms": round(v * 1e3, 3),
               "share": round(v / wall_s, 4) if wall_s > 0 else 0.0}
              for s, v in ordered_s.items()]
    out = {"wall_ms": round(wall_ms, 3),
           "stages": stages,
           "attributed_ms": round(sum(v for v in ordered_s.values())
                                  * 1e3, 3),
           "unattributed_ms": round(unattributed_s * 1e3, 3)}
    if trace_id is not None:
        out["trace_id"] = trace_id
    return out


def breakdown_from_stamps(stamps, t_submit, t_done, trace_id=None):
    """Stamp tuples + wall endpoints -> breakdown dict. This is what
    the engine computes at request completion and hangs on
    ``InferenceFuture.breakdown``:

    ``{"wall_ms", "stages": [{"stage", "ms", "share"}, ...],
    "attributed_ms", "unattributed_ms", "trace_id"}``

    with stages ordered by first occurrence on the timeline and
    ``attributed_ms + unattributed_ms == wall_ms`` (float rounding
    aside). ``share`` is of wall."""
    wall = t_done - t_submit
    if wall <= 0:
        return _breakdown_dict({}, 0.0, 0.0, trace_id)
    ordered, unattributed = _decompose(stamps or (), t_submit, t_done)
    return _breakdown_dict(ordered, unattributed, wall, trace_id)


def critical_path(spans, root_id=None):
    """Walk a finished request's span tree (a list of span dicts as
    stored by :class:`~.spans.SpanRecorder` / served at
    ``/traces/<id>``) into the same decomposition shape as
    :func:`breakdown_from_stamps`.

    The root is ``root_id`` if given, else the first span without a
    parent in the list (else the earliest span). Descendant spans
    named ``stage/<name>`` — plus the legacy synthesized children in
    :data:`_LEGACY_SPAN_STAGES` — become the stage intervals; all
    other spans are structure, not stages."""
    if not spans:
        return _breakdown_dict({}, 0.0, 0.0)
    by_id = {s["span_id"]: s for s in spans if s.get("span_id")}
    root = None
    if root_id is not None:
        root = by_id.get(root_id)
    if root is None:
        for s in spans:
            if not s.get("parent_id") or s["parent_id"] not in by_id:
                root = s
                break
    if root is None:
        root = min(spans, key=lambda s: s.get("ts_us", 0))

    def under_root(s):
        seen = 0
        cur = s
        while cur is not None and seen < len(spans) + 1:
            if cur.get("span_id") == root.get("span_id"):
                return True
            cur = by_id.get(cur.get("parent_id"))
            seen += 1
        return False

    intervals = []
    for s in spans:
        name = s.get("name", "")
        if name.startswith(SPAN_PREFIX):
            stage = name[len(SPAN_PREFIX):]
        else:
            stage = _LEGACY_SPAN_STAGES.get(name)
        if stage is None or s is root or not under_root(s):
            continue
        t0 = s.get("ts_us", 0) / 1e6
        intervals.append((stage, t0, t0 + s.get("dur_us", 0) / 1e6))
    w0 = root.get("ts_us", 0) / 1e6
    w1 = w0 + root.get("dur_us", 0) / 1e6
    wall = w1 - w0
    if wall <= 0:
        return _breakdown_dict({}, 0.0, 0.0, root.get("trace_id"))
    ordered, unattributed = _decompose(intervals, w0, w1)
    return _breakdown_dict(ordered, unattributed, wall,
                           root.get("trace_id"))


# -- fleet aggregation (/whyslow) --------------------------------------------
_STAGE_BUCKETS = (0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                  500.0, 1000.0, 2500.0, 10000.0)

_families_cache = None


def _families(registry=None):
    """The stage metric families, created on FIRST observation only —
    the disabled path registers nothing."""
    global _families_cache
    if _families_cache is None or registry is not None:
        reg = registry or REGISTRY
        _families_cache = (
            reg.histogram(
                "mxnet_tpu_serving_stage_latency_ms",
                "per-request attributed stage time (critical-path "
                "decomposition; unattributed is an explicit stage)",
                ("engine_id", "stage", "tenant_class", "model"),
                buckets=_STAGE_BUCKETS),
            reg.counter(
                "mxnet_tpu_serving_stage_seconds_total",
                "cumulative attributed stage seconds (share-over-time "
                "queries: rate this against its siblings)",
                ("engine_id", "stage", "tenant_class", "model")))
    return _families_cache


class _StageStat:
    """One (stage, tenant_class, model) cell: count/total plus a
    sliding window of the last N per-request ``(ms, trace)`` samples.
    p99 and the slowest retrievable exemplar are computed over the
    WINDOW on read, so both decay as an incident ages out — an
    eviction policy that keeps extremes forever would converge on
    all-time maxima and report a stale tail as current."""

    __slots__ = ("count", "total_ms", "window")

    def __init__(self, capacity):
        self.count = 0
        self.total_ms = 0.0
        self.window = deque(maxlen=max(1, int(capacity or 1)))

    def observe(self, ms, trace_id=None):
        self.count += 1
        self.total_ms += ms
        self.window.append((ms, trace_id))

    def p99(self):
        if not self.window:
            return None
        w = sorted(ms for ms, _ in self.window)
        i = max(0, int(0.99 * len(w) + 0.5) - 1)
        return w[min(i, len(w) - 1)]

    def exemplar(self):
        """``(ms, trace_id)`` of the slowest windowed sample carrying
        a retrievable trace, or ``(None, None)``."""
        best_ms, best_tr = None, None
        for ms, tr in self.window:
            if tr is not None and (best_ms is None or ms > best_ms):
                best_ms, best_tr = ms, tr
        return best_ms, best_tr


class StageBreakdown:
    """Per-owner stage aggregator: what the ``/whyslow`` body reads.

    ``observe`` folds one request's breakdown dict in; ``snapshot``
    renders per-(stage, tenant_class, model) rows plus the ``top``
    ranking by share of attributed time, each top row carrying the
    stage's windowed p99 and slowest retrievable exemplar trace.
    """

    def __init__(self, owner, registry=None, window=None):
        self.owner = str(owner)
        self._registry = registry
        self._window = (window if window is not None
                        else envvars.get("MXNET_TPU_ATTRIBUTION_WINDOW"))
        self._lock = threading.Lock()
        self._stats = {}          # (stage, tenant_class, model) -> stat
        self._requests = 0

    def observe(self, breakdown, tenant_class=None, model=None,
                trace_id=None):
        """Fold one request's breakdown in. ``trace_id`` is attached
        as a stage exemplar only when the trace is actually
        retrievable at ``/traces/<id>`` (the tail-sampler kept it:
        wall >= the slow threshold)."""
        if not breakdown:
            return
        cls = str(tenant_class or "standard")
        mdl = str(model or "-")
        wall = breakdown.get("wall_ms") or 0.0
        retrievable = (trace_id is not None and _spans.enabled()
                       and wall >= _spans.RECORDER.slow_ms)
        ex = trace_id if retrievable else None
        hist, secs = _families(self._registry)
        rows = list(breakdown.get("stages") or ())
        un = breakdown.get("unattributed_ms")
        if un:
            rows.append({"stage": "unattributed", "ms": un})
        with self._lock:
            self._requests += 1
            for row in rows:
                stage, ms = row["stage"], float(row.get("ms") or 0.0)
                key = (stage, cls, mdl)
                st = self._stats.get(key)
                if st is None:
                    st = self._stats[key] = _StageStat(self._window)
                st.observe(ms, ex)
                hist.labels(engine_id=self.owner, stage=stage,
                            tenant_class=cls, model=mdl).observe(ms)
                secs.labels(engine_id=self.owner, stage=stage,
                            tenant_class=cls, model=mdl).inc(ms / 1e3)

    def snapshot(self, top=None):
        """The ``/whyslow`` body for this owner."""
        top = top if top is not None \
            else envvars.get("MXNET_TPU_ATTRIBUTION_TOP")
        with self._lock:
            rows = []
            by_stage = {}
            grand = 0.0
            for (stage, cls, mdl), st in sorted(self._stats.items()):
                grand += st.total_ms
                p99 = st.p99()
                ex_ms, ex_tr = st.exemplar()
                rows.append({"engine_id": self.owner, "stage": stage,
                             "tenant_class": cls, "model": mdl,
                             "count": st.count,
                             "total_ms": round(st.total_ms, 3),
                             "mean_ms": round(st.total_ms
                                              / max(1, st.count), 3),
                             "p99_ms": (None if p99 is None
                                        else round(p99, 3)),
                             "exemplar": ex_tr})
                agg = by_stage.setdefault(
                    stage, {"stage": stage, "count": 0, "total_ms": 0.0,
                            "p99_ms": 0.0, "exemplar": None,
                            "_ex_ms": -1.0})
                agg["count"] += st.count
                agg["total_ms"] += st.total_ms
                if p99 is not None:
                    agg["p99_ms"] = max(agg["p99_ms"], p99)
                if ex_tr is not None and ex_ms > agg["_ex_ms"]:
                    agg["_ex_ms"] = ex_ms
                    agg["exemplar"] = ex_tr
            requests = self._requests
        ranked = sorted(by_stage.values(),
                        key=lambda r: -r["total_ms"])
        out_top = []
        for r in ranked[:top]:
            out_top.append({"stage": r["stage"], "count": r["count"],
                            "total_ms": round(r["total_ms"], 3),
                            "share": round(r["total_ms"] / grand, 4)
                            if grand > 0 else 0.0,
                            "p99_ms": round(r["p99_ms"], 3),
                            "exemplar": r["exemplar"]})
        return {"owner": self.owner, "enabled": enabled(),
                "requests": requests, "stages": rows, "top": out_top}


def merge_whyslow(parts, owner="fleet"):
    """Router fleet merge: engine ``/whyslow`` bodies -> one table.
    Rows concatenate (each already carries its ``engine_id``); the
    ``top`` ranking is recomputed across the fleet by share of total
    attributed time, keeping each stage's worst p99 and slowest
    exemplar."""
    rows, owners = [], []
    requests = 0
    by_stage = {}
    grand = 0.0
    for part in parts:
        if not part:
            continue
        owners.append(part.get("owner"))
        requests += part.get("requests") or 0
        part_rows = list(part.get("stages") or ())
        rows.extend(part_rows)
        # the fleet ranking is recomputed from the FULL per-stage rows
        # — each part's own "top" table is pre-truncated to its local
        # top-N, so ranking from those would hide a stage that is #4
        # on every engine but #1 fleet-wide and overstate shares. Fall
        # back to "top" only for parts that carry no stage rows.
        for t in part_rows or part.get("top") or ():
            agg = by_stage.setdefault(
                t["stage"], {"stage": t["stage"], "count": 0,
                             "total_ms": 0.0, "p99_ms": 0.0,
                             "exemplar": None, "_ex": -1.0})
            agg["count"] += t.get("count") or 0
            agg["total_ms"] += t.get("total_ms") or 0.0
            agg["p99_ms"] = max(agg["p99_ms"], t.get("p99_ms") or 0.0)
            grand += t.get("total_ms") or 0.0
            if t.get("exemplar") and (t.get("p99_ms") or 0.0) > agg["_ex"]:
                agg["_ex"] = t.get("p99_ms") or 0.0
                agg["exemplar"] = t["exemplar"]
    top = []
    for r in sorted(by_stage.values(), key=lambda r: -r["total_ms"]):
        top.append({"stage": r["stage"], "count": r["count"],
                    "total_ms": round(r["total_ms"], 3),
                    "share": round(r["total_ms"] / grand, 4)
                    if grand > 0 else 0.0,
                    "p99_ms": round(r["p99_ms"], 3),
                    "exemplar": r["exemplar"]})
    return {"owner": owner, "fleet": True, "engines": owners,
            "requests": requests, "stages": rows, "top": top}


# -- process-wide aggregator registry ---------------------------------------
_AGGS = {}


def aggregator(owner, registry=None):
    """Get-or-create the owner's :class:`StageBreakdown` (engines and
    routers each own one, keyed by their id — the same key the alert
    daemon's evaluator carries, so a firing page finds its table)."""
    with _lock:
        agg = _AGGS.get(str(owner))
        if agg is None:
            agg = _AGGS[str(owner)] = StageBreakdown(owner,
                                                     registry=registry)
        return agg


def get_aggregator(owner):
    """Peek (no create): None when the owner never observed a stage —
    the alert daemon's lookup must not mint families on a quiet
    process."""
    with _lock:
        return _AGGS.get(str(owner))


def top_stages_for(owner, top=None):
    """Alert-payload attachment: the owner's current top-stage rows
    (``[{stage, share, p99_ms, count, exemplar}, ...]``) or None when
    attribution has nothing — a page reads "p99 blown, 78% of it is
    wfq_wait" straight off this."""
    agg = get_aggregator(owner)
    if agg is None:
        return None
    snap = agg.snapshot(top=top)
    return snap["top"] or None


def reset():
    """Test hook: drop aggregators + cached gates/families."""
    global _families_cache, _enabled_cache
    with _lock:
        _AGGS.clear()
    _families_cache = None
    _enabled_cache = None
