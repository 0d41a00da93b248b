"""Serving observability: latency summaries, counters, cost ledger.

A port of ``mxnet_tpu/serving/metrics.py`` reduced to what the decode
engine uses: :class:`ServingStats` (request outcomes and stage
latencies), :class:`DecodeStats` (inter-token latency, TTFT, token
throughput, slot churn), :class:`CostLedger` (device seconds per
bucket, the per-request bills reconcile against it) and the exemplar
gate. Every family bridges onto this package's telemetry
:data:`~mxnet_tpu_torch.telemetry.registry.REGISTRY` with an
``engine_id`` label, as in the JAX package. The dispatch-wire
families are left for the slice that ports the wire.

Everything is thread-safe: client threads observe submit/reject
counters while the single worker thread observes step stats.
"""
from __future__ import annotations

import threading
from collections import deque

from .. import envvars
from ..telemetry import spans as _spans
from ..telemetry.registry import REGISTRY

__all__ = ["LatencySummary", "ServingStats", "CostLedger", "DecodeStats",
           "nearest_rank", "merge_cost_buckets", "exemplar_gate",
           "slow_exemplar"]


def exemplar_gate():
    """Resolve the latency-exemplar recording gate once per owner
    (engine/router construction): exemplars only make sense when the
    SLO engine runs AND spans are enabled — an exemplar whose trace
    tail sampling can never keep would be a dead link."""
    return bool(envvars.get("MXNET_TPU_SLO")
                and envvars.get("MXNET_TPU_SLO_EXEMPLARS")
                and _spans.enabled())


def slow_exemplar(trace_id, total_ms, gated):
    """The exemplar to attach to a total-latency observation: the
    request's trace id when the gate is open and the request is slow
    enough that tail sampling KEEPS its trace (same threshold), else
    None. The one place the exemplar↔retrievable-trace contract
    lives — engine and router both call it."""
    return (trace_id if gated and total_ms >= _spans.RECORDER.slow_ms
            else None)

# batch-size histogram boundaries (requests per dispatched batch)
_BATCH_REQ_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)


# inter-token latency boundaries (ms): steady-state decode iterations
# are model-forward-sized — finer than the default request buckets,
# coarser than the wire-overhead ones
_INTER_TOKEN_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                        500.0, 1000.0, 2500.0, 10000.0)


class DecodeStats:
    """Decode-loop observability bundle for one ``DecodeEngine`` —
    the token-level numbers the request-level :class:`ServingStats`
    has no axis for: inter-token latency (THE decode SLI — the default
    ``decode_inter_token`` LatencySLO judges its histogram), time to
    first token, generated-token throughput, and slot churn
    (join/leave events at iteration boundaries). KV-page occupancy
    lives on the pool's own gauges (``serving/kvcache.py``)."""

    def __init__(self, engine_id, window=4096, registry=None):
        reg = registry if registry is not None else REGISTRY
        self.engine_id = str(engine_id)
        self.window = window          # public: reset_stats reads this
        eid = self.engine_id
        self.inter_token_ms = LatencySummary(
            window, reg.histogram(
                "mxnet_tpu_serving_inter_token_latency_ms",
                "wall time between consecutive generated tokens of one "
                "sequence (the decode-path SLI), per engine",
                ("engine_id",), buckets=_INTER_TOKEN_BUCKETS)
            .labels(engine_id=eid))
        self.ttft_ms = LatencySummary(
            window, reg.histogram(
                "mxnet_tpu_serving_ttft_ms",
                "time to first token: submit to the prefill's first "
                "generated token, per engine", ("engine_id",))
            .labels(engine_id=eid))
        self._c_tokens = reg.counter(
            "mxnet_tpu_serving_decode_tokens_total",
            "generated tokens, per engine", ("engine_id",)) \
            .labels(engine_id=eid)
        self._c_iters = reg.counter(
            "mxnet_tpu_serving_decode_iterations_total",
            "decode-loop iterations dispatched, per engine",
            ("engine_id",)).labels(engine_id=eid)
        slot = reg.counter(
            "mxnet_tpu_serving_decode_slot_events_total",
            "decode-batch slot churn: sequences joining at an "
            "iteration boundary and leaving on EOS/max-tokens, per "
            "engine", ("engine_id", "event"))
        self._c_join = slot.labels(engine_id=eid, event="join")
        self._c_leave = slot.labels(engine_id=eid, event="leave")
        self._c_chunks = reg.counter(
            "mxnet_tpu_serving_decode_prefill_chunks_total",
            "chunked-prefill steps interleaved at decode iteration "
            "boundaries (rate vs decode_iterations_total = the share "
            "of loop turns spent prefilling), per engine",
            ("engine_id",)).labels(engine_id=eid)
        self._q_split = reg.gauge(
            "mxnet_tpu_serving_decode_queue_split",
            "decode scheduler population by phase: requests waiting "
            "for prefill vs sequences in the decode batch, per engine",
            ("engine_id", "phase"))
        self._lock = threading.Lock()
        self._tokens = 0
        self._iters = 0
        self._joins = 0
        self._leaves = 0
        self._slot_steps = 0      # rows dispatched across iterations
        self._active_steps = 0    # live rows among them (utilization)
        self._chunks = 0
        self._chunk_tokens = 0

    def set_split_fns(self, prefill_fn, decode_fn):
        """Wire the phase-split pull gauges (scrape-time reads)."""
        self._q_split.labels(engine_id=self.engine_id,
                             phase="prefill").set_function(prefill_fn)
        self._q_split.labels(engine_id=self.engine_id,
                             phase="decode").set_function(decode_fn)

    def observe_token(self, n=1):
        """One generated token (prefill's first token and every
        iteration token land here, at emission)."""
        with self._lock:
            self._tokens += n
        self._c_tokens.inc(n)

    def observe_iteration(self, rows, active):
        with self._lock:
            self._iters += 1
            self._slot_steps += rows
            self._active_steps += active
        self._c_iters.inc()

    def observe_join(self, n=1):
        with self._lock:
            self._joins += n
        self._c_join.inc(n)

    def observe_leave(self, n=1):
        with self._lock:
            self._leaves += n
        self._c_leave.inc(n)

    def observe_chunk(self, tokens):
        """One chunked-prefill step (``tokens`` real prompt tokens)
        interleaved at an iteration boundary."""
        with self._lock:
            self._chunks += 1
            self._chunk_tokens += tokens
        self._c_chunks.inc()

    def snapshot(self):
        with self._lock:
            out = {"tokens": self._tokens, "iterations": self._iters,
                   "joins": self._joins, "leaves": self._leaves,
                   "prefill_chunks": self._chunks,
                   "prefill_chunk_tokens": self._chunk_tokens,
                   "slot_utilization": (
                       round(self._active_steps / self._slot_steps, 4)
                       if self._slot_steps else None)}
        out["inter_token"] = self.inter_token_ms.snapshot()
        out["ttft"] = self.ttft_ms.snapshot()
        return out


def nearest_rank(sorted_xs, p):
    """Nearest-rank percentile of an ascending-sorted sample (None on
    empty) — THE percentile convention for every serving metric
    (engine-side summaries and the loadgen's client-observed numbers
    share it so the two can be compared directly)."""
    if not sorted_xs:
        return None
    rank = max(0, min(len(sorted_xs) - 1,
                      int(round(p / 100.0 * len(sorted_xs))) - 1))
    return sorted_xs[rank]


class LatencySummary:
    """Bounded-window latency aggregator (milliseconds).

    Keeps a ring of the most recent ``capacity`` observations for
    percentiles (a serving process runs forever; unbounded sample
    lists would not) plus running count/sum/max over the full
    lifetime. p50/p95/p99 therefore describe the recent window, count
    and mean the whole run — the usual server-metrics convention.

    ``hist`` (optional) is a telemetry histogram child co-observed on
    every sample, so the same numbers are scrapeable at /metrics.
    ``exemplar`` (a trace id) rides through to the histogram as an
    OpenMetrics exemplar — the machine link from a latency bucket back
    to a retrievable trace at ``/traces/<id>``.
    """

    def __init__(self, capacity=4096, hist=None):
        self._window = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._count = 0
        self._total = 0.0
        self._max = 0.0
        self._hist = hist

    def observe(self, ms, exemplar=None):
        with self._lock:
            self._window.append(float(ms))
            self._count += 1
            self._total += ms
            if ms > self._max:
                self._max = ms
        if self._hist is not None:
            self._hist.observe(ms, exemplar=exemplar)

    @property
    def count(self):
        return self._count

    def percentile(self, p):
        """Nearest-rank percentile over the recent window (None when
        nothing was observed)."""
        with self._lock:
            xs = sorted(self._window)
        return nearest_rank(xs, p)

    def snapshot(self):
        with self._lock:
            xs = sorted(self._window)
            count, total, mx = self._count, self._total, self._max
        if not xs:
            return {"count": 0}
        return {"count": count,
                "mean_ms": round(total / count, 3),
                "p50_ms": round(nearest_rank(xs, 50), 3),
                "p95_ms": round(nearest_rank(xs, 95), 3),
                "p99_ms": round(nearest_rank(xs, 99), 3),
                "max_ms": round(mx, 3)}


class CostLedger:
    """Per-bucket resource/cost accounting for one engine — what a
    request actually COSTS, not just how fast it was.

    Every dispatched batch lands in the row-length bucket it ran at,
    split by where the wall time went:

    - ``device_s``   — forward wall seconds of memory-hit batches (the
      steady-state serving cost);
    - ``compile_s``  — first-visit trace+compile wall seconds (live
      batches AND warmup replays — the amortizable startup cost);
    - ``warmup_s``   — memory-hit warmup forwards (dummy traffic; kept
      apart so device_s reconciles against real requests exactly);
    - ``request_s``  — the amortizable slice: seconds of batches that
      carried real requests (device or compile). The engine writes
      each member request's token-weighted share onto its
      ``InferenceFuture.cost``, so ``sum(per-request device_s) ==
      request_s`` by construction — the exactness contract
      tests/test_profiling.py pins and ``serve_loadgen`` cross-checks;
    - ``requests`` / ``valid_tokens`` / ``batches`` — the divisor side.

    The same numbers feed the ``mxnet_tpu_serving_cost_*`` registry
    families (engine-labeled, per the fleet contract) so Prometheus
    rates give fleet cost-per-1k-tokens live. The ledger is
    process-cumulative like registry counters: ``reset_stats`` swaps
    the stats WINDOW, never the ledger — scrapers diff ``/costs``
    between scrapes.
    """

    FIELDS = ("device_s", "compile_s", "warmup_s", "request_s")

    def __init__(self, engine_id, registry=None):
        reg = registry if registry is not None else REGISTRY
        self.engine_id = str(engine_id)
        self._lock = threading.Lock()
        self._buckets = {}      # bucket_len -> row dict
        self._sec = reg.counter(
            "mxnet_tpu_serving_cost_seconds_total",
            "accumulated serving wall seconds by row-length bucket and "
            "kind (device = memory-hit batch forward, compile = "
            "first-visit trace+compile, warmup = dummy warmup forward)",
            ("engine_id", "bucket", "kind"))
        self._req = reg.counter(
            "mxnet_tpu_serving_cost_requests_total",
            "requests whose device time was amortized into the cost "
            "ledger, by row-length bucket",
            ("engine_id", "bucket"))
        self._tok = reg.counter(
            "mxnet_tpu_serving_cost_tokens_total",
            "valid tokens cost-accounted, by row-length bucket",
            ("engine_id", "bucket"))

    def _row(self, bucket_len):
        row = self._buckets.get(bucket_len)
        if row is None:
            row = self._buckets.setdefault(
                bucket_len, {f: 0.0 for f in self.FIELDS}
                | {"requests": 0, "valid_tokens": 0, "batches": 0})
        return row

    def observe_batch(self, bucket_len, seconds, requests, valid_tokens,
                      compiled):
        """One LIVE dispatched batch: ``seconds`` is the batch's
        forward wall (including the compile on first visit)."""
        kind = "compile" if compiled else "device"
        with self._lock:
            row = self._row(bucket_len)
            row["compile_s" if compiled else "device_s"] += seconds
            if requests:
                row["request_s"] += seconds
            row["requests"] += requests
            row["valid_tokens"] += valid_tokens
            row["batches"] += 1
        self._sec.labels(engine_id=self.engine_id, bucket=bucket_len,
                         kind=kind).inc(seconds)
        if requests:
            self._req.labels(engine_id=self.engine_id,
                             bucket=bucket_len).inc(requests)
        if valid_tokens:
            self._tok.labels(engine_id=self.engine_id,
                             bucket=bucket_len).inc(valid_tokens)

    def observe_decode(self, rows_bucket, seconds, tokens, completed,
                       compiled):
        """One decode-loop iteration, keyed by the NEGATED rows bucket
        (decode batches have no row length; the sign keeps the decode
        key space disjoint from prefill prompt-length buckets even
        when ``max_rows`` overlaps a bucket value — ``-8`` reads as "a
        decode batch of 8 rows"). Every iteration carries live
        requests by construction, so its wall lands in ``request_s`` —
        the engine amortizes the same seconds across the member
        sequences' bills, keeping the sum(bills) == request_s
        exactness contract. ``completed`` counts the sequences that
        FINISHED this iteration (requests are counted once, at leave,
        not once per token)."""
        kind = "compile" if compiled else "device"
        with self._lock:
            row = self._row(rows_bucket)
            row["compile_s" if compiled else "device_s"] += seconds
            row["request_s"] += seconds
            row["requests"] += completed
            row["valid_tokens"] += tokens
            row["batches"] += 1
        self._sec.labels(engine_id=self.engine_id, bucket=rows_bucket,
                         kind=kind).inc(seconds)
        if completed:
            self._req.labels(engine_id=self.engine_id,
                             bucket=rows_bucket).inc(completed)
        if tokens:
            self._tok.labels(engine_id=self.engine_id,
                             bucket=rows_bucket).inc(tokens)

    def observe_warmup(self, bucket_len, seconds, compiled):
        """A dummy warmup forward (no requests): compile seconds count
        with the compiles, memory-hit replays stay in warmup_s."""
        kind = "compile" if compiled else "warmup"
        with self._lock:
            row = self._row(bucket_len)
            row["compile_s" if compiled else "warmup_s"] += seconds
            row["batches"] += 1
        self._sec.labels(engine_id=self.engine_id, bucket=bucket_len,
                         kind=kind).inc(seconds)

    @staticmethod
    def _derive(row):
        out = dict(row)
        for f in CostLedger.FIELDS:
            out[f] = round(out[f], 6)
        if out["requests"]:
            out["device_ms_per_request"] = round(
                out["request_s"] * 1e3 / out["requests"], 3)
        if out["valid_tokens"]:
            out["device_s_per_1k_tokens"] = round(
                out["request_s"] * 1e3 / out["valid_tokens"], 6)
        return out

    def table(self):
        """``{bucket_len(str): row}`` with derived per-request /
        per-1k-token rates — the ``/costs`` body."""
        with self._lock:
            rows = {str(b): dict(r)
                    for b, r in sorted(self._buckets.items())}
        return {b: self._derive(r) for b, r in rows.items()}

    def totals(self):
        """One row summed across buckets (the /stats `costs` line)."""
        with self._lock:
            rows = [dict(r) for r in self._buckets.values()]
        return self._derive(merge_cost_buckets(rows))


class CaptureCounters:
    """Graph-capture outcomes of an engine's forwards: the JAX engines'
    compile-cache counters (``mxnet_tpu_serving_compile_cache_total``,
    labels ``engine_id`` and ``result``). A forward that captured a
    CUDA graph (a hybridized model's first forward of a shape bucket)
    is a ``miss``, any other a ``memory_hit`` (a replay, or a model that
    captures nothing). ``persistent_hit`` stays 0 by design: a CUDA
    graph does not outlive its process, where the JAX package's
    executables can come back from its disk cache."""

    RESULTS = ("memory_hit", "persistent_hit", "miss")

    def __init__(self, engine_id, registry=None):
        reg = registry if registry is not None else REGISTRY
        family = reg.counter(
            "mxnet_tpu_serving_compile_cache_total",
            "per-shape graph cache outcomes at dispatch: memory_hit (a "
            "replay, or nothing to capture), persistent_hit (always 0: "
            "CUDA graphs do not outlive the process), miss (a capture)",
            ("engine_id", "result"))
        self._children = {r: family.labels(engine_id=engine_id, result=r)
                          for r in self.RESULTS}
        self._counts = {r: 0 for r in self.RESULTS}
        self._lock = threading.Lock()

    def observe(self, captured):
        """Count one forward; returns its result name."""
        result = "miss" if captured else "memory_hit"
        with self._lock:
            self._counts[result] += 1
        self._children[result].inc()
        return result

    def snapshot(self):
        with self._lock:
            return dict(self._counts)


def merge_cost_buckets(rows):
    """Sum cost-ledger rows field-by-field (a router folding N
    engines' buckets, or totals across buckets)."""
    out = {f: 0.0 for f in CostLedger.FIELDS} \
        | {"requests": 0, "valid_tokens": 0, "batches": 0}
    for row in rows:
        for f in CostLedger.FIELDS:
            out[f] += row.get(f, 0.0) or 0.0
        for f in ("requests", "valid_tokens", "batches"):
            out[f] += int(row.get(f, 0) or 0)
    return out


class ServingStats:
    """Counter/gauge/latency bundle for one :class:`ServingEngine`.

    Counters follow the admission-control outcomes one-to-one so a
    dashboard can account for every submitted request:
    ``submitted == completed + failed + rejected_* + expired +
    cancelled + in flight``.
    """

    COUNTERS = ("submitted", "completed", "failed", "rejected_queue_full",
                "rejected_too_long", "rejected_stopped",
                "rejected_unknown_model", "expired",
                "cancelled", "batches", "compiles")

    def __init__(self, window=4096, registry=None, engine_id="default"):
        reg = registry if registry is not None else REGISTRY
        self.window = window          # public: reset_stats reads this
        self.engine_id = str(engine_id)
        eid = self.engine_id
        self._lock = threading.Lock()
        self._c = {name: 0 for name in self.COUNTERS}
        # dispatched slot accounting for the aggregate packing number
        self._slots = 0
        self._valid_tokens = 0
        # registry bridge: children resolved ONCE here so the hot path
        # pays a dict lookup + locked add, never family bookkeeping
        req_total = reg.counter(
            "mxnet_tpu_serving_requests_total",
            "serving requests by admission/completion outcome, per engine",
            ("engine_id", "event"))
        self._reg_c = {name: req_total.labels(engine_id=eid, event=name)
                       for name in self.COUNTERS
                       if name not in ("batches", "compiles")}
        # not request outcomes — their own families keep the
        # requests_total label space reconcilable request-for-request
        self._reg_c["batches"] = reg.counter(
            "mxnet_tpu_serving_batches_total",
            "dispatched packed batches, per engine",
            ("engine_id",)).labels(engine_id=eid)
        self._reg_c["compiles"] = reg.counter(
            "mxnet_tpu_serving_compiles_total",
            "first-visit shape trace+compiles, per engine",
            ("engine_id",)).labels(engine_id=eid)
        lat = reg.histogram("mxnet_tpu_serving_latency_ms",
                            "serving latency by pipeline stage, per engine",
                            ("engine_id", "stage"))
        self.queue_ms = LatencySummary(
            window, lat.labels(engine_id=eid, stage="queue"))
        self.pack_ms = LatencySummary(
            window, lat.labels(engine_id=eid, stage="pack"))
        self.compute_ms = LatencySummary(
            window, lat.labels(engine_id=eid, stage="compute"))
        self.compile_ms = LatencySummary(
            window, lat.labels(engine_id=eid, stage="compile"))
        self.total_ms = LatencySummary(
            window, lat.labels(engine_id=eid, stage="total"))
        self.batch_requests = LatencySummary(
            window, reg.histogram("mxnet_tpu_serving_batch_requests",
                                  "requests per dispatched batch",
                                  ("engine_id",),
                                  buckets=_BATCH_REQ_BUCKETS)
            .labels(engine_id=eid))
        self._reg_batch_tokens = reg.counter(
            "mxnet_tpu_serving_batch_tokens_total",
            "valid tokens dispatched, by row-length bucket",
            ("engine_id", "bucket"))
        self._reg_batch_slots = reg.counter(
            "mxnet_tpu_serving_batch_slots_total",
            "padded slots dispatched, by row-length bucket",
            ("engine_id", "bucket"))
        self._reg_queue_depth = reg.gauge(
            "mxnet_tpu_serving_queue_depth",
            "requests waiting in the admission queue, per engine",
            ("engine_id",)).labels(engine_id=eid)
        self._queue_depth_fn = None
        self._last_batch = None

    def bump(self, name, n=1):
        with self._lock:
            self._c[name] += n
        self._reg_c[name].inc(n)

    def count(self, name):
        with self._lock:
            return self._c[name]

    def set_queue_depth_fn(self, fn):
        self._queue_depth_fn = fn
        # pull gauge: evaluated at scrape time, zero hot-path cost
        self._reg_queue_depth.set_function(fn)

    def observe_batch(self, rows, row_len, valid_tokens, n_requests,
                      bucket_len):
        with self._lock:
            self._c["batches"] += 1
            self._slots += rows * row_len
            self._valid_tokens += valid_tokens
            self._last_batch = {
                "rows": rows, "row_len": row_len, "requests": n_requests,
                "bucket_len": bucket_len,
                "packing_efficiency":
                    round(valid_tokens / float(rows * row_len), 4)}
        self._reg_c["batches"].inc()
        self._reg_batch_tokens.labels(
            engine_id=self.engine_id, bucket=bucket_len).inc(valid_tokens)
        self._reg_batch_slots.labels(
            engine_id=self.engine_id, bucket=bucket_len).inc(rows * row_len)
        self.batch_requests.observe(n_requests)

    def packing_efficiency(self):
        """Aggregate fraction of dispatched slots holding real tokens
        (dummy pad rows from row-count quantization included — the
        honest number the chip actually paid for)."""
        with self._lock:
            if not self._slots:
                return None
            return self._valid_tokens / float(self._slots)

    def snapshot(self):
        with self._lock:
            counters = dict(self._c)
            slots, valid = self._slots, self._valid_tokens
            last = dict(self._last_batch) if self._last_batch else None
        out = {"engine_id": self.engine_id,
               "counters": counters,
               "queue_depth": (self._queue_depth_fn()
                               if self._queue_depth_fn else None),
               "latency": {"queue": self.queue_ms.snapshot(),
                           "pack": self.pack_ms.snapshot(),
                           "compute": self.compute_ms.snapshot(),
                           "compile": self.compile_ms.snapshot(),
                           "total": self.total_ms.snapshot()},
               "dispatched_slots": slots,
               "valid_tokens": valid,
               "packing_efficiency":
                   round(valid / float(slots), 4) if slots else None,
               "last_batch": last}
        return out
