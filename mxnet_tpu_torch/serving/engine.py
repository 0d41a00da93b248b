"""In-process continuous-batching model server for encoder models.

``ServingEngine`` owns three pieces: a bounded :class:`RequestQueue`
(admission control), a :class:`ContinuousBatcher` (first-fit packing
into a closed set of shapes), and one worker thread running the
model's forward per packed batch, with iteration-level scheduling:
every batch is re-formed from whatever is queued the moment the
previous batch finishes, so a long request never convoys short ones
behind it.

The model contract is one callable::

    model(ids, token_types, valid_length, segment_ids, positions)
      -> (B, S, U) tensor             # or a tuple whose [0] is that

with every input an int32 tensor on the engine's device in the
``io/packing`` layout (``gluon.model_zoo.bert.bert_serving_entry``
adapts a ``BERTModel``).

PyTorch port of ``mxnet_tpu/serving/engine.py``: admission (queue
full, deadline, oversize, unknown model, WFQ eviction), the worker
loop, dispatch with per-request cost shares, span trees and stage
stamps, the three poolers, warmup, ``swap_model`` (without the shadow
gate), snapshot, ``reset_stats``, ``cost_table`` and
``scheduler_state``. The engine runs on ``device`` (``None`` is the
current CUDA device, and raises without one); its worker thread binds
that device, and each forward copies its output to the host once.
A hybridized model (``bert_serving_entry(..., hybridize=True)``)
captures one CUDA graph per (rows, row_len) shape bucket at its first
forward and replays it after: the JAX engine's compile-cache counters
count captures (``miss``) and replays (``memory_hit``), with the
``compile_begin``/``compile_end`` events around a first visit, and a
batch whose forward captured bills as a compile
(``metrics.CaptureCounters``; ``persistent_hit`` stays 0, since a graph
does not outlive its process). A forward captured if the worker
thread's capture count (``graphs.captures``) moved across it. Not ported yet: ``expose`` and the
wire listener, SLO and alerts, history, capture, the watchdog, the
incident/recorder/profiling hooks and ``warmup(manifest=)``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

import numpy as np
import torch

from .. import graphs
from ..context import resolve_device
from ..telemetry import attribution as _attribution
from ..telemetry import events as _events
from ..telemetry import spans as _spans
from ..telemetry.trace import trace_context as _trace_context
from . import tenancy
from .batcher import ContinuousBatcher, PackedPlan
from .metrics import (CaptureCounters, CostLedger, ServingStats,
                      exemplar_gate, slow_exemplar)
from .queue import (DeadlineExceededError, EngineStoppedError,
                    QueueFullError, Request, RequestQueue,
                    RequestTooLongError, ServingError, UnknownModelError)

__all__ = ["ServingEngine"]

_engine_seq = itertools.count()


def _zero():
    """A stopped engine's gauge reading."""
    return 0


def _join_trace_ids(requests, cap=16):
    """One contextvar value for a whole batch: the member requests'
    trace ids, comma-joined and capped; None for an empty batch."""
    ids = [r.trace_id for r in requests]
    if not ids:
        return None
    if len(ids) > cap:
        ids = ids[:cap] + [f"+{len(ids) - cap}more"]
    return ",".join(ids)


def _slice_tokens(seq_slice, request):
    """Default postprocess: the request's per-token outputs."""
    return seq_slice


def _mean_pool(seq_slice, request):
    return seq_slice.mean(axis=0)


def _cls_pool(seq_slice, request):
    return seq_slice[0]


_POOLERS = {"tokens": _slice_tokens, "mean": _mean_pool, "cls": _cls_pool}


class ServingEngine:
    """Continuous-batching server around one encoder forward.

    Parameters
    ----------
    model : callable or :class:`~.tenancy.ModelRegistry`
        The packed forward (see module docstring), or a registry of
        several; each batch runs the model its requests named
        (``submit(model_id=...)``), and ``swap_model`` replaces any
        entry live.
    device : where the plan's tensors are built and the model runs
        (``None`` = the current CUDA device; ``"cpu"`` for the CPU).
    bucket_lens : row-length buckets (ascending); a request longer
        than the last one is rejected at submit.
    max_rows : packed rows per dispatched batch (row counts are
        quantized to powers of two up to this).
    max_queue_depth : admission bound; a full queue sheds with
        :class:`QueueFullError`.
    default_deadline_ms : deadline of requests that bring none.
    batch_wait_ms : linger after the first drained request to let a
        batch fill (0 = pure continuous batching).
    pool : per-request output view: "tokens" (len, U), "mean" (U,),
        "cls" (U,), or a callable ``(seq_slice, request) -> result``.
    engine_id : label value of this engine's metric families.
    """

    def __init__(self, model, device=None, bucket_lens=(64, 256, 1024),
                 max_rows=8, max_queue_depth=256, default_deadline_ms=None,
                 batch_wait_ms=0.0, max_batch_requests=None, pool="tokens",
                 pad_value=0, stats_window=4096, engine_id=None):
        self._models = tenancy.ModelRegistry.of(model)
        self.engine_id = str(engine_id) if engine_id is not None \
            else f"e{os.getpid():x}-{next(_engine_seq)}"
        self.device = resolve_device(device)
        self._batcher = ContinuousBatcher(bucket_lens=bucket_lens,
                                          max_rows=max_rows,
                                          pad_value=pad_value)
        self._queue = RequestQueue(max_queue_depth)
        self._default_deadline_ms = default_deadline_ms
        self._batch_wait_s = batch_wait_ms / 1e3
        # a packed batch holds at most rows*row_len requests; the drain
        # cap just bounds per-iteration work
        self._max_batch_requests = (max_batch_requests
                                    or max_rows * self._batcher.max_len)
        self._pool = _POOLERS[pool] if isinstance(pool, str) else pool
        self.stats = ServingStats(stats_window, engine_id=self.engine_id)
        self.tenants = tenancy.TenantStats(self.engine_id)
        self._register_gauges()
        # per-bucket cost ledger, process-cumulative (reset_stats swaps
        # the stats window, never the ledger)
        self.costs = CostLedger(self.engine_id)
        self.captures = CaptureCounters(self.engine_id)
        # visited (model_id, rows, row_len) buckets: swap_model warms a
        # new version over the shapes its model has served
        self._seen_shapes = set()
        self._shapes_lock = threading.Lock()
        # serializes forwards: the worker dispatches live batches while
        # warmup()/swap_model() run forwards on the caller's thread
        self._forward_lock = threading.Lock()
        self._exemplars = exemplar_gate()
        self._worker = None
        self._abort = False
        self._started = False
        self._lock = threading.Lock()
        self._beat = time.monotonic()

    @property
    def models(self):
        """The engine's :class:`~.tenancy.ModelRegistry`."""
        return self._models

    # -- lifecycle ---------------------------------------------------------
    def start(self):
        with self._lock:
            if self._started:
                return self
            if self._queue.closed:
                raise EngineStoppedError("engine cannot be restarted")
            self._started = True
            self._beat = time.monotonic()
            self._worker = threading.Thread(target=self._run,
                                            name="mxnet_tpu_serving",
                                            daemon=True)
            self._worker.start()
        _events.emit("engine_start", engine_id=self.engine_id,
                     bucket_lens=list(self._batcher.bucket_lens),
                     max_rows=self._batcher.max_rows,
                     device=str(self.device))
        return self

    def stop(self, drain=True, timeout=None):
        """Shut down. ``drain=True`` finishes every queued/in-flight
        request first; ``drain=False`` fails them with
        :class:`EngineStoppedError` (counted ``cancelled``)."""
        _events.emit("engine_abort" if not drain else "engine_stop",
                     engine_id=self.engine_id, drain=drain)
        with self._lock:
            self._queue.close()
            if not drain:
                self._abort = True
            worker = self._worker
        timed_out = False
        if worker is not None:
            worker.join(timeout)
            timed_out = worker.is_alive()
        # requests still queued after the worker exited (stop before
        # start, abort racing submits, a hung worker) fail loudly
        for r in self._queue.drain_all():
            self.stats.bump("cancelled")
            r.span.end(error="cancelled: engine stopped")
            r.future.set_exception(
                EngineStoppedError("engine stopped before request ran"))
        self._register_gauges()
        if timed_out:
            raise ServingError("serving worker did not stop in time")

    def _register_gauges(self):
        """Set the scrape-time gauges: the queue depth and each tenant
        class's WFQ depth. Their functions hold the engine, so a
        stopped engine sets constants instead and is collected once
        dropped."""
        wfq = tenancy.wfq_depth_gauge()
        if self._queue.closed:
            self.stats.set_queue_depth_fn(_zero)
            for cls in tenancy.TENANT_CLASSES:
                wfq.labels(engine_id=self.engine_id,
                           tenant_class=cls).set_function(_zero)
            return
        self.stats.set_queue_depth_fn(lambda: len(self._queue))
        for cls in tenancy.TENANT_CLASSES:
            wfq.labels(engine_id=self.engine_id, tenant_class=cls) \
               .set_function(
                   lambda c=cls: self._queue.depths().get(c, 0))

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop(drain=True)
        return False

    @property
    def running(self):
        with self._lock:
            return (self._started and self._worker is not None
                    and self._worker.is_alive())

    # -- client surface ----------------------------------------------------
    def submit(self, tokens, token_types=None, deadline_ms=None,
               trace_id=None, parent_span_id=None, model_id=None,
               tenant=None, tenant_class=None):
        """Enqueue one request; returns an :class:`InferenceFuture`.
        Raises the admission errors directly (queue full, too long,
        stopped, unknown model) so callers can tell shedding from
        failure. ``trace_id``/``parent_span_id`` adopt an upstream
        trace; ``tenant``/``tenant_class`` attribute the request to an
        owner and its WFQ admission class."""
        if deadline_ms is None:
            deadline_ms = self._default_deadline_ms
        # validate first: a malformed request raises without touching a
        # counter, so submitted == the sum of the outcome counters
        req = Request(tokens, token_types, deadline_ms,
                      trace_id=trace_id, parent_span_id=parent_span_id,
                      tenant=tenant, tenant_class=tenant_class,
                      model_id=model_id)
        req.span.set_attr(engine=self.engine_id)
        self.stats.bump("submitted")
        try:
            req.model_id = self._models.resolve_id(req.model_id)
        except UnknownModelError:
            self.stats.bump("rejected_unknown_model")
            self.tenants.observe_event(
                req.tenant, req.tenant_class, str(model_id),
                "rejected_unknown_model")
            _events.emit("request_shed", reason="unknown_model",
                         engine_id=self.engine_id, model=str(model_id),
                         trace_id=req.trace_id, tokens=len(req))
            req.span.set_attr(shed="unknown_model").force_keep() \
               .end(error="shed: unknown_model")
            raise
        self.tenants.observe_event(req.tenant, req.tenant_class,
                                   req.model_id, "submitted")
        if not self._started or self._queue.closed:
            self.stats.bump("rejected_stopped")
            req.span.end(error="rejected: engine not running")
            raise EngineStoppedError("serving engine is not running")
        if len(req) > self._batcher.max_len:
            self.stats.bump("rejected_too_long")
            _events.emit("request_shed", reason="too_long",
                         engine_id=self.engine_id,
                         trace_id=req.trace_id, tokens=len(req))
            req.span.set_attr(shed="too_long").force_keep() \
               .end(error="shed: too_long")
            raise RequestTooLongError(
                f"request of {len(req)} tokens exceeds the largest row "
                f"bucket ({self._batcher.max_len})")
        try:
            victim = self._queue.put(req)
        except ServingError as e:
            full = not self._queue.closed
            reason = "queue_full" if full else "stopped"
            self.stats.bump("rejected_queue_full"
                            if full else "rejected_stopped")
            self.tenants.observe_event(
                req.tenant, req.tenant_class, req.model_id,
                "rejected_queue_full" if full else "rejected_stopped")
            _events.emit("request_shed", reason=reason,
                         engine_id=self.engine_id,
                         trace_id=req.trace_id, tokens=len(req))
            req.span.set_attr(shed=reason).force_keep() \
               .end(error=f"shed: {reason}")
            raise e
        if victim is not None:
            self._shed_victim(victim)
        return req.future

    def _shed_victim(self, victim):
        """Fail a request the WFQ queue evicted to admit a higher-class
        arrival under overload, loudly on every surface."""
        self.stats.bump("rejected_queue_full")
        self.tenants.observe_event(victim.tenant, victim.tenant_class,
                                   victim.model_id
                                   or self._models.default_id(),
                                   "shed")
        _events.emit("request_shed", reason="wfq_evicted",
                     engine_id=self.engine_id,
                     trace_id=victim.trace_id,
                     tenant_class=victim.tenant_class,
                     tokens=len(victim))
        victim.span.set_attr(shed="wfq_evicted").force_keep() \
              .end(error="shed: wfq_evicted")
        victim.future.set_exception(QueueFullError(
            f"shed by weighted-fair admission: queue full and a "
            f"higher class arrived (class {victim.tenant_class})"))

    def infer(self, tokens, token_types=None, deadline_ms=None,
              timeout=None):
        """Synchronous convenience: submit + wait."""
        return self.submit(tokens, token_types, deadline_ms).result(timeout)

    def warmup(self, shapes=None, model_id=None):
        """One dummy forward per (rows, row_len) shape the batcher can
        emit (or the given subset), ahead of traffic: builds the CUDA
        kernels and warms the allocator and cuBLAS for every shape."""
        if shapes is None:
            shapes = self._batcher.shape_universe()
        for rows, row_len in shapes:
            self._forward_shape(rows, row_len, model_id=model_id)
        return self

    def swap_model(self, model, model_id=None, version=None, shapes=None):
        """Cut ``model_id`` (None = the default model) over to ``model``
        with no lost request: the new fn first runs one forward per
        shape its model has served (or the given ``shapes``) on the
        caller's thread, then the registry flips atomically. A batch
        dispatched before the flip finishes on the old fn."""
        mid = self._models.resolve_id(model_id)
        if shapes is None:
            with self._shapes_lock:
                shapes = sorted((r, l) for m, r, l in self._seen_shapes
                                if m == mid)
        _events.emit("model_swap_begin", engine_id=self.engine_id,
                     model=mid, version=version, shapes=len(shapes))
        t0 = time.monotonic()
        for rows, row_len in shapes:
            self._forward_shape(rows, row_len, fn=model)
        old = self._models.swap(mid, model, version)
        _events.emit("model_swap", engine_id=self.engine_id, model=mid,
                     from_version=old,
                     to_version=self._models.versions().get(mid),
                     warmed_shapes=len(shapes),
                     ms=round((time.monotonic() - t0) * 1e3, 3))
        return self

    def reset_stats(self):
        """Swap in a fresh ServingStats: separates a warmup window from
        the measured one (the cost ledger keeps counting)."""
        self.stats = ServingStats(self.stats.window,
                                  engine_id=self.engine_id)
        self._register_gauges()
        return self

    def snapshot(self):
        """Stats dict: counters, queue depth, latency percentiles,
        packing efficiency (see ``metrics.ServingStats``)."""
        out = self.stats.snapshot()
        out["running"] = self.running
        out["bucket_lens"] = list(self._batcher.bucket_lens)
        out["max_rows"] = self._batcher.max_rows
        out["seconds_since_beat"] = round(time.monotonic() - self._beat, 3)
        with self._shapes_lock:
            out["visited_shapes"] = len(self._seen_shapes)
        out["compile_cache"] = self.captures.snapshot()
        out["device"] = str(self.device)
        out["costs"] = self.costs.totals()
        out["models"] = self._models.versions()
        out["queue_classes"] = self._queue.depths()
        out["tenants"] = self.tenants.bills()
        return out

    def scheduler_state(self):
        """The WFQ per-class queue split and the hosted model
        versions: what was queued for whom."""
        return {"engine_id": self.engine_id,
                "queue_classes": self._queue.depths(),
                "queue_depth": len(self._queue),
                "models": self._models.versions()}

    def cost_table(self):
        """This engine's per-bucket cost ledger (device seconds,
        requests, valid tokens, derived per-request and per-1k-token
        rates) plus the cross-bucket totals."""
        return {"engine_id": self.engine_id,
                "buckets": self.costs.table(),
                "totals": self.costs.totals()}

    # -- worker ------------------------------------------------------------
    def _run(self):
        # the worker launches the device work: bind the engine's device
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        carry = []
        while True:
            self._beat = time.monotonic()
            if self._abort:
                self._fail(carry, EngineStoppedError(
                    "engine stopped before request ran"), "cancelled")
                return
            drained = self._queue.poll(
                self._max_batch_requests - len(carry),
                timeout=0.0 if carry else 0.05)
            if drained and self._batch_wait_s > 0 \
                    and len(carry) + len(drained) < self._max_batch_requests:
                time.sleep(self._batch_wait_s)   # linger for the batch
                drained += self._queue.poll(
                    self._max_batch_requests - len(carry) - len(drained))
            reqs = carry + drained
            carry = []
            if not reqs:
                if self._queue.closed and not len(self._queue):
                    return                       # clean drain complete
                continue
            now = time.monotonic()
            live = []
            for r in reqs:
                if r.expired(now):
                    self.stats.bump("expired")
                    self.tenants.observe_event(
                        r.tenant, r.tenant_class,
                        r.model_id or self._models.default_id(),
                        "expired")
                    _events.emit("request_expired", trace_id=r.trace_id,
                                 waited_ms=round((now - r.t_submit) * 1e3,
                                                 3))
                    self._queue_span(r)
                    r.span.end(error="deadline exceeded before dispatch")
                    r.future.set_exception(DeadlineExceededError(
                        f"request {r.id} deadline exceeded before "
                        "dispatch"))
                else:
                    live.append(r)
            if not live:
                continue
            # one packed batch per model, in first-arrival order (the
            # WFQ drain order is kept within each group)
            groups, index = [], {}
            for r in live:
                mid = r.model_id or self._models.default_id()
                if mid not in index:
                    index[mid] = len(groups)
                    groups.append((mid, []))
                groups[index[mid]][1].append(r)
            for mid, members in groups:
                try:
                    t0 = time.perf_counter()
                    with _trace_context(_join_trace_ids(members)):
                        plan, leftover = self._batcher.plan(members)
                    carry.extend(leftover)
                    pack_t1 = time.perf_counter()
                    self.stats.pack_ms.observe((pack_t1 - t0) * 1e3)
                except Exception as e:  # packing failure: fail the group
                    self._fail(members, e, "failed")
                    continue
                try:
                    self._dispatch(plan, model_id=mid,
                                   pack_interval=(t0, pack_t1))
                except Exception as e:
                    # a model failure fails ONLY the dispatched batch's
                    # unfinished requests; the carry gets its turn next
                    self._fail([r for r, _ in plan.entries
                                if not r.future.done()], e, "failed")

    def _fail(self, requests, exc, counter):
        for r in requests:
            self.stats.bump(counter)
            self.tenants.observe_event(
                r.tenant, r.tenant_class,
                r.model_id or self._models.default_id(), counter)
            r.span.end(error=repr(exc))
            r.future.set_exception(exc)

    def _queue_span(self, req):
        """Synthesized queue-wait child span (submit -> drain)."""
        if req.t_drain is not None and req.span.span_id is not None:
            _spans.record_span("serving/queue", req.trace_id,
                               parent_id=req.span.span_id,
                               mono_start=req.t_submit,
                               mono_end=req.t_drain,
                               attrs={"engine": self.engine_id})

    def _counted_forward(self, plan, fn, shape):
        """The forward, with the compile events around a first visit of
        ``shape`` and the capture counters; returns (output, t0, t1,
        whether it captured)."""
        with self._shapes_lock:
            first = shape is not None and shape not in self._seen_shapes
        if first:
            _events.emit("compile_begin", engine_id=self.engine_id,
                         shape=list(shape[1:]))
        before = graphs.captures()
        t0 = time.perf_counter()
        seq = self._forward(plan, fn)
        t1 = time.perf_counter()
        captured = graphs.captures() != before
        result = self.captures.observe(captured)
        if captured:
            self.stats.bump("compiles")
            self.stats.compile_ms.observe((t1 - t0) * 1e3)
        if first:
            _events.emit("compile_end", engine_id=self.engine_id,
                         shape=list(shape[1:]), result=result,
                         ms=round((t1 - t0) * 1e3, 3))
        return seq, t0, t1, captured

    def _dispatch(self, plan, model_id=None, pack_interval=None):
        mid, fn = self._models.resolve(model_id)
        shape = (mid, plan.rows, plan.row_len)
        seq, t0, t1, captured = self._counted_forward(plan, fn, shape)
        dt_s = t1 - t0
        dt_ms = dt_s * 1e3
        with self._shapes_lock:
            self._seen_shapes.add(shape)
        if not captured:
            self.stats.compute_ms.observe(dt_ms)
        self.costs.observe_batch(plan.row_len, dt_s, len(plan.entries),
                                 plan.valid_tokens, compiled=captured)
        self.stats.observe_batch(plan.rows, plan.row_len,
                                 plan.valid_tokens, len(plan.entries),
                                 plan.row_len)
        # one event per batch: every served request's trace id is
        # findable in the event log without per-request lines
        _events.emit("batch_dispatch", engine_id=self.engine_id,
                     model=mid, rows=plan.rows,
                     row_len=plan.row_len, requests=len(plan.entries),
                     valid_tokens=plan.valid_tokens, ms=round(dt_ms, 3),
                     trace_ids=[r.trace_id for r, _ in plan.entries])
        now = time.monotonic()
        fwd_attrs = {"rows": plan.rows, "row_len": plan.row_len,
                     "requests": len(plan.entries),
                     "engine": self.engine_id}
        for req, pl in plan.entries:
            # the batch's forward wall split by token share rides the
            # future; the shares sum to the batch time exactly
            share = (pl.length / plan.valid_tokens
                     if plan.valid_tokens else 0.0)
            req.future.cost = {"engine_id": self.engine_id,
                               "bucket": plan.row_len,
                               "model": mid,
                               "tenant": req.tenant,
                               "tenant_class": req.tenant_class,
                               "device_s": dt_s * share,
                               "compiled": captured,
                               "tokens": pl.length,
                               "batch_requests": len(plan.entries)}
            self.tenants.observe_cost(req.tenant, req.tenant_class,
                                      mid, dt_s * share, pl.length)
            record_spans = req.span.span_id is not None
            if record_spans:
                self._queue_span(req)
                if pack_interval is not None:
                    _spans.record_span(
                        "serving/pack", req.trace_id,
                        parent_id=req.span.span_id,
                        start_us=int(pack_interval[0] * 1e6),
                        end_us=int(pack_interval[1] * 1e6),
                        attrs={"engine": self.engine_id})
                _spans.record_span("serving/compile" if captured
                                   else "serving/forward", req.trace_id,
                                   parent_id=req.span.span_id,
                                   start_us=int(t0 * 1e6),
                                   end_us=int(t1 * 1e6),
                                   attrs=fwd_attrs)
            # stage stamps for the critical-path breakdown; pack and
            # forward were timed on perf_counter, stamps are monotonic
            if req.stages is not None:
                if pack_interval is not None:
                    _attribution.stamp(
                        req, "pack",
                        _spans.perf_to_mono(pack_interval[0]),
                        _spans.perf_to_mono(pack_interval[1]),
                        span=False)
                _attribution.stamp(req, "compile" if captured else "compute",
                                   _spans.perf_to_mono(t0),
                                   _spans.perf_to_mono(t1), span=False)
            try:
                out = self._pool(
                    seq[pl.row, pl.offset:pl.offset + pl.length], req)
            except Exception as e:  # a bad pool callable fails ITS
                # request, not the rest of the batch
                self.stats.bump("failed")
                req.span.end(error=repr(e))
                req.future.set_exception(e)
                continue
            req.t_done = now
            self.stats.queue_ms.observe((req.t_drain - req.t_submit) * 1e3)
            total_ms = (now - req.t_submit) * 1e3
            self.stats.total_ms.observe(
                total_ms, exemplar=slow_exemplar(
                    req.trace_id, total_ms, self._exemplars))
            self.stats.bump("completed")
            self.tenants.observe_event(req.tenant, req.tenant_class,
                                       mid, "completed")
            self.tenants.observe_latency(req.tenant, req.tenant_class,
                                         mid, total_ms)
            if record_spans:
                _spans.record_span("serving/complete", req.trace_id,
                                   parent_id=req.span.span_id,
                                   start_us=int(t1 * 1e6),
                                   attrs={"engine": self.engine_id})
            if req.stages is not None:
                breakdown = _attribution.breakdown_from_stamps(
                    req.stages, req.t_submit, now,
                    trace_id=req.trace_id)
                req.future.breakdown = breakdown
                _attribution.aggregator(self.engine_id).observe(
                    breakdown, tenant_class=req.tenant_class,
                    model=mid, trace_id=req.trace_id)
            req.span.end()
            req.future.set_result(out)

    def _forward(self, plan, fn):
        """The plan's arrays as int32 tensors on the engine's device,
        the model under ``inference_mode``, and ONE copy of the output
        to the host (per-request slicing follows there)."""
        dev = self.device
        ids, tt, vl, seg, pos = (
            torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
            for a in (plan.data, plan.token_types, plan.valid_length,
                      plan.segment_ids, plan.positions))
        with self._forward_lock, torch.inference_mode():
            with _trace_context(
                    _join_trace_ids(r for r, _ in plan.entries)):
                out = fn(ids, tt, vl, seg, pos)
            if isinstance(out, (list, tuple)):
                out = out[0]
            return out.float().cpu().numpy()

    def _forward_shape(self, rows, row_len, model_id=None, fn=None):
        """One dummy forward at (rows, row_len), for warmup (the
        model's own fn) and for swap_model's warm replay (an explicit
        ``fn``, not yet in the registry, whose shapes are not marked
        seen). Billed to the ledger as warmup."""
        data = np.zeros((rows, row_len), np.int32)
        seg = np.zeros((rows, row_len), np.int32)
        seg[:, 0] = 1
        plan = PackedPlan(data, np.zeros_like(data), seg,
                          np.zeros_like(data), np.ones(rows, np.int32),
                          entries=[], pad_rows=rows)
        mid = None
        if fn is None:
            mid, fn = self._models.resolve(model_id)
        _, t0, t1, captured = self._counted_forward(
            plan, fn, None if mid is None else (mid, rows, row_len))
        self.costs.observe_warmup(row_len, t1 - t0, compiled=captured)
        if mid is not None:
            with self._shapes_lock:
                self._seen_shapes.add((mid, rows, row_len))
