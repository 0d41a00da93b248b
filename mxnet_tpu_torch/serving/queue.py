"""Request queue with admission control for the serving engine.

Admission is where a server earns the right to stay up under heavy
traffic: the queue is BOUNDED (a full queue raises
:class:`QueueFullError` to the caller — backpressure, never unbounded
growth), every request can carry a deadline (expired requests are
rejected with :class:`DeadlineExceededError`, a DISTINCT error, not a
silent drop), and close() fails fast instead of accepting work that
will never run. The reference lineage is MXNet Model Server's bounded
job queue in front of its backend workers.

Since the tenancy subsystem (``serving/tenancy.py``) the queue is
CLASS-AWARE: every request lands in its admission class's deque
(``priority``/``standard``/``best-effort``) and ``poll`` dequeues in
weighted-fair order — each class ``c`` owns a virtual finish time
``vft[c]``; the pop takes the backlogged class with the smallest
``vft`` (ties break toward higher priority) and advances it by
``1/weight[c]``, so sustained contention shares dequeues
weight-proportionally while any lone class runs at full rate. A class
waking from idle catches its ``vft`` up to the queue's virtual time
so it cannot claim a retroactive backlog. Under overload, ``put``
prefers EVICTING the newest request of a lower class over refusing
the arrival (best-effort sheds first, priority last); the evicted
request is returned to the caller, who fails its future loudly. A
single-class workload reduces to the exact pre-tenancy bounded FIFO.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError
from ..telemetry import attribution as _attribution
from ..telemetry import events as _events
from ..telemetry import spans as _spans
from ..telemetry.trace import new_trace_id
from . import tenancy
from .tenancy import UnknownModelError

__all__ = ["ServingError", "QueueFullError", "DeadlineExceededError",
           "RequestTooLongError", "EngineStoppedError",
           "InvalidSamplingError", "UnknownModelError", "InferenceFuture",
           "Request", "RequestQueue", "validate_tokens",
           "validate_sampling"]


class ServingError(MXNetError):
    """Base class for serving-layer failures."""


class QueueFullError(ServingError):
    """Admission refused: the request queue is at max depth
    (backpressure — retry later or shed upstream)."""


class DeadlineExceededError(ServingError):
    """The request's deadline passed before compute finished."""


class RequestTooLongError(ServingError):
    """The request does not fit the largest configured row bucket."""


class EngineStoppedError(ServingError):
    """The engine is stopped (or stopping) and admits no new work."""


class InvalidSamplingError(ServingError):
    """The request's sampling parameters are out of range — refused at
    admission (HTTP 400 / wire error frame), never inside the compiled
    step where a bad ``top_p`` would surface as NaN tokens."""


class InferenceFuture:
    """Single-assignment result slot handed back by ``submit``.

    Minimal on purpose (stdlib ``concurrent.futures.Future`` drags in
    executor/cancel semantics the engine doesn't have): ``result``
    blocks until the worker fulfils it, re-raising the request's
    failure (deadline, shutdown, model error) in the CALLER's thread.

    ``cost`` is the request's amortized bill, written by the engine at
    dispatch (and forwarded by the router across processes): a dict of
    ``engine_id``, row-length ``bucket``, token-share ``device_s`` of
    the batch forward, ``compiled`` (first-visit batch), ``tokens``
    and ``batch_requests`` — None until dispatched (sheds and
    pre-dispatch expiries never ran, so they cost nothing).

    STREAMING: a decode request's future also carries the token
    stream. The engine (or the router/wire relaying for a remote one)
    delivers each generated token with :meth:`push_part`; consumers
    either iterate :meth:`stream` (blocking generator — the client
    shape) or register :meth:`add_part_callback` (the relay shape:
    wire listeners and routers forward parts without a thread per
    request). Parts are ADVISORY latency signal — ``result()`` always
    returns the complete, authoritative output, so a consumer that
    lost parts (killed connection) misses nothing by waiting for the
    final result instead.
    """

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None
        self._lock = threading.Lock()
        # one condition over the same lock wakes stream() readers on
        # both new parts and completion
        self._parts_cv = threading.Condition(self._lock)
        self._callbacks = []
        self._parts = []
        # part-callback entries are [fn, cursor] pairs: deliveries are
        # driven by a SINGLE drainer at a time (the _part_draining
        # flag), so every callback sees parts strictly in order even
        # when a registration's replay races fresh pushes from the
        # engine worker — and no lock is ever held across a callback
        self._part_callbacks = []
        self._part_draining = False
        self.cost = None
        # critical-path decomposition of the request's wall time
        # (telemetry.attribution), written by the engine at completion
        # and relayed by router/wire exactly like cost — None until
        # finished (or when attribution is off)
        self.breakdown = None

    def done(self):
        return self._event.is_set()

    def _finish(self, value, exc):
        # first write wins: a batch-failure sweep arriving after a
        # request was already fulfilled must not clobber its result.
        # Callbacks are SNAPSHOT under the lock and invoked OUTSIDE it:
        # a done-callback may block, take other locks, or reentrantly
        # submit/resolve — under the future's lock any of those
        # deadlocks the completing thread (the engine worker) against
        # every other waiter. tools/mxlint's lock-callback rule pins
        # this shape.
        with self._lock:
            if self._event.is_set():
                return
            self._value = value
            self._exc = exc
            self._event.set()
            callbacks, self._callbacks = self._callbacks, []
            self._part_callbacks = []
            self._parts_cv.notify_all()
        for cb in callbacks:
            self._run_callback(cb)

    def _run_callback(self, cb):
        try:
            cb(self)
        except Exception as e:
            # a broken observer must not lose the result — but it must
            # not vanish either (thread-hygiene contract)
            _events.emit("future_callback_error",
                         trace_id=getattr(self, "trace_id", None),
                         error=repr(e))

    def set_result(self, value):
        self._finish(value, None)

    def set_exception(self, exc):
        self._finish(None, exc)

    def add_done_callback(self, fn):
        """Call ``fn(self)`` once the future resolves (immediately when
        it already has) — the router's completion hook. ``fn`` runs
        OUTSIDE the future's lock (it may reenter submit); exceptions
        are swallowed after leaving a ``future_callback_error`` event."""
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(fn)
                return
        self._run_callback(fn)

    # -- streaming (decode token parts) ------------------------------------
    def _drain_parts(self):
        """Deliver pending parts to registered part callbacks, in
        order, from exactly ONE thread at a time. Callers must have
        set ``_part_draining`` under the lock before calling; the
        drain releases it when no work remains. Callbacks run OUTSIDE
        the lock (same contract as done-callbacks); the single-drainer
        discipline is what keeps a registration's replay from racing a
        fresh push into out-of-order delivery."""
        while True:
            with self._lock:
                work = []
                for entry in self._part_callbacks:
                    cur = entry[1]
                    if cur < len(self._parts):
                        work.append((entry[0], self._parts[cur]))
                        entry[1] = cur + 1
                if not work:
                    self._part_draining = False
                    return
            for fn, part in work:
                try:
                    fn(self, part)
                except Exception as e:
                    _events.emit("future_callback_error",
                                 trace_id=getattr(self, "trace_id",
                                                  None),
                                 error=repr(e))

    def push_part(self, part):
        """Deliver one streamed partial (a generated-token dict).
        Returns False once the future is resolved — late parts from a
        racing completion are dropped, never delivered out of order
        after the final result."""
        with self._lock:
            if self._event.is_set():
                return False
            self._parts.append(part)
            self._parts_cv.notify_all()
            if self._part_draining or not self._part_callbacks:
                return True
            self._part_draining = True
        self._drain_parts()
        return True

    def add_part_callback(self, fn):
        """Call ``fn(self, part)`` for every streamed part — parts
        already received are replayed first (even on a resolved
        future: a relay attached late misses nothing), and replay vs
        concurrent pushes stays strictly ordered (the single-drainer
        discipline above)."""
        with self._lock:
            self._part_callbacks.append([fn, 0])
            if self._part_draining:
                return              # the active drainer picks it up
            self._part_draining = True
        self._drain_parts()

    def parts(self):
        """Snapshot of the parts received so far."""
        with self._lock:
            return list(self._parts)

    def stream(self, timeout=None):
        """Blocking generator over the token parts, ending when the
        future resolves. ``timeout`` bounds each WAIT for the next
        part (inter-token patience), not the whole stream. The
        request's failure — deadline, shutdown, model error — re-
        raises after the received parts have been yielded, exactly as
        ``result()`` would raise it."""
        i = 0
        while True:
            with self._parts_cv:
                while i >= len(self._parts) and not self._event.is_set():
                    if not self._parts_cv.wait(timeout):
                        raise TimeoutError(
                            "no decode token within the stream timeout")
                if i < len(self._parts):
                    part = self._parts[i]
                    i += 1
                else:
                    break               # resolved and fully drained
            yield part
        if self._exc is not None:
            raise self._exc

    def exception(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        return self._exc

    def result(self, timeout=None):
        if not self._event.wait(timeout):
            raise TimeoutError("inference result not ready")
        if self._exc is not None:
            raise self._exc
        return self._value


_req_ids = itertools.count()


def validate_tokens(tokens, token_types):
    """Shared admission validation (engine Request AND router
    RouterRequest): int32-flatten tokens, reject empty, shape-match
    token_types. Returns the normalized ``(tokens, token_types)``."""
    tokens = np.asarray(tokens, np.int32).reshape(-1)
    if tokens.size == 0:
        raise ValueError("empty request")
    if token_types is not None:
        token_types = np.asarray(token_types, np.int32).reshape(-1)
        if token_types.shape != tokens.shape:
            raise ValueError(
                f"token_types length {token_types.size} != tokens "
                f"length {tokens.size}")
    return tokens, token_types


def validate_sampling(temperature=None, top_k=None, top_p=None,
                      seed=None):
    """Shared sampling-parameter admission validation (decode engine
    submit, wire SUBMIT, HTTP ``/submit``, router): range-check and
    normalize, raising :class:`InvalidSamplingError` up front so a bad
    request is a typed 4xx, not a NaN inside the compiled step.
    Returns ``(temperature, top_k, top_p, seed)`` with Nones preserved
    (None means "engine default")."""
    if temperature is not None:
        try:
            temperature = float(temperature)
        except (TypeError, ValueError):
            raise InvalidSamplingError(
                f"temperature must be a number, got {temperature!r}")
        if not np.isfinite(temperature) or temperature < 0.0:
            raise InvalidSamplingError(
                f"temperature must be finite and >= 0, got "
                f"{temperature}")
    if top_k is not None:
        try:
            ok = float(top_k) == int(top_k)
        except (TypeError, ValueError):
            ok = False
        if not ok or int(top_k) < 0:
            raise InvalidSamplingError(
                f"top_k must be an integer >= 0, got {top_k!r}")
        top_k = int(top_k)
    if top_p is not None:
        try:
            top_p = float(top_p)
        except (TypeError, ValueError):
            raise InvalidSamplingError(
                f"top_p must be a number, got {top_p!r}")
        if not np.isfinite(top_p) or not 0.0 < top_p <= 1.0:
            raise InvalidSamplingError(
                f"top_p must be in (0, 1], got {top_p}")
    if seed is not None:
        try:
            ok = float(seed) == int(seed)
        except (TypeError, ValueError):
            ok = False
        if not ok:
            raise InvalidSamplingError(
                f"seed must be an integer, got {seed!r}")
        seed = int(seed) & 0x7FFFFFFF
    return temperature, top_k, top_p, seed


class Request:
    """One queued inference request and its timing breadcrumbs.

    ``trace_id`` is the request's cross-layer identity: minted here (at
    submit time), it follows the request through queue→batcher→dispatch
    via the telemetry contextvar, gets stamped into profiler
    Chrome-trace/xprof spans, and names the request in the structured
    event log — ``id`` stays the cheap in-process ordinal.

    ``span`` is the request's ROOT span (``serving/request``): started
    here, ended by the engine at complete/fail/shed — its duration is
    the tail-sampling input, so only slow/errored/shed requests retain
    their full queue→pack→forward span trees.

    A fronting :class:`~.router.ServingRouter` passes its own
    ``trace_id`` and root-span id down so the engine-side tree parents
    under the router's ``router/request`` span — the same frame-carried
    ``(trace_id, span_id)`` crossing the dist_async wire uses (the
    parent may live in ANOTHER process; ``local_root=True`` keeps the
    engine's tail-sampling decision local either way).
    """

    __slots__ = ("id", "trace_id", "span", "tokens", "token_types",
                 "deadline", "future", "t_submit", "t_drain",
                 "t_dispatch", "t_done", "tenant", "tenant_class",
                 "model_id", "stages", "t_activity", "t_defer",
                 "defers")

    def __init__(self, tokens, token_types=None, deadline_ms=None,
                 trace_id=None, parent_span_id=None, tenant=None,
                 tenant_class=None, model_id=None):
        self.id = next(_req_ids)
        self.trace_id = trace_id or new_trace_id("req")
        self.tokens, self.token_types = validate_tokens(tokens,
                                                        token_types)
        self.tenant = str(tenant) if tenant is not None else None
        self.tenant_class = tenancy.normalize_class(tenant_class)
        self.model_id = str(model_id) if model_id is not None else None
        if deadline_ms is None:
            # per-class deadline budget: under overload, expiry then
            # consumes the short-budget (best-effort) classes first
            deadline_ms = tenancy.class_deadline_ms().get(
                self.tenant_class)
        self.t_submit = time.monotonic()
        self.span = _spans.start_span(
            "serving/request", trace_id=self.trace_id,
            parent_id=parent_span_id,
            attrs={"tokens": int(self.tokens.size)}, local_root=True)
        self.deadline = (self.t_submit + deadline_ms / 1e3
                         if deadline_ms is not None else None)
        self.future = InferenceFuture()
        # clients hold only the future; mirror the id there so caller
        # logs can name the request the server's telemetry names
        self.future.trace_id = self.trace_id
        self.t_drain = self.t_dispatch = self.t_done = None
        # stage-attribution breadcrumbs (telemetry.attribution.stamp):
        # (stage, t0, t1) monotonic tuples; None = attribution off, the
        # whole subsystem then costs one attribute check per stamp site
        self.stages = [] if _attribution.enabled() else None
        self.t_activity = None      # end of the last stamped stage
        self.t_defer = None         # first KV page-exhaustion defer
        self.defers = 0

    def __len__(self):
        return int(self.tokens.size)

    def expired(self, now=None):
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)


class RequestQueue:
    """Thread-safe bounded admission queue the continuous batcher
    drains in weighted-fair class order.

    ``put`` never blocks and never grows past ``max_depth``; under
    overload it sheds DOWNWARD — a higher-class arrival evicts the
    newest request of the lowest backlogged class below it (returned
    to the caller to fail loudly), and only an arrival with nobody
    beneath it eats :class:`QueueFullError` (that IS the flow
    control). Per-class depth budgets (fractions of ``max_depth``)
    bound each class before the global bound is even reached.
    ``poll`` is the iteration-level drain: wait up to ``timeout`` for
    the queue to become non-empty, then take everything available (up
    to ``max_items``) WITHOUT waiting for stragglers — the Orca-style
    continuous-batching discipline (batch what is there, never hold a
    batch open for latecomers) — in WFQ order, so the batcher's
    first-fit packing draws weight-proportionally from the classes.

    The WFQ state machine is deliberately deterministic (no wall
    clock): ``vft[c]`` floats advanced by exact ``1/weight`` steps,
    ties broken by class priority — tests/test_tenancy.py pins exact
    dequeue orders as goldens.
    """

    def __init__(self, max_depth=256, class_weights=None,
                 depth_shares=None):
        if max_depth < 1:
            raise ValueError("max_depth must be >= 1")
        self._max_depth = max_depth
        weights = dict(class_weights if class_weights is not None
                       else tenancy.class_weights())
        shares = dict(depth_shares if depth_shares is not None
                      else tenancy.class_depth_shares())
        self._weights = {c: float(weights.get(c, 1.0))
                         for c in tenancy.TENANT_CLASSES}
        self._budget = {
            c: max(1, int(round(max_depth * float(shares.get(c, 1.0)))))
            for c in tenancy.TENANT_CLASSES}
        self._dqs = {c: deque() for c in tenancy.TENANT_CLASSES}
        self._vft = {c: 0.0 for c in tenancy.TENANT_CLASSES}
        self._vtime = 0.0
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def __len__(self):
        with self._lock:
            return sum(len(dq) for dq in self._dqs.values())

    @property
    def max_depth(self):
        return self._max_depth

    @property
    def closed(self):
        with self._lock:
            return self._closed

    def depths(self):
        """Per-class queue depth ``{class: n}`` — the WFQ split the
        ``/stats`` body, flight-bundle scheduler sections and the
        ``mxnet_tpu_serving_wfq_queue_depth`` gauge expose."""
        with self._lock:
            return {c: len(dq) for c, dq in self._dqs.items()}

    def _class_of(self, request):
        cls = getattr(request, "tenant_class", None)
        return cls if cls in self._dqs else "standard"

    def _evict_locked(self, above):
        """Pop the NEWEST request of the lowest-priority backlogged
        class strictly below ``above`` (None when nothing beneath it
        can be shed)."""
        idx = tenancy.TENANT_CLASSES.index(above)
        for cls in reversed(tenancy.TENANT_CLASSES[idx + 1:]):
            if self._dqs[cls]:
                return self._dqs[cls].pop()
        return None

    def put(self, request):
        """Admit ``request``; returns the lower-class victim it
        EVICTED under overload (None normally) — the caller fails the
        victim's future and counts the shed."""
        with self._lock:
            if self._closed:
                raise EngineStoppedError(
                    "serving engine is stopped; request refused")
            cls = self._class_of(request)
            dq = self._dqs[cls]
            if len(dq) >= self._budget[cls]:
                raise QueueFullError(
                    f"request queue full for class {cls} (budget "
                    f"{self._budget[cls]} of depth {self._max_depth}); "
                    "backpressure — retry later")
            victim = None
            if sum(len(d) for d in self._dqs.values()) \
                    >= self._max_depth:
                victim = self._evict_locked(cls)
                if victim is None:
                    raise QueueFullError(
                        f"request queue full (depth {self._max_depth}); "
                        "backpressure — retry later")
            if not dq:
                # waking from idle: catch up to the queue's virtual
                # time — an idle class must not bank credit
                self._vft[cls] = max(self._vft[cls], self._vtime)
            dq.append(request)
            self._not_empty.notify()
            return victim

    def _pop_locked(self):
        backlogged = [c for c in tenancy.TENANT_CLASSES
                      if self._dqs[c]]
        if not backlogged:
            return None
        # min virtual finish; ties go to the higher-priority class
        # (TENANT_CLASSES order) — deterministic for the goldens
        cls = min(backlogged,
                  key=lambda c: (self._vft[c],
                                 tenancy.TENANT_CLASSES.index(c)))
        self._vtime = self._vft[cls]
        self._vft[cls] += 1.0 / self._weights[cls]
        return self._dqs[cls].popleft()

    def poll(self, max_items, timeout=0.0):
        """Drain up to ``max_items`` requests in WFQ order; block up
        to ``timeout`` seconds only while the queue is empty."""
        deadline = time.monotonic() + timeout
        with self._not_empty:
            while not any(self._dqs.values()) and not self._closed:
                remaining = deadline - time.monotonic()
                if remaining <= 0 or not self._not_empty.wait(remaining):
                    break
            out = []
            while len(out) < max_items:
                r = self._pop_locked()
                if r is None:
                    break
                out.append(r)
            now = time.monotonic()
            for r in out:
                first = r.t_drain is None
                r.t_drain = now
                # first drain only: a requeued (KV-deferred) request's
                # second wait is the DEFER episode, stamped by the
                # decode engine when the re-admit finally lands
                if first and r.stages is not None:
                    _attribution.stamp(
                        r, "wfq_wait", r.t_submit, now,
                        attrs={"tenant_class": r.tenant_class})
            return out

    def requeue(self, request):
        """Put an already-admitted request back at the FRONT of its
        class (the decode engine defers a join when the KV page pool
        is momentarily exhausted). Bypasses the depth bound — the
        request was admitted once and must not be shed for coming
        back — and rewinds the class's virtual finish so the carry is
        immediately eligible again."""
        with self._lock:
            cls = self._class_of(request)
            self._dqs[cls].appendleft(request)
            self._vft[cls] = min(self._vft[cls], self._vtime)
            self._not_empty.notify()

    def close(self):
        """Refuse new work; queued requests stay drainable (the engine
        decides whether to run or fail them)."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()

    def drain_all(self):
        """Take every queued request (shutdown path), priority class
        first, FIFO within a class."""
        with self._lock:
            out = []
            for cls in tenancy.TENANT_CLASSES:
                out.extend(self._dqs[cls])
                self._dqs[cls].clear()
            return out
