"""Multi-tenant, multi-model serving control plane.

The fleet up to here was single-model/single-tenant: one entry-point
per engine, one admission class, one bill. Production traffic is
N models x M tenants with different priorities,
so this module adds the two identity axes every layer below threads
through:

- :class:`ModelRegistry` — ``model_id -> (entry-point fn, version)``.
  One engine hosts several models; ``model_id`` rides SUBMIT wire
  frames, HTTP ``/submit``, router relays, the HA journal, shape /
  compile-cache keys and the canary golden index. ``swap()`` flips a
  model to a new fn/version atomically (the engine warm-replays the
  model's visited shapes first — see ``ServingEngine.swap_model``),
  which is the live hot-swap primitive: zero lost requests, and the
  version change re-TOFUs the router's canary golden via the seat
  token (``router._canary_targets``).

- Tenant **admission classes** with weighted-fair queuing:
  ``priority`` / ``standard`` / ``best-effort``, in that priority
  order. Each class has a WFQ weight (default 4/2/1 — overridable via
  ``MXNET_TPU_TENANT_WEIGHTS``), a depth budget (a fraction of the
  queue's ``max_depth``, ``MXNET_TPU_TENANT_DEPTH_SHARES``) and an
  optional default deadline (``MXNET_TPU_TENANT_DEADLINE_MS``). The
  WFQ scheduler itself lives in ``queue.RequestQueue``; this module
  owns the class vocabulary and the knob parsing.

- :class:`TenantStats` — the per-tenant/per-model observability
  slice: ``mxnet_tpu_serving_tenant_*`` registry families (every one
  carries ``engine_id`` + ``tenant`` + ``tenant_class`` + ``model``
  labels — the mxlint ``metric-tenant-label`` contract) and an
  in-process per-(tenant, model) ledger with derived
  ``device_s_per_1k_tokens`` bills, the number ``serve_loadgen``
  cross-checks against its client-side ledger.

The WFQ *class-depth* gauge is deliberately named
``mxnet_tpu_serving_wfq_queue_depth`` (outside the ``tenant_*``
prefix): it is keyed by class, not by tenant, so forcing the tenant
label on it would fan a bounded gauge into an unbounded one.
"""
from __future__ import annotations

import threading

from .. import envvars
from ..telemetry.registry import REGISTRY

__all__ = ["TENANT_CLASSES", "DEFAULT_CLASS_WEIGHTS", "DEFAULT_MODEL",
           "default_model_id", "normalize_class", "parse_class_map",
           "class_weights", "class_depth_shares", "class_deadline_ms",
           "class_slo_ms", "UnknownModelError", "ModelRegistry",
           "TenantStats", "wfq_depth_gauge"]

#: admission classes, HIGHEST priority first — this order is the WFQ
#: virtual-finish tie-break, the shed/expiry scan order (reversed),
#: and the dequeue order of ``RequestQueue.drain_all``
TENANT_CLASSES = ("priority", "standard", "best-effort")

DEFAULT_CLASS_WEIGHTS = {"priority": 4.0, "standard": 2.0,
                         "best-effort": 1.0}

#: the model id a single-model engine serves and a model-less submit
#: targets — resolved through ``MXNET_TPU_MODEL_DEFAULT``
DEFAULT_MODEL = "default"


def default_model_id():
    return str(envvars.get("MXNET_TPU_MODEL_DEFAULT") or DEFAULT_MODEL)


def normalize_class(name):
    """Canonical admission class for ``name`` (None -> ``standard``).
    Unknown classes raise ``ValueError`` — a typo'd class silently
    landing in best-effort would be an invisible demotion."""
    if name is None:
        return "standard"
    cls = str(name).strip().lower().replace("_", "-")
    if cls not in TENANT_CLASSES:
        raise ValueError(
            f"unknown tenant class {name!r} (expected one of "
            f"{', '.join(TENANT_CLASSES)})")
    return cls


def parse_class_map(spec, vtype=float):
    """Parse ``"priority:4,standard:2,best-effort:1"`` into a
    ``{class: value}`` dict (classes validated, values ``vtype``-cast).
    Empty/None -> ``{}``. The one parser behind every per-class knob
    (WFQ weights, depth shares, deadlines, loadgen ``--tenants``)."""
    out = {}
    for part in (spec or "").split(","):
        part = part.strip()
        if not part:
            continue
        if ":" not in part:
            raise ValueError(f"bad class spec entry {part!r} "
                             f"(expected class:value)")
        cls, _, val = part.partition(":")
        out[normalize_class(cls)] = vtype(val)
    return out


def class_weights():
    """Effective WFQ weights: defaults overlaid with
    ``MXNET_TPU_TENANT_WEIGHTS``. Weights must be positive."""
    w = dict(DEFAULT_CLASS_WEIGHTS)
    w.update(parse_class_map(envvars.get("MXNET_TPU_TENANT_WEIGHTS")))
    for cls, val in w.items():
        if val <= 0:
            raise ValueError(f"tenant class weight {cls}:{val} must "
                             f"be > 0")
    return w


def class_depth_shares():
    """Per-class depth budgets as fractions of the queue's
    ``max_depth`` (default 1.0 — no extra cap — so a single-class
    workload keeps the exact pre-tenancy admission behavior)."""
    shares = {cls: 1.0 for cls in TENANT_CLASSES}
    shares.update(
        parse_class_map(envvars.get("MXNET_TPU_TENANT_DEPTH_SHARES")))
    for cls, val in shares.items():
        if not 0.0 < val <= 1.0:
            raise ValueError(f"tenant depth share {cls}:{val} outside "
                             f"(0, 1]")
    return shares


def class_deadline_ms():
    """Per-class DEFAULT deadlines (ms) applied to requests that bring
    none of their own (``MXNET_TPU_TENANT_DEADLINE_MS``; empty = no
    class defaults)."""
    return parse_class_map(envvars.get("MXNET_TPU_TENANT_DEADLINE_MS"))


def class_slo_ms():
    """Per-class total-latency SLO thresholds (ms) for
    ``default_tenant_objectives`` (``MXNET_TPU_TENANT_SLO_MS``)."""
    return parse_class_map(envvars.get("MXNET_TPU_TENANT_SLO_MS"))


class UnknownModelError(LookupError):
    """Submit names a ``model_id`` this engine/registry does not
    host. (A LookupError, not a ServingError subclass, so the model
    axis stays importable below ``queue.py``; the engine re-raises it
    through the normal shed taxonomy.)"""


class ModelRegistry:
    """Thread-safe ``model_id -> (entry-point fn, version)`` map.

    The registry is the hot-swap pivot: ``resolve()`` is a dict read
    under a lock, ``swap()`` replaces the fn/version in one critical
    section — a dispatching worker sees either the old or the new
    model, never a half-swapped one. In-flight batches keep the fn
    they resolved; the queue is untouched, so a swap loses nothing.
    """

    def __init__(self, models=None, default=None):
        self._lock = threading.Lock()
        self._entries = {}          # model_id -> {"fn", "version"}
        self._default = None
        for mid, fn in (models or {}).items():
            self.register(mid, fn)
        if default is not None:
            self._default = str(default)

    @classmethod
    def of(cls, model, model_id=None):
        """Wrap a plain entry-point callable into a one-model registry
        (or pass an existing registry through) — how ``ServingEngine``
        keeps its ``model`` argument backward compatible."""
        if isinstance(model, ModelRegistry):
            return model
        reg = cls()
        reg.register(model_id or default_model_id(), model)
        return reg

    def register(self, model_id, fn, version=None):
        if not callable(fn):
            raise TypeError(f"model {model_id!r} entry point is not "
                            f"callable: {fn!r}")
        mid = str(model_id)
        with self._lock:
            self._entries[mid] = {"fn": fn,
                                  "version": str(version or "v0")}
            if self._default is None:
                self._default = mid
        return mid

    def resolve_id(self, model_id=None):
        """Canonical hosted id for ``model_id`` (None -> the default
        model); raises :class:`UnknownModelError` otherwise."""
        with self._lock:
            mid = str(model_id) if model_id is not None else self._default
            if mid is None or mid not in self._entries:
                raise UnknownModelError(
                    f"model {model_id!r} not hosted here (have: "
                    f"{sorted(self._entries) or 'none'})")
            return mid

    def resolve(self, model_id=None):
        """``(model_id, fn)`` for dispatch."""
        with self._lock:
            mid = str(model_id) if model_id is not None else self._default
            entry = self._entries.get(mid) if mid is not None else None
            if entry is None:
                raise UnknownModelError(
                    f"model {model_id!r} not hosted here (have: "
                    f"{sorted(self._entries) or 'none'})")
            return mid, entry["fn"]

    def swap(self, model_id, fn, version=None):
        """Atomically cut ``model_id`` over to ``fn``/``version``;
        returns the previous version string. The caller (the engine)
        warm-replays the model's visited shapes through ``fn`` BEFORE
        calling this, so post-swap traffic is warm."""
        if not callable(fn):
            raise TypeError(f"model {model_id!r} entry point is not "
                            f"callable: {fn!r}")
        mid = str(model_id)
        with self._lock:
            entry = self._entries.get(mid)
            if entry is None:
                raise UnknownModelError(
                    f"cannot swap unknown model {mid!r}")
            old = entry["version"]
            self._entries[mid] = {"fn": fn,
                                  "version": str(version or old)}
        return old

    def ids(self):
        with self._lock:
            return sorted(self._entries)

    def default_id(self):
        with self._lock:
            return self._default

    def versions(self):
        """``{model_id: version}`` — advertised at ``/healthz`` so the
        router's canary targets re-TOFU on hot-swap."""
        with self._lock:
            return {mid: e["version"]
                    for mid, e in sorted(self._entries.items())}


class TenantStats:
    """Per-engine tenant/model observability slice.

    Registry families (all four labels — the mxlint
    ``metric-tenant-label`` contract for ``mxnet_tpu_serving_tenant_*``
    names):

    - ``..._tenant_requests_total``   — admission/completion outcomes
      per tenant/model (``shed`` = WFQ eviction under overload);
    - ``..._tenant_latency_ms``       — total request latency
      histogram, the family ``default_tenant_objectives`` judges with
      per-class ``match=`` filters (label subset matching);
    - ``..._tenant_cost_seconds_total`` / ``..._tenant_tokens_total``
      — the billing axis: amortized device seconds and valid tokens.

    ``bills()`` derives ``device_s_per_1k_tokens`` per tenant (and per
    model within it) — the engine's side of the loadgen cost
    cross-check.
    """

    def __init__(self, engine_id, registry=None):
        reg = registry if registry is not None else REGISTRY
        self.engine_id = str(engine_id)
        self._lock = threading.Lock()
        self._rows = {}             # (tenant, tclass, model) -> row
        self._req = reg.counter(
            "mxnet_tpu_serving_tenant_requests_total",
            "serving requests by tenant, admission class, model and "
            "outcome (shed = WFQ overload eviction), per engine",
            ("engine_id", "tenant", "tenant_class", "model", "event"))
        self._lat = reg.histogram(
            "mxnet_tpu_serving_tenant_latency_ms",
            "total request latency by tenant, admission class and "
            "model, per engine (the per-class SLO family)",
            ("engine_id", "tenant", "tenant_class", "model"))
        self._sec = reg.counter(
            "mxnet_tpu_serving_tenant_cost_seconds_total",
            "amortized device seconds billed by tenant, admission "
            "class and model, per engine",
            ("engine_id", "tenant", "tenant_class", "model"))
        self._tok = reg.counter(
            "mxnet_tpu_serving_tenant_tokens_total",
            "valid tokens billed by tenant, admission class and "
            "model, per engine",
            ("engine_id", "tenant", "tenant_class", "model"))

    def _row(self, tenant, tclass, model):
        key = (tenant, tclass, model)
        row = self._rows.get(key)
        if row is None:
            row = self._rows.setdefault(
                key, {"events": {}, "device_s": 0.0, "tokens": 0})
        return row

    def observe_event(self, tenant, tclass, model, event, n=1):
        tenant = str(tenant or "anonymous")
        with self._lock:
            ev = self._row(tenant, tclass, model)["events"]
            ev[event] = ev.get(event, 0) + n
        self._req.labels(engine_id=self.engine_id, tenant=tenant,
                         tenant_class=tclass, model=model,
                         event=event).inc(n)

    def observe_latency(self, tenant, tclass, model, total_ms):
        tenant = str(tenant or "anonymous")
        self._lat.labels(engine_id=self.engine_id, tenant=tenant,
                         tenant_class=tclass,
                         model=model).observe(float(total_ms))

    def observe_cost(self, tenant, tclass, model, device_s, tokens):
        tenant = str(tenant or "anonymous")
        with self._lock:
            row = self._row(tenant, tclass, model)
            row["device_s"] += float(device_s)
            row["tokens"] += int(tokens)
        if device_s:
            self._sec.labels(engine_id=self.engine_id, tenant=tenant,
                             tenant_class=tclass,
                             model=model).inc(float(device_s))
        if tokens:
            self._tok.labels(engine_id=self.engine_id, tenant=tenant,
                             tenant_class=tclass,
                             model=model).inc(int(tokens))

    @staticmethod
    def _derive(row):
        out = {"events": dict(row["events"]),
               "device_s": round(row["device_s"], 6),
               "tokens": row["tokens"]}
        if row["tokens"]:
            out["device_s_per_1k_tokens"] = round(
                row["device_s"] * 1e3 / row["tokens"], 6)
        return out

    def bills(self):
        """``{tenant: {class, totals, by_model: {model: row}}}`` with
        derived per-1k-token rates — the ``/stats`` `tenants` block
        and ``telemetry_dump --fleet``'s per-tenant table."""
        with self._lock:
            items = [((t, c, m), {"events": dict(r["events"]),
                                  "device_s": r["device_s"],
                                  "tokens": r["tokens"]})
                     for (t, c, m), r in sorted(self._rows.items())]
        out = {}
        for (tenant, tclass, model), row in items:
            slot = out.setdefault(
                tenant, {"tenant_class": tclass, "by_model": {},
                         "device_s": 0.0, "tokens": 0, "events": {}})
            slot["tenant_class"] = tclass
            slot["by_model"][model] = self._derive(row)
            slot["device_s"] = round(slot["device_s"] + row["device_s"],
                                     6)
            slot["tokens"] += row["tokens"]
            for ev, n in row["events"].items():
                slot["events"][ev] = slot["events"].get(ev, 0) + n
        for slot in out.values():
            if slot["tokens"]:
                slot["device_s_per_1k_tokens"] = round(
                    slot["device_s"] * 1e3 / slot["tokens"], 6)
        return out


def wfq_depth_gauge(registry=None):
    """The per-class queue-depth pull gauge family (class-keyed, so
    deliberately OUTSIDE the tenant_* label contract — see module
    docstring)."""
    reg = registry if registry is not None else REGISTRY
    return reg.gauge(
        "mxnet_tpu_serving_wfq_queue_depth",
        "admission-queue depth by WFQ class, per engine",
        ("engine_id", "tenant_class"))
