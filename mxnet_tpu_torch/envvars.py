"""Typed registry of the ``MXNET_TPU_*`` environment variables the
PyTorch port reads.

The same mechanism as the JAX package's ``mxnet_tpu/envvars.py``: every
variable is declared here once (name, type, default, doc, scope) and
read through :func:`get`, which returns the parsed typed value or the
declared default. Only the variables this package reads are declared,
under the SAME names as in the JAX package, so one environment
configures both packages alike: the decode-serving knobs
(``MXNET_TPU_KV_*``, ``MXNET_TPU_DECODE_*``), the serving queue's tenancy
knobs, and what the telemetry modules read (events, spans,
attribution, exemplars).

Stdlib-only. Parsing conventions: ``bool`` treats ``"" / 0 / false / no
/ off`` (case-insensitive) as False and anything else as True; ``int``
and ``float`` fall back to the declared default on an empty or
unparsable value.
"""
from __future__ import annotations

import os
from collections import OrderedDict

__all__ = ["EnvVar", "ENVVARS", "register", "get", "get_raw", "is_set",
           "all_vars"]

_FALSY = ("", "0", "false", "no", "off")


class EnvVar:
    """One declared variable: its name, value type (``bool``/``int``/
    ``float``/``str``/``path``), default, one-line doc, and subsystem
    scope (groups the generated reference table)."""

    __slots__ = ("name", "vtype", "default", "doc", "scope")

    def __init__(self, name, vtype, default, doc, scope):
        if not name.startswith("MXNET_TPU_"):
            raise ValueError(f"{name!r} is not an MXNET_TPU_* variable")
        if vtype not in ("bool", "int", "float", "str", "path"):
            raise ValueError(f"unknown env var type {vtype!r}")
        self.name = name
        self.vtype = vtype
        self.default = default
        self.doc = doc
        self.scope = scope

    def parse(self, raw):
        """Raw string → typed value (the declared default when the
        value is empty or unparsable — a typo'd knob must degrade to
        documented behavior, not crash process startup)."""
        if raw is None:
            return self.default
        raw = raw.strip()
        if self.vtype == "bool":
            return raw.lower() not in _FALSY
        if raw == "":
            return self.default
        try:
            if self.vtype == "int":
                return int(raw, 0)
            if self.vtype == "float":
                return float(raw)
        except ValueError:
            return self.default
        return raw      # str / path

    def describe_default(self):
        if self.default is None:
            return "unset"
        if self.vtype == "bool":
            return "on" if self.default else "off"
        return str(self.default)


#: declaration order is documentation order (grouped by scope)
ENVVARS: "OrderedDict[str, EnvVar]" = OrderedDict()


def register(name, vtype, default, doc, scope="runtime"):
    if name in ENVVARS:
        raise ValueError(f"env var {name} registered twice")
    var = EnvVar(name, vtype, default, doc, scope)
    ENVVARS[name] = var
    return var


def get(name):
    """The typed value of a registered variable (its default when
    unset). Raises ``KeyError`` for undeclared names — registering here
    IS the act of creating a configuration knob."""
    return ENVVARS[name].parse(os.environ.get(name))


def get_raw(name):
    """The raw string (None when unset) of a registered variable — for
    fallback chains that must distinguish unset from falsy values."""
    ENVVARS[name]            # undeclared names fail just like get()
    return os.environ.get(name)


def is_set(name):
    ENVVARS[name]
    return name in os.environ


def all_vars():
    return list(ENVVARS.values())


# ---------------------------------------------------------------------------
# the registry: only what the port reads
# ---------------------------------------------------------------------------

register("MXNET_TPU_SYMBOLIC_JIT", "bool", True,
         "compiled symbolic executor for Module/simple_bind (on the card "
         "one CUDA graph per binding key); ``0`` falls back to the eager "
         "per-op DAG walk (bug-bisection ladder)", scope="runtime")
register("MXNET_TPU_MODEL_STORE", "path", None,
         "root of the local pretrained-weight store "
         "(``gluon/model_zoo/model_store.py``; falls back to "
         "``$MXNET_HOME/models``, then ``~/.mxnet/models``)",
         scope="runtime")
register("MXNET_TPU_KV_PAGE_SIZE", "int", 16,
         "tokens per paged-KV-cache page (``serving/kvcache.py``): the "
         "allocation granule of the decode engine's attention memory",
         scope="decode")
register("MXNET_TPU_KV_PAGES", "int", 256,
         "paged-KV-cache pool capacity in pages, preallocated per "
         "layer at engine start (+1 internal scratch page); an "
         "exhausted pool defers decode joins instead of failing them",
         scope="decode")
register("MXNET_TPU_DECODE_ROWS", "int", 8,
         "decode-batch slot cap (``DecodeEngine`` default max "
         "concurrent sequences; row counts quantize to powers of two "
         "up to this, one step shape per (rows, table-width) "
         "bucket)", scope="decode")
register("MXNET_TPU_DECODE_MAX_NEW_TOKENS", "int", 64,
         "default generation cap for decode requests that bring no "
         "``max_new_tokens`` of their own", scope="decode")
register("MXNET_TPU_DECODE_PREFILLS_PER_ITER", "int", 1,
         "prompt prefills admitted per decode-loop iteration: bounds "
         "how long the running decode batch can stall behind prefill "
         "work (the prefill/decode split-scheduling knob)",
         scope="decode")
register("MXNET_TPU_DECODE_PREFILL_BUDGET", "int", 64,
         "prompt tokens prefilled per decode-loop iteration: prompts "
         "are split into kernel-sized chunks interleaved at iteration "
         "boundaries, so a long prompt never stalls the running batch "
         "for more than one chunk; ``0`` restores whole-prompt dense "
         "prefill (the chunked-prefill A/B baseline)", scope="decode")
register("MXNET_TPU_KV_PREFIX", "bool", True,
         "prefix KV cache reuse (``serving/kvcache.py``): prompts "
         "sharing a token prefix share its full KV pages read-only "
         "(refcounted, copy-on-write on divergence); ``0`` disables — "
         "the prefix-reuse A/B knob. Needs chunked prefill "
         "(``MXNET_TPU_DECODE_PREFILL_BUDGET`` > 0) to take effect",
         scope="decode")
register("MXNET_TPU_KV_PREFIX_PAGES", "int", 64,
         "bounded LRU capacity of the prefix-KV index, in entries "
         "(one full page each); eviction unpins the page, which "
         "recycles once no live sequence references it",
         scope="decode")
register("MXNET_TPU_DECODE_TEMPERATURE", "float", 0.0,
         "default decode sampling temperature for requests that bring "
         "none: ``0`` is greedy argmax — deterministic by "
         "construction, the byte-reproducible solo-parity lever",
         scope="decode")
register("MXNET_TPU_DECODE_TOP_K", "int", 0,
         "default top-k sampling cutoff for decode requests (``0`` = "
         "no top-k truncation; only applies when temperature > 0)",
         scope="decode")
register("MXNET_TPU_DECODE_TOP_P", "float", 1.0,
         "default nucleus (top-p) sampling mass for decode requests "
         "(``1.0`` = no truncation; only applies when temperature "
         "> 0)", scope="decode")
register("MXNET_TPU_EVENT_LOG", "path", None,
         "structured JSONL run-event log path (a directory gets one "
         "``events-<pid>.jsonl`` per process)", scope="telemetry")
register("MXNET_TPU_EVENT_LOG_MAX_MB", "float", None,
         "rotate the event log at this size (MB); unset = no rotation",
         scope="telemetry")
register("MXNET_TPU_EVENT_LOG_KEEP", "int", 3,
         "rotated event-log files kept (``read_events`` reads across "
         "rotations)", scope="telemetry")
register("MXNET_TPU_SPANS", "bool", True,
         "span recording (tail-sampled request tracing); ``0`` disables "
         "— the ring is bounded either way", scope="telemetry")
register("MXNET_TPU_TRACE_SLOW_MS", "float", 250.0,
         "tail-sampling keep threshold: traces whose local root ran "
         "longer are kept in full", scope="telemetry")
register("MXNET_TPU_TRACE_BUFFER", "int", 64,
         "kept-trace ring size", scope="telemetry")
register("MXNET_TPU_TRACE_MAX_SPANS", "int", 256,
         "per-trace span cap (a leaked trace cannot grow the process)",
         scope="telemetry")
register("MXNET_TPU_TRACE_MAX_ACTIVE", "int", 256,
         "in-flight (not yet sampled) trace buffer cap",
         scope="telemetry")
register("MXNET_TPU_ATTRIBUTION", "bool", True,
         "per-request critical-path stage attribution (stage spans, "
         "``InferenceFuture.breakdown``, the ``/whyslow`` aggregator); "
         "``0`` — or spans off — disables: no stamps, no families, no "
         "threads", scope="telemetry")
register("MXNET_TPU_ATTRIBUTION_WINDOW", "int", 2048,
         "per-stage sample window behind the ``/whyslow`` windowed "
         "p99 (per (stage, tenant_class, model) cell)",
         scope="telemetry")
register("MXNET_TPU_ATTRIBUTION_TOP", "int", 3,
         "stages ranked in ``/whyslow``'s ``top`` table and attached "
         "to firing latency alert payloads", scope="telemetry")
register("MXNET_TPU_SLO", "bool", True,
         "in-process SLO engine: serving engines/routers register "
         "their default objectives (latency quantile, availability, "
         "cost budget, engine-up fraction) and the alert daemon "
         "evaluates multi-window burn-rate / threshold / absence "
         "rules against them; ``0`` disables evaluation, exemplar "
         "recording and the ``/alerts``+``/slo`` endpoints",
         scope="slo")
register("MXNET_TPU_SLO_EXEMPLARS", "bool", True,
         "record (latency bucket, trace_id) exemplar pairs on the "
         "serving/router total-latency histograms, rendered "
         "OpenMetrics-style in the text exposition and surfaced on "
         "``/alerts``; ``0`` skips the per-request exemplar write",
         scope="slo")
register("MXNET_TPU_TENANT_WEIGHTS", "str", None,
         "WFQ admission-class weights as ``class:weight`` pairs "
         "(overlays the 4/2/1 default, e.g. "
         "``priority:8,best-effort:1``): the queue dequeues classes "
         "in proportion to weight under contention", scope="tenancy")
register("MXNET_TPU_TENANT_DEPTH_SHARES", "str", None,
         "per-class admission-queue depth budgets as fractions of "
         "``max_depth`` (``class:share`` pairs, default 1.0 each — "
         "e.g. ``best-effort:0.5`` caps best-effort at half the "
         "queue even before WFQ eviction kicks in)", scope="tenancy")
register("MXNET_TPU_TENANT_DEADLINE_MS", "str", None,
         "per-class DEFAULT deadlines (ms) for requests that bring "
         "none (``class:ms`` pairs, e.g. ``best-effort:2000``): "
         "under overload, expiry consumes the short-deadline classes "
         "first", scope="tenancy")
register("MXNET_TPU_TENANT_SLO_MS", "str", None,
         "per-class total-latency SLO thresholds (ms) for the "
         "``default_tenant_objectives`` set (``class:ms`` pairs; "
         "classes not listed default to 0.5x / 1x / 4x the serving "
         "latency bound for priority/standard/best-effort)",
         scope="tenancy")
register("MXNET_TPU_MODEL_DEFAULT", "str", "default",
         "model id a single-model engine registers under and a "
         "model-less submit targets — the backward-compat identity "
         "of the pre-registry fleet", scope="tenancy")
