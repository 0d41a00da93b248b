"""Process-wide metrics registry: Counter / Gauge / Histogram.

The scrape-side half of the observability story (reference lineage:
MXNet Model Server's management-API metrics). One registry per
process (module-level :data:`REGISTRY`, the default everywhere);
subsystems create metric FAMILIES (a name + label names) and bump
label-addressed children on their hot paths.

Cost discipline: a counter bump or histogram observe is one lock
acquisition and a couple of dict/float ops — cheap enough for the
serving dispatch and kvstore RPC paths it instruments (guarded by the
disabled-path microbenchmark in tests/test_telemetry.py). Everything
expensive (sorting, text rendering) happens at scrape/snapshot time on
the scraper's thread. Gauges can be PULL-based (``set_function``) so
an instrumented component pays nothing until someone scrapes.

Everything is thread-safe; children are created on first touch and
live for the process lifetime (Prometheus counters are cumulative by
contract — `serving.ServingStats` windows reset, registry counters
never do; scrapers diff).

Histograms can carry OpenMetrics-style EXEMPLARS: ``observe(v,
exemplar=trace_id)`` remembers the most recent (and, per bucket, the
slowest-seen) ``(value, trace_id, wall_ts)`` triple for the bucket the
observation landed in, rendered as ``# {trace_id="..."} value ts``
after the ``_bucket`` sample line. That is the machine-readable link
from a latency histogram back to a retrievable trace in
``/traces/<id>`` — the SLO engine's alert surface reads them off
:meth:`Histogram._Child.exemplars`.
"""
from __future__ import annotations

import threading
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "DEFAULT_MS_BUCKETS", "escape_label_value",
           "EXEMPLAR_MAX_AGE_S"]

#: a bucket's reigning exemplar decays after this many seconds: the
#: slowest-ever observation would otherwise pin a trace id whose trace
#: the bounded tail-sampling ring evicted long ago — a dead link. Past
#: this age ANY new exemplar-bearing observation takes the slot, so
#: exposition exemplars always point near the present.
EXEMPLAR_MAX_AGE_S = 30.0

# latency bucket boundaries in milliseconds: sub-ms dispatch overhead
# through multi-second compiles on one axis
DEFAULT_MS_BUCKETS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


def escape_label_value(v):
    """Prometheus text-format label-value escaping (backslash, quote,
    newline — in that order, per the exposition spec)."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


class _Family:
    """A named metric family: children addressed by label-value tuples
    (label NAMES are fixed at creation; values address children)."""

    kind = "untyped"

    def __init__(self, name, help_text="", labelnames=()):
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._children = {}
        self._lock = threading.Lock()

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by "
                                 "name, not both")
            values = tuple(kv[n] for n in self.labelnames)
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} expects labels {self.labelnames}, got "
                f"{values}")
        child = self._children.get(values)
        if child is None:
            with self._lock:
                child = self._children.setdefault(values,
                                                  self._make_child())
        return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled {self.labelnames}; "
                             "use .labels(...)")
        return self.labels()

    def _label_str(self, values):
        if not values:
            return ""
        pairs = ",".join(f'{n}="{escape_label_value(v)}"'
                         for n, v in zip(self.labelnames, values))
        return "{" + pairs + "}"

    def _sorted_children(self):
        with self._lock:
            return sorted(self._children.items())


class Counter(_Family):
    """Monotone counter family. ``inc`` on the unlabeled family or a
    ``labels(...)`` child."""

    kind = "counter"

    class _Child:
        __slots__ = ("_value", "_lock")

        def __init__(self):
            self._value = 0.0
            self._lock = threading.Lock()

        def inc(self, n=1):
            if n < 0:
                raise ValueError("counters only go up")
            with self._lock:
                self._value += n

        @property
        def value(self):
            return self._value

    def _make_child(self):
        return Counter._Child()

    def inc(self, n=1):
        self._default_child().inc(n)

    @property
    def value(self):
        return self._default_child().value

    def render(self, out):
        for values, child in self._sorted_children():
            out.append(f"{self.name}{self._label_str(values)} "
                       f"{_fmt(child.value)}")

    def snapshot(self):
        return {self._label_str(v): c.value
                for v, c in self._sorted_children()}


class Gauge(_Family):
    """Settable (or pull-function-backed) point-in-time value."""

    kind = "gauge"

    class _Child:
        __slots__ = ("_value", "_fn", "_lock")

        def __init__(self):
            self._value = 0.0
            self._fn = None
            self._lock = threading.Lock()

        def set(self, v):
            with self._lock:
                self._value = float(v)
                self._fn = None

        def inc(self, n=1):
            with self._lock:
                self._value += n

        def dec(self, n=1):
            self.inc(-n)

        def set_function(self, fn):
            """Evaluate ``fn()`` at scrape time (zero hot-path cost)."""
            with self._lock:
                self._fn = fn

        @property
        def value(self):
            fn = self._fn
            if fn is not None:
                try:
                    return float(fn())
                except Exception:
                    return float("nan")
            return self._value

    def _make_child(self):
        return Gauge._Child()

    def set(self, v):
        self._default_child().set(v)

    def inc(self, n=1):
        self._default_child().inc(n)

    def dec(self, n=1):
        self._default_child().dec(n)

    def set_function(self, fn):
        self._default_child().set_function(fn)

    @property
    def value(self):
        return self._default_child().value

    def render(self, out):
        for values, child in self._sorted_children():
            out.append(f"{self.name}{self._label_str(values)} "
                       f"{_fmt(child.value)}")

    def snapshot(self):
        return {self._label_str(v): c.value
                for v, c in self._sorted_children()}


class Histogram(_Family):
    """Fixed-boundary histogram (Prometheus bucket semantics: each
    ``le`` bucket is CUMULATIVE, ``+Inf`` equals ``_count``)."""

    kind = "histogram"

    class _Child:
        __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock",
                     "_exemplars")

        def __init__(self, bounds):
            self._bounds = bounds
            self._counts = [0] * (len(bounds) + 1)   # last = +Inf
            self._sum = 0.0
            self._count = 0
            self._lock = threading.Lock()
            self._exemplars = None      # allocated on first exemplar

        def observe(self, v, exemplar=None):
            v = float(v)
            i = 0
            bounds = self._bounds
            n = len(bounds)
            # linear scan beats bisect for the ~dozen buckets used here
            while i < n and v > bounds[i]:
                i += 1
            with self._lock:
                self._counts[i] += 1
                self._sum += v
                self._count += 1
                if exemplar is not None:
                    if self._exemplars is None:
                        self._exemplars = [None] * (len(bounds) + 1)
                    prev = self._exemplars[i]
                    # per bucket, the SLOWEST RECENT observation wins:
                    # a firing latency alert wants the worst retrievable
                    # trace in that bucket, not whichever came last —
                    # but a stale champion decays (EXEMPLAR_MAX_AGE_S,
                    # measured on the monotonic clock; the wall ts is
                    # exposition-only) so the id still resolves in the
                    # bounded trace ring
                    mono = time.monotonic()
                    if (prev is None or v >= prev["value"]
                            or mono - prev["mono"] > EXEMPLAR_MAX_AGE_S):
                        self._exemplars[i] = {
                            "trace_id": str(exemplar), "value": v,
                            "ts": round(time.time(), 3), "mono": mono}

        def exemplars(self):
            """``{bucket_bound_or_inf: {trace_id, value, ts}}`` for
            buckets that have one (empty when none were recorded)."""
            with self._lock:
                ex = list(self._exemplars) if self._exemplars else []
            out = {}
            for i, e in enumerate(ex):
                if e is not None:
                    bound = (self._bounds[i] if i < len(self._bounds)
                             else float("inf"))
                    out[bound] = {k: v for k, v in e.items()
                                  if k != "mono"}
            return out

        @property
        def count(self):
            return self._count

        @property
        def sum(self):
            return self._sum

        def cumulative(self):
            with self._lock:
                counts = list(self._counts)
            acc, out = 0, []
            for c in counts:
                acc += c
                out.append(acc)
            return out

    def __init__(self, name, help_text="", labelnames=(), buckets=None):
        super().__init__(name, help_text, labelnames)
        bounds = tuple(float(b) for b in (buckets or DEFAULT_MS_BUCKETS))
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram buckets must ascend: {bounds}")
        self.buckets = bounds

    def _make_child(self):
        return Histogram._Child(self.buckets)

    def observe(self, v, exemplar=None):
        self._default_child().observe(v, exemplar=exemplar)

    @property
    def count(self):
        return self._default_child().count

    @property
    def sum(self):
        return self._default_child().sum

    def exemplars(self):
        return self._default_child().exemplars()

    def render(self, out):
        for values, child in self._sorted_children():
            cum = child.cumulative()
            exemplars = child.exemplars()
            for bound, acc in zip(self.buckets + (float("inf"),),
                                  cum):
                lv = values + (("+Inf" if bound == float("inf")
                                else _fmt(bound)),)
                pairs = ",".join(
                    f'{n}="{escape_label_value(v)}"'
                    for n, v in zip(self.labelnames + ("le",), lv))
                line = f"{self.name}_bucket{{{pairs}}} {acc}"
                ex = exemplars.get(bound)
                if ex is not None:
                    # OpenMetrics exemplar syntax on the bucket line:
                    # the trace id a scraper can resolve at /traces/<id>
                    line += (f' # {{trace_id="'
                             f'{escape_label_value(ex["trace_id"])}"}} '
                             f'{_fmt(ex["value"])} {_fmt(ex["ts"])}')
                out.append(line)
            ls = self._label_str(values)
            out.append(f"{self.name}_sum{ls} {_fmt(child.sum)}")
            out.append(f"{self.name}_count{ls} {child.count}")

    def snapshot(self):
        return {self._label_str(v): {"count": c.count,
                                     "sum": round(c.sum, 3)}
                for v, c in self._sorted_children()}


def _fmt(v):
    """Render a float the Prometheus way: integers without the dot."""
    f = float(v)
    if f != f:
        return "NaN"
    if f in (float("inf"), float("-inf")):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Create-or-get metric families by name; render/snapshot them.

    ``counter/gauge/histogram`` are idempotent: the same name returns
    the SAME family (so `ServingStats` instances recreated by
    ``reset_stats`` keep feeding one cumulative counter set), and a
    name re-registered as a different kind or label set raises.
    """

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get_or_make(self, cls, name, help_text, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if type(m) is not cls or m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{type(m).__name__}{m.labelnames}")
                want = kw.get("buckets")
                if want is not None and m.buckets != tuple(
                        float(b) for b in want):
                    # silently handing back a family with DIFFERENT
                    # boundaries would mis-bucket the second caller's
                    # observations — as loud as a kind conflict
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}")
                return m
            m = cls(name, help_text, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help_text="", labelnames=()):
        return self._get_or_make(Counter, name, help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._get_or_make(Gauge, name, help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(), buckets=None):
        return self._get_or_make(Histogram, name, help_text, labelnames,
                                 buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def render_prometheus(self):
        """The full text exposition (format 0.0.4), families sorted by
        name, children sorted by label values — deterministic output
        for goldens and diff-based scrapers."""
        out = []
        with self._lock:
            families = sorted(self._metrics.items())
        for name, fam in families:
            if fam.help:
                out.append(f"# HELP {name} "
                           + fam.help.replace("\\", "\\\\")
                           .replace("\n", "\\n"))
            out.append(f"# TYPE {name} {fam.kind}")
            fam.render(out)
        return "\n".join(out) + "\n"

    def snapshot(self):
        """JSON-able {name: {kind, values}} dump (the /stats analog of
        /metrics)."""
        with self._lock:
            families = sorted(self._metrics.items())
        return {name: {"kind": fam.kind, "values": fam.snapshot()}
                for name, fam in families}

    def snapshot_compact(self):
        """Nonzero counters + histogram counts only — small enough to
        embed per bench leg in `bench_suite_summary`."""
        out = {}
        with self._lock:
            families = sorted(self._metrics.items())
        for name, fam in families:
            if fam.kind == "counter":
                vals = {k or "": v for k, v in fam.snapshot().items() if v}
                if vals:
                    out[name] = vals
            elif fam.kind == "histogram":
                vals = {k or "": v["count"]
                        for k, v in fam.snapshot().items() if v["count"]}
                if vals:
                    out[name] = vals
        return out


#: the process-wide default registry every subsystem instruments
REGISTRY = MetricsRegistry()
