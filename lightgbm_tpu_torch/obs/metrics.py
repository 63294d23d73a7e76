"""Low-overhead metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of the JAX package's ``obs/metrics.py`` (which
imports no jax; the port imports nothing of that package).  The registry
answers "how much work has this process done": the aggregate counters a
serving deployment scrapes.  Instruments are process-global
(``REGISTRY``), one lock and an add per observation, and export as
Prometheus text (``to_prometheus``, ``REGISTRY.write("metrics.prom")``)
or a JSON snapshot (``snapshot``, ``to_json``).  The predict and serving
paths record unconditionally.

Histogram semantics follow Prometheus: cumulative buckets keyed by
upper bound ``le`` (inclusive), plus ``_sum``/``_count``.
"""
from __future__ import annotations

import bisect
import json
import threading

# the content type Prometheus scrapers expect from a text exposition,
# served by the live /metrics endpoint (obs/live.py)
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# default latency buckets (seconds) — the standard Prometheus ladder
# stretched to cover graph captures
TIME_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
# batch-size buckets (rows per predict call)
SIZE_BUCKETS = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6, 1e7)


def _fmt(v):
    """Prometheus sample formatting: integers without the trailing .0."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _series(name, labels):
    if not labels:
        return name
    inner = ",".join('%s="%s"' % (k, labels[k]) for k in sorted(labels))
    return "%s{%s}" % (name, inner)


class Counter:
    """Monotonically increasing count."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name, help="", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, amount=1):
        if amount < 0:
            raise ValueError("counter %s: negative increment %r"
                             % (self.name, amount))
        with self._lock:
            self._value += amount

    @property
    def value(self):
        return self._value

    def _export(self):
        return {"type": "counter", "value": self._value}


class Gauge:
    """A value that can go up and down (watermarks, in-flight counts)."""

    __slots__ = ("name", "help", "labels", "_value", "_lock")

    def __init__(self, name, help="", labels=None):
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, value):
        with self._lock:
            self._value = value

    def inc(self, amount=1):
        with self._lock:
            self._value += amount

    def dec(self, amount=1):
        self.inc(-amount)

    def max(self, value):
        """Watermark update: keep the larger of current and ``value``."""
        with self._lock:
            if value > self._value:
                self._value = value

    @property
    def value(self):
        return self._value

    def _export(self):
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket histogram, Prometheus ``le`` (inclusive upper bound)
    semantics with an implicit +Inf bucket."""

    __slots__ = ("name", "help", "labels", "buckets", "_counts", "_sum",
                 "_count", "_lock")

    def __init__(self, name, help="", labels=None, buckets=TIME_BUCKETS):
        b = tuple(float(x) for x in buckets)
        if not b or list(b) != sorted(set(b)):
            raise ValueError("histogram %s: buckets must be strictly "
                             "increasing, got %r" % (name, buckets))
        self.name = name
        self.help = help
        self.labels = dict(labels or {})
        self.buckets = b
        self._counts = [0] * (len(b) + 1)      # last slot = +Inf
        self._sum = 0.0
        self._count = 0
        self._lock = threading.Lock()

    def observe(self, value):
        v = float(value)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self):
        return self._count

    @property
    def sum(self):
        return self._sum

    def cumulative(self):
        """[(le_str, cumulative_count), ...] ending with '+Inf'."""
        out = []
        acc = 0
        for le, c in zip(self.buckets, self._counts):
            acc += c
            out.append((_fmt(le), acc))
        out.append(("+Inf", acc + self._counts[-1]))
        return out

    def _export(self):
        return {"type": "histogram", "count": self._count,
                "sum": self._sum,
                "buckets": {le: c for le, c in self.cumulative()}}


class MetricsRegistry:
    """Named instruments, get-or-create.  One series per (name, labels);
    re-requesting an existing series returns the same instrument, and a
    type mismatch raises rather than silently forking the series."""

    _TYPES = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}

    def __init__(self):
        self._series = {}          # (name, labels-key) -> instrument
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw):
        key = (name, tuple(sorted((labels or {}).items())))
        with self._lock:
            inst = self._series.get(key)
            if inst is None:
                inst = cls(name, help=help, labels=labels, **kw)
                self._series[key] = inst
            elif not isinstance(inst, cls):
                raise ValueError(
                    "metric %r already registered as %s, requested %s"
                    % (name, type(inst).__name__, cls.__name__))
            return inst

    def counter(self, name, help="", labels=None) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=None) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=None,
                  buckets=TIME_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def reset(self):
        """Drop every instrument (tests; a fresh process-global slate)."""
        with self._lock:
            self._series.clear()

    # ------------------------------------------------------------ export
    def snapshot(self):
        """{series: export-dict} — counters/gauges carry ``value``,
        histograms ``count``/``sum``/cumulative ``buckets``."""
        with self._lock:
            series = list(self._series.values())
        return {_series(m.name, m.labels): m._export() for m in series}

    def to_json(self, indent=None):
        return json.dumps({"metrics": self.snapshot()}, indent=indent,
                          sort_keys=True)

    def to_prometheus(self):
        """Prometheus textfile exposition format (one HELP/TYPE block per
        metric family, series within a family grouped together)."""
        with self._lock:
            series = list(self._series.values())
        families = {}
        for m in series:
            families.setdefault(m.name, []).append(m)
        lines = []
        for name in sorted(families):
            fam = families[name]
            kind = {Counter: "counter", Gauge: "gauge",
                    Histogram: "histogram"}[type(fam[0])]
            help_text = next((m.help for m in fam if m.help), "")
            if help_text:
                lines.append("# HELP %s %s" % (name, help_text))
            lines.append("# TYPE %s %s" % (name, kind))
            for m in fam:
                if isinstance(m, Histogram):
                    for le, c in m.cumulative():
                        lbl = dict(m.labels)
                        lbl["le"] = le
                        lines.append("%s %s"
                                     % (_series(name + "_bucket", lbl),
                                        _fmt(c)))
                    lines.append("%s %s" % (_series(name + "_sum", m.labels),
                                            _fmt(m._sum)))
                    lines.append("%s %s" % (_series(name + "_count",
                                                    m.labels),
                                            _fmt(m._count)))
                else:
                    lines.append("%s %s" % (_series(name, m.labels),
                                            _fmt(m.value)))
        return "\n".join(lines) + ("\n" if lines else "")

    def write(self, path):
        """Export to ``path``: Prometheus textfile format for ``.prom`` /
        ``.txt`` suffixes, JSON otherwise."""
        path = str(path)
        if path.endswith((".prom", ".txt")):
            body = self.to_prometheus()
        else:
            body = self.to_json(indent=2) + "\n"
        import os
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            f.write(body)
        return path


# the process-global registry every subsystem records into
REGISTRY = MetricsRegistry()


def observe_predict(rows, seconds):
    """Serving-path instrumentation: one call per predict request.
    Unconditional (no observer gate) — three lock/adds per request is
    noise next to a traversal, and the serving path has no training-run
    observer to gate on.  ``rows`` is the INPUT row count of the request
    (the caller computes it from the normalized feature matrix, not the
    output array, so 1-D converted outputs and multiclass matrices both
    count rows)."""
    REGISTRY.histogram(
        "lgbm_predict_seconds",
        "per-request predict latency (seconds)").observe(seconds)
    REGISTRY.histogram(
        "lgbm_predict_batch_rows",
        "rows per predict request", buckets=SIZE_BUCKETS).observe(rows)
    REGISTRY.counter(
        "lgbm_predict_rows_total", "total rows predicted").inc(int(rows))


def observe_serve_batch(route, rows, pad, bucket, queue_s, exec_s):
    """One coalesced serving microbatch (serve/scheduler.py flush):
    ``rows`` real rows, ``pad`` padding rows added to reach ``bucket``,
    ``queue_s`` the oldest request's coalescing wait, ``exec_s`` the
    encode+execute+split time.  The counter is labeled by the route
    KIND only (``route[0]``): full route tuples embed client-supplied
    early-stop freq/margin values, which would make label cardinality
    unbounded."""
    kind = route[0] if isinstance(route, tuple) and route else route
    REGISTRY.counter(
        "lgbm_serve_batches_total",
        "coalesced serving microbatches executed",
        labels={"route": str(kind)}).inc()
    REGISTRY.counter(
        "lgbm_serve_rows_total", "rows scored by the serving tier").inc(
            int(rows))
    REGISTRY.counter(
        "lgbm_serve_pad_rows_total",
        "bucket-padding rows scored and discarded").inc(int(pad))
    REGISTRY.histogram(
        "lgbm_serve_batch_rows", "real rows per serving microbatch",
        buckets=SIZE_BUCKETS).observe(rows)
    REGISTRY.histogram(
        "lgbm_serve_queue_seconds",
        "coalescing wait of the oldest request in a microbatch").observe(
            queue_s)
    REGISTRY.histogram(
        "lgbm_serve_exec_seconds",
        "microbatch encode+execute+split time").observe(exec_s)


def observe_serve_request(seconds):
    """End-to-end latency of one serving request (submit -> result)."""
    REGISTRY.histogram(
        "lgbm_serve_request_seconds",
        "per-request serving latency, submit to result").observe(seconds)


def observe_serve_shed(route, reason):
    """One request shed at admission (serve/scheduler.py overload
    protection).  ``reason`` is ``queue_full`` (bounded queue at
    ``serve_queue_limit``) or ``deadline`` (projected wait already
    exceeds the request's deadline).  Labeled by route KIND only, same
    cardinality discipline as observe_serve_batch."""
    kind = route[0] if isinstance(route, tuple) and route else route
    REGISTRY.counter(
        "lgbm_serve_shed_total",
        "requests rejected at admission by overload protection",
        labels={"route": str(kind), "reason": str(reason)}).inc()


def observe_serve_queue_age(seconds):
    """Age of the oldest queued request (0 when the queue is empty) —
    the gauge that makes a building backlog visible BEFORE shedding
    starts; updated on every admission and batch pop."""
    REGISTRY.gauge(
        "lgbm_serve_queue_age_seconds",
        "wait of the oldest request still in the microbatch queue").set(
            round(float(seconds), 6))
