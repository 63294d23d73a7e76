"""Serving-tier SLOs: the rolling window, burn-rate alerts.

Ported from the JAX package's ``obs/serve.py``: the writer side here,
and the reader side below (``serve_events``, ``serve_metrics``,
``serve_headline``, ``serve_roofline`` and ``render_serve_report``,
behind ``python -m lightgbm_tpu_torch obs serve [--check]`` and ``obs
summary``'s serving headline).  The microbatch scheduler feeds ``SloEngine`` one ``record()`` per completed
request and one ``record_shed()`` per rejected one.  State is a ring of
1-second buckets per route kind, each a fixed log-spaced latency
histogram plus request, error and shed counts: recording is one lock,
one bisect and four int adds, safe on the serve worker's hot path.
Every ``serve_slo_every_s`` it evaluates:

- per-route QPS, p50/p95/p99 (histogram upper bounds, conservative),
  error rate and shed rate over the long window;
- the **multi-window burn rate** against the ``serve_slo_p99_ms``
  target: the latency SLO is "at most 1% of requests may exceed the
  target" (the 99 in p99), burn = (fraction over target) / 1%, and the
  alert fires only when BOTH the short window (window/6) and the long
  window burn above ``BURN_THRESHOLD``; it clears when the short-window
  burn drops back under threshold.  Transitions are logged through
  ``Log.warning`` and sent to the observer as ``health`` events
  (warn-only: killing a server that misses latency targets only makes
  the outage total).
"""
from __future__ import annotations

import bisect
import math
import sys
import threading
import time

from ..utils.log import Log
from .events import NULL_OBSERVER
from .metrics import REGISTRY

# the consequence modes of a health check (the JAX package's
# obs/health.py MODES) and the checks that only ever warn
MODES = ("off", "warn", "fatal")
_WARN_ONLY = frozenset(("slo_burn_rate",))

# log-spaced latency estimation ladder: 50us .. ~26s, 25% resolution.
# Quantiles report a bucket's upper bound, so they over-estimate by at
# most one ratio step — conservative in the direction that never hides
# an SLO violation.
_RATIO = 1.25
LATENCY_LADDER = tuple(5e-5 * (_RATIO ** i) for i in range(60))

# the "99" in p99: the fraction of requests allowed over the target
P99_BUDGET = 0.01
# both burn windows must exceed this multiple of the budget to page
BURN_THRESHOLD = 2.0


def route_kind(route):
    """Route KIND from a route key: tuple -> first element, string ->
    itself.  The cardinality discipline of obs/metrics.py: full route
    tuples embed client-supplied values and stay on sampled events."""
    if isinstance(route, tuple) and route:
        return str(route[0])
    return str(route)


def _kind_from_event(e):
    """Route kind of a recorded serving event: the explicit ``kind``
    field (schema 7) or parsed from the stringified route tuple that
    schema-6 events carry, e.g. ``"('dev', True)"`` -> ``dev``."""
    k = e.get("kind")
    if k:
        return str(k)
    r = str(e.get("route", "")).strip()
    for ch in "(\"'":
        r = r.replace(ch, "")
    return (r.split(",")[0] or "?").strip()


def _pct_sorted(xs, q):
    """Nearest-rank percentile of an already-sorted list."""
    if not xs:
        return 0.0
    i = max(0, min(len(xs) - 1, int(math.ceil(q * len(xs))) - 1))
    return xs[i]


class SloEngine:
    """Rolling-window SLO aggregator + burn-rate alerter for the serve
    tier.  Thread-safe; one instance per ServingPredictor, fed by the
    scheduler worker and submitting threads.

    ``p99_ms``/``qps`` of 0 mean "no target": the engine still
    aggregates and snapshots (the operator's dashboard), it just has
    nothing to verdict or page on.  ``clock`` is injectable so tests
    drive the windows deterministically.
    """

    def __init__(self, observer=None, mode="warn", p99_ms=0.0, qps=0.0,
                 window_s=60.0, every_s=10.0,
                 burn_threshold=BURN_THRESHOLD, clock=time.monotonic):
        self.observer = observer if observer is not None else NULL_OBSERVER
        mode = str(mode or "warn").strip().lower()
        if mode not in MODES:
            raise ValueError("slo mode %r (expected off/warn/fatal)"
                             % (mode,))
        self.mode = mode
        self.p99_target_s = max(0.0, float(p99_ms or 0.0)) / 1e3
        self.qps_target = max(0.0, float(qps or 0.0))
        self.window_s = max(1.0, float(window_s or 60.0))
        self.short_s = max(1.0, self.window_s / 6.0)
        self.every_s = max(0.0, float(every_s or 0.0))
        # alert evaluation keeps its own cadence when snapshots are off
        self._eval_s = self.every_s or max(1.0, self.short_s / 2.0)
        self.burn_threshold = float(burn_threshold)
        self.clock = clock
        self._lock = threading.Lock()
        # kind -> list of [sec, n, err, shed, lat_sum, counts]; counts
        # has len(LATENCY_LADDER)+1 slots (last = +Inf), buckets sorted
        # by sec, pruned as they age past the long window
        self._routes = {}
        self._last_eval = clock()
        self._last_overall = None      # most recent evaluated window
        self._last_verdicts = {}
        self.alerting = False
        self.alerts_fired = 0
        self.alerts_cleared = 0
        self._m_alerts = REGISTRY.counter(
            "lgbm_serve_slo_alerts_total",
            "burn-rate alerts fired by the serving SLO engine")
        self._m_burn = REGISTRY.gauge(
            "lgbm_serve_slo_burn_rate",
            "long-window p99 error-budget burn rate (1.0 = on budget)")

    # ------------------------------------------------------------ writing
    def _bucket_locked(self, kind, now):
        sec = int(now)
        dq = self._routes.get(kind)
        if dq is None:
            dq = self._routes[kind] = []
        if dq and dq[-1][0] == sec:
            return dq[-1]
        b = [sec, 0, 0, 0, 0.0, [0] * (len(LATENCY_LADDER) + 1)]
        dq.append(b)
        # prune: nothing older than the long window ever aggregates
        cut = now - self.window_s - 2.0
        while dq and dq[0][0] < cut:
            dq.pop(0)
        return b

    def record(self, route, latency_s, error=False):
        """One completed request: latency submit->result; ``error`` for
        futures resolved with an exception (they count against the
        error rate, not the latency quantiles' happy path — but their
        latency is recorded too, slow failures are still slow)."""
        now = self.clock()
        with self._lock:
            b = self._bucket_locked(route_kind(route), now)
            i = bisect.bisect_left(LATENCY_LADDER, float(latency_s))
            b[5][i] += 1
            b[1] += 1
            b[4] += float(latency_s)
            if error:
                b[2] += 1
            due = (now - self._last_eval) >= self._eval_s
            if due:
                self._last_eval = now
        if due:
            self.evaluate(now)

    def record_shed(self, route, reason="queue_full"):
        """One request rejected at admission (overload protection)."""
        now = self.clock()
        with self._lock:
            b = self._bucket_locked(route_kind(route), now)
            b[3] += 1
            due = (now - self._last_eval) >= self._eval_s
            if due:
                self._last_eval = now
        if due:
            self.evaluate(now)

    # ----------------------------------------------------------- reading
    def _aggregate_locked(self, now, horizon, kind=None):
        """(n, err, shed, lat_sum, counts) over buckets newer than
        ``now - horizon`` (1-second bucket granularity)."""
        cut = now - horizon
        n = err = shed = 0
        lat = 0.0
        counts = [0] * (len(LATENCY_LADDER) + 1)
        items = ([(kind, self._routes.get(kind, []))] if kind is not None
                 else list(self._routes.items()))
        for _, dq in items:
            for b in reversed(dq):
                if b[0] < cut:
                    break
                n += b[1]
                err += b[2]
                shed += b[3]
                lat += b[4]
                for i, c in enumerate(b[5]):
                    counts[i] += c
        return n, err, shed, lat, counts

    @staticmethod
    def _pct(counts, n, q):
        """Quantile as a ladder upper bound (conservative)."""
        target = max(1, int(math.ceil(q * n)))
        acc = 0
        for i, c in enumerate(counts):
            acc += c
            if acc >= target:
                if i < len(LATENCY_LADDER):
                    return LATENCY_LADDER[i]
                break
        return LATENCY_LADDER[-1] * _RATIO

    @staticmethod
    def _frac_over(counts, n, target_s):
        """Fraction of requests strictly over ``target_s``.  Counted
        from the first ladder bucket whose entire range exceeds the
        target — never a false positive from the bucket the target
        itself lands in."""
        if n <= 0:
            return 0.0
        j = bisect.bisect_left(LATENCY_LADDER, float(target_s))
        return sum(counts[j + 1:]) / n

    def _stats(self, agg, horizon):
        n, err, shed, lat, counts = agg
        out = {"n": n, "qps": round(n / horizon, 3), "shed": shed}
        if shed:
            out["shed_rate"] = round(shed / float(n + shed), 4)
        if n:
            out["p50_s"] = round(self._pct(counts, n, 0.50), 6)
            out["p95_s"] = round(self._pct(counts, n, 0.95), 6)
            out["p99_s"] = round(self._pct(counts, n, 0.99), 6)
            out["mean_s"] = round(lat / n, 6)
            out["err_rate"] = round(err / n, 4)
        return out

    # -------------------------------------------------------- evaluation
    def evaluate(self, now=None, force_snapshot=False):
        """Aggregate both windows, update the alert state machine, and
        emit the periodic ``serve_slo`` snapshot.  Called from the
        record path on its own cadence and from ``close(force=True)``
        so short-lived servers still leave one snapshot."""
        if now is None:
            now = self.clock()
        with self._lock:
            long_all = self._aggregate_locked(now, self.window_s)
            short_all = self._aggregate_locked(now, self.short_s)
            per_route = {
                k: self._stats(self._aggregate_locked(
                    now, self.window_s, kind=k), self.window_s)
                for k in sorted(self._routes)}
        overall = self._stats(long_all, self.window_s)
        burn_long = burn_short = 0.0
        if self.p99_target_s > 0:
            n_l, _, _, _, c_l = long_all
            n_s, _, _, _, c_s = short_all
            burn_long = self._frac_over(c_l, n_l,
                                        self.p99_target_s) / P99_BUDGET
            burn_short = self._frac_over(c_s, n_s,
                                         self.p99_target_s) / P99_BUDGET
            self._m_burn.set(round(burn_long, 3))
        verdicts = {}
        if self.p99_target_s > 0 and overall.get("n"):
            verdicts["p99"] = ("ok" if overall["p99_s"]
                               <= self.p99_target_s else "fail")
        if self.qps_target > 0:
            verdicts["qps"] = ("ok" if overall["qps"] >= self.qps_target
                               else "fail")
        # the most recent evaluated window, for headline()
        self._last_overall = overall
        self._last_verdicts = verdicts
        transition = None
        if self.p99_target_s > 0:
            if (not self.alerting and burn_short >= self.burn_threshold
                    and burn_long >= self.burn_threshold):
                self.alerting = True
                self.alerts_fired += 1
                self._m_alerts.inc()
                transition = "firing"
            elif self.alerting and burn_short < self.burn_threshold:
                self.alerting = False
                self.alerts_cleared += 1
                transition = "cleared"
        obs = self.observer
        if obs.enabled and (force_snapshot or self.every_s > 0):
            rec = {"window_s": self.window_s, "short_s": self.short_s,
                   "routes": per_route, "overall": overall,
                   "alert": "firing" if self.alerting else "clear"}
            targets = {}
            if self.p99_target_s > 0:
                targets["p99_ms"] = self.p99_target_s * 1e3
                rec["burn_short"] = round(burn_short, 3)
                rec["burn_long"] = round(burn_long, 3)
            if self.qps_target > 0:
                targets["qps"] = self.qps_target
            if targets:
                rec["targets"] = targets
            if verdicts:
                rec["verdicts"] = verdicts
            obs.event("serve_slo", **rec)
        if transition is not None:
            self._emit_alert(transition, burn_short, burn_long, overall)
        return overall

    def _emit_alert(self, transition, burn_short, burn_long, overall):
        detail = {
            "burn_short": round(burn_short, 3),
            "burn_long": round(burn_long, 3),
            "threshold": self.burn_threshold,
            "p99_target_ms": round(self.p99_target_s * 1e3, 3),
            "p99_s": overall.get("p99_s"),
            "qps": overall.get("qps"),
            "cleared": transition == "cleared",
        }
        if transition == "firing":
            Log.warning(
                "serve slo: burn-rate alert FIRING — %.1fx/%.1fx of the "
                "p99<=%.1fms error budget (short/long window, "
                "threshold %.1fx)", burn_short, burn_long,
                self.p99_target_s * 1e3, self.burn_threshold)
        else:
            Log.warning("serve slo: burn-rate alert cleared "
                        "(short-window burn %.1fx)", burn_short)
        if self.mode == "off":
            return
        obs = self.observer
        if not obs.enabled:
            return
        status = ("warn" if (self.mode == "warn"
                             or "slo_burn_rate" in _WARN_ONLY)
                  else "fatal")
        if transition == "cleared":
            status = "ok"
        obs.event("health", check="slo_burn_rate", status=status, it=-1,
                  detail=detail)
        obs.flush()

    def summary(self):
        return {"alerting": self.alerting,
                "alerts_fired": self.alerts_fired,
                "alerts_cleared": self.alerts_cleared,
                "targets": {"p99_ms": self.p99_target_s * 1e3,
                            "qps": self.qps_target}}

    def headline(self):
        """One-dict SLO digest (registered as a flight provider by
        ServingPredictor): alert state + the most
        recent evaluated window's overall stats and verdicts."""
        out = self.summary()
        if self._last_overall is not None:
            out["overall"] = dict(self._last_overall)
        if self._last_verdicts:
            out["verdicts"] = dict(self._last_verdicts)
        return out

    def close(self):
        """Final forced snapshot: a server that lived shorter than one
        snapshot period still leaves its SLO record on the timeline."""
        try:
            self.evaluate(force_snapshot=True)
        except Exception as e:       # forensics must never break close
            Log.warning("serve slo: final snapshot failed: %s", e)


# ======================================================================
# reader side: timeline -> serving report (obs serve / obs summary)
# ======================================================================

def serve_events(events):
    return [e for e in events
            if str(e.get("ev", "")).startswith("serve_")]


def serve_metrics(events):
    """Fold a timeline's serving events into one report dict.  Lifetime
    totals come from the ``serve_summary`` close record when present
    (exact), else from summing the SAMPLED serve_batch events (lower
    bound, flagged ``sampled``)."""
    batches = [e for e in events if e.get("ev") == "serve_batch"]
    reqs = [e for e in events if e.get("ev") == "serve_request"]
    slos = [e for e in events if e.get("ev") == "serve_slo"]
    summaries = [e for e in events if e.get("ev") == "serve_summary"]
    benches = [e for e in events if e.get("ev") == "serve_bench"]
    alerts = [e for e in events if e.get("ev") == "health"
              and e.get("check") == "slo_burn_rate"]
    out = {"present": bool(batches or reqs or slos or summaries
                           or benches)}
    if not out["present"]:
        return out
    if summaries:
        s = summaries[-1]
        out["totals"] = {"batches": s.get("batches", 0),
                         "rows": s.get("rows", 0),
                         "pad_rows": s.get("pad_rows", 0),
                         "max_queue_depth": s.get("max_queue_depth", 0),
                         "shed_total": s.get("shed_total", 0),
                         "shed": dict(s.get("shed") or {}),
                         "sampled": False}
    else:
        out["totals"] = {
            "batches": len(batches),
            "rows": sum(int(e.get("rows", 0)) for e in batches),
            "pad_rows": sum(int(e.get("pad", 0)) for e in batches),
            "max_queue_depth": None,
            "shed_total": sum(int(e.get("shed", 0)) for e in benches),
            "shed": {},
            "sampled": True}
    t = out["totals"]
    slots = t["rows"] + t["pad_rows"]
    t["batch_efficiency"] = round(t["rows"] / slots, 4) if slots else None

    # per-route latency from sampled request traces
    routes = {}
    for e in reqs:
        k = _kind_from_event(e)
        r = routes.setdefault(k, {"n": 0, "lat": [], "rows": 0,
                                  "spans": {}})
        r["n"] += 1
        r["rows"] += int(e.get("rows", 0))
        if e.get("total_s") is not None:
            r["lat"].append(float(e["total_s"]))
        for name, v in (e.get("spans") or {}).items():
            r["spans"][name] = r["spans"].get(name, 0.0) + float(v)
    for k, r in routes.items():
        lat = sorted(r.pop("lat"))
        if lat:
            r["p50_s"] = _pct_sorted(lat, 0.50)
            r["p95_s"] = _pct_sorted(lat, 0.95)
            r["p99_s"] = _pct_sorted(lat, 0.99)
            r["mean_s"] = sum(lat) / len(lat)
        r["spans"] = {name: round(v / max(r["n"], 1), 6)
                      for name, v in sorted(r["spans"].items())}
    out["routes"] = routes

    # per-route microbatch shape from sampled serve_batch events
    broutes = {}
    for e in batches:
        k = _kind_from_event(e)
        b = broutes.setdefault(k, {"batches": 0, "rows": 0, "pad": 0,
                                   "requests": 0, "queue": [],
                                   "exec": []})
        b["batches"] += 1
        b["rows"] += int(e.get("rows", 0))
        b["pad"] += int(e.get("pad", 0))
        b["requests"] += int(e.get("requests", 1))
        b["queue"].append(float(e.get("queue_s", 0.0)))
        b["exec"].append(float(e.get("exec_s", 0.0)))
    for k, b in broutes.items():
        q, x = sorted(b.pop("queue")), sorted(b.pop("exec"))
        b["queue_p50_s"] = _pct_sorted(q, 0.50)
        b["exec_p50_s"] = _pct_sorted(x, 0.50)
        slots = b["rows"] + b["pad"]
        b["efficiency"] = round(b["rows"] / slots, 4) if slots else None
    out["batch_routes"] = broutes

    if slos:
        out["slo"] = slos[-1]
    if benches:
        out["bench"] = benches[-1]
    fired = [a for a in alerts if a.get("status") != "ok"]
    out["alerts"] = {
        "fired": len(fired),
        "cleared": len(alerts) - len(fired),
        "active": bool(alerts) and alerts[-1].get("status") != "ok",
        "last": alerts[-1] if alerts else None}
    return out


def serve_headline(events):
    """The one-line serving digest for ``obs summary`` /
    trace_summary.py: totals + efficiency + shed + last p99."""
    m = serve_metrics(events)
    if not m.get("present"):
        return None
    t = m["totals"]
    head = {"batches": t["batches"], "rows": t["rows"],
            "batch_efficiency": t["batch_efficiency"],
            "shed_total": t["shed_total"], "sampled": t["sampled"],
            "alerts_fired": m["alerts"]["fired"]}
    slo = m.get("slo")
    if slo:
        head["p99_s"] = (slo.get("overall") or {}).get("p99_s")
        head["qps"] = (slo.get("overall") or {}).get("qps")
    bench = m.get("bench")
    if bench:
        head.setdefault("p99_s", bench.get("p99_s"))
        head.setdefault("qps", bench.get("qps"))
    return head


def serve_roofline(events):
    """Roofline rows for the per-bucket serving programs.

    serve/executable.py announces each bucket's graph capture as a
    ``compile_attr`` event named ``serve_predict_b<bucket>[_conv]``; the
    sampled ``serve_batch`` events time the same buckets' executes.  A
    capture's cost is that of the kernel launches it recorded
    (obs/compile.py); the port's traversal is plain torch and records
    none, so its buckets carry no cost and this returns no row for them
    (a timeline of the JAX package's, whose XLA programs carry a cost
    analysis, gets its rows)."""
    from .roofline import entry_roofline, peaks_for
    costs = {}
    for e in events:
        if e.get("ev") == "compile_attr" and e.get("cost") \
                and str(e.get("entry", "")).startswith("serve_predict_b"):
            costs[e["entry"]] = e["cost"]
    if not costs:
        return []
    header = next((e for e in events if e.get("ev") == "run_header"), {})
    kind = ""
    for d in header.get("devices") or ():
        if isinstance(d, dict) and d.get("kind"):
            kind = str(d["kind"])
            break
    peaks = peaks_for(kind or str(header.get("backend", "") or ""))
    # executes per bucket from the sampled microbatch events
    execs = {}
    for e in events:
        if e.get("ev") != "serve_batch":
            continue
        b = e.get("bucket")
        execs.setdefault(b, []).append(float(e.get("exec_s", 0.0)))
    rows = []
    for entry, cost in sorted(costs.items()):
        suffix = entry[len("serve_predict_b"):]
        try:
            bucket = int(suffix.split("_")[0])
        except ValueError:
            bucket = None
        xs = execs.get(bucket) or []
        mean = (sum(xs) / len(xs)) if xs else 0.0
        r = entry_roofline(cost, mean, len(xs), peaks)
        r["entry"] = entry
        r["bucket"] = bucket
        r["timed"] = bool(xs)
        r["roof_source"] = peaks.get("source")
        rows.append(r)
    rows.sort(key=lambda r: -r["headroom_s"])
    return rows


def _ms(v):
    return "-" if v is None else "%.2f" % (float(v) * 1e3)


def render_serve_report(events, out=None, check=False):
    """Print the serving report; returns the list of problems (empty =
    healthy).  ``check`` only changes the verdict footer text — the
    caller turns problems into an exit code."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    m = serve_metrics(events)
    problems = []
    w("== serving report ==")
    if not m.get("present"):
        w("no serving events in this timeline (serve_batch / "
          "serve_request / serve_slo / serve_summary / serve_bench)")
        problems.append("no serving events in timeline")
        return problems
    t = m["totals"]
    src = "sampled serve_batch events (lower bound)" if t["sampled"] \
        else "serve_summary (exact lifetime totals)"
    w("totals [%s]:" % src)
    w("  batches %s   rows %s   pad rows %s   max queue depth %s"
      % (t["batches"], t["rows"], t["pad_rows"],
         "-" if t["max_queue_depth"] is None else t["max_queue_depth"]))
    if t["batch_efficiency"] is not None:
        w("  batch efficiency %.1f%% (rows / padded slots)"
          % (100.0 * t["batch_efficiency"]))

    if m.get("routes"):
        w("")
        w("per-route latency (sampled serve_request traces):")
        w("  %-10s %6s %10s %10s %10s %10s" %
          ("route", "n", "p50_ms", "p95_ms", "p99_ms", "mean_ms"))
        for k in sorted(m["routes"]):
            r = m["routes"][k]
            w("  %-10s %6d %10s %10s %10s %10s"
              % (k, r["n"], _ms(r.get("p50_s")), _ms(r.get("p95_s")),
                 _ms(r.get("p99_s")), _ms(r.get("mean_s"))))
            if r.get("spans"):
                w("  %-10s   spans(ms): %s" % ("", "  ".join(
                    "%s=%s" % (name.replace("_s", ""), _ms(v))
                    for name, v in r["spans"].items())))
    if m.get("batch_routes"):
        w("")
        w("per-route microbatches (sampled serve_batch events):")
        w("  %-10s %8s %9s %8s %6s %9s %12s %11s" %
          ("route", "batches", "rows", "pad", "eff%", "req/batch",
           "queue_p50_ms", "exec_p50_ms"))
        for k in sorted(m["batch_routes"]):
            b = m["batch_routes"][k]
            eff = ("-" if b["efficiency"] is None
                   else "%.1f" % (100.0 * b["efficiency"]))
            w("  %-10s %8d %9d %8d %6s %9.1f %12s %11s"
              % (k, b["batches"], b["rows"], b["pad"], eff,
                 b["requests"] / max(b["batches"], 1),
                 _ms(b["queue_p50_s"]), _ms(b["exec_p50_s"])))

    slo = m.get("slo")
    w("")
    if slo:
        targets = slo.get("targets") or {}
        tgt = "  ".join(filter(None, [
            ("p99<=%.1fms" % targets["p99_ms"]) if "p99_ms" in targets
            else "",
            ("qps>=%g" % targets["qps"]) if "qps" in targets else ""]))
        w("SLO (window %gs%s):" % (slo.get("window_s", 0),
                                   (", targets " + tgt) if tgt else ""))
        overall = slo.get("overall") or {}
        w("  overall: qps %s  p50 %sms  p99 %sms  n %s"
          % (overall.get("qps", "-"), _ms(overall.get("p50_s")),
             _ms(overall.get("p99_s")), overall.get("n", "-")))
        for name, verdict in sorted((slo.get("verdicts") or {}).items()):
            w("  verdict %-4s: %s" % (name, verdict.upper()))
            if verdict != "ok":
                problems.append("SLO verdict %s=FAIL" % name)
        if "burn_long" in slo:
            w("  burn rate: short %sx, long %sx (threshold %gx) — %s"
              % (slo.get("burn_short"), slo.get("burn_long"),
                 BURN_THRESHOLD, slo.get("alert", "clear")))
    else:
        w("SLO: no serve_slo snapshots on this timeline "
          "(set serve_slo_every_s / serve_slo_p99_ms)")

    a = m["alerts"]
    w("")
    w("overload & shedding:")
    shed_bits = ", ".join("%s %d" % (k, v)
                          for k, v in sorted(t["shed"].items()))
    w("  shed: %d request(s)%s" % (t["shed_total"],
                                   (" (%s)" % shed_bits) if shed_bits
                                   else ""))
    w("  burn-rate alerts: %d fired, %d cleared%s"
      % (a["fired"], a["cleared"],
         "  [ACTIVE]" if a["active"] else ""))
    if t["shed_total"]:
        problems.append("%d shed request(s)" % t["shed_total"])
    if a["fired"]:
        problems.append("%d burn-rate alert(s) fired" % a["fired"])

    bench = m.get("bench")
    if bench:
        w("")
        w("bench: qps %s  p50 %sms  p99 %sms%s"
          % (bench.get("qps"), _ms(bench.get("p50_s")),
             _ms(bench.get("p99_s")),
             ("  shed_rate %s" % bench.get("shed_rate")
              if bench.get("shed_rate") is not None else "")))

    rl = serve_roofline(events)
    if rl:
        w("")
        w("executable roofline (achieved vs %s peaks, obs/roofline.py):"
          % (rl[0].get("roof_source", "?")))
        w("  %-26s %7s %10s %6s %6s %-18s %9s" %
          ("entry", "execs", "exec_p50", "MXU%", "HBM%", "bound",
           "headroom"))
        for r in rl:
            w("  %-26s %7d %8.3fms %5.1f%% %5.1f%% %-18s %8.4fs%s"
              % (r["entry"][:26], r["exec_n"], r["exec_mean_s"] * 1e3,
                 100 * r["flop_util"], 100 * r["hbm_util"], r["bound"],
                 r["headroom_s"],
                 "" if r["timed"] else "  (no sampled executes)"))
    w("")
    if problems:
        w("verdict: %s — %s" % ("FAIL" if check else "UNHEALTHY",
                                "; ".join(problems)))
    else:
        w("verdict: %s" % ("PASS" if check else "healthy"))
    return problems
