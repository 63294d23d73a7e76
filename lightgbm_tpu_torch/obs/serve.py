"""Serving-tier SLOs: the rolling window, burn-rate alerts.

Ported from the JAX package's ``obs/serve.py`` (its writer side; the
timeline reports of ``obs serve`` are not in the port yet).  The
microbatch scheduler feeds ``SloEngine`` one ``record()`` per completed
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
