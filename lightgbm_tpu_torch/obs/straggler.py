"""Distributed straggler profiling: per-rank busy-time skew.

Ported from the JAX package's ``obs/straggler.py``.  Under the
distributed learners every histogram all-reduce is a barrier: it ends
when the *slowest* rank arrives, so one lagging rank serializes the
world -- the per-device load imbalance arxiv 1809.04559 measures as the
dominant multi-GPU cost.  The JAX package times when each shard of one
process's row-sharded array becomes readable; in the port a rank is a
process with one device, and the barrier hides a slow rank's lateness in
every other rank's collectives.  So each rank measures, over the window
since its last sample, its *busy* time: the wall time (to a fence on
its device) less the time it spent inside collectives (``HostComm``
``stats``), which is the time it waited for the others.  The ranks
exchange their busy times (one host collective, ``allgather_obj``).

``StragglerProfiler`` samples this every ``obs_straggler_every``
iterations (sampled, because each sample is a fence and a collective).
Ordered by busy time, each rank's marginal wait is the time it kept the
world waiting beyond the ranks before it, and

    ``skew = (max_wait - median_wait) / total_wait``

is the fraction of the window spent waiting on the single slowest rank
beyond the typical one.  Each sample lands in the timeline as a
``straggler`` event (``devices`` lists the ranks, ``axis`` is
``ranks``); skew above ``obs_straggler_warn_skew`` goes through the
health channel (a ``health`` event with ``check="straggler_skew"`` and
the monitors' warn counter); ``run_end`` carries the rolling summary
with the slowest-rank attribution.  A run of one rank has nothing to
compare: the sampler counts the skip and stays silent.
"""
from __future__ import annotations

import time

from ..utils.log import Log


class StragglerProfiler:
    """Rolling straggler state driven by the observer's
    ``straggler_sample`` hook (every ``obs_straggler_every`` iters)."""

    def __init__(self, every=0, warn_skew=0.5, registry=None, comm=None):
        if registry is None:
            from .metrics import REGISTRY
            registry = REGISTRY
        self._registry = registry
        self.comm = comm if comm is not None and comm.size > 1 else None
        self.every = max(0, int(every))
        self.warn_skew = float(warn_skew)
        self.samples = 0
        self.skipped_single = 0
        self.warned = 0
        self.max_skew = 0.0
        self.max_skew_it = -1
        self.slowest_counts = {}      # rank -> times it was slowest
        self._mark = None             # (wall time, comm wait) at the
        #                               window's start

    def due(self, it):
        return self.every > 0 and it % self.every == 0

    def _now(self):
        st = self.comm.stats
        return time.time(), st["seconds"] + st["host_seconds"]

    def mark(self):
        """Start the first window (the first iteration's start)."""
        if self.comm is not None and self._mark is None:
            self._mark = self._now()

    def sample(self, obs, it, value):
        """Wait for this rank's ``value`` on its device, exchange the
        ranks' busy times over the window since the last sample and emit
        a ``straggler`` event.  A fence and a collective: call it only on
        the sampling cadence, on every rank."""
        if self.comm is None:
            self.skipped_single += 1
            return
        from .timers import fence
        fence(value)
        self.mark()
        (t0, w0), (t1, w1) = self._mark, self._now()
        busy = self.comm.allgather_obj(max((t1 - t0) - (w1 - w0), 0.0))
        self._mark = self._now()
        order = sorted(range(len(busy)), key=lambda r: busy[r])
        waits, prev = [], 0.0
        for r in order:
            waits.append((r, busy[r] - prev))
            prev = busy[r]
        total = sum(w for _, w in waits)
        ordered = sorted(w for _, w in waits)
        median = ordered[len(ordered) // 2]
        slowest, max_wait = max(waits, key=lambda p: p[1])
        skew = (max_wait - median) / total if total > 0 else 0.0
        self.samples += 1
        self.slowest_counts[slowest] = self.slowest_counts.get(slowest,
                                                               0) + 1
        if skew > self.max_skew:
            self.max_skew, self.max_skew_it = skew, it
        obs.event("straggler", it=it, axis="ranks",
                  devices=[{"id": r, "wait_s": round(w, 6)}
                           for r, w in sorted(waits)],
                  skew=round(skew, 4), slowest=slowest,
                  total_s=round(total, 6))
        self._registry.counter(
            "lgbm_straggler_samples_total",
            "per-rank arrival-skew samples taken").inc()
        self._registry.gauge(
            "lgbm_straggler_max_skew",
            "worst observed per-rank arrival skew this run").set(
                self.max_skew)
        if skew > self.warn_skew:
            self.warned += 1
            detail = {"skew": round(skew, 4), "slowest": slowest,
                      "axis": "ranks", "threshold": self.warn_skew}
            obs.event("health", check="straggler_skew", status="warn",
                      it=it, detail=detail)
            if obs.health is not None:
                obs.health.counts["warn"] += 1
            Log.warning("obs: straggler skew %.0f%% at iter %d (rank %d "
                        "slowest)", 100.0 * skew, it, slowest)

    def summary(self):
        """Folded into run_end: rolling attribution of who straggled."""
        return {"every": self.every, "samples": self.samples,
                "skipped_single_device": self.skipped_single,
                "warned": self.warned, "warn_skew": self.warn_skew,
                "max_skew": round(self.max_skew, 4),
                "max_skew_it": self.max_skew_it,
                "slowest_counts": {str(k): v for k, v in
                                   sorted(self.slowest_counts.items())}}
