"""Training health monitors: catch sick runs while they are cheap.

The port's copy of the JAX package's ``obs/health.py``.  The monitors
watch the quantities the training loop already has on the card and emit
``health`` events into the run timeline (events.py) the moment
something is off:

* **non-finite guard** -- gradients, hessians and the grown trees' leaf
  values.  One ``mean(abs(x))`` reduction per array on the device: the
  mean is NaN/Inf iff any element is non-finite, so one scalar answers
  both "is it finite" and "how big is it".  The scalars are stacked on
  the device and read in one counted read (``timers.fenced_get``), only
  on the iterations the cadence makes due.
* **EMA divergence / plateau** -- an exponential moving average over
  the gradient magnitude of each checked iteration.  Divergence fires
  after two consecutive checks above ``divergence x EMA``; plateau after
  ``plateau`` consecutive checks with relative EMA movement under 1e-4
  (informational, never fatal).
* **memory watermark** -- per-device ``bytes_in_use`` against
  ``bytes_limit`` where there is a card (on the CPU the check is a
  no-op), with the peak fraction tracked per device.

``obs_health`` picks the consequence: ``off`` (no monitors), ``warn``
(log + ``health`` event), ``fatal`` (log + event + flush the timeline +
raise LightGBMError).  Cadence: ``obs_health_every``.  Warn-channel
events are edge-triggered: a check that keeps failing emits one
``health`` event and stays silent until a clean evaluation re-arms it
or it escalates to fatal.
"""
from __future__ import annotations

import math

from ..utils.log import Log

MODES = ("off", "warn", "fatal")

# checks that never abort the run even under obs_health=fatal: a flat
# loss is a tuning smell, not a poisoned run, and an SLO burn-rate alert
# (obs/serve.py) is a paging signal for operators -- killing the server
# that is already missing latency targets only makes the outage total.
# Drift and input anomalies (obs/drift.py) are retrain signals for the
# continuous-training loop for the same reason: the model still serves,
# it just serves traffic it was not trained on.
_WARN_ONLY = frozenset(("plateau", "slo_burn_rate", "drift",
                        "serve_input", "online_quality"))

_PLATEAU_REL = 1e-4


def _finite(x):
    return math.isfinite(x)


class HealthMonitors:
    """Stateful per-run monitor set.  The training loop stages device
    reductions while the iteration is in flight (``stage_gradients``,
    ``stage_leaf_values``) and the observer triggers the single host
    sync + verdicts at iteration end (``run_checks``)."""

    def __init__(self, mode="warn", every=1, divergence=3.0, plateau=0,
                 mem_frac=0.9, ema_alpha=0.3):
        if mode not in MODES:
            raise ValueError("obs_health mode %r (expected off/warn/fatal)"
                             % (mode,))
        self.mode = mode
        self.every = max(1, int(every))
        self.divergence = float(divergence)
        self.plateau = int(plateau)
        self.mem_frac = float(mem_frac)
        self.ema_alpha = float(ema_alpha)
        self._staged = None            # (mean|g|, mean|h|) device scalars
        self._staged_leaves = None     # max|leaf_value| device scalar
        self._ema = None
        self._diverging = 0
        self._flat = 0
        self.mem_peak_frac = {}        # device id -> peak in_use/limit
        self.counts = {"ok": 0, "warn": 0, "fatal": 0}
        self._firing = {}              # check -> status last emitted

    # ----------------------------------------------------------- staging
    def due(self, it):
        return it % self.every == 0

    def stage_gradients(self, g_dev, h_dev):
        """Launch the finiteness/magnitude reductions without a wait; the
        results are read in run_checks."""
        self._staged = (g_dev.abs().mean(), h_dev.abs().mean())

    def stage_leaf_values(self, leaf_values):
        """``leaf_values``: device tensors of the leaf outputs grown this
        iteration (one per tree)."""
        if leaf_values:
            import torch
            self._staged_leaves = torch.stack(
                [lv.abs().max() for lv in leaf_values]).max()

    # ----------------------------------------------------------- verdicts
    def run_checks(self, obs, it):
        """One counted read of the staged scalars, then verdicts.  Emits
        a ``health`` stats event plus one event per firing check; raises
        LightGBMError under mode='fatal'."""
        import torch
        from .timers import fenced_get
        staged = list(self._staged or ())
        has_leaves = self._staged_leaves is not None
        if has_leaves:
            staged.append(self._staged_leaves)
        self._staged = None
        self._staged_leaves = None
        if not staged:
            return
        host = fenced_get(torch.stack(
            [s.reshape(()).to(torch.float64) for s in staged])).tolist()
        stats = {}
        problems = []
        g_mean = h_mean = None
        if len(host) >= 2 + (1 if has_leaves else 0):
            g_mean, h_mean = host[0], host[1]
            stats["grad_abs_mean"] = g_mean
            stats["hess_abs_mean"] = h_mean
            if not _finite(g_mean) or not _finite(h_mean):
                problems.append(("nonfinite_gradients",
                                 {"grad_abs_mean": repr(g_mean),
                                  "hess_abs_mean": repr(h_mean)}))
        if has_leaves:
            leaf_max = host[-1]
            stats["leaf_abs_max"] = leaf_max
            if not _finite(leaf_max):
                problems.append(("nonfinite_leaf_values",
                                 {"leaf_abs_max": repr(leaf_max)}))
        problems.extend(self._trend(g_mean))
        status = "ok" if not problems else self.mode
        obs.event("health", check="stats", status=status, it=it,
                  detail=stats)
        self.counts["ok" if not problems else self.mode] += 1
        evaluated = set()
        if g_mean is not None:
            evaluated.update(("nonfinite_gradients", "loss_divergence",
                              "plateau"))
        if has_leaves:
            evaluated.add("nonfinite_leaf_values")
        self._resolve(obs, it, problems, evaluated=evaluated)

    def _trend(self, g_mean):
        """EMA divergence / plateau over the gradient-magnitude series."""
        out = []
        if g_mean is None or not _finite(g_mean):
            return out
        if self._ema is None:
            self._ema = g_mean
            return out
        prev = self._ema
        if self.divergence > 0 and g_mean > self.divergence * prev + 1e-300:
            self._diverging += 1
            if self._diverging >= 2:
                out.append(("loss_divergence",
                            {"grad_abs_mean": g_mean, "ema": prev,
                             "factor": self.divergence,
                             "consecutive": self._diverging}))
        else:
            self._diverging = 0
        self._ema = (1.0 - self.ema_alpha) * prev + self.ema_alpha * g_mean
        rel = abs(self._ema - prev) / max(abs(prev), 1e-300)
        if self.plateau > 0:
            if rel < _PLATEAU_REL:
                self._flat += 1
                if self._flat >= self.plateau:
                    out.append(("plateau",
                                {"ema": self._ema, "rel_change": rel,
                                 "checks": self._flat}))
                    self._flat = 0
            else:
                self._flat = 0
        return out

    def check_memory(self, obs, it, devices=None):
        """Per-device in-use/limit watermark; ``devices`` reuses an
        already-captured memory snapshot when the cadences line up."""
        if self.mem_frac <= 0:
            return
        if devices is None:
            from .memory import device_memory_stats
            devices = device_memory_stats()
        problems = []
        for d in devices:
            limit = d.get("bytes_limit", 0)
            in_use = d.get("bytes_in_use")
            if not limit or in_use is None:
                continue          # CPU backend: identity rows only
            frac = in_use / limit
            did = d["id"]
            if frac > self.mem_peak_frac.get(did, 0.0):
                self.mem_peak_frac[did] = frac
            if frac > self.mem_frac:
                problems.append(("memory_watermark",
                                 {"device": did, "bytes_in_use": in_use,
                                  "bytes_limit": limit,
                                  "frac": round(frac, 4),
                                  "threshold": self.mem_frac}))
        if problems:
            self.counts[self.mode] += 1
        self._resolve(obs, it, problems, evaluated=("memory_watermark",))

    # ------------------------------------------------------------ actions
    def _resolve(self, obs, it, problems, evaluated=()):
        """Emit one ``health`` event per firing check -- edge-triggered
        on the warn channel: a check already firing at ``warn`` stays
        silent until a clean evaluation (``evaluated`` names the checks
        this call assessed) re-arms it or it escalates to fatal.  Fatal
        verdicts are never deduplicated: they abort the run."""
        fatal = []
        firing = set()
        for check, detail in problems:
            status = ("warn" if (self.mode == "warn"
                                 or check in _WARN_ONLY) else "fatal")
            firing.add(check)
            if status == "warn" and self._firing.get(check) == "warn":
                continue
            self._firing[check] = status
            obs.event("health", check=check, status=status, it=it,
                      detail=detail)
            Log.warning("health[%s] %s at iteration %d: %s",
                        status, check, it, detail)
            if status == "fatal":
                fatal.append(check)
        for check in evaluated:
            if check not in firing:
                self._firing.pop(check, None)
        if fatal:
            obs.flush()           # the timeline must survive the raise
            try:                  # black box for the abort (obs/watchdog.py)
                obs.flight("obs_health=fatal: %s" % "/".join(fatal),
                           extra={"it": it, "checks": fatal})
            except Exception:
                pass
            Log.fatal("obs_health=fatal: %s tripped at iteration %d "
                      "(timeline has the health event)"
                      % ("/".join(fatal), it))

    def verdict(self):
        """Worst verdict recorded so far."""
        if self.counts.get("fatal"):
            return "fatal"
        if self.counts.get("warn"):
            return "warn"
        return "ok"

    def summary(self):
        """Folded into run_end: verdict counts + per-device memory peaks."""
        out = {"mode": self.mode, "counts": dict(self.counts)}
        if self.mem_peak_frac:
            out["mem_peak_frac"] = {str(k): round(v, 4)
                                    for k, v in self.mem_peak_frac.items()}
        return out
