"""Hang watchdog + flight recorder.

The port's copy of the JAX package's ``obs/watchdog.py`` (pure stdlib
there too; device memory comes from obs/memory.py through
``torch.cuda``).  The port trains in one process, so its watchdog is
armed by per-iteration progress, by the serve worker around each
runner call, and around each host collective of the distributed
learners (parallel/comm.py ``_CollectiveGuard``).

The failure mode a pod gets for free is a collective that never
returns: one rank dies or stalls, every other rank parks inside the
barrier, and the job burns its reservation in silence — no exception,
no log line, no timeline record past the last flush.  The watchdog is
the forensics for exactly that death.

``Watchdog`` is a daemon thread armed by the observer around blocking
regions (host collectives in ``parallel/comm.py``) and re-armed by
per-iteration progress (``iter_begin``/``iter_end``).  When no progress
lands within ``obs_watchdog_secs`` it dumps a **flight record** next to
the rank's timeline shard (``<events_path>.flight.json``):

* the ring buffer of the last N events (``RingBuffer`` in events.py) —
  what this rank was doing right before it stopped;
* the armed label — which collective/iteration hung, with its ``seq``;
* every Python thread's stack via ``sys._current_frames`` (the
  ``faulthandler``-style view, but structured);
* live per-device memory stats and the current metrics-registry
  snapshot;
* any registered flight-context providers (``obs.add_flight_provider``)
  — the serve scheduler reports queue depth, queued rows and pending
  route kinds, so a wedged serve runner's dump shows what was stuck
  behind it.

The serve worker thread arms the same watchdog around every runner call
(serve/scheduler.py), so a microbatch that never returns — a hung device
call, a deadlocked host predictor — dumps the same flight record a hung
collective would.

The same dump fires on SIGTERM (the scheduler killing the job) and on
``obs_health=fatal`` aborts, so "the run died" always leaves a black
box.  The watchdog only observes — it never kills the run itself; the
simulated-rank barrier timeout (comm.py) and the cluster scheduler stay
in charge of actually reaping a hung job.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time

from ..utils.log import Log


def _thread_stacks():
    """{thread label: [frame lines]} for every live Python thread.

    Delegates to the one shared ``sys._current_frames`` walker in
    obs/prof.py — flight records, incident evidence and the sampling
    profiler must agree on thread labeling, so there is exactly one
    capture path."""
    from .prof import capture_thread_stacks
    return capture_thread_stacks()


def dump_flight_record(obs, reason, label=None, extra=None):
    """Write ``<events_path>.flight.json`` for ``obs`` and return the
    path (None when the observer has no events path to anchor it to).
    Best-effort everywhere: forensics must never raise into the run."""
    path = getattr(obs, "flight_path", "")
    record = {
        "reason": str(reason),
        "label": label if label is not None else getattr(
            getattr(obs, "_watchdog", None), "label", None),
        "t": time.time(),
        "run": getattr(obs, "run_id", None),
        "rank": getattr(obs, "rank", 0),
        "world_size": getattr(obs, "world_size", 1),
        "pid": os.getpid(),
        "events": obs.ring_snapshot(),
        "threads": _thread_stacks(),
    }
    # a live scrape plane (obs/live.py) outlives the hang that dumped
    # this record — point the operator reading the dump at it
    live = getattr(obs, "live_url", "")
    if live:
        record["live_url"] = live
    if extra:
        record["extra"] = dict(extra)
    # live-context providers (serve/scheduler.py: queue depth, queued
    # rows, pending route kinds) — what the subsystem was holding when
    # the run wedged, which the event ring alone cannot show
    try:
        ctx = obs.flight_context()
    except AttributeError:
        ctx = {}
    except Exception as e:
        ctx = {"error": repr(e)}
    if ctx:
        record["context"] = ctx
    try:
        from .memory import device_memory_stats
        record["devices"] = device_memory_stats()
    except Exception as e:
        record["devices"] = [{"error": repr(e)}]
    try:
        from .metrics import REGISTRY
        record["metrics"] = REGISTRY.snapshot()
    except Exception as e:
        record["metrics"] = {"error": repr(e)}
    if not path:
        return None
    try:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = "%s.tmp.%d" % (path, os.getpid())
        with open(tmp, "w") as f:
            json.dump(record, f, default=str)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except OSError as e:
        Log.warning("obs: flight record %s failed: %s", path, e)
        return None
    obs._flight_dumped = True
    Log.warning("obs: flight record (%s) -> %s", reason, path)
    return path


class Watchdog:
    """Per-observer hang detector.

    ``arm(label)`` starts (or restarts) the countdown with a new label;
    ``pet(label)`` is the progress heartbeat that restarts it.  The
    daemon thread fires at most once per armed window: it dumps the
    flight record and emits a ``health`` event with
    ``check="watchdog"``, then waits for fresh progress before it can
    fire again — a genuinely hung rank dumps exactly one record.
    """

    def __init__(self, obs, timeout_s):
        self._obs = obs
        self.timeout_s = float(timeout_s)
        self.label = None
        self.fired = 0
        self._deadline = None          # None = disarmed
        self._fired_this_window = False
        self._near_signaled = False    # one near-expiry per armed window
        self._wake = threading.Event()
        self._stop = False
        self._lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="lgbm-obs-watchdog", daemon=True)
        _install_sigterm_hook()

    def start(self):
        self._thread.start()

    # ------------------------------------------------------------ arming
    def arm(self, label):
        with self._lock:
            self.label = str(label)
            self._deadline = time.monotonic() + self.timeout_s
            self._fired_this_window = False
            self._near_signaled = False
        self._wake.set()

    def pet(self, label=None):
        with self._lock:
            if label is not None:
                self.label = str(label)
            self._deadline = time.monotonic() + self.timeout_s
            self._fired_this_window = False
            self._near_signaled = False
        self._wake.set()

    def stop(self):
        with self._lock:
            self._stop = True
            self._deadline = None
        self._wake.set()

    # ------------------------------------------------------------- loop
    def _loop(self):
        poll = max(0.02, min(0.25, self.timeout_s / 4.0))
        while True:
            self._wake.wait(timeout=poll)
            self._wake.clear()
            with self._lock:
                if self._stop:
                    return
                now = time.monotonic()
                expired = (self._deadline is not None
                           and not self._fired_this_window
                           and now >= self._deadline)
                # near-expiry at 75% of the window: an incident-engine
                # early warning — evidence captured while the rank is
                # merely SLOW still shows what it was stuck on when it
                # finally hangs
                near = (not expired and self._deadline is not None
                        and not self._fired_this_window
                        and not self._near_signaled
                        and now >= self._deadline - 0.25 * self.timeout_s)
                label = self.label
                remaining = (self._deadline - now
                             if self._deadline is not None else 0.0)
                if expired:
                    self._fired_this_window = True
                    self.fired += 1
                if near:
                    self._near_signaled = True
            if near:
                try:
                    self._obs.incident_signal(
                        "watchdog_near_expiry",
                        {"timeout_s": self.timeout_s, "label": label,
                         "remaining_s": round(max(0.0, remaining), 3)})
                except Exception:
                    pass
            if expired:
                self._fire(label)

    def _fire(self, label):
        obs = self._obs
        Log.warning("obs: watchdog expired after %.1fs without progress "
                    "(rank %d, last armed: %s)", self.timeout_s,
                    getattr(obs, "rank", 0), label)
        path = dump_flight_record(obs, "watchdog timeout", label=label)
        try:
            obs.event("health", check="watchdog", status="warn",
                      it=getattr(obs, "_iters", -1),
                      detail={"timeout_s": self.timeout_s,
                              "label": label,
                              "flight_record": path or ""})
            obs.flush()
        except Exception:
            pass


# -- SIGTERM hook ---------------------------------------------------------
# one per process, installed lazily by the first watchdog-enabled
# observer; dumps a flight record for EVERY live observer, then defers
# to the previous handler so the process still dies as asked
_SIGTERM_INSTALLED = False


def _install_sigterm_hook():
    global _SIGTERM_INSTALLED
    if _SIGTERM_INSTALLED:
        return
    if threading.current_thread() is not threading.main_thread():
        return                  # signal.signal only works there
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _on_term(signum, frame):
            from .events import live_observers
            for obs in live_observers():
                if getattr(obs, "_watchdog", None) is not None:
                    try:
                        dump_flight_record(obs, "SIGTERM")
                    except Exception:
                        pass
            if callable(prev):
                prev(signum, frame)
            else:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                os.kill(os.getpid(), signal.SIGTERM)

        signal.signal(signal.SIGTERM, _on_term)
        _SIGTERM_INSTALLED = True
    except (ValueError, OSError):
        pass
