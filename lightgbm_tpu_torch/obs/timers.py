"""Phase clocks and per-entry-point timers for the training loop.

The port's copy of the JAX package's ``obs/timers.py``.  CUDA launches
are asynchronous: a host ``time.perf_counter()`` around a kernel launch
measures the launch, not the device's work.  A device-accurate time
waits for the card first (``torch.cuda.synchronize``), which also
drains the launch queue, so every timer here takes the wait as a
parameter and the caller (RunObserver) decides by ``obs_timing``.  The
timers are plain Python; none is on the disabled path (NULL_OBSERVER
never builds one).
"""
from __future__ import annotations

import dataclasses
import time

import torch

# process-wide count of host waits for the device issued through fence()
# and fenced_get().  Every deliberate wait of the training stack and the
# autotuner's probes goes through them, so the count is an audit: a run
# with the NULL observer and no probe leaves it unchanged (the tree's
# own host reads of its status are reads, not fences).
_FENCE_COUNT = 0


def fence_count() -> int:
    """Total fence()/fenced_get() waits issued (the sync audit)."""
    return _FENCE_COUNT


def _cuda_device(value):
    """The device of the first CUDA tensor in value (a tensor, a
    list/tuple/dict of them or a dataclass of tensors), else None."""
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                return v.device
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
        elif dataclasses.is_dataclass(v) and not isinstance(v, type):
            stack.extend(getattr(v, f.name) for f in dataclasses.fields(v))
    return None


def fence(value) -> None:
    """Wait until the device work behind value is done: one counted
    ``torch.cuda.synchronize`` of the device of value's first CUDA
    tensor.  None passes untouched; CPU tensors and host values are
    counted and need no wait (the CPU ran them already)."""
    global _FENCE_COUNT
    if value is None:
        return
    _FENCE_COUNT += 1
    dev = _cuda_device(value)
    if dev is not None:
        torch.cuda.synchronize(dev)


def _to_host(value):
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    return value


def fenced_get(value):
    """value with every tensor copied to a host numpy array, counted in
    the sync audit: the counted twin of fence() for reads that need the
    host value, not only completion."""
    global _FENCE_COUNT
    _FENCE_COUNT += 1
    return _to_host(value)


class PhaseClock:
    """Splits one iteration into named laps (boost / grow / partition /
    update / eval) and accumulates per-phase totals across iterations.

    ``begin()`` starts the iteration, ``lap(name, value)`` closes the
    current phase (fencing ``value`` first when ``fence_laps``),
    ``end(value)`` closes the iteration and returns ``(total_s, {phase:
    s})``.  Repeated laps with the same name within one iteration add up
    (the tree loop laps "grow" once a tree).  ``current`` is the name of
    the lap last crossed in the iteration in flight (None between
    iterations)."""

    def __init__(self, fence_laps=True):
        self.fence_laps = bool(fence_laps)
        self.current = None
        self._totals = {}
        self._phases = {}
        self._t_begin = 0.0
        self._t_last = 0.0

    def begin(self):
        self._phases = {}
        self.current = None
        self._t_begin = self._t_last = time.perf_counter()

    def lap(self, name, value=None):
        if self.fence_laps:
            fence(value)
        now = time.perf_counter()
        self._phases[name] = self._phases.get(name, 0.0) + (now - self._t_last)
        self._t_last = now
        self.current = name

    def end(self, value=None):
        fence(value)
        self.current = None
        now = time.perf_counter()
        total = now - self._t_begin
        # time since the last lap (or begin) that no lap() claimed
        tail = now - self._t_last
        if tail > 0.0 and self._phases:
            self._phases["other"] = self._phases.get("other", 0.0) + tail
        phases = self._phases
        self._phases = {}
        for k, v in phases.items():
            self._totals[k] = self._totals.get(k, 0.0) + v
        return total, phases

    def totals(self):
        return dict(self._totals)


class EntryTimers:
    """First-call-vs-steady split per entry point (tree_grow,
    fused_iter).  The first call of an entry pays its set-up (the fused
    iteration's warm-up and graph captures, the kernels' first launch
    plans); later calls pay their work only.  ``record`` returns True
    exactly once per entry name, where the caller emits a ``compile``
    event, and folds every later call into the execute statistics."""

    def __init__(self):
        self._entries = {}

    def record(self, name, dt):
        st = self._entries.get(name)
        if st is None:
            self._entries[name] = {"first_s": dt, "exec_n": 0,
                                   "exec_total_s": 0.0, "exec_min_s": 0.0,
                                   "exec_max_s": 0.0}
            return True
        st["exec_n"] += 1
        st["exec_total_s"] += dt
        if st["exec_n"] == 1 or dt < st["exec_min_s"]:
            st["exec_min_s"] = dt
        if dt > st["exec_max_s"]:
            st["exec_max_s"] = dt
        return False

    def summary(self):
        out = {}
        for name, st in self._entries.items():
            n = st["exec_n"]
            mean = (st["exec_total_s"] / n) if n else 0.0
            out[name] = {
                "first_s": st["first_s"],
                "exec_n": n,
                "exec_total_s": st["exec_total_s"],
                "exec_mean_s": mean,
                "exec_min_s": st["exec_min_s"],
                "exec_max_s": st["exec_max_s"],
                # set-up estimate: first call minus a steady execute
                "compile_est_s": max(0.0, st["first_s"] - mean),
            }
        return out


class OrchestrationClock:
    """Host time between device submissions within one iteration.

    Construction marks the iteration start; ``enter()``/``exit()``
    bracket each device submission; the remainder is the host's own glue
    of the iteration (the ``host_orchestration_s`` field of the ``iter``
    event, what the fused iteration's graphs exist to shrink).  Never
    fences."""

    __slots__ = ("_t0", "_t_enter", "_inside")

    def __init__(self):
        self._t0 = time.perf_counter()
        self._t_enter = 0.0
        self._inside = 0.0

    def enter(self):
        self._t_enter = time.perf_counter()

    def exit(self):
        self._inside += time.perf_counter() - self._t_enter

    def host_seconds(self) -> float:
        """Elapsed since construction minus time inside submissions."""
        return max(0.0, (time.perf_counter() - self._t0) - self._inside)


class NullOrchestration:
    """No-op stand-in for OrchestrationClock when telemetry is off: the
    disabled hot path builds no obs objects."""

    __slots__ = ()

    def enter(self):
        pass

    def exit(self):
        pass

    def host_seconds(self) -> float:
        return 0.0


NULL_ORCH = NullOrchestration()

