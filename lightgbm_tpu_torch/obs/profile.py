"""``torch.profiler`` trace windows over configured iterations.

The port's copy of the JAX package's ``obs/profile.py``:
``obs_trace_iters=a:b`` (Python range semantics: start at iteration
``a``, stop after iteration ``b-1``) with ``obs_trace_dir`` records the
CPU and CUDA activity of exactly those iterations into a Chrome trace
(``trace.<pid>.<n>.json`` in ``obs_trace_dir``; load it in
ui.perfetto.dev or chrome://tracing).  The CLI's ``tpu_profile_dir``
traces a whole run through the same ``start_trace``/``stop_trace``.
torch.profiler allows one profiler at a time in a process, so a second
window started while one runs fails (and warns) instead of nesting.
"""
from __future__ import annotations

import os

import torch

from ..utils.log import Log

_ACTIVE = []                 # [(profiler, out_dir)] of the open trace
_WRITTEN = [0]               # traces written by this process


def parse_trace_iters(spec):
    """'a:b' -> (a, b) with 0 <= a < b; '' -> None.  Fatal on malformed
    input: a silently dropped trace window wastes a run on the card."""
    spec = str(spec or "").strip()
    if not spec:
        return None
    parts = spec.split(":")
    if len(parts) == 2:
        try:
            start, stop = int(parts[0]), int(parts[1])
        except ValueError:
            start = stop = -1
        if 0 <= start < stop:
            return (start, stop)
    Log.fatal("Bad obs_trace_iters %r (expected 'a:b' with 0 <= a < b, "
              "e.g. '10:13')", spec)


def start_trace(trace_dir) -> None:
    """Open a torch.profiler window over the CPU and, where there is a
    card, CUDA; raises when one is already open."""
    if _ACTIVE:
        raise RuntimeError("a torch.profiler trace is already running "
                           "(to %s)" % _ACTIVE[0][1])
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    _ACTIVE.append((prof, str(trace_dir)))


def stop_trace() -> str:
    """Close the open window and write its Chrome trace; the path."""
    prof, out_dir = _ACTIVE.pop()
    prof.stop()
    os.makedirs(out_dir or ".", exist_ok=True)
    _WRITTEN[0] += 1
    path = os.path.join(out_dir, "trace.%d.%d.json" % (os.getpid(),
                                                       _WRITTEN[0]))
    prof.export_chrome_trace(path)
    return path


class TraceWindow:
    """Opens the profiler at iteration ``start`` and closes it after
    iteration ``stop - 1``; one window a run."""

    def __init__(self, iters_spec, trace_dir):
        self.window = parse_trace_iters(iters_spec)
        self.trace_dir = str(trace_dir or "")
        self.active = False
        self.done = False

    def maybe_start(self, it, obs):
        if (self.window is None or self.active or self.done
                or it < self.window[0]):
            return
        try:
            start_trace(self.trace_dir)
        except Exception as exc:        # profiler busy / unsupported
            Log.warning("obs: could not start profiler trace: %s", exc)
            self.done = True
            return
        self.active = True
        obs.event("trace_window", action="start", dir=self.trace_dir, it=it)

    def maybe_stop(self, it, obs):
        if not self.active or it + 1 < self.window[1]:
            return
        self._stop(obs, it)

    def force_stop(self, obs):
        """Close a window left open at run end (early stop inside it)."""
        if self.active:
            self._stop(obs, -1)

    def _stop(self, obs, it):
        try:
            stop_trace()
        except Exception as exc:
            Log.warning("obs: could not stop profiler trace: %s", exc)
        self.active = False
        self.done = True
        obs.event("trace_window", action="stop", dir=self.trace_dir, it=it)
