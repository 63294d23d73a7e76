"""Device policy of the port's entry points.

Training runs on the GPU unless the caller asks for the CPU.  A request
for CUDA on a machine without it is an error, never a silent fall back:
on the CPU the kernels' plain torch versions run instead, which is what
the tests want and what a user asking for the GPU does not.
"""
from __future__ import annotations

import contextlib
import gc
import threading

import torch

from .utils.log import LightGBMError

# One CUDA graph capture at a time in the process.  A capture fails
# when any thread synchronizes the whole device while it runs (CUDA's
# rule), and torch.cuda.graph synchronizes the device before it
# captures, so the port's captures (ops/fused_iter.py, serve/executable.py)
# take this lock; between captures each thread synchronizes only its own
# streams and events.
CAPTURE_LOCK = threading.Lock()


@contextlib.contextmanager
def capture_guard():
    """CAPTURE_LOCK held and Python's cyclic garbage collector paused for
    the length of a capture.  A collection runs on whichever thread
    happens to allocate (the run observer's sampling profiler, a serving
    thread, the capturing thread itself) and may free an earlier booster's
    graphs, whose teardown is a CUDA call that invalidates a capture in
    progress; with the collector paused, such objects wait for the next
    collection after the capture."""
    with CAPTURE_LOCK:
        enabled = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if enabled:
                gc.enable()


def resolve_device(device="cuda") -> torch.device:
    """torch.device for ``device`` ("cuda", "cuda:N" or "cpu"); raises
    when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "device=%r needs CUDA, but torch.cuda.is_available() is "
                "false; pass device='cpu' to run on the CPU" % str(device))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise LightGBMError("unsupported device %r (expected cuda or cpu)"
                            % str(device))
    return dev
