"""Serving tier: bucket programs (one CUDA graph a power-of-two bucket on
the card) and async microbatching.

``Booster.serve()`` is the entry point.

* ``executable.py`` — ``PredictExecutableCache``: a program per
  (batch bucket, raw/converted) over static buffers, captured once as a
  CUDA graph and replayed by every request, so the steady state builds
  nothing (``steady_state_compiles``).
* ``scheduler.py`` — ``MicrobatchScheduler`` / ``ServingPredictor``: an
  async coalescer that batches concurrent requests into padded
  power-of-two buckets under a max-latency deadline, with early-stop and
  ``pred_contrib`` served through the same queue.  Overload protection
  sheds at admission (bounded queue / per-request deadlines) and fails
  shed futures fast with ``ServeOverloadError``; the rolling SLO engine
  and burn-rate alerts live in ``obs/serve.py``.
"""
from .executable import PredictExecutableCache, next_pow2
from .scheduler import (MicrobatchScheduler, ServeOverloadError,
                        ServingPredictor)

__all__ = ["MicrobatchScheduler", "PredictExecutableCache",
           "ServeOverloadError", "ServingPredictor", "next_pow2"]
