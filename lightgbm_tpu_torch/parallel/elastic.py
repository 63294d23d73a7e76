"""Elastic shrink-and-resume: survive a lost rank, finish the run.

Ported from the JAX package's ``parallel/elastic.py``.  It does not
re-admit a dead rank into a live world (``torch.distributed`` has no
such surgery either): a failed attempt tears the whole world down, its
evidence is kept (each failed rank's exit code and output tail, or the
thread rank's error), and a fresh, smaller world starts -- new
processes, a new rendezvous, the binned rows re-split by the new world
size (``Dataset.from_binned(comm=)`` in parallel/worker.py), resuming
from the last checkpoint (models/checkpoint.py; engine.train emits
``mesh_shrink`` when the resumed world differs from the checkpoint's).

Two modes share the loop:

* ``run_elastic`` -- subprocess ranks over ``run_ranks_subprocess``
  (launch.py): real processes and ``torch.distributed`` worlds (NCCL
  where every rank has a card of its own, gloo where ranks share one);
* ``run_elastic_threads`` -- thread ranks over ``run_ranks`` (comm.py):
  one process, the rank's death a raised exception that strands the
  others at their next collective (``BarrierTimeoutError``).

A resumed attempt never re-injects the kill that ended the last one.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

from ..utils.log import Log
from .comm import BarrierTimeoutError, run_ranks
from .launch import (DEFAULT_WORKER_TIMEOUT, RankFailure,
                     run_ranks_subprocess)


class ElasticExhausted(RuntimeError):
    """Every allowed world size failed; carries the flight records."""

    def __init__(self, flight_records):
        self.flight_records = list(flight_records)
        super().__init__("elastic run failed at every world size tried: "
                         + ", ".join(str(r["world_size"])
                                     for r in flight_records))


def _strip_kill(payload: Optional[dict], extra_env: Optional[dict]):
    """Resumed attempts must not re-inject the rank kill."""
    p = dict(payload or {})
    p["kill_rank"] = -1
    env = dict(extra_env or {})
    env["LGBM_MP_KILL_RANK"] = "-1"
    return p, env


def run_elastic(size: int, spec: str, payload: Optional[dict] = None, *,
                min_size: int = 1, device: str = "cuda",
                timeout: float = DEFAULT_WORKER_TIMEOUT,
                extra_env: Optional[dict] = None) -> Dict[str, Any]:
    """Run ``spec`` ("package.module:function", called as ``fn(comm,
    payload)``) in ``size`` rank processes; on a rank death, shrink to
    the survivors (never below ``min_size``) and start again, resuming
    from the checkpoint the payload's ranks write.  Returns {"results",
    "world_size", "attempts", "flight_records"}; raises ElasticExhausted
    when a world of ``min_size`` fails too.  ``timeout`` bounds each
    attempt; ``device`` goes to the launcher."""
    world = int(size)
    attempts = 0
    flight_records: List[dict] = []
    while True:
        attempts += 1
        try:
            results = run_ranks_subprocess(
                world, spec, payload, timeout=timeout, device=device,
                extra_env=extra_env)
            return {"results": results, "world_size": world,
                    "attempts": attempts,
                    "flight_records": flight_records}
        except RankFailure as rf:
            flight_records.append({
                "t": time.time(), "world_size": world,
                "failed_ranks": rf.failed, "returncodes": rf.returncodes,
                "tails": rf.tails,
            })
            survivors = world - len(rf.failed)
            new_world = max(int(min_size), survivors)
            if new_world >= world:       # nothing actually died, or
                new_world = world - 1    # only results went missing
            if new_world < int(min_size) or new_world < 1:
                raise ElasticExhausted(flight_records) from rf
            Log.warning("elastic: rank(s) %s died at world %d; "
                        "resuming at world %d from checkpoint",
                        rf.failed, world, new_world)
            payload, extra_env = _strip_kill(payload, extra_env)
            world = new_world


def run_elastic_threads(size: int, fn: Callable, *, min_size: int = 1,
                        fault=None,
                        barrier_timeout: Optional[float] = None
                        ) -> Dict[str, Any]:
    """The thread-rank drill: ``fn(comm)`` on each simulated rank through
    ``run_ranks``.  A rank that raises (an injected kill) strands the
    others at their next collective; the world then runs again at one
    rank fewer, without ``fault``.  Checkpoint resume works as in
    subprocess mode: it is the engine's, not the comm's."""
    world = int(size)
    attempts = 0
    flight_records: List[dict] = []
    use_fault = fault
    while True:
        attempts += 1
        try:
            results = run_ranks(world, fn, fault=use_fault,
                                barrier_timeout=barrier_timeout)
            return {"results": results, "world_size": world,
                    "attempts": attempts,
                    "flight_records": flight_records}
        except (BarrierTimeoutError, RuntimeError) as e:
            flight_records.append({
                "t": time.time(), "world_size": world,
                "error": "%s: %s" % (type(e).__name__, e),
            })
            if world - 1 < int(min_size):
                raise ElasticExhausted(flight_records) from e
            Log.warning("elastic(threads): world %d failed (%s); "
                        "resuming at world %d", world, type(e).__name__,
                        world - 1)
            world -= 1
            use_fault = None             # never re-inject on resume
