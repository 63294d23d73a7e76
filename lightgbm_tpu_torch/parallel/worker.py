"""The training worker of a rank (parallel/launch.py's spec target).

Ported from the JAX package's ``parallel/worker.py``.  One function,
``train_worker(comm, payload)``, drives the whole product path on one
rank: a rank-sharded dataset (``Dataset.from_binned(comm=)``, or rows of
a deterministic synthetic matrix binned through ``from_matrix(comm=)``),
``engine.train`` with its checkpoint wiring, and the booster's comm
integration (histogram all-reduces, reduced metrics, stop votes).
Subprocess mode runs it under ``run_ranks_subprocess`` (spec
``lightgbm_tpu_torch.parallel.worker:train_worker``); thread mode calls
it from ``run_ranks`` ranks: the same function.

Payload keys: rows, cols, seed, num_rounds, params, binned_dir,
obs_path, checkpoint_dir / checkpoint_every, valid_rows (a validation
block split across the ranks like the training rows), device ("cuda"
by default: ``cuda:(LOCAL_RANK % device_count)``; "cpu" when asked) and
return_model.

Fault hooks (environment first, payload keys when unset):

* ``LGBM_MP_SLOW_RANK`` / ``LGBM_MP_SLOW_SECS`` -- that rank sleeps
  before every round (skew injection for the merged-timeline tests);
* ``LGBM_MP_KILL_RANK`` / ``LGBM_MP_KILL_ITER`` -- that rank dies after
  completing ITER rounds: ``os._exit(1)`` in subprocess mode (payload
  ``kill_hard``, the default), a raised RuntimeError in thread mode.

Returns a JSON-able summary: the model digest and tree count for
bit-identity asserts, rows, timing and (return_model) the model text.
"""
from __future__ import annotations

import hashlib
import os
import time
from typing import Any, Dict


def make_data(rows: int, cols: int, seed: int):
    """Deterministic synthetic binary-classification data.  Every rank
    makes the FULL matrix from the seed and takes its block -- the cheap
    stand-in for a shared filesystem."""
    import numpy as np
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, cols))
    y = (X[:, 0] + np.sin(X[:, 1] * 2.0)
         + 0.4 * rng.normal(size=rows) > 0).astype(np.float32)
    return X, y


def default_params() -> Dict[str, Any]:
    return {"objective": "binary", "num_leaves": 15, "max_bin": 63,
            "min_data_in_leaf": 5, "verbose": -1, "learning_rate": 0.2,
            "tree_learner": "data", "enable_bundle": False,
            "bagging_seed": 3, "data_random_seed": 1,
            "feature_fraction_seed": 2}


def _env_or_payload_int(env_key: str, payload, key: str, default: int):
    v = os.environ.get(env_key, "")
    if v != "":
        return int(v)
    return int(payload.get(key, default))


def rank_rows(n: int, size: int, rank: int):
    """(lo, hi): rank's contiguous block of n rows (rank * n // size)."""
    return rank * n // size, (rank + 1) * n // size


def train_worker(comm, payload):
    from .. import engine as engine_mod
    from ..basic import Dataset
    from ..io.dataset import TrainingData
    from ..utils.config import Config
    from .comm import rank_device

    p = dict(payload or {})
    rows = int(p.get("rows", 2048))
    cols = int(p.get("cols", 8))
    rounds = int(p.get("num_rounds", 5))
    seed = int(p.get("seed", 0))
    size = max(int(getattr(comm, "size", 1) or 1), 1)
    rank = int(getattr(comm, "rank", 0) or 0)
    device = rank_device(str(p.get("device", "cuda")))

    params = default_params()
    params.update(p.get("params") or {})
    if p.get("obs_path"):
        # multi-rank observers shard to <path>.r<rank>
        params["obs_events_path"] = str(p["obs_path"])
    if p.get("checkpoint_dir"):
        params["checkpoint_dir"] = str(p["checkpoint_dir"])
        params["checkpoint_every"] = int(p.get("checkpoint_every", 1))

    mcomm = comm if size > 1 else None
    feature = str(params.get("tree_learner", "")) in ("feature",
                                                      "feature_parallel")
    binned_dir = str(p.get("binned_dir") or "")
    valid = []
    if binned_dir:
        ds = Dataset.from_binned(binned_dir, params=dict(params),
                                 comm=mcomm)
    else:
        n_valid = int(p.get("valid_rows", 0))
        X, y = make_data(rows + n_valid, cols, seed)
        lo, hi = (0, rows) if feature else rank_rows(rows, size, rank)
        ds = Dataset(X[lo:hi], label=y[lo:hi], params=dict(params))
        # the rows kept: a resumed run scores its checkpoint's trees on
        # them
        ds._handle = TrainingData.from_matrix(
            X[lo:hi], label=y[lo:hi], config=Config(dict(params)),
            comm=mcomm, keep_raw=True)
        if n_valid:
            vlo, vhi = ((0, n_valid) if feature
                        else rank_rows(n_valid, size, rank))
            valid = [Dataset(X[rows + vlo:rows + vhi],
                             label=y[rows + vlo:rows + vhi],
                             reference=ds)]

    slow_rank = _env_or_payload_int("LGBM_MP_SLOW_RANK", p,
                                    "slow_rank", -1)
    slow_secs = float(os.environ.get("LGBM_MP_SLOW_SECS",
                                     p.get("slow_secs", 0.2)))
    kill_rank = _env_or_payload_int("LGBM_MP_KILL_RANK", p,
                                    "kill_rank", -1)
    kill_iter = _env_or_payload_int("LGBM_MP_KILL_ITER", p,
                                    "kill_iter", -1)
    kill_hard = bool(p.get("kill_hard", True))

    cbs = []
    if rank == slow_rank and slow_secs > 0:
        def _slow(env):
            time.sleep(slow_secs)
        _slow.before_iteration = True
        cbs.append(_slow)
    if rank == kill_rank and kill_iter >= 0:
        state = {"n": 0}

        def _kill(env):
            # after the iteration: its checkpoint (on the cadence) is
            # written
            state["n"] += 1
            if state["n"] >= kill_iter:
                if kill_hard:
                    os._exit(1)
                raise RuntimeError(
                    "injected rank kill (LGBM_MP_KILL_RANK=%d after %d "
                    "round(s))" % (kill_rank, kill_iter))
        cbs.append(_kill)

    evals = {}
    t0 = time.perf_counter()
    booster = engine_mod.train(
        params, ds, num_boost_round=rounds, valid_sets=valid or None,
        verbose_eval=False, callbacks=cbs, device=device,
        evals_result=evals,
        early_stopping_rounds=p.get("early_stopping_rounds"))
    train_s = time.perf_counter() - t0

    gbdt = booster._gbdt
    model_str = booster.model_to_string()
    td = gbdt.train_data
    out = {"rank": rank, "size": size,
           "digest": hashlib.sha256(model_str.encode()).hexdigest()[:16],
           "num_trees": len(gbdt.models), "iter": int(gbdt.iter),
           "num_data": int(td.num_data), "train_s": train_s,
           "best_iteration": int(booster.best_iteration),
           "evals": evals}
    reader = getattr(td, "_binned_reader", None)
    if reader is not None:
        out["row_range"] = [int(reader.row_range[0]),
                            int(reader.row_range[1])]
    if p.get("return_model"):
        out["model"] = model_str
    return out
