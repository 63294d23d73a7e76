"""End-to-end distributed training in the port, and the rank observers.

``lgb.train`` over two real gloo processes (parallel/launch.py, a short
timeout) trains the same model text on both ranks, and the text of the
same run on two thread ranks; the early stop is voted, the metrics are
the ranks' row-weighted means; ``obs merge`` and the straggler profiler
name a slowed rank.  The JAX package's tests/test_obs_dist.py cases are
ported on the port's observer.
"""
import io
import math
import time

import numpy as np
import pytest

import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.obs import RunObserver
from lightgbm_tpu_torch.obs.merge import (discover_shards, load_shards,
                                          merge_shards, render_report)
from lightgbm_tpu_torch.obs.query import load_timeline, main as obs_main
from lightgbm_tpu_torch.parallel import comm as pcomm
from lightgbm_tpu_torch.parallel.launch import (RankFailure,
                                                run_ranks_subprocess)
from lightgbm_tpu_torch.parallel.worker import train_worker
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 60.0
SPEC = "lightgbm_tpu_torch.parallel.worker:train_worker"


# the rank processes run torch on one thread, as this process does
ONE_THREAD = {"OMP_NUM_THREADS": "1"}
PAYLOAD = {"rows": 600, "cols": 6, "num_rounds": 4, "valid_rows": 200,
           "return_model": True, "device": "cpu",
           "params": {"metric": "binary_logloss,auc", "num_leaves": 7}}


def test_two_gloo_processes_train_one_text():
    """Two real processes over gloo: byte-equal texts on both ranks, equal
    to the two-thread-rank run's (each rank bins its block of features
    from its own rows, so the text is the distributed run's, not the
    serial one's)."""
    procs = run_ranks_subprocess(2, SPEC, PAYLOAD, timeout=120,
                                 device="cpu", extra_env=ONE_THREAD)
    threads = pcomm.run_ranks(2, lambda c: train_worker(c, PAYLOAD),
                              barrier_timeout=TIMEOUT)
    assert procs[0]["model"] == procs[1]["model"] == threads[0]["model"]
    assert procs[0]["num_trees"] == 4 and procs[0]["num_data"] == 300
    assert procs[0]["evals"] == threads[1]["evals"]


def test_a_dead_rank_is_named():
    with pytest.raises(RankFailure) as e:
        run_ranks_subprocess(2, SPEC, dict(PAYLOAD, kill_rank=1,
                                           kill_iter=1),
                             timeout=60, fail_grace=2.0, device="cpu",
                             extra_env=ONE_THREAD)
    assert 1 in e.value.failed


def _split(X, y, comm, n=None):
    n = len(y) if n is None else n
    lo, hi = comm.rank * n // comm.size, (comm.rank + 1) * n // comm.size
    return lo, hi


def test_metrics_are_the_ranks_row_weighted_means():
    """binary_logloss decomposes: the ranks' row-weighted mean of their
    local values is the logloss of all rows' scores; every rank reports
    that value."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(900, 5))
    y = (X[:, 0] + 0.3 * rng.normal(size=900) > 0).astype(float)
    Xv, yv = X[:301], y[:301]

    def rank(comm):
        p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
             "tree_learner": "data", "metric": "binary_logloss"}
        lo, hi = _split(X, y, comm)
        vlo, vhi = _split(Xv, yv, comm)
        ds = lgbt.Dataset(X[lo:hi], label=y[lo:hi])
        ds._handle = TrainingData.from_matrix(
            X[lo:hi], label=y[lo:hi], config=Config(dict(p)), comm=comm)
        vd = lgbt.Dataset(Xv[vlo:vhi], label=yv[vlo:vhi], reference=ds)
        ev = {}
        b = lgbt.train(p, ds, 3, valid_sets=[vd], evals_result=ev,
                       device="cpu")
        return ev["valid_0"]["binary_logloss"][-1], b.model_to_string()
    out = pcomm.run_ranks(3, rank, barrier_timeout=TIMEOUT)
    assert out[0] == out[1] == out[2]
    b = lgbt.Booster(model_str=out[0][1], device="cpu")
    p = np.clip(b.predict(Xv), 1e-15, 1 - 1e-15)
    want = -np.mean(yv * np.log(p) + (1 - yv) * np.log(1 - p))
    assert math.isclose(out[0][0], want, rel_tol=1e-5)
    assert pcomm.reduce_metrics(None, {"a": 1.0}) == {"a": 1.0}


def test_the_early_stop_is_voted():
    """Every rank stops at the same round with the same best iteration
    (the metrics are reduced, so the votes agree); a vote needs every
    rank."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(800, 4))
    y = (X[:, 0] + 1.5 * rng.normal(size=800) > 0).astype(float)

    def rank(comm):
        p = {"objective": "binary", "num_leaves": 15, "verbose": -1,
             "tree_learner": "data", "metric": "binary_logloss",
             "learning_rate": 0.5, "min_data_in_leaf": 2}
        lo, hi = _split(X, y, comm)
        ds = lgbt.Dataset(X[lo:hi], label=y[lo:hi])
        ds._handle = TrainingData.from_matrix(
            X[lo:hi], label=y[lo:hi], config=Config(dict(p)), comm=comm)
        vlo, vhi = lo // 2, hi // 2
        vd = lgbt.Dataset(X[vlo:vhi] + 0.5, label=y[vlo:vhi], reference=ds)
        b = lgbt.train(p, ds, 60, valid_sets=[vd], device="cpu",
                       early_stopping_rounds=3)
        return b.best_iteration, b._gbdt.iter, b.model_to_string()
    out = pcomm.run_ranks(2, rank, barrier_timeout=TIMEOUT)
    assert out[0] == out[1]
    assert 0 < out[0][0] < 60 and out[0][1] < 60

    def vote(comm):
        return pcomm.vote_stop(comm, comm.rank == 0), \
            pcomm.vote_stop(comm, True)
    assert pcomm.run_ranks(3, vote, barrier_timeout=TIMEOUT) == \
        [(False, True)] * 3


# ------------------------------------------------------------ observers
def _train_ranks(base, size, iters=3, slow_rank=None, slow_secs=0.05,
                 **obs_kw):
    """The JAX package's simulated distributed run: each rank's observer
    shards ``base``, every iteration gathers once (a host collective with
    a seq)."""

    def work(comm):
        obs = RunObserver(events_path=base, prof_hz=0, **obs_kw)
        obs.run_header(backend="cpu", devices=[], params={}, context={})
        for it in range(iters):
            obs.iter_begin(it)
            if comm.rank == slow_rank:
                time.sleep(slow_secs)
            comm.allgather_obj(it)
            obs.iter_end(it)
        obs.close()
        return obs.events_path

    return pcomm.run_ranks(size, work, barrier_timeout=TIMEOUT)


def test_merge_attributes_slow_rank(tmp_path):
    base = str(tmp_path / "skew.jsonl")
    paths = _train_ranks(base, 4, slow_rank=2, slow_secs=0.06)
    assert paths == [base + ".r%d" % r for r in range(4)]
    shards = discover_shards(base + ".r0")
    assert len(shards) == 4
    merged, report = merge_shards(load_shards(shards))
    assert report["world_size"] == 4 and report["ranks"] == [0, 1, 2, 3]
    assert report["collective_skew_max_s"] > 0.03
    worst = max(report["collectives"], key=lambda r: r["skew_s"])
    assert worst["last_rank"] == 2
    slowest = report["slowest_rank_collectives"]
    assert max(slowest, key=lambda k: slowest[k]) == "2"
    iters = [e for e in merged if e["ev"] == "iter"]
    assert len(iters) == 3
    assert all(set(e["rank_times"]) == {"0", "1", "2", "3"} for e in iters)
    buf = io.StringIO()
    render_report(report, buf)
    assert "rank 2" in buf.getvalue()
    out = str(tmp_path / "merged.jsonl")
    assert obs_main(["merge", base + ".r0", "-o", out]) == 0
    head = load_timeline(out)[0]
    assert head["ev"] == "run_header" and head["world_size"] == 4


def test_straggler_profiler_names_the_slow_rank(tmp_path):
    """A data-parallel run with rank 1 sleeping before every round: the
    other ranks wait for it inside the collectives, so its busy time
    stands out; the straggler events, the run_end summary and the merged
    timeline name it."""
    base = str(tmp_path / "dp.jsonl")
    payload = dict(PAYLOAD, obs_path=base, slow_rank=1, slow_secs=0.25,
                   num_rounds=3, params=dict(
                       PAYLOAD["params"], obs_straggler_every=1,
                       obs_straggler_warn_skew=0.3, obs_prof_hz=0))
    pcomm.run_ranks(3, lambda c: train_worker(c, payload),
                    barrier_timeout=TIMEOUT)
    shards = load_shards(discover_shards(base))
    for events in shards.values():
        samples = [e for e in events if e["ev"] == "straggler"]
        assert len(samples) == 3
        assert all(e["slowest"] == 1 and e["axis"] == "ranks"
                   for e in samples[1:])
        end = next(e for e in events if e["ev"] == "run_end")
        assert end["stragglers"]["slowest_counts"].get("1", 0) >= 2
        assert any(e["ev"] == "health"
                   and e.get("check") == "straggler_skew" for e in events)
    assert obs_main(["stragglers", base + ".r0"]) == 0
    _, report = merge_shards(shards)
    assert report["world_size"] == 3


def test_observer_shards_by_the_comm(tmp_path):
    base = str(tmp_path / "c.jsonl")
    from lightgbm_tpu_torch.obs import observer_from_config

    def rank(comm):
        obs = observer_from_config(Config({"obs_events_path": base,
                                           "obs_prof_hz": 0}), comm=comm)
        obs.run_header(backend="cpu", devices=[], params={}, context={})
        obs.close()
        return obs.events_path, obs.rank, obs.world_size
    out = pcomm.run_ranks(2, rank, barrier_timeout=TIMEOUT)
    assert out == [(base + ".r0", 0, 2), (base + ".r1", 1, 2)]
    assert pcomm.rank_context() is None
