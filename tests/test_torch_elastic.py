"""Elastic shrink-and-resume in the port, against the JAX package.

The JAX package's drills (tests/test_multihost.py:186-270) on the port's
``parallel/elastic.py``: thread ranks over ``run_ranks`` and one real
two-process world over gloo on the CPU, each killing rank 1 and
finishing at world 1 from the checkpoint; the checkpoint's world size
and the ``mesh_shrink`` event held to the JAX package's field values.
"""
import json
import os

import numpy as np
import pytest

import lightgbm_tpu as lgbj
from lightgbm_tpu.models import checkpoint as jck
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.models import checkpoint as ck
from lightgbm_tpu_torch.parallel import worker
from lightgbm_tpu_torch.parallel.comm import SingleProcessComm
from lightgbm_tpu_torch.parallel.elastic import (ElasticExhausted,
                                                 run_elastic,
                                                 run_elastic_threads)
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

TIMEOUT = 30.0        # a collective that waits longer fails the rank


def _events(d, prefix):
    out = []
    for name in sorted(os.listdir(d)):
        if name.startswith(prefix):
            with open(os.path.join(d, name)) as f:
                out += [json.loads(line) for line in f if line.strip()]
    return out


def test_elastic_thread_drill_kill_one_rank(tmp_path):
    """Rank 1 dies after round 3; the world shrinks to 1 and resumes from
    the checkpoint to the tree count of an uninterrupted run, with the
    shrink on the resumed timeline (JAX test_multihost.py:186-220)."""
    d = str(tmp_path / "el")
    os.makedirs(d)
    obs = os.path.join(d, "tl.jsonl")
    payload = {"rows": 500, "cols": 5, "num_rounds": 6, "seed": 5,
               "checkpoint_dir": d, "checkpoint_every": 1,
               "kill_rank": 1, "kill_iter": 3, "kill_hard": False,
               "obs_path": obs, "device": "cpu",
               "params": {"tree_learner": "serial"}}
    out = run_elastic_threads(
        2, lambda comm: worker.train_worker(comm, payload),
        barrier_timeout=TIMEOUT)
    assert out["attempts"] == 2 and out["world_size"] == 1
    assert len(out["flight_records"]) == 1
    assert "injected rank kill" in out["flight_records"][0]["error"]
    ref = worker.train_worker(SingleProcessComm(),
                              {"rows": 500, "cols": 5, "num_rounds": 6,
                               "seed": 5, "device": "cpu",
                               "params": {"tree_learner": "serial"}})
    assert [r["num_trees"] for r in out["results"]] == [ref["num_trees"]]
    evs = _events(d, "tl.jsonl")
    shrink = [e for e in evs if e.get("ev") == "mesh_shrink"]
    assert shrink and shrink[0]["world_size_from"] == 2 \
        and shrink[0]["world_size_to"] == 1
    assert any(e.get("ev") == "checkpoint" for e in evs)


def test_elastic_exhausted_carries_flight_records():
    def always_dies(comm):
        raise RuntimeError("rank %d down" % comm.rank)

    with pytest.raises(ElasticExhausted) as ei:
        run_elastic_threads(2, always_dies, min_size=2)
    recs = ei.value.flight_records
    assert len(recs) == 1 and recs[0]["world_size"] == 2
    assert "down" in recs[0]["error"]


def test_elastic_threads_data_parallel_resumes_on_the_rows(tmp_path):
    """The data-parallel learner over a pre-binned directory: world 2
    loses rank 1 after round 2, world 1 re-splits the rows (all of them)
    and resumes; the text is the serial continuation's from the
    checkpoint, and its first 2 trees are an uninterrupted 2-rank
    run's.  The directory, saved from an in-memory Dataset, carries its
    drift fingerprint, so the texts carry a drift_fingerprint= line,
    whose training scores are those of the first text the booster
    wrote: equal too, since the continuation checkpoints as the resumed
    world does."""
    X, y = worker.make_data(600, 5, 4)
    binned = str(tmp_path / "binned")
    params = dict(worker.default_params(), tree_learner="data")
    lgbt.Dataset(X, label=y, params=dict(params)).construct() \
        ._handle.save_binned(binned)
    d = str(tmp_path / "ck")
    os.makedirs(d)
    payload = {"binned_dir": binned, "num_rounds": 4, "device": "cpu",
               "checkpoint_dir": d, "checkpoint_every": 1,
               "kill_rank": 1, "kill_iter": 2, "kill_hard": False,
               "return_model": True, "obs_path": os.path.join(d, "tl"),
               "params": {"tree_learner": "data"}}
    out = run_elastic_threads(
        2, lambda comm: worker.train_worker(comm, payload),
        barrier_timeout=TIMEOUT)
    assert out["attempts"] == 2 and out["world_size"] == 1
    text = out["results"][0]["model"]
    assert out["results"][0]["num_data"] == 600
    whole = run_elastic_threads(
        2, lambda comm: worker.train_worker(comm, dict(
            payload, kill_rank=-1, checkpoint_dir="", obs_path="")),
        barrier_timeout=TIMEOUT)
    assert whole["attempts"] == 1
    two = whole["results"][0]["model"]
    assert two == whole["results"][1]["model"]
    # the round the resume read (2, or 1 where the dead rank's error
    # broke rank 0's last barrier before it wrote round 2's checkpoint)
    done = _resumed_at(d, "tl")
    assert _trees(text)[:done] == _trees(two)[:done]
    assert "\ndrift_fingerprint=" in text
    assert _continuation(binned, params, text, done, 4,
                         str(tmp_path / "cont")) == text


def _trees(text):
    body = text.split("\nTree=")[1:]
    return [t.split("\n\nfeature importances:")[0] for t in body]


def _resumed_at(d, prefix):
    """The round of the checkpoint the resumed world read (its
    mesh_shrink event)."""
    shrink = [e for e in _events(d, prefix)
              if e.get("ev") == "mesh_shrink"]
    assert len(shrink) == 1 and shrink[0]["world_size_to"] == 1
    return shrink[0]["it"]


def _continuation(binned, params, text, done, rounds, ck_dir):
    """The serial init_model continuation from the first ``done`` trees of
    text on the pre-binned rows, writing a checkpoint every round into
    ck_dir as the resumed world does: its model text."""
    params = dict(params, checkpoint_dir=ck_dir, checkpoint_every=1)
    ds = lgbt.Dataset.from_binned(binned, params=dict(params))
    head = lgbt.Booster(model_str=_first_trees(text, done), device="cpu")
    return lgbt.train(params, ds, rounds - done, init_model=head,
                      device="cpu").model_to_string()


def test_subprocess_elastic_drill_resumes(tmp_path):
    """Two rank processes over gloo on the CPU: rank 1 dies (os._exit)
    after round 2, the world-1 relaunch resumes from the checkpoint and
    trains the serial continuation's text."""
    X, y = worker.make_data(512, 5, 4)
    binned = str(tmp_path / "binned")
    params = dict(worker.default_params(), tree_learner="data")
    TrainingData.from_streamed(X, y, Config(dict(params)), out_dir=binned,
                               chunk_rows=128)
    d = str(tmp_path / "ck")
    os.makedirs(d)
    payload = {"binned_dir": binned, "num_rounds": 4, "device": "cpu",
               "checkpoint_dir": d, "checkpoint_every": 1,
               "kill_rank": 1, "kill_iter": 2, "return_model": True,
               "obs_path": os.path.join(d, "tl"),
               "params": {"tree_learner": "data"}}
    out = run_elastic(2, "lightgbm_tpu_torch.parallel.worker:train_worker",
                      payload, device="cpu", timeout=100.0,
                      extra_env={"OMP_NUM_THREADS": "1"})
    assert out["attempts"] == 2 and out["world_size"] == 1
    assert 1 in out["flight_records"][0]["failed_ranks"]
    assert [r["num_trees"] for r in out["results"]] == [4]
    # the world-1 run has written its own checkpoints since the resume
    assert ck.load_checkpoint(d)["world_size"] == 1
    model = out["results"][0]["model"]
    assert _continuation(binned, params, model, _resumed_at(d, "tl"),
                         4, str(tmp_path / "cont")) == model


def _first_trees(text, n):
    """The model text of the first n trees (its header and those)."""
    b = lgbt.Booster(model_str=text, device="cpu")
    return b.model_to_string(num_iteration=n)


def test_checkpoint_world_size_and_mesh_shrink_match_jax(tmp_path):
    """A checkpoint written at world 2 and resumed at world 1: the
    checkpoint's world size and the mesh_shrink event's fields are the
    JAX package's (JAX engine.py:86-99, :149-166)."""
    X, y = worker.make_data(300, 5, 1)
    params = dict(worker.default_params(), tree_learner="serial")
    fields = {}
    for name, pkg, ckm, kw in (
            ("jax", lgbj, jck, {"verbose_eval": False}),
            ("port", lgbt, ck, {"device": "cpu"})):
        d = str(tmp_path / name)
        bst = pkg.train(dict(params), pkg.Dataset(X, label=y), 2, **kw)
        ckm.save_checkpoint(d, bst._gbdt, 2, params, world_size=2)
        assert ckm.load_checkpoint(d)["world_size"] == 2
        obs = os.path.join(d, "tl.jsonl")
        pkg.train(dict(params, checkpoint_dir=d, checkpoint_every=1,
                       obs_events_path=obs), pkg.Dataset(X, label=y), 4,
                  **kw)
        evs = _events(d, "tl.jsonl")
        shrink = [e for e in evs if e.get("ev") == "mesh_shrink"]
        assert len(shrink) == 1
        fields[name] = {k: shrink[0][k] for k in (
            "world_size_from", "world_size_to", "it", "reason")}
        assert shrink[0]["checkpoint"] == ckm.checkpoint_path(d)
        cks = [e for e in evs if e["ev"] == "checkpoint"]
        assert [e["it"] for e in cks] == [3, 4]
        assert {e["world_size"] for e in cks} == {1}
        assert ckm.load_checkpoint(d)["world_size"] == 1
    assert fields["port"] == fields["jax"] == {
        "world_size_from": 2, "world_size_to": 1, "it": 2,
        "reason": "resume"}


def test_only_rank_zero_writes_and_records_its_world(tmp_path):
    """Under the data-parallel learner only rank 0 writes the checkpoint,
    with the world size 2 (JAX engine.py:149-156)."""
    X, y = worker.make_data(400, 5, 2)
    written = []
    orig = ck.save_checkpoint

    def spy(ckdir, gbdt, iteration, params, world_size=1):
        written.append(world_size)
        return orig(ckdir, gbdt, iteration, params, world_size=world_size)

    d = str(tmp_path / "ck")
    payload = {"rows": 400, "cols": 5, "num_rounds": 2, "seed": 2,
               "device": "cpu", "checkpoint_dir": d,
               "checkpoint_every": 1, "params": {"tree_learner": "data"}}
    mp = pytest.MonkeyPatch()
    mp.setattr(ck, "save_checkpoint", spy)
    try:
        run_elastic_threads(
            2, lambda comm: worker.train_worker(comm, payload),
            barrier_timeout=TIMEOUT)
    finally:
        mp.undo()
    assert written == [2, 2]
    saved = ck.load_checkpoint(d)
    assert saved["world_size"] == 2 and saved["iteration"] == 2
    assert np.isfinite(lgbt.Booster(model_str=saved["model"], device="cpu")
                       .predict(X)).all()
