"""Rank-sharded ingest and the drift fingerprint, against the JAX package.

The port's ``from_matrix(comm=)`` bins each rank's block of features from
a sample of that rank's rows and all-gathers the mappers; the JAX
package's ``run_ranks`` run of the same shards must give the same
mappers.  ``from_binned(comm=)`` opens a rank's share of a directory the
JAX package wrote, row for row as the JAX package opens it.  The model
text carries the JAX package's ``drift_fingerprint=`` line where the JAX
package writes it, and a reloaded model serves with drift monitoring.
"""
import json
import os

import numpy as np
import pytest

import jax

import lightgbm_tpu as jlgb
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.parallel.comm import run_ranks as jrun_ranks
from lightgbm_tpu.utils.config import Config as JConfig
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.parallel.comm import run_ranks
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

TIMEOUT = 60.0


def _rows(n, size, rank):
    return rank * n // size, (rank + 1) * n // size


@pytest.mark.parametrize("size,f", [(2, 6), (3, 6), (3, 2)])
def test_distributed_mappers_equal_the_jax_packages(size, f):
    """(3, 2): more ranks than features, so a rank bins none."""
    rng = np.random.default_rng(11)
    n = 900
    X = rng.normal(size=(n, f))
    X[:, 0] = np.round(X[:, 0] * 3)              # few distinct values
    X[rng.random(n) < 0.2, f - 1] = 0.0          # zeros and a categorical
    y = (X[:, 0] > 0).astype(np.float64)
    params = {"max_bin": 31, "min_data_in_leaf": 5, "verbose": -1,
              "bin_construct_sample_cnt": 500, "enable_bundle": False,
              "data_random_seed": 3 + size}
    cats = [f - 1] if f > 2 else []

    def port(comm):
        lo, hi = _rows(n, comm.size, comm.rank)
        cfg = Config(dict(params, data_random_seed=params[
            "data_random_seed"] + comm.rank))
        td = TrainingData.from_matrix(X[lo:hi], label=y[lo:hi], config=cfg,
                                      categorical_feature=cats, comm=comm)
        # the RNG-bearing keys were synced to the ranks' minimum
        assert cfg.data_random_seed == params["data_random_seed"]
        return [m.to_dict() for m in td.bin_mappers], td.used_feature_idx

    def jax_(comm):
        lo, hi = _rows(n, comm.size, comm.rank)
        cfg = JConfig(dict(params, data_random_seed=params[
            "data_random_seed"] + comm.rank))
        td = JTrainingData.from_matrix(X[lo:hi], label=y[lo:hi], config=cfg,
                                       categorical_feature=cats, comm=comm)
        return [m.to_dict() for m in td.bin_mappers], td.used_feature_idx

    ours = run_ranks(size, port, barrier_timeout=TIMEOUT)
    theirs = jrun_ranks(size, jax_, barrier_timeout=TIMEOUT)
    assert all(o == ours[0] for o in ours)
    assert json.dumps(ours[0], sort_keys=True) == \
        json.dumps(theirs[0], sort_keys=True)


def test_rank_sharded_directory_of_the_jax_package(tmp_path):
    rng = np.random.default_rng(5)
    n = 1201
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] > 0).astype(np.float64)
    w = rng.random(n)
    out = str(tmp_path / "jdir")
    jlgb.Dataset(X, label=y, weight=w,
                 params={"verbose": -1, "max_bin": 63}).save_binned(out)

    def port(comm):
        td = TrainingData.from_binned(out, comm=comm)
        return (td._binned_reader.row_range, td.binned, td.metadata.label,
                td.metadata.weights, td._comm is comm)

    def jax_(comm):
        td = JTrainingData.from_binned(out, comm=comm)
        return (td._binned_reader.row_range, np.asarray(td.binned),
                np.asarray(td.metadata.label),
                np.asarray(td.metadata.weights))

    ours = run_ranks(3, port, barrier_timeout=TIMEOUT)
    theirs = jrun_ranks(3, jax_, barrier_timeout=TIMEOUT)
    for o, t in zip(ours, theirs):
        assert tuple(o[0]) == tuple(t[0])
        np.testing.assert_array_equal(o[1], t[1])
        np.testing.assert_array_equal(o[2], t[2])
        np.testing.assert_array_equal(o[3], t[3])
        assert o[4]
    # the ranks' rows are the directory's, in order
    full = TrainingData.from_binned(out)
    np.testing.assert_array_equal(np.concatenate([o[1] for o in ours]),
                                  full.binned)


# --------------------------------------------------------- drift line
BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
        "min_data_in_leaf": 5, "verbose": -1, "metric": "auc"}


def _fp_line(text):
    lines = [l for l in text.splitlines()
             if l.startswith("drift_fingerprint=")]
    return lines[0] if lines else None


def _without_fp(text):
    return "\n".join(l for l in text.splitlines()
                     if not l.startswith("drift_fingerprint="))


@pytest.fixture(scope="module")
def drift_xy():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(1200, 5))
    y = (X[:, 0] - X[:, 1] + 0.2 * rng.normal(size=1200) > 0).astype(float)
    return X, y


def test_model_text_carries_the_jax_packages_drift_line(drift_xy,
                                                        tmp_path):
    X, y = drift_xy
    ds = lgbt.Dataset(X, label=y)
    b = lgbt.train(BASE, ds, 4, valid_sets=[ds], valid_names=["train"],
                   device="cpu")
    text = b.model_to_string()
    jds = jlgb.Dataset(X, label=y)
    bj = jlgb.train(dict(BASE, tpu_growth="wave", tpu_wave_width=8,
                         tpu_histogram_mode="pallas_ct",
                         tpu_pallas_interpret=True,
                         tpu_hist_precision="hilo"),
                    jds, 4, valid_sets=[jds], valid_names=["train"],
                    verbose_eval=False)
    ours, theirs = _fp_line(text), _fp_line(bj.model_to_string())
    assert ours is not None and theirs is not None
    mine, want = (json.loads(l.split("=", 1)[1]) for l in (ours, theirs))
    assert mine["features"] == want["features"]
    # the score histograms: the same counts, edges at scores that agree
    # to the oracle's hi/lo rounding
    for kind in ("raw", "output"):
        assert mine["scores"][kind]["counts"] == \
            want["scores"][kind]["counts"]
        np.testing.assert_allclose(mine["scores"][kind]["edges"],
                                   want["scores"][kind]["edges"], rtol=1e-4,
                                   atol=1e-5)
    assert set(mine) == set(want)
    assert [e["metric"] for e in mine["eval"]] == \
        [e["metric"] for e in want["eval"]]
    np.testing.assert_allclose([e["value"] for e in mine["eval"]],
                               [e["value"] for e in want["eval"]],
                               rtol=1e-4)

    # a reloaded model serves with drift monitoring on
    path = str(tmp_path / "m.txt")
    b.save_model(path)
    loaded = lgbt.Booster(model_file=path, device="cpu")
    assert loaded._gbdt.drift_fingerprint()["features"] == mine["features"]
    from lightgbm_tpu_torch.obs import observer_from_config
    obs = observer_from_config(Config({"obs_drift_every": 64}))
    with loaded.serve(observer=obs, drift_every=64) as sp:
        sp.predict(X[:300])
        assert sp.drift is not None and sp.drift.enabled
    assert "drift" in [e["ev"] for e in obs.timeline]


def test_the_line_rides_where_the_jax_package_carries_it(drift_xy,
                                                         tmp_path):
    """In memory and through a directory saved from it: the line (the
    header carries the fingerprint); streamed into a directory or through
    a binary dataset file: no line, as in the JAX package.  The texts are
    otherwise equal."""
    X, y = drift_xy
    p = dict(BASE, metric="binary_logloss")
    mem = lgbt.Dataset(X, label=y, params=p)
    t_mem = lgbt.train(p, mem, 3, device="cpu").model_to_string()
    saved = str(tmp_path / "saved")
    lgbt.Dataset(X, label=y, params=p).save_binned(saved)
    t_dir = lgbt.train(p, lgbt.Dataset.from_binned(saved, params=p), 3,
                       device="cpu").model_to_string()
    streamed = str(tmp_path / "streamed")
    TrainingData.from_streamed(X, y, Config(dict(p)), out_dir=streamed)
    t_str = lgbt.train(p, lgbt.Dataset.from_binned(streamed, params=p), 3,
                       device="cpu").model_to_string()
    binf = str(tmp_path / "d.bin")
    lgbt.Dataset(X, label=y, params=p).save_binary(binf)
    t_bin = lgbt.train(p, lgbt.Dataset(binf, params=p), 3,
                       device="cpu").model_to_string()
    assert _fp_line(t_mem) is not None and _fp_line(t_dir) == _fp_line(t_mem)
    assert _fp_line(t_str) is None and _fp_line(t_bin) is None
    assert len({_without_fp(t) for t in (t_mem, t_dir, t_str, t_bin)}) == 1
    # the JAX package's own directory and binary file agree
    jsaved = str(tmp_path / "jsaved")
    jlgb.Dataset(X, label=y, params=p).save_binned(jsaved)
    assert json.load(open(os.path.join(jsaved, "header.json"))).get(
        "drift_fingerprint") is not None
    assert json.load(open(os.path.join(saved, "header.json")))[
        "drift_fingerprint"] == json.load(open(os.path.join(
            jsaved, "header.json")))["drift_fingerprint"]
