"""Lambdarank and the ranking metrics in the port, against the JAX
package.

* ``LambdarankNDCG.get_gradients`` (device torch over padded query
  buckets, here on the CPU) against the JAX package's ``get_gradients``
  (its XLA ``vmap``) and ``get_gradients_host`` (the reference-shaped
  numpy oracle), and the port's own host oracle against the JAX one: rtol
  2e-4 / atol 2e-5 (the JAX package's tolerance,
  tests/test_lambdarank_device.py), with and without row weights, with
  degenerate queries (one document, equal labels, no positive label,
  tied scores) and a query wider than the block of another bucket;
* NDCG and MAP give the JAX package's values on the same scores to 1e-12
  (host float64 on both sides), with and without query weights;
* a small ranking run trains the JAX package's trees (its exact-order
  waves, oracle flags, f32 ``onehot`` leaf values to rtol 1e-5) with the
  same valid NDCG; fused (``tpu_fused_iter=on``) equals staged to the byte;
* the reference-written ``tests/data/golden/lambdarank.model`` predicts
  ``lambdarank.pred`` (rtol 1e-6, as tests/test_torch_cli.py holds the
  other golden models);
* the CLI on examples/lambdarank/train.conf's params over the golden
  files trains the JAX CLI's trees.
"""
import os
import shutil

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu.cli as jcli
import lightgbm_tpu_torch as lgbt
import lightgbm_tpu_torch.cli as tcli
from lightgbm_tpu import metrics as jmet
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.io.metadata import Metadata as JMetadata
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch import metrics as tmet
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.io.metadata import Metadata as TMetadata
from lightgbm_tpu_torch.utils.config import Config as TConfig
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")
CPU = torch.device("cpu")
TOL = {"rtol": 2e-4, "atol": 2e-5}
ORACLE = {"tpu_histogram_mode": "pallas_ct", "tpu_pallas_interpret": True,
          "tpu_hist_precision": "hilo"}


def _ranking(nq=60, seed=3, max_docs=40, wide=0):
    """Query sizes 1..max_docs (and one query of ``wide`` documents),
    labels 0-4 with an informative first feature, and the degenerate
    queries: equal labels, no positive label, tied scores are drawn in."""
    rng = np.random.default_rng(seed)
    counts = list(rng.integers(1, max_docs, size=nq))
    if wide:
        counts.insert(nq // 2, wide)
    counts = np.asarray(counts)
    n = int(counts.sum())
    labels = rng.integers(0, 5, size=n).astype(np.float64)
    qb = np.concatenate([[0], np.cumsum(counts)])
    labels[qb[1]:qb[2]] = 2.0            # equal labels
    labels[qb[2]:qb[3]] = 0.0            # no positive label
    X = rng.normal(size=(n, 8))
    X[:, 0] += labels
    return X, labels, counts


def _metadata(cls, labels, counts, weights=None):
    md = cls(len(labels))
    md.set_label(labels)
    md.set_query_counts(counts)
    if weights is not None:
        md.set_weights(weights)
    return md


def _both(labels, counts, weights=None, **params):
    p = dict({"objective": "lambdarank", "verbose": -1}, **params)
    j = jobj.LambdarankNDCG(JConfig(p))
    j.init(_metadata(JMetadata, labels, counts, weights), len(labels))
    t = tobj.create_objective("lambdarank", TConfig(p))
    t.init(_metadata(TMetadata, labels, counts, weights), len(labels), CPU)
    return j, t


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("wide", [0, 300])
def test_gradients_match_jax(weighted, wide):
    _, labels, counts = _ranking(wide=wide)
    n = len(labels)
    rng = np.random.default_rng(7)
    w = rng.random(n) + 0.5 if weighted else None
    j, t = _both(labels, counts, w)
    for it in range(3):
        score = (rng.normal(size=n) * (it + 1)).astype(np.float32)
        score[:6] = 0.25                 # ties inside the first queries
        g, h = t.get_gradients(torch.from_numpy(score))
        g, h = g.numpy(), h.numpy()
        gj, hj = (np.asarray(a) for a in j.get_gradients(score))
        gh, hh = (np.asarray(a) for a in j.get_gradients_host(score))
        th = t.get_gradients_host(score)
        for got, want in ((g, gj), (h, hj), (g, gh), (h, hh),
                          (th[0], gh), (th[1], hh)):
            np.testing.assert_allclose(got, want, **TOL)
        assert np.abs(g).max() > 0


def test_degenerate_queries_give_zero_lambdas():
    labels = np.array([1.0, 2.0, 2.0, 2.0, 0.0, 0.0, 0.0])
    counts = np.array([1, 3, 1, 2])
    _, t = _both(labels, counts)
    g, h = t.get_gradients(torch.tensor([0.3, 0.1, 0.2, -0.5, 0.9, 0.1,
                                         0.4]))
    assert not g.any() and not h.any()


def test_the_objective_round_trips_and_blocks_bound_the_pairs():
    _, labels, counts = _ranking(wide=300)
    _, t = _both(labels, counts)
    assert t.to_string() == "lambdarank"
    assert isinstance(tobj.load_objective_from_string("lambdarank"),
                      tobj.LambdarankNDCG)
    widths = [int(b["discounts"].numel()) for b in t._buckets]
    assert widths == sorted(widths) and widths[-1] == 512
    assert t.pair_block_bytes() <= 4 * 16_000_000


@pytest.mark.parametrize("name", ["ndcg", "map"])
@pytest.mark.parametrize("weighted", [False, True])
def test_ranking_metrics_match_jax(name, weighted):
    _, labels, counts = _ranking(seed=5)
    n = len(labels)
    rng = np.random.default_rng(11)
    w = rng.random(n) + 0.5 if weighted else None
    p = {"objective": "lambdarank", "verbose": -1,
         "ndcg_eval_at": [1, 3, 5, 10]}
    jm = jmet.create_metric(name, JConfig(p))
    tm = tmet.create_metric(name, TConfig(p))
    assert tm.get_names() == jm.get_names()
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better == 1.0
    jm.init(_metadata(JMetadata, labels, counts, w), n)
    tm.init(_metadata(TMetadata, labels, counts, w), n)
    score = rng.normal(size=n)
    score[:5] = 0.5
    np.testing.assert_allclose(tm.eval(score, None), jm.eval(score, None),
                               rtol=0, atol=1e-12)


def _structure(text, thresholds=True):
    keys = ("split_feature", "left_child", "right_child", "leaf_count",
            "decision_type") + (("threshold=",) if thresholds else ())
    return [ln for ln in text.splitlines() if ln.startswith(keys)]


def _leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value")])


def test_small_ranking_run_trains_the_jax_trees():
    X, y, counts = _ranking(nq=70, seed=8)
    Xv, yv, cv = _ranking(nq=20, seed=9)
    base = {"objective": "lambdarank", "num_leaves": 7, "max_bin": 63,
            "min_data_in_leaf": 20, "verbose": -1, "metric": "ndcg",
            "ndcg_eval_at": [1, 3, 5], "tpu_growth": "wave",
            "tpu_wave_width": 4}
    ej, et, ef = {}, {}, {}
    bj = lgbj.train(dict(base, **ORACLE), lgbj.Dataset(X, label=y,
                                                       group=counts), 3,
                    valid_sets=[lgbj.Dataset(Xv, label=yv, group=cv)],
                    evals_result=ej, verbose_eval=False)
    bf = lgbj.train(dict(base, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y, group=counts), 3,
                    verbose_eval=False)
    texts = []
    for fused in ("off", "on"):
        bt = lgbt.train(dict(base, tpu_fused_iter=fused, **ORACLE),
                        lgbt.Dataset(X, label=y, group=counts), 3,
                        valid_sets=[lgbt.Dataset(Xv, label=yv, group=cv)],
                        evals_result=et, verbose_eval=False, device="cpu")
        assert bt._gbdt.learner.wave_order == "exact"
        assert (bt._gbdt._fused_state[0] is not None) == (fused == "on")
        texts.append(bt.model_to_string())
    assert texts[0] == texts[1]
    st, sj, sf = texts[0], bj.model_to_string(), bf.model_to_string()
    assert "objective=lambdarank" in st
    assert bt.num_trees() == bj.num_trees() == 3
    assert _structure(st) == _structure(sj) == _structure(sf)
    np.testing.assert_allclose(_leaf_values(st), _leaf_values(sf),
                               rtol=1e-5)
    for k in ("ndcg@1", "ndcg@3", "ndcg@5"):
        np.testing.assert_allclose(et["valid_0"][k], ej["valid_0"][k],
                                   rtol=0, atol=1e-6)


def test_golden_model_predicts_the_reference_pred():
    data = np.loadtxt(os.path.join(GOLDEN, "lambdarank.test"),
                      delimiter="\t", ndmin=2)
    want = np.loadtxt(os.path.join(GOLDEN, "lambdarank.pred"))
    path = os.path.join(GOLDEN, "lambdarank.model")
    got = lgbt.Booster(model_file=path, device="cpu").predict(data[:, 1:])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got, lgbj.Booster(model_file=path)
                                  .predict(data[:, 1:]))


def test_cli_trains_the_jax_clis_ranking_trees(tmp_path, monkeypatch):
    """examples/lambdarank/train.conf's params (lambdarank, 31 leaves,
    learning rate 0.1, NDCG at 1, 3, 5) on the golden files with their
    .query side files, 3 trees."""
    for name in os.listdir(GOLDEN):
        if name.startswith("lambdarank"):
            shutil.copy(os.path.join(GOLDEN, name), tmp_path)
    monkeypatch.chdir(tmp_path)
    args = ["task=train", "objective=lambdarank", "data=lambdarank.train",
            "valid_data=lambdarank.test", "num_trees=3",
            "learning_rate=0.1", "num_leaves=31", "metric=ndcg",
            "ndcg_eval_at=1,3,5", "device_type=cpu", "verbose=-1",
            "tpu_growth=wave", "tpu_wave_width=32",
            "tpu_histogram_mode=pallas_ct"]
    jcli.main(args + ["tpu_pallas_interpret=true", "tpu_hist_precision=hilo",
                      "output_model=j.txt"])
    tcli.main(args + ["output_model=t.txt"])
    tj, tt = open("j.txt").read(), open("t.txt").read()
    assert tt.count("Tree=") == tj.count("Tree=") == 3
    assert "objective=lambdarank" in tt
    # the golden files leave bin gaps empty in the training rows, where
    # either threshold of a gap makes the same partition (as
    # tests/test_torch_cli.py compares them): the partitions of the
    # training rows, not the threshold values
    assert _structure(tt, thresholds=False) == _structure(tj,
                                                           thresholds=False)
    X = np.loadtxt("lambdarank.train", delimiter="\t", ndmin=2)[:, 1:]
    np.testing.assert_array_equal(
        lgbt.Booster(model_str=tt, device="cpu").predict(X, pred_leaf=True),
        lgbj.Booster(model_str=tj).predict(X, pred_leaf=True))
    np.testing.assert_allclose(_leaf_values(tt), _leaf_values(tj), rtol=0,
                               atol=1e-3 * np.abs(_leaf_values(tj)).max())
