"""DART, GOSS and InfiniteBoost in the port (models/factory.py), as the
JAX package trains them.

Each mode is order-sensitive, so ``tpu_wave_order=auto`` resolves to
exact-order waves in both packages; the port trains on ``device="cpu"``
through its kernels' plain versions and the JAX package with f32
``onehot`` histograms.  What must agree:

* DART (uniform_drop and xgboost_dart_mode on and off, drop_rate 0.5,
  skip_drop 0): the trees dropped at each iteration, the trees'
  partitions and their leaf values after normalization (rtol 1e-5, atol
  1e-5 x the largest leaf);
* GOSS (learning_rate 0.5, so sampling starts at iteration 2), with the
  JAX package's uniform keys handed to the port: the same row
  multipliers at every iteration and the same trees (a pinned seed: the
  rows left out weigh 0, so the bins holding only them are empty to the
  split search, and where rounding picks the other threshold of such a
  gap those rows land in another leaf and the later samples part); no
  sampling before
  int(1 / learning_rate); rows tied at the |g h| threshold all kept;
  bagging refused;
* InfiniteBoost: the same trees and the same final tree weights (the
  ``shrinkage`` of each tree) to rtol 1e-6, and the same normalization
  as the JAX package really uses (``train`` takes num_iterations out of
  the params before the booster reads it);
* ``fused_supported``'s verdict and reason for each mode and for
  multiclass, mirroring tests/test_fused_iter.py.

Thresholds are not compared: at 15 leaves and 63 bins a small leaf (or,
under GOSS, a leaf's kept rows) often leaves a bin empty, where two
thresholds make one partition of the training rows and rounding picks
one (ROADMAP C).
"""
import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import fused_iter as jfi
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.models.goss import GOSS
from lightgbm_tpu_torch.ops import fused_iter as tfi
from torch_cases import labels, leaf_values, parity_data
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ROUNDS = 5
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def _partitions(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def _params(objective, **more):
    return {"objective": objective, "num_leaves": 15,
            "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
            "tpu_growth": "wave", "tpu_wave_width": 4,
            "tpu_histogram_mode": "pallas_ct", **more}


def _jax_uniform(self, it, n):
    """The JAX package's GOSS keys for iteration it."""
    key = jax.random.PRNGKey(self.config.bagging_seed + it)
    return torch.as_tensor(np.array(jax.random.uniform(key, (n,))))


def _record(store):
    """A callback keeping each iteration's drops and row multipliers."""
    def callback(env):
        g = env.model._gbdt
        m = getattr(g, "row_mult", None)
        store.append((list(getattr(g, "drop_index", [])),
                      None if m is None else np.asarray(m).copy()))
    return callback


def _pair(objective, seed, **more):
    """(port booster, JAX booster, port records, JAX records, X)."""
    X, s = parity_data(seed, 2500, False)
    y = labels(objective, s)
    p = _params(objective, **more)
    rt, rj = [], []
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), ROUNDS, device="cpu",
                    callbacks=[_record(rt)])
    bj = lgbj.train(dict(p, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), ROUNDS, verbose_eval=False,
                    callbacks=[_record(rj)])
    assert bt._gbdt.learner.wave_order == "exact"
    return bt, bj, rt, rj, X


def _same_trees(bt, bj, X):
    st, sj = bt.model_to_string(), bj.model_to_string()
    assert bt.num_trees() == bj.num_trees()
    assert _partitions(st) == _partitions(sj)
    lt, lj = leaf_values(st), leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=1e-5,
                               atol=1e-5 * np.abs(lj).max())
    np.testing.assert_allclose(bt.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("uniform_drop", [False, True])
@pytest.mark.parametrize("xgboost_dart_mode", [False, True])
def test_dart_drops_and_normalizes_as_the_jax_package(uniform_drop,
                                                      xgboost_dart_mode):
    objective = "regression" if xgboost_dart_mode else "binary"
    bt, bj, rt, rj, X = _pair(
        objective, 2, boosting="dart", drop_rate=0.5, skip_drop=0.0,
        uniform_drop=uniform_drop, xgboost_dart_mode=xgboost_dart_mode)
    drops = [d for d, _ in rt]
    assert drops == [d for d, _ in rj]
    assert any(drops)
    if not uniform_drop:
        np.testing.assert_allclose(bt._gbdt.tree_weight,
                                   bj._gbdt.tree_weight, rtol=1e-12)
    _same_trees(bt, bj, X)
    # the device train score follows the normalized host trees
    np.testing.assert_allclose(bt._gbdt.train_score[0],
                               bt.predict(X, raw_score=True), rtol=1e-5,
                               atol=1e-5)


def test_goss_samples_and_trains_as_the_jax_package(monkeypatch):
    monkeypatch.setattr(GOSS, "_uniform", _jax_uniform)
    bt, bj, rt, rj, X = _pair("binary", 14, boosting="goss",
                              learning_rate=0.5)
    for it, ((_, mt), (_, mj)) in enumerate(zip(rt, rj)):
        if it < 2:
            assert mt is None and mj is None
        else:
            np.testing.assert_array_equal(mt, mj)
            assert 0 < mt.sum() < len(X)
    _same_trees(bt, bj, X)


def test_goss_keeps_ties_at_the_threshold(monkeypatch):
    """Rows whose |g h| equals the top_k-th largest are all kept; the
    rest are sampled with an exact count and scaled by (n - top_k) /
    other_k; the port's selection equals the JAX package's on the same
    gradients and keys."""
    monkeypatch.setattr(GOSS, "_uniform", _jax_uniform)
    X, s = parity_data(3, 400, False)
    y = labels("binary", s)
    p = _params("binary", boosting="goss", learning_rate=0.5,
                top_rate=0.1, other_rate=0.2)
    gt = lgbt.Booster(p, lgbt.Dataset(X, label=y), device="cpu")._gbdt
    gj = lgbj.Booster(dict(p, tpu_histogram_mode="onehot"),
                      lgbj.Dataset(X, label=y))._gbdt
    rng = np.random.default_rng(4)
    g = rng.normal(size=(1, 400)).astype(np.float32)
    h = np.ones((1, 400), np.float32)
    g[0, :60] = 5.0                            # 60 rows tie at the top
    for it in (0, 1):
        out = gt._bagging_with_grad(it, torch.from_numpy(g),
                                    torch.from_numpy(h))
        assert gt.row_mult is None and np.array_equal(out[0].numpy(), g)
    gt_g, gt_h = gt._bagging_with_grad(2, torch.from_numpy(g),
                                       torch.from_numpy(h))
    gj_g, gj_h = gj._bagging_with_grad(2, jax.numpy.asarray(g),
                                       jax.numpy.asarray(h))
    mult = gt.row_mult.numpy()
    np.testing.assert_array_equal(mult, np.asarray(gj.row_mult))
    np.testing.assert_array_equal(gt_g.numpy(), np.asarray(gj_g))
    np.testing.assert_array_equal(gt_h.numpy(), np.asarray(gj_h))
    assert mult[:60].all()                     # top_k is 40: ties kept
    rest = mult[60:]
    assert rest.sum() == 80                    # other_k, exactly
    scaled = (mult > 0) & (gt_h.numpy()[0] != 1.0)
    assert scaled.sum() == 80
    np.testing.assert_array_equal(gt_h.numpy()[0][scaled],
                                  np.float32((400 - 40) / 80))


def test_goss_refuses_bagging():
    X, s = parity_data(3, 400, False)
    p = _params("binary", boosting="goss", bagging_fraction=0.5,
                bagging_freq=1)
    with pytest.raises(lgbt.LightGBMError, match="cannot use bagging in GOSS"):
        lgbt.train(p, lgbt.Dataset(X, label=labels("binary", s)), 1,
                   device="cpu")


@pytest.mark.parametrize("objective,seed", [("regression", 2),
                                            ("binary", 3)])
def test_infiniteboost_weights_trees_as_the_jax_package(objective, seed):
    bt, bj, _, _, X = _pair(objective, seed, boosting="infinite",
                            capacity=20.0, num_iterations=ROUNDS)
    # train() pops num_iterations before the booster is built, in both
    # packages, so the normalization is the default 100 rounds'
    assert bt._gbdt.normalization == bj._gbdt.normalization == 5050.0
    assert bt._gbdt.shrinkage_rate == 1.0
    _same_trees(bt, bj, X)

    def weights(b):
        return [float(ln.split("=")[1]) for ln in
                b.model_to_string().splitlines()
                if ln.startswith("shrinkage=")]
    wt = weights(bt)
    assert len(wt) == bt.num_trees()
    np.testing.assert_allclose(wt, weights(bj), rtol=1e-6)
    # the scores trained on (the capped contributions, with the (1 - eta)
    # multiplies in place), not the final weights
    np.testing.assert_allclose(bt._gbdt.train_score,
                               np.asarray(bj._gbdt.train_score), rtol=1e-5,
                               atol=1e-5)
    # a Booster built directly reads the configured count
    y = labels(objective, parity_data(seed, 2500, False)[1])
    direct = lgbt.Booster(_params(objective, boosting="infinite",
                                  num_iterations=ROUNDS),
                          lgbt.Dataset(X, label=y), device="cpu")
    assert direct._gbdt.normalization == ROUNDS * (ROUNDS + 1) / 2


def test_fused_supported_gives_the_jax_package_reasons():
    X, s = parity_data(3, 300, False)
    y = labels("binary", s)
    y3 = np.digitize(s, [-0.6, 0.6]).astype(float)
    cases = [({"boosting": "dart"}, y, "dart"),
             ({"boosting": "goss"}, y, "goss"),
             ({"boosting": "infinite"}, y, "dart"),
             ({"objective": "multiclass", "num_class": 3}, y3,
              "multiclass"),
             ({"objective": "multiclassova", "num_class": 3}, y3,
              "multiclass"),
             ({}, y, None)]
    for extra, lab, tag in cases:
        p = dict(_params("binary", tpu_fused_iter="on"), **extra)
        bt = lgbt.train(p, lgbt.Dataset(X, label=lab), 1, device="cpu")
        # the verdict reads the booster's shape only: no training needed
        bj = lgbj.Booster(dict(p, tpu_histogram_mode="onehot"),
                          lgbj.Dataset(X, label=lab))
        got = tfi.fused_supported(bt._gbdt)
        assert got == jfi.fused_supported(bj._gbdt), extra
        if tag is None:
            assert got == (True, "")
            assert bt._gbdt._fused_state[0] is not None
        else:
            assert not got[0] and tag in got[1], extra
            # on: warned and stayed on the staged chain
            assert bt._gbdt._fused_state == (None,)
