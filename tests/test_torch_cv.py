"""``cv`` in the port against the JAX package's.

* ``_make_n_folds`` gives the JAX package's folds for the same seed:
  plain (numpy ``default_rng(seed)`` permutation, shuffled or not) and
  stratified (sklearn's StratifiedKFold), and caller-given folds;
* ``cv`` histories (``<metric>-mean`` and ``-stdv`` a round) agree with
  the JAX package's on the oracle flags within the training tolerance of
  ROADMAP C: AUC to 1e-6, the logloss to rtol 1e-4 (the oracle's bf16
  hi/lo split moves leaf values by up to 1e-3 of the largest);
* early stopping cuts every list at the best round, and the CVBooster
  hands a method to every fold's booster.
"""
import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.engine import _make_n_folds as jfolds
from lightgbm_tpu_torch.engine import _make_n_folds as tfolds
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
          "min_data_in_leaf": 10, "verbose": -1, "learning_rate": 0.3,
          "metric": ["auc", "binary_logloss"], "tpu_growth": "wave",
          "tpu_wave_width": 4, "tpu_histogram_mode": "pallas_ct"}
ORACLE = {"tpu_pallas_interpret": True, "tpu_hist_precision": "hilo"}


def _data(seed=0, n=900):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0)
    return X, y.astype(float)


@pytest.mark.parametrize("stratified,shuffle", [(False, True),
                                                (False, False),
                                                (True, True)])
def test_folds_match_jax(stratified, shuffle):
    X, y = _data()
    t = tfolds(lgbt.Dataset(X, label=y, params=PARAMS), None, 4, PARAMS,
               seed=7, stratified=stratified, shuffle=shuffle)
    j = jfolds(lgbj.Dataset(X, label=y, params=PARAMS), None, 4, PARAMS,
               seed=7, stratified=stratified, shuffle=shuffle)
    assert len(t) == len(j) == 4
    for (tt, tv, _), (jt, jv, _) in zip(t, j):
        np.testing.assert_array_equal(tt.used_indices, jt.used_indices)
        np.testing.assert_array_equal(tv.used_indices, jv.used_indices)
        np.testing.assert_array_equal(tt.construct()._handle.binned,
                                      jt.construct()._handle.binned)
        np.testing.assert_array_equal(tv.get_label(), jv.get_label())


@pytest.mark.parametrize("classes,shuffle", [(2, True), (3, True),
                                             (3, False)])
def test_stratified_folds_are_sklearns(classes, shuffle):
    """The port's own stratified folds (no scikit-learn needed) are
    StratifiedKFold's, classes in order of first appearance included."""
    from sklearn.model_selection import StratifiedKFold
    from lightgbm_tpu_torch.engine import _stratified_folds
    rng = np.random.default_rng(classes)
    y = rng.integers(0, classes, size=503).astype(float)
    y[0] = classes - 1
    want = StratifiedKFold(n_splits=5, shuffle=shuffle,
                           random_state=11 if shuffle else None).split(
        np.zeros(len(y)), y)
    for (tt, tv), (wt, wv) in zip(_stratified_folds(y, 5, shuffle, 11),
                                  want):
        np.testing.assert_array_equal(tt, wt)
        np.testing.assert_array_equal(tv, wv)
    with pytest.raises(lgbt.LightGBMError, match="class labels"):
        _stratified_folds(y + 0.5, 5, True, 0)


def test_given_folds_are_used():
    X, y = _data(1, n=300)
    given = [(np.arange(100, 300), np.arange(100)),
             (np.arange(200), np.arange(200, 300))]
    t = tfolds(lgbt.Dataset(X, label=y, params=PARAMS), given, 2, PARAMS,
               seed=0)
    assert [list(v.used_indices) for _, v, _ in t] == [
        list(range(100)), list(range(200, 300))]


def test_cv_histories_match_jax():
    X, y = _data(2)
    params = dict(PARAMS, **ORACLE)
    ht = lgbt.cv(params, lgbt.Dataset(X, label=y), num_boost_round=3,
                 nfold=3, stratified=True, seed=5, device="cpu")
    hj = lgbj.cv(params, lgbj.Dataset(X, label=y), num_boost_round=3,
                 nfold=3, stratified=True, seed=5)
    assert sorted(ht) == sorted(hj) == ["auc-mean", "auc-stdv",
                                        "binary_logloss-mean",
                                        "binary_logloss-stdv"]
    for key in ("auc-mean", "auc-stdv"):
        np.testing.assert_allclose(ht[key], hj[key], rtol=0, atol=1e-6)
    np.testing.assert_allclose(ht["binary_logloss-mean"],
                               hj["binary_logloss-mean"], rtol=1e-4)
    assert len(ht["auc-mean"]) == 3


def test_cv_early_stopping_and_the_cvbooster():
    X, y = _data(3, n=600)
    Xt = np.random.default_rng(4).normal(size=(600, 5))
    yt = (Xt[:, 0] > 0).astype(float)     # the label is noise to X
    seen = []

    def spy(env):
        seen.append(env.model)

    hist = lgbt.cv(dict(PARAMS, metric="binary_logloss", learning_rate=1.0,
                        num_leaves=15, min_data_in_leaf=2),
                   lgbt.Dataset(X, label=yt), num_boost_round=30, nfold=3,
                   early_stopping_rounds=2, verbose_eval=False,
                   callbacks=[spy], device="cpu")
    n = len(hist["binary_logloss-mean"])
    assert 1 <= n < 30
    assert len(hist["binary_logloss-stdv"]) == n
    cvb = seen[0]
    assert isinstance(cvb, lgbt.CVBooster) and len(cvb.boosters) == 3
    assert cvb.best_iteration == n
    assert cvb.current_iteration() == [len(seen)] * 3
    preds = cvb.predict(Xt[:5])
    assert len(preds) == 3 and all(p.shape == (5,) for p in preds)
