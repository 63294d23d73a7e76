"""The port's scikit-learn estimators against the JAX package's.

* LGBMModel, LGBMRegressor, LGBMClassifier and LGBMRanker fit the JAX
  estimators' trees on the same data and params (the oracle flags passed
  through as keyword params; the partitions of the training rows
  (``apply``), as an empty bin gap lets either of two thresholds split
  them; leaf values and predictions within the
  oracle's bf16 hi/lo rounding: 1e-3 of the largest leaf, rtol 1e-4 on
  predictions) and, on the port alone, the trees ``train`` fits with the
  params the estimator makes;
* ``get_params``/``clone`` carry every constructor argument, ``device``
  among them; string class labels come back from ``predict``;
  ``predict_proba`` rows sum to 1; a small ``GridSearchCV`` runs.
"""
import numpy as np
import pytest
from sklearn.base import clone
from sklearn.model_selection import GridSearchCV

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

KW = {"n_estimators": 3, "num_leaves": 7, "max_bin": 31,
      "min_child_samples": 10, "tpu_growth": "wave", "tpu_wave_width": 4,
      "tpu_histogram_mode": "pallas_ct"}
ORACLE = {"tpu_pallas_interpret": True, "tpu_hist_precision": "hilo"}
KEYS = ("split_feature", "left_child", "right_child", "leaf_count",
        "decision_type")


def _structure(text):
    return [ln for ln in text.splitlines() if ln.startswith(KEYS)]


def _leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value")])


def _data(seed=0, n=700):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    s = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=n)
    return X, s


def _ranking(seed=0, nq=40, per=15):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(nq * per, 5))
    rel = X[:, 0] + 0.3 * rng.normal(size=nq * per)
    y = np.clip((rel * 2).astype(int) - rel.astype(int), 0, 4).astype(float)
    return X, y, np.full(nq, per)


CASES = {
    "regressor": (lgbt.LGBMRegressor, lgbj.LGBMRegressor, {}),
    "classifier": (lgbt.LGBMClassifier, lgbj.LGBMClassifier, {}),
    "multiclass": (lgbt.LGBMClassifier, lgbj.LGBMClassifier, {}),
    "ranker": (lgbt.LGBMRanker, lgbj.LGBMRanker, {}),
    "model": (lgbt.LGBMModel, lgbj.LGBMModel, {"objective": "huber"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_estimators_fit_the_jax_trees(case):
    tcls, jcls, more = CASES[case]
    fit = {}
    if case == "ranker":
        X, y, group = _ranking()
        fit["group"] = group
    else:
        X, s = _data(3)
        y = s
        if case == "classifier":
            y = (s > 0).astype(int)
        elif case == "multiclass":
            y = np.digitize(s, np.quantile(s, [1 / 3, 2 / 3]))
    t = tcls(device="cpu", **KW, **more).fit(X, y, **fit)
    j = jcls(**KW, **ORACLE, **more).fit(X, y, **fit)
    st, sj = t.booster_.model_to_string(), j.booster_.model_to_string()
    assert _structure(st) == _structure(sj)
    # the partitions of the training rows: an empty bin gap (the zero bin
    # of normal features) makes two thresholds split the rows alike
    np.testing.assert_array_equal(t.apply(X), j.apply(X))
    lj = _leaf_values(sj)
    np.testing.assert_allclose(_leaf_values(st), lj, rtol=0,
                               atol=1e-3 * np.abs(lj).max())
    np.testing.assert_allclose(t.predict(X), j.predict(X), rtol=1e-4,
                               atol=1e-4 if case != "ranker" else 1e-3)
    if case in ("classifier", "multiclass"):
        p = t.predict_proba(X)
        assert p.shape == (len(X), 2 if case == "classifier" else 3)
        np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-12)
        np.testing.assert_array_equal(t.classes_, j.classes_)
    # the estimator trains what train trains with the estimator's params
    params, _ = t._make_params()
    ds = lgbt.Dataset(X, label=y if case != "classifier" else
                      y.astype(float), group=fit.get("group"))
    if case == "multiclass":
        params = dict(params, objective="multiclass", num_class=3)
    want = lgbt.train(params, ds, KW["n_estimators"], device="cpu",
                      verbose_eval=False)
    assert st == want.model_to_string()
    assert t.n_features_ == X.shape[1]
    np.testing.assert_array_equal(t.feature_importances_,
                                  want.feature_importance())


def test_get_params_clone_and_string_labels():
    est = lgbt.LGBMClassifier(device="cpu", n_estimators=2, num_leaves=5,
                              min_child_samples=5, extra_knob=3)
    params = est.get_params()
    assert params["device"] == "cpu" and params["extra_knob"] == 3
    twin = clone(est)
    assert twin.get_params() == params
    assert lgbt.LGBMRegressor().get_params()["device"] == "cuda"
    X, s = _data(4, n=300)
    labels = np.where(s > 0, "yes", "no")
    twin.fit(X, labels)
    assert set(twin.predict(X)) <= {"yes", "no"}
    np.testing.assert_array_equal(twin.classes_, ["no", "yes"])
    assert (twin.predict(X) == labels).mean() > 0.7


def test_small_grid_search():
    X, s = _data(5, n=300)
    gs = GridSearchCV(lgbt.LGBMRegressor(device="cpu", n_estimators=2,
                                         min_child_samples=5),
                      {"num_leaves": [3, 7]}, cv=2)
    gs.fit(X, s)
    assert gs.best_params_["num_leaves"] in (3, 7)
    assert gs.best_estimator_.get_params()["device"] == "cpu"
