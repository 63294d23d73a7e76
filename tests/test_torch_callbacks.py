"""Early stopping, the callbacks and rollback in the port, as in the JAX
package (its engine.py and callback.py, and models/gbdt.py's own
``early_stopping_round``).

The JAX package trains with f32 ``onehot`` histograms, the port on
``device="cpu"`` through its kernels' plain versions, on pinned seeds
(where a small leaf leaves a bin empty, two thresholds make one
partition of the training rows and rounding picks one; a valid row in
that bin then scores differently -- ROADMAP C).

* ``early_stopping_rounds``: the same ``best_iteration`` and
  ``best_score`` (to 1e-6), every tree kept, and the same
  ``predict(num_iteration=best_iteration)`` (rtol 1e-5);
* the booster's own ``early_stopping_round``, reached when GBDT's
  ``train_one_iter`` evaluates (is_eval): the same iteration stops and
  the same trees are popped;
* ``record_evaluation`` fills the same dict; ``reset_parameter`` with a
  learning-rate schedule (and ``learning_rates``) trains the same trees;
* ``rollback_one_iter`` leaves the same train and valid scores and the
  same trees as the JAX package's, binary and multiclass;
* ``print_evaluation`` logs each iteration's evaluation.
"""
import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch import callback as tcb
from lightgbm_tpu import callback as jcb
from torch_cases import labels, leaf_values, parity_data
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def _partitions(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def _params(objective="binary", **more):
    return {"objective": objective, "num_leaves": 15,
            "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
            "learning_rate": 0.5, "metric": "binary_logloss",
            "tpu_growth": "wave", "tpu_wave_width": 4,
            "tpu_histogram_mode": "pallas_ct", **more}


def _jax(p):
    return dict(p, tpu_histogram_mode="onehot")


def _data(seed, n=1500, nv=500, noise=1.5):
    """parity_data's features with a noisy label, so the valid loss turns
    up within a few rounds at learning rate 0.5."""
    X, s = parity_data(seed, n + nv, False)
    rng = np.random.default_rng(seed + 7)
    y = (s + noise * rng.normal(size=n + nv) > 0).astype(float)
    return X[:n], y[:n], X[n:], y[n:]


def _same_trees(st, sj):
    assert _partitions(st) == _partitions(sj)
    lt, lj = leaf_values(st), leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=1e-5,
                               atol=1e-5 * np.abs(lj).max())


def test_early_stopping_rounds_as_the_jax_package():
    X, y, Xv, yv = _data(3)
    p = _params()
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), 40,
                    valid_sets=[lgbt.Dataset(Xv, label=yv)],
                    early_stopping_rounds=3, device="cpu")
    bj = lgbj.train(_jax(p), lgbj.Dataset(X, label=y), 40,
                    valid_sets=[lgbj.Dataset(Xv, label=yv)],
                    early_stopping_rounds=3, verbose_eval=False)
    assert 1 <= bt.best_iteration == bj.best_iteration < 20
    assert bt.current_iteration() == bj.current_iteration() \
        == bt.best_iteration + 3
    got = bt.best_score["valid_0"]["binary_logloss"]
    assert abs(got - bj.best_score["valid_0"]["binary_logloss"]) <= 1e-6
    _same_trees(bt.model_to_string(), bj.model_to_string())
    best = bt.predict(Xv, num_iteration=bt.best_iteration)
    np.testing.assert_allclose(
        best, bj.predict(Xv, num_iteration=bj.best_iteration), rtol=1e-5)
    # num_iteration=-1 means every tree, not best_iteration
    assert not np.allclose(bt.predict(Xv), best)
    # the early_stopping_round param takes the same path
    bp = lgbt.train(dict(p, early_stopping_round=3),
                    lgbt.Dataset(X, label=y), 40,
                    valid_sets=[lgbt.Dataset(Xv, label=yv)], device="cpu")
    assert bp.best_iteration == bt.best_iteration
    assert bp.model_to_string() == bt.model_to_string()


def test_gbdt_early_stopping_round_pops_the_same_trees():
    X, y, Xv, yv = _data(3)
    p = _params(early_stopping_round=2)
    dt, dj = lgbt.Dataset(X, label=y), lgbj.Dataset(X, label=y)
    bt = lgbt.Booster(p, dt, device="cpu")
    bt.add_valid(dt.create_valid(Xv, label=yv), "valid_0")
    bj = lgbj.Booster(_jax(p), dj)
    bj.add_valid(dj.create_valid(Xv, label=yv), "valid_0")
    gt, gj = bt._gbdt, bj._gbdt
    nt = next(i + 1 for i in range(40) if gt.train_one_iter(True))
    nj = next(i + 1 for i in range(40) if gj.train_one_iter(None, None,
                                                            True))
    assert nt == nj < 40
    # the trees of the last early_stopping_round iterations were popped
    assert len(gt.models) == len(gj.models) == nt - 2
    assert gt.best_iter == gj.best_iter
    _same_trees(bt.model_to_string(), bj.model_to_string())


def test_record_evaluation_and_print_evaluation(capsys):
    X, y, Xv, yv = _data(3)
    p = _params(metric="binary_logloss,auc", verbose=1)
    rt, rj = {}, {}
    lgbt.train(p, lgbt.Dataset(X, label=y), 4,
               valid_sets=[lgbt.Dataset(X, label=y),
                           lgbt.Dataset(Xv, label=yv)],
               valid_names=["train", "valid"], device="cpu",
               callbacks=[tcb.record_evaluation(rt)], verbose_eval=2)
    err = capsys.readouterr().err
    assert "[2]\ttrain's binary_logloss:" in err and "[4]\t" in err
    assert "[3]\t" not in err
    lgbj.train(_jax(p), lgbj.Dataset(X, label=y), 4,
               valid_sets=[lgbj.Dataset(X, label=y),
                           lgbj.Dataset(Xv, label=yv)],
               valid_names=["train", "valid"], verbose_eval=False,
               callbacks=[jcb.record_evaluation(rj)])
    assert list(rt) == list(rj) == ["train", "valid"]
    for name in rj:
        assert list(rt[name]) == list(rj[name])
        for metric in rj[name]:
            np.testing.assert_allclose(rt[name][metric], rj[name][metric],
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("how", ["callback", "learning_rates"])
def test_reset_parameter_trains_the_same_trees(how):
    X, y, Xv, yv = _data(5)
    p = _params()
    rates = [0.5, 0.3, 0.2, 0.1]
    kw_t = ({"callbacks": [tcb.reset_parameter(learning_rate=rates)]}
            if how == "callback" else {"learning_rates": rates})
    kw_j = ({"callbacks": [jcb.reset_parameter(learning_rate=rates)]}
            if how == "callback" else {"learning_rates": rates})
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), 4, device="cpu", **kw_t)
    bj = lgbj.train(_jax(p), lgbj.Dataset(X, label=y), 4,
                    verbose_eval=False, **kw_j)
    st = bt.model_to_string()
    assert [float(ln.split("=")[1]) for ln in st.splitlines()
            if ln.startswith("shrinkage=")] == rates
    _same_trees(st, bj.model_to_string())
    # another key rebuilds the learner and keeps the trees and scores
    bt.reset_parameter({"num_leaves": 7})
    assert bt._gbdt.learner.num_leaves == 7 and bt.num_trees() == 4
    bt.update()
    assert bt.num_trees() == 5
    with pytest.raises(lgbt.LightGBMError, match="Cannot change objective"):
        bt.reset_parameter({"objective": "regression"})


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_rollback_one_iter_as_the_jax_package(objective):
    X, s = parity_data(3, 2000, False)
    if objective == "binary":
        y = labels("binary", s)
        more = {}
    else:
        y = np.digitize(s, [-0.6, 0.6]).astype(float)
        more = {"num_class": 3, "metric": "multi_logloss"}
    p = _params(objective, **more)
    dt = lgbt.Dataset(X[:1500], label=y[:1500])
    dj = lgbj.Dataset(X[:1500], label=y[:1500])
    bt = lgbt.Booster(p, dt, device="cpu")
    bt.add_valid(dt.create_valid(X[1500:], label=y[1500:]), "valid_0")
    bj = lgbj.Booster(_jax(p), dj)
    bj.add_valid(dj.create_valid(X[1500:], label=y[1500:]), "valid_0")
    for b in (bt, bj):
        for _ in range(3):
            b.update()
        b.rollback_one_iter()
    k = 3 if objective == "multiclass" else 1
    assert bt.num_trees() == bj.num_trees() == 2 * k
    assert bt.current_iteration() == bj.current_iteration() == 2
    for got, want in ((bt._gbdt.train_score, bj._gbdt.train_score),
                      (bt._gbdt.valid_score_host(0),
                       bj._gbdt.valid_score_host(0))):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    _same_trees(bt.model_to_string(), bj.model_to_string())
    # the scores are the remaining trees' again
    np.testing.assert_allclose(
        bt._gbdt.train_score.T.reshape(-1, k),
        bt.predict(X[:1500], raw_score=True).reshape(-1, k), rtol=1e-5,
        atol=1e-5)
