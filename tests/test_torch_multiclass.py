"""Multiclass training in the port: K trees an iteration through the
wave grower (B3 at the root, B1 every wave, B2 into row ``tid`` of the
(K, N) score), as the JAX package trains them.

The port trains on ``device="cpu"`` with the oracle params of
tests/test_torch_train_parity.py (``pallas_ct``, interpret, ``hilo``),
through its kernels' plain versions.  Against the JAX package's f32
``onehot`` wave run (softmax K = 3 and OVA K = 3, 3 iterations):

* every class tree's structure exactly: split features, thresholds,
  child pointers, leaf counts, decision types (pinned seeds: at 15
  leaves and 63 bins a small leaf often has empty bins, where two
  thresholds make one partition and rounding picks one -- ROADMAP C);
* leaf values to rtol 1e-5 with atol 1e-5 x the largest leaf (the
  exact-growth tests' tolerance: balanced leaves sum in another order);
* the valid ``multi_logloss`` at each iteration to 1e-6;
* ``predict`` of shape (N, 3) to rtol 1e-5.

Against the interpret-mode ``pallas_ct`` oracle itself (softmax), the
same partitions and leaf values within 1e-3 of the largest leaf (its
bf16 hi/lo weights).  A class absent from the labels gets the JAX
package's constant stub, and model text loads in either package and
predicts the same.
"""
import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.convert import booster_from_model_string
from torch_cases import leaf_values, structure
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ROUNDS = 3
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def _partitions(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def multiclass_data(seed, n, classes=(-0.6, 0.6)):
    """tests/torch_cases.py parity_data's features; the label is the
    bucket of its score between the cut points."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=n))
    return X, np.digitize(s, classes).astype(float)


def params(objective, **more):
    return {"objective": objective, "num_class": 3, "num_leaves": 15,
            "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
            "metric": "multi_logloss", "tpu_growth": "wave",
            "tpu_wave_width": 4, **more}


ORACLE = {"tpu_histogram_mode": "pallas_ct", "tpu_pallas_interpret": True,
          "tpu_hist_precision": "hilo"}
# (objective, pinned seed)
CASES = [("multiclass", 5), ("multiclassova", 1)]


def _train(objective, seed):
    X, y = multiclass_data(seed, 2500)
    Xv, yv = multiclass_data(seed + 1000, 600)
    p = params(objective, **ORACLE)
    et, ef = {}, {}
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), ROUNDS,
                    valid_sets=[lgbt.Dataset(Xv, label=yv)], evals_result=et,
                    device="cpu")
    bf = lgbj.train(dict(p, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), ROUNDS,
                    valid_sets=[lgbj.Dataset(Xv, label=yv)], evals_result=ef,
                    verbose_eval=False)
    return bt, bf, et, ef, Xv


@pytest.mark.parametrize("objective,seed", CASES)
def test_multiclass_trains_the_jax_package_trees(objective, seed):
    bt, bf, et, ef, Xv = _train(objective, seed)
    st, sf = bt.model_to_string(), bf.model_to_string()
    assert bt.num_trees() == bf.num_trees() == 3 * ROUNDS
    assert bt.num_model_per_iteration() == 3
    assert bt.current_iteration() == ROUNDS
    assert "num_tree_per_iteration=3" in st.splitlines()
    assert structure(st) == structure(sf)
    lt, lf = leaf_values(st), leaf_values(sf)
    np.testing.assert_allclose(lt, lf, rtol=1e-5,
                               atol=1e-5 * np.abs(lf).max())
    got, want = et["valid_0"]["multi_logloss"], ef["valid_0"]["multi_logloss"]
    assert len(got) == ROUNDS
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert all(a > b for a, b in zip(got, got[1:]))
    pt = bt.predict(Xv)
    assert pt.shape == (len(Xv), 3)
    np.testing.assert_allclose(pt, bf.predict(Xv), rtol=1e-5)
    np.testing.assert_allclose(bt.predict(Xv, raw_score=True),
                               bf.predict(Xv, raw_score=True), rtol=1e-5,
                               atol=1e-6)
    # the device valid scores follow the host trees, a row a class
    raw_dev = bt._gbdt.valid_score_host(0)
    assert raw_dev.shape == (3, len(Xv))
    np.testing.assert_allclose(raw_dev.T, bt.predict(Xv, raw_score=True),
                               rtol=1e-5, atol=1e-5)
    # model text loads in either package and predicts the same
    from_jax = booster_from_model_string(sf, device="cpu")
    np.testing.assert_array_equal(from_jax.predict(Xv), bf.predict(Xv))
    from_port = lgbj.Booster(model_str=st)
    np.testing.assert_array_equal(from_port.predict(Xv), pt)
    again = booster_from_model_string(st, device="cpu")
    assert again.model_to_string() == st


def test_softmax_against_the_interpret_mode_oracle():
    X, y = multiclass_data(5, 2500)
    p = params("multiclass", **ORACLE)
    bj = lgbj.train(p, lgbj.Dataset(X, label=y), ROUNDS, verbose_eval=False)
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), ROUNDS, device="cpu")
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert _partitions(st) == _partitions(sj)
    lt, lj = leaf_values(st), leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())


def test_absent_class_gets_the_constant_stub():
    """Class 1 never appears: it trains no tree; its first tree is the
    JAX package's constant stub (-log(1/eps - 1)) and the later ones
    single leaves, in the port's text as in the JAX package's."""
    X, y = multiclass_data(5, 2500, classes=(0.0,))
    y = y * 2                                  # labels 0 and 2
    p = params("multiclass", tpu_histogram_mode="pallas_ct")
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), ROUNDS, device="cpu")
    bf = lgbj.train(dict(p, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), ROUNDS, verbose_eval=False)
    assert bt._gbdt.class_need_train == [True, False, True]
    assert bt._gbdt.class_default_output == bf._gbdt.class_default_output
    st, sf = bt.model_to_string(), bf.model_to_string()
    trees_t, trees_f = st.split("Tree=")[1:], sf.split("Tree=")[1:]
    assert len(trees_t) == len(trees_f) == 3 * ROUNDS
    assert trees_t[1] == trees_f[1]            # the stub, to the byte
    assert all(trees_t[i].splitlines()[1] == "num_leaves=1"
               for i in (4, 7))
    assert _partitions(st) == _partitions(sf)
    stub = bt._gbdt.class_default_output[1]
    assert np.all(bt._gbdt.train_score[1] == np.float32(stub))
    pt = bt.predict(X[:50])
    np.testing.assert_allclose(pt, bf.predict(X[:50]), rtol=1e-5)
    assert np.all(pt[:, 1] < 1e-12)
