"""Custom objectives (``fobj``) and evaluation (``feval``) in the port.

* a ``fobj`` that returns the port's own built-in gradients (binary
  logloss, and softmax over 3 classes) trains the built-in objective's
  staged trees: every ``Tree=`` section equal to the byte (the built-in
  run with ``boost_from_average=false``: a booster without an objective
  takes no stub); fobj gets the raw training scores, K * N class-major;
* ``Booster.update(fobj=)`` and ``train(fobj=)`` agree;
* ``feval`` gives the JAX package's values on the same params (oracle
  flags; its values are taken at the raw scores, which agree to the
  oracle's bf16 hi/lo rounding: rtol 1e-4), gets the raw scores (the
  values equal the feval of the booster's own raw predictions, to f32
  rounding), and may return a list.
"""
import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.objectives import create_objective
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
BASE = {"num_leaves": 7, "max_bin": 31, "min_data_in_leaf": 10,
        "verbose": -1, "learning_rate": 0.3, "boost_from_average": False}


def _data(seed=0, n=800, classes=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    s = X[:, 0] + 0.6 * X[:, 1] * X[:, 2] + 0.2 * rng.normal(size=n)
    if classes == 2:
        return X, (s > 0).astype(float)
    return X, np.digitize(s, np.quantile(s, [1 / 3, 2 / 3])).astype(float)


def _builtin_fobj(name, params, seen):
    """fobj returning the port's built-in gradients as numpy."""
    state = {}

    def fobj(preds, train_data):
        if "obj" not in state:
            md = train_data._handle.metadata
            obj = create_objective(name, Config(params))
            obj.init(md, train_data.num_data(), CPU)
            state["obj"] = obj
        seen.append(preds.copy())
        g, h = state["obj"].get_gradients(
            torch.from_numpy(preds.astype(np.float32)))
        return g.numpy(), h.numpy()
    return fobj


def _trees(text):
    return [blk for blk in text.split("Tree=")[1:]]


def test_fobj_of_builtin_gradients_trains_the_builtin_trees():
    X, y = _data(1)
    params = dict(BASE, objective="binary")
    want = lgbt.train(dict(params, tpu_fused_iter="off"),
                      lgbt.Dataset(X, label=y), 4, device="cpu")
    seen = []
    got = lgbt.train(params, lgbt.Dataset(X, label=y), 4,
                     fobj=_builtin_fobj("binary", params, seen),
                     device="cpu")
    tw, tg = want.model_to_string(), got.model_to_string()
    assert "objective=" not in tg.split("Tree=")[0]
    assert got.num_trees() == want.num_trees() == 4
    assert _trees(tg) == _trees(tw)
    # fobj saw the raw training scores
    assert len(seen) == 4 and seen[0].shape == y.shape
    assert not seen[0].any()
    np.testing.assert_array_equal(got._gbdt.train_score,
                                  want._gbdt.train_score)
    # Booster.update(fobj=) trains the same
    bst = lgbt.Booster(dict(params, objective="none"),
                       lgbt.Dataset(X, label=y), device="cpu")
    fobj = _builtin_fobj("binary", params, [])
    for _ in range(4):
        bst.update(fobj=fobj)
    assert _trees(bst.model_to_string()) == _trees(tw)


def test_multiclass_fobj_is_class_major():
    """A multiclass booster updated with a fobj of the softmax gradients
    (K * N values, class k's rows at [k N, (k + 1) N)) trains the
    built-in softmax trees; the JAX package's Booster.update(fobj=) takes
    the same layout and grows the same partitions."""
    X, y = _data(5, classes=3)
    params = dict(BASE, objective="multiclass", num_class=3,
                  tpu_growth="wave", tpu_wave_width=4,
                  tpu_histogram_mode="pallas_ct")
    want = lgbt.train(dict(params, tpu_fused_iter="off"),
                      lgbt.Dataset(X, label=y), 3, device="cpu")
    seen = []
    fobj = _builtin_fobj("multiclass", params, seen)
    bst = lgbt.Booster(params, lgbt.Dataset(X, label=y), device="cpu")
    bj = lgbj.Booster(dict(params, tpu_pallas_interpret=True,
                           tpu_hist_precision="hilo"),
                      lgbj.Dataset(X, label=y))
    jseen = []
    fobj_j = _builtin_fobj("multiclass", params, jseen)
    for _ in range(3):
        bst.update(fobj=fobj)
        bj.update(fobj=fobj_j)
    assert seen[0].shape == jseen[0].shape == (3 * len(y),)
    # class k's raw scores at [k N, (k + 1) N)
    preds = bst._inner_predict(0)
    raw = bst.predict(X, raw_score=True)
    for k in range(3):
        np.testing.assert_allclose(preds[k * len(y):(k + 1) * len(y)],
                                   raw[:, k], rtol=1e-5, atol=1e-6)
    text = bst.model_to_string()
    assert bst.num_trees() == want.num_trees() == 9
    assert _trees(text) == _trees(want.model_to_string())
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    assert ([ln for ln in text.splitlines() if ln.startswith(keys)]
            == [ln for ln in bj.model_to_string().splitlines()
                if ln.startswith(keys)])


def test_fobj_with_a_builtin_objective_and_length_check():
    X, y = _data(2)
    bst = lgbt.Booster(dict(BASE, objective="binary"),
                       lgbt.Dataset(X, label=y), device="cpu")
    with pytest.raises(ValueError, match="don't match"):
        bst.update(fobj=lambda p, d: (p, p[:-1]))


def _error(preds, data):
    return "error", float(((preds > 0) != (data.get_label() > 0)).mean()), \
        False


def _two(preds, data):
    lab = data.get_label()
    return [("mse_raw", float(np.mean((preds - lab) ** 2)), False),
            ("mean_raw", float(np.mean(preds)), True)]


def test_feval_matches_jax():
    X, y = _data(3)
    Xv, yv = _data(4, n=300)
    params = dict(BASE, objective="binary", metric="binary_logloss",
                  tpu_growth="wave", tpu_wave_width=4,
                  tpu_histogram_mode="pallas_ct", tpu_pallas_interpret=True,
                  tpu_hist_precision="hilo")
    for feval in (_error, _two):
        et, ej = {}, {}
        bt = lgbt.train(params, lgbt.Dataset(X, label=y), 3,
                        valid_sets=[lgbt.Dataset(Xv, label=yv)],
                        feval=feval, evals_result=et, verbose_eval=False,
                        device="cpu")
        lgbj.train(params, lgbj.Dataset(X, label=y), 3,
                   valid_sets=[lgbj.Dataset(Xv, label=yv)], feval=feval,
                   evals_result=ej, verbose_eval=False)
        assert list(et["valid_0"]) == list(ej["valid_0"])
        for name in et["valid_0"]:
            np.testing.assert_allclose(et["valid_0"][name],
                                       ej["valid_0"][name], rtol=1e-4,
                                       atol=1e-7)
        # feval got the raw scores of the valid rows
        out = bt.eval_valid(feval)
        ret = feval(bt.predict(Xv, raw_score=True),
                    bt._valid_sets[0])
        ret = ret if isinstance(ret, list) else [ret]
        for (_, name, value, hb), (fname, fvalue, fhb) in zip(out[1:], ret):
            assert (name, hb) == (fname, fhb)
            np.testing.assert_allclose(value, fvalue, rtol=1e-6)
