"""Bulk prediction through the ranked traversal (ops/predict.py) and the
prediction surfaces of Booster.predict, against the JAX package.

The JAX package trains each model on the CPU; the port loads its text
with ``device="cpu"``, so both predict with the same trees.  What must
agree, and how closely:

* ``rank_encode``'s V and D arrays, exactly (zeros, NaN, +-inf and an
  unseen category included);
* leaf indices of the ranked traversal, exactly: the JAX package's
  ``ranked_leaf_indices_device`` and the host ``Tree.predict_leaf_index``;
* raw scores, within rtol 2e-6 and atol 2e-6 of the JAX package's
  ``ranked_predict_device`` and of the host f64 sum (f32 with Kahan
  compensation against f64: the JAX package's own tolerance);
* ``pred_leaf``, ``pred_contrib`` and prediction early stopping (host
  f64 in both packages), to rtol 1e-12.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.predictor import Predictor as JPredictor

import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.models import gbdt as gbdt_mod
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.predictor import Predictor as TPredictor
import torch
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def _binary_data():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(4000, 6))
    X[rng.random(X.shape) < 0.2] = 0.0          # exercise zero redirect
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    Xq = X.copy()
    Xq[rng.random(Xq.shape) < 0.05] = np.nan    # NaN -> right
    Xq[rng.random(Xq.shape) < 0.05] = 0.0
    Xq[:20, 0] = np.inf
    Xq[20:40, 1] = -np.inf
    return X, y, Xq


def _categorical_data():
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 5))
    X[:, 0] = rng.integers(0, 12, size=3000)
    X[:, 1] = rng.integers(0, 5, size=3000)
    eff = rng.normal(size=(12, 3))
    y = np.argmax(eff[X[:, 0].astype(int)] + 0.5 * rng.normal(size=(3000, 3))
                  + np.stack([X[:, 2], X[:, 1] == 2, -X[:, 2]], axis=1),
                  axis=1).astype(np.float64)
    Xq = X.copy()
    Xq[:50, 0] = 99.0                           # unseen category
    Xq[50:60, 1] = np.nan
    Xq[60:70, 0] = -np.inf
    Xq[70:80, 2] = 0.0
    return X, y, Xq


def _train_jax(X, y, params, rounds, cats=()):
    p = dict({"verbose": -1, "num_leaves": 15, "min_data_in_leaf": 5},
             **params)
    return lgbj.train(p, lgbj.Dataset(X, label=y, params=p,
                                      categorical_feature=list(cats)
                                      or "auto"),
                      num_boost_round=rounds)


@pytest.fixture(scope="module")
def binary():
    X, y, Xq = _binary_data()
    bj = _train_jax(X, y, {"objective": "binary"}, 10)
    bt = lgbt.Booster(model_str=bj.model_to_string(), device="cpu")
    return bj, bt, Xq


@pytest.fixture(scope="module")
def categorical():
    X, y, Xq = _categorical_data()
    bj = _train_jax(X, y, {"objective": "multiclass", "num_class": 3}, 5,
                    cats=(0, 1))
    bt = lgbt.Booster(model_str=bj.model_to_string(), device="cpu")
    models = bt._gbdt.models
    assert any((t.decision_type[:t.num_leaves - 1] == 1).any()
               for t in models), "the fixture grew no categorical split"
    return bj, bt, Xq


@pytest.fixture(params=["binary", "categorical"])
def model(request):
    return request.getfixturevalue(request.param)


def _ranked(bj, bt, Xq):
    """(JAX predictor, port predictor) built from the same trees."""
    gj, gt = bj._gbdt, bt._gbdt
    gj._materialize()
    k = gt.num_tree_per_iteration
    rpj = jpredict.build_ranked_predictor(gj.models, k, Xq.shape[1])
    rpt = tpredict.build_ranked_predictor(gt.models, k, Xq.shape[1], "cpu")
    return rpj, rpt, k


def test_rank_encode_equals_the_jax_package(model):
    bj, bt, Xq = model
    rpj, rpt, _ = _ranked(bj, bt, Xq)
    Vj, Dj = jpredict.rank_encode(rpj, Xq)
    Vt, Dt = tpredict.rank_encode(rpt, Xq)
    assert Vt.dtype == np.int32 and Dt.dtype == np.bool_
    np.testing.assert_array_equal(Vt, Vj)
    np.testing.assert_array_equal(Dt, Dj)
    assert rpt.cat_features == rpj.cat_features
    assert rpt.max_feature == rpj.max_feature


def test_leaf_indices_equal_the_jax_package_and_the_host(model):
    bj, bt, Xq = model
    rpj, rpt, _ = _ranked(bj, bt, Xq)
    Vj, Dj = jpredict.rank_encode(rpj, Xq)
    want = np.asarray(jpredict.ranked_leaf_indices_device(
        rpj.dev, jnp.asarray(Vj), jnp.asarray(Dj)))
    V, D = (torch_of(a) for a in tpredict.rank_encode(rpt, Xq))
    got = tpredict.ranked_leaf_indices(rpt.dev, V, D).numpy()
    host = np.stack([t.predict_leaf_index(Xq) for t in bt._gbdt.models],
                    axis=1)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, host)


def test_raw_scores_match_the_jax_package_and_the_host(model):
    bj, bt, Xq = model
    rpj, rpt, k = _ranked(bj, bt, Xq)
    Vj, Dj = jpredict.rank_encode(rpj, Xq)
    want = np.asarray(jpredict.ranked_predict_device(
        rpj.dev, jnp.asarray(Vj), jnp.asarray(Dj), k))
    V, D = (torch_of(a) for a in tpredict.rank_encode(rpt, Xq))
    got = tpredict.ranked_predict(rpt.dev, V, D).numpy()
    host = bt._gbdt.predict_raw(Xq, allow_device=False)
    assert got.dtype == np.float32 and got.shape == (len(Xq), k)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(got, host, rtol=2e-6, atol=2e-6)


def test_tree_blocks_and_rows_change_no_bit(model):
    """The traversal's tree blocks bound its state and change nothing; a
    row scores the same bits alone as in a batch (row independence)."""
    bj, bt, Xq = model
    _, rpt, _ = _ranked(bj, bt, Xq)
    V, D = (torch_of(a) for a in tpredict.rank_encode(rpt, Xq))
    full = tpredict.ranked_predict(rpt.dev, V, D).numpy()
    for block in (1, 3, 7):
        np.testing.assert_array_equal(
            tpredict.ranked_predict(rpt.dev, V, D, block).numpy(), full)
    for lo, n in ((0, 1), (13, 7), (100, 64)):
        np.testing.assert_array_equal(tpredict.ranked_predict(
            rpt.dev, V[lo:lo + n], D[lo:lo + n]).numpy(),
            full[lo:lo + n])


def torch_of(a):
    import torch
    return torch.from_numpy(a)


def test_tree_depth_is_the_deepest_leaf():
    """Tree.depth from the child arrays alone equals the grower's leaf
    depths (a loaded tree has none)."""
    X, y, _ = _binary_data()
    bt = lgbt.train({"objective": "binary", "num_leaves": 31,
                     "min_data_in_leaf": 5, "verbose": -1},
                    lgbt.Dataset(X, label=y), 4, device="cpu")
    bt._gbdt._materialize()
    for tree in bt._gbdt.models:
        assert tree.depth() == int(tree.leaf_depth[:tree.num_leaves].max())
    loaded = lgbt.Booster(model_str=bt.model_to_string(), device="cpu")
    assert ([t.depth() for t in loaded._gbdt.models]
            == [t.depth() for t in bt._gbdt.models])


def _spy(monkeypatch, name):
    calls = {"n": 0}
    real = getattr(tpredict, name)

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    monkeypatch.setattr(tpredict, name, spy)
    return calls


@pytest.mark.parametrize("chunk,extra", [(None, 0), (400, 0), (None, 3),
                                         (700, 2)])
def test_tpu_predict_true_engages_the_device_path(monkeypatch, binary,
                                                   chunk, extra):
    """tpu_predict=true runs Booster.predict through the traversal on the
    booster's device (here the CPU): chunked (the one-deep pipeline) and
    with more input columns than the model uses."""
    bj, bt, Xq = binary
    X = np.concatenate([Xq, np.ones((len(Xq), extra))], axis=1)
    g = bt._gbdt
    g.config.tpu_predict = "false"
    host_raw = bt.predict(X, raw_score=True)
    host = bt.predict(X)
    walks = _spy(monkeypatch, "ranked_predict")
    encodes = _spy(monkeypatch, "rank_encode")
    if chunk is not None:
        monkeypatch.setattr(gbdt_mod.GBDT, "_predict_chunk_rows",
                            staticmethod(lambda nf, tb: chunk))
    g.config.tpu_predict = "true"
    g._ranked_pred_key = None
    try:
        raw = bt.predict(X, raw_score=True)
        conv = bt.predict(X)
    finally:
        g.config.tpu_predict = "auto"
    chunks = -(-len(X) // (chunk or len(X)))
    assert walks["n"] == encodes["n"] == 2 * chunks
    np.testing.assert_allclose(raw, host_raw, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(conv, host, rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(raw, bj.predict(X, raw_score=True),
                               rtol=2e-6, atol=2e-6)


def test_auto_stays_on_the_host_off_the_card(monkeypatch, binary):
    """tpu_predict=auto runs the traversal only on the card from 100,000
    rows; a CPU booster predicts on the host, bit-equal to the f64 sum."""
    _, bt, Xq = binary
    walks = _spy(monkeypatch, "ranked_predict")
    monkeypatch.setattr(gbdt_mod.GBDT, "_DEVICE_PREDICT_MIN_ROWS", 10)
    got = bt.predict(Xq, raw_score=True)
    assert walks["n"] == 0
    np.testing.assert_array_equal(
        got, bt._gbdt.predict_raw(Xq, allow_device=False)[:, 0])


def test_pred_leaf_and_contrib_equal_the_jax_package(model):
    bj, bt, Xq = model
    np.testing.assert_array_equal(bt.predict(Xq, pred_leaf=True),
                                  bj.predict(Xq, pred_leaf=True))
    got = bt.predict(Xq, pred_contrib=True)
    np.testing.assert_allclose(got, bj.predict(Xq, pred_contrib=True),
                               rtol=1e-12, atol=0)
    raw = bt.predict(Xq, raw_score=True)
    np.testing.assert_allclose(got.sum(axis=-1), raw, rtol=1e-10,
                               atol=1e-10)
    per_tree = bt._gbdt.pred_contrib(Xq, per="tree")
    np.testing.assert_allclose(per_tree,
                               bj._gbdt.pred_contrib(Xq, per="tree"),
                               rtol=1e-12, atol=0)
    k = bt._gbdt.num_tree_per_iteration
    np.testing.assert_allclose(
        per_tree.reshape(len(Xq), -1, k).sum(axis=1).reshape(raw.shape),
        raw, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("freq,margin", [(2, 1.0), (1, 0.5), (10, 10.0)])
def test_pred_early_stop_equals_the_jax_package(model, freq, margin):
    bj, bt, Xq = model
    kw = {"pred_early_stop": True, "pred_early_stop_freq": freq,
          "pred_early_stop_margin": margin}
    got = bt.predict(Xq, **kw)
    np.testing.assert_allclose(got, bj.predict(Xq, **kw), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(
        TPredictor(bt._gbdt, raw_score=True, early_stop=True,
                   early_stop_freq=freq,
                   early_stop_margin=margin).predict(Xq),
        JPredictor(bj._gbdt, raw_score=True, early_stop=True,
                   early_stop_freq=freq,
                   early_stop_margin=margin).predict(Xq),
        rtol=1e-12, atol=0)


def _mixed(bt):
    """A copy of the categorical model whose first numerical node splits
    on a categorical feature: that feature is then used both ways."""
    mixed = lgbt.Booster(model_str=bt.model_to_string(), device="cpu")
    models = mixed._gbdt.models
    cat = next(int(t.split_feature[i]) for t in models
               for i in range(t.num_leaves - 1) if t.decision_type[i] == 1)
    tree, node = next((t, i) for t in models
                      for i in range(t.num_leaves - 1)
                      if t.decision_type[i] == 0)
    tree.split_feature[node] = cat
    return mixed


def test_mixed_feature_use_takes_the_host_path(categorical, capsys):
    _, bt, Xq = categorical
    mixed = _mixed(bt)
    g = mixed._gbdt
    with pytest.raises(ValueError, match="used both ways"):
        tpredict.build_ranked_predictor(g.models, 3, Xq.shape[1], "cpu")
    g.config.tpu_predict = "true"
    got = mixed.predict(Xq, raw_score=True)
    assert "device bulk predict unavailable" in capsys.readouterr().err
    np.testing.assert_array_equal(got, g.predict_raw(Xq, allow_device=False))


def test_loaded_booster_resolves_its_device():
    """A Booster from model text runs on the card unless asked for the
    CPU; without a card that is an error, as for every entry point."""
    import torch
    X, y, _ = _binary_data()
    text = lgbt.train({"objective": "binary", "verbose": -1},
                      lgbt.Dataset(X[:500], label=y[:500]), 2,
                      device="cpu").model_to_string()
    assert lgbt.Booster(model_str=text, device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert lgbt.Booster(model_str=text).device.type == "cuda"
    else:
        with pytest.raises(lgbt.LightGBMError, match="needs CUDA"):
            lgbt.Booster(model_str=text)
