"""The port trains the trees the JAX package trains.

The JAX side runs the main path's kernels in interpret mode, as on the
TPU: ``tpu_growth=wave, tpu_histogram_mode=pallas_ct,
tpu_pallas_interpret=true, tpu_hist_precision=hilo`` (the oracle).  The
port trains on ``device="cpu"`` with the same params, through its kernels'
plain versions.

What must agree, and how closely:

* tree structure, exactly: split features, threshold bins (as values),
  child pointers, leaf counts, decision types;
* the valid-set AUC, to 1e-6;
* leaf values and predictions, to rtol 1e-5, against the same wave grower
  run with f32 XLA histograms (``tpu_histogram_mode=onehot``), which must
  grow the same trees.  Against the oracle itself they agree only as far
  as its bf16 hi/lo split of the weights allows: 16 significant bits a
  weight, so a leaf output -G/H errs relative to the leaf's sum of |g|
  rather than to G, and leaves with balanced labels (G near 0) move most.
  There the bound is 1e-3 relative to the largest leaf value and 1e-4
  on predictions;
* a model saved by either package loads in the other and predicts the
  same.

The fixtures are pinned (as tests/test_parallel.py pins ``wide_data``):
near-tie splits can flip under f32 reordering and under the oracle's
rounding, and on these seeds every configuration below grows the same
trees in all three runs.
"""
import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.convert import booster_from_model_string
import torch
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

STRUCTURE = ("split_feature", "threshold=", "left_child", "right_child",
             "leaf_count", "decision_type")


def _data(seed, n, bundled):
    """Normal features; with ``bundled`` the last four columns are mostly
    zero and mutually exclusive, so EFB packs them into one group column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    if bundled:
        owner = rng.integers(0, 8, size=n)
        for j in range(4):
            X[:, 6 + j] = np.where(owner == j, rng.normal(size=n) + 2.0, 0.0)
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=n))
    return X, s


def _structure(model):
    return [ln for ln in model.splitlines() if ln.startswith(STRUCTURE)]


def _leaf_values(model):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in model.splitlines()
                           if ln.startswith("leaf_value")])


SAMPLED = {"bagging_fraction": 0.8, "bagging_freq": 1,
           "feature_fraction": 0.8}
# (objective, wave width, EFB bundles, pinned seed, more params)
CASES = [("binary", 4, False, 15, {}), ("binary", 14, False, 15, {}),
         ("regression", 4, False, 15, {}), ("regression", 14, False, 15, {}),
         ("regression", 4, True, 6, {}), ("regression", 4, False, 10, SAMPLED)]


@pytest.mark.parametrize("objective,width,bundled,seed,more", CASES)
def test_port_trains_the_oracle_trees(objective, width, bundled, seed, more):
    X, s = _data(seed, 2500, bundled)
    Xv, sv = _data(seed + 1000, 600, bundled)
    binary = objective == "binary"
    y, yv = ((s > 0).astype(float), (sv > 0).astype(float)) if binary \
        else (s, sv)
    base = {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "metric": "auc" if binary else "l2",
            "tpu_growth": "wave", "tpu_wave_width": width, **more}
    oracle = dict(base, tpu_histogram_mode="pallas_ct",
                  tpu_pallas_interpret=True, tpu_hist_precision="hilo")
    ej, et = {}, {}
    bj = lgbj.train(oracle, lgbj.Dataset(X, label=y), 3,
                    valid_sets=[lgbj.Dataset(Xv, label=yv)],
                    evals_result=ej, verbose_eval=False)
    bf = lgbj.train(dict(base, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), 3, verbose_eval=False)
    dt = lgbt.Dataset(X, label=y, params=oracle).construct()
    assert (dt._handle.bundle is not None) == bundled
    bt = lgbt.train(oracle, dt, 3, valid_sets=[lgbt.Dataset(Xv, label=yv)],
                    evals_result=et, device="cpu")
    sj, sf, st = (bj.model_to_string(), bf.model_to_string(),
                  bt.model_to_string())
    assert bt.num_trees() == bj.num_trees() >= 3
    assert _structure(st) == _structure(sj)
    assert _structure(st) == _structure(sf)

    metric = "auc" if binary else "l2"
    assert len(et["valid_0"][metric]) == 3
    if binary:
        assert abs(et["valid_0"][metric][-1]
                   - ej["valid_0"][metric][-1]) <= 1e-6

    lt, lf, lj = _leaf_values(st), _leaf_values(sf), _leaf_values(sj)
    np.testing.assert_allclose(lt, lf, rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())
    pt = bt.predict(Xv)
    np.testing.assert_allclose(pt, bf.predict(Xv), rtol=1e-5)
    np.testing.assert_allclose(pt, bj.predict(Xv), rtol=1e-4)

    # the text model is the interchange: each package loads the other's
    from_jax = booster_from_model_string(sj, device="cpu")
    np.testing.assert_array_equal(from_jax.predict(Xv), bj.predict(Xv))
    from_port = lgbj.Booster(model_str=st)
    np.testing.assert_array_equal(from_port.predict(Xv), pt)


@pytest.mark.parametrize("variant", [{"tpu_histogram_mode": "pallas_t"},
                                     {"histogram_pool_size": 0.01}])
def test_histogram_only_and_no_cache_paths_grow_the_same_trees(variant):
    """The partition as plain tensor ops with the histogram-only kernel
    (pallas_t), and recomputing both children when the histogram cache
    does not fit histogram_pool_size, grow the default path's trees."""
    X, s = _data(15, 2500, False)
    y = (s > 0).astype(float)
    base = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": 4}
    ref = lgbt.train(base, lgbt.Dataset(X, label=y), 3, device="cpu")
    got = lgbt.train(dict(base, **variant), lgbt.Dataset(X, label=y), 3,
                     device="cpu")
    learner = got._gbdt.learner
    if "histogram_pool_size" in variant:
        assert not learner.cache_hists
    else:
        assert learner.hist_mode == "pallas_t"
    assert _structure(got.model_to_string()) == _structure(
        ref.model_to_string())
    np.testing.assert_allclose(got.predict(X), ref.predict(X), rtol=1e-5)


def _categorical_data(seed, n):
    """Two categorical columns (12 and 5 categories, integer codes) with
    their own effects, beside four normal features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[:, 0] = rng.integers(0, 12, size=n)
    X[:, 1] = rng.integers(0, 5, size=n)
    effect = rng.normal(size=12)
    s = (effect[X[:, 0].astype(int)] + 0.8 * (X[:, 1] == 2) + X[:, 2]
         + 0.1 * rng.normal(size=n))
    return X, (s > 0).astype(float)


def test_port_trains_the_oracle_trees_on_categorical_columns():
    """A pinned fixture with two categorical columns: the port grows the
    oracle's trees as partitions of the training rows, with the same
    split features and decision types, and its leaves to the tolerances
    above; the model routes through the ranked predictor's categorical
    branch (V == threshold) as the host trees route.  Leaf values agree
    with the f32 onehot run to 1e-4 relative: on this data the numeric
    columns alone already differ by up to 6.3e-5 relative in the later
    trees' leaves (ROADMAP C, leaves with balanced gradients; another
    summation order), and the categorical ones by 3.6e-5."""
    import torch

    from lightgbm_tpu_torch.ops import predict as tpredict

    X, y = _categorical_data(1, 2500)
    Xv, yv = _categorical_data(1001, 600)
    Xv[:40, 0] = 99.0                        # a category never seen
    base = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": 4}
    oracle = dict(base, tpu_histogram_mode="pallas_ct",
                  tpu_pallas_interpret=True, tpu_hist_precision="hilo")
    cats = [0, 1]
    bj = lgbj.train(oracle, lgbj.Dataset(X, label=y, categorical_feature=cats),
                    3, verbose_eval=False)
    bf = lgbj.train(dict(base, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y, categorical_feature=cats), 3,
                    verbose_eval=False)
    bt = lgbt.train(oracle, lgbt.Dataset(X, label=y, categorical_feature=cats),
                    3, device="cpu")
    bt._gbdt._materialize()
    models = bt._gbdt.models
    assert sum(int((t.decision_type[:t.num_leaves - 1] == 1).sum())
               for t in models) >= 10
    shape = ("split_feature", "decision_type", "left_child", "right_child")

    def trees(b):
        return [ln for ln in b.model_to_string().splitlines()
                if ln.startswith(shape)]

    def partitions(b):
        return np.stack([t.predict_leaf_index(X) for t in b._gbdt.models],
                        axis=1)

    assert trees(bt) == trees(bj) == trees(bf)
    np.testing.assert_array_equal(partitions(bt), partitions(bj))
    np.testing.assert_array_equal(partitions(bt), partitions(bf))
    lt, lf, lj = (_leaf_values(b.model_to_string()) for b in (bt, bf, bj))
    np.testing.assert_allclose(lt, lf, rtol=1e-4)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())
    np.testing.assert_allclose(bt.predict(Xv), bf.predict(Xv), rtol=1e-4)

    rp = tpredict.build_ranked_predictor(models, 1, Xv.shape[1], "cpu")
    assert rp.cat_features == frozenset(cats)
    V, D = tpredict.rank_encode(rp, Xv)
    leaves = tpredict.ranked_leaf_indices(rp.dev, torch.from_numpy(V),
                                          torch.from_numpy(D)).numpy()
    np.testing.assert_array_equal(
        leaves, np.stack([t.predict_leaf_index(Xv) for t in models], axis=1))
