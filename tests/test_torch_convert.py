"""State carried across from the JAX package: a tree grown by its wave
engine, handed over as numpy arrays, is the same tree in the port; and
model text (multiclass, DART, InfiniteBoost) written by either package
loads in the other and predicts the same."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.convert import (booster_from_model_string,
                                        tree_arrays_from_numpy)
from lightgbm_tpu_torch.ops.learner import materialize_tree
from lightgbm_tpu_torch.ops.predict import (leaf_index_binned,
                                            traversal_from_grow)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def test_tree_arrays_from_numpy_is_the_jax_tree():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(1500, 6))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "min_data_in_leaf": 10, "verbose": -1, "tpu_growth": "wave",
              "tpu_wave_width": 4}
    learner = lgbj.train(params, lgbj.Dataset(X, label=y), 1,
                         verbose_eval=False)._gbdt.learner
    g = (0.5 - y).astype(np.float32)
    h = np.full(len(y), 0.25, np.float32)
    tree_j, leaf_j = learner.train_device(jnp.asarray(g), jnp.asarray(h))
    arrays = {f: np.asarray(getattr(tree_j, f)) for f in tree_j._fields}

    tree_t = tree_arrays_from_numpy(arrays, device="cpu")
    nl = int(arrays["num_leaves"])
    assert nl == 15 and tree_t.split_feature.dtype == torch.int32
    assert tree_t.leaf_value.dtype == torch.float32

    # the port's traversal of the converted tree reproduces the JAX
    # engine's final partition of the training rows
    train = lgbt.Dataset(X, label=y, params=params).construct()._handle
    depth = int(arrays["leaf_depth"][:nl].max())
    leaf_t = leaf_index_binned(traversal_from_grow(tree_t, nl, depth),
                               torch.as_tensor(train.binned))
    np.testing.assert_array_equal(leaf_t.numpy(),
                                  np.asarray(leaf_j)[:len(y)])
    # and materializes to the same model text
    text_t = materialize_tree(tree_t.to_numpy(), train, 15).to_string()
    assert text_t == learner.materialize(tree_j).to_string()


def _models(objective, boosting, seed=4):
    """(port model text, JAX model text, X) of one small run each."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(1200, 6))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2]
    y = (np.digitize(s, [-0.5, 0.5]).astype(float)
         if objective.startswith("multiclass") else (s > 0).astype(float))
    params = {"objective": objective, "boosting": boosting, "num_leaves": 7,
              "max_bin": 63, "min_data_in_leaf": 10, "verbose": -1,
              "tpu_growth": "wave", "tpu_wave_width": 4}
    if objective.startswith("multiclass"):
        params["num_class"] = 3
    if boosting == "dart":
        params.update(drop_rate=0.5, skip_drop=0.0)
    bt = lgbt.train(params, lgbt.Dataset(X, label=y), 4, device="cpu")
    bj = lgbj.train(dict(params, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), 4, verbose_eval=False)
    return bt, bj, X


@pytest.mark.parametrize("objective,boosting", [
    ("multiclass", "gbdt"), ("multiclassova", "gbdt"), ("binary", "dart"),
    ("binary", "infinite"), ("multiclass", "dart")])
def test_model_text_loads_across_packages(objective, boosting):
    """Model text of multiclass, DART and InfiniteBoost runs written by
    either package loads in the other (through
    ``convert.booster_from_model_string`` in the port) and predicts the
    same, raw and converted; saving the loaded model writes its trees
    back to the byte (the port drops header keys it does not use, such
    as the JAX package's drift fingerprint)."""
    bt, bj, X = _models(objective, boosting)
    st, sj = bt.model_to_string(), bj.model_to_string()
    k = 3 if objective.startswith("multiclass") else 1
    for text, writer in ((st, bt), (sj, bj)):
        port = booster_from_model_string(text, device="cpu")
        jax_side = lgbj.Booster(model_str=text)
        assert port.num_model_per_iteration() == k
        assert port.current_iteration() == writer.current_iteration()
        for raw in (False, True):
            want = writer.predict(X, raw_score=raw)
            assert want.shape == ((len(X), k) if k > 1 else (len(X),))
            np.testing.assert_array_equal(port.predict(X, raw_score=raw),
                                          want)
            np.testing.assert_array_equal(
                jax_side.predict(X, raw_score=raw), want)
        for it in (1, 3):
            np.testing.assert_array_equal(port.predict(X, num_iteration=it),
                                          writer.predict(X,
                                                         num_iteration=it))
        def trees(t):
            return t[t.index("Tree=0"):t.index("feature importances")]
        assert trees(port.model_to_string()) == trees(text)
