"""Wave growth with ``tpu_histogram_mode=pallas``: the port keeps the bins
row-major and takes every histogram from kernel B4's plain version (and
the partition as plain tensor ops on the split columns); it trains the
JAX package's trees.

The JAX side runs the same params with ``tpu_pallas_interpret=true`` (its
row-major Pallas wave kernel in interpret mode, bf16 hi/lo weights), and
with ``tpu_histogram_mode=onehot`` (f32 XLA histograms).  Tree structure
must equal both exactly; leaf values and predictions agree with the f32
run to rtol 1e-5, with the atol that tests/test_torch_exact_train.py
gives for leaves with balanced gradients (1e-5 of the largest leaf, 1e-6
of the largest prediction), and with the hi/lo run to 1e-3 of the
largest leaf (16 significant bits a weight;
tests/test_torch_train_parity.py says more).  The fixtures are pinned for
the reason given there.
"""
import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from torch_cases import (NO_CACHE, SAMPLED, labels as _labels,
                         leaf_values as _leaf_values, parity_data as _data,
                         parity_params as _params, structure as _structure)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

# (objective, EFB bundles, pinned seed, more params)
CASES = [("binary", False, 2, {}), ("binary", False, 2, NO_CACHE),
         ("binary", False, 1, SAMPLED), ("regression", False, 0, {}),
         ("regression", True, 1, {})]


@pytest.mark.parametrize("objective,bundled,seed,more", CASES)
def test_rowmajor_wave_trains_the_jax_package_trees(objective, bundled, seed,
                                                    more):
    X, s = _data(seed, 2500, bundled)
    y = _labels(objective, s)
    params = _params(objective, dict({"tpu_growth": "wave",
                                      "tpu_wave_width": 4,
                                      "tpu_histogram_mode": "pallas"},
                                     **more))
    bj = lgbj.train(dict(params, tpu_pallas_interpret=True),
                    lgbj.Dataset(X, label=y), 5)
    bf = lgbj.train(dict(params, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), 5)
    dt = lgbt.Dataset(X, label=y, params=params).construct()
    assert (dt._handle.bundle is not None) == bundled
    bt = lgbt.train(params, dt, 5, device="cpu")
    learner = bt._gbdt.learner
    assert (learner.growth, learner.hist_mode) == ("wave", "pallas")
    assert learner.cache_hists == ("histogram_pool_size" not in more)
    assert learner.X.shape == (len(X), learner.X.shape[1])   # row-major
    sj, sf, st = (bj.model_to_string(), bf.model_to_string(),
                  bt.model_to_string())
    assert bt.num_trees() == bj.num_trees() >= 5
    assert _structure(st) == _structure(sj) == _structure(sf)
    lt, lf, lj = _leaf_values(st), _leaf_values(sf), _leaf_values(sj)
    np.testing.assert_allclose(lt, lf, rtol=1e-5,
                               atol=1e-5 * np.abs(lf).max())
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())
    pt, pf = bt.predict(X), bf.predict(X)
    np.testing.assert_allclose(pt, pf, rtol=1e-5,
                               atol=1e-6 * np.abs(pf).max())
