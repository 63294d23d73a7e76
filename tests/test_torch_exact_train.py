"""Exact (leaf-wise) growth: the port trains the JAX package's trees with
``tpu_histogram_mode=pallas``, through kernel B5's plain version on the
CPU.

The JAX side runs the same params on the CPU, where its exact grower takes
the Pallas leaf-histogram kernel in interpret mode.  Both are f32 with
f32 products, so tree structure must agree exactly (split features,
threshold values, child pointers, leaf counts, decision types) and leaf
values and predictions to rtol 1e-5.  The two packages add a histogram
cell's rows in different orders, and a leaf output -G/H errs relative to
the leaf's sum of |g| rather than to G: a leaf with balanced gradients
(G near 0) moves most (up to 7e-5 relative on these fixtures), so leaf
values also get an atol of 1e-5 x the largest leaf value (the largest
difference seen is 4e-6 of it), and predictions near 0 one of 1e-6 x the
largest prediction.  The fixtures are pinned, as in
tests/test_torch_train_parity.py: where two thresholds tie up to rounding
(an empty bin beside the split) the two packages' summation orders may
pick either.

Inside the port, exact growth and wave growth at width 1 take the same
splits in the same order from bit-identical histograms, so their models
are equal byte for byte (the JAX package pins the same property in
tests/test_wave_exact_order.py).
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

# (objective, EFB bundles, pinned seed, more params); growth 'auto' with
# 'pallas' resolves to exact, as in the JAX package
CASES = [
    ("binary", False, 2, {"tpu_histogram_mode": "pallas"}),
    ("regression", False, 0, {}),
    ("binary", False, 2, NO_CACHE),
    ("regression", False, 1, {"max_depth": 3}),
    ("binary", False, 1, SAMPLED),
    ("regression", True, 1, {}),
    ("regression", True, 1, dict(NO_CACHE, **SAMPLED)),
]


@pytest.mark.parametrize("objective,bundled,seed,more", CASES)
def test_exact_growth_trains_the_jax_package_trees(objective, bundled, seed,
                                                   more):
    X, s = _data(seed, 2500, bundled)
    y = _labels(objective, s)
    params = _params(objective, dict({"tpu_growth": "exact",
                                      "tpu_histogram_mode": "pallas"},
                                     **more))
    if "tpu_growth" not in more and "tpu_histogram_mode" in more:
        del params["tpu_growth"]
    bj = lgbj.train(params, lgbj.Dataset(X, label=y), 5)
    dt = lgbt.Dataset(X, label=y, params=params).construct()
    assert (dt._handle.bundle is not None) == bundled
    bt = lgbt.train(params, dt, 5, device="cpu")
    learner = bt._gbdt.learner
    assert (learner.growth, learner.hist_mode) == ("exact", "pallas")
    assert bj._gbdt.learner.growth == "exact"
    assert bj._gbdt.learner.hist_mode == "pallas"
    assert learner.cache_hists == ("histogram_pool_size" not in more)
    assert learner.X.shape == (len(X), learner.X.shape[1])   # row-major
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert bt.num_trees() == bj.num_trees() >= 5
    assert _structure(st) == _structure(sj)
    lt, lj = _leaf_values(st), _leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=1e-5,
                               atol=1e-5 * np.abs(lj).max())
    pt, pj = bt.predict(X), bj.predict(X)
    np.testing.assert_allclose(pt, pj, rtol=1e-5,
                               atol=1e-6 * np.abs(pj).max())
    for stats in bt.grow_stats():
        assert stats.passes == stats.num_leaves - 1       # one pass a split
        assert stats.host_reads <= stats.num_leaves // 2


@pytest.mark.parametrize("wave_mode", ["pallas", "pallas_ct"])
@pytest.mark.parametrize("objective,bundled,more", [
    ("binary", False, dict(SAMPLED, max_depth=4)),
    ("regression", True, NO_CACHE),
])
def test_exact_growth_equals_wave_width_1(objective, bundled, more,
                                          wave_mode):
    X, s = _data(7, 2500, bundled)
    y = _labels(objective, s)
    params = _params(objective, more)
    exact = lgbt.train(dict(params, tpu_growth="exact"),
                       lgbt.Dataset(X, label=y), 5, device="cpu")
    wave = lgbt.train(dict(params, tpu_growth="wave", tpu_wave_width=1,
                           tpu_histogram_mode=wave_mode),
                      lgbt.Dataset(X, label=y), 5, device="cpu")
    assert exact._gbdt.learner.hist_mode == "pallas"
    assert exact.model_to_string() == wave.model_to_string()
    assert ([s.num_leaves for s in exact.grow_stats()]
            == [s.num_leaves for s in wave.grow_stats()])


def test_exact_growth_stops_early_without_extra_passes():
    """A tree that runs out of positive gains before num_leaves stops at
    once: one pass a committed split, one host read a batch of splits and
    one at the end."""
    X, s = _data(1, 600, False)
    params = _params("regression", {"tpu_growth": "exact",
                                    "num_leaves": 63,
                                    "min_data_in_leaf": 40})
    bt = lgbt.train(params, lgbt.Dataset(X, label=s), 3, device="cpu")
    stats = bt.grow_stats()
    assert all(st.num_leaves < 63 for st in stats)
    for st in stats:
        assert st.passes == st.num_leaves - 1
        assert 2 <= st.host_reads <= st.num_leaves
    bj = lgbj.train(dict(params, tpu_histogram_mode="pallas"),
                    lgbj.Dataset(X, label=s), 3)
    assert _structure(bt.model_to_string()) == _structure(
        bj.model_to_string())
