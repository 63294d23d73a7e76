"""The port's batched best-split search against the JAX package's
vmapped one (ops/split_finder.py best_splits_vmapped) on random
histograms: integer slots (feature, threshold, default bin for zero,
counts, is_cat, runner-up feature) exactly equal, float slots within
rtol 1e-5 (both are f32; the port's cumsums and the XLA ones may
associate differently)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.ops import grow as jgrow
from lightgbm_tpu.ops import learner as jlearner
from lightgbm_tpu.ops import split_finder as jsf
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch.io.dataset import TrainingData as TTrainingData
from lightgbm_tpu_torch.ops import grow as tgrow
from lightgbm_tpu_torch.ops import learner as tlearner
from lightgbm_tpu_torch.ops import split_finder as tsf
from lightgbm_tpu_torch.utils.config import Config as TConfig
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

INT_SLOTS = [tsf.FEATURE, tsf.THRESHOLD, tsf.DEFAULT_BIN_FOR_ZERO,
             tsf.LEFT_COUNT, tsf.RIGHT_COUNT, tsf.IS_CAT,
             tsf.SECOND_FEATURE]
FLOAT_SLOTS = [i for i in range(tsf.SPLIT_VEC_SIZE) if i not in INT_SLOTS]


def _hists(k, f, b, seed, num_bin, n=600):
    """Per-leaf (F, B, 3) histograms of random rows, with their sums."""
    rng = np.random.default_rng(seed)
    hist = np.zeros((k, f, b, 3), np.float32)
    sums = np.zeros((k, 3), np.float32)
    for leaf in range(k):
        m = int(rng.integers(n // 4, n))
        g = rng.normal(size=m).astype(np.float32)
        h = rng.uniform(0.05, 0.25, size=m).astype(np.float32)
        for j in range(f):
            bins = rng.integers(0, num_bin[j], size=m)
            # a heavy default bin, as real data has
            bins[rng.random(m) < 0.3] = 0
            np.add.at(hist[leaf, j, :, 0], bins, g)
            np.add.at(hist[leaf, j, :, 1], bins, h)
            np.add.at(hist[leaf, j, :, 2], bins, 1.0)
        sums[leaf] = [g.sum(), h.sum(), m]
    return hist, sums


@pytest.mark.parametrize("use_missing,l1,l2,min_gain,max_depth,mask", [
    (True, 0.0, 0.0, 0.0, -1, False),
    (False, 0.5, 1.0, 0.01, 3, True),
    (True, 0.0, 2.0, 0.0, 2, True),
])
def test_batched_best_split_matches_vmapped(use_missing, l1, l2, min_gain,
                                            max_depth, mask):
    k, f, b = 9, 6, 12
    num_bin = np.array([12, 12, 5, 9, 12, 3], np.int32)
    default_bin = np.array([0, 3, 0, 8, 0, 1], np.int32)
    is_cat = np.array([False, False, False, False, True, False])
    hist, sums = _hists(k, f, b, seed=int(l2 * 10 + max_depth + 7),
                        num_bin=num_bin)
    depths = np.arange(k, dtype=np.int32) % 4
    fmask = np.ones(f, bool)
    if mask:
        fmask[[1, 4]] = False
    args = dict(lambda_l1=l1, lambda_l2=l2, min_gain_to_split=min_gain,
                min_data_in_leaf=5.0, min_sum_hessian_in_leaf=1e-3,
                use_missing=use_missing)
    jmeta = jsf.FeatureMeta(jnp.asarray(num_bin), jnp.asarray(default_bin),
                            jnp.asarray(is_cat))
    want = np.asarray(jsf.best_splits_vmapped(
        jnp.asarray(hist), jnp.asarray(sums), jnp.asarray(depths), jmeta,
        jnp.asarray(fmask), jsf.SplitParams(**args), max_depth))
    tmeta = tsf.FeatureMeta(torch.from_numpy(num_bin),
                            torch.from_numpy(default_bin),
                            torch.from_numpy(is_cat))
    got = tsf.best_splits_batched(
        torch.from_numpy(hist), torch.from_numpy(sums),
        torch.from_numpy(depths), tmeta, torch.from_numpy(fmask),
        tsf.SplitParams(**args), max_depth).numpy()
    assert got.shape == want.shape == (k, tsf.SPLIT_VEC_SIZE)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[:, INT_SLOTS], want[:, INT_SLOTS])
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin[:, 0]][:, FLOAT_SLOTS],
                               want[fin[:, 0]][:, FLOAT_SLOTS],
                               rtol=1e-5, atol=1e-6)
    assert fin[:, 0].sum() >= 3           # enough leaves really split


def test_argmax_prefer_last_keeps_the_last_tie():
    x = np.array([[1.0, 3.0, 3.0, 2.0], [-np.inf] * 4, [5.0, 1.0, 5.0, 5.0]],
                 np.float32)
    got = tsf._argmax_prefer_last(torch.from_numpy(x)).numpy()
    want = np.asarray(jsf._argmax_prefer_last(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [2, 3, 3])


def test_bundled_feature_view_matches():
    """EFB group histograms -> per-feature views (default bin rebuilt by
    subtraction) agree with the JAX package's feature_hist_view."""
    rng = np.random.default_rng(7)
    n = 1500
    X = rng.normal(size=(n, 8))
    owner = rng.integers(0, 6, size=n)
    for j in range(4):
        X[:, 4 + j] = np.where(owner == j, rng.normal(size=n) + 2.0, 0.0)
    params = {"verbose": -1, "min_data_in_leaf": 5}
    jtd = JTrainingData.from_matrix(X, label=np.zeros(n),
                                    config=JConfig(params))
    ttd = TTrainingData.from_matrix(X, label=np.zeros(n),
                                    config=TConfig(params))
    assert jtd.bundle is not None and ttd.bundle is not None
    jb, jbins = jlearner.build_bundle_arrays(jtd)
    tb, tbins = tlearner.build_bundle_arrays(ttd, "cpu")
    assert jbins == tbins
    G = len(ttd.bundle.num_group_bins)
    ghist = rng.normal(size=(3, G, tbins, 3)).astype(np.float32)
    sums = rng.normal(size=(3, 3)).astype(np.float32)
    jmeta = jsf.FeatureMeta(jnp.asarray(jtd.num_bin_arr),
                            jnp.asarray(jtd.default_bin_arr),
                            jnp.asarray(jtd.is_categorical_arr))
    tmeta = tsf.FeatureMeta(torch.from_numpy(ttd.num_bin_arr),
                            torch.from_numpy(ttd.default_bin_arr),
                            torch.from_numpy(ttd.is_categorical_arr))
    got = tgrow.feature_hist_view(torch.from_numpy(ghist),
                                  torch.from_numpy(sums), tmeta, tb).numpy()
    for i in range(3):
        want = np.asarray(jgrow.feature_hist_view(
            jnp.asarray(ghist[i]), jnp.asarray(sums[i]), jmeta, jb, True))
        # gathered slots are copies; the default-bin slot is a sum over
        # the feature's bins (up to tbins terms of |x| <~ 4) taken in
        # another order, hence the f32 rounding allowance
        np.testing.assert_allclose(got[i], want, rtol=1e-6,
                                   atol=tbins * 4 * 2 ** -23)
