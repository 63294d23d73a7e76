"""The port's fused boosting iteration (lightgbm_tpu_torch/ops/fused_iter.py)
on the CPU, mirroring tests/test_fused_iter.py.

* Bit-identity: ``tpu_fused_iter=on`` trains the model text of ``off`` to
  the byte, with equal predictions, on every dense dataflow (pallas_ct,
  pallas_t, row-major pallas under wave growth), with and without the
  histogram cache, on EFB group columns, on the entry-chunk sparse
  store, with bagging and feature_fraction, binary and regression.  Both
  chains run the same wave body; the fused one runs M masked waves
  unread, reads once, then single waves.
* Against the JAX package: the port's fused run grows the trees of the
  JAX package's fused run (``tpu_growth=wave,
  tpu_histogram_mode=pallas_ct, tpu_pallas_interpret=true,
  tpu_hist_precision=hilo``) with ROADMAP C's standing tolerances: the
  same splits exactly, leaf values to rtol 1e-5 against the JAX
  package's fused f32 ``onehot`` run, and within 1e-3 of the largest
  leaf of the oracle (its bf16 hi/lo weights;
  tests/test_torch_train_parity.py says why).  The fixtures are that
  file's pinned ones.
* The schedule: ``wave_count``, a wave with no valid split is an exact
  no-op on the state, a tree that finishes within M waves makes one host
  read, a tree that needs more waves finishes through tail waves.
* Exact growth: the fused exact iteration (the tree graph's S gated
  splits, then tail blocks of S) trains the staged exact model text to
  the byte, grows the JAX package's fused exact trees (``tpu_growth=exact,
  tpu_histogram_mode=pallas``: its Pallas leaf kernel in interpret mode
  on the CPU) with tests/test_torch_exact_train.py's tolerances, a split
  with no positive gain is an exact no-op, and a tree makes one read a
  block of S splits; exact-order waves train the staged exact-order text.
* Modes: unknown is fatal, ineligible configs warn under ``on`` and stay
  staged, ``on`` with exact growth fuses, ``auto`` stays staged on the
  CPU.
"""
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.ops import fused_iter as fi
from lightgbm_tpu_torch.ops.grow import TreeArrays
from lightgbm_tpu_torch.ops.histogram import weight_rows
from lightgbm_tpu_torch.ops.split_finder import GAIN
from lightgbm_tpu_torch.ops.wave_kernels import fixed_point_exponents
from lightgbm_tpu_torch.utils.log import LightGBMError
from torch_cases import (NO_CACHE, SAMPLED, labels, leaf_values,
                         parity_data, parity_params, structure)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ITERS = 5


def _params(objective, mode, more=None):
    return {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": 4, "tpu_histogram_mode": mode, **(more or {})}


def _sparse_data(seed, n=2000):
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, 10)) < 0.25, rng.normal(size=(n, 10)), 0.0)
    X[:, 0] = rng.normal(size=n)
    s = X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * X[:, 9]
    return sps.csr_matrix(X), s + 0.2 * rng.normal(size=n)


def _pair(params, X, y, rounds=ITERS):
    """The same data trained fused and staged on the CPU."""
    fused = lgb.train(dict(params, tpu_fused_iter="on"),
                      lgb.Dataset(X, label=y), rounds, device="cpu")
    staged = lgb.train(dict(params, tpu_fused_iter="off"),
                       lgb.Dataset(X, label=y), rounds, device="cpu")
    assert fused._gbdt._fused_state[0] is not None
    assert staged._gbdt._fused_state == (None,)
    return fused, staged


# (objective, histogram mode or "sparse", EFB bundles, more params)
MATRIX = [
    ("binary", "pallas_ct", False, {}),
    ("binary", "pallas_t", False, {}),
    ("binary", "pallas", False, {}),
    ("binary", "pallas_ct", False, NO_CACHE),
    ("binary", "pallas_t", False, NO_CACHE),
    ("binary", "pallas", False, NO_CACHE),
    ("binary", "pallas_ct", True, {}),
    ("regression", "pallas_t", True, NO_CACHE),
    ("binary", "pallas_ct", False, SAMPLED),
    ("regression", "pallas_ct", False, {}),
    ("regression", "pallas", False, SAMPLED),
    ("binary", "sparse", False, {}),
    ("regression", "sparse", False, NO_CACHE),
    ("binary", "sparse", False, SAMPLED),
]


@pytest.mark.parametrize("objective,mode,bundled,more", MATRIX)
def test_fused_trains_the_staged_model_text(objective, mode, bundled, more):
    if mode == "sparse":
        X, s = _sparse_data(5)
        params = _params(objective, "auto", dict(
            more, tpu_sparse=True, tpu_sparse_kernel=True))
        del params["tpu_histogram_mode"]
    else:
        X, s = parity_data(3, 2000, bundled)
        params = _params(objective, mode, more)
    fused, staged = _pair(params, X, labels(objective, s))
    learner = fused._gbdt.learner
    assert learner.hist_mode == ("sparse_mxu" if mode == "sparse" else mode)
    assert learner.cache_hists == ("histogram_pool_size" not in more)
    assert (fused._gbdt.train_data.bundle is not None) == bundled
    assert fused.num_trees() == staged.num_trees() == ITERS + (
        objective == "regression")
    assert fused.model_to_string() == staged.model_to_string()
    np.testing.assert_array_equal(fused.predict(X), staged.predict(X))
    for f, s_ in zip(fused.grow_stats(), staged.grow_stats()):
        assert (f.num_leaves, f.depth, f.passes) == (s_.num_leaves, s_.depth,
                                                   s_.passes)
        assert f.host_reads == 1 + f.tail_passes


# tests/test_torch_train_parity.py CASES: (objective, width, bundled,
# pinned seed, more params)
JAX_CASES = [("binary", 4, False, 15, {}),
             ("regression", 4, False, 10, SAMPLED)]


@pytest.mark.parametrize("objective,width,bundled,seed,more", JAX_CASES)
def test_fused_run_grows_the_jax_fused_trees(objective, width, bundled,
                                             seed, more):
    X, s = parity_data(seed, 2500, bundled)
    Xv, sv = parity_data(seed + 1000, 600, bundled)
    y, yv = labels(objective, s), labels(objective, sv)
    base = dict(_params(objective, "pallas_ct", more),
                tpu_wave_width=width, tpu_fused_iter="on",
                metric="auc" if objective == "binary" else "l2")
    oracle = dict(base, tpu_pallas_interpret=True,
                  tpu_hist_precision="hilo")
    bj = lgbj.train(oracle, lgbj.Dataset(X, label=y), 3, verbose_eval=False)
    bf = lgbj.train(dict(base, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), 3, verbose_eval=False)
    assert bj._gbdt._fused_state[0] is not None
    assert bf._gbdt._fused_state[0] is not None
    bt = lgb.train(oracle, lgb.Dataset(X, label=y), 3, device="cpu")
    assert bt._gbdt._fused_state[0] is not None
    sj, sf, st = (bj.model_to_string(), bf.model_to_string(),
                  bt.model_to_string())
    assert bt.num_trees() == bj.num_trees() >= 3
    assert structure(st) == structure(sj) == structure(sf)
    lt, lf, lj = leaf_values(st), leaf_values(sf), leaf_values(sj)
    np.testing.assert_allclose(lt, lf, rtol=1e-5)
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())
    np.testing.assert_allclose(bt.predict(Xv), bf.predict(Xv), rtol=1e-5)


@pytest.mark.parametrize("leaves,width,waves", [
    (255, 32, 12), (15, 4, 5), (31, 8, 6), (63, 16, 7), (7, 16, 3),
    (2, 1, 1), (1, 1, 0), (255, 1, 254), (256, 32, 12), (257, 32, 13)])
def test_wave_count(leaves, width, waves):
    """Leaves double until the width, then grow by it: 255 leaves at
    width 32 take the 12 waves every profile shows."""
    assert fi.wave_count(leaves, width) == waves


def _grower_state():
    """A trained booster's wave grower and a state at its root, with the
    weight rows, exponents and feature mask of a tree."""
    X, s = parity_data(3, 2000, False)
    booster = lgb.train(_params("binary", "pallas_ct"),
                        lgb.Dataset(X, label=(s > 0).astype(float)), 1,
                        device="cpu")
    gbdt = booster._gbdt
    grower = gbdt.learner.wave_grower()
    st = grower.new_state(gbdt.num_data, torch.device("cpu"))
    g, h = gbdt.objective.get_gradients(gbdt._score_dev[0])
    w3 = weight_rows(g, h, None)
    exps = fixed_point_exponents(w3)
    mask = gbdt.learner._full_mask
    grower.root(st, w3, exps, mask)
    return grower, st, (w3, exps, mask)


def _snapshot(grower, st):
    tree = grower.tree_of(st)
    L = grower.L
    out = {f: getattr(tree, f).clone() for f in tree.__dataclass_fields__}
    out.update(leaf_id=st.leaf_id.clone(), bests=st.bests[:L].clone(),
               hists=st.hists[:L].clone(), nn=st.nn.clone())
    if st.waves is not None:
        out["waves"] = st.waves.clone()
    return out


def _assert_same(a, b):
    """Bit for bit (a best split may hold a NaN leaf output)."""
    assert a.keys() == b.keys()
    for name in a:
        x, y = a[name], b[name]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


@pytest.mark.parametrize("how", ["gains_at_most_0", "tree_done"])
def test_wave_without_valid_split_is_a_no_op(how):
    """A wave whose top-W leaves all have gain <= 0 (every gain set to 0
    or -1 at the root, or a finished tree) leaves every state tensor
    bit-unchanged: leaf ids, the histogram cache, the best splits, every
    tree array, the split and wave counts; and it reports done."""
    grower, st, args = _grower_state()
    if how == "gains_at_most_0":
        st.bests[:, GAIN] = torch.where(st.bests[:, GAIN] > 0, 0.0, -1.0)
    else:
        for _ in range(fi.wave_count(grower.L, grower.W)):
            grower.wave(st, *args)
        assert int(st.nn) == grower.L - 1
    before = _snapshot(grower, st)
    grower.wave(st, *args)
    _assert_same(before, _snapshot(grower, st))
    assert bool(st.done)
    grower.write_status(st)
    assert st.status.tolist() == [1, int(st.nn), int(
        st.tree.leaf_depth[:grower.L].max()), int(st.waves)]


def test_tree_within_m_waves_makes_one_host_read():
    """Every tree of this fixture finishes within wave_count(15, 4) = 5
    waves: under the fused schedule each makes exactly one host read and
    no tail wave, where the staged chain reads once a wave."""
    X, s = parity_data(3, 2000, False)
    fused, staged = _pair(_params("binary", "pallas_ct"), X,
                          (s > 0).astype(float))
    for f, st in zip(fused.grow_stats(), staged.grow_stats()):
        assert f.passes <= fi.wave_count(15, 4)
        assert (f.host_reads, f.tail_passes) == (1, 0)
        assert st.host_reads >= f.passes


def _chain_data(n=3000):
    """Regression on a staircase y = 4^r / 1e6 over r in 0..14: the best
    split cuts off the top step, whose leaf is constant, so a wave splits
    fewer leaves than the doubling schedule and trees need more than M
    waves."""
    rng = np.random.default_rng(0)
    r = rng.integers(0, 15, size=n)
    X = np.stack([r.astype(float), rng.normal(size=n)], 1)
    return X, 4.0 ** r / 1e6


@pytest.mark.parametrize("mode", ["pallas_ct", "sparse"])
def test_tree_that_needs_tail_waves_equals_the_staged_tree(mode):
    X, y = _chain_data()
    params = _params("regression", mode, {"min_data_in_leaf": 5})
    if mode == "sparse":
        del params["tpu_histogram_mode"]
        params.update(tpu_sparse=True, tpu_sparse_kernel=True)
        X = sps.csr_matrix(X)
    fused, staged = _pair(params, X, y, rounds=3)
    stats = fused.grow_stats()
    assert any(st.tail_passes > 0 for st in stats)
    for f, st in zip(stats, staged.grow_stats()):
        assert f.num_leaves == st.num_leaves == 15
        assert f.host_reads == 1 + f.tail_passes
        assert f.passes == st.passes <= fi.wave_count(15, 4) + f.tail_passes
    assert fused.model_to_string() == staged.model_to_string()


def test_unknown_mode_is_fatal():
    X, s = parity_data(3, 500, False)
    with pytest.raises(LightGBMError, match="tpu_fused_iter"):
        lgb.train(_params("binary", "pallas_ct", {"tpu_fused_iter": "yes"}),
                  lgb.Dataset(X, label=(s > 0).astype(float)), 1,
                  device="cpu")


def test_on_with_exact_growth_is_an_error():
    """No longer an error: tpu_fused_iter=on with exact growth (set, or
    auto growth resolving to it with 'pallas') fuses the exact grower and
    trains the staged chain's model text."""
    X, s = parity_data(3, 500, False)
    y = (s > 0).astype(float)
    for growth in ("exact", "auto"):
        p = _params("binary", "pallas", {"tpu_growth": growth})
        fused, staged = _pair(p, X, y, rounds=2)
        assert fused._gbdt.learner.growth == "exact"
        assert fused.model_to_string() == staged.model_to_string()


# ------------------------------------------------------- exact growth
# (objective, EFB bundles, more params)
EXACT_MATRIX = [
    ("binary", False, {}),
    ("regression", False, {}),
    ("binary", True, {}),
    ("binary", False, NO_CACHE),
    ("binary", False, SAMPLED),
    ("regression", True, dict(NO_CACHE, **SAMPLED)),
]


@pytest.mark.parametrize("objective,bundled,more", EXACT_MATRIX)
def test_fused_exact_trains_the_staged_model_text(objective, bundled, more):
    X, s = parity_data(3, 2000, bundled)
    params = _params(objective, "pallas", dict(more, tpu_growth="exact"))
    fused, staged = _pair(params, X, labels(objective, s))
    learner = fused._gbdt.learner
    assert (learner.growth, learner.hist_mode) == ("exact", "pallas")
    assert learner.cache_hists == ("histogram_pool_size" not in more)
    assert (fused._gbdt.train_data.bundle is not None) == bundled
    assert fused.model_to_string() == staged.model_to_string()
    np.testing.assert_array_equal(fused.predict(X), staged.predict(X))
    for f, s_ in zip(fused.grow_stats(), staged.grow_stats()):
        assert (f.num_leaves, f.depth, f.passes) == (s_.num_leaves, s_.depth,
                                                   s_.passes)
        assert (f.host_reads, f.tail_passes) == (1, 0)


# tests/test_torch_exact_train.py CASES: (objective, pinned seed)
@pytest.mark.parametrize("objective,seed", [("binary", 2),
                                            ("regression", 0)])
def test_fused_exact_grows_the_jax_fused_exact_trees(objective, seed):
    X, s = parity_data(seed, 2500, False)
    y = labels(objective, s)
    params = parity_params(objective, {"tpu_growth": "exact",
                                       "tpu_histogram_mode": "pallas",
                                       "tpu_fused_iter": "on"})
    bj = lgbj.train(params, lgbj.Dataset(X, label=y), 5)
    assert bj._gbdt._fused_state[0] is not None
    bt = lgb.train(params, lgb.Dataset(X, label=y), 5, device="cpu")
    assert bt._gbdt._fused_state[0] is not None
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert bt.num_trees() == bj.num_trees() >= 5
    assert structure(st) == structure(sj)
    lt, lj = leaf_values(st), leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=1e-5,
                               atol=1e-5 * np.abs(lj).max())
    pt, pj = bt.predict(X), bj.predict(X)
    np.testing.assert_allclose(pt, pj, rtol=1e-5,
                               atol=1e-6 * np.abs(pj).max())


def _exact_state():
    """A trained exact booster's grower and a state at its root, with the
    weight rows, exponents and feature mask of a tree."""
    X, s = parity_data(3, 2000, False)
    booster = lgb.train(_params("binary", "pallas", {"tpu_growth": "exact"}),
                        lgb.Dataset(X, label=(s > 0).astype(float)), 1,
                        device="cpu")
    gbdt = booster._gbdt
    grower = gbdt.learner.exact_grower()
    st = grower.new_state(gbdt.num_data, torch.device("cpu"))
    g, h = gbdt.objective.get_gradients(gbdt._score_dev[0])
    w3 = weight_rows(g, h, None)
    exps = fixed_point_exponents(w3)
    mask = gbdt.learner._full_mask
    grower.root(st, w3, exps, mask)
    return grower, st, (w3, exps, mask)


@pytest.mark.parametrize("how", ["gains_at_most_0", "tree_done"])
def test_split_without_positive_gain_is_a_no_op(how):
    """A gated split whose best leaf has gain <= 0 (every gain set to 0
    or -1 at the root), or one past a full tree, leaves every state
    tensor bit-unchanged: leaf ids, the histogram cache, the best
    splits, every tree array and the split count; and it reports done."""
    grower, st, args = _exact_state()
    if how == "gains_at_most_0":
        st.bests[:, GAIN] = torch.where(st.bests[:, GAIN] > 0, 0.0, -1.0)
    else:
        for _ in range(grower.L - 1):
            grower.split(st, *args)
        assert int(st.nn) == grower.L - 1
    before = _snapshot(grower, st)
    grower.split(st, *args)
    _assert_same(before, _snapshot(grower, st))
    assert bool(st.done)
    grower.write_status(st)
    nn = int(st.nn)
    assert st.status.tolist() == [1, nn, int(
        st.tree.leaf_depth[:grower.L].max()), nn]


@pytest.mark.parametrize("stops_early", [False, True])
def test_fused_exact_reads_once_a_block_of_splits(monkeypatch, stops_early):
    """With S = 4 splits a graph, a tree of n splits makes max(1,
    ceil(n / S)) host reads (the tree graph's, then one a tail block)
    and runs S splits a tail block, full trees and trees that run out
    of positive gains alike (tests/test_torch_exact_train.py's early
    stop fixture); the staged chain reads once a batch of certain
    splits, and both grow the same trees."""
    monkeypatch.setattr(fi, "SPLIT_BLOCK", 4)
    if stops_early:
        X, y = parity_data(1, 600, False)
        params = _params("regression", "pallas", {
            "tpu_growth": "exact", "num_leaves": 63,
            "min_data_in_leaf": 40})
    else:
        X, s = parity_data(3, 2000, False)
        y = (s > 0).astype(float)
        params = _params("binary", "pallas", {"tpu_growth": "exact"})
    fused, staged = _pair(params, X, y, rounds=3)
    assert fused._gbdt._fused_state[0].tail_len == 4
    stats = fused.grow_stats()
    L = params["num_leaves"]
    assert all((st.num_leaves < L) == stops_early for st in stats)
    for f, s_ in zip(stats, staged.grow_stats()):
        assert (f.num_leaves, f.depth, f.passes) == (s_.num_leaves, s_.depth,
                                                   s_.passes)
        assert f.passes == f.num_leaves - 1
        assert f.host_reads == max(1, -(-f.passes // 4))
        assert f.tail_passes == 4 * (f.host_reads - 1)
    assert fused.model_to_string() == staged.model_to_string()


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t", "pallas",
                                  "sparse"])
def test_fused_exact_order_trains_the_staged_model_text(mode):
    """Exact-order waves (tpu_wave_order=exact) fused: M masked waves,
    then one-wave tail graphs with a read each, train the staged
    exact-order chain's model text, with bagging and feature_fraction,
    on every dataflow."""
    params = _params("binary", mode, dict(SAMPLED, tpu_wave_order="exact"))
    if mode == "sparse":
        X, s = _sparse_data(5)
        del params["tpu_histogram_mode"]
        params.update(tpu_sparse=True, tpu_sparse_kernel=True)
    else:
        X, s = parity_data(3, 2000, False)
    fused, staged = _pair(params, X, labels("binary", s))
    it = fused._gbdt._fused_state[0]
    assert it.grower.exact_order and it.tail_len == 1
    assert fused.model_to_string() == staged.model_to_string()
    for f, s_ in zip(fused.grow_stats(), staged.grow_stats()):
        assert (f.num_leaves, f.depth, f.passes) == (s_.num_leaves, s_.depth,
                                                   s_.passes)
        assert f.host_reads == 1 + f.tail_passes
        assert s_.host_reads == s_.passes + 1


class _RescalingBagging(GBDT):
    """A boosting mode with its own gradient bagging (GOSS's hook), which
    the fused iteration does not run."""

    def _bagging_with_grad(self, it, grad, hess):
        return GBDT._bagging_with_grad(self, it, grad, hess)


def test_ineligible_config_warns_under_on_and_stays_staged(capsys):
    X, s = parity_data(3, 1000, False)
    y = (s > 0).astype(float)
    p = _params("binary", "pallas_ct")
    staged = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cpu")
    booster = lgb.Booster(dict(p, tpu_fused_iter="on", verbose=0),
                          lgb.Dataset(X, label=y), device="cpu")
    booster._gbdt.__class__ = _RescalingBagging
    assert fi.fused_supported(booster._gbdt) == (
        False, "gradient-rescaling bagging (goss)")
    capsys.readouterr()
    for _ in range(3):
        booster.update()
    assert "tpu_fused_iter=on but the fused iteration is unavailable" in (
        capsys.readouterr().err)
    assert booster._gbdt._fused_state == (None,)
    assert booster.model_to_string() == staged.model_to_string()
    booster._gbdt.objective = None
    assert fi.fused_supported(booster._gbdt)[0] is False


def test_auto_stays_staged_on_the_cpu():
    X, s = parity_data(3, 1000, False)
    booster = lgb.train(_params("binary", "pallas_ct"),
                        lgb.Dataset(X, label=(s > 0).astype(float)), 2,
                        device="cpu")
    assert fi.fused_supported(booster._gbdt) == (True, "")
    assert booster._gbdt._fused_state == (None,)
    assert all(st.host_reads >= st.passes for st in booster.grow_stats())


def test_tree_arrays_reset_copy_clone():
    """TreeArrays.reset_ re-initialises preallocated arrays to new()'s
    one-leaf tree, clone owns its arrays and copy_ fills in place."""
    count = torch.tensor(7.0)
    fresh = TreeArrays.new(5, count, torch.float32, "cpu")
    used = TreeArrays.new(5, count, torch.float32, "cpu")
    for name in used.__dataclass_fields__:
        getattr(used, name).fill_(3)
    same = used.reset_(count)
    assert same is used
    for name in fresh.__dataclass_fields__:
        assert torch.equal(getattr(used, name), getattr(fresh, name)), name
    twin = used.clone()
    used.leaf_value.fill_(2.5)
    assert not torch.equal(twin.leaf_value, used.leaf_value)
    twin.copy_(used)
    assert torch.equal(twin.leaf_value, used.leaf_value)
    head = TreeArrays.new(6, count, torch.float32, "cpu").head(5)
    assert head.split_feature.shape == (4,) and head.leaf_value.shape == (5,)
