"""The coordinate sparse store (``tpu_sparse=true`` without
``tpu_sparse_kernel``) against the JAX package's ``ops/sparse_store.py``
on the same numpy inputs, and whole runs on it.

* The store's arrays, its window size and its byte count are the JAX
  package's.
* ``leaf_histogram_sparse``, the slot form (the wave grower's W children
  in one pass) and ``sparse_split_column`` against the JAX package's on
  weights that are multiples of 2^-6: every sum is then exact in f32, so
  the JAX package's f32 segment sums, the port's fixed point (the card's
  sums) and the port's CPU sums agree to rtol 1e-6, fill slots zero in
  all.  On normal weights the port's CPU sums are held to the JAX
  package's at the f32 reordering tolerance.
* Training: the JAX package's trees under wave growth (W = 32) and
  exact growth, splits equal and leaf values within 5e-4 of the largest
  leaf (the standing note's bound for sparse against dense); the
  coordinate store's model text equal to the entry-chunk store's to the
  byte, fused equal to staged, exact growth equal to waves of width 1;
  DART, rollback and continued training on both sparse stores from the
  raw rows, where the port raised before, against the JAX package.

The whole-run fixtures are pinned: near an empty bin two thresholds give
the same partition with gains equal up to rounding (ROADMAP C).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.ops import sparse_store as jss
from lightgbm_tpu_torch.ops import sparse_store as tss
from torch_cases import (assert_hist_close, leaf_values, sparse_bundled_case,
                         sparse_case, structure)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

STORE_FIELDS = ("nz_row", "nz_bin", "nz_seg", "colptr", "fill")


def _dyadic(w3):
    """w3 rounded to multiples of 2^-6: exact f32 sums."""
    return (np.round(w3 * 64) / 64).astype(np.float32)


def _stores(X, fill, b):
    js, jcap, jbytes = jss.build_sparse_store(X, fill, b)
    ts, tcap, tbytes = tss.build_sparse_store(X, fill, b)
    return (js, jcap, jbytes), (ts, tcap, tbytes)


@pytest.mark.parametrize("dense_col", [3, None])
def test_store_arrays_equal(dense_col):
    X, fill, _, _ = sparse_case(dense_col=dense_col)
    (js, jcap, jbytes), (ts, tcap, tbytes) = _stores(X, fill, 14)
    for name in STORE_FIELDS:
        got = getattr(ts, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert (tcap, tbytes) == (jcap, jbytes) == (ts.col_cap, tbytes)
    assert tss.store_device_bytes(ts) == tbytes


def test_split_column_is_the_column():
    X, fill, _, _ = sparse_case()
    (js, jcap, _), (ts, _, _) = _stores(X, fill, 14)
    for j in range(X.shape[1]):
        col = tss.sparse_split_column(ts, j, X.shape[0])
        np.testing.assert_array_equal(col.numpy(), X[:, j].astype(np.int32))
        np.testing.assert_array_equal(
            col.numpy(), np.asarray(jss.sparse_split_column(
                js, j, X.shape[0], jcap)))


def _jax_leaf(js, w3, lid, leaf, b, f):
    return np.asarray(jss.leaf_histogram_sparse(
        js, jnp.asarray(w3[:, 0]), jnp.asarray(w3[:, 1]), jnp.asarray(lid),
        leaf, jnp.asarray(w3[:, 2]), b, f))


@pytest.mark.parametrize("fixed", [True, False])
@pytest.mark.parametrize("case", ["plain", "bundled"])
def test_leaf_histogram_matches_jax(case, fixed):
    if case == "plain":
        X, fill, lid, w3 = sparse_case()
        b = 14
    else:
        X, fill, lid, w3, b = sparse_bundled_case()
    w3 = _dyadic(w3)
    w3[:, 2] = np.abs(w3[:, 2])              # row multipliers
    (js, _, _), (ts, _, _) = _stores(X, fill, b)
    f = X.shape[1]
    for leaf in (0, 3, -1):
        want = _jax_leaf(js, w3, lid, leaf, b, f)
        got = tss.leaf_histogram_sparse(
            ts, torch.as_tensor(w3[:, 0]), torch.as_tensor(w3[:, 1]),
            torch.as_tensor(lid), leaf, torch.as_tensor(w3[:, 2]), b, f,
            fixed=fixed).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
        # the store never holds fill entries
        assert not got[np.arange(f), fill].any()


@pytest.mark.parametrize("fixed", [True, False])
def test_slot_form_matches_jax_per_leaf(fixed):
    """The W children's histograms in one pass, against the JAX package's
    leaf histogram of each child; an inactive slot is zero and a
    repeated id's slots both hold its histogram."""
    X, fill, lid, w3 = sparse_case(L=12)
    w3 = _dyadic(w3)
    w3[:, 2] = 1.0                   # [g, h, 1]: no row multipliers
    (js, _, _), (ts, _, _) = _stores(X, fill, 14)
    f = X.shape[1]
    cid = np.array([2, 10, -1, 5, 2, 11], np.int32)
    got = tss.sparse_wave_hists(ts, torch.as_tensor(lid),
                                torch.as_tensor(w3), torch.as_tensor(cid),
                                14, f, 12, fixed=fixed).numpy()
    for k, c in enumerate(cid):
        want = (np.zeros_like(got[k]) if c < 0
                else _jax_leaf(js, w3, lid, int(c), 14, f))
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=0)


def test_cpu_sums_hold_to_jax_on_normal_weights():
    """The CPU's sums in the weights' dtype, and the fixed point, on
    unrounded weights: the f32 reordering tolerance."""
    X, fill, lid, w3 = sparse_case()
    w3[:, 2] = 1.0
    (js, _, _), (ts, _, _) = _stores(X, fill, 14)
    f = X.shape[1]
    want = _jax_leaf(js, w3, lid, 4, 14, f)
    for fixed in (False, True):
        got = tss.sparse_leaf_hist(ts, torch.as_tensor(lid),
                                   torch.as_tensor(w3), 4, 14, f,
                                   fixed=fixed).numpy()
        assert_hist_close(got, want, w3)


def test_fixed_point_equals_the_slot_form_and_float64():
    """The fixed point gives the same bits through the slot form and the
    leaf form, and the 128-bit form of float64 weights is within a
    float64 rounding of the plain float64 sums."""
    X, fill, lid, w3 = sparse_case()
    (_, _, _), (ts, _, _) = _stores(X, fill, 14)
    f = X.shape[1]
    t_lid, t_w3 = torch.as_tensor(lid), torch.as_tensor(w3)
    one = tss.sparse_leaf_hist(ts, t_lid, t_w3, 7, 14, f, fixed=True)
    slots = tss.sparse_wave_hists(ts, t_lid, t_w3, torch.tensor(
        [7, -1], dtype=torch.int32), 14, f, 12, fixed=True)
    assert torch.equal(one, slots[0])
    w64 = t_w3.double()
    wide = tss.sparse_leaf_hist(ts, t_lid, w64, 7, 14, f, fixed=True)
    plain = tss.sparse_leaf_hist(ts, t_lid, w64, 7, 14, f, fixed=False)
    assert wide.dtype == torch.float64
    np.testing.assert_allclose(wide.numpy(), plain.numpy(), rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------ whole runs
def _data(seed, n=2500, f=12):
    """A dense first column and 20%-dense others, as dense rows (the raw
    rows that DART, rollback and continued training score)."""
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, f)) < 0.2, rng.normal(size=(n, f)), 0.0)
    X[:, 0] = rng.normal(size=n)
    s = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * X[:, 9]
         + 0.3 * rng.normal(size=n))
    return X, s


BASE = {"num_leaves": 15, "min_data_in_leaf": 20, "max_bin": 63,
        "verbose": -1, "tpu_sparse": True}
WAVE = {"tpu_growth": "wave", "tpu_wave_width": 32}
CHUNKED = {"tpu_sparse_kernel": True, "tpu_growth": "wave",
           "tpu_wave_width": 32}


def _labels(objective, s):
    return (s > 0).astype(float) if objective == "binary" else s


def _both(params, X, y, rounds=3, **kw):
    bj = lgbj.train(params, lgbj.Dataset(X, label=y), rounds,
                    verbose_eval=False, **kw)
    bt = lgbt.train(params, lgbt.Dataset(X, label=y), rounds,
                    device="cpu", **kw)
    return bj, bt


def _assert_same_trees(sj, st):
    assert structure(st) == structure(sj)
    lv = leaf_values(sj)
    np.testing.assert_allclose(leaf_values(st), lv, rtol=0,
                               atol=5e-4 * np.abs(lv).max())


# (objective, growth, pinned seed)
RUNS = [("binary", "wave", 0), ("regression", "wave", 2),
        ("binary", "exact", 2), ("regression", "exact", 2)]


@pytest.mark.parametrize("objective,growth,seed", RUNS)
def test_coordinate_store_grows_the_jax_trees(objective, growth, seed):
    X, s = _data(seed)
    y = _labels(objective, s)
    p = dict(BASE, objective=objective, **(WAVE if growth == "wave" else {}))
    bj, bt = _both(p, X, y)
    assert bj._gbdt.learner.hist_mode == "sparse"
    learner = bt._gbdt.learner
    assert (learner.hist_mode, learner.growth) == ("sparse", growth)
    assert learner.sparse_device_bytes == bj._gbdt.learner \
        .sparse_device_bytes
    assert learner.X.col_cap == bj._gbdt.learner.sparse_col_cap
    assert bt.num_trees() == bj.num_trees() >= 3
    _assert_same_trees(bj.model_to_string(), bt.model_to_string())


@pytest.mark.parametrize("objective,seed", [("binary", 0),
                                            ("regression", 2)])
def test_coordinate_store_text_is_the_entry_chunk_stores(objective, seed):
    """The same data through both sparse stores at width 32: one model
    text to the byte (both sum each cell's entries in one order on the
    CPU, and in one fixed point on the card)."""
    X, s = _data(seed)
    y = _labels(objective, s)
    texts = {}
    for name, more in (("coord", WAVE), ("chunked", CHUNKED)):
        b = lgbt.train(dict(BASE, objective=objective, **more),
                       lgbt.Dataset(X, label=y), 4, device="cpu")
        assert b._gbdt.learner.hist_mode == ("sparse" if name == "coord"
                                             else "sparse_mxu")
        texts[name] = b.model_to_string()
    assert texts["coord"] == texts["chunked"]


def test_exact_growth_is_wave_growth_at_width_one_and_fused_is_staged():
    X, s = _data(0)
    y = _labels("binary", s)
    texts = {}
    for name, more in (("exact", {"tpu_growth": "exact"}),
                       ("w1", {"tpu_growth": "wave", "tpu_wave_width": 1}),
                       ("exact_staged", {"tpu_growth": "exact",
                                         "tpu_fused_iter": "off"}),
                       ("wave_staged", dict(WAVE, tpu_fused_iter="off")),
                       ("wave", WAVE)):
        b = lgbt.train(dict(BASE, objective="binary", **more),
                       lgbt.Dataset(X, label=y), 3, device="cpu")
        texts[name] = b.model_to_string()
    assert texts["exact"] == texts["w1"] == texts["exact_staged"]
    assert texts["wave"] == texts["wave_staged"]


def test_auto_growth_is_exact_and_dp_trains():
    """tpu_growth=auto on the coordinate store is exact growth, as in the
    JAX package; tpu_use_dp trains it in float64."""
    X, s = _data(0, n=800)
    y = _labels("binary", s)
    b = lgbt.train(dict(BASE, objective="binary", tpu_use_dp=True),
                   lgbt.Dataset(X, label=y), 2, device="cpu")
    learner = b._gbdt.learner
    assert (learner.growth, learner.hist_mode) == ("exact", "sparse")
    assert learner.dtype == torch.float64
    assert b.num_trees() == 2


@pytest.mark.parametrize("store", ["coord", "chunked"])
@pytest.mark.parametrize("mode", ["dart", "rollback", "init_model"])
def test_modes_score_the_raw_rows_on_both_stores(store, mode):
    """DART, rollback and continued training on a sparse store score a
    tree by the host traversal of the kept raw rows (the JAX package's
    _apply_tree_to_train), where the port used to raise: the JAX
    package's trees, and train scores that follow the trees."""
    # pinned: DART's dense runs part from the JAX package's on near-tie
    # thresholds on most seeds too (tests/test_torch_boosting_modes.py)
    X, s = _data(4 if mode == "dart" else 0)
    y = _labels("binary", s)
    p = dict(BASE, objective="binary",
             **(WAVE if store == "coord" else CHUNKED))
    if mode == "dart":
        p.update(boosting="dart", drop_rate=0.5, drop_seed=3)
        bj, bt = _both(p, X, y, rounds=5)
    elif mode == "rollback":
        bj, bt = _both(p, X, y, rounds=4)
        for b in (bj, bt):
            b.rollback_one_iter()
    else:
        base_j, base_t = _both(p, X, y, rounds=2)
        bj = lgbj.train(p, lgbj.Dataset(X, label=y), 2, init_model=base_j,
                        verbose_eval=False)
        bt = lgbt.train(p, lgbt.Dataset(X, label=y), 2, init_model=base_t,
                        device="cpu")
    _assert_same_trees(bj.model_to_string(), bt.model_to_string())
    # the training scores are the trees' raw sums on the rows
    want = bt.predict(X, raw_score=True)
    np.testing.assert_allclose(bt._gbdt.train_score[0], want, rtol=1e-5,
                               atol=1e-5)


def test_reset_config_reuses_the_store():
    X, s = _data(1, n=800)
    y = _labels("binary", s)
    for more in (WAVE, CHUNKED):
        b = lgbt.Booster(dict(BASE, objective="binary", **more),
                         lgbt.Dataset(X, label=y), device="cpu")
        b.update()
        store = b._gbdt.learner.X
        nbytes = b._gbdt.learner.sparse_device_bytes
        b.reset_parameter({"learning_rate": 0.05})
        assert b._gbdt.learner.X is store
        assert b._gbdt.learner.sparse_device_bytes == nbytes
        b.update()
        assert b.num_trees() == 2
