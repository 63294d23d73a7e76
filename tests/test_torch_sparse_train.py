"""Training on the entry-chunk sparse store (``tpu_sparse=true,
tpu_sparse_kernel=true``) from CSR input: the port grows the JAX
package's trees, grows its own dense path's trees, and refuses the flag
combinations the JAX package refuses.

On the CPU the JAX package's ``sparse_mxu`` engine histograms through its
f32 segment-sum form (``chunked_child_hists_ref``) and the port through
B6's plain version, so leaf values and predictions agree to rtol 1e-5.

The fixtures are pinned: where a split borders an empty bin (the zero bin
of a feature whose sampled values are mostly zero) two thresholds give the
same partition with gains equal up to rounding, and the fill slot rebuilt
by subtraction (sums minus the other bins) rounds differently from a
direct sum, so either threshold may win (ROADMAP C).  On these seeds every
configuration picks the same one in all runs.
"""
import numpy as np
import pytest
import scipy.sparse as sps

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

STRUCTURE = ("split_feature", "threshold=", "left_child", "right_child",
             "leaf_count", "decision_type")
SPARSE = {"tpu_sparse": True, "tpu_sparse_kernel": True}


def _data(seed, n=2500, f=12, bundled=False):
    """A dense first column and 20%-dense others; with ``bundled`` the last
    four columns are mutually exclusive, so EFB packs them."""
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, f)) < 0.2, rng.normal(size=(n, f)), 0.0)
    X[:, 0] = rng.normal(size=n)
    if bundled:
        owner = rng.integers(0, 8, size=n)
        for j in range(4):
            X[:, 8 + j] = np.where(owner == j, rng.normal(size=n) + 2.0, 0.0)
    s = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.4 * X[:, 9]
         + 0.3 * rng.normal(size=n))
    return X, s


def _structure(model):
    return [ln for ln in model.splitlines() if ln.startswith(STRUCTURE)]


def _leaf_values(model):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in model.splitlines()
                           if ln.startswith("leaf_value")])


def _params(objective, width, more):
    return {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": width, **SPARSE, **more}


# (objective, wave width, EFB bundles, pinned seed, more params)
CASES = [("binary", 4, False, 0, {}), ("binary", 4, False, 5, {}),
         ("binary", 14, False, 0, {}), ("regression", 4, False, 2, {}),
         ("regression", 4, True, 1, {}), ("binary", 4, True, 2, {}),
         ("binary", 4, False, 0, {"histogram_pool_size": 0.01})]


@pytest.mark.parametrize("objective,width,bundled,seed,more", CASES)
def test_sparse_store_grows_the_jax_trees(objective, width, bundled, seed,
                                          more):
    X, s = _data(seed, bundled=bundled)
    Xv, sv = _data(seed + 1000, n=600, bundled=bundled)
    binary = objective == "binary"
    y, yv = ((s > 0).astype(float), (sv > 0).astype(float)) if binary \
        else (s, sv)
    p = dict(_params(objective, width, more),
             metric="auc" if binary else "l2")
    C, Cv = sps.csr_matrix(X), sps.csr_matrix(Xv)
    ej, et = {}, {}
    bj = lgbj.train(p, lgbj.Dataset(C, label=y), 3,
                    valid_sets=[lgbj.Dataset(Cv, label=yv)],
                    evals_result=ej, verbose_eval=False)
    dt = lgbt.Dataset(C, label=y, params=p).construct()
    assert (dt._handle.bundle is not None) == bundled
    bt = lgbt.train(p, dt, 3, valid_sets=[lgbt.Dataset(Cv, label=yv)],
                    evals_result=et, device="cpu")
    learner = bt._gbdt.learner
    assert learner.hist_mode == bj._gbdt.learner.hist_mode == "sparse_mxu"
    assert learner.X.cap_chunks == bj._gbdt.learner.sparse_col_cap >= 1
    assert learner.cache_hists == ("histogram_pool_size" not in more)
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert bt.num_trees() == bj.num_trees() >= 3
    assert _structure(st) == _structure(sj)
    np.testing.assert_allclose(_leaf_values(st), _leaf_values(sj),
                               rtol=1e-5)
    np.testing.assert_allclose(bt.predict(Cv), bj.predict(Cv), rtol=1e-5)
    metric = "auc" if binary else "l2"
    np.testing.assert_allclose(et["valid_0"][metric],
                               ej["valid_0"][metric], rtol=1e-5)


@pytest.mark.parametrize("objective,width,bundled,seed,more", CASES[:5])
def test_sparse_and_dense_paths_grow_the_same_trees(objective, width,
                                                    bundled, seed, more):
    """The same data, dense and as CSR through the sparse store: the same
    partitions, and leaf values to 5e-4 of the largest leaf.  The two
    histogram the default bin differently.  The dense plain version adds
    its rows one after another in f32 (index_add_), and in these mostly
    zero columns the default bin holds ~80% of the rows, so its sum drifts
    by up to ~1e-5 of the column's sum of |g|.  The sparse path rebuilds
    that slot as the leaf sum minus the few other rows.  Trees 2 and 3
    inherit the drift through the scores: on these seeds leaf values
    differ by up to 1.5e-4 of the largest leaf (the JAX package's own
    sparse and f32 dense paths, which sum blockwise, differ by 2e-5)."""
    X, s = _data(seed, bundled=bundled)
    y = (s > 0).astype(float) if objective == "binary" else s
    p = _params(objective, width, more)
    dense_p = {k: v for k, v in p.items() if k not in SPARSE}
    sparse = lgbt.train(p, lgbt.Dataset(sps.csr_matrix(X), label=y), 3,
                        device="cpu")
    dense = lgbt.train(dense_p, lgbt.Dataset(X, label=y), 3, device="cpu")
    assert sparse._gbdt.learner.hist_mode == "sparse_mxu"
    assert dense._gbdt.learner.hist_mode == "pallas_ct"
    ss, ds = sparse.model_to_string(), dense.model_to_string()
    assert _structure(ss) == _structure(ds)
    lv = _leaf_values(ds)
    np.testing.assert_allclose(_leaf_values(ss), lv, rtol=0,
                               atol=5e-4 * np.abs(lv).max())
    # prediction takes the matrix in either form
    for C in (sps.csr_matrix(X), sps.csc_matrix(X)):
        np.testing.assert_array_equal(sparse.predict(C), sparse.predict(X))
    np.testing.assert_array_equal(
        sparse.predict(sps.csr_matrix(X), raw_score=True),
        sparse.predict(X, raw_score=True))


def test_sparse_store_holds_only_non_fill_entries():
    X, s = _data(0)
    b = lgbt.train(_params("binary", 4, {}),
                   lgbt.Dataset(sps.csr_matrix(X), label=(s > 0) * 1.0), 1,
                   device="cpu")
    learner = b._gbdt.learner
    td = b._gbdt.train_data
    store = learner.X
    real = int((store.ent_row.numpy() < td.num_data).sum())
    fill = store.fill.numpy()
    assert real == int((td.binned != fill[None, :]).sum())
    assert real < 0.5 * td.binned.size
    assert learner.sparse_device_bytes == 4 * (
        2 * store.ent_row.numel() + store.ent_row.shape[0]
        + 2 * len(fill) + 1)


def _train(params, n=300):
    X, s = _data(3, n=n)
    return lgbt.train(dict({"objective": "binary", "verbose": -1},
                           **params),
                      lgbt.Dataset(sps.csr_matrix(X), label=(s > 0) * 1.0),
                      1, device="cpu")


@pytest.mark.parametrize("params,match", [
    # tpu_sparse alone trains on the coordinate store
    # (tests/test_torch_coord_store.py); kernel B6 sums f32 weights only
    ({**SPARSE, "tpu_use_dp": True}, "tpu_sparse_kernel"),
    ({**SPARSE, "tpu_growth": "exact"}, "wave growth"),
    ({**SPARSE, "tpu_histogram_mode": "pallas_ct"}, "dense-only"),
    ({**SPARSE, "tpu_histogram_mode": "pallas_t"}, "dense-only"),
])
def test_sparse_flag_errors(params, match):
    with pytest.raises(lgbt.LightGBMError, match=match):
        _train(params)


def test_sparse_kernel_without_sparse_is_ignored(capsys):
    b = _train({"tpu_sparse_kernel": True, "verbose": 0})
    assert "tpu_sparse_kernel=true has no effect" in capsys.readouterr().err
    assert not b._gbdt.learner.sparse
    assert b._gbdt.learner.hist_mode == "pallas_ct"
