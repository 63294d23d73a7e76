"""Sparse input on the port's host side: io/sparse.py and
TrainingData.from_csc build the JAX package's arrays, bins, mappers and
bundle layout byte for byte from the same CSR/CSC input, for the train set
and for a valid set binned with its reference; the Dataset takes scipy
matrices and keeps them sparse."""
import numpy as np
import pytest
import scipy.sparse as sps

from lightgbm_tpu.io import sparse as jsp
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.utils.config import Config as JConfig
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.io import sparse as tsp
from lightgbm_tpu_torch.io.dataset import TrainingData as TTrainingData
from lightgbm_tpu_torch.utils.config import Config as TConfig
from test_torch_dataset import _assert_same


def _sparse_matrix(kind, n=2000, f=10, seed=0):
    """Mostly-zero columns (with a few NaN entries); with ``bundled`` the
    last four columns are mutually exclusive, so EFB packs them."""
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, f)) < 0.12, rng.normal(size=(n, f)), 0.0)
    X[:, 0] = rng.normal(size=n)
    X[rng.random(n) < 0.02, 2] = np.nan
    if kind == "bundled":
        owner = rng.integers(0, 6, size=n)
        for j in range(4):
            X[:, f - 4 + j] = np.where(owner == j,
                                       rng.normal(size=n) + 1.5, 0.0)
    return X, (X[:, 0] > 0).astype(np.float64)


def _assert_columns_equal(got, want):
    assert (got.num_row, got.num_col) == (want.num_row, want.num_col)
    for name in ("colptr", "indices", "values"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_sparse_columns_match_the_jax_package():
    X, _ = _sparse_matrix("plain", n=700)
    csr = sps.csr_matrix(X)
    csc = csr.tocsc()
    _assert_columns_equal(
        tsp.csr_to_csc(csr.indptr, csr.indices, csr.data, X.shape[1]),
        jsp.csr_to_csc(csr.indptr, csr.indices, csr.data, X.shape[1]))
    _assert_columns_equal(
        tsp.csc_arrays(csc.indptr, csc.indices, csc.data, X.shape[0]),
        jsp.csc_arrays(csc.indptr, csc.indices, csc.data, X.shape[0]))
    for m in (csr, csc, sps.coo_matrix(X)):
        assert tsp.is_scipy_sparse(m) and jsp.is_scipy_sparse(m)
        _assert_columns_equal(tsp.from_scipy(m), jsp.from_scipy(m))
    assert not tsp.is_scipy_sparse(X)
    tc, jc = tsp.from_scipy(csr), jsp.from_scipy(csr)
    rows = np.sort(np.random.default_rng(1).choice(700, 300, replace=False))
    _assert_columns_equal(tc.take_rows(rows), jc.take_rows(rows))
    with pytest.raises(ValueError):
        tc.take_rows(rows[::-1])
    for j in (0, 4, 9):
        for a, b in zip(tc.column(j), jc.column(j)):
            np.testing.assert_array_equal(a, b)
    blocks = list(tsp.iter_dense_row_chunks(tc, chunk=256))
    assert [s for s, _ in blocks] == [s for s, _ in
                                      jsp.iter_dense_row_chunks(jc, 256)]
    np.testing.assert_array_equal(np.concatenate([b for _, b in blocks]), X)


@pytest.mark.parametrize("kind,params", [
    ("plain", {"max_bin": 63}),
    ("bundled", {"max_bin": 63}),
    ("bundled", {"max_bin": 63, "enable_bundle": False}),
    ("plain", {"max_bin": 15, "min_data_in_leaf": 5,
               "bin_construct_sample_cnt": 800}),
])
def test_from_csc_byte_identical(kind, params):
    params = dict(params, verbose=-1)
    X, y = _sparse_matrix(kind)
    Xv, yv = _sparse_matrix(kind, n=500, seed=1)
    sp, spv = jsp.from_scipy(sps.csr_matrix(X)), jsp.from_scipy(
        sps.csr_matrix(Xv))
    tp, tpv = tsp.from_scipy(sps.csr_matrix(X)), tsp.from_scipy(
        sps.csr_matrix(Xv))
    j = JTrainingData.from_csc(sp, label=y, config=JConfig(params))
    t = TTrainingData.from_csc(tp, label=y, config=TConfig(params))
    jv = JTrainingData.from_csc(spv, label=yv, config=JConfig(params),
                                reference=j)
    tv = TTrainingData.from_csc(tpv, label=yv, config=TConfig(params),
                                reference=t)
    bundled = kind == "bundled" and params.get("enable_bundle", True)
    assert (t.bundle is not None) == bundled
    _assert_same(j, t)
    _assert_same(jv, tv)
    assert tv.bin_mappers is t.bin_mappers and tv.bundle is t.bundle


def test_from_csc_rejects_a_valid_set_of_another_width():
    X, y = _sparse_matrix("plain", n=300)
    t = TTrainingData.from_csc(tsp.from_scipy(sps.csr_matrix(X)), label=y,
                               config=TConfig({"verbose": -1}))
    with pytest.raises(lgbt.LightGBMError, match="features"):
        TTrainingData.from_csc(tsp.from_scipy(sps.csr_matrix(X[:, :4])),
                               reference=t, config=TConfig({"verbose": -1}))


def test_dataset_keeps_scipy_input_sparse():
    X, y = _sparse_matrix("plain", n=400)
    for m in (sps.csr_matrix(X), sps.csc_matrix(X)):
        ds = lgbt.Dataset(m, label=y)
        assert isinstance(ds.data, tsp.SparseColumns)
        assert (ds.num_data(), ds.num_feature()) == X.shape
        dense = lgbt.Dataset(X, label=y).construct()._handle
        assert ds.construct()._handle.binned.tobytes() == \
            dense.binned.tobytes()
