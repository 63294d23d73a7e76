"""The port's LGBM_* C ABI library through ctypes: the flows of the JAX
package's tests/test_c_abi.py (the reference's tests/c_api_test/test.py)
on ``liblgbm_tpu_torch_capi`` (lightgbm_tpu_torch/capi_lib.py builds
csrc/host/capi_bridge.cpp with g++ into lightgbm_tpu_torch/_build/ on
first use).  Datasets come from raw C buffers; training, evaluation,
saving and prediction go through exported C symbols only, on the CPU
(``LGBM_SetDevice("cpu")``).  Loaded into this process with ctypes.CDLL,
the library attaches to the running interpreter through the GIL.

The model string and the predictions equal ``lightgbm_tpu_torch.train``'s
(byte for byte; predictions within rtol 1e-12, the same f64 host trees).
Against the JAX package's c_api on the oracle config of ROADMAP the trees'
structure is equal and leaf values agree with its f32 ``onehot`` run to
rtol 1e-5, atol 1e-5 x the largest leaf (ROADMAP C, standing notes).
"""
import ctypes
import os

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu_torch as lgbt
from lightgbm_tpu import c_api as jc_api
from lightgbm_tpu_torch import capi_lib

jax.config.update("jax_platforms", "cpu")

F64, I32 = 1, 2
N, F = 1500, 10
STRUCTURE = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


@pytest.fixture(scope="module")
def lib():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lib = capi_lib.load()
    _check(lib, lib.LGBM_SetDevice(b"cpu"))
    yield lib
    _check(lib, lib.LGBM_SetDevice(b"cuda"))
    torch.set_num_threads(threads)


def _check(lib, rc):
    assert rc == 0, lib.LGBM_GetLastError().decode()


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _f64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _dataset(lib, X, params, ref=None):
    ds = ctypes.c_void_p()
    n, f = X.shape
    _check(lib, lib.LGBM_DatasetCreateFromMat(
        _ptr(X), ctypes.c_int(F64), ctypes.c_int32(n), ctypes.c_int32(f),
        ctypes.c_int(1), params, ref, ctypes.byref(ds)))
    return ds


def _set_label(lib, ds, y):
    y = np.ascontiguousarray(y, dtype=np.float32)
    _check(lib, lib.LGBM_DatasetSetField(ds, b"label", _ptr(y),
                                         ctypes.c_int64(len(y)),
                                         ctypes.c_int(0)))


def _model_string(lib, bst):
    slen = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterSaveModelToString(
        bst, ctypes.c_int(-1), ctypes.c_int64(0), ctypes.byref(slen), None))
    buf = ctypes.create_string_buffer(slen.value)
    _check(lib, lib.LGBM_BoosterSaveModelToString(
        bst, ctypes.c_int(-1), slen, ctypes.byref(slen), buf))
    return buf.value.decode()


def _predict(lib, bst, X, predict_type=0):
    out_len = ctypes.c_int64()
    out = np.zeros(X.shape[0], np.float64)
    _check(lib, lib.LGBM_BoosterPredictForMat(
        bst, _ptr(X), ctypes.c_int(F64), ctypes.c_int32(X.shape[0]),
        ctypes.c_int32(X.shape[1]), ctypes.c_int(1),
        ctypes.c_int(predict_type), ctypes.c_int(-1), b"",
        ctypes.byref(out_len), _f64p(out)))
    assert out_len.value == X.shape[0]
    return out


def test_library_builds_under_the_port_build_dir(lib):
    path = capi_lib.lib_path()
    assert path.parent == capi_lib.BUILD_DIR
    assert path.name.startswith("liblgbm_tpu_torch_capi_")
    assert path.exists()
    assert capi_lib.BUILD_DIR.parts[-2:] == ("lightgbm_tpu_torch", "_build")


def test_build_error_raises_with_the_compiler_output(monkeypatch, tmp_path):
    from lightgbm_tpu_torch.utils.log import LightGBMError
    bad = tmp_path / "capi_bridge.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(capi_lib, "SOURCE", bad)
    monkeypatch.setattr(capi_lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(LightGBMError, match="capi_bridge.cpp") as err:
        capi_lib.build()
    assert "$ " in str(err.value) and "error" in str(err.value)


def test_c_abi_train_eval_save_predict(lib, tmp_path):
    rng = np.random.default_rng(4)
    X = np.ascontiguousarray(rng.normal(size=(N, F)))
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    params = (b"objective=binary num_leaves=15 max_bin=63 verbose=-1 "
              b"metric=auc")
    ds = _dataset(lib, X, params)
    _set_label(lib, ds, y)
    nd, nf = ctypes.c_int(), ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetNumData(ds, ctypes.byref(nd)))
    _check(lib, lib.LGBM_DatasetGetNumFeature(ds, ctypes.byref(nf)))
    assert nd.value == N and nf.value == F

    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(8):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 8
    elen = ctypes.c_int()
    evals = (ctypes.c_double * 4)()
    _check(lib, lib.LGBM_BoosterGetEval(bst, ctypes.c_int(0),
                                        ctypes.byref(elen), evals))
    assert elen.value == 1 and 0.8 < evals[0] <= 1.0

    # the same model and predictions as lightgbm_tpu_torch.train
    pyparams = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
                "verbose": -1, "metric": "auc"}
    want = lgbt.train(pyparams, lgbt.Dataset(X, label=y), 8, device="cpu")
    text = _model_string(lib, bst)
    assert text == want.model_to_string()
    preds = _predict(lib, bst, X)
    np.testing.assert_allclose(preds, want.predict(X), rtol=1e-12)

    model_path = str(tmp_path / "abi.model").encode()
    _check(lib, lib.LGBM_BoosterSaveModel(bst, ctypes.c_int(-1),
                                          model_path))
    nit, bst2 = ctypes.c_int(), ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreateFromModelfile(
        model_path, ctypes.byref(nit), ctypes.byref(bst2)))
    assert nit.value == 8
    np.testing.assert_allclose(_predict(lib, bst2, X), preds, rtol=1e-12)
    bst3 = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterLoadModelFromString(
        text.encode(), ctypes.byref(nit), ctypes.byref(bst3)))
    assert _model_string(lib, bst3) == text
    for h in (bst3, bst2, bst):
        _check(lib, lib.LGBM_BoosterFree(h))
    _check(lib, lib.LGBM_DatasetFree(ds))


def test_c_abi_full_surface(lib, tmp_path):
    """Push-rows streaming, subset, field get, feature names,
    custom-objective update, merge and reset-parameter, leaf get/set,
    dump, file predict."""
    rng = np.random.default_rng(6)
    X = np.ascontiguousarray(rng.normal(size=(N, F)))
    y = (X[:, 0] + X[:, 3] > 0).astype(np.float32)
    params = (b"objective=binary num_leaves=15 max_bin=63 verbose=-1 "
              b"metric=auc")
    ds0 = _dataset(lib, X, params)
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateByReference(ds0, ctypes.c_int64(N),
                                                  ctypes.byref(ds)))
    half = N // 2
    head = np.ascontiguousarray(X[:half])
    tail = np.ascontiguousarray(X[half:])
    for start, chunk in ((half, tail), (0, head)):
        _check(lib, lib.LGBM_DatasetPushRows(
            ds, _ptr(chunk), ctypes.c_int(F64),
            ctypes.c_int32(chunk.shape[0]), ctypes.c_int32(F),
            ctypes.c_int32(start)))
    _set_label(lib, ds, y)

    names = [b"f%d" % i for i in range(F)]
    arr = (ctypes.c_char_p * F)(*names)
    _check(lib, lib.LGBM_DatasetSetFeatureNames(ds, arr, ctypes.c_int(F)))
    bufs = [ctypes.create_string_buffer(255) for _ in range(F)]
    outp = (ctypes.c_char_p * F)(*[ctypes.cast(b, ctypes.c_char_p)
                                   for b in bufs])
    n_names = ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetFeatureNames(ds, outp,
                                                ctypes.byref(n_names)))
    assert n_names.value == F and bufs[3].value == b"f3"

    flen, fptr, ftype = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetField(ds, b"label", ctypes.byref(flen),
                                         ctypes.byref(fptr),
                                         ctypes.byref(ftype)))
    assert flen.value == N and ftype.value == 0
    got = np.ctypeslib.as_array(
        ctypes.cast(fptr, ctypes.POINTER(ctypes.c_float)), shape=(N,))
    np.testing.assert_array_equal(got, y)

    idx = np.arange(0, N, 2, dtype=np.int32)
    sub = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetGetSubset(
        ds, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(len(idx)), params, ctypes.byref(sub)))
    snd = ctypes.c_int()
    _check(lib, lib.LGBM_DatasetGetNumData(sub, ctypes.byref(snd)))
    assert snd.value == len(idx)

    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    nfeat = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetNumFeature(bst, ctypes.byref(nfeat)))
    assert nfeat.value == F
    fin = ctypes.c_int()
    score = np.zeros(N, np.float64)
    for _ in range(4):
        p = 1.0 / (1.0 + np.exp(-score))
        grad = (p - y).astype(np.float32)
        hess = (p * (1 - p)).astype(np.float32)
        _check(lib, lib.LGBM_BoosterUpdateOneIterCustom(
            bst, grad.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            hess.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.byref(fin)))
        plen = ctypes.c_int64()
        _check(lib, lib.LGBM_BoosterGetNumPredict(bst, ctypes.c_int(0),
                                                  ctypes.byref(plen)))
        assert plen.value == N
        _check(lib, lib.LGBM_BoosterGetPredict(bst, ctypes.c_int(0),
                                               ctypes.byref(plen),
                                               _f64p(score)))
    np.testing.assert_allclose(score, _predict(lib, bst, X, 1), rtol=1e-5,
                               atol=1e-6)

    elen = ctypes.c_int()
    nslots = max(F, 8)
    ebufs = [ctypes.create_string_buffer(255) for _ in range(nslots)]
    eoutp = (ctypes.c_char_p * nslots)(*[ctypes.cast(b, ctypes.c_char_p)
                                         for b in ebufs])
    _check(lib, lib.LGBM_BoosterGetEvalNames(bst, ctypes.byref(elen), eoutp))
    assert elen.value == 1 and ebufs[0].value == b"auc"
    _check(lib, lib.LGBM_BoosterGetFeatureNames(bst, ctypes.byref(elen),
                                                eoutp))
    assert elen.value == F and ebufs[2].value == b"f2"

    leaf = ctypes.c_double()
    _check(lib, lib.LGBM_BoosterGetLeafValue(bst, ctypes.c_int(0),
                                             ctypes.c_int(0),
                                             ctypes.byref(leaf)))
    _check(lib, lib.LGBM_BoosterSetLeafValue(bst, ctypes.c_int(0),
                                             ctypes.c_int(0),
                                             ctypes.c_double(leaf.value)))
    cnt = ctypes.c_int64()
    _check(lib, lib.LGBM_BoosterCalcNumPredict(
        bst, ctypes.c_int(100), ctypes.c_int(0), ctypes.c_int(-1),
        ctypes.byref(cnt)))
    assert cnt.value == 100
    dlen = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterDumpModel(bst, ctypes.c_int(-1),
                                          ctypes.c_int(0), ctypes.byref(dlen),
                                          None))
    dbuf = ctypes.create_string_buffer(dlen.value)
    _check(lib, lib.LGBM_BoosterDumpModel(bst, ctypes.c_int(-1), dlen,
                                          ctypes.byref(dlen), dbuf))
    assert dbuf.value.decode().lstrip().startswith("{")

    _check(lib, lib.LGBM_BoosterResetParameter(bst, b"learning_rate=0.05"))
    other = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(other)))
    _check(lib, lib.LGBM_BoosterUpdateOneIter(other, ctypes.byref(fin)))
    _check(lib, lib.LGBM_BoosterMerge(bst, other))
    it = ctypes.c_int()
    _check(lib, lib.LGBM_BoosterGetCurrentIteration(bst, ctypes.byref(it)))
    assert it.value == 5
    _check(lib, lib.LGBM_BoosterRollbackOneIter(bst))

    data_path = str(tmp_path / "pred.tsv")
    np.savetxt(data_path, np.column_stack([y, X]), delimiter="\t",
               fmt="%.17g")
    result_path = str(tmp_path / "preds.txt")
    _check(lib, lib.LGBM_BoosterPredictForFile(
        bst, data_path.encode(), ctypes.c_int(0), ctypes.c_int(0),
        ctypes.c_int(-1), b"", result_path.encode()))
    preds = np.loadtxt(result_path)
    np.testing.assert_allclose(preds, _predict(lib, bst, X), rtol=1e-8)

    lib.LGBM_SetLastError(b"custom message")
    assert lib.LGBM_GetLastError() == b"custom message"
    for h in (other, bst):
        _check(lib, lib.LGBM_BoosterFree(h))
    for d in (sub, ds, ds0):
        _check(lib, lib.LGBM_DatasetFree(d))


def test_c_abi_streaming_and_csc(lib):
    """Sampled-column create (double**/int**), CSR row pushes, CSC
    predict, reset-training-data, and a missing field as an error."""
    rng = np.random.default_rng(8)
    n, f = 600, 5
    X = np.ascontiguousarray(rng.normal(size=(n, f)))
    y = (X[:, 0] > 0).astype(np.float32)
    params = b"objective=binary num_leaves=7 max_bin=31 verbose=-1"
    col_arrays = [np.ascontiguousarray(X[:, c]) for c in range(f)]
    idx_arrays = [np.arange(n, dtype=np.int32) for _ in range(f)]
    col_ptrs = (ctypes.POINTER(ctypes.c_double) * f)(
        *[_f64p(a) for a in col_arrays])
    idx_ptrs = (ctypes.POINTER(ctypes.c_int) * f)(
        *[a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
          for a in idx_arrays])
    per_col = (ctypes.c_int * f)(*([n] * f))
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromSampledColumn(
        col_ptrs, idx_ptrs, ctypes.c_int32(f), per_col, ctypes.c_int32(n),
        ctypes.c_int32(n), params, ctypes.byref(ds)))

    def csr_of(rows):
        indptr, cols, vals = [0], [], []
        for i in range(rows.shape[0]):
            nz = np.nonzero(rows[i])[0]
            cols.extend(nz.tolist())
            vals.extend(rows[i, nz].tolist())
            indptr.append(len(cols))
        return (np.asarray(indptr, np.int32), np.asarray(cols, np.int32),
                np.asarray(vals, np.float64))

    half = n // 2
    for start, chunk in ((0, X[:half]), (half, X[half:])):
        indptr, cols, vals = csr_of(np.ascontiguousarray(chunk))
        _check(lib, lib.LGBM_DatasetPushRowsByCSR(
            ds, _ptr(indptr), ctypes.c_int(I32),
            cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _ptr(vals), ctypes.c_int(F64), ctypes.c_int64(len(indptr)),
            ctypes.c_int64(len(vals)), ctypes.c_int64(f),
            ctypes.c_int64(start)))
    _set_label(lib, ds, y)
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(3):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))

    colptr, rows_i, vals_c = [0], [], []
    for c in range(f):
        nz = np.nonzero(X[:, c])[0]
        rows_i.extend(nz.tolist())
        vals_c.extend(X[nz, c].tolist())
        colptr.append(len(rows_i))
    colptr = np.asarray(colptr, np.int32)
    rows_i = np.asarray(rows_i, np.int32)
    vals_c = np.asarray(vals_c, np.float64)
    out_len = ctypes.c_int64()
    preds = np.zeros(n, np.float64)
    _check(lib, lib.LGBM_BoosterPredictForCSC(
        bst, _ptr(colptr), ctypes.c_int(I32),
        rows_i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _ptr(vals_c), ctypes.c_int(F64), ctypes.c_int64(len(colptr)),
        ctypes.c_int64(len(vals_c)), ctypes.c_int64(n), ctypes.c_int(0),
        ctypes.c_int(-1), b"", ctypes.byref(out_len), _f64p(preds)))
    assert out_len.value == n
    np.testing.assert_allclose(preds, _predict(lib, bst, X), rtol=1e-9)

    ds2 = _dataset(lib, X, params)
    _set_label(lib, ds2, y)
    _check(lib, lib.LGBM_BoosterResetTrainingData(bst, ds2))
    _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))

    flen, fptr, ftype = ctypes.c_int(), ctypes.c_void_p(), ctypes.c_int()
    rc = lib.LGBM_DatasetGetField(ds2, b"weight", ctypes.byref(flen),
                                  ctypes.byref(fptr), ctypes.byref(ftype))
    assert rc != 0 and b"not found" in lib.LGBM_GetLastError().lower()
    _check(lib, lib.LGBM_BoosterFree(bst))
    _check(lib, lib.LGBM_DatasetFree(ds2))
    _check(lib, lib.LGBM_DatasetFree(ds))


def test_c_abi_csr_create_and_predict(lib):
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(800, 12))
    dense[rng.random(dense.shape) > 0.15] = 0.0
    y = (dense[:, 0] + dense[:, 1] > 0).astype(np.float32)
    indptr, cols, vals = [0], [], []
    for i in range(dense.shape[0]):
        nz = np.nonzero(dense[i])[0]
        cols.extend(nz.tolist())
        vals.extend(dense[i, nz].tolist())
        indptr.append(len(cols))
    indptr = np.asarray(indptr, np.int32)
    cols = np.asarray(cols, np.int32)
    vals = np.asarray(vals, np.float64)
    params = b"objective=binary num_leaves=15 max_bin=63 verbose=-1"
    ds = ctypes.c_void_p()
    _check(lib, lib.LGBM_DatasetCreateFromCSR(
        _ptr(indptr), ctypes.c_int(I32),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _ptr(vals),
        ctypes.c_int(F64), ctypes.c_int64(len(indptr)),
        ctypes.c_int64(len(vals)), ctypes.c_int64(12), params, None,
        ctypes.byref(ds)))
    _set_label(lib, ds, y)
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(4):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    out_len = ctypes.c_int64()
    preds = np.zeros(len(y), np.float64)
    _check(lib, lib.LGBM_BoosterPredictForCSR(
        bst, _ptr(indptr), ctypes.c_int(I32),
        cols.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _ptr(vals),
        ctypes.c_int(F64), ctypes.c_int64(len(indptr)),
        ctypes.c_int64(len(vals)), ctypes.c_int64(12), ctypes.c_int(0),
        ctypes.c_int(-1), b"", ctypes.byref(out_len), _f64p(preds)))
    assert out_len.value == len(y)
    np.testing.assert_allclose(
        preds, _predict(lib, bst, np.ascontiguousarray(dense)), rtol=1e-9)

    bad = ctypes.c_void_p(987654)
    rc = lib.LGBM_BoosterUpdateOneIter(bad, ctypes.byref(fin))
    assert rc != 0 and b"handle" in lib.LGBM_GetLastError().lower()


def test_c_abi_trains_the_jax_trees(lib):
    """The ABI's booster on the oracle config against the JAX package's
    c_api: structure exact; leaf values to its f32 onehot run within
    rtol 1e-5, atol 1e-5 x the largest leaf."""
    rng = np.random.default_rng(0)
    X = np.ascontiguousarray(rng.normal(size=(2000, 8)))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    common = ("objective=binary verbose=-1 num_leaves=15 max_bin=63 "
              "tpu_growth=wave tpu_wave_width=32 ")
    oracle = ("tpu_histogram_mode=pallas_ct tpu_pallas_interpret=true "
              "tpu_hist_precision=hilo")
    ds = _dataset(lib, X, b"max_bin=63 verbose=-1")
    _set_label(lib, ds, y)
    bst = ctypes.c_void_p()
    _check(lib, lib.LGBM_BoosterCreate(ds, (common + oracle).encode(),
                                       ctypes.byref(bst)))
    fin = ctypes.c_int()
    for _ in range(4):
        _check(lib, lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    port = _model_string(lib, bst)

    def jax_text(more):
        h = jc_api.LGBM_DatasetCreateFromMat(X, "max_bin=63 verbose=-1",
                                             label=y)
        b = jc_api.LGBM_BoosterCreate(h, common + more)
        for _ in range(4):
            jc_api.LGBM_BoosterUpdateOneIter(b)
        return jc_api.LGBM_BoosterSaveModelToString(b)

    jax_oracle = jax_text(oracle)
    f32 = jax_text("tpu_histogram_mode=onehot")

    def structure(text):
        return [ln for ln in text.splitlines() if ln.startswith(STRUCTURE)]

    def leaves(text):
        return np.concatenate([np.array(ln.split("=")[1].split(), float)
                               for ln in text.splitlines()
                               if ln.startswith("leaf_value")])

    assert structure(port) == structure(jax_oracle) == structure(f32)
    ref = leaves(f32)
    np.testing.assert_allclose(leaves(port), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_c_abi_in_a_fresh_process_imports_no_jax(tmp_path):
    """A C host's view: the library, loaded into a Python process that
    imported nothing, trains through the port alone."""
    import json
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import ctypes, json, sys\n"
        "import numpy as np\n"
        "from lightgbm_tpu_torch import capi_lib\n"
        "lib = capi_lib.load()\n"
        "assert lib.LGBM_SetDevice(b'cpu') == 0\n"
        "X = np.ascontiguousarray(np.random.default_rng(1).normal("
        "size=(300, 4)))\n"
        "ds = ctypes.c_void_p()\n"
        "rc = lib.LGBM_DatasetCreateFromMat(X.ctypes.data_as("
        "ctypes.c_void_p), 1, 300, 4, 1, b'verbose=-1', None, "
        "ctypes.byref(ds))\n"
        "assert rc == 0, lib.LGBM_GetLastError()\n"
        "y = (X[:, 0] > 0).astype(np.float32)\n"
        "assert lib.LGBM_DatasetSetField(ds, b'label', y.ctypes.data_as("
        "ctypes.c_void_p), ctypes.c_int64(300), 0) == 0\n"
        "b = ctypes.c_void_p(); fin = ctypes.c_int()\n"
        "assert lib.LGBM_BoosterCreate(ds, b'objective=binary "
        "verbose=-1', ctypes.byref(b)) == 0\n"
        "assert lib.LGBM_BoosterUpdateOneIter(b, ctypes.byref(fin)) == 0\n"
        "maps = open('/proc/self/maps').read()\n"
        "print(json.dumps([sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'lightgbm_tpu' or "
        "m.startswith('lightgbm_tpu.')), 'liblgbm_tpu_torch_capi_' in "
        "maps]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         env=dict(os.environ, PYTHONPATH=repo),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    mods, mapped = json.loads(out.stdout.strip().splitlines()[-1])
    assert mods == [] and mapped
