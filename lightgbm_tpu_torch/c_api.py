"""LGBM_*-shaped stable API surface: handle-based, as
include/LightGBM/c_api.h:37-719, over the port's ``basic.Dataset`` and
``Booster`` (the JAX package's ``c_api.py``).

The same function names and shapes operate on an in-process handle
registry, so code written against the C API (dataset from file or
matrix, push fields and rows, booster create/update/eval/predict, model
save/load) ports over; arguments that are raw C pointers in C take numpy
arrays here.  The ``_abi_*`` adapters at the end take raw caller memory
from the port's C ABI library (csrc/host/capi_bridge.cpp, built by
``capi_lib.py``), which forwards each exported ``LGBM_*`` symbol here.

Boosters train and predict on the card unless the caller asks for the
CPU: ``device_type=cpu`` (or ``device=cpu``) in a booster's parameters,
or ``LGBM_SetDevice("cpu")`` for the boosters created after it (a
model file or string carries no parameters).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .basic import Booster, Dataset
from .utils.config import key_alias_transform
from .utils.log import LightGBMError

_handles: Dict[int, Any] = {}
_next_handle = itertools.count(1)
# the device of boosters whose parameters name none (LGBM_SetDevice)
_device: List[str] = ["cuda"]


def LGBM_SetDevice(device: str) -> int:
    """The device ("cuda", "cuda:N" or "cpu") of the boosters created
    from now on whose parameters do not name one.  Not part of the
    reference C API: the port trains on the card unless asked not to."""
    if torch.device(str(device)).type not in ("cuda", "cpu"):
        raise LightGBMError("unsupported device %r (expected cuda or cpu)"
                            % str(device))
    _device[0] = str(device)
    return 0


def _booster_device(params: dict) -> str:
    for key in ("device_type", "device"):
        if str(params.get(key, "")).lower() == "cpu":
            return "cpu"
    return _device[0]


def _register(obj) -> int:
    h = next(_next_handle)
    _handles[h] = obj
    return h


def _get(handle: int):
    if handle not in _handles:
        raise LightGBMError("Invalid handle %s" % handle)
    obj = _handles[handle]
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "pushing":
        raise LightGBMError(
            "Dataset %s is still streaming: %d of %d declared rows pushed "
            "(LGBM_DatasetPushRows)" % (
                handle, sum(len(r) for r in obj[1]["rows"]),
                obj[1]["num_total_row"]))
    return obj


def _get_pushing(handle: int):
    if handle not in _handles:
        raise LightGBMError("Invalid handle %s" % handle)
    return _handles[handle]


def _csr_to_dense(indptr, indices, data, num_col: int) -> np.ndarray:
    """Small-chunk densify (streaming push-rows only; bulk creation goes
    through the sparse path, io/sparse.py)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    n = len(indptr) - 1
    mat = np.zeros((n, num_col), dtype=np.float64)
    rows = np.repeat(np.arange(n), np.diff(indptr))
    mat[rows, np.asarray(indices, dtype=np.int64)] = \
        np.asarray(data, dtype=np.float64)
    return mat


def _csc_to_dense(colptr, indices, data, num_row: int) -> np.ndarray:
    colptr = np.asarray(colptr, dtype=np.int64)
    num_col = len(colptr) - 1
    mat = np.zeros((num_row, num_col), dtype=np.float64)
    cols = np.repeat(np.arange(num_col), np.diff(colptr))
    mat[np.asarray(indices, dtype=np.int64), cols] = \
        np.asarray(data, dtype=np.float64)
    return mat


def _parse_params(parameters: str) -> dict:
    out = {}
    for tok in (parameters or "").split():
        if "=" in tok:
            k, _, v = tok.partition("=")
            out[k] = v
    return out


# ---------------------------------------------------------------- datasets

def LGBM_DatasetCreateFromFile(filename: str, parameters: str = "",
                               reference: Optional[int] = None) -> int:
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(filename, params=params, reference=ref)
    ds.construct()
    return _register(ds)


def LGBM_DatasetCreateFromMat(data, parameters: str = "",
                              reference: Optional[int] = None,
                              label=None) -> int:
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(np.asarray(data, dtype=np.float64), label=label,
                 params=params, reference=ref, free_raw_data=False)
    ds.construct()
    return _register(ds)


def LGBM_DatasetCreateFromCSR(indptr, indices, data, num_col: int,
                              parameters: str = "",
                              reference: Optional[int] = None) -> int:
    """Sparse create stays sparse (sparse_bin.hpp:68 analog): rows are
    re-sorted to CSC and binned per column — no N x F densification."""
    from .io.sparse import csr_to_csc
    sp = csr_to_csc(indptr, indices, data, num_col)
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(sp, params=params, reference=ref, free_raw_data=False)
    ds.construct()
    return _register(ds)


def LGBM_DatasetCreateFromCSC(colptr, indices, data, num_row: int,
                              parameters: str = "",
                              reference: Optional[int] = None) -> int:
    from .io.sparse import csc_arrays
    sp = csc_arrays(colptr, indices, data, num_row)
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(sp, params=params, reference=ref, free_raw_data=False)
    ds.construct()
    return _register(ds)


def LGBM_DatasetSetField(handle: int, field_name: str, data) -> int:
    _get(handle).set_field(field_name, data)
    return 0


def LGBM_DatasetGetField(handle: int, field_name: str):
    return _get(handle).get_field(field_name)


def LGBM_DatasetGetNumData(handle: int) -> int:
    return _get(handle).num_data()


def LGBM_DatasetGetNumFeature(handle: int) -> int:
    return _get(handle).num_feature()


def LGBM_DatasetSaveBinary(handle: int, filename: str) -> int:
    _get(handle).save_binary(filename)
    return 0


def LGBM_DatasetFree(handle: int) -> int:
    _handles.pop(handle, None)
    # drop pinned GetField pointers for this dataset (C ABI bridge)
    for key in [k for k in _field_cache if k[0] == handle]:
        _field_cache.pop(key, None)
    return 0


# ---------------------------------------------------------------- boosters

def LGBM_BoosterCreate(train_data: int, parameters: str = "") -> int:
    params = _parse_params(parameters)
    bst = Booster(params=params, train_set=_get(train_data),
                  device=_booster_device(params))
    return _register(bst)


def LGBM_BoosterCreateFromModelfile(filename: str) -> int:
    return _register(Booster(model_file=filename, device=_device[0]))


def LGBM_BoosterLoadModelFromString(model_str: str) -> int:
    return _register(Booster(model_str=model_str, device=_device[0]))


def LGBM_BoosterAddValidData(handle: int, valid_data: int) -> int:
    bst = _get(handle)
    bst.add_valid(_get(valid_data), "valid_%d" % len(bst.name_valid_sets))
    return 0


def LGBM_BoosterUpdateOneIter(handle: int) -> int:
    """Returns 1 when training should stop (c_api.cpp:149 semantics)."""
    return int(_get(handle).update())


def LGBM_BoosterUpdateOneIterCustom(handle: int, grad, hess) -> int:
    return int(_get(handle)._boost(grad, hess))


def LGBM_BoosterRollbackOneIter(handle: int) -> int:
    _get(handle).rollback_one_iter()
    return 0


def LGBM_BoosterGetCurrentIteration(handle: int) -> int:
    return _get(handle).current_iteration()


def LGBM_BoosterGetEval(handle: int, data_idx: int) -> List[float]:
    return _get(handle)._gbdt.get_eval_at(data_idx)


def LGBM_BoosterGetEvalNames(handle: int) -> List[str]:
    return _get(handle)._gbdt.eval_names(0)


def LGBM_BoosterGetNumClasses(handle: int) -> int:
    return _get(handle)._gbdt.num_class


def LGBM_BoosterPredictForMat(handle: int, data, predict_type: int = 0,
                              num_iteration: int = -1):
    """predict_type: 0 normal, 1 raw score, 2 leaf index (c_api.h).

    The serving entry: per-request latency and batch size land in the
    metrics registry via Booster.predict (obs/metrics.py; the CSR/CSC
    variants route through here a dense chunk at a time).  Scrape via
    LGBM_MetricsScrape.
    """
    bst = _get(handle)
    return bst.predict(np.asarray(data, dtype=np.float64),
                       num_iteration=num_iteration,
                       raw_score=predict_type == 1,
                       pred_leaf=predict_type == 2)


def LGBM_MetricsScrape(fmt: str = "prometheus") -> str:
    """Process-global metrics registry export: 'prometheus' textfile
    format or 'json'.  Not part of the reference C API — the hook a
    serving wrapper exposes on its /metrics endpoint."""
    from .obs.metrics import REGISTRY
    if fmt == "prometheus":
        return REGISTRY.to_prometheus()
    if fmt == "json":
        return REGISTRY.to_json()
    raise LightGBMError("LGBM_MetricsScrape: unknown format %r "
                        "(expected prometheus/json)" % (fmt,))


def LGBM_BoosterPredictForFile(handle: int, data_filename: str,
                               data_has_header: bool, result_filename: str,
                               predict_type: int = 0,
                               num_iteration: int = -1) -> int:
    bst = _get(handle)
    out = bst.predict(data_filename, data_has_header=data_has_header,
                      num_iteration=num_iteration,
                      raw_score=predict_type == 1,
                      pred_leaf=predict_type == 2)
    out = np.asarray(out)
    with open(result_filename, "w") as f:
        if out.ndim == 1:
            for v in out:
                f.write("%.9g\n" % v)
        else:
            for row in out:
                f.write("\t".join("%.9g" % v for v in row) + "\n")
    return 0


def LGBM_BoosterSaveModel(handle: int, num_iteration: int, filename: str) -> int:
    _get(handle).save_model(filename, num_iteration=num_iteration)
    return 0


def LGBM_BoosterSaveModelToString(handle: int, num_iteration: int = -1) -> str:
    return _get(handle).model_to_string(num_iteration=num_iteration)


def LGBM_BoosterDumpModel(handle: int, num_iteration: int = -1) -> str:
    import json
    return json.dumps(_get(handle).dump_model(num_iteration=num_iteration))


def LGBM_BoosterGetLeafValue(handle: int, tree_idx: int, leaf_idx: int) -> float:
    gbdt = _get(handle)._gbdt
    gbdt._materialize()
    return float(gbdt.models[tree_idx].leaf_value[leaf_idx])


def LGBM_BoosterSetLeafValue(handle: int, tree_idx: int, leaf_idx: int,
                             val: float) -> int:
    gbdt = _get(handle)._gbdt
    gbdt._materialize()
    gbdt.models[tree_idx].leaf_value[leaf_idx] = val
    gbdt._models_changed()          # the device predictor follows
    return 0


def LGBM_BoosterFeatureImportance(handle: int, num_iteration: int = -1):
    return _get(handle)._gbdt.feature_importance()


def LGBM_BoosterFree(handle: int) -> int:
    _handles.pop(handle, None)
    return 0


# ------------------------------------------------- error handling (c_api.h)

_last_error: List[str] = [""]


def LGBM_SetLastError(msg: str) -> None:
    _last_error[0] = str(msg)


def LGBM_GetLastError() -> str:
    return _last_error[0]


def LGBM_APIHandleException(ex) -> int:
    """Reference macro API_END catch-all (c_api.cpp): record and return -1."""
    LGBM_SetLastError(str(ex))
    return -1


# --------------------------------------------- remaining dataset functions

def LGBM_DatasetCreateByReference(reference: int, num_total_row: int) -> int:
    """Empty dataset aligned to a reference for row streaming
    (c_api.h LGBM_DatasetCreateByReference + PushRows protocol)."""
    ds = {"reference": _get(reference), "num_total_row": int(num_total_row),
          "rows": []}     # list of (start_row, chunk) — any push order
    return _register(("pushing", ds))


def LGBM_DatasetPushRows(handle: int, data, start_row: int = -1) -> int:
    """Chunks may arrive in any order (multi-threaded producers push with
    explicit start_row, c_api.h:120-140); start_row=-1 appends after the
    last pushed row."""
    obj = _get_pushing(handle)
    if not (isinstance(obj, tuple) and obj[0] == "pushing"):
        raise LightGBMError("Dataset was not created for row pushing")
    _, ds = obj
    chunk = np.asarray(data, dtype=np.float64)
    if start_row is None or start_row < 0:
        start_row = sum(len(c) for _, c in ds["rows"])
    start_row = int(start_row)
    n_total = ds["num_total_row"]
    if start_row + len(chunk) > n_total:
        raise LightGBMError(
            "PushRows chunk [%d, %d) exceeds num_total_row=%d"
            % (start_row, start_row + len(chunk), n_total))
    # finalize only when every row is covered exactly once — a duplicate
    # start_row must not trigger premature finalization with zero-filled
    # holes, nor silently overwrite previously pushed rows
    covered = ds.setdefault("covered", np.zeros(n_total, dtype=bool))
    if covered[start_row:start_row + len(chunk)].any():
        raise LightGBMError(
            "PushRows chunk [%d, %d) overlaps previously pushed rows"
            % (start_row, start_row + len(chunk)))
    covered[start_row:start_row + len(chunk)] = True
    ds["rows"].append((start_row, chunk))
    if covered.all():
        _finish_push(handle, ds)
    return 0


def LGBM_DatasetPushRowsByCSR(handle: int, indptr, indices, data,
                              num_col: int, start_row: int = -1) -> int:
    return LGBM_DatasetPushRows(handle,
                                _csr_to_dense(indptr, indices, data, num_col),
                                start_row)


def _finish_push(handle: int, ds: dict) -> None:
    n = ds["num_total_row"]
    f = ds["rows"][0][1].shape[1]
    mat = np.zeros((n, f), dtype=np.float64)
    for start, chunk in ds["rows"]:
        end = min(start + len(chunk), n)
        mat[start:end] = chunk[:end - start]
    out = Dataset(mat, reference=ds["reference"], free_raw_data=False)
    out.construct()
    _handles[handle] = out


def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices,
                                        num_col: int, num_per_col,
                                        num_sample_row: int,
                                        num_total_row: int,
                                        parameters: str = "") -> int:
    """Sampled-column creation (c_api.h:78-101): bin mappers from column
    samples, rows streamed afterwards via LGBM_DatasetPushRows."""
    mat = np.zeros((num_sample_row, num_col), dtype=np.float64)
    for c in range(num_col):
        vals = np.asarray(sample_data[c], dtype=np.float64)
        idx = np.asarray(sample_indices[c], dtype=np.int64)
        mat[idx[:len(vals)], c] = vals
    params = _parse_params(parameters)
    ref = Dataset(mat, params=params, free_raw_data=False)
    ref.construct()
    ds = {"reference": ref, "num_total_row": int(num_total_row), "rows": []}
    return _register(("pushing", ds))


def LGBM_DatasetGetSubset(handle: int, used_row_indices,
                          parameters: str = "") -> int:
    sub = _get(handle).subset(np.asarray(used_row_indices, dtype=np.int64),
                              params=_parse_params(parameters))
    sub.construct()
    return _register(sub)


def LGBM_DatasetSetFeatureNames(handle: int, feature_names: List[str]) -> int:
    ds = _get(handle)
    ds.set_feature_name(list(feature_names))
    return 0


def LGBM_DatasetGetFeatureNames(handle: int) -> List[str]:
    ds = _get(handle)
    ds.construct()
    return list(ds._handle.feature_names)


# --------------------------------------------- remaining booster functions

def LGBM_BoosterMerge(handle: int, other_handle: int) -> int:
    """Merge other's trees into handle (c_api.cpp Booster::MergeFrom)."""
    _get(handle)._gbdt.merge_from(_get(other_handle)._gbdt)
    return 0


def LGBM_BoosterResetParameter(handle: int, parameters: str) -> int:
    bst = _get(handle)
    bst.reset_parameter(key_alias_transform(_parse_params(parameters)))
    return 0


def LGBM_BoosterResetTrainingData(handle: int, train_data: int) -> int:
    bst = _get(handle)
    bst.set_train_data(_get(train_data))
    return 0


def LGBM_BoosterGetNumFeature(handle: int) -> int:
    return int(_get(handle)._gbdt.max_feature_idx + 1)


def LGBM_BoosterGetEvalCounts(handle: int) -> int:
    return len(LGBM_BoosterGetEvalNames(handle))


def LGBM_BoosterCalcNumPredict(handle: int, num_row: int,
                               predict_type: int = 0,
                               num_iteration: int = -1) -> int:
    gbdt = _get(handle)._gbdt
    k = gbdt.num_tree_per_iteration
    if predict_type == 2:    # leaf index: one per tree
        total = len(gbdt.models) // max(k, 1)
        n_iter = min(num_iteration, total) if num_iteration > 0 else total
        return num_row * k * n_iter
    return num_row * k


def LGBM_BoosterGetNumPredict(handle: int, data_idx: int) -> int:
    gbdt = _get(handle)._gbdt
    if data_idx == 0:
        n = gbdt.num_data
    else:
        n = gbdt.valid_data[data_idx - 1].num_data
    return n * gbdt.num_tree_per_iteration


def LGBM_BoosterGetPredict(handle: int, data_idx: int):
    """Raw scores of train (0) or valid set (1..) — c_api GetPredict."""
    gbdt = _get(handle)._gbdt
    if data_idx == 0:
        return np.asarray(gbdt.train_score).reshape(-1).copy()
    return np.asarray(gbdt.valid_score_host(data_idx - 1)).reshape(-1).copy()


def LGBM_BoosterGetFeatureNames(handle: int) -> List[str]:
    return list(_get(handle).feature_name())


def LGBM_BoosterPredictForCSR(handle: int, indptr, indices, data,
                              num_col: int, predict_type: int = 0,
                              num_iteration: int = -1):
    from .io.sparse import csr_to_csc, iter_dense_row_chunks
    sp = csr_to_csc(indptr, indices, data, num_col)
    outs = [LGBM_BoosterPredictForMat(handle, block, predict_type,
                                      num_iteration)
            for _, block in iter_dense_row_chunks(sp)]
    return np.concatenate(outs) if outs else np.zeros(0, dtype=np.float64)


def LGBM_BoosterPredictForCSC(handle: int, colptr, indices, data,
                              num_row: int, predict_type: int = 0,
                              num_iteration: int = -1):
    from .io.sparse import csc_arrays, iter_dense_row_chunks
    sp = csc_arrays(colptr, indices, data, num_row)
    outs = [LGBM_BoosterPredictForMat(handle, block, predict_type,
                                      num_iteration)
            for _, block in iter_dense_row_chunks(sp)]
    return np.concatenate(outs) if outs else np.zeros(0, dtype=np.float64)


# ------------------------------------------------------------- C ABI bridge
# Buffer-based adapters for the port's C ABI library
# (csrc/host/capi_bridge.cpp).  The library embeds CPython and forwards
# each exported LGBM_* symbol here, passing raw caller memory as
# memoryviews; these shims give them numpy form with the C_API_DTYPE_*
# codes of include/LightGBM/c_api.h:16-22.

_DTYPE_BY_CODE = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}


def _np_from_buffer(mv, count, dtype_code, copy=True):
    # COPY by default: the caller's C buffer is only valid for the
    # duration of the call, but datasets/metadata retain arrays
    # (free_raw_data=False, Metadata.set_label) — a view would dangle
    # after the C side frees it.  Pure prediction paths pass copy=False
    # (nothing retains the matrix past the synchronous call).
    arr = np.frombuffer(mv, dtype=_DTYPE_BY_CODE[int(dtype_code)],
                        count=int(count))
    return arr.copy() if copy else arr


def _abi_dataset_from_file(filename, parameters, ref_handle):
    return LGBM_DatasetCreateFromFile(filename, parameters,
                                      ref_handle or None)


def _abi_dataset_from_mat(mv, nrow, ncol, dtype_code, is_row_major,
                          parameters, ref_handle):
    mat = _np_from_buffer(mv, nrow * ncol, dtype_code)
    mat = (mat.reshape(nrow, ncol) if is_row_major
           else mat.reshape(ncol, nrow).T)
    return LGBM_DatasetCreateFromMat(mat, parameters, ref_handle or None)


def _abi_dataset_from_csr(mv_indptr, n_indptr, indptr_code, mv_indices,
                          mv_data, nnz, data_code, num_col, parameters,
                          ref_handle):
    indptr = _np_from_buffer(mv_indptr, n_indptr, indptr_code)
    indices = _np_from_buffer(mv_indices, nnz, 2)
    data = _np_from_buffer(mv_data, nnz, data_code)
    return LGBM_DatasetCreateFromCSR(indptr, indices, data, num_col,
                                     parameters, ref_handle or None)


def _abi_dataset_from_csc(mv_colptr, n_colptr, colptr_code, mv_indices,
                          mv_data, nnz, data_code, num_row, parameters,
                          ref_handle):
    colptr = _np_from_buffer(mv_colptr, n_colptr, colptr_code)
    indices = _np_from_buffer(mv_indices, nnz, 2)
    data = _np_from_buffer(mv_data, nnz, data_code)
    return LGBM_DatasetCreateFromCSC(colptr, indices, data, num_row,
                                     parameters, ref_handle or None)


def _abi_dataset_set_field(handle, field_name, mv, count, dtype_code):
    return LGBM_DatasetSetField(handle, field_name,
                                _np_from_buffer(mv, count, dtype_code))


def _abi_booster_get_eval(handle, data_idx):
    return np.asarray(LGBM_BoosterGetEval(handle, data_idx),
                      dtype=np.float64)


def _abi_booster_predict_mat(handle, mv, nrow, ncol, dtype_code,
                             is_row_major, predict_type, num_iteration):
    mat = _np_from_buffer(mv, nrow * ncol, dtype_code, copy=False)
    mat = (mat.reshape(nrow, ncol) if is_row_major
           else mat.reshape(ncol, nrow).T)
    out = LGBM_BoosterPredictForMat(handle, mat, predict_type,
                                    num_iteration)
    return np.ascontiguousarray(np.asarray(out, dtype=np.float64)
                                .reshape(-1))


def _abi_booster_predict_csr(handle, mv_indptr, n_indptr, indptr_code,
                             mv_indices, mv_data, nnz, data_code, num_col,
                             predict_type, num_iteration):
    indptr = _np_from_buffer(mv_indptr, n_indptr, indptr_code, copy=False)
    indices = _np_from_buffer(mv_indices, nnz, 2, copy=False)
    data = _np_from_buffer(mv_data, nnz, data_code, copy=False)
    out = LGBM_BoosterPredictForCSR(handle, indptr, indices, data, num_col,
                                    predict_type, num_iteration)
    return np.ascontiguousarray(np.asarray(out, dtype=np.float64)
                                .reshape(-1))


def _abi_booster_save_model_string(handle, num_iteration):
    return LGBM_BoosterSaveModelToString(handle, num_iteration)


def _abi_booster_dump_model(handle, num_iteration):
    return LGBM_BoosterDumpModel(handle, num_iteration)


def _abi_dataset_push_rows(handle, mv, nrow, ncol, dtype_code, start_row):
    mat = _np_from_buffer(mv, nrow * ncol, dtype_code).reshape(nrow, ncol)
    return LGBM_DatasetPushRows(handle, mat, start_row)


def _abi_dataset_push_rows_csr(handle, mv_indptr, n_indptr, indptr_code,
                               mv_indices, mv_data, nnz, data_code,
                               num_col, start_row):
    indptr = _np_from_buffer(mv_indptr, n_indptr, indptr_code)
    indices = _np_from_buffer(mv_indices, nnz, 2)
    data = _np_from_buffer(mv_data, nnz, data_code)
    return LGBM_DatasetPushRowsByCSR(handle, indptr, indices, data,
                                     num_col, start_row)


def _abi_dataset_from_sampled(cols, idxs, num_col, num_sample_row,
                              num_total_row, parameters):
    """cols/idxs: per-column memoryviews (f64 values / i32 row indices),
    sized by the C caller from num_per_col."""
    sd = [np.frombuffer(c, dtype=np.float64).copy() for c in cols]
    si = [np.frombuffer(i, dtype=np.int32).copy() for i in idxs]
    return LGBM_DatasetCreateFromSampledColumn(
        sd, si, num_col, [len(x) for x in sd], num_sample_row,
        num_total_row, parameters)


def _abi_dataset_get_subset(handle, mv_indices, count, parameters):
    idx = _np_from_buffer(mv_indices, count, 2)
    return LGBM_DatasetGetSubset(handle, idx, parameters)


# GetField hands out INTERNAL pointers (c_api.h:286-290 semantics); the
# arrays are pinned here so the address outlives the call — freed with the
# dataset (LGBM_DatasetFree clears the registry entry the cache keys on).
_field_cache: dict = {}
_FIELD_CODE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
               np.dtype(np.int32): 2, np.dtype(np.int64): 3}


def _abi_dataset_get_field(handle, field_name):
    """-> (addr, length, dtype_code); addr valid until the next GetField
    of the same field or DatasetFree.  Missing fields are an ERROR, as in
    the reference (success never yields a NULL pointer)."""
    arr = LGBM_DatasetGetField(handle, field_name)
    if arr is None:
        raise LightGBMError("Field %s not found" % field_name)
    arr = np.ascontiguousarray(arr)
    if arr.dtype not in _FIELD_CODE:
        arr = np.ascontiguousarray(arr, dtype=np.float64)
    _field_cache[(handle, field_name)] = arr
    return (int(arr.ctypes.data), int(arr.size), _FIELD_CODE[arr.dtype])


def _abi_booster_train_size(handle):
    """grad/hess element count for UpdateOneIterCustom."""
    gbdt = _get(handle)._gbdt
    return int(gbdt.num_data * max(gbdt.num_tree_per_iteration, 1))


def _abi_booster_update_custom(handle, mv_grad, mv_hess, n):
    grad = _np_from_buffer(mv_grad, n, 0, copy=False)
    hess = _np_from_buffer(mv_hess, n, 0, copy=False)
    return LGBM_BoosterUpdateOneIterCustom(handle, grad, hess)


def _abi_booster_get_predict(handle, data_idx):
    return np.asarray(LGBM_BoosterGetPredict(handle, data_idx),
                      dtype=np.float64)


def _abi_booster_predict_csc(handle, mv_colptr, n_colptr, colptr_code,
                             mv_indices, mv_data, nnz, data_code, num_row,
                             predict_type, num_iteration):
    colptr = _np_from_buffer(mv_colptr, n_colptr, colptr_code, copy=False)
    indices = _np_from_buffer(mv_indices, nnz, 2, copy=False)
    data = _np_from_buffer(mv_data, nnz, data_code, copy=False)
    out = LGBM_BoosterPredictForCSC(handle, colptr, indices, data, num_row,
                                    predict_type, num_iteration)
    return np.ascontiguousarray(np.asarray(out, dtype=np.float64)
                                .reshape(-1))
