"""ctypes bridge to the port's host data plane (``csrc/host/native.cpp``).

The JAX package's ``native.py`` loads a library its build script made
beforehand.  The port keeps its own copy of the sources and builds
them on first use with the host C++ compiler (``$CXX``, ``c++`` or
``g++``; no ``nvcc``) into ``_build/``, naming the library by a digest of
the sources and flags, as ``_build.py`` names the CUDA library.  Nothing
is built or loaded at import time.

Every call site keeps its pure-Python fallback.  The fallback runs only
when no C++ compiler is found (one warning in the log); a compile, link
or load error of the port's own source raises, naming the command and
its output.  ``disabled()`` runs a block on the fallback on purpose (the
tests and chip_smoke.py hold the two against each other).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from .utils.log import LightGBMError, Log

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc" / "host"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-fno-math-errno", "-std=c++17", "-shared", "-fPIC"]
OPENMP_FLAG = "-fopenmp"

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
# path of the loaded library (None before the first use or without a
# compiler)
lib_path: Optional[Path] = None

_c_double_p = ctypes.POINTER(ctypes.c_double)


def _cpp_sources():
    """The library's C++ sources: every .cpp of SOURCE_DIR but the C ABI
    bridge, which capi_lib.py builds into a library of its own."""
    return sorted(p for p in SOURCE_DIR.glob("*.cpp")
                  if p.name != "capi_bridge.cpp")


def _sources():
    return _cpp_sources() + sorted(SOURCE_DIR.glob("*.h"))


def _compiler() -> Optional[str]:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def _digest() -> str:
    h = hashlib.sha256()
    for s in _sources():
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(CXX_FLAGS + [OPENMP_FLAG]).encode())
    return h.hexdigest()[:16]


def build() -> Optional[Path]:
    """Compile the library if it is missing; its path, or None when no
    C++ compiler is found.  With ``-fopenmp`` where the compiler takes
    it; any other failure raises."""
    so = BUILD_DIR / ("liblgbt_native_%s.so" % _digest())
    if so.exists():
        return so
    cxx = _compiler()
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("%s.%d" % (so.name, os.getpid()))
    srcs = [str(s) for s in _cpp_sources()]
    logs = []
    for extra in ([OPENMP_FLAG], []):
        cmd = [cxx, *CXX_FLAGS, *extra, *srcs, "-o", str(tmp)]
        out = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        logs.append("$ %s\n%s" % (" ".join(cmd), out.stdout))
        if out.returncode == 0:
            os.replace(tmp, so)
            return so
    tmp.unlink(missing_ok=True)
    raise LightGBMError("building the host library failed:\n%s"
                        % "\n".join(logs))


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library (built on first call), or None without a C++
    compiler."""
    global _LIB, _TRIED, lib_path
    if _TRIED:
        return _LIB
    with _lock:
        if _TRIED:
            return _LIB
        path = build()
        if path is None:
            Log.warning("no C++ compiler found (CXX, c++, g++): binning, "
                        "parsing and host prediction run in pure Python")
        else:
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise LightGBMError("loading %s failed: %s" % (path, e))
            lib.LGBMTPU_FindBinNumerical.restype = ctypes.c_int
            lib.LGBMTPU_ValueToBin.restype = ctypes.c_int
            lib.LGBMTPU_ParseFile.restype = ctypes.c_int
            lib.LGBMTPU_PredictRaw.restype = ctypes.c_int
            lib.LGBMTPU_Free.restype = None
            _LIB, lib_path = lib, path
        _TRIED = True
    return _LIB


def available() -> bool:
    return get_lib() is not None


@contextlib.contextmanager
def disabled():
    """Run the block on the pure-Python fallbacks."""
    global _LIB, _TRIED
    get_lib()
    saved = _LIB, _TRIED
    _LIB, _TRIED = None, True
    try:
        yield
    finally:
        _LIB, _TRIED = saved


def _np_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def find_bin_numerical(values: np.ndarray, total_cnt: int, max_bin: int,
                       min_data_in_bin: int, min_split_data: int):
    """Native FindBin; returns (upper_bounds, is_trivial, min_val, max_val,
    default_bin, sparse_rate) or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.float64)
    out_bounds = np.empty(max(max_bin, 2), dtype=np.float64)
    num_bin = ctypes.c_int32()
    trivial = ctypes.c_int32()
    vmin = ctypes.c_double()
    vmax = ctypes.c_double()
    default_bin = ctypes.c_int32()
    sparse_rate = ctypes.c_double()
    rc = lib.LGBMTPU_FindBinNumerical(
        _np_ptr(values, ctypes.c_double), ctypes.c_int32(len(values)),
        ctypes.c_int32(total_cnt), ctypes.c_int32(max_bin),
        ctypes.c_int32(min_data_in_bin), ctypes.c_int32(min_split_data),
        _np_ptr(out_bounds, ctypes.c_double), ctypes.byref(num_bin),
        ctypes.byref(trivial), ctypes.byref(vmin), ctypes.byref(vmax),
        ctypes.byref(default_bin), ctypes.byref(sparse_rate))
    if rc != 0:
        return None
    return (out_bounds[:num_bin.value].copy(), bool(trivial.value),
            vmin.value, vmax.value, default_bin.value, sparse_rate.value)


def value_to_bin(upper_bounds: np.ndarray, values: np.ndarray):
    """Numerical value -> bin by binary search over the upper bounds
    (int64, values' shape), or None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    upper_bounds = np.ascontiguousarray(upper_bounds, dtype=np.float64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(values.size, dtype=np.uint16)
    rc = lib.LGBMTPU_ValueToBin(
        _np_ptr(upper_bounds, ctypes.c_double),
        ctypes.c_int32(len(upper_bounds)),
        _np_ptr(values, ctypes.c_double), ctypes.c_int64(values.size),
        _np_ptr(out, ctypes.c_uint16))
    if rc != 0:
        return None
    return out.reshape(values.shape).astype(np.int64)


def parse_file(path: str, has_header: bool, label_idx: int):
    """Native file parse -> (features, label) or None."""
    lib = get_lib()
    if lib is None:
        return None
    rows = ctypes.c_int64()
    cols = ctypes.c_int32()
    feat_p = _c_double_p()
    lab_p = _c_double_p()
    rc = lib.LGBMTPU_ParseFile(str(path).encode(),
                               ctypes.c_int32(int(has_header)),
                               ctypes.c_int32(label_idx), ctypes.byref(rows),
                               ctypes.byref(cols), ctypes.byref(feat_p),
                               ctypes.byref(lab_p))
    if rc != 0:
        return None
    n, f = rows.value, cols.value
    feat = np.ctypeslib.as_array(feat_p, shape=(n, f)).copy()
    lab = np.ctypeslib.as_array(lab_p, shape=(n,)).copy()
    lib.LGBMTPU_Free(feat_p)
    lib.LGBMTPU_Free(lab_p)
    return feat, lab


def predict_raw(trees, n_class: int,
                features: np.ndarray) -> Optional[np.ndarray]:
    """Ensemble raw scores (N, n_class) in float64 through the native
    traversal, each tree added in list order (the Python loop's order,
    so the sums are the same bits), or None when the library is
    unavailable.

    trees: list of (models.Tree, class_id).
    """
    lib = get_lib()
    if lib is None or not trees:
        return None
    node_offsets = [0]
    leaf_offsets = [0]
    sf, th, dt, dv, lc, rc_, lv, tc = [], [], [], [], [], [], [], []
    for tree, cls in trees:
        ni = max(tree.num_leaves - 1, 0)
        nl = tree.num_leaves
        sf.append(tree.split_feature[:ni])
        th.append(tree.threshold[:ni])
        dt.append(tree.decision_type[:ni])
        dv.append(tree.default_value[:ni])
        lc.append(tree.left_child[:ni])
        rc_.append(tree.right_child[:ni])
        lv.append(tree.leaf_value[:nl])
        tc.append(cls)
        node_offsets.append(node_offsets[-1] + ni)
        leaf_offsets.append(leaf_offsets[-1] + nl)
    features = np.ascontiguousarray(features, dtype=np.float64)
    n, f = features.shape
    out = np.zeros((n, n_class), dtype=np.float64)

    def cat(arrs, dtype):
        return np.ascontiguousarray(
            np.concatenate(arrs) if arrs else np.empty(0), dtype=dtype)

    rc = lib.LGBMTPU_PredictRaw(
        ctypes.c_int32(len(trees)),
        _np_ptr(np.asarray(node_offsets, np.int64), ctypes.c_int64),
        _np_ptr(np.asarray(leaf_offsets, np.int64), ctypes.c_int64),
        _np_ptr(cat(sf, np.int32), ctypes.c_int32),
        _np_ptr(cat(th, np.float64), ctypes.c_double),
        _np_ptr(cat(dt, np.int8), ctypes.c_int8),
        _np_ptr(cat(dv, np.float64), ctypes.c_double),
        _np_ptr(cat(lc, np.int32), ctypes.c_int32),
        _np_ptr(cat(rc_, np.int32), ctypes.c_int32),
        _np_ptr(cat(lv, np.float64), ctypes.c_double),
        _np_ptr(np.asarray(tc, np.int32), ctypes.c_int32),
        ctypes.c_int32(n_class),
        _np_ptr(features, ctypes.c_double), ctypes.c_int64(n),
        ctypes.c_int32(f), _np_ptr(out, ctypes.c_double))
    if rc != 0:
        return None
    return out
