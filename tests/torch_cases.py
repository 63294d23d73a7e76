"""Inputs shared by the port's kernel tests (tests/test_torch_*.py): numpy
only, so that the GPU tests can run where JAX is not installed."""
import threading
import time
import warnings

import numpy as np
import pytest
import torch

# how long a module's teardown waits for the threads it started
THREAD_JOIN_S = 10.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module runs (a module imports this
    fixture to take it): the plain CPU paths are many small torch
    operations, which threads slow down, most of all beside the other
    test workers.  At the module's end, every thread it started must
    have stopped (they are joined for up to THREAD_JOIN_S): a
    non-daemon thread left running fails the module, and a daemon one
    warns.  A thread left alive in a test worker is state that a later
    module's fork inherits."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    before = set(threading.enumerate())
    yield
    torch.set_num_threads(threads)
    deadline = time.monotonic() + THREAD_JOIN_S
    left = []
    for th in threading.enumerate():
        if th in before or th is threading.current_thread():
            continue
        th.join(max(0.0, deadline - time.monotonic()))
        if th.is_alive():
            left.append(th)
    if any(not th.daemon for th in left):
        pytest.fail("threads left running: %s"
                    % [th.name for th in left if not th.daemon])
    if left:
        warnings.warn("daemon threads left running: %s"
                      % [th.name for th in left])


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def wave_data(n=2500, f=7, b=14, k=5, seed=0):
    """(X (N, F) uint8, leaf_id, w3 (N, 3) f32, child_id (K,), num_bins)."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b, size=(n, f), dtype=np.uint8)
    leaf_id = rng.integers(0, 2 * k, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(np.float32)
    cid = np.array([0, 2, 4, -1, 7], dtype=np.int32)[:k]
    return X, leaf_id, w3, cid, b


def compact_from_tbl(tbl, w):
    """(cols (W, 10), psrc (W,)) from a dense (L, 10) split table: active
    rows fill the slots in leaf order, the rest get psrc = -3."""
    act = [leaf for leaf in range(len(tbl)) if tbl[leaf, 0] > 0.5]
    cols = np.zeros((w, 10), np.float32)
    psrc = np.full(w, -3, np.int32)
    for j, leaf in enumerate(act):
        cols[j] = tbl[leaf]
        psrc[j] = leaf
    return cols, psrc


def unbundled_case():
    """A wave of three numerical splits and one categorical split."""
    X, _, w3, cid, b = wave_data(n=2500, f=7, b=14, k=5, seed=9)
    rng = np.random.default_rng(10)
    lid = rng.integers(0, 8, size=len(X)).astype(np.int32)
    tbl = np.zeros((16, 10), np.float32)
    for leaf in (1, 3, 5):
        tbl[leaf] = [1, rng.integers(0, X.shape[1]), rng.integers(0, b),
                     0, 0, rng.integers(0, 2), 8 + leaf, 0, 0, 0]
    # a categorical split with a default bin inside the range
    tbl[6] = [1, 2, 4, 1, 4, 1, 15, 0, 0, 0]
    cols, psrc = compact_from_tbl(tbl, w=5)
    return X, lid, w3, cid, b, cols, psrc


def bundled_case():
    """A wave over EFB group columns: offsets, spans and bin adjusts."""
    X, _, w3, cid, b = wave_data(n=2200, f=7, b=14, k=5, seed=15)
    rng = np.random.default_rng(16)
    lid = rng.integers(0, 8, size=len(X)).astype(np.int32)
    tbl = np.zeros((16, 10), np.float32)
    # leaf 2: group column 3, bins [4, 4+6) remap to adj 1, default bin 2
    tbl[2] = [1, 3, 5, 0, 2, 1, 10, 4, 1, 6]
    # leaf 5: group column 1, bins [0, 5), adj 0, default-right
    tbl[5] = [1, 1, 2, 0, 7, 0, 13, 0, 0, 5]
    # leaf 7: categorical on group column 0, bins [3, 9) -> adj 0
    tbl[7] = [1, 0, 2, 1, 0, 0, 11, 3, 0, 6]
    cols, psrc = compact_from_tbl(tbl, w=5)
    cid = np.array([2, 10, 5, -1, 11], np.int32)
    return X, lid, w3, cid, b, cols, psrc


def assert_hist_close(got, want, w3):
    """rtol 1e-5 with atol 1e-5 x max|w|: sums taken in another order."""
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w3).max()))


def sparse_case(n=5000, f=13, b=14, L=12, seed=0, dense_col=3,
                empty_col=7):
    """(X (N, F) uint8 bins, fill (F,), leaf_id, w3) for the sparse store:
    each column sits at its fill bin except ~15% of rows, one column is
    dense (per-column skew) and one is all fill."""
    rng = np.random.default_rng(seed)
    dtype = np.uint8 if b <= 256 else np.uint16
    fill = rng.integers(0, b, size=f)
    X = np.tile(fill, (n, 1)).astype(dtype)
    nz = rng.random((n, f)) < 0.15
    X[nz] = rng.integers(0, b, size=int(nz.sum())).astype(dtype)
    if dense_col is not None:
        X[:, dense_col] = rng.integers(0, b, size=n).astype(dtype)
    if empty_col is not None:
        X[:, empty_col] = fill[empty_col]
    leaf_id = rng.integers(0, L, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(np.float32)
    return X, fill, leaf_id, w3


def sparse_bundled_case(n=4000, seed=4):
    """Group columns laid out as EFB lays them out: three multi-feature
    groups (fill bin 0, 40 bins) and three single-feature groups (fill =
    the feature's default bin), ~10% of rows off the fill."""
    rng = np.random.default_rng(seed)
    b = 40
    fill = np.array([0, 0, 0, 5, 0, 17])
    X = np.tile(fill, (n, 1)).astype(np.uint8)
    nz = rng.random((n, len(fill))) < 0.1
    X[nz] = rng.integers(1, b, size=int(nz.sum())).astype(np.uint8)
    leaf_id = rng.integers(0, 9, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(np.float32)
    return X, fill, leaf_id, w3, b


SCORE_CASES = [(5000, 255), (8192, 31), (777, 7), (300, 1)]


def score_case(n, L, seed=11):
    """(score, leaf ids with out-of-range values, leaf values large enough
    to hit the kMaxTreeOutput clip, scale)."""
    rng = np.random.default_rng(seed + n + L)
    score = rng.normal(size=n).astype(np.float32)
    lid = rng.integers(-1, L + 1, size=n).astype(np.int32)
    lv = (rng.normal(size=L) * 60).astype(np.float32)
    return score, lid, lv, np.float32(1.7)


# (n, f, b, row_mult kind, leaf): row_mult None, with zeros, fractional;
# a leaf with no rows (9); n not a multiple of the JAX kernel's row chunk
LEAF_CASES = [(3000, 7, 14, "none", 1), (2500, 5, 63, "zeros", 2),
              (4097, 9, 31, "fractional", 0), (1500, 4, 255, "fractional", 3),
              (777, 3, 8, "none", 9)]


# B5's forms, (bins, form): byte bins up to 255, two-byte past them, and
# the f64 weights of tpu_use_dp; and the leaf sizes of its tests
LEAF_FORMS = [(63, "byte"), (255, "byte"), (1023, "uint16"), (63, "f64"),
              (255, "f64"), (1023, "f64")]
LEAF_SIZES = ("none", "n/4096", "n/64", "root")


def leaf_size_case(n, f, b, form, size, seed=0):
    """(X (N, F) bins in [0, b] -- uint16 past 256 bins or for the uint16
    form, the bin b itself dropped --, leaf_id, w3 (N, 3) f32 or float64
    with a 0/1 count column, leaf): the leaf holds no row (-1), about N /
    4096 rows (at least one), about N / 64, or every row (the root:
    every id 0)."""
    rng = np.random.default_rng(seed + n + f + b)
    wide_bins = b > 255 or form == "uint16"
    X = rng.integers(0, b + 1, size=(n, f)).astype(
        np.uint16 if wide_bins else np.uint8)
    w3 = rng.normal(size=(n, 3)).astype(
        np.float64 if form == "f64" else np.float32)
    w3[:, 2] = rng.random(n) > 0.2
    if size == "root":
        return X, np.zeros(n, np.int32), w3, 0
    lid = rng.integers(3, 64, size=n).astype(np.int32)
    lid[rng.choice(n, size=max(1, n // 64), replace=False)] = 1
    lid[rng.choice(n, size=max(1, n // 4096), replace=False)] = 2
    return X, lid, w3, {"none": -1, "n/4096": 2, "n/64": 1}[size]


def leaf_case(n, f, b, kind, seed=0):
    """(X (N, F) uint8, grad, hess, leaf_id, row_mult or None) for B5:
    rows spread over leaves 0-3, bins over [0, b]; the bin b itself lies
    past num_bins and must be dropped."""
    rng = np.random.default_rng(seed + n + f + b)
    X = rng.integers(0, b + 1, size=(n, f)).astype(np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32) + 0.1
    lid = rng.integers(0, 4, size=n).astype(np.int32)
    rm = {"none": None,
          "zeros": (rng.random(n) > 0.3).astype(np.float32),
          "fractional": rng.uniform(0, 2, size=n).astype(np.float32)}[kind]
    return X, g, h, lid, rm


STRUCTURE = ("split_feature", "threshold=", "left_child", "right_child",
             "leaf_count", "decision_type")
SAMPLED = {"bagging_fraction": 0.8, "bagging_freq": 1,
           "feature_fraction": 0.8}
NO_CACHE = {"histogram_pool_size": 0.01}


def parity_data(seed, n, bundled):
    """Training data of the growth parity tests: normal features; with
    ``bundled`` the last four columns are mostly zero and mutually
    exclusive, so EFB packs them into one group column."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 10))
    if bundled:
        owner = rng.integers(0, 8, size=n)
        for j in range(4):
            X[:, 6 + j] = np.where(owner == j, rng.normal(size=n) + 2.0, 0.0)
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=n))
    return X, s


def labels(objective, s):
    return (s > 0).astype(float) if objective == "binary" else s


def parity_params(objective, more):
    return {"objective": objective, "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, **more}


def structure(model):
    """The lines of a model text that fix the trees' partitions."""
    return [ln for ln in model.splitlines() if ln.startswith(STRUCTURE)]


def leaf_values(model):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in model.splitlines()
                           if ln.startswith("leaf_value")])
