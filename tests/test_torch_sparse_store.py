"""The port's entry-chunk sparse store and its histogram kernel (B6)
against the JAX package's ``ops/sparse_mxu.py`` on the same numpy inputs.

* The store's arrays, cap and byte count are equal, for both chunk widths,
  with and without the auto_uniform layout, on data with one dense and one
  all-fill column.
* B6's plain version is held against the JAX package's XLA oracle
  ``chunked_child_hists_ref`` at rtol = atol = 1e-5 (f32 sums in another
  order), and against its Pallas kernel in interpret mode at rtol = atol =
  5e-4, the JAX package's own tolerance for the kernel's bf16 hi/lo weight
  split (tests/test_sparse_mxu.py).  Fill and inactive slots are exactly 0.
* The sparse partition routes rows exactly as the dense one does on the
  same bins.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.io.bundle import BundleLayout as JBundleLayout
from lightgbm_tpu.ops import sparse_mxu as jsm
from lightgbm_tpu.ops.sparse_store import column_fill_bins as j_fill_bins
from lightgbm_tpu_torch.ops import sparse_mxu as tsm
from lightgbm_tpu_torch.ops import wave_kernels as wk
from lightgbm_tpu_torch.ops.sparse_store import column_fill_bins
from torch_cases import (bundled_case, sparse_bundled_case, sparse_case, t,
                         unbundled_case)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

STORE_FIELDS = ("ent_row", "ent_bin", "chunk_col", "col_cptr", "fill")


def _stores(X, fill, b, **kw):
    js, jcap, jbytes = jsm.build_chunked_store(X, fill, b, **kw)
    ts, tbytes = tsm.build_chunked_store(X, fill, b, **kw)
    return (js, jcap, jbytes), (ts, ts.cap_chunks, tbytes)


@pytest.mark.parametrize("entry_chunk", [128, 512])
@pytest.mark.parametrize("auto_uniform", [False, True])
@pytest.mark.parametrize("dense_col", [3, None])
def test_store_arrays_equal(entry_chunk, auto_uniform, dense_col):
    X, fill, _, _ = sparse_case(dense_col=dense_col)
    (js, jcap, jbytes), (ts, tcap, tbytes) = _stores(
        X, fill, 14, entry_chunk=entry_chunk, auto_uniform=auto_uniform)
    for name in STORE_FIELDS:
        got = getattr(ts, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(js, name)),
                                      err_msg=name)
    assert (tcap, tbytes) == (jcap, jbytes)
    # the uniform layout engages only on the low-skew data
    widened = ts.ent_bin.shape[1] > entry_chunk
    assert widened == (auto_uniform and dense_col is None)


def test_split_column_is_the_column():
    X, fill, _, _ = sparse_case()
    for kw in ({"entry_chunk": 128}, {"entry_chunk": 128,
                                      "auto_uniform": True}):
        ts, _ = tsm.build_chunked_store(X, fill, 14, **kw)
        for j in range(X.shape[1]):
            col = tsm.chunked_split_column(ts, j, X.shape[0])
            assert col.dtype == torch.int32
            np.testing.assert_array_equal(col.numpy(), X[:, j])


def test_column_fill_bins_match():
    num_bin = np.array([10, 7, 12, 5, 9], np.int32)
    default = np.array([3, 0, 4, 2, 0], np.int32)
    np.testing.assert_array_equal(column_fill_bins(num_bin, default, None),
                                  j_fill_bins(num_bin, default, None))
    groups = [[0, 2], [1], [3, 4]]
    layout = JBundleLayout(groups=groups, group_of=np.zeros(5, np.int32),
                           bin_off=np.zeros(5, np.int32),
                           bin_adj=np.zeros(5, np.int32),
                           bin_span=np.zeros(5, np.int32),
                           num_group_bins=np.zeros(3, np.int32))
    got = column_fill_bins(num_bin, default, layout)
    np.testing.assert_array_equal(got, j_fill_bins(num_bin, default, layout))
    np.testing.assert_array_equal(got, [0, 0, 0])
    layout = layout._replace(groups=[[0], [1, 2], [3], [4]])
    np.testing.assert_array_equal(column_fill_bins(num_bin, default, layout),
                                  [3, 0, 2, 0])


# (child ids, leaf count): inactive slots, the root call (slot 0 = leaf 0,
# the other W - 1 slots inactive), one slot, and K = W all active
B6_CASES = {"inactive": ([0, 2, 4, -1, 7], 12),
            "root": ([0, -1, -1, -1], 1),
            "k1": ([3], 12),
            "k_eq_w": ([0, 1, 2, 3, 4, 5, 6, 7], 8)}


def _b6_inputs(case, entry_chunk, auto_uniform=False):
    cid, L = B6_CASES[case]
    X, fill, leaf_id, w3 = sparse_case(L=L)
    (js, _, _), (ts, _, _) = _stores(X, fill, 14, entry_chunk=entry_chunk,
                                     auto_uniform=auto_uniform)
    return X, fill, leaf_id, w3, np.asarray(cid, np.int32), js, ts, L


def _plain_b6(ts, leaf_id, w3, cid, b, f):
    return tsm.sparse_wave_histogram(ts, t(leaf_id), t(w3), t(cid), b,
                                     f).numpy()


@pytest.mark.parametrize("case", sorted(B6_CASES))
@pytest.mark.parametrize("entry_chunk,auto_uniform",
                         [(128, False), (512, False), (128, True)])
def test_b6_plain_matches_xla_oracle(case, entry_chunk, auto_uniform):
    X, fill, leaf_id, w3, cid, js, ts, L = _b6_inputs(case, entry_chunk,
                                                      auto_uniform)
    f = X.shape[1]
    got = _plain_b6(ts, leaf_id, w3, cid, 14, f)
    want = np.asarray(jsm.chunked_child_hists_ref(
        js, jnp.asarray(leaf_id), jnp.asarray(w3), jnp.asarray(cid), 14, f,
        L))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[cid < 0] == 0.0)                   # inactive slots
    assert np.all(got[:, np.arange(f), fill] == 0.0)     # fill slots
    assert np.abs(got[cid >= 0]).sum() > 0


@pytest.mark.parametrize("case", sorted(B6_CASES))
def test_b6_plain_matches_pallas_interpret(case):
    X, fill, leaf_id, w3, cid, js, ts, _ = _b6_inputs(case, 128)
    f = X.shape[1]
    got = _plain_b6(ts, leaf_id, w3, cid, 14, f)
    want = np.asarray(jsm.sparse_wave_histogram_mxu(
        js, jnp.asarray(leaf_id), jnp.asarray(w3), jnp.asarray(cid), 14, f,
        interpret=True))
    np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)


def test_b6_plain_bundled_columns():
    X, fill, leaf_id, w3, b = sparse_bundled_case()
    cid = np.array([1, 4, -1, 8], np.int32)
    (js, _, _), (ts, _, _) = _stores(X, fill, b, entry_chunk=128)
    got = _plain_b6(ts, leaf_id, w3, cid, b, X.shape[1])
    want = np.asarray(jsm.chunked_child_hists_ref(
        js, jnp.asarray(leaf_id), jnp.asarray(w3), jnp.asarray(cid), b,
        X.shape[1], 9))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[:, :3, 0] == 0.0)          # group fill bin 0


def test_b6_duplicate_child_ids_each_get_the_histogram():
    X, fill, leaf_id, w3 = sparse_case(L=12)
    ts, _ = tsm.build_chunked_store(X, fill, 14, entry_chunk=128)
    got = _plain_b6(ts, leaf_id, w3, np.array([2, 5, 2], np.int32), 14,
                    X.shape[1])
    np.testing.assert_array_equal(got[0], got[2])
    single = _plain_b6(ts, leaf_id, w3, np.array([2], np.int32), 14,
                       X.shape[1])
    np.testing.assert_array_equal(got[0], single[0])


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("auto_uniform", [False, True])
def test_sparse_partition_routes_like_the_dense_one(bundled, auto_uniform):
    """The same wave on the same bins: the sparse store's routing (fill
    bin plus the split columns' entries) gives the dense routing's ids."""
    X, lid, _, _, _, cols, psrc = (bundled_case() if bundled
                                   else unbundled_case())
    fill = np.array([np.bincount(X[:, j]).argmax()
                     for j in range(X.shape[1])])
    ts, _ = tsm.build_chunked_store(X, fill, 14, entry_chunk=128,
                                    auto_uniform=auto_uniform)
    got = tsm.sparse_route_rows(ts, t(lid), t(cols), t(psrc), 16, bundled)
    want = wk.route_rows_plain(t(X.T), t(lid), t(cols), t(psrc), bundled)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert (got.numpy() != lid).any()


@pytest.mark.parametrize("b,k", [(63, 1), (63, 32), (255, 1), (255, 32),
                                 (600, 32), (2, 3)])
def test_b6_launch_plan_bounds(b, k):
    """B6's plan: a block's shared memory fits the budget, the K slots
    split evenly over as few slices as fit, and a block takes 512
    threads, or 1024 where shared memory holds at most two blocks an SM.
    At Bosch's K = 32 and 63 bins: all 32 slots in one 56 KB block (four
    an SM); at 255 bins 32 slots in one 196 KB block of 1024 threads."""
    ks, threads, smem, tiles = tsm.launch_plan(b, k)
    assert tiles == 1                   # one (slot, b, 3) row fits
    slices = -(-k // ks)
    assert 1 <= ks <= k and (slices - 1) * ks < k
    assert slices == 1 or tsm._smem_bytes(
        b, -(-k // (slices - 1))) > tsm._SMEM_BUDGET   # fewest slices
    assert smem == tsm._smem_bytes(b, ks) <= tsm._SMEM_BUDGET
    per_sm = tsm._SMEM_PER_SM // (smem + 1024)
    assert threads == (1024 if per_sm <= 2 else 512)
    if (b, k) == (63, 32):
        assert (ks, threads, per_sm) == (32, 512, 4)
    if b == 255 and k == 32:
        assert (ks, threads, per_sm) == (32, 1024, 1)
