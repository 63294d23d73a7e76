"""The port's wave kernels (B1 fused partition + histograms, B3 histogram
only, B4 histogram only on the row-major bins) against the JAX package's
Pallas kernels run in interpret mode and against its XLA oracle, on the
same numpy inputs.

Tolerance for histograms: rtol 1e-5 with atol 1e-5 x max|w|, for sums
taken in another order than the port's f32 adds.  The Pallas kernels also
multiply through a bf16 hi/lo split of the weights, which keeps 16
significant bits (up to 2^-16 relative per product); the inputs of the
comparisons with them are cut to 16 significant bits, which the split
represents exactly, so that what is compared is the contract and not the
TPU's precision trick.  The comparisons with the XLA oracle use full f32
weights.  Leaf ids are integers and must match exactly.  B4 is also held
against its Pallas kernel on full f32 weights: the hi/lo split keeps 16
significant bits of each weight (a product errs by at most 2^-16 of it),
so there a cell may differ by 1e-4 x (sum of |w| over the cell) + 1e-6 x
max|w|.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.histogram import leaf_histogram_onehot
from lightgbm_tpu.ops.pallas_wave import (wave_histogram_pallas,
                                          wave_histogram_pallas_t,
                                          wave_histogram_reference,
                                          wave_partition_hist_pallas_ct)
from lightgbm_tpu_torch.ops import wave_kernels as wk
from torch_cases import (assert_hist_close as _assert_hist_close,
                         bundled_case as _bundled_case, t as _t,
                         unbundled_case as _unbundled_case,
                         wave_data as _data)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _hilo_exact(w3):
    """w3 cut to 16 significant bits: exact under the bf16 hi/lo split."""
    bits = np.ascontiguousarray(w3, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFFF00)).view(np.float32)


def _plain_fused(X, lid, w3, cid, cols, psrc, b, bundled=False):
    new_lid, hist = wk.wave_partition_hist(
        _t(X.T), _t(lid), _t(w3), _t(cid), _t(cols), _t(psrc), b,
        bundled=bundled)
    return new_lid.numpy(), hist.numpy()


@pytest.mark.parametrize("bundled", [False, True])
def test_fused_plain_matches_pallas_ct(bundled):
    X, lid, w3, cid, b, cols, psrc = (_bundled_case() if bundled
                                      else _unbundled_case())
    wq = _hilo_exact(w3)
    want_lid, want_hist = wave_partition_hist_pallas_ct(
        jnp.asarray(X.T), jnp.asarray(lid), jnp.asarray(wq),
        jnp.asarray(cid), jnp.asarray(cols), jnp.asarray(psrc), b,
        bundled=bundled, interpret=True)
    got_lid, got_hist = _plain_fused(X, lid, wq, cid, cols, psrc, b,
                                     bundled)
    np.testing.assert_array_equal(got_lid, np.asarray(want_lid))
    assert (got_lid != lid).any()           # some rows really moved
    _assert_hist_close(got_hist, np.asarray(want_hist), wq)
    # and against the XLA oracle on the routed ids, full f32 weights
    got_hist = _plain_fused(X, lid, w3, cid, cols, psrc, b, bundled)[1]
    ref = np.asarray(wave_histogram_reference(
        jnp.asarray(X), jnp.asarray(got_lid), jnp.asarray(w3),
        jnp.asarray(cid), b))
    _assert_hist_close(got_hist, ref, w3)


def test_fused_plain_inactive_table_is_identity():
    """psrc all -3: no row moves, histograms equal the histogram-only
    pass on the same ids."""
    X, lid, w3, cid, b = _data(n=1500, seed=21)
    cols = np.zeros((4, 10), np.float32)
    psrc = np.full(4, -3, np.int32)
    got_lid, got_hist = _plain_fused(X, lid, w3, cid, cols, psrc, b)
    np.testing.assert_array_equal(got_lid, lid)
    only = wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b).numpy()
    np.testing.assert_array_equal(got_hist, only)


def test_hist_plain_matches_pallas_t():
    X, lid, w3, cid, b = _data(n=3000, f=7, b=14, k=5, seed=0)
    wq = _hilo_exact(w3)
    want = np.asarray(wave_histogram_pallas_t(
        jnp.asarray(X.T), jnp.asarray(lid), jnp.asarray(wq),
        jnp.asarray(cid), b, interpret=True))
    got = wk.wave_histogram(_t(X.T), _t(lid), _t(wq), _t(cid), b).numpy()
    _assert_hist_close(got, want, wq)
    got = wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b).numpy()
    ref = np.asarray(wave_histogram_reference(
        jnp.asarray(X), jnp.asarray(lid), jnp.asarray(w3),
        jnp.asarray(cid), b))
    _assert_hist_close(got, ref, w3)
    assert np.all(got[3] == 0.0)            # the inactive (-1) slot


def test_hist_drops_bins_past_num_bins():
    """Bins >= num_bins contribute nothing (the Pallas kernel slices its
    padded bin axis back to num_bins)."""
    X, lid, w3, cid, _ = _data(n=1200, f=5, b=20, seed=4)
    w3 = _hilo_exact(w3)
    b = 12
    got = wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b).numpy()
    want = np.asarray(wave_histogram_pallas_t(
        jnp.asarray(X.T), jnp.asarray(lid), jnp.asarray(w3),
        jnp.asarray(cid), b, interpret=True))
    assert got.shape == (len(cid), X.shape[1], b, 3)
    _assert_hist_close(got, want, w3)


def test_root_histogram_k1_matches_leaf_histogram_onehot():
    """K = 1 with child id 0 on all-zero leaf ids is the root histogram
    the JAX wave engine takes from leaf_histogram_onehot."""
    rng = np.random.default_rng(5)
    n, f, b = 2000, 9, 31
    X = rng.integers(0, b, size=(n, f), dtype=np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    rm = (rng.random(n) > 0.2).astype(np.float32)
    lid = np.zeros(n, np.int32)
    want = np.asarray(leaf_histogram_onehot(
        jnp.asarray(X), jnp.asarray(g), jnp.asarray(h), jnp.asarray(lid),
        0, jnp.asarray(rm), num_bins=b))
    w3 = np.stack([g * rm, h * rm, rm], axis=-1)
    got = wk.wave_histogram(_t(X.T), _t(lid), _t(w3),
                            torch.zeros(1, dtype=torch.int32), b).numpy()
    assert got.shape == (1, f, b, 3)
    _assert_hist_close(got[0], want, w3)


def test_duplicate_child_ids_fill_both_slots():
    X, lid, w3, _, b = _data(n=900, seed=3)
    cid = np.array([2, 5, 2], np.int32)
    got = wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b).numpy()
    np.testing.assert_array_equal(got[0], got[2])
    assert np.abs(got[0]).sum() > 0


def test_cpu_wrappers_do_not_count_launches():
    X, lid, w3, cid, b, cols, psrc = _unbundled_case()
    before = (wk.wave_partition_hist.launches, wk.wave_histogram.launches)
    _plain_fused(X, lid, w3, cid, cols, psrc, b)
    wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b)
    assert (wk.wave_partition_hist.launches,
            wk.wave_histogram.launches) == before


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "bins"])
def test_wrapper_validates_inputs(bad):
    X, lid, w3, cid, b = _data(n=64, seed=1)
    w = _t(w3)
    if bad == "dtype":
        # float64 weights are the f64 form (tpu_use_dp); half is none
        w = w.half()
    elif bad == "shape":
        w = w[:, :2].contiguous()
    elif bad == "device":
        w = w.to("meta")
    else:
        b = 300
    with pytest.raises(wk.LightGBMError):
        wk.wave_histogram(_t(X.T), _t(lid), w, _t(cid), b)


def _rowmajor_case(k, seed):
    """K child slots over 2K leaves, with an inactive (-1) slot and a
    duplicate child id once K > 1."""
    X, lid, w3, _, b = _data(n=3000, f=7, b=14, seed=seed)
    rng = np.random.default_rng(seed)
    lid = rng.integers(0, 2 * k, size=len(X)).astype(np.int32)
    cid = rng.permutation(2 * k)[:k].astype(np.int32)
    if k > 1:
        cid[1] = -1
        cid[-1] = cid[0]
    return X, lid, w3, cid, b


@pytest.mark.parametrize("k", [1, 4, 32])
def test_rowmajor_plain_matches_pallas(k):
    X, lid, w3, cid, b = _rowmajor_case(k, seed=k)
    got = wk.wave_histogram_rowmajor(_t(X), _t(lid), _t(w3), _t(cid),
                                     b).numpy()
    assert got.shape == (k, X.shape[1], b, 3)
    want = np.asarray(wave_histogram_pallas(
        jnp.asarray(X), jnp.asarray(lid), jnp.asarray(w3), jnp.asarray(cid),
        b, interpret=True, hilo=True))
    scale = wk.wave_histogram_rowmajor(_t(X), _t(lid), _t(np.abs(w3)),
                                       _t(cid), b).numpy()
    assert np.all(np.abs(got - want)
                  <= 1e-4 * scale + 1e-6 * np.abs(w3).max())
    ref = np.asarray(wave_histogram_reference(
        jnp.asarray(X), jnp.asarray(lid), jnp.asarray(w3), jnp.asarray(cid),
        b))
    _assert_hist_close(got, ref, w3)
    # the same pass on the transposed bins (B3's plain version)
    same = wk.wave_histogram(_t(X.T), _t(lid), _t(w3), _t(cid), b).numpy()
    np.testing.assert_array_equal(got, same)
    if k > 1:
        assert np.all(got[1] == 0.0)
        np.testing.assert_array_equal(got[0], got[-1])


@pytest.mark.parametrize("bundled", [False, True])
def test_rowmajor_routing_matches_the_transposed(bundled):
    X, lid, w3, cid, b, cols, psrc = (_bundled_case() if bundled
                                      else _unbundled_case())
    got = wk.route_rows_rowmajor(_t(X), _t(lid), _t(cols), _t(psrc),
                                 bundled).numpy()
    want = wk.route_rows_plain(_t(X.T), _t(lid), _t(cols), _t(psrc),
                               bundled).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != lid).any()


def test_rowmajor_wrapper_validates_inputs():
    X, lid, w3, cid, b = _data(n=64, seed=1)
    with pytest.raises(wk.LightGBMError):       # X_t where X belongs
        wk.wave_histogram_rowmajor(_t(X.T), _t(lid), _t(w3), _t(cid), b)
    before = wk.wave_histogram_rowmajor.launches
    wk.wave_histogram_rowmajor(_t(X), _t(lid), _t(w3), _t(cid), b)
    assert wk.wave_histogram_rowmajor.launches == before


def _assert_plan_bounds(f, n, b, k, sms=132):
    """The shared plan of B1, B3 and B4: the int64 (KS, FS, B, 3) block
    histogram times its copies fits a block's shared memory (and takes
    the room one histogram leaves; the slot-ordered plan holds one slot
    and one copy), the feature groups and slot slices cover every feature
    and slot, the R list shares cover a list of every row, and the
    list-pass blocks cover the rows (or fill the card)."""
    plan = wk.hist_plan(f, n, b, k, sms)
    list_blocks, groups, R, ks, fs, copies, smem, ordered = plan
    assert smem == copies * ks * fs * b * 3 * 8 <= wk._SMEM_BUDGET
    assert copies in (1, 2, 4, 8, 16, 32)
    if ordered:
        assert (ks, copies) == (1, 1) and 1 < k <= wk._MAX_ORDERED_SLOTS
    else:
        assert copies == 32 or 2 * smem > wk._SMEM_BUDGET
    assert 1 <= fs <= wk._GROUP_MAX and groups * fs >= f
    assert (groups - 1) * fs < f
    assert 1 <= ks <= k and -(-k // ks) * ks >= k
    assert 1 <= R <= 65535
    per = -(-n // R)                        # shares of an n-row list:
    assert R * per >= n and (R - 1) * per < n   # all of it, none empty
    assert 1 <= list_blocks <= sms * wk._LIST_BLOCKS_PER_SM
    assert list_blocks * wk._LIST_TILE >= min(
        n, sms * wk._LIST_BLOCKS_PER_SM * wk._LIST_TILE)
    return plan


@pytest.mark.parametrize("n,k", [(2_000_000, 32), (2_000_000, 1),
                                 (10_500_000, 32), (3000, 5)])
def test_launch_plan_bounds(n, k):
    """B3's plan at the flagship's 28 features and 63 bins: the root's
    one slot takes 4 groups of 7 features with 16 interleaved copies of
    its histogram, the wave's 32 slots 7 groups of 4 and one copy."""
    plan = _assert_plan_bounds(28, n, 63, k)
    if k == 1:
        assert (plan[1], plan[4], plan[5]) == (4, 7, 16)
    if k == 32:
        assert (plan[1], plan[4], plan[5]) == (7, 4, 1)


@pytest.mark.parametrize("n,k,b", [(2_000_000, 32, 63), (2_000_000, 1, 63),
                                   (2_000_000, 32, 255), (3000, 5, 14)])
def test_rowmajor_launch_plan_bounds(n, k, b):
    """B4 launches on B3's plan: the layout changes how a row's bytes
    are read, not the plan."""
    plan = _assert_plan_bounds(28, n, b, k)
    assert plan == wk.hist_plan(28, n, b, k, 132)


@pytest.mark.parametrize("n,f,b,k", [(2_000_000, 28, 63, 32),
                                     (10_500_000, 28, 63, 32),
                                     (3000, 968, 255, 32), (3000, 7, 14, 5),
                                     (2_000_000, 28, 256, 64),
                                     (50_000, 3, 63, 1), (1000, 9, 255, 200)])
def test_fused_launch_plan_bounds(n, f, b, k):
    """B1's plan (the shared one): its bounds, one round of blocks fits
    the card at 32 warps a SM, and the flagship wave keeps one histogram
    copy in 7 groups of 4 features over 18 list shares."""
    sms = 132
    _, groups, R, ks, fs, copies, _, ordered = _assert_plan_bounds(f, n, b,
                                                                   k, sms)
    # the slot-ordered pass's grid has no slot-slice axis
    kslices = 1 if ordered else -(-k // ks)
    assert R == 1 or groups * kslices * R <= sms * (2048 // wk._HIST_THREADS)
    assert wk._HIST_THREADS // 32 >= 32        # resident warps a block
    if (n, f, b, k) == (2_000_000, 28, 63, 32):
        assert (groups, fs, ks, R, copies) == (7, 4, 32, 18, 1)


@pytest.mark.parametrize("seed,spread", [(0, 1.0), (1, 1e-30), (2, 1e30),
                                         (3, 0.0)])
def test_fixed_point_exponents_error_bound(seed, spread):
    """B1 sums round(w * 2^e_c) in int64: no sum of N values can reach
    2^62, and a cell errs by at most N_cell * N * max|w_c| / 2^62 against
    the float64 sum (the kernel's arithmetic, emulated in numpy)."""
    rng = np.random.default_rng(seed)
    n = 20000
    w3 = (rng.standard_cauchy(size=(n, 3)) * spread).astype(np.float32)
    w3[:, 2] = (rng.random(n) > 0.3) * spread   # a 0/1-like multiplier
    e = wk.fixed_point_exponents(_t(w3)).numpy()
    assert e.dtype == np.int32 and e.shape == (3,)
    wmax = np.abs(w3).astype(np.float64).max(axis=0)
    cells = rng.integers(0, 50, size=n)
    for c in range(3):
        scale = np.ldexp(1.0, int(e[c]))
        if wmax[c] > 0:
            assert n * wmax[c] * scale < 2.0 ** 62
            assert n * wmax[c] * scale >= 2.0 ** 61
        q = np.rint(w3[:, c].astype(np.float64) * scale).astype(np.int64)
        assert np.abs(q).sum() < 2 ** 62
        got = np.zeros(50, np.int64)
        np.add.at(got, cells, q)
        got = np.ldexp(got.astype(np.float64), -int(e[c]))
        want = np.zeros(50)
        np.add.at(want, cells, w3[:, c].astype(np.float64))
        n_cell = np.bincount(cells, minlength=50)
        bound = n_cell * n * wmax[c] / 2.0 ** 62
        assert np.all(np.abs(got - want) <= bound * (1 + 1e-9) + 1e-300)


@pytest.mark.parametrize("bundled", [False, True])
def test_route_list_plain_lists_the_rows_in_a_child_slot(bundled):
    """B1's routing pass lists each row whose new id is a child id once,
    in row order, with the first slot that holds the id (a repeated child
    id lists its rows under its first slot)."""
    X, lid, w3, cid, b, cols, psrc = (_bundled_case() if bundled
                                      else _unbundled_case())
    cid = cid.copy()
    cid[-1] = cid[0]
    new_lid, rows, slots = wk.route_list(_t(X.T), _t(lid), _t(cid),
                                         _t(cols), _t(psrc), bundled)
    want = wk.route_rows_plain(_t(X.T), _t(lid), _t(cols), _t(psrc),
                               bundled).numpy()
    np.testing.assert_array_equal(new_lid.numpy(), want)
    first = {}
    for k, c in enumerate(cid):
        first.setdefault(int(c), k)
    expect = [(i, first[int(v)]) for i, v in enumerate(want)
              if int(v) in first]
    assert [(int(r), int(s)) for r, s in zip(rows, slots)] == expect
    assert 0 < len(expect) < len(want)


@pytest.mark.parametrize("kind", ["unbundled", "repeated", "inactive"])
def test_select_list_plain_lists_the_rows_in_a_child_slot(kind):
    """The select pass of B3 and B4 lists each row whose leaf id is a
    child id once, in row order, with the first slot that holds the id;
    a repeated child id lists its rows under its first slot, and with
    every slot inactive the list is empty."""
    X, lid, w3, cid, b = _data(n=2500, seed=12)
    cid = cid.copy()
    if kind == "repeated":
        cid[-1] = cid[0]
    elif kind == "inactive":
        cid[:] = -1
    rows, slots = wk.select_list(_t(lid), _t(cid))
    assert rows.dtype == slots.dtype == torch.int32
    first = {}
    for k, c in enumerate(cid):
        if c >= 0:
            first.setdefault(int(c), k)
    expect = [(i, first[int(v)]) for i, v in enumerate(lid)
              if int(v) in first]
    assert [(int(r), int(s)) for r, s in zip(rows, slots)] == expect
    assert (len(expect) == 0) == (kind == "inactive")
    plain = wk.select_list_plain(_t(lid), _t(cid))
    assert all(torch.equal(a, c) for a, c in zip(plain, (rows, slots)))


@pytest.mark.parametrize("f,n", [(256, 8_500_000), (968, 10_500_000)])
def test_row_guard_allows_f_times_n_past_2_31(f, n):
    """The kernels' only shape limit is the int row: F x N past 2^31
    (8.5M x 256 bins, the 10.5M-row recipe at Bosch's width) is taken."""
    assert f * n >= 2 ** 31
    wk.check_rows(n)
    wk.check_rows(wk.MAX_ROWS)


@pytest.mark.parametrize("n", [2 ** 31, 2 ** 33])
def test_row_guard_refuses_2_31_rows(n):
    with pytest.raises(wk.LightGBMError, match="2\\^31 rows"):
        wk.check_rows(n)


def test_list_buffers_take_the_callers_workspace():
    """Given a workspace (a grower's, sized for its widest call), the
    list passes' buffers point into it -- the list at its start, the
    fixed-point sums 8 N bytes on, then the list's length and the slot
    counts and cursors of the slot-ordered list, and last B5's zeroed
    sums -- for any slot count up to its size; a workspace
    too small or of another dtype raises; without one, each call makes
    its own."""
    N, K, F, B = 100, 4, 3, 7
    cpu = torch.device("cpu")
    work = wk.list_workspace(N, K, F, B, cpu)
    assert work.dtype == torch.int64
    tail = wk.leaf_sum_words(F, B)
    assert tail == F * B * 3
    assert work.numel() == N + K * F * B * 3 + 1 + 2 * K + tail
    assert not bool(work[-tail:].any())
    for k, shape in ((1, (F, B, 3)), (K, None)):
        rows, acc, got, hist = wk._list_buffers(N, k, F, B, cpu, shape, work)
        assert got is work and hist.dtype == torch.float32
        assert (rows, acc) == (work.data_ptr(), work.data_ptr() + 8 * N)
        assert hist.shape == (shape or (k, F, B, 3))
    for bad in (work[:-tail - 1], work.to(torch.int32)):
        with pytest.raises(Exception, match="work: expected"):
            wk._list_buffers(N, K, F, B, cpu, work=bad)
    own = wk._list_buffers(N, K, F, B, cpu)[2]
    assert own is not work and own.numel() == work.numel() - tail
