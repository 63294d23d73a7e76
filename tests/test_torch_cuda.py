"""The port's CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU: a CUDA kernel has no CPU mode, so they
skip where torch.cuda.is_available() is false.  The file imports neither
JAX nor the JAX package, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: leaf ids and the score update are exact; histograms agree to
rtol 1e-5 with atol 1e-5 x max|w| (f32 sums taken in another order), and
two launches on the same input are bit-identical.  B1, B3, B4, B5 and B6
are also held against their plain versions computed in float64 with
chip_smoke.py's tolerance: a cell may differ by 1e-5 x (sum of |w| over
the cell) + 1e-5 x max|w|.  All five sum in one fixed point with the
tree's exponents, so on the same rows their histograms are equal to the
bit (B6's in every cell but the fill bins it never holds): the three
dense wave dataflows train byte-identical model text, and so do exact
growth and wave growth at width 1.  The kernels take F x N past 2^31
(test_kernels_large_f_times_n_past_2_31, 4.4 GB of bins on the card).
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import _build
from lightgbm_tpu_torch.ops import leaf_hist as lh
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.ops import sparse_mxu as sm
from lightgbm_tpu_torch.ops import wave_kernels as wk
from lightgbm_tpu_torch.ops.partition import clipped_leaf_values
from lightgbm_tpu_torch.utils.common import kMaxTreeOutput
from lightgbm_tpu_torch.ops.histogram import weight_rows
from lightgbm_tpu_torch.ops.pack import pack4_host
from torch_cases import (LEAF_CASES, LEAF_FORMS, LEAF_SIZES, NO_CACHE, SAMPLED, SCORE_CASES,
                         assert_hist_close, bundled_case, labels, leaf_case,
                         leaf_size_case,
                         parity_data, parity_params, score_case,
                         sparse_bundled_case, sparse_case, t, unbundled_case,
                         wave_data)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _no_fp(text):
    """A model text without its drift_fingerprint= line."""
    return "".join(ln for ln in text.splitlines(keepends=True)
                   if not ln.startswith("drift_fingerprint="))


def _launched_passes(booster):
    """Wave passes a run launched: on the card wave growth runs fused
    (tpu_fused_iter=auto), M masked waves and the tail waves a tree; on
    the staged chain, the waves that split."""
    stats = booster.grow_stats()
    fused = booster._gbdt._fused_state[0]
    if fused is None:
        return sum(s.passes for s in stats)
    return sum(fused.passes + s.tail_passes for s in stats)


@pytest.mark.parametrize("bundled", [False, True])
def test_fused_kernel_matches_plain(dev, bundled):
    X, lid, w3, cid, b, cols, psrc = (bundled_case() if bundled
                                      else unbundled_case())
    args = [t(a).to(dev) for a in (X.T, lid, w3, cid, cols, psrc)]
    n0 = wk.wave_partition_hist.launches
    got_lid, got_hist = wk.wave_partition_hist(*args, b, bundled=bundled)
    again_lid, again = wk.wave_partition_hist(*args, b, bundled=bundled)
    torch.cuda.synchronize()
    assert wk.wave_partition_hist.launches == n0 + 2
    want_lid, want_hist = wk.wave_partition_hist(
        *[t(a) for a in (X.T, lid, w3, cid, cols, psrc)], b, bundled=bundled)
    np.testing.assert_array_equal(got_lid.cpu().numpy(), want_lid.numpy())
    assert (want_lid.numpy() != lid).any()      # some rows really moved
    assert_hist_close(got_hist.cpu().numpy(), want_hist.numpy(), w3)
    assert torch.equal(got_hist, again) and torch.equal(got_lid, again_lid)


def _b1_case(n, f, b, k, seed, bundled=False, dup=False):
    """A wave at B1's real shapes: k leaves, each split once (numerical
    and categorical splits, default bins, default-left and -right), the
    smaller child of each split in child_id (a repeated child id when
    dup, an inactive slot), over X (N, F) bins below b; bundled adds EFB
    offsets, spans and bin adjusts."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b, size=(n, f), dtype=np.uint8)
    lid = rng.integers(0, k, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(np.float32)
    w3[:, 2] = rng.random(n) > 0.2
    cols = np.zeros((k, 10), np.float32)
    cols[:, 0] = 1
    cols[:, 1] = rng.integers(0, f, size=k)
    cols[:, 2] = rng.integers(0, b - 1, size=k)
    cols[:, 3] = rng.random(k) < 0.25                # categorical
    cols[:, 4] = rng.integers(0, b, size=k)          # default bin
    cols[:, 5] = rng.integers(0, 2, size=k)          # default left
    cols[:, 6] = np.arange(k, 2 * k)                 # right child
    cols[:, 9] = b
    if bundled:
        cols[:, 7] = rng.integers(0, b // 2, size=k)
        cols[:, 9] = rng.integers(1, b // 2, size=k)
        cols[:, 8] = rng.integers(0, 3, size=k)
    psrc = np.arange(k, dtype=np.int32)
    psrc[k // 3] = -3                                # an idle parent
    cid = np.where(rng.random(k) < 0.5, psrc, psrc + k).astype(np.int32)
    cid[k // 3] = -1
    if dup:
        cid[-1] = cid[0]
    return X, lid, w3, cid, b, cols, psrc


def _check_b1(dev, case, bundled):
    X, lid, w3, cid, b, cols, psrc = case
    args = [t(a).to(dev) for a in (X.T, lid, w3, cid, cols, psrc)]
    n0 = wk.wave_partition_hist.launches
    got_lid, got = wk.wave_partition_hist(*args, b, bundled=bundled)
    again_lid, again = wk.wave_partition_hist(*args, b, bundled=bundled)
    torch.cuda.synchronize()
    assert wk.wave_partition_hist.launches == n0 + 2
    assert torch.equal(got, again) and torch.equal(got_lid, again_lid)
    want_lid = wk.route_rows_plain(*args[:2], *args[4:], bundled)
    assert torch.equal(got_lid, want_lid)
    assert bool((want_lid != args[1]).any())
    w64 = args[2].double()
    want = wk.wave_histogram_plain(args[0], want_lid, w64, args[3], b)
    scale = wk.wave_histogram_plain(args[0], want_lid, w64.abs(), args[3], b)
    assert _within_f64(got, want.cpu(), scale.cpu(),
                       float(np.abs(w3).max()))
    inactive = cid < 0
    assert bool((got[torch.from_numpy(inactive).to(dev)] == 0).all())
    for k in range(1, len(cid)):
        first = int(np.argmax(cid == cid[k]))
        if first < k:                    # a repeated child id
            assert torch.equal(got[k], got[first])
    return got_lid


@pytest.mark.parametrize("bundled", [False, True])
def test_fused_kernel_at_the_flagship_shape(dev, bundled):
    """B1 at phase 2's shape (N = 2M, F = 28, B = 63, K = W = 32) with
    categorical splits, an idle parent, an inactive and a repeated child
    slot: leaf ids exactly equal to the plain routing, the histogram
    within phase 2's tolerance of the float64 plain version, repeats
    bit-identical; and its routing pass lists each row in a child slot
    exactly once (rows are routed once a wave)."""
    case = _b1_case(2_000_000, 28, 63, 32, seed=7, bundled=bundled,
                    dup=True)
    _check_b1(dev, case, bundled)
    X, lid, _, cid, _, cols, psrc = case
    args = [t(a).to(dev) for a in (X.T, lid, cid, cols, psrc)]
    got = wk.route_list(*args, bundled)
    want = wk.route_list_plain(*args, bundled)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("n,f,b,k", [(3000, 968, 255, 32), (2500, 7, 14, 5),
                                     (4000, 3, 256, 70), (2000, 5, 20, 2)])
def test_fused_kernel_wide_and_small_shapes(dev, n, f, b, k):
    """B1 where one feature's K slots at B bins would fill a block (F =
    968, B = 255: the slot-ordered pass, 8 features a block), at a small
    shape, with 70 slots at 256 bins (slot-ordered), and with every child
    slot inactive (K = 2: rows move, the list stays empty)."""
    plan = wk.hist_plan(f, n, b, k, torch.cuda.get_device_properties(
        0).multi_processor_count)
    if f == 968:
        assert plan.ordered and plan.FS == 8 and plan.groups == 121
    if k == 70:
        assert plan.ordered and plan.KS == 1
    _check_b1(dev, _b1_case(n, f, b, k, seed=f + b, dup=True), False)


def test_fused_kernel_occupancy(dev):
    """B1's histogram blocks keep 32 warps resident on every SM at the
    flagship shape (the per-warp f32 design held 8), and the kernel's shared
    memory is the plan's, for B1's wave and for the root's copies."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.library()
    for k in (32, 1):
        _, _, _, ks, fs, copies, smem, _ = wk.hist_plan(28, 2_000_000, 63,
                                                        k, sms)
        assert lib.lgbt_wave_hist_smem(63, ks, fs, copies) == smem
        for rowmajor in (0, 1):
            blocks = lib.lgbt_wave_hist_blocks_per_sm(63, ks, fs, copies,
                                                      rowmajor, 0)
            assert blocks * wk._HIST_THREADS // 32 >= 32


def _check_hist(dev, X, lid, w3, cid, b, exps=None, f32_plain=True):
    """B3 on X_t and B4 on X against their plain versions in float64
    (phase 2's tolerance) and, with f32_plain, in f32
    (assert_hist_close), repeats bit-identical, B4 bit-equal to B3,
    inactive slots exactly 0 and a repeated child id's slots equal.
    Returns B3's histogram."""
    Xt, Xr = t(X.T).to(dev), t(X).to(dev)
    ids, w, c = t(lid).to(dev), t(w3).to(dev), t(cid).to(dev)
    n0 = (wk.wave_histogram.launches, wk.wave_histogram_rowmajor.launches)
    got = wk.wave_histogram(Xt, ids, w, c, b, exps=exps)
    again = wk.wave_histogram(Xt, ids, w, c, b, exps=exps)
    rowmajor = wk.wave_histogram_rowmajor(Xr, ids, w, c, b, exps=exps)
    torch.cuda.synchronize()
    assert (wk.wave_histogram.launches - n0[0],
            wk.wave_histogram_rowmajor.launches - n0[1]) == (2, 1)
    assert torch.equal(got, again) and torch.equal(got, rowmajor)
    if f32_plain:
        assert_hist_close(
            got.cpu().numpy(),
            wk.wave_histogram_plain(Xt, ids, w, c, b).cpu().numpy(), w3)
    w64 = w.double()
    want = wk.wave_histogram_plain(Xt, ids, w64, c, b).cpu()
    scale = wk.wave_histogram_plain(Xt, ids, w64.abs(), c, b).cpu()
    assert _within_f64(got, want, scale, float(np.abs(w3).max()))
    inactive = torch.from_numpy(cid < 0).to(dev)
    assert bool((got[inactive] == 0).all())
    for k in range(1, len(cid)):
        first = int(np.argmax(cid == cid[k]))
        if first < k and cid[k] >= 0:
            assert torch.equal(got[k], got[first])
    return got


@pytest.mark.parametrize("n,f,b,k", [(5000, 7, 14, 1), (5000, 7, 14, 5),
                                     (20000, 28, 63, 32),
                                     (3000, 968, 255, 32),
                                     (6000, 3, 63, 1100)])
def test_hist_kernel_matches_plain(dev, n, f, b, k):
    """B3 and B4 at K = 1 (the root: every row in one slot, the plan's
    interleaved copies), 5 and 32 slots over 2K leaves with an inactive
    and a repeated slot, at 968 features of 255 bins (the slot-ordered
    pass) and at 1100 slots (past the ordered pass's 1024: the slots
    split over the grid)."""
    if k == 1100:
        plan = wk.hist_plan(f, n, b, k, torch.cuda.get_device_properties(
            0).multi_processor_count)
        assert not plan.ordered and plan.KS < k
    X, _, w3, _, _ = wave_data(n=n, f=f, b=b, seed=n + f)
    rng = np.random.default_rng(k)
    if k == 1:
        lid, cid = np.zeros(n, np.int32), np.zeros(1, np.int32)
    else:
        lid = rng.integers(0, 2 * k, size=n).astype(np.int32)
        cid = rng.permutation(2 * k)[:k].astype(np.int32)
        cid[1] = -1
        cid[-1] = cid[0]
    got = _check_hist(dev, X, lid, w3, cid, b)
    assert bool((got[0] != 0).any())


@pytest.mark.parametrize("kind", ["duplicate", "inactive"])
def test_hist_kernel_duplicate_child_ids(dev, kind):
    """A child id in two slots fills both; with every slot inactive (the
    no-cache path's idle slots) the list is empty and every slot 0."""
    X, lid, w3, _, b = wave_data(n=900, seed=3)
    cid = (np.array([2, 5, 2], np.int32) if kind == "duplicate"
           else np.full(4, -1, np.int32))
    got = _check_hist(dev, X, lid, w3, cid, b)
    if kind == "duplicate":
        assert torch.equal(got[0], got[2]) and bool((got[0] != 0).any())
    else:
        assert bool((got == 0).all())


@pytest.mark.parametrize("bundled", [False, True])
def test_hist_kernels_bit_equal_to_b1(dev, bundled):
    """At the flagship shape, with the same exponents: B3's histogram of
    the ids B1 routed is B1's histogram to the bit, and B4's on the
    row-major bins is B3's."""
    X, lid, w3, cid, b, cols, psrc = _b1_case(2_000_000, 28, 63, 32,
                                              seed=11, bundled=bundled,
                                              dup=True)
    args = [t(a).to(dev) for a in (X.T, lid, w3, cid, cols, psrc)]
    exps = wk.fixed_point_exponents(args[2])
    new_lid, fused = wk.wave_partition_hist(*args, b, bundled=bundled,
                                            exps=exps)
    # at 2M rows the f32 plain version's own rounding (~1,000 rows a cell,
    # added one after another) exceeds assert_hist_close's tolerance on
    # cancelling cells; the float64 plain version is the reference here
    got = _check_hist(dev, X, new_lid.cpu().numpy(), w3, cid, b, exps,
                      f32_plain=False)
    assert torch.equal(got, fused)


@pytest.mark.parametrize("kind", ["unbundled", "repeated", "inactive",
                                  "large"])
def test_select_kernel_matches_plain(dev, kind):
    """The select pass's list, sorted by row, is select_list_plain's: each
    row in a child slot once, with the first slot holding its id."""
    n = 2_000_000 if kind == "large" else 2500
    X, lid, w3, cid, b = wave_data(n=n, seed=12)
    cid = cid.copy()
    if kind == "repeated":
        cid[-1] = cid[0]
    elif kind == "inactive":
        cid[:] = -1
    got = wk.select_list(t(lid).to(dev), t(cid).to(dev))
    want = wk.select_list_plain(t(lid), t(cid))
    for a, c in zip(got, want):
        assert torch.equal(a.cpu(), c)
    assert (len(want[0]) == 0) == (kind == "inactive")


@pytest.mark.parametrize("n,L", SCORE_CASES + [(2_000_001, 255),
                                               (4099, 20000)])
def test_score_update_bit_equal(dev, n, L):
    """B2 folds the clip in: leaf values beyond +-kMaxTreeOutput after the
    scale, ids out of range, a ragged tail (n not a multiple of 4), a
    table too large to stage in shared memory (L = 20000); out of place,
    in place, and on a view whose data is not 16-byte aligned."""
    score, lid, lv, scale = score_case(n, L)
    assert L == 1 or np.abs(lv * scale).max() > kMaxTreeOutput
    want = tp.score_update_plain(t(score), t(lid),
                                 clipped_leaf_values(t(lv), float(scale)))
    d_score, d_lid, d_lv = t(score).to(dev), t(lid).to(dev), t(lv).to(dev)
    before = tp.score_update.launches
    got = tp.score_update(d_score, d_lid, d_lv, scale)
    assert tp.score_update.launches == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(d_score.cpu(), t(score))   # input left as it was
    kept = d_score.clone()
    same = tp.score_update(d_score, d_lid, d_lv, scale, out=d_score)
    assert same is d_score and torch.equal(d_score.cpu(), want)
    if n > 1:
        off = tp.score_update(kept[1:], d_lid[1:], d_lv, scale)
        assert torch.equal(off.cpu(), want[1:])


def _sparse_kernel_case(kind):
    """(X, fill, leaf_id, w3, child_id, num_bins) for B6: plain columns,
    EFB group columns, K = 32 at 63 bins (a full block of 8 warps), and
    K * B too large for one block (child slots split over the grid)."""
    if kind == "bundled":
        X, fill, lid, w3, b = sparse_bundled_case()
        return X, fill, lid, w3, np.array([1, 4, -1, 8], np.int32), b
    if kind == "plain":
        X, fill, lid, w3 = sparse_case(L=12)
        return X, fill, lid, w3, np.array([0, 2, 4, -1, 7], np.int32), 14
    b = 63 if kind == "k32" else 600
    X, fill, lid, w3 = sparse_case(n=6000, f=9, b=b, L=64, seed=5)
    cid = np.arange(32, dtype=np.int32) * 2
    cid[[3, 17]] = -1
    return X, fill, lid, w3, cid, b


def _on(store, dev):
    return sm.ChunkedSparseStore(*[getattr(store, f).to(dev) for f in (
        "ent_row", "ent_bin", "chunk_col", "col_cptr", "fill")],
        cap_chunks=store.cap_chunks)


@pytest.mark.parametrize("kind", ["plain", "bundled", "k32", "k_split"])
@pytest.mark.parametrize("auto_uniform", [False, True])
def test_sparse_kernel_matches_plain(dev, kind, auto_uniform):
    X, fill, lid, w3, cid, b = _sparse_kernel_case(kind)
    store, _ = sm.build_chunked_store(X, fill, b, entry_chunk=128,
                                      auto_uniform=auto_uniform)
    f = X.shape[1]
    args = [t(a).to(dev) for a in (lid, w3, cid)]
    on_card = _on(store, dev)
    n0 = sm.sparse_wave_histogram.launches
    got = sm.sparse_wave_histogram(on_card, *args, b, f)
    again = sm.sparse_wave_histogram(on_card, *args, b, f)
    torch.cuda.synchronize()
    assert sm.sparse_wave_histogram.launches == n0 + 2
    want = sm.sparse_wave_histogram(store, t(lid), t(w3), t(cid), b, f)
    got = got.cpu().numpy()
    assert_hist_close(got, want.numpy(), w3)
    assert torch.equal(torch.from_numpy(got), again.cpu())
    assert np.all(got[cid < 0] == 0.0)
    assert np.all(got[:, np.arange(f), fill] == 0.0)
    assert np.abs(got).sum() > 0


def test_sparse_kernel_duplicate_child_ids(dev):
    X, fill, lid, w3 = sparse_case(L=12)
    store, _ = sm.build_chunked_store(X, fill, 14, entry_chunk=128)
    cid = np.array([2, 5, 2], np.int32)
    got = sm.sparse_wave_histogram(
        _on(store, dev), *[t(a).to(dev) for a in (lid, w3, cid)], 14,
        X.shape[1])
    want = sm.sparse_wave_histogram(store, t(lid), t(w3), t(cid), 14,
                                    X.shape[1])
    assert torch.equal(got[0], got[2])
    assert_hist_close(got.cpu().numpy(), want.numpy(), w3)


def _check_b6_against_b3(dev, X, fill, lid, w3, cid, b, entry_chunk=128,
                         auto_uniform=False):
    """B6 on a store built from X against B3 on X_t with the same leaf
    ids, w3, child ids and exponents: every non-fill cell equal to the
    bit, fill cells exactly 0, within the float64 tolerance of the plain
    version, repeats equal.  Returns B6's histogram."""
    store, _ = sm.build_chunked_store(X, fill, b, entry_chunk=entry_chunk,
                                      auto_uniform=auto_uniform)
    f = X.shape[1]
    ids, w, c = t(lid).to(dev), t(w3).to(dev), t(cid).to(dev)
    exps = wk.fixed_point_exponents(w)
    on_card = _on(store, dev)
    got = sm.sparse_wave_histogram(on_card, ids, w, c, b, f, exps=exps)
    again = sm.sparse_wave_histogram(on_card, ids, w, c, b, f)
    dense = wk.wave_histogram(t(X.T).to(dev), ids, w, c, b, exps=exps)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    fill_cell = torch.zeros((f, b), dtype=torch.bool, device=dev)
    fill_cell[torch.arange(f, device=dev), t(fill).long().to(dev)] = True
    assert bool((got[:, fill_cell] == 0).all())
    assert torch.equal(got[:, ~fill_cell], dense[:, ~fill_cell])
    assert bool((got[:, ~fill_cell] != 0).any())
    w64 = t(w3).double()
    want = sm.chunked_child_hists_plain(store, t(lid), w64, t(cid), b, f)
    scale = sm.chunked_child_hists_plain(store, t(lid), w64.abs(), t(cid),
                                         b, f)
    assert _within_f64(got, want, scale, float(np.abs(w3).max()))
    return got


@pytest.mark.parametrize("kind", ["plain", "bundled", "k32"])
@pytest.mark.parametrize("auto_uniform", [False, True])
def test_sparse_kernel_bit_equal_to_b3(dev, kind, auto_uniform):
    """B6's non-fill cells are B3's to the bit on the same rows and
    exponents: plain columns, EFB group columns, and K = 32 at 63 bins
    with an inactive and a repeated child id, in the narrow and the
    uniform chunk layout."""
    X, fill, lid, w3, cid, b = _sparse_kernel_case(kind)
    if kind == "k32":
        cid[-1] = cid[0]
    _check_b6_against_b3(dev, X.astype(np.uint8), fill, lid, w3, cid, b,
                         auto_uniform=auto_uniform)


def test_sparse_kernel_bin_tiles_past_one_row(dev):
    """Past one (slot, B, 3) int64 row of shared memory (B > 9,044) B6
    tiles its bin axis: at B = 16,383 (two tiles of 8,192 bins) on a
    small uint16 store its non-fill cells are B3's on the same rows' dense
    X_t to the bit, within tolerance of B6's plain version, the fill
    cells exactly 0, and the second tile holds entries.  The kernel's
    shared memory is the plan's."""
    b, k = 16383, 4
    X, fill, lid, w3 = sparse_case(n=20_000, f=9, b=b, L=2 * k, seed=11)
    assert X.dtype == np.uint16
    ks, threads, smem, tiles = sm.launch_plan(b, k)
    assert (ks, tiles) == (1, 2)
    assert _build.library().lgbt_sparse_hist_smem(-(-b // tiles), ks) == smem
    cid = np.array([0, 5, -1, 6], dtype=np.int32)
    n0 = sm.sparse_wave_histogram.launches
    got = _check_b6_against_b3(dev, X, fill, lid, w3, cid, b)
    assert sm.sparse_wave_histogram.launches == n0 + 2
    assert bool((got[..., 8192:, 2] != 0).any())


def test_sparse_kernel_255_bins_split_slots(dev):
    """At 255 bins one (K, B, 3) int64 histogram of K = 32 takes 196 KB,
    a block an SM with 1024 threads; K = 64 splits the slots over two
    slices, with a child id held in both slices (each slice sums it
    apart, to the same bits) and an inactive slot.  The kernel's shared
    memory is the plan's."""
    b, k = 255, 64
    X, fill, lid, w3 = sparse_case(n=6000, f=9, b=b, L=2 * k, seed=8)
    ks, threads, smem, tiles = sm.launch_plan(b, k)
    assert ks < k and (ks, threads, tiles) == (32, 1024, 1)
    assert _build.library().lgbt_sparse_hist_smem(b, ks) == smem
    assert sm.launch_plan(b, 32)[:2] == (32, 1024)
    cid = np.random.default_rng(8).permutation(2 * k)[:k].astype(np.int32)
    cid[40] = cid[3]                     # one id in both slices
    cid[5] = -1
    got = _check_b6_against_b3(dev, X, fill, lid, w3, cid, b)
    assert torch.equal(got[40], got[3]) and bool((got[5] == 0).all())


@pytest.mark.parametrize("bundled", [False, True])
def test_sparse_training_on_the_card_matches_the_cpu(dev, bundled):
    """Sparse CSR input through the entry-chunk store: the card (kernel
    B6 for every histogram) grows the CPU's trees; B1 and B3 never run."""
    import scipy.sparse as sps

    import lightgbm_tpu_torch as lgb

    rng = np.random.default_rng(0)
    n = 3000
    X = np.where(rng.random((n, 12)) < 0.2, rng.normal(size=(n, 12)), 0.0)
    X[:, 0] = rng.normal(size=n)
    if bundled:
        owner = rng.integers(0, 8, size=n)
        for j in range(4):
            X[:, 8 + j] = np.where(owner == j, rng.normal(size=n) + 2.0, 0.0)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.normal(size=n) > 0) * 1.0
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 4, "tpu_sparse": True, "tpu_sparse_kernel": True}
    C = sps.csr_matrix(X)
    n0 = (sm.sparse_wave_histogram.launches, wk.wave_partition_hist.launches,
          wk.wave_histogram.launches)
    on_card = lgb.train(p, lgb.Dataset(C, label=y), 3, device="cuda")
    stats = on_card.grow_stats()
    assert (on_card._gbdt.train_data.bundle is not None) == bundled
    assert (sm.sparse_wave_histogram.launches - n0[0]
            == _launched_passes(on_card) + len(stats))
    assert wk.wave_partition_hist.launches == n0[1]
    assert wk.wave_histogram.launches == n0[2]
    on_cpu = lgb.train(p, lgb.Dataset(C, label=y), 3, device="cpu")
    keys = ("split_feature", "left_child", "right_child", "leaf_count")

    def structure(s):
        return [ln for ln in s.splitlines() if ln.startswith(keys)]

    assert structure(on_card.model_to_string()) == structure(
        on_cpu.model_to_string())
    np.testing.assert_allclose(on_card.predict(C), on_cpu.predict(C),
                               rtol=1e-5)


@pytest.mark.parametrize("variant", [{}, {"tpu_histogram_mode": "pallas_t"},
                                     {"histogram_pool_size": 0.01}])
def test_training_on_the_card_matches_the_cpu(dev, variant):
    """A small binary run through the kernels grows the trees the plain
    versions grow on the CPU: split features, child pointers and leaf
    counts equal, predictions on the training rows to rtol 1e-5.
    Threshold values may name either of two bins around an empty one
    (chip_smoke.py small_run_matches_cpu says why).  The variants run the
    histogram-only kernel after a plain-tensor partition, and both
    children through it when the histogram cache is off."""
    import lightgbm_tpu_torch as lgb

    rng = np.random.default_rng(10)
    X = rng.normal(size=(2000, 10))
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
         + 0.1 * rng.normal(size=2000) > 0).astype(float)
    p = dict({"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
              "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
              "tpu_wave_width": 4}, **variant)
    n0 = (wk.wave_partition_hist.launches, wk.wave_histogram.launches)
    on_card = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cuda")
    fused = wk.wave_partition_hist.launches - n0[0]
    hist_only = wk.wave_histogram.launches - n0[1]
    trees = len(on_card.grow_stats())
    waves = _launched_passes(on_card)
    if not variant:
        assert (fused, hist_only) == (waves, trees)
    elif "tpu_histogram_mode" in variant:
        assert (fused, hist_only) == (0, trees + waves)
    else:
        assert (fused, hist_only) == (waves, trees + waves)
    on_cpu = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cpu")

    def structure(s):
        keys = ("split_feature", "left_child", "right_child", "leaf_count")
        return [ln for ln in s.splitlines() if ln.startswith(keys)]

    assert structure(on_card.model_to_string()) == structure(
        on_cpu.model_to_string())
    np.testing.assert_allclose(on_card.predict(X), on_cpu.predict(X),
                               rtol=1e-5)


def _within_f64(got, want, scale, wmax):
    """chip_smoke.py's phase-2 tolerance against a float64 plain result."""
    diff = (got.double().cpu() - want).abs()
    return bool((diff <= 1e-5 * scale + 1e-5 * wmax).all())


@pytest.mark.parametrize("k", [1, 4, 32])
def test_rowmajor_hist_kernel_matches_plain(dev, k):
    """B4 on X (N, F): K = 1 (the root), 4 and 32 slots over 2K leaves,
    with an inactive slot and a duplicate child id once K > 1; bit-equal
    to B3 on X_t."""
    X, _, w3, _, b = wave_data(n=20000, f=28, b=63, seed=k)
    rng = np.random.default_rng(k)
    lid = rng.integers(0, 2 * k, size=len(X)).astype(np.int32)
    cid = rng.permutation(2 * k)[:k].astype(np.int32)
    if k > 1:
        cid[1] = -1
        cid[-1] = cid[0]
    _check_hist(dev, X, lid, w3, cid, b)


@pytest.mark.parametrize("n,f,b,kind,leaf", LEAF_CASES
                         + [(20000, 968, 255, "fractional", 1)])
@pytest.mark.parametrize("copies", [0, 1])
def test_leaf_hist_kernel_matches_plain(dev, n, f, b, kind, leaf, copies):
    """B5 on the CPU cases, and a wide shape (968 features at 255 bins,
    past what a cluster holds: B4's plan, many feature groups), through
    the wrapper (its plan, ``leaf_plan``) and launched as B4's chain at K
    = 1 with that plan's copies (0) or one copy, each with the weight
    rows and exponents built inside and handed in: within the float64
    tolerance, bit-identical across plans, repeats and the two ways of
    calling."""
    X, g, h, lid, rm = leaf_case(n, f, b, kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = wk.hist_plan(f, n, b, 1, sms)[:6]
    assert bool(lh.leaf_plan(f, b).fused) == (f != 968)
    if f == 968:
        assert plan[1] > 1                 # more than one feature group
    dargs = [t(a).to(dev) for a in (X, g, h, lid)]
    drm = None if rm is None else t(rm).to(dev)
    w3 = weight_rows(dargs[1], dargs[2], drm)
    exps = wk.fixed_point_exponents(w3)
    n0 = lh.leaf_histogram.launches
    got = lh.leaf_histogram(*dargs, leaf, drm, b)
    again = lh.leaf_histogram(*dargs, torch.tensor([leaf], device=dev), drm,
                              b, w3=w3, exps=exps)
    leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
    other = lh._launch(dargs[0], w3, dargs[3], leaf_t, b, exps,
                       plan[:5] + (copies or plan[5],))
    torch.cuda.synchronize()
    assert lh.leaf_histogram.launches == n0 + 2
    assert torch.equal(got, again) and torch.equal(got, other)
    rm64 = None if rm is None else t(rm).double()
    want = lh.leaf_histogram_plain(t(X), t(g).double(), t(h).double(),
                                   t(lid), leaf, rm64, b)
    scale = lh.leaf_histogram_plain(t(X), t(g).double().abs(),
                                    t(h).double().abs(), t(lid), leaf,
                                    None if rm is None else rm64.abs(), b)
    wmax = float(max(np.abs(g).max(), np.abs(h).max(), 1.0)
                 * (1.0 if rm is None else np.abs(rm).max()))
    assert _within_f64(got, want, scale, wmax)
    if leaf == 9:
        assert bool((got == 0).all())


@pytest.mark.parametrize("leaf", [0, 5])
def test_leaf_hist_kernel_bit_equal_to_b4(dev, leaf):
    """At the flagship shape (N = 2M, F = 28, B = 63, a 64-leaf state
    with bagging multipliers): B5 on leaf 5 and on the root (every row in
    leaf 0) equals B4 at K = 1 on the same X, leaf ids, w3 and exponents,
    bit for bit."""
    n, f, b = 2_000_000, 28, 63
    g = torch.Generator(device="cpu").manual_seed(leaf)
    X = torch.randint(0, b, (n, f), generator=g, dtype=torch.uint8).to(dev)
    lid = (torch.randint(0, 64, (n,), generator=g, dtype=torch.int32)
           if leaf else torch.zeros(n, dtype=torch.int32)).to(dev)
    grad = torch.randn(n, generator=g).to(dev)
    hess = (torch.rand(n, generator=g) + 0.05).to(dev)
    rm = (torch.rand(n, generator=g) > 0.2).float().to(dev)
    w3 = weight_rows(grad, hess, rm)
    exps = wk.fixed_point_exponents(w3)
    leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
    got = lh.leaf_histogram(X, grad, hess, lid, leaf_t, rm, b, w3=w3,
                            exps=exps)
    b4 = wk.wave_histogram_rowmajor(X, lid, w3, leaf_t, b, exps=exps)
    torch.cuda.synchronize()
    assert torch.equal(got, b4[0]) and bool((got != 0).any())


@pytest.mark.parametrize("objective,bundled,more", [
    ("binary", False, dict(SAMPLED, max_depth=4)),
    ("regression", True, {}),
])
@pytest.mark.parametrize("cache", [True, False])
def test_exact_growth_equals_wave_width_1_on_the_card(dev, objective,
                                                      bundled, more, cache):
    """Exact growth (B5) and wave growth at width 1 on the row-major bins
    (B4) and through the fused step (B1, B3) train byte-identical model
    text on the card, with and without the histogram cache: every
    histogram of the three is the f32 rounding of the same fixed-point
    sum (tests/test_torch_exact_train.py's fixtures)."""
    import lightgbm_tpu_torch as lgb

    X, s = parity_data(7, 2500, bundled)
    y = labels(objective, s)
    params = parity_params(objective, dict(more, **({} if cache
                                                   else NO_CACHE)))
    n0 = (lh.leaf_histogram.launches, wk.wave_histogram_rowmajor.launches)
    exact = lgb.train(dict(params, tpu_growth="exact",
                           tpu_histogram_mode="pallas"),
                      lgb.Dataset(X, label=y), 5, device="cuda")
    assert exact._gbdt.learner.cache_hists == cache
    assert ((exact._gbdt.train_data.bundle is not None) == bundled)
    assert lh.leaf_histogram.launches > n0[0]
    texts = [exact.model_to_string()]
    for mode in ("pallas", "pallas_ct"):
        wave = lgb.train(dict(params, tpu_growth="wave", tpu_wave_width=1,
                              tpu_histogram_mode=mode),
                         lgb.Dataset(X, label=y), 5, device="cuda")
        texts.append(wave.model_to_string())
    assert wk.wave_histogram_rowmajor.launches > n0[1]
    assert texts[0] == texts[1] == texts[2]


def test_kernels_large_f_times_n_past_2_31(dev):
    """F x N past 2^31 (8.5M rows x 256 features of random bins made on
    the card, 2.2 GB a layout): B3 on X_t, B4 on X and B5 on X take it.
    The features whose bytes lie past 2^31 in X_t (f * N >= 2^31: the
    last three) are held against a float64 torch.bincount of those
    features alone; B4 equals B3 and B5 equals B4's slot, bit for bit."""
    n, f, b = 8_500_000, 256, 256
    assert f * n >= 2 ** 31 and (f - 3) * n >= 2 ** 31
    g = torch.Generator(device=dev).manual_seed(3)
    X = torch.randint(0, b, (n, f), generator=g, dtype=torch.uint8,
                      device=dev)
    lid = torch.randint(0, 4, (n,), generator=g, dtype=torch.int32,
                        device=dev)
    grad = torch.randn(n, generator=g, device=dev)
    hess = torch.rand(n, generator=g, device=dev) + 0.05
    rm = (torch.rand(n, generator=g, device=dev) > 0.2).float()
    w3 = weight_rows(grad, hess, rm)
    exps = wk.fixed_point_exponents(w3)
    cid = torch.tensor([1, 3], dtype=torch.int32, device=dev)
    rowmajor = wk.wave_histogram_rowmajor(X, lid, w3, cid, b, exps=exps)
    leaf = lh.leaf_histogram(X, grad, hess, lid, cid[1:], rm, b, w3=w3,
                             exps=exps)
    tail = X[:, f - 3:].long()                     # (N, 3)
    X_t = X.t().contiguous()
    del X
    torch.cuda.empty_cache()
    got = wk.wave_histogram(X_t, lid, w3, cid, b, exps=exps)
    torch.cuda.synchronize()
    assert torch.equal(got, rowmajor) and torch.equal(leaf, rowmajor[1])
    idx = (torch.arange(3, device=dev)[None, :] * b + tail)    # (N, 3)
    w64 = w3.double()
    wmax = float(w3.abs().max())
    for k in range(2):
        rows = lid == cid[k]
        cell = idx[rows].reshape(-1)
        for c in range(3):
            wc = w64[rows, c].repeat_interleave(3)
            want = torch.bincount(cell, weights=wc, minlength=3 * b)
            scale = torch.bincount(cell, weights=wc.abs(), minlength=3 * b)
            have = got[k, f - 3:, :, c].double().reshape(-1)
            assert bool(((have - want).abs()
                         <= 1e-5 * scale + 1e-5 * wmax).all())
            assert bool((have != 0).all())


@pytest.mark.parametrize("growth", ["exact", "wave"])
@pytest.mark.parametrize("variant", [{}, NO_CACHE])
def test_pallas_training_on_the_card_matches_the_cpu(dev, growth, variant):
    """tpu_histogram_mode=pallas on the card: exact growth through B5 (the
    root and the smaller child of each split, both children without the
    cache), wave growth through B4 (the root and each wave, twice a wave
    without the cache); no other histogram kernel runs, and the card
    grows the CPU's trees (compared as
    test_training_on_the_card_matches_the_cpu compares them)."""
    import lightgbm_tpu_torch as lgb

    X, s = parity_data(10, 2000, False)
    y = (s > 0).astype(float)
    p = dict({"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
              "tpu_growth": growth, "tpu_histogram_mode": "pallas",
              "tpu_wave_width": 4}, **variant)
    counters = (lh.leaf_histogram, wk.wave_histogram_rowmajor,
                wk.wave_partition_hist, wk.wave_histogram,
                sm.sparse_wave_histogram)
    n0 = [c.launches for c in counters]
    on_card = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cuda")
    counts = [c.launches - a for c, a in zip(counters, n0)]
    stats = on_card.grow_stats()
    passes = (len(stats) + _launched_passes(on_card)
              * (1 if on_card._gbdt.learner.cache_hists else 2))
    assert counts == ([passes, 0, 0, 0, 0] if growth == "exact"
                      else [0, passes, 0, 0, 0])
    if growth == "exact":
        assert all(st.passes == st.num_leaves - 1 for st in stats)
    on_cpu = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cpu")
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    assert ([ln for ln in on_card.model_to_string().splitlines()
             if ln.startswith(keys)]
            == [ln for ln in on_cpu.model_to_string().splitlines()
                if ln.startswith(keys)])
    np.testing.assert_allclose(on_card.predict(X), on_cpu.predict(X),
                               rtol=1e-5)


@pytest.mark.parametrize("fixture", ["small_run", "bundled"])
@pytest.mark.parametrize("cache", [True, False])
def test_dense_dataflows_train_the_same_model_text(dev, fixture, cache):
    """On the card the three dense dataflows -- pallas_ct (B1 a wave, B3
    for the root), pallas_t (B3 for every histogram) and pallas (B4 on
    the row-major bins) -- sum every histogram in the tree's fixed point,
    so they train byte-identical model text; with and without the
    histogram cache, and on EFB group columns.  chip_smoke.py's small-run
    fixture, and tests/torch_cases.py parity_data with four bundled
    columns."""
    import lightgbm_tpu_torch as lgb

    if fixture == "small_run":
        rng = np.random.default_rng(10)
        X = rng.normal(size=(2000, 10))
        y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.5 * X[:, 9]
             + 0.1 * rng.normal(size=2000) > 0).astype(float)
    else:
        X, s = parity_data(3, 2000, True)
        y = (s > 0).astype(float)
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor)
    texts = []
    for mode in ("pallas_ct", "pallas_t", "pallas"):
        p = dict({"objective": "binary", "num_leaves": 15,
                  "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
                  "tpu_growth": "wave", "tpu_wave_width": 4,
                  "tpu_histogram_mode": mode}, **({} if cache else NO_CACHE))
        n0 = [c.launches for c in counters]
        booster = lgb.train(p, lgb.Dataset(X, label=y), 3, device="cuda")
        counts = [c.launches - a for c, a in zip(counters, n0)]
        learner = booster._gbdt.learner
        assert (learner.hist_mode, learner.cache_hists) == (mode, cache)
        assert ((booster._gbdt.train_data.bundle is not None)
                == (fixture == "bundled"))
        stats = booster.grow_stats()
        trees, waves = len(stats), _launched_passes(booster)
        extra = 0 if cache else waves       # the larger children
        assert counts == {"pallas_ct": [waves, trees + extra, 0],
                          "pallas_t": [0, trees + waves + extra, 0],
                          "pallas": [0, 0, trees + waves + extra]}[mode]
        texts.append(booster.model_to_string())
    assert texts[0] == texts[1] == texts[2]


# ------------------------------------------- the fused iteration (graphs)
FUSED_FLOWS = ["pallas_ct", "pallas_t", "pallas", "sparse"]


def _fused_case(flow, more=None):
    """(params, X, y) of a small binary run on flow: a dense histogram
    mode under wave growth, or the entry-chunk sparse store."""
    import scipy.sparse as sps

    X, s = parity_data(3, 2000, False)
    p = dict({"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
              "tpu_growth": "wave", "tpu_wave_width": 4}, **(more or {}))
    if flow == "sparse":
        X = np.where(np.abs(X) < 0.8, 0.0, X)
        p.update(tpu_sparse=True, tpu_sparse_kernel=True)
        X = sps.csr_matrix(X)
    else:
        p["tpu_histogram_mode"] = flow
    return p, X, (s > 0).astype(float)


def _fused_pair(flow, rounds=5, more=None):
    """The same data trained on the card fused (auto) and staged (off)."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _fused_case(flow, more)
    fused = lgb.train(p, lgb.Dataset(X, label=y), rounds, device="cuda")
    staged = lgb.train(dict(p, tpu_fused_iter="off"),
                       lgb.Dataset(X, label=y), rounds, device="cuda")
    assert fused._gbdt._fused_state[0] is not None
    assert staged._gbdt._fused_state == (None,)
    return fused, staged, X


@pytest.mark.parametrize("flow", FUSED_FLOWS)
def test_fused_trains_the_staged_model_text_on_the_card(dev, flow):
    """tpu_fused_iter=auto fuses on the card: the tree graph (gradients,
    root, M masked waves), one host read, tail-wave graphs and the B2
    graph train the staged chain's model text to the byte, for the three
    dense dataflows and the sparse store."""
    fused, staged, X = _fused_pair(flow)
    assert fused.model_to_string() == staged.model_to_string()
    np.testing.assert_array_equal(fused.predict(X), staged.predict(X))
    for f, s in zip(fused.grow_stats(), staged.grow_stats()):
        assert (f.num_leaves, f.passes) == (s.num_leaves, s.passes)
        assert f.host_reads == 1 + f.tail_passes
    assert fused._gbdt._fused_state[0].replays > 0


def test_fused_stored_trees_are_not_aliased(dev):
    """The graphs write the same tree buffers every iteration; the model
    keeps a copy of each tree, so the 5 trees of the model text are the
    staged chain's 5 trees, not 5 copies of the last one."""
    fused, staged, _ = _fused_pair("pallas_ct", rounds=5)
    text = fused.model_to_string()
    trees = [blk.split("\n\n")[0] for blk in text.split("Tree=")[1:]]
    assert len(trees) == 5 and len(set(trees)) == 5
    assert text == staged.model_to_string()


@pytest.mark.parametrize("flow", ["pallas_ct", "sparse"])
def test_fused_launch_counters_count_replays(dev, flow):
    """A replay adds the launches its capture recorded: B2 once an
    iteration, and each wave's histogram kernel once for each of the M
    masked waves and tail waves of a tree; the root's once a tree."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import fused_iter as fi

    p, X, y = _fused_case(flow)
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                sm.sparse_wave_histogram, tp.score_update)
    n0 = [c.launches for c in counters]
    booster = lgb.train(p, lgb.Dataset(X, label=y), 5, device="cuda")
    counts = [c.launches - a for c, a in zip(counters, n0)]
    stats = booster.grow_stats()
    passes = len(stats) * fi.wave_count(15, 4) + sum(
        s.tail_passes for s in stats)
    trees = len(stats)
    assert booster._gbdt._fused_state[0].replays >= 2 * 4
    if flow == "sparse":
        assert counts == [0, 0, trees + passes, 5]
    else:
        assert counts == [passes, trees, 0, 5]


@pytest.mark.parametrize("flow", ["pallas_ct", "pallas_t", "pallas",
                                  "sparse"])
def test_fused_tree_makes_no_host_sync(dev, flow):
    """The tree pass (gradients, weight rows, exponents, the root, M
    masked waves), a tail wave and the score update run eagerly under
    torch.cuda.set_sync_debug_mode('error') without raising: nothing
    before the one per-tree read waits for the device."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _fused_case(flow, {"bagging_fraction": 0.8,
                                 "bagging_freq": 1,
                                 "feature_fraction": 0.8})
    booster = lgb.Booster(p, lgb.Dataset(X, label=y), device="cuda")
    gbdt = booster._gbdt
    fused = gbdt._resolve_fused_iter()
    gbdt._bagging(0)
    fused.row_mult.copy_(gbdt.row_mult)
    fused.feature_mask.copy_(gbdt.learner.sample_feature_mask())
    score = gbdt._score_dev[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fused.tree_pass(score)
        fused.tail_pass()
        fused.score_pass(score, 0.1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert fused.state.status.tolist()[0] == 1


def test_fused_capture_failure_raises(dev):
    """An objective that reads the device cannot be captured: the
    capture after the first (eager) iteration raises, and training does
    not fall back to the staged chain."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _fused_case("pallas_ct")
    booster = lgb.Booster(p, lgb.Dataset(X, label=y), device="cuda")
    obj = booster._gbdt.objective
    real = obj.get_gradients

    def reads_the_device(score):
        float(score.sum())
        return real(score)

    obj.get_gradients = reads_the_device
    stream = torch.cuda.current_stream()
    with pytest.raises(RuntimeError):
        booster.update()
    # the caller's stream is current again, not the failed capture's
    assert torch.cuda.current_stream() == stream
    torch.cuda.synchronize()
    assert booster._gbdt._fused_state[0] is not None


# --------------------------- exact growth fused, and exact-order waves
def _exact_case(more=None):
    """(params, X, y) of a small binary run under exact growth."""
    X, s = parity_data(3, 2000, False)
    p = dict({"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
              "tpu_growth": "exact", "tpu_histogram_mode": "pallas"},
             **(more or {}))
    return p, X, (s > 0).astype(float)


@pytest.mark.parametrize("variant", [{}, NO_CACHE, SAMPLED])
def test_fused_exact_trains_the_staged_model_text_on_the_card(dev, variant):
    """tpu_fused_iter=auto fuses exact growth on the card: the tree graph
    (gradients, root, S gated splits), its read, tail graphs of S splits
    and the B2 graph train the staged exact chain's model text to the
    byte, one host read a block of S splits."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.ops import fused_iter as fi

    p, X, y = _exact_case(variant)
    fused = lgb.train(p, lgb.Dataset(X, label=y), 5, device="cuda")
    staged = lgb.train(dict(p, tpu_fused_iter="off"),
                       lgb.Dataset(X, label=y), 5, device="cuda")
    it = fused._gbdt._fused_state[0]
    assert it is not None and staged._gbdt._fused_state == (None,)
    assert it.passes == it.tail_len == min(fi.SPLIT_BLOCK, 14)
    assert fused.model_to_string() == staged.model_to_string()
    for f, s in zip(fused.grow_stats(), staged.grow_stats()):
        assert (f.num_leaves, f.passes) == (s.num_leaves, s.passes)
        assert f.host_reads == max(1, -(-f.passes // it.tail_len))
    assert it.replays > 0


@pytest.mark.parametrize("flow", FUSED_FLOWS)
def test_exact_order_trains_the_leaf_wise_model_text_on_the_card(dev, flow):
    """Exact-order waves at W = 32 (31 leaves) train exact growth's model
    text to the byte on the three dense dataflows, fused and staged, and
    the sparse store its own W = 1 text: every histogram is the same
    fixed-point sum at any width, and the split search gives each child
    the same bits in a batch of 64 children as in a batch of 2."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _fused_case(flow, {"num_leaves": 31, "tpu_wave_width": 32,
                                 "tpu_wave_order": "exact"})
    texts = []
    for chain in ("auto", "off"):
        b = lgb.train(dict(p, tpu_fused_iter=chain), lgb.Dataset(X, label=y),
                      5, device="cuda")
        assert (b._gbdt._fused_state[0] is None) == (chain == "off")
        texts.append(b.model_to_string())
    if flow == "sparse":
        ref = dict(p, tpu_wave_width=1, tpu_wave_order="batched")
    else:
        ref = dict(p, tpu_growth="exact", tpu_histogram_mode="pallas")
    want = lgb.train(ref, lgb.Dataset(X, label=y), 5, device="cuda")
    assert texts[0] == texts[1] == want.model_to_string()


def test_fused_exact_launch_counters_count_replays(dev):
    """Under fused exact growth B5 counts once a tree for the root and
    once for each of the S gated splits of the tree graph and of every
    tail graph (no-op splits past a tree's end included); B2 once an
    iteration; no other histogram kernel."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _exact_case()
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor, lh.leaf_histogram,
                tp.score_update)
    n0 = [c.launches for c in counters]
    booster = lgb.train(p, lgb.Dataset(X, label=y), 5, device="cuda")
    counts = [c.launches - a for c, a in zip(counters, n0)]
    it = booster._gbdt._fused_state[0]
    stats = booster.grow_stats()
    passes = sum(it.passes + s.tail_passes for s in stats)
    assert it.replays >= 2 * 4
    assert counts == [0, 0, 0, len(stats) + passes, 5]


def test_fused_exact_tree_makes_no_host_sync(dev):
    """The exact tree pass (gradients, weight rows, exponents, the root,
    S gated splits), a tail block and the score update run eagerly under
    torch.cuda.set_sync_debug_mode('error') without raising, with
    bagging and feature_fraction, with and without the histogram cache:
    nothing before a block's read waits for the device."""
    import lightgbm_tpu_torch as lgb

    for more in ({}, NO_CACHE):
        p, X, y = _exact_case(dict(SAMPLED, **more))
        booster = lgb.Booster(p, lgb.Dataset(X, label=y), device="cuda")
        gbdt = booster._gbdt
        fused = gbdt._resolve_fused_iter()
        gbdt._bagging(0)
        fused.row_mult.copy_(gbdt.row_mult)
        fused.feature_mask.copy_(gbdt.learner.sample_feature_mask())
        score = gbdt._score_dev[0]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fused.tree_pass(score)
            fused.tail_pass()
            fused.score_pass(score, 0.1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert fused.state.status.tolist()[0] == 1


@pytest.mark.parametrize("leaf", [-1, 64, 5000])
def test_leaf_hist_kernel_leaf_no_row_holds_is_zero(dev, leaf):
    """B5 given a device-tensor leaf that no row holds (the inactive id
    -1 a gated split passes, an id past every row's, one past the slot
    table) returns exact zeros, with no host sync."""
    n, f, b = 5000, 7, 63
    g = torch.Generator().manual_seed(3)
    X = torch.randint(0, b, (n, f), generator=g, dtype=torch.uint8).to(dev)
    lid = torch.randint(0, 64, (n,), generator=g,
                        dtype=torch.int32).to(dev)
    w3 = torch.randn(n, 3, generator=g).to(dev)
    exps = wk.fixed_point_exponents(w3)
    leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = lh.leaf_histogram(X, None, None, lid, leaf_t, None, b, w3=w3,
                                exps=exps)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert got.shape == (f, b, 3) and not bool(got.any())
    held = lh.leaf_histogram(X, None, None, lid, leaf_t.clamp(0, 63), None,
                             b, w3=w3, exps=exps)
    assert bool(held.any())


def test_boosters_give_their_device_memory_back(dev):
    """Boosters of two row counts, fused and staged, under wave and exact
    growth, trained one after another: once each is deleted the device
    memory in use is back at its baseline.  The list passes' workspace
    lives in the grower's state and goes with its booster; nothing is
    kept for the process per stream, row count or size."""
    import gc

    import lightgbm_tpu_torch as lgb

    def train(n, more):
        X, s = parity_data(3, n, False)
        p = dict({"objective": "binary", "num_leaves": 15,
                  "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
                  "tpu_wave_width": 4}, **more)
        booster = lgb.train(p, lgb.Dataset(X, label=(s > 0).astype(float)),
                            3, device="cuda")
        assert (booster._gbdt._fused_state[0] is None) == (
            more.get("tpu_fused_iter") == "off")
        del booster
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(dev)

    flows = ({"tpu_histogram_mode": "pallas_ct"},
             {"tpu_histogram_mode": "pallas_ct", "tpu_fused_iter": "off"},
             {"tpu_growth": "exact", "tpu_histogram_mode": "pallas"},
             {"tpu_growth": "exact", "tpu_histogram_mode": "pallas",
              "tpu_fused_iter": "off"})
    base = train(2000, flows[0])
    after = [train(n, more) for n in (2000, 3000, 2000) for more in flows]
    assert after == [base] * len(after)


def test_score_update_into_a_row_of_a_class_score(dev):
    """B2 into row tid of a (K, N) score, in place, as a multiclass
    iteration runs it: the row bit-equal to the plain version, the
    other rows untouched."""
    score, lid, lv, scale = score_case(50_001, 15)
    rng = np.random.default_rng(2)
    k_score = rng.normal(size=(3, len(score))).astype(np.float32)
    k_score[1] = score
    d = t(k_score).to(dev)
    before = tp.score_update.launches
    row = d[1]
    out = tp.update_score_from_partition(row, t(lid).to(dev),
                                         t(lv).to(dev), scale, out=row)
    assert out.data_ptr() == d.data_ptr() + d.stride(0) * 4
    assert tp.score_update.launches == before + 1
    want = tp.score_update_plain(t(score), t(lid),
                                 clipped_leaf_values(t(lv), float(scale)))
    got = d.cpu()
    assert torch.equal(got[1], want)
    assert torch.equal(got[0], t(k_score[0]))
    assert torch.equal(got[2], t(k_score[2]))


MODES = [({"objective": "multiclass", "num_class": 3}, 3),
         ({"objective": "multiclassova", "num_class": 3}, 3),
         ({"objective": "binary", "boosting": "dart", "drop_rate": 0.5,
           "skip_drop": 0.0}, 1),
         ({"objective": "regression", "boosting": "infinite"}, 1)]


@pytest.mark.parametrize("more,k", MODES)
def test_boosting_modes_on_the_card_match_the_cpu(dev, more, k):
    """Multiclass (K trees an iteration), DART and InfiniteBoost
    train on the card through the kernels, staged (B3 once a tree, B1
    once a wave, B2 once a tree into its class's row), and grow the CPU
    plain versions' trees: the same partitions, predictions on the
    training rows to rtol 1e-5."""
    import lightgbm_tpu_torch as lgb

    X, s = parity_data(3, 2000, False)
    y = (np.digitize(s, [-0.6, 0.6]).astype(float) if k > 1
         else labels(more["objective"], s))
    p = dict({"num_leaves": 15, "min_data_in_leaf": 20, "max_bin": 63,
              "verbose": -1, "tpu_growth": "wave", "tpu_wave_width": 4},
             **more)
    counters = (wk.wave_partition_hist, wk.wave_histogram, tp.score_update)
    n0 = [c.launches for c in counters]
    card = lgb.train(p, lgb.Dataset(X, label=y), 5, device="cuda")
    b1, b3, b2 = (c.launches - a for c, a in zip(counters, n0))
    assert card._gbdt._fused_state == (None,)
    stats = card.grow_stats()
    stub = 1 if card._gbdt.boost_from_average_used else 0
    assert len(stats) == 5 * k == card.num_trees() - stub
    assert (b1, b3, b2) == (sum(s.passes for s in stats), 5 * k, 5 * k)
    cpu = lgb.train(p, lgb.Dataset(X, label=y), 5, device="cpu")

    def partitions(s):
        keys = ("split_feature", "left_child", "right_child", "leaf_count")
        return [ln for ln in s.splitlines() if ln.startswith(keys)]

    assert partitions(card.model_to_string()) == partitions(
        cpu.model_to_string())
    np.testing.assert_allclose(card.predict(X), cpu.predict(X), rtol=1e-5,
                               atol=1e-7)


def test_binary_fused_after_class_scores(dev):
    """Scores are (K, N) now: the binary run still fuses under auto, its
    graphs hold row 0 of the (1, N) score (the tensor's own storage),
    replays happen, and the fused model text is the staged one."""
    fused, staged, X = _fused_pair("pallas_ct", rounds=4)
    it = fused._gbdt._fused_state[0]
    score = fused._gbdt._score_dev
    assert score.shape == (1, len(X))
    assert it._score_key[0] == score[0].data_ptr() == score.data_ptr()
    assert it.replays > 0
    assert fused.model_to_string() == staged.model_to_string()


def test_goss_on_the_card_matches_the_cpu_through_the_first_sample(dev):
    """GOSS (learning_rate 0.5: sampling from iteration 2) on the card,
    staged: the trees before sampling and the first sampled tree are the
    CPU's (the partitions of the rows they weigh), the first sample keeps
    the same rows with the same multipliers, and the kept rows predict
    the same after it.  Later iterations may part: a bin that holds only
    left-out rows (weight 0) is empty to the split search, either
    threshold of the gap may win on rounding, and a left-out row may land
    in another leaf (chip_smoke.py goss_matches_cpu, ROADMAP C)."""
    import lightgbm_tpu_torch as lgb

    X, s = parity_data(3, 2000, False)
    y = labels("binary", s)
    p = {"objective": "binary", "boosting": "goss", "learning_rate": 0.5,
         "num_leaves": 15, "min_data_in_leaf": 20, "max_bin": 63,
         "verbose": -1, "tpu_growth": "wave", "tpu_wave_width": 4}
    keys = ("split_feature", "left_child", "right_child", "leaf_count")
    runs = []
    for device in ("cuda", "cpu"):
        mults = []

        def keep(env):
            m = env.model._gbdt.row_mult
            mults.append(None if m is None else m.cpu().numpy())
        b = lgb.train(p, lgb.Dataset(X, label=y), 4, device=device,
                      callbacks=[keep])
        trees = [[ln for ln in blk.splitlines() if ln.startswith(keys)]
                 for blk in b.model_to_string().split("Tree=")[1:]]
        runs.append((b, mults, trees))
    (card, mc, tc), (cpu, mp, tp_) = runs
    assert card._gbdt._fused_state == (None,)
    assert mc[0] is mc[1] is mp[0] is mp[1] is None
    np.testing.assert_array_equal(mc[2], mp[2])
    assert 0 < mc[2].sum() < len(X)
    assert tc[:3] == tp_[:3]
    kept = mc[2] > 0
    np.testing.assert_allclose(card.predict(X[kept], num_iteration=3),
                               cpu.predict(X[kept], num_iteration=3),
                               rtol=1e-5)


# ------------------------------------------------- prediction and serving
def _predict_case(objective="binary", rows=3000, seed=21):
    """(params, X, y) of a small model for the predict and serve tests."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, 8))
    X[rng.random(X.shape) < 0.1] = 0.0
    s = X[:, 0] + 0.6 * X[:, 1] - 0.4 * X[:, 3] + 0.2 * rng.normal(size=rows)
    p = {"objective": objective, "num_leaves": 31, "min_data_in_leaf": 10,
         "max_bin": 63, "verbose": -1}
    if objective == "multiclass":
        p["num_class"] = 3
        y = np.digitize(s, [-0.5, 0.5]).astype(float)
    else:
        y = (s > 0).astype(float)
    return p, X, y


def _query(X, seed=22):
    rng = np.random.default_rng(seed)
    Xq = X + 0.1 * rng.normal(size=X.shape)
    Xq[rng.random(Xq.shape) < 0.03] = np.nan
    Xq[rng.random(Xq.shape) < 0.03] = 0.0
    return Xq


@pytest.mark.parametrize("objective", ["binary", "multiclass"])
def test_ranked_scores_on_the_card_equal_the_cpu_to_the_bit(dev, objective):
    """Raw scores of the ranked traversal and of the serving graphs on the
    card equal the port's CPU scores bit for bit (elementwise operations
    only, each its own, so no fused multiply-add can form); converted
    scores agree within 1e-6."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serve import PredictExecutableCache

    p, X, y = _predict_case(objective)
    text = lgb.train(p, lgb.Dataset(X, label=y), 8,
                     device="cpu").model_to_string()
    Xq = _query(X)
    card = lgb.Booster(model_str=text, device="cuda")
    cpu = lgb.Booster(model_str=text, device="cpu")
    for b in (card, cpu):
        b._gbdt.config.tpu_predict = "true"
    raw_card = card.predict(Xq, raw_score=True)
    np.testing.assert_array_equal(raw_card, cpu.predict(Xq, raw_score=True))
    np.testing.assert_allclose(card.predict(Xq), cpu.predict(Xq), rtol=0,
                               atol=1e-6)
    caches = [PredictExecutableCache(b._gbdt, bucket_min=16, max_batch=512)
              for b in (card, cpu)]
    for convert in (False, True):
        got, want = (c.predict_batch(Xq[:700], convert=convert)
                     for c in caches)
        if convert:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got[:, 0] if got.shape[1] == 1
                                          else got, raw_card[:700])
    st = caches[0].stats()
    assert st["graphs"] == st["compiles"] == 2 * len(st["buckets"])


def test_bulk_predict_chunks_on_the_card_change_no_bit(dev, monkeypatch):
    """The one-deep pipeline's chunks (pinned encode, copies behind
    events) assemble the same bits as one chunk."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod

    p, X, y = _predict_case()
    b = lgb.train(dict(p, tpu_predict="true"), lgb.Dataset(X, label=y), 6,
                  device="cuda")
    Xq = _query(X)
    whole = b.predict(Xq, raw_score=True)
    monkeypatch.setattr(gbdt_mod.GBDT, "_predict_chunk_rows",
                        staticmethod(lambda nf, tb: 700))
    b._gbdt._ranked_pred_key = None
    np.testing.assert_array_equal(b.predict(Xq, raw_score=True), whole)


def test_graph_replays_from_the_worker_beside_bulk_predict(dev):
    """The scheduler's worker replays graphs while the main thread runs
    Booster.predict on the device path: every response equals the same
    rows served alone."""
    import threading

    import lightgbm_tpu_torch as lgb

    p, X, y = _predict_case()
    b = lgb.train(dict(p, tpu_predict="true"), lgb.Dataset(X, label=y), 8,
                  device="cuda")
    bulk = b.predict(X, raw_score=True)
    blocks = [(lo, 1 + (lo * 7) % 300) for lo in range(0, 2400, 40)]
    with b.serve(max_batch=512, max_delay_ms=1.0, bucket_min=16) as sp:
        sp.warmup([16, 32, 64, 128, 256, 512])
        solo = [sp.predict(X[lo:lo + n]) for lo, n in blocks]
        got, errors = {}, []

        def client(i):
            try:
                for j in range(i, len(blocks), 4):
                    lo, n = blocks[j]
                    got[j] = sp.submit(X[lo:lo + n]).result(timeout=60)
            except Exception as e:          # surfaced below
                errors.append(e)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for _ in range(5):
            np.testing.assert_array_equal(b.predict(X, raw_score=True), bulk)
        for t in ts:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in ts)
        assert sp.cache.steady_state_compiles == 0
    for j, want in enumerate(solo):
        np.testing.assert_array_equal(got[j], want)


def test_serving_capture_while_another_stream_trains(dev):
    """Bucket graphs captured (thread-local) while another thread trains
    fused on its own stream, capturing its own graphs: neither capture
    fails, the model trains the text it trains alone, and the serving
    graphs score as graphs captured on an idle card."""
    import threading

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.serve import PredictExecutableCache

    p, X, y = _predict_case()
    served = lgb.train(p, lgb.Dataset(X, label=y), 6, device="cuda")
    want = PredictExecutableCache(served._gbdt, bucket_min=16,
                                  max_batch=256).predict_batch(X[:500])
    pt, Xt, yt = _predict_case(rows=20000, seed=23)
    alone = lgb.train(pt, lgb.Dataset(Xt, label=yt), 6,
                      device="cuda").model_to_string()
    result, errors = {}, []

    def trainer():
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                b = lgb.train(pt, lgb.Dataset(Xt, label=yt), 6,
                              device="cuda")
                result["text"] = b.model_to_string()
                result["fused"] = b._gbdt._fused_state[0] is not None
        except Exception as e:              # surfaced below
            errors.append(e)

    th = threading.Thread(target=trainer)
    th.start()
    captures = 0
    while th.is_alive() and captures < 400:
        cache = PredictExecutableCache(served._gbdt, bucket_min=16,
                                       max_batch=256)
        cache.warmup([16, 32, 64, 128, 256])
        captures += cache.compiles
        np.testing.assert_array_equal(cache.predict_batch(X[:500]), want)
    th.join(timeout=300)
    assert not th.is_alive() and not errors, errors
    assert captures > 0 and result["fused"]
    assert result["text"] == alone


def test_loaded_booster_serves_on_the_card(dev):
    """Booster(model_str=..., device="cuda") predicts and serves on the
    card: the device route, graphs captured, the CPU-loaded booster's
    raw scores to the bit."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _predict_case("multiclass")
    text = lgb.train(p, lgb.Dataset(X, label=y), 5,
                     device="cpu").model_to_string()
    card = lgb.Booster(model_str=text, device="cuda")
    cpu = lgb.Booster(model_str=text, device="cpu")
    assert card.device.type == "cuda"
    with card.serve(max_batch=256, max_delay_ms=1.0, bucket_min=16) as sp, \
            cpu.serve(max_batch=256, max_delay_ms=1.0, bucket_min=16) as sc:
        got = sp.predict(X[:300], raw_score=True)
        np.testing.assert_array_equal(got, sc.predict(X[:300],
                                                      raw_score=True))
        conv = sp.predict(X[:300])
        assert conv.shape == (300, 3)
        np.testing.assert_allclose(conv, cpu.predict(X[:300]), rtol=0,
                                   atol=1e-6)
        st = sp.stats()
        assert st["routes"] == {"dev": 2}
        assert st["executables"]["graphs"] >= 2
        assert st["executables"]["device"].startswith("cuda")


def _categorical_data(seed, n):
    """tests/test_torch_train_parity.py's categorical fixture: two
    categorical columns (12 and 5 categories) beside four normal ones."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[:, 0] = rng.integers(0, 12, size=n)
    X[:, 1] = rng.integers(0, 5, size=n)
    effect = rng.normal(size=12)
    s = (effect[X[:, 0].astype(int)] + 0.8 * (X[:, 1] == 2) + X[:, 2]
         + 0.1 * rng.normal(size=n))
    return X, (s > 0).astype(float)


def test_categorical_training_on_the_card_matches_the_cpu(dev):
    """The pinned categorical fixture trains on the card the CPU's trees
    (as partitions of the training rows, with the same split features
    and decision types), and the ranked traversal's categorical branch
    routes on the card as the host trees route."""
    import lightgbm_tpu_torch as lgb

    X, y = _categorical_data(1, 2500)
    Xv, _ = _categorical_data(1001, 600)
    Xv[:40, 0] = 99.0
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 4}
    runs = [lgb.train(p, lgb.Dataset(X, label=y, categorical_feature=[0, 1]),
                      3, device=d) for d in ("cuda", "cpu")]
    shape = ("split_feature", "decision_type", "left_child", "right_child")
    trees = [[ln for ln in b.model_to_string().splitlines()
              if ln.startswith(shape)] for b in runs]
    assert trees[0] == trees[1]
    assert any("decision_type=" in ln and " 1" in ln for ln in trees[0])
    for b in runs:
        b._gbdt._materialize()
    parts = [np.stack([t.predict_leaf_index(X) for t in b._gbdt.models],
                      axis=1) for b in runs]
    np.testing.assert_array_equal(parts[0], parts[1])
    card = runs[0]
    rp = tp.build_ranked_predictor(card._gbdt.models, 1, 6, "cuda")
    assert rp.cat_features == frozenset({0, 1})
    V, D = tp.rank_encode(rp, Xv)
    leaves = tp.ranked_leaf_indices(rp.dev, torch.as_tensor(V, device=dev),
                                    torch.as_tensor(D, device=dev)).cpu()
    np.testing.assert_array_equal(
        leaves.numpy(),
        np.stack([t.predict_leaf_index(Xv) for t in card._gbdt.models],
                 axis=1))
    np.testing.assert_allclose(card.predict(Xv), runs[1].predict(Xv),
                               rtol=1e-5)


def test_host_library_builds_on_the_card_host():
    """The host library (native.py, csrc/host/native.cpp) builds with the
    host compiler into lightgbm_tpu_torch/_build and bins as its Python
    fallback does."""
    from lightgbm_tpu_torch import native
    from lightgbm_tpu_torch.io.binning import NUMERICAL, BinMapper

    assert native.available()
    assert native.lib_path.parent == native.BUILD_DIR
    assert native.BUILD_DIR.name == "_build"
    rng = np.random.default_rng(0)
    vals = rng.normal(size=5000)
    got, want = BinMapper(), BinMapper()
    got.find_bin(vals, 6000, 63, 3, 5, NUMERICAL)
    with native.disabled():
        want.find_bin(vals, 6000, 63, 3, 5, NUMERICAL)
    np.testing.assert_array_equal(got.bin_upper_bound, want.bin_upper_bound)


def _cli_data(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8))
    return X, (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] > 0).astype(float)


def _write_tsv(path, X, y):
    with open(path, "w") as f:
        for yy, row in zip(y, X):
            f.write("\t".join("%.17g" % v for v in (yy, *row)) + "\n")


CLI_PARAMS = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbose": -1}


def _cli_args(extra):
    return ["%s=%s" % kv for kv in CLI_PARAMS.items()] + extra


def test_cli_train_on_the_card_equals_train(dev, tmp_path, monkeypatch):
    """task=train through the CLI on the card (the default device) gives
    the model text of lightgbm_tpu_torch.train on the same arrays, to the
    byte; continued training then appends to the loaded trees."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    X, y = _cli_data(20_000, 21)
    _write_tsv("t.tsv", X, y)
    cli.main(_cli_args(["task=train", "data=t.tsv", "num_iterations=4",
                        "output_model=m.txt"]))
    # the CLI writes GBDT's model text, as the JAX package's CLI does;
    # model_to_string adds the Python API's pandas_categorical line
    want = lgb.train(CLI_PARAMS, lgb.Dataset(X, label=y), 4)
    # each text carries its own drift_fingerprint= line (the CLI's from
    # the parsed text file): equal but for that line
    cli_text = open("m.txt").read()
    assert "\ndrift_fingerprint=" in cli_text
    assert _no_fp(cli_text) == _no_fp(want._gbdt.save_model_to_string())
    assert _no_fp(want.model_to_string()) == _no_fp(
        cli_text + "\npandas_categorical:null\n")
    cli.main(_cli_args(["task=train", "data=t.tsv", "num_iterations=3",
                        "input_model=m.txt", "output_model=more.txt"]))
    more = lgb.Booster(model_file="more.txt")
    assert more.num_trees() == 7
    base = lgb.Booster(model_file="m.txt")
    ll = [float(np.mean(np.log1p(np.exp(-(2 * y - 1) * b.predict(
        X, raw_score=True))))) for b in (base, more)]
    assert ll[1] <= ll[0]


def test_cli_predict_on_the_card_takes_the_device_path(dev, tmp_path,
                                                       monkeypatch):
    """task=predict on 100,000 rows on the card runs the ranked traversal
    (tpu_predict=auto) and writes the host trees' predictions within
    2e-6."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    X, y = _cli_data(20_000, 22)
    lgb.train(CLI_PARAMS, lgb.Dataset(X, label=y), 5).save_model("m.txt")
    Xp, _ = _cli_data(100_000, 23)
    _write_tsv("p.tsv", Xp, np.zeros(len(Xp)))
    walks = []
    real = tp.ranked_predict

    def counted(*a, **k):
        walks.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tp, "ranked_predict", counted)
    cli.main(["task=predict", "input_model=m.txt", "data=p.tsv",
              "output_result=dev.txt", "verbose=-1"])
    assert walks
    n = len(walks)
    cli.main(["task=predict", "input_model=m.txt", "data=p.tsv",
              "output_result=host.txt", "tpu_predict=false", "verbose=-1"])
    assert len(walks) == n
    got, want = np.loadtxt("dev.txt"), np.loadtxt("host.txt")
    assert got.shape == (100_000,)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def _ranking_case(nq=300, seed=3, max_docs=200):
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, max_docs, size=nq)
    n = int(counts.sum())
    y = rng.integers(0, 5, size=n).astype(np.float64)
    X = rng.normal(size=(n, 8))
    X[:, 0] += y
    return X, y, counts


def test_lambdarank_gradients_on_the_card_match_the_host_oracle(dev):
    """The device lambdas (padded query buckets, plain torch) against the
    reference-shaped host oracle, rtol 2e-4 / atol 2e-5 (the JAX
    package's tolerance), with and without weights; and fused training
    (the gradients captured in the tree graph) equals staged."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.io.metadata import Metadata
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.utils.config import Config

    X, y, counts = _ranking_case()
    rng = np.random.default_rng(5)
    for w in (None, rng.random(len(y)) + 0.5):
        md = Metadata(len(y))
        md.set_label(y)
        md.set_query_counts(counts)
        md.set_weights(w)
        obj = create_objective("lambdarank", Config({}))
        obj.init(md, len(y), dev)
        score = rng.normal(size=len(y)).astype(np.float32)
        g, h = obj.get_gradients(torch.from_numpy(score).to(dev))
        gh, hh = obj.get_gradients_host(score)
        np.testing.assert_allclose(g.cpu().numpy(), gh, rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(h.cpu().numpy(), hh, rtol=2e-4, atol=2e-5)
    params = {"objective": "lambdarank", "num_leaves": 15, "verbose": -1,
              "metric": "ndcg", "ndcg_eval_at": [5]}
    texts = []
    for mode in ("auto", "off"):
        b = lgb.train(dict(params, tpu_fused_iter=mode),
                      lgb.Dataset(X, label=y, group=counts), 4)
        assert (b._gbdt._fused_state[0] is not None) == (mode == "auto")
        texts.append(b.model_to_string())
    assert texts[0] == texts[1]


def test_fobj_of_builtin_gradients_trains_the_builtin_trees_on_the_card(dev):
    """A fobj returning the built-in logloss gradients (computed on the
    card, handed over as numpy) trains the built-in objective's staged
    trees, every Tree= section to the byte."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.objectives import create_objective
    from lightgbm_tpu_torch.utils.config import Config

    X, s = parity_data(3, 20_000, False)
    y = (s > 0).astype(float)
    params = parity_params("binary", {"boost_from_average": False})
    want = lgb.train(dict(params, tpu_fused_iter="off"),
                     lgb.Dataset(X, label=y), 4)
    ds = lgb.Dataset(X, label=y, params=params).construct()
    obj = create_objective("binary", Config(params))
    obj.init(ds._handle.metadata, len(y), dev)

    def fobj(preds, data):
        g, h = obj.get_gradients(torch.as_tensor(preds, dtype=torch.float32,
                                                 device=dev))
        return g.cpu().numpy(), h.cpu().numpy()

    got = lgb.train(params, ds, 4, fobj=fobj)
    assert got._gbdt._fused_state is None or got._gbdt._fused_state[0] is None
    assert (got.model_to_string().split("Tree=")[1:]
            == want.model_to_string().split("Tree=")[1:])


def test_pickle_round_trip_on_the_card(dev):
    """A booster on the card pickles and deep-copies onto the card and
    predicts the same bits."""
    import copy
    import pickle

    import lightgbm_tpu_torch as lgb

    X, s = parity_data(4, 5000, False)
    b = lgb.train(parity_params("binary", {}),
                  lgb.Dataset(X, label=(s > 0).astype(float)), 3)
    want = b.predict(X, raw_score=True)
    for other in (pickle.loads(pickle.dumps(b)), copy.deepcopy(b)):
        assert other.device.type == "cuda"
        np.testing.assert_array_equal(other.predict(X, raw_score=True), want)


# --------------------------------- packed bins and the single bf16 product
def _packed_args(dev, case, f):
    """The device tensors of a _b1_case, with its bins in both layouts
    byte and 4-bit packed: (Xt, Xt_packed, X, X_packed, lid, w3, cid,
    cols, psrc)."""
    X, lid, w3, cid, _, cols, psrc = case
    Xp = pack4_host(X)
    assert Xp.shape[1] == (f + 1) // 2
    return [t(a).to(dev) for a in (X.T, Xp.T, X, Xp, lid, w3, cid, cols,
                                   psrc)]


@pytest.mark.parametrize("n,f,b,k", [(20000, 28, 16, 32), (5000, 7, 14, 5),
                                     (3000, 13, 16, 2), (4000, 1, 16, 3),
                                     (2_000_000, 28, 16, 32)])
@pytest.mark.parametrize("bundled", [False, True])
def test_packed_kernels_match_plain_and_the_byte_bins(dev, n, f, b, k,
                                                      bundled):
    """B1, B3 and B4 on 4-bit packed bins (ceil(F/2) stored columns; with
    odd F a padding nibble that is no feature): leaf ids equal the plain
    routing of the packed bins, the histograms are within phase 2's
    tolerance of the float64 plain version, and with the same exponents
    every histogram is the byte bins' kernels' to the bit; the routing
    pass lists the plain version's rows.  Each launch counts as a packed
    one."""
    case = _b1_case(n, f, b, k, seed=n + f + k, bundled=bundled, dup=k > 2)
    xt, xtp, xr, xrp, ids, w, c, cl, ps = _packed_args(dev, case, f)
    exps = wk.fixed_point_exponents(w)
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor)
    n0 = [fn.form_launches["packed"] for fn in counters]
    lid_b, h_b = wk.wave_partition_hist(xt, ids, w, c, cl, ps, b,
                                        bundled=bundled, exps=exps)
    lid_p, h_p = wk.wave_partition_hist(xtp, ids, w, c, cl, ps, b,
                                        bundled=bundled, exps=exps,
                                        logical_cols=f)
    assert torch.equal(lid_p, lid_b) and torch.equal(h_p, h_b)
    assert torch.equal(lid_p, wk.route_rows_plain(xtp, ids, cl, ps, bundled,
                                                  logical_cols=f))
    w64 = w.double()
    want = wk.wave_histogram_plain(xtp, lid_p, w64, c, b, f).cpu()
    scale = wk.wave_histogram_plain(xtp, lid_p, w64.abs(), c, b, f).cpu()
    assert _within_f64(h_p, want, scale, float(w.abs().max()))
    for fn, xb, xp in ((wk.wave_histogram, xt, xtp),
                       (wk.wave_histogram_rowmajor, xr, xrp)):
        hp = fn(xp, lid_b, w, c, b, exps=exps, logical_cols=f)
        assert torch.equal(hp, fn(xb, lid_b, w, c, b, exps=exps))
        assert torch.equal(hp, h_b)
    got = wk.route_list(xtp, ids, c, cl, ps, bundled, logical_cols=f)
    want = wk.route_list_plain(xtp, ids, c, cl, ps, bundled, f)
    for a, z in zip(got, want):
        assert torch.equal(a, z)
    torch.cuda.synchronize()
    assert [fn.form_launches["packed"] - a
            for fn, a in zip(counters, n0)] == [1, 1, 1]


def test_packed_plan_halves_the_bytes_a_block_reads(dev):
    """The packed plan at the flagship's F = 28, B = 16: blocks own packed
    columns and hold both nibbles' features (FS even), the kernel's shared
    memory is the plan's and 32 warps stay resident."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _build.library()
    for k in (32, 1):
        plan = wk.hist_plan(28, 2_000_000, 16, k, sms, True)
        _, groups, _, ks, fs, copies, smem, _ = plan
        assert fs % 2 == 0 and groups * fs // 2 >= 14
        assert lib.lgbt_wave_hist_smem(16, ks, fs, copies) == smem
        for rowmajor in (0, 1):
            blocks = lib.lgbt_wave_hist_blocks_per_sm(16, ks, fs, copies,
                                                      rowmajor, 1)
            assert blocks * wk._HIST_THREADS // 32 >= 32


def _bf16_weights(w3, seed):
    """w3 with ties of the bf16 rounding (1 + 2^-8 and its negative, whose
    rounding differs from round-half-to-even) in a tenth of the rows."""
    w = w3.copy()
    rng = np.random.default_rng(seed)
    tie = rng.random(len(w)) < 0.1
    w[tie] = np.float32(1 + 2.0 ** -8) * np.where(w[tie] < 0, -1, 1)
    return w


@pytest.mark.parametrize("n,f,b,k", [(20000, 28, 63, 32), (5000, 7, 14, 5),
                                     (3000, 9, 16, 2),
                                     (2_000_000, 28, 63, 32)])
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_kernels_sum_the_rounded_weights(dev, n, f, b, k, packed):
    """B1, B3 and B4 with hilo=False (the single bf16 product): with the
    same exponents each equals its hilo form on the weights rounded by
    round_bf16 (the JAX package's rounding, ties away from zero) to the
    bit, and is within phase 2's tolerance of the float64 plain bf16
    version; B3 and B4 equal B1 on its routed ids; packed bins too."""
    if packed and b > 16:
        b = 16
    case = list(_b1_case(n, f, b, k, seed=n + k, dup=k > 2))
    case[2] = _bf16_weights(case[2], n)
    xt, xtp, xr, xrp, ids, w, c, cl, ps = _packed_args(dev, case, f)
    if packed:
        xt, xr = xtp, xrp
    lc = f if packed else 0
    wr = wk.round_bf16(w)
    assert bool((wr != w).any())
    exps = wk.fixed_point_exponents(w)
    n0 = wk.wave_partition_hist.form_launches["bf16"]
    lid1, h1 = wk.wave_partition_hist(xt, ids, w, c, cl, ps, b, exps=exps,
                                      logical_cols=lc, hilo=False)
    lid2, h2 = wk.wave_partition_hist(xt, ids, wr, c, cl, ps, b, exps=exps,
                                      logical_cols=lc)
    assert torch.equal(lid1, lid2) and torch.equal(h1, h2)
    assert wk.wave_partition_hist.form_launches["bf16"] == n0 + 1
    w64 = wr.double()
    want = wk.wave_histogram_plain(xt, lid1, w64, c, b, lc).cpu()
    scale = wk.wave_histogram_plain(xt, lid1, w64.abs(), c, b, lc).cpu()
    assert _within_f64(h1, want, scale, float(w.abs().max()))
    assert torch.equal(want.float(), wk.wave_histogram_plain(
        xt, lid1, w.double(), c, b, lc, hilo=False).float().cpu())
    for fn, x in ((wk.wave_histogram, xt), (wk.wave_histogram_rowmajor, xr)):
        assert torch.equal(fn(x, lid1, w, c, b, exps=exps, logical_cols=lc,
                              hilo=False), h1)


@pytest.mark.parametrize("kind", ["plain", "bundled", "k32"])
def test_sparse_bf16_kernel_sums_the_rounded_weights(dev, kind):
    """B6 with hilo=False (the sparse store never packs): with the same
    exponents its hilo form on the weights rounded by round_bf16 to the
    bit, and within tolerance of the float64 plain bf16 version."""
    X, fill, lid, w3, cid, b = _sparse_kernel_case(kind)
    w3 = _bf16_weights(w3, 5)
    store, _ = sm.build_chunked_store(X, fill, b, auto_uniform=True)
    f = X.shape[1]
    on_card = _on(store, dev)
    ids, w, c = (t(a).to(dev) for a in (lid, w3, cid))
    exps = wk.fixed_point_exponents(w)
    n0 = sm.sparse_wave_histogram.form_launches["bf16"]
    got = sm.sparse_wave_histogram(on_card, ids, w, c, b, f, exps=exps,
                                   hilo=False)
    assert torch.equal(got, sm.sparse_wave_histogram(
        on_card, ids, wk.round_bf16(w), c, b, f, exps=exps))
    assert sm.sparse_wave_histogram.form_launches["bf16"] == n0 + 1
    w64 = wk.round_bf16(t(w3)).double()
    want = sm.chunked_child_hists_plain(store, t(lid), w64, t(cid), b, f)
    scale = sm.chunked_child_hists_plain(store, t(lid), w64.abs(), t(cid),
                                         b, f)
    assert _within_f64(got, want, scale, float(np.abs(w3).max()))
    assert bool((got != 0).any())


def _packed_run(mode, fused, pack, rounds=4, more=None):
    """A small binary run at max_bin = 15 on the card."""
    import lightgbm_tpu_torch as lgb

    X, s = parity_data(3, 3000, False)
    p = dict({"objective": "binary", "num_leaves": 15, "max_bin": 15,
              "min_data_in_leaf": 20, "verbose": -1, "tpu_growth": "wave",
              "tpu_wave_width": 4, "tpu_histogram_mode": mode,
              "tpu_bin_pack": pack, "tpu_fused_iter": fused}, **(more or {}))
    return lgb.train(p, lgb.Dataset(X, label=(s > 0).astype(float)), rounds,
                     device="cuda")


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t", "pallas"])
@pytest.mark.parametrize("more", [{}, NO_CACHE])
def test_packed_training_equals_the_byte_bins_on_the_card(dev, mode, more):
    """At max_bin = 15 tpu_bin_pack=auto uploads ceil(F/2) packed columns
    and trains the byte bins' model text to the byte, fused and staged,
    with every wave-kernel launch a packed one."""
    base = _packed_run(mode, "auto", "false", more=more)
    assert base._gbdt.learner.packed_cols == 0
    text = base.model_to_string()
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor)
    for fused in ("auto", "off"):
        n0 = [(fn.launches, fn.form_launches["packed"]) for fn in counters]
        booster = _packed_run(mode, fused, "auto", more=more)
        learner = booster._gbdt.learner
        assert learner.packed_cols == 10
        assert learner.X.numel() == 5 * 3000
        assert booster.model_to_string() == text
        for fn, (a, p) in zip(counters, n0):
            assert fn.launches - a == fn.form_launches["packed"] - p
        assert sum(fn.launches - a for fn, (a, _) in zip(counters, n0)) > 0


@pytest.mark.parametrize("flow", FUSED_FLOWS)
def test_bf16_fused_trains_the_staged_model_text_on_the_card(dev, flow):
    """tpu_hist_precision=bf16: fused and staged train the same model
    text on every dataflow, the wave kernels' launches all bf16 ones
    (the dense root stays unrounded, as the JAX package's one-hot root
    does)."""
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor, sm.sparse_wave_histogram)
    n0 = [fn.form_launches["bf16"] for fn in counters]
    fused, staged, X = _fused_pair(flow, more={"tpu_hist_precision": "bf16"})
    assert fused._gbdt.learner.hist_hilo is False
    assert fused.model_to_string() == staged.model_to_string()
    assert sum(fn.form_launches["bf16"] - a
               for fn, a in zip(counters, n0)) > 0


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t"])
@pytest.mark.parametrize("more", [{}, NO_CACHE, {"tpu_wave_order": "exact"}])
def test_compact_training_equals_the_full_pass_on_the_card(dev, mode, more):
    """tpu_wave_compact=true on the card, fused and staged: the knob is
    taken and the ordinary full pass runs under it, so the run launches
    the kernels the full pass launches, as often, and trains its model
    text to the byte."""
    p, X, y = _fused_case(mode, more)
    import lightgbm_tpu_torch as lgb

    counters = (wk.wave_partition_hist, wk.wave_histogram)
    for fused in ("auto", "off"):
        runs = []
        for compact in (False, True):
            n0 = [fn.launches for fn in counters]
            b = lgb.train(dict(p, tpu_wave_compact=compact,
                               tpu_fused_iter=fused),
                          lgb.Dataset(X, label=y), 4, device="cuda")
            assert b._gbdt.learner.wave_compact is compact
            runs.append((b.model_to_string(),
                         [fn.launches - a for fn, a in zip(counters, n0)]))
        assert runs[1] == runs[0]
        assert sum(runs[0][1]) > 0


# ------------------------------------------------ the autotuner's probes
def _autotune_case(tmp_path, **more):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(20000, 12))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=20000) > 0)
    p = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
         "verbose": -1, "tpu_growth": "wave", "tpu_autotune": "measure",
         "tpu_autotune_cache": str(tmp_path / "cache.json"), **more}
    return p, X, y.astype(float)


def test_autotune_probes_every_cell_on_the_card(dev, tmp_path):
    """measure on the card probes every enumerated cell (staged and
    fused, both kernels, both precisions, three widths) with real
    launches, counted apart: every launch counter is as before the
    probes, each probe run waits once through obs/timers.fence, and the
    fused cell's graphs are freed."""
    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs import timers
    from lightgbm_tpu_torch.ops import autotune as at
    from lightgbm_tpu_torch.ops import fused_iter

    p, X, y = _autotune_case(tmp_path)
    ds = lgb.Dataset(X, label=y, params=p).construct()
    counts, f0 = fused_iter._counts(), timers.fence_count()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    b = lgb.Booster(p, ds, device="cuda")
    lrn = b._gbdt.learner
    dec = lrn.autotune
    want = at.enumerate_cells(at.Cell.from_dict(dec.events[-1][1]["prior"]),
                              lrn.autotune_shape, lrn.autotune_pins)
    assert dec.source == "measured"
    assert [c for c, _ in dec.probes] == want and len(want) == at.MAX_CELLS
    assert {c.fused for c in want} == {True, False}
    assert all(s > 0 for _, s in dec.probes)
    assert timers.fence_count() - f0 == len(want) * (
        1 + int(lrn.config.tpu_autotune_waves))
    assert fused_iter._counts() == counts
    assert lrn.autotune_launches["wave_partition_hist"] > 0
    assert lrn.autotune_launches["wave_histogram"] > 0
    assert lrn.autotune_launches["score_update"] > 0
    assert lrn.autotune_launches["wave_partition_hist_bf16"] > 0
    # the probes' growers and graphs are gone: what stays is the
    # booster's upload and its scores
    del dec
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    x_bytes = lrn.X.numel() * lrn.X.element_size()
    assert torch.cuda.memory_allocated() - before < 4 * x_bytes + (8 << 20)


def test_autotune_measured_winner_trains_the_pinned_text(dev, tmp_path):
    """The measured winner's run, a cache hit under prior, and a run with
    the winner pinned train one model text."""
    import lightgbm_tpu_torch as lgb

    p, X, y = _autotune_case(tmp_path)
    texts = []
    for mode in ("measure", "prior"):
        b = lgb.train(dict(p, tpu_autotune=mode), lgb.Dataset(X, label=y),
                      3, device="cuda")
        texts.append(b.model_to_string())
        cell = b._gbdt.learner.autotune.cell
    assert b._gbdt.learner.autotune_source == "cache"
    pinned = dict(p, tpu_autotune="off", tpu_histogram_mode=cell.hist_mode,
                  tpu_wave_width=cell.wave_width,
                  tpu_hist_precision="hilo" if cell.hist_hilo else "bf16",
                  tpu_wave_compact=cell.compact,
                  tpu_fused_iter="on" if cell.fused else "off")
    texts.append(lgb.train(pinned, lgb.Dataset(X, label=y), 3,
                           device="cuda").model_to_string())
    assert texts[0] == texts[1] == texts[2]


def test_fence_audit_and_trace_window_on_the_card(dev, tmp_path):
    """A NULL-observer run issues no fence; obs_timing=iter one an
    iteration; an obs_trace_iters window writes a Chrome trace naming
    the port's kernels."""
    import json
    import os

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.obs import timers

    p, X, y = _autotune_case(tmp_path, tpu_autotune="off")
    f0 = timers.fence_count()
    lgb.train(p, lgb.Dataset(X, label=y), 3, device="cuda")
    assert timers.fence_count() == f0
    lgb.train(dict(p, obs_timing="iter",
                   obs_events_path=str(tmp_path / "ev.jsonl")),
              lgb.Dataset(X, label=y), 3, device="cuda")
    assert timers.fence_count() - f0 == 3
    trace_dir = tmp_path / "trace"
    lgb.train(dict(p, tpu_fused_iter="off", obs_trace_iters="1:2",
                   obs_trace_dir=str(trace_dir)),
              lgb.Dataset(X, label=y), 3, device="cuda")
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as f:
        names = " ".join(str(e.get("name", ""))
                         for e in json.load(f)["traceEvents"])
    for kernel in ("list_kernel", "hist_kernel", "score_update_kernel"):
        assert kernel in names


def _binned_case(tmp_path, workers=1, n=20_000, f=12):
    """A streamed binned directory of uneven shards (7,000 rows, the last
    6,000) and its rows."""
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.utils.config import Config
    rng = np.random.default_rng(21)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    out = str(tmp_path / "binned")
    TrainingData.from_streamed(X, y, Config({"max_bin": 63, "verbose": -1,
                                             "ooc_workers": workers}),
                               out_dir=out, chunk_rows=7000)
    return out, X, y


@pytest.mark.parametrize("row_major", [False, True])
def test_paged_upload_equals_the_one_shot_upload_on_the_card(dev, tmp_path,
                                                             row_major):
    """Shard by shard through the pinned stage into X_t[:, lo:hi] (a 2-D
    strided copy) or X[lo:hi]: the one-shot upload's bytes."""
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.ops.learner import paged_device_matrix
    out, _, _ = _binned_case(tmp_path)
    td = TrainingData.from_binned(out)
    X, stats = paged_device_matrix(td, row_major, dev)
    assert td._binned is None and X.device.type == "cuda"
    assert stats["shards"] == 3 and stats["staging_bytes"] == 7000 * 12
    host = td.binned
    want = torch.as_tensor(np.ascontiguousarray(host if row_major
                                                else host.T), device=dev)
    assert torch.equal(X, want)


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t", "pallas"])
def test_streamed_directory_trains_on_the_card(dev, tmp_path, mode):
    """The fork pool's two workers stream after the card is in use; the
    directory trains fused through the paged upload, to the in-memory
    Dataset's model text."""
    import lightgbm_tpu_torch as lgb
    torch.ones(4, device=dev).sum().item()       # CUDA is initialised
    out, X, y = _binned_case(tmp_path, workers=2)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbose": -1, "tpu_growth": "wave", "tpu_wave_width": 8,
              "tpu_histogram_mode": mode}
    want = lgb.train(params, lgb.Dataset(X, label=y), 3, device="cuda")
    got = lgb.train(params, out, 3, device="cuda")
    assert got._gbdt._fused_state[0] is not None
    assert got._gbdt.learner.upload_stats["paged"]
    assert got._gbdt.train_data._binned is None
    # a streamed directory's header carries no drift fingerprint (as in
    # the JAX package); the in-memory text's line is the one difference
    assert "drift_fingerprint=" not in got.model_to_string()
    assert got.model_to_string() == _no_fp(want.model_to_string())


def test_c_abi_builds_and_trains_on_the_card(dev):
    """The port's C ABI library builds on the card's host and trains on
    the card by default: train's model text, and predictions within 2e-6
    of Booster.predict."""
    import ctypes

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch import c_api, capi_lib
    lib = capi_lib.load()
    rng = np.random.default_rng(9)
    n, f = 20_000, 10
    X = np.ascontiguousarray(rng.normal(size=(n, f)))
    y = (X[:, 0] - X[:, 2] > 0).astype(np.float32)
    params = b"objective=binary num_leaves=31 max_bin=63 verbose=-1"

    def ok(rc):
        assert rc == 0, lib.LGBM_GetLastError().decode()

    ds, bst, fin = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_int()
    ok(lib.LGBM_DatasetCreateFromMat(
        X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, params, None,
        ctypes.byref(ds)))
    ok(lib.LGBM_DatasetSetField(ds, b"label",
                                y.ctypes.data_as(ctypes.c_void_p),
                                ctypes.c_int64(n), 0))
    ok(lib.LGBM_BoosterCreate(ds, params, ctypes.byref(bst)))
    assert c_api._get(bst.value).device.type == "cuda"
    for _ in range(3):
        ok(lib.LGBM_BoosterUpdateOneIter(bst, ctypes.byref(fin)))
    slen = ctypes.c_int64()
    ok(lib.LGBM_BoosterSaveModelToString(bst, -1, ctypes.c_int64(0),
                                         ctypes.byref(slen), None))
    buf = ctypes.create_string_buffer(slen.value)
    ok(lib.LGBM_BoosterSaveModelToString(bst, -1, slen, ctypes.byref(slen),
                                         buf))
    want = lgb.train({"objective": "binary", "num_leaves": 31, "max_bin": 63,
                      "verbose": -1}, lgb.Dataset(X, label=y), 3,
                     device="cuda")
    assert buf.value.decode() == want.model_to_string()
    out_len = ctypes.c_int64()
    preds = np.zeros(n, np.float64)
    ok(lib.LGBM_BoosterPredictForMat(
        bst, X.ctypes.data_as(ctypes.c_void_p), 1, n, f, 1, 0, -1, b"",
        ctypes.byref(out_len),
        preds.ctypes.data_as(ctypes.POINTER(ctypes.c_double))))
    np.testing.assert_allclose(preds, want.predict(X), rtol=0, atol=2e-6)
    ok(lib.LGBM_BoosterFree(bst))
    ok(lib.LGBM_DatasetFree(ds))


# ------------------------------------------- two-byte bins and the f64 form
def _form_case(n, f, b, k, seed, wdtype=np.float32):
    """A wave of k parents over X (N, F) bins below b (uint16 past 256
    bins), with _b1_case's splits, and w3 in wdtype."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b, size=(n, f)).astype(
        np.uint16 if b > 256 else np.uint8)
    lid = rng.integers(0, k, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(wdtype)
    w3[:, 2] = rng.random(n) > 0.2
    cols = np.zeros((k, 10), np.float32)
    cols[:, 0] = 1
    cols[:, 1] = rng.integers(0, f, size=k)
    cols[:, 2] = rng.integers(0, b - 1, size=k)
    cols[:, 3] = rng.random(k) < 0.25
    cols[:, 4] = rng.integers(0, b, size=k)
    cols[:, 5] = rng.integers(0, 2, size=k)
    cols[:, 6] = np.arange(k, 2 * k)
    cols[:, 9] = b
    psrc = np.arange(k, dtype=np.int32)
    cid = np.where(rng.random(k) < 0.5, psrc, psrc + k).astype(np.int32)
    cid[k // 3] = -1
    return X, lid, w3, cid, cols, psrc


def _within_form(got, want, scale, wmax, wide):
    """The f32 forms: phase 2's tolerance.  The f64 form sums in 128-bit
    fixed point and rounds once, so it is held to 1e-12 x (sum of |w|
    over the cell) + 1e-14 x max|w| of the float64 plain version (whose
    own row-order rounding is the larger part of that)."""
    if not wide:
        return _within_f64(got, want, scale, wmax)
    diff = (got.cpu() - want).abs()
    return bool((diff <= 1e-12 * scale + 1e-14 * wmax).all())


@pytest.mark.parametrize("n,f,b,wide,k", [
    (200_000, 6, 511, False, 8), (200_000, 6, 1023, False, 8),
    (60_000, 4, 16383, False, 8), (20_000, 3, 65536, False, 8),
    (200_000, 6, 63, True, 8), (200_000, 6, 1023, True, 8),
    (30_000, 3, 9000, True, 8), (200_000, 10, 255, False, 32),
    (200_000, 10, 1023, False, 32)])
def test_wide_bin_and_f64_forms_match_plain(dev, n, f, b, wide, k):
    """B1, B3, B4 and B5 on uint16 bins (b > 256), byte bins at 255 and
    with float64 weights (the f64 form): B1's ids equal the plain
    routing; each histogram is within its form's tolerance of the
    float64 plain version; B1's and B3's equal the scatter engine's
    (``ops/histogram.py scatter_histogram``, an int64 ``index_add_`` of
    the same fixed point) with the same exponents to the bit; two
    launches are bit-identical; with B1's exponents, B3's histogram of
    B1's ids is B1's to the bit, B4's is B3's and B5's (K = 1) is B4's
    slot.  B past 9,386 (4,693 wide) tiles the bin axis; the wide rows
    take the slot-ordered pass (every case but f64 at 63 bins and 8
    slots); each form's launches are counted."""
    from lightgbm_tpu_torch.ops.histogram import scatter_histogram
    X, lid, w3, cid, cols, psrc = _form_case(
        n, f, b, k, seed=b + f, wdtype=np.float64 if wide else np.float32)
    Xt, Xr = t(X.T).to(dev), t(X).to(dev)
    ids, w, c = t(lid).to(dev), t(w3).to(dev), t(cid).to(dev)
    cl, ps = t(cols).to(dev), t(psrc).to(dev)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = wk.hist_plan(f, n, b, k, sms, False, wide)
    tiles = wk.bin_tiles(f, b, plan[1], plan[4])
    assert (len(tiles) > 1) == (b > (4693 if wide else 9386))
    assert plan[6] <= wk._SMEM_BUDGET
    # fewer than 4 features of all k slots fit a block but f64 at 63 bins
    assert bool(plan.ordered) == (not (wide and b == 63))
    # the kernel derives the plan's tiles and shared memory as the plan
    # does, and a block of the plan is resident
    lib = _build.library()
    bt = tiles[0][1] - tiles[0][0]
    _, groups, _, ks, fs, copies, smem, ordered = plan
    assert lib.lgbt_wave_bin_tile(f, b, groups, fs, 0) == bt
    assert lib.lgbt_wave_hist_smem_form(bt, ks, fs, copies, int(wide)) == smem
    for rowmajor in (0, 1):
        blocks = (lib.lgbt_wave_hist_ordered_blocks_per_sm(
                      bt, fs, 0, int(b > 256), int(wide))
                  if ordered else lib.lgbt_wave_hist_blocks_per_sm_form(
                      bt, ks, fs, copies, rowmajor, 0, int(b > 256),
                      int(wide)))
        assert blocks >= 1
    form = "f64" if wide else ("uint16" if b > 256 else None)
    counters = (wk.wave_partition_hist, wk.wave_histogram,
                wk.wave_histogram_rowmajor, lh.leaf_histogram)
    n0 = [fn.form_launches[form] for fn in counters] if form else None
    exps = wk.fixed_point_exponents(w)
    new_lid, h1 = wk.wave_partition_hist(Xt, ids, w, c, cl, ps, b, exps=exps)
    again_lid, again = wk.wave_partition_hist(Xt, ids, w, c, cl, ps, b,
                                              exps=exps)
    h3 = wk.wave_histogram(Xt, new_lid, w, c, b, exps=exps)
    h3b = wk.wave_histogram(Xt, new_lid, w, c, b, exps=exps)
    h4 = wk.wave_histogram_rowmajor(Xr, new_lid, w, c, b, exps=exps)
    h5 = lh.leaf_histogram(Xr, None, None, new_lid, c[:1], None, b, w3=w,
                           exps=exps)
    want_bits = scatter_histogram(Xr, new_lid, w, c, b, exps)
    torch.cuda.synchronize()
    want_lid = wk.route_rows_plain(Xt, ids, cl, ps)
    assert torch.equal(new_lid, want_lid) and torch.equal(new_lid, again_lid)
    assert h1.dtype == (torch.float64 if wide else torch.float32)
    assert torch.equal(h1, again) and torch.equal(h1, h3)
    assert torch.equal(h3, h3b) and torch.equal(h3, want_bits)
    assert torch.equal(h3, h4) and torch.equal(h5, h4[0])
    w64 = t(w3).double()
    cpu_lid = new_lid.cpu()
    want = wk.wave_histogram_plain(t(X.T), cpu_lid, w64, t(cid), b)
    scale = wk.wave_histogram_plain(t(X.T), cpu_lid, w64.abs(), t(cid), b)
    assert _within_form(h1, want, scale, float(np.abs(w3).max()), wide)
    assert bool((h1[torch.from_numpy(cid < 0).to(dev)] == 0).all())
    # the highest bins are reached (the last tile holds rows)
    assert bool((h1[..., b - 64:, 2] != 0).any())
    if form:
        assert [fn.form_launches[form] - a
                for fn, a in zip(counters, n0)] == [2, 2, 1, 1]
    if ordered:
        # the slot-ordered list: grouped by slot in slot order, the
        # select pass's pairs, each slot's rows those of the plain list
        rows, slots = wk.select_list(new_lid, c, ordered=True)
        assert bool((slots[1:] >= slots[:-1]).all())
        want_r, want_s, _ = wk.slot_order_plain(
            *wk.select_list_plain(cpu_lid, t(cid)), k)
        got_r, got_s, _ = wk.slot_order_plain(rows.cpu(), slots.cpu(), k)
        assert torch.equal(got_r, want_r) and torch.equal(got_s, want_s)
        # the list passes and the ordered pass captured in a CUDA graph
        # (the growers' workspace, nothing allocated inside) and replayed
        # twice give the eager histograms
        work = wk.list_workspace(n, k, f, b, dev, wide)
        wk.wave_histogram(Xt, new_lid, w, c, b, exps=exps, work=work)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = wk.wave_histogram(Xt, new_lid, w, c, b, exps=exps,
                                    work=work)
        for _ in range(2):
            out.zero_()
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, h3)


def test_wide_bins_bundled_route(dev):
    """B1's EFB remap reads a two-byte group bin: groups of at most 256
    bins and a 300-bin singleton in a uint16 matrix."""
    X, lid, w3, cid, cols, psrc = _form_case(50_000, 5, 300, 6, seed=5)
    rng = np.random.default_rng(6)
    cols[:, 7] = rng.integers(0, 150, size=6)
    cols[:, 9] = rng.integers(1, 150, size=6)
    cols[:, 8] = rng.integers(0, 3, size=6)
    args = [t(a).to(dev) for a in (X.T, lid, w3, cid, cols, psrc)]
    got_lid, got = wk.wave_partition_hist(*args, 300, bundled=True)
    want_lid = wk.route_rows_plain(*args[:2], *args[4:], True)
    assert torch.equal(got_lid, want_lid)
    assert bool((want_lid != args[1]).any())
    w64 = args[2].double().cpu()
    want = wk.wave_histogram_plain(t(X.T), want_lid.cpu(), w64, t(cid), 300)
    scale = wk.wave_histogram_plain(t(X.T), want_lid.cpu(), w64.abs(),
                                    t(cid), 300)
    assert _within_f64(got, want, scale, float(np.abs(w3).max()))


def test_uint16_plain_paths_on_the_card(dev):
    """The plain torch reads of uint16 bins the growers run on the card
    (the routing of pallas_t and pallas, the traversal) give the CPU's
    values."""
    X, lid, w3, cid, cols, psrc = _form_case(5000, 4, 40000, 5, seed=2)
    for rowmajor in (False, True):
        Xc = t(X if rowmajor else X.T)
        fn = wk.route_rows_rowmajor if rowmajor else wk.route_rows_plain
        want = fn(Xc, t(lid), t(cols), t(psrc))
        got = fn(Xc.to(dev), t(lid).to(dev), t(cols).to(dev),
                 t(psrc).to(dev))
        assert torch.equal(got.cpu(), want)


def test_scatter_engine_equals_the_kernels_to_the_bit(dev):
    """The scatter engine sums the kernels' fixed point: on the card its
    histograms equal B3's (f32 form) and B5's (f64 form) to the bit; the
    onehot engine is within phase 2's tolerance of the float64 plain
    version."""
    from lightgbm_tpu_torch.ops import histogram as th
    X, lid, w3, cid, b = wave_data(n=300_000, f=6, b=200, seed=4)
    Xd, ids, c = t(X).to(dev), t(lid).to(dev), t(cid).to(dev)
    for wide in (False, True):
        w = t(w3.astype(np.float64) if wide else w3).to(dev)
        exps = wk.fixed_point_exponents(w)
        got = th.engine_histogram("scatter", Xd, ids, w, c, b, exps)
        again = th.engine_histogram("scatter", Xd, ids, w, c, b, exps)
        want = wk.wave_histogram(Xd.t().contiguous(), ids, w, c, b,
                                 exps=exps)
        assert torch.equal(got, again) and torch.equal(got, want)
        leaf = lh.leaf_histogram(Xd, None, None, ids, c[:1], None, b, w3=w,
                                 exps=exps)
        assert torch.equal(got[0], leaf)
    w = t(w3).to(dev)
    got = th.engine_histogram("onehot", Xd, ids, w, c, b, None)
    w64 = t(w3).double()
    want = wk.wave_histogram_plain(t(X.T), t(lid), w64, t(cid), b)
    scale = wk.wave_histogram_plain(t(X.T), t(lid), w64.abs(), t(cid), b)
    assert _within_f64(got, want, scale, float(np.abs(w3).max()))


@pytest.mark.parametrize("more", [
    {"tpu_histogram_mode": "scatter", "tpu_growth": "wave"},
    {"tpu_histogram_mode": "onehot", "tpu_growth": "exact"},
    {"tpu_use_dp": True},
    {"tpu_use_dp": True, "tpu_growth": "exact"},
    {"max_bin": 1023},
    {"max_bin": 1023, "tpu_histogram_mode": "pallas", "tpu_growth": "wave"},
    {"tpu_score_update": "gather"}])
def test_engines_wide_bins_and_f64_fused_equal_staged(dev, more):
    """Each new path trains on the card, fused and staged with equal
    text; scatter and gather give the kernels' text (the same fixed
    point, B2's arithmetic)."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.default_rng(1)
    X = rng.normal(size=(20_000, 8))
    y = (X[:, 0] + X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=len(X))
         > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 31, "verbose": -1,
         "max_bin": 63, **more}
    texts = []
    for fused in ("auto", "off"):
        b = lgb.train(dict(p, tpu_fused_iter=fused), lgb.Dataset(X, label=y),
                      3, device="cuda")
        assert (b._gbdt._fused_state[0] is None) == (fused == "off")
        texts.append(b.model_to_string())
    assert texts[0] == texts[1]
    if more.get("tpu_histogram_mode") == "scatter" or "tpu_score_update" \
            in more:
        base = lgb.train(dict(p, tpu_histogram_mode="pallas_ct",
                              tpu_score_update="auto"),
                         lgb.Dataset(X, label=y), 3, device="cuda")
        assert base.model_to_string() == texts[0]


# ------------------------------------------------- the coordinate store
def _coord_case(dev, dtype=torch.float32):
    from lightgbm_tpu_torch.ops import sparse_store as ss
    X, fill, lid, w3 = sparse_case()
    store, _, _ = ss.build_sparse_store(X, fill, 14, device=dev)
    cpu, _, _ = ss.build_sparse_store(X, fill, 14)
    w = torch.as_tensor(w3).to(dtype)
    return ss, store, cpu, torch.as_tensor(lid), w, X.shape[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_coord_store_histograms_on_the_card_equal_the_cpu_fixed_point(
        dev, dtype):
    """The coordinate store's slot and leaf histograms on the card (the
    tree's fixed point: an integer index_add_, order-free) equal the same
    fixed point computed on the CPU to the bit, f32 and float64 weights,
    and two calls on the card are bit-identical."""
    ss, store, cpu, lid, w3, f = _coord_case(dev, dtype)
    cid = torch.tensor([2, 10, -1, 5, 2, 11], dtype=torch.int32)
    want = ss.sparse_wave_hists(cpu, lid, w3, cid, 14, f, 12, fixed=True)
    got = ss.sparse_wave_hists(store, lid.to(dev), w3.to(dev), cid.to(dev),
                               14, f, 12)
    again = ss.sparse_wave_hists(store, lid.to(dev), w3.to(dev),
                                 cid.to(dev), 14, f, 12)
    assert torch.equal(got.cpu(), want) and torch.equal(got, again)
    leaf = ss.sparse_leaf_hist(store, lid.to(dev), w3.to(dev), 5, 14, f)
    assert torch.equal(leaf.cpu(), want[3])
    for j in (0, 3, f - 1):
        assert torch.equal(ss.sparse_split_column(store, j, lid.shape[0])
                           .cpu(), ss.sparse_split_column(cpu, j,
                                                          lid.shape[0]))


def _bosch_rows(n, seed=7, cols=968, density=0.01):
    """The Bosch-shaped recipe (tools/tpu_ab2.py:51-57) at n rows, as
    CSR."""
    import scipy.sparse as sps
    rng = np.random.default_rng(seed)
    nnz = int(n * cols * density)
    X = sps.csr_matrix((rng.normal(size=nnz),
                        (rng.integers(0, n, nnz), rng.integers(0, cols,
                                                               nnz))),
                       shape=(n, cols))
    X.sum_duplicates()
    y = (X[:, 0].toarray()[:, 0] + X[:, 1].toarray()[:, 0] > 0.02) * 1.0
    return X, y


@pytest.mark.parametrize("growth", ["wave", "exact"])
def test_coord_store_fused_equals_staged_on_bosch_rows(dev, growth):
    """100,000 Bosch-shaped rows through the coordinate store on the
    card: fused and staged train one model text; no kernel but B2
    launches; wave growth's text is the entry-chunk store's (B6's sums are
    the same fixed point)."""
    import lightgbm_tpu_torch as lgb
    X, y = _bosch_rows(100_000)
    p = {"objective": "binary", "num_leaves": 63, "max_bin": 63,
         "min_data_in_leaf": 1, "verbose": -1, "tpu_sparse": True,
         "tpu_growth": growth, "tpu_wave_width": 32}
    ds = lgb.Dataset(X, label=y, params=p).construct()
    n0 = (sm.sparse_wave_histogram.launches, wk.wave_partition_hist.launches,
          lh.leaf_histogram.launches)
    fused = lgb.train(p, ds, 3, device="cuda")
    staged = lgb.train(dict(p, tpu_fused_iter="off"), ds, 3, device="cuda")
    assert fused._gbdt.learner.hist_mode == "sparse"
    assert fused._gbdt._fused_state[0] is not None
    assert fused.model_to_string() == staged.model_to_string()
    assert n0 == (sm.sparse_wave_histogram.launches,
                  wk.wave_partition_hist.launches,
                  lh.leaf_histogram.launches)
    if growth == "wave":
        chunked = lgb.train(dict(p, tpu_sparse_kernel=True), ds, 3,
                            device="cuda")
        assert chunked.model_to_string() == fused.model_to_string()


def test_graph_capture_lands_as_a_compile_attr_event(dev):
    """Under obs_compile a fused run's tree, tail and score graph
    captures land as compile and compile_attr events with the tensors'
    signature on the card and the cost of the launches they recorded;
    the score graph's entry is timed as fused_iter."""
    import lightgbm_tpu_torch as lgb
    X, y = parity_data(0, 4000, False)
    p = dict(parity_params("binary", {}), tpu_growth="wave",
             tpu_wave_width=4, obs_compile=True, obs_prof_hz=0)
    b = lgb.train(p, lgb.Dataset(X, label=labels("binary", y)), 3,
                  device="cuda")
    events = b.telemetry()
    attrs = {e["entry"]: e for e in events if e["ev"] == "compile_attr"}
    assert {"fused_iter.tree", "fused_iter.tail", "fused_iter.score"} <= \
        set(attrs)
    tree = attrs["fused_iter.tree"]
    assert tree["sig_compiles"] == 1
    assert tree["sig"]["score"].endswith("@cuda:0")
    assert tree["cost"]["bytes_accessed"] > 0
    assert {e["entry"] for e in events if e["ev"] == "compile"} >= {
        "fused_iter.tree", "fused_iter.score"}
    assert events[-1]["compile_attr"]["fused_iter.tree"]["compiles"] == 1


# ------------------------------------------------------- distributed
@pytest.mark.parametrize("wide", [False, True])
def test_deferred_finish_sums_of_two_row_sets_equal_one_launch(dev, wide):
    """B1, B3, B4 and B5 stopped before their conversion over two disjoint
    row sets: the int64 sums added and converted by the finish alone are
    one launch over the union, to the bit.  The f64 form returns its
    sums as two words (low, high), which a word-wise sum would not carry:
    the learners all-reduce its finished histograms instead."""
    g = torch.Generator(device="cpu").manual_seed(18)
    N, F, B, K = 20_000, 9, 31, 6
    X_t = torch.randint(0, B, (F, N), generator=g, dtype=torch.uint8).to(dev)
    X = X_t.t().contiguous()
    lid = torch.randint(0, K, (N,), generator=g, dtype=torch.int32).to(dev)
    w3 = torch.randn((N, 3), generator=g,
                     dtype=torch.float64 if wide else torch.float32).to(dev)
    cid = torch.arange(K, dtype=torch.int32, device=dev)
    exps = wk.fixed_point_exponents(w3)
    half = torch.arange(N, device=dev) < N // 3
    parts = [torch.where(m, lid, torch.full_like(lid, -1))
             for m in (half, ~half)]
    for fn, Xk in ((wk.wave_histogram, X_t),
                   (wk.wave_histogram_rowmajor, X)):
        one = fn(Xk, lid, w3, cid, B, exps=exps)
        sums = [fn(Xk, p, w3, cid, B, exps=exps, finish=False).clone()
                for p in parts]
        assert sums[0].dtype == torch.int64
        if not wide:
            assert torch.equal(wk.finish_hist(sums[0] + sums[1], cid, exps),
                               one)
        else:
            assert sums[0].shape == (K, F, B, 3, 2)
    if wide:
        return
    leaf = torch.full((1,), 2, dtype=torch.int32, device=dev)
    one = lh.leaf_histogram(X, None, None, lid, leaf, None, B, w3=w3,
                            exps=exps)
    sums = [lh.leaf_histogram(X, None, None, p, leaf, None, B, w3=w3,
                              exps=exps, finish=False).clone()
            for p in parts]
    assert torch.equal(wk.finish_hist(sums[0] + sums[1], leaf, exps)[0], one)
    n0 = (wk.wave_partition_hist.form_launches["deferred"],
          wk.finish_hist.launches)
    cols = torch.tensor([[1, 0, 10, 0, 0, 1, K, 0, 0, B]] * 1,
                        dtype=torch.float32, device=dev)
    psrc = torch.zeros(1, dtype=torch.int32, device=dev)
    cid2 = torch.tensor([0, K], dtype=torch.int32, device=dev)
    new_u, hist_u = wk.wave_partition_hist(X_t, lid, w3, cid2, cols, psrc,
                                           B, exps=exps)
    outs = [wk.wave_partition_hist(X_t, p, w3, cid2, cols, psrc, B,
                                   exps=exps, finish=False) for p in parts]
    got = wk.finish_hist(outs[0][1].clone() + outs[1][1], cid2, exps)
    assert torch.equal(got, hist_u)
    assert torch.equal(torch.where(half, outs[0][0], outs[1][0]), new_u)
    assert (wk.wave_partition_hist.form_launches["deferred"],
            wk.finish_hist.launches) == (n0[0] + 2, n0[1] + 1)


@pytest.mark.parametrize("learner", ["data", "feature"])
def test_two_ranks_on_one_card_over_gloo(dev, learner):
    """Two rank processes share the card over gloo (parallel/launch.py):
    byte-equal texts; the data-parallel ranks launch the deferred forms
    and the finish."""
    from lightgbm_tpu_torch.parallel.launch import run_ranks_subprocess
    payload = {"rows": 4000, "cols": 8, "num_rounds": 3, "device": "cuda",
               "params": {"tree_learner": learner, "num_leaves": 15}}
    out = run_ranks_subprocess(2, "lightgbm_tpu_torch.parallel.worker:"
                               "train_worker", payload, timeout=240,
                               device="cuda")
    assert out[0]["digest"] == out[1]["digest"]
    assert out[0]["num_trees"] == 3


# ------------------------------------------------- the rest of distributed
def test_sharded_prediction_on_two_entries_of_the_card(dev):
    """ranked_predict_sharded over ["cuda", "cuda"] (a replica of the
    trees each) equals ranked_predict to the bit, padded rows and all."""
    import lightgbm_tpu_torch as lgbt
    X, s = parity_data(4, 3000, False)
    y = labels("binary", s)
    b = lgbt.train({"objective": "binary", "num_leaves": 15,
                    "verbose": -1}, lgbt.Dataset(X, label=y), 5,
                   device="cpu")
    g = b._gbdt
    g._materialize()
    rp = tp.build_ranked_predictor(g.models, 1, X.shape[1], dev)
    V, D = tp.rank_encode(rp, X[:2999])
    one = tp.ranked_predict(rp.dev, torch.as_tensor(V, device=dev),
                            torch.as_tensor(D, device=dev))
    two, n = tp.ranked_predict_sharded(rp, V, D, 1,
                                       devices=["cuda", "cuda"])
    assert n == 2999 and torch.equal(two[:n], one)


def test_cpu_booster_predicts_over_entries_of_the_card(dev):
    """A CPU booster with tpu_predict=true whose entries name the card:
    the scores come back from the card (pinned copy, its event) with the
    bits of a card booster's one-device prediction."""
    import lightgbm_tpu_torch as lgbt
    X, s = parity_data(6, 3000, False)
    y = labels("binary", s)
    b = lgbt.train({"objective": "binary", "num_leaves": 15,
                    "verbose": -1, "tpu_predict": "true"},
                   lgbt.Dataset(X, label=y), 5, device="cpu")
    card = lgbt.Booster(model_str=b.model_to_string(), device="cuda")
    card._gbdt.config.tpu_predict = "true"
    want = card.predict(X[:2999], raw_score=True)
    b.set_predict_devices(["cuda:0", "cuda:0"])
    np.testing.assert_array_equal(b.predict(X[:2999], raw_score=True),
                                  want)


@pytest.mark.skipif(not torch.cuda.is_available()
                    or torch.cuda.device_count() < 2,
                    reason="needs two cards: the first entry is not the "
                           "current card")
def test_bulk_prediction_whose_first_entry_is_not_the_current_card(dev):
    """Entries ["cuda:1", "cuda:0"] while cuda:0 is current: the copy and
    its event run on cuda:1, the scores are one card's bits."""
    import lightgbm_tpu_torch as lgbt
    X, s = parity_data(7, 3000, False)
    y = labels("binary", s)
    b = lgbt.train({"objective": "binary", "num_leaves": 15,
                    "verbose": -1, "tpu_predict": "true"},
                   lgbt.Dataset(X, label=y), 5, device="cuda:0")
    want = b.predict(X, raw_score=True)
    b.set_predict_devices(["cuda:1", "cuda:0"])
    np.testing.assert_array_equal(b.predict(X, raw_score=True), want)
    b.set_predict_devices(["cuda:1"])
    np.testing.assert_array_equal(b.predict(X, raw_score=True), want)


def test_serving_over_two_entries_of_the_card(dev):
    """A serving cache over two entries of the card: a graph a device a
    bucket, the one-device bits, no capture after warm-up."""
    import lightgbm_tpu_torch as lgbt
    from lightgbm_tpu_torch.serve.executable import PredictExecutableCache
    X, s = parity_data(5, 3000, False)
    y = labels("binary", s)
    b = lgbt.train({"objective": "binary", "num_leaves": 15,
                    "verbose": -1}, lgbt.Dataset(X, label=y), 5,
                   device="cpu")
    one = PredictExecutableCache(b._gbdt, devices=["cuda"], max_batch=256)
    two = PredictExecutableCache(b._gbdt, devices=["cuda", "cuda"],
                                 max_batch=256)
    for convert in (True, False):
        two.warmup([1, 100, 256], convert=convert)
    two.mark_warm()
    for n in (1, 7, 100, 255):
        for convert in (True, False):
            assert np.array_equal(two.predict_batch(X[:n], convert=convert),
                                  one.predict_batch(X[:n], convert=convert))
    st = two.stats()
    assert st["devices"] == 2 and st["steady_state_compiles"] == 0
    assert st["graphs"] == 2 * len(two._exe)


def test_data_parallel_coordinate_store_on_the_card(dev):
    """Two thread ranks on the card, each its block of a coordinate
    store padded to the agreed size: their all-reduced slot histogram is
    the serial store's to the bit (the card's fixed point)."""
    from lightgbm_tpu_torch.ops import sparse_store as ss
    from lightgbm_tpu_torch.parallel import comm as pcomm
    X, fill, leaf_id, w3 = sparse_case(n=6001)
    child = torch.tensor([0, 3, -1, 5], dtype=torch.int32, device=dev)
    serial, _, _ = ss.build_sparse_store(X, fill, 14, device=dev)
    w = torch.as_tensor(w3, device=dev)
    lid = torch.as_tensor(leaf_id, device=dev)
    exps = wk.fixed_point_exponents(w)
    want = ss.sparse_wave_hists(serial, lid, w, child, 14, X.shape[1], 12,
                                exps=exps)

    def rank(comm):
        lo = comm.rank * 3001
        hi = min(lo + 3001, len(X))
        parts, nnz, cap = ss.sharded_store_parts(X[lo:hi], fill, 14, 1)
        agreed = comm.allgather_obj([nnz, cap])
        store, _ = ss.assemble_sharded_store(
            parts, X.shape[1], 14, max(a[0] for a in agreed),
            max(a[1] for a in agreed))
        return ss.sparse_wave_hists(ss.upload_store(store, dev), lid[lo:hi],
                                    w[lo:hi], child, 14, X.shape[1], 12,
                                    exps=exps, comm=comm)
    for got in pcomm.run_ranks(2, rank, barrier_timeout=120):
        assert torch.equal(got, want)


def test_elastic_drill_on_the_card(dev, tmp_path):
    """run_elastic: two rank processes over gloo on the card, rank 1
    killed after round 2, the world-1 relaunch resumes from the
    checkpoint to the serial continuation's text."""
    import lightgbm_tpu_torch as lgbt
    from lightgbm_tpu_torch.io.dataset import TrainingData
    from lightgbm_tpu_torch.parallel import worker
    from lightgbm_tpu_torch.parallel.elastic import run_elastic
    from lightgbm_tpu_torch.utils.config import Config
    X, y = worker.make_data(4000, 6, 4)
    params = dict(worker.default_params(), tree_learner="data")
    binned = str(tmp_path / "binned")
    TrainingData.from_streamed(X, y, Config(dict(params)), out_dir=binned,
                               chunk_rows=1000)
    payload = {"binned_dir": binned, "num_rounds": 4, "device": "cuda",
               "checkpoint_dir": str(tmp_path / "ck"),
               "checkpoint_every": 1, "kill_rank": 1, "kill_iter": 2,
               "return_model": True, "params": {"tree_learner": "data"}}
    out = run_elastic(2, "lightgbm_tpu_torch.parallel.worker:train_worker",
                      payload, device="cuda", timeout=240)
    assert out["attempts"] == 2 and out["world_size"] == 1
    text = out["results"][0]["model"]
    head = lgbt.Booster(model_str=text, device="cpu").model_to_string(
        num_iteration=2)
    cont = lgbt.train(params, lgbt.Dataset.from_binned(binned,
                                                       params=params), 2,
                      init_model=lgbt.Booster(model_str=head, device=dev),
                      device=dev)
    assert cont.model_to_string() == text


# ------------------------------------------------ B5, the one-scan kernel
def _leaf_form(dev, n, f, b, form, size, seed=0):
    """A leaf_size_case on the card: X, leaf ids, w3, the leaf as a (1,)
    int32 tensor, the exponents, a grower's workspace."""
    X, lid, w3, leaf = leaf_size_case(n, f, b, form, size, seed)
    Xd, lidd, w3d = (t(a).to(dev) for a in (X, lid, w3))
    leaf_t = torch.full((1,), leaf, dtype=torch.int32, device=dev)
    work = wk.list_workspace(n, 1, f, b, dev, form == "f64", rowmajor=True)
    return Xd, lidd, w3d, leaf_t, wk.fixed_point_exponents(w3d), work


def _leaf_tail(work, f, b, wide):
    return work[work.numel() - wk.leaf_sum_words(f, b, wide):]


@pytest.mark.parametrize("size", LEAF_SIZES)
@pytest.mark.parametrize("b,form", LEAF_FORMS)
def test_leaf_one_scan_every_form_bit_equal_to_b4(dev, b, form, size):
    """B5 in every form (the one-scan kernel: byte at 63 and 255 bins,
    f64 at 63; B4's plan where one block cannot hold the cells: uint16
    at 1023, f64 at 255 and 1023) at every leaf size (no row, ~N/4096,
    ~N/64, the root): bit-equal to B4 at K = 1 on the same ids, weights
    and exponents, within the float64 tolerance of the plain version,
    two back-to-back calls bit-identical, and the workspace's sums and
    zero again after each call."""
    n, f = 300_000, 28
    wide = form == "f64"
    X, lid, w3, leaf, exps, work = _leaf_form(dev, n, f, b, form, size)
    plan = lh.leaf_plan(f, b, wide)
    assert bool(plan.fused) == (b <= (63 if wide else 255))
    got = lh.leaf_histogram(X, None, None, lid, leaf, None, b, w3=w3,
                            exps=exps, work=work)
    again = lh.leaf_histogram(X, None, None, lid, leaf, None, b, w3=w3,
                              exps=exps, work=work)
    b4 = wk.wave_histogram_rowmajor(X, lid, w3, leaf, b, exps=exps)[0]
    torch.cuda.synchronize()
    assert got.dtype == w3.dtype and got.shape == (f, b, 3)
    assert torch.equal(got, b4) and torch.equal(got, again)
    assert not bool(_leaf_tail(work, f, b, wide).any())
    assert bool(got.any()) == (size != "none")
    w64 = w3.double()

    def plain(w):
        return wk.wave_histogram_rowmajor_plain(X, lid, w, leaf, b)[0].cpu()
    assert _within_f64(got, plain(w64), plain(w64.abs()),
                       max(float(w3.abs().max()), 1.0))


@pytest.mark.parametrize("b,form", LEAF_FORMS)
def test_leaf_one_scan_graph_replays_give_the_same_bits(dev, b, form):
    """Three B5 calls (the root, ~N/64 rows, no row) captured in one CUDA
    graph on one workspace and replayed twice give the eager calls'
    histograms to the bit: each call leaves the sums zero
    for the next."""
    n, f = 200_000, 28
    X, lid, w3, leaf, exps, work = _leaf_form(dev, n, f, b, form, "n/64")
    root_ids = torch.zeros_like(lid)
    calls = ((root_ids, torch.zeros_like(leaf)), (lid, leaf),
             (lid, torch.full_like(leaf, -1)))

    def run():
        return [lh.leaf_histogram(X, None, None, ids, lf, None, b, w3=w3,
                                  exps=exps, work=work) for ids, lf in calls]
    eager = run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        for o in outs:
            o.fill_(7)
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(o, e) for o, e in zip(outs, eager))
    assert not bool(_leaf_tail(work, f, b, form == "f64").any())


@pytest.mark.parametrize("b,form", LEAF_FORMS)
def test_leaf_deferred_sums_finish_to_the_finished_histogram(dev, b, form):
    """The deferred form's int64 sums (a memset and the kernel, no
    conversion), converted by finish_hist, are the finished call's
    histogram to the bit; the f64 form's come as (low, high) words."""
    n, f = 200_000, 28
    wide = form == "f64"
    X, lid, w3, leaf, exps, work = _leaf_form(dev, n, f, b, form, "n/64")
    one = lh.leaf_histogram(X, None, None, lid, leaf, None, b, w3=w3,
                            exps=exps, work=work)
    sums = lh.leaf_histogram(X, None, None, lid, leaf, None, b, w3=w3,
                             exps=exps, work=work, finish=False)
    assert sums.dtype == torch.int64
    assert sums.shape == ((1, f, b, 3, 2) if wide else (1, f, b, 3))
    assert torch.equal(wk.finish_hist(sums, leaf, exps)[0], one)
    # a finished call after a deferred one on the same workspace
    assert torch.equal(lh.leaf_histogram(X, None, None, lid, leaf, None, b,
                                         w3=w3, exps=exps, work=work), one)


@pytest.mark.parametrize("b,form", LEAF_FORMS)
@pytest.mark.parametrize("finish", [True, False])
def test_leaf_device_launches_within_the_design(dev, b, form, finish,
                                                tmp_path):
    """Each B5 call's device operations given a workspace, counted as the
    nodes of a CUDA graph that captures five calls (its debug dump):
    ``plan_launches`` -- two for the one-scan kernel (the kernel and its
    conversion, or a memset and the kernel when deferred), four for B4's
    chain -- and the wrapper's device_launches counter adds exactly
    that; the graph replays the eager calls' histogram.  (torch.profiler
    was not used: on the card it dropped kernel records once earlier
    tests of the file had profiled.)"""
    import re
    n, f, calls = 100_000, 28, 5
    X, lid, w3, leaf, exps, work = _leaf_form(dev, n, f, b, form, "n/64")
    plan = lh.leaf_plan(f, b, form == "f64")
    want = lh.plan_launches(plan, finish)
    assert want <= (2 if plan.fused else 4)
    lib = _build.library()
    assert lib.lgbt_leaf_static_smem() == lh.LEAF_STATIC_SMEM
    if plan.fused:
        assert lib.lgbt_leaf_smem(f, b, int(form == "f64")) == plan.smem

    def call():
        return lh.leaf_histogram(X, None, None, lid, leaf, None, b, w3=w3,
                                 exps=exps, work=work, finish=finish)
    eager = call().clone()
    torch.cuda.synchronize()
    d0 = lh.leaf_histogram.device_launches
    try:        # keep the captured cudaGraph_t for its dump
        graph, keep = torch.cuda.CUDAGraph(keep_graph=True), True
    except TypeError:
        graph, keep = torch.cuda.CUDAGraph(), False
    graph.enable_debug_mode()
    with torch.cuda.graph(graph):
        outs = [call() for _ in range(calls)]
    assert lh.leaf_histogram.device_launches - d0 == calls * want
    if keep:
        graph.instantiate()             # before the dump frees the graph
    dot = tmp_path / "b5.dot"
    graph.debug_dump(str(dot))
    nodes = set(re.findall(r"graph_\d+_node_\d+", dot.read_text()))
    assert len(nodes) == calls * want, dot.read_text()[:2000]
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(o, eager) for o in outs)
