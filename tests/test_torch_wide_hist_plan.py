"""The histogram plan of B1, B3 and B4 at wide (slot, feature) rows, on the
CPU (``ops/wave_kernels.py hist_plan``; ``csrc/wave_fused.cu``).

Where the slot-sliced plan would hold fewer than 4 features of all K
slots a block (uint16 bins at 1023 bins, byte bins at 255), the plan is
the slot-ordered one: the list passes order the compact (row, slot)
list by slot, and a block holds one slot of a feature group and walks a
contiguous share of the list.  The kernels run only on the card, so this
module holds the plan to a Python walk of its blocks, as the kernels
derive them:

* the slot-ordered list (``slot_order_plain``) holds the pairs of
  ``select_list_plain`` / ``route_list_plain``, grouped by slot, with
  the offsets of the slots' segments;
* a walk of the plan's blocks (feature groups x bin tiles x the slots'
  pieces, each through one slot's shared cells and a flush, or straight
  to the sums; list shares x slot slices under the slot-sliced plan)
  sums ``ops/histogram.py quantize_rows`` into int64
  cells, which equal ``scatter_histogram``'s with the same exponents to
  the bit (byte, uint16 and f64 forms, B in {63, 255, 1023, 16383}, K in
  {1, 32}, skewed slots, a repeated and an inactive child id); and the
  walk's histogram is the JAX package's ``wave_histogram_reference``
  within f32 tolerance;
* each listed row is read once a (feature group, bin tile) under the
  slot-ordered plan (``plan_reads``), and every plan's shared memory is
  within the budget at every B up to 65,536.
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu.ops.pallas_wave import wave_histogram_reference
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import wave_kernels as wk
from torch_cases import t
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

SMS = 132                               # an H100's SMs
# csrc/wave_fused.cu: the fewest listed rows a share takes, and the
# piece length (BT / _SHARED_ROWS_DIV rows) from which a piece goes
# through shared memory
_MIN_SHARE_ROWS = 2048
_SHARED_ROWS_DIV = 4


def case(n, f, b, k, seed, wide=False, skew=True):
    """X (N, F) bins below b (uint16 past 256 bins), leaf ids over 2k
    leaves (skewed: leaf i holds ~1 / (i + 1) of the rows), w3 (N, 3) in
    f32 (float64 when wide), and k child ids: half of the leaves, one
    inactive and one repeated when k > 2 (the root, k = 1: every row in
    leaf 0)."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b, size=(n, f)).astype(
        np.uint16 if b > 256 else np.uint8)
    X[:64] = b - 1 - np.arange(64)[:, None] % 7   # the highest bins
    w3 = rng.normal(size=(n, 3)).astype(np.float64 if wide else np.float32)
    w3[:, 2] = rng.random(n) > 0.2
    if k == 1:
        return X, np.zeros(n, np.int32), w3, np.zeros(1, np.int32)
    p = 1.0 / np.arange(1, 2 * k + 1) if skew else np.ones(2 * k)
    lid = rng.choice(2 * k, size=n, p=p / p.sum()).astype(np.int32)
    cid = rng.permutation(2 * k)[:k].astype(np.int32)
    cid[1] = -1
    cid[-1] = cid[0]
    return X, lid, w3, cid


def walk(X, leaf_id, w3, child_id, B, exps, plan):
    """The kernels' histogram pass on ``plan`` as a Python walk of its
    blocks: returns (hist, reads), the (K, F, B, 3) histogram (w3's
    dtype) converted from the int64 sums the blocks add, and how many
    blocks read each listed row's entry (in the list's order)."""
    n_rows, F = X.shape
    K = child_id.shape[0]
    rows, slots = wk.select_list_plain(leaf_id, child_id)
    if plan.ordered:
        rows, slots, off = wk.slot_order_plain(rows, slots, K)
    q = th.quantize_rows(w3, exps)                      # (N, 3, L)
    L = q.shape[-1]
    n = rows.shape[0]
    sums = torch.zeros((K, F, B, 3, L), dtype=torch.int64)
    reads = torch.zeros(n, dtype=torch.int64)
    fgroups = -(-F // plan.FS)
    tiles = plan.groups // fgroups
    BT = -(-B // tiles)
    shares = max(1, min(plan.R, n // _MIN_SHARE_ROWS))
    per = -(-n // shares)
    kslices = 1 if plan.ordered else -(-K // plan.KS)
    Xl = X.long()

    def add(cells, sel, c0, nc, b0, bn):
        """The rows sel's quantized weights into cells (nc, BT, 3, L) at
        their bins of features c0 .. c0 + nc within [b0, b0 + bn)."""
        r = rows[sel].long()
        for i in range(nc):
            x = Xl[r, c0 + i] - b0
            keep = (x >= 0) & (x < bn)
            cells[i].index_add_(0, x[keep], q[r[keep]])

    if plan.ordered:
        # slot k's segment in max(1, round(seg / per)) equal pieces, one
        # a block (at most R + K: the grid's y axis)
        pieces = []
        for k in range(K):
            seg = int(off[k + 1] - off[k])
            p = 0 if seg == 0 else max(1, (seg + per // 2) // per)
            pieces += [(k, int(off[k]) + i * seg // p,
                        int(off[k]) + (i + 1) * seg // p) for i in range(p)]
        assert len(pieces) <= plan.R + K
    for gx in range(plan.groups):
        c0 = (gx % fgroups) * plan.FS
        nc = min(plan.FS, F - c0)
        b0 = (gx // fgroups) * BT
        bn = min(BT, B - b0)
        if bn <= 0:
            continue
        if plan.ordered:
            for k, a, b in pieces:
                reads[a:b] += 1
                # a long piece through one slot's shared cells and a
                # flush, a short one straight to the sums: the same
                # integers either way
                cells = torch.zeros((nc, BT, 3, L), dtype=torch.int64)
                add(cells, slice(a, b), c0, nc, b0, bn)
                sums[k, c0:c0 + nc, b0:b0 + bn] += cells[:, :bn]
            continue
        for share in range(shares):
            j0, j1 = share * per, min(n, share * per + per)
            for z in range(kslices if j0 < j1 else 0):
                reads[j0:j1] += 1
                k0 = z * plan.KS
                s = slots[j0:j1].long()
                for kk in range(k0, min(K, k0 + plan.KS)):
                    sel = torch.nonzero(s == kk).reshape(-1) + j0
                    cells = torch.zeros((nc, BT, 3, L), dtype=torch.int64)
                    add(cells, sel, c0, nc, b0, bn)
                    sums[kk, c0:c0 + nc, b0:b0 + bn] += cells[:, :bn]
    # a repeated child id's slots hold its first slot's sums
    first = torch.argmax((child_id[:, None] == child_id[None, :])
                         .to(torch.int32), dim=1)
    return th.dequantize(sums[first], exps, w3.dtype), reads


CASES = [(63, "byte"), (255, "byte"), (1023, "uint16"), (16383, "uint16"),
         (63, "f64"), (255, "f64"), (1023, "f64"), (16383, "f64")]


@pytest.mark.parametrize("k", [1, 32])
@pytest.mark.parametrize("b,form", CASES)
def test_plan_walk_equals_scatter_histogram_to_the_bit(b, form, k):
    """The plan's blocks sum every listed (row, feature) into its cell
    once: the walk's histogram is the scatter engine's with the same
    exponents, bit for bit; under the slot-ordered plan each listed row
    is read once a (feature group, bin tile), under the slot-sliced one
    once a (feature group, bin tile, slot slice)."""
    wide = form == "f64"
    f = {63: 28, 16383: 2}.get(b, 6)
    n = 9000 if b < 16383 else 5000
    X, lid, w3, cid = case(n, f, b, k, seed=b + k, wide=wide)
    Xt, ids, w, c = t(X), t(lid), t(w3), t(cid)
    plan = wk.hist_plan(f, n, b, k, SMS, False, wide)
    # the main path's 63 byte bins keep 4 features of 32 slots a block
    assert bool(plan.ordered) == (k > 1 and (wide or b > 63))
    exps = wk.fixed_point_exponents(w)
    got, reads = walk(Xt, ids, w, c, b, exps, plan)
    want = th.scatter_histogram(Xt, ids, w, c, b, exps)
    assert got.dtype == w.dtype and torch.equal(got, want)
    tiles = len(wk.bin_tiles(f, b, plan.groups, plan.FS))
    assert bool((reads == wk.plan_reads(plan, k)).all())
    if plan.ordered:
        assert wk.plan_reads(plan, k) == -(-f // plan.FS) * tiles
    assert bool((got[..., b - 7:, 2] != 0).any())       # the last tile


@pytest.mark.parametrize("skew", [True, False])
def test_walk_takes_both_piece_paths(skew):
    """At 1023 bins a slot's piece of fewer than BT / 4 rows goes
    straight to the sums and a longer one through shared memory; with
    skewed slots the blocks take both, and the sums are the scatter
    engine's either way."""
    b, k, f, n = 1023, 32, 5, 30_000
    X, lid, w3, cid = case(n, f, b, k, seed=7, skew=skew)
    plan = wk.hist_plan(f, n, b, k, SMS)
    assert plan.ordered
    rows, slots = wk.select_list_plain(t(lid), t(cid))
    _, _, off = wk.slot_order_plain(rows, slots, k)
    seg = off[1:] - off[:-1]
    nonempty = seg[seg > 0]
    if skew:
        assert bool((nonempty * _SHARED_ROWS_DIV < b).any())
        assert bool((nonempty * _SHARED_ROWS_DIV >= b).any())
    exps = wk.fixed_point_exponents(t(w3))
    got, _ = walk(t(X), t(lid), t(w3), t(cid), b, exps, plan)
    assert torch.equal(got, th.scatter_histogram(t(X), t(lid), t(w3),
                                                 t(cid), b, exps))


def test_walk_matches_the_jax_reference():
    """The slot-ordered plan's histogram at 1023 uint16 bins and 32 slots
    (the walk, with the fixed point's one rounding) is the JAX package's
    wave_histogram_reference (f32 sums in another order) within rtol
    1e-5 and atol 1e-5 x max|w|."""
    b, k, f, n = 1023, 32, 4, 2500
    X, lid, w3, cid = case(n, f, b, k, seed=3)
    plan = wk.hist_plan(f, n, b, k, SMS)
    assert plan.ordered
    exps = wk.fixed_point_exponents(t(w3))
    got, _ = walk(t(X), t(lid), t(w3), t(cid), b, exps, plan)
    want = np.asarray(wave_histogram_reference(X, lid, w3, cid, b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w3).max()))


@pytest.mark.parametrize("k", [1, 5, 32])
def test_slot_ordered_list_is_the_select_and_route_lists(k):
    """slot_order_plain holds the select pass's and the routing pass's
    (row, slot) pairs, grouped by slot in slot order with rows ascending,
    and offsets whose segments hold each slot's rows; select_list and
    route_list give it on the CPU with ordered=True."""
    rng = np.random.default_rng(k)
    n, f, b = 4000, 5, 300
    X, lid, _, cid = case(n, f, b, k, seed=k)
    rows, slots = wk.select_list_plain(t(lid), t(cid))
    got_r, got_s, off = wk.slot_order_plain(rows, slots, k)
    o_rows, o_slots = wk.select_list(t(lid), t(cid), ordered=True)
    assert torch.equal(o_rows, got_r) and torch.equal(o_slots, got_s)
    assert sorted(zip(got_r.tolist(), got_s.tolist())) == sorted(
        zip(rows.tolist(), slots.tolist()))
    assert int(off[0]) == 0 and int(off[-1]) == rows.shape[0]
    for s in range(k):
        seg_r, seg_s = got_r[off[s]:off[s + 1]], got_s[off[s]:off[s + 1]]
        assert bool((seg_s == s).all())
        assert torch.equal(seg_r, rows[slots == s])    # ascending rows
    # the routing pass: the pairs of its new ids, grouped the same way
    cols = np.zeros((k, 10), np.float32)
    cols[:, 0] = 1
    cols[:, 1] = rng.integers(0, f, size=k)
    cols[:, 2] = rng.integers(0, b - 1, size=k)
    cols[:, 4] = rng.integers(0, b, size=k)
    cols[:, 6] = np.arange(2 * k, 3 * k)
    cols[:, 9] = b
    psrc = np.arange(k, dtype=np.int32)
    args = (t(X.T), t(lid), t(cid), t(cols), t(psrc))
    new_lid, rows, slots = wk.route_list_plain(*args)
    o_lid, o_rows, o_slots = wk.route_list(*args, ordered=True)
    want_r, want_s, _ = wk.slot_order_plain(rows, slots, k)
    assert torch.equal(o_lid, new_lid)
    assert torch.equal(o_rows, want_r) and torch.equal(o_slots, want_s)
    assert bool((o_slots[1:] >= o_slots[:-1]).all())


@pytest.mark.parametrize("packed,wide", [(False, False), (True, False),
                                         (False, True)])
def test_plans_within_the_budget_at_every_width(packed, wide):
    """Every plan's shared memory (the ordered pass's static slot
    offsets beside it) fits a block and an SM at every B up to 65,536,
    its tiles cover the bins once, and the slot-ordered plan is taken
    exactly where the slot-sliced one would hold fewer than 4 features
    a block of more than one slot and it reads a listed row fewer
    times."""
    widths = [2, 16] if packed else [
        2, 16, 63, 64, 255, 256, 511, 1023, 1024, 4096, 9386, 9387, 16383,
        65536]
    for B in widths:
        for F in (1, 3, 28, 136):
            for K in (1, 2, 8, 32, 64, 1100):
                plan = wk.hist_plan(F, 1 << 20, B, K, SMS, packed, wide)
                cellb = 3 * (16 if wide else 8)
                tiles = wk.bin_tiles(F, B, plan.groups, plan.FS, packed)
                bt = max(b1 - b0 for b0, b1 in tiles)
                assert [b0 for b0, _ in tiles] == list(range(0, B, bt))
                assert tiles[-1][1] == B
                assert plan.smem == (plan.copies * plan.KS * plan.FS * bt
                                     * cellb) <= wk._SMEM_BUDGET
                static = wk._ORDERED_STATIC_SMEM if plan.ordered else 0
                assert plan.smem + static + 1024 <= wk._SMEM_PER_SM
                if plan.ordered:
                    assert 1 < K <= wk._MAX_ORDERED_SLOTS
                    assert (plan.KS, plan.copies) == (1, 1)
                    assert wk.plan_reads(plan, K) == plan.groups
                else:
                    assert (K == 1 or K > wk._MAX_ORDERED_SLOTS
                            or plan.FS >= min(4, F))
