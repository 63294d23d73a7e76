"""B5's one-scan plan on the CPU (``ops/leaf_hist.py leaf_plan``;
``csrc/leaf_hist.cu``).

The kernel runs only on the card, so this module holds its block
decomposition to a Python walk, as the kernel does it:

* a persistent grid: warp w of block k takes the groups of four chunks
  of 128 rows k 32 + w, k 32 + w + 32 blocks, ...; each leaf id is read
  once in all;
* a warp adds the leaf's rows into its block's cells of all F features,
  32 at a time (a row a lane), and the rows left at the end of its walk
  as (row, feature) items over its lanes;
* each block adds its non-zero cells into the int64 sums, and the
  conversion turns them into the histogram and zeroes them;

so its histogram equals ``scatter_histogram``'s with the same exponents
to the bit (byte, uint16 and f64 forms, B in {15, 63, 255, 1023, 16383},
no row, one row, ~N/64 and every row; where one block cannot hold the
cells, B4's plan at K = 1, walked as ``tests/test_torch_wide_hist_plan.py``
walks it), and every plan's shared memory is within an H100 block's and
SM's at every B up to 65,536.
"""
import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import leaf_hist as lh
from lightgbm_tpu_torch.ops import wave_kernels as wk
from test_torch_wide_hist_plan import walk as b4_walk
from torch_cases import t
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

SMS = 132                               # an H100's SMs
# csrc/leaf_hist.cu kChunk, kSub, kWarps
CHUNK, SUB, WARPS = 128, 4, 32
# the most shared memory an H100 block may opt into, and an SM's
H100_SMEM_PER_BLOCK, H100_SMEM_PER_SM = 232448, 233472


def case(n, f, b, form, leaf, seed):
    """X (N, F) bins in [0, b] (uint16 past 256 bins or for the uint16
    form; the bin b dropped), w3 (N, 3) f32 or float64, leaf ids over 64
    leaves and the leaf: -1 (no row), 1 (one row), 2 (~N/64) or 0 with
    every row in it."""
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b + 1, size=(n, f)).astype(
        np.uint16 if b > 256 or form == "uint16" else np.uint8)
    w3 = rng.normal(size=(n, 3)).astype(
        np.float64 if form == "f64" else np.float32)
    w3[:, 2] = rng.random(n) > 0.2
    if leaf == 0:
        return X, np.zeros(n, np.int32), w3
    lid = rng.integers(3, 64, size=n).astype(np.int32)
    lid[rng.choice(n, size=n // 64, replace=False)] = 2
    lid[rng.integers(0, n)] = 1
    return X, lid, w3


def walk(X, lid, w3, leaf, B, exps, blocks):
    """The one-scan kernel as a Python walk of a grid of `blocks` blocks:
    returns (hist, sums, reads, flushed), the (F, B, 3) histogram the
    last block converts, the sums it leaves (zeroed), how many times each
    leaf id is read and how many cells the blocks flush."""
    n, F = X.shape
    q = th.quantize_rows(w3, exps)                  # (N, 3, L)
    L = q.shape[-1]
    group = torch.arange(n) // (CHUNK * SUB)        # a warp's load of ids
    warp = group % (blocks * WARPS)                 # the warp of each row
    reads = torch.zeros(n, dtype=torch.int64)
    for k in range(blocks):
        reads[warp // WARPS == k] += 1
    sums = torch.zeros((F, B, 3, L), dtype=torch.int64)
    flushed = 0
    Xl = X.long()
    for k in range(blocks):
        cells = torch.zeros((F * B, 3, L), dtype=torch.int64)
        for w in range(k * WARPS, (k + 1) * WARPS):
            rows = torch.nonzero((lid == leaf) & (warp == w)).reshape(-1)
            full = rows.shape[0] // 32 * 32
            # a row a lane for the full batches of 32; the rest as
            # (row, feature) items: every (row, feature) once either way
            for part in (rows[:full], rows[full:]):
                t = torch.arange(part.shape[0] * F)
                r, f = part[t // F], t % F
                x = Xl[r, f]
                keep = x < B
                cells.index_add_(0, f[keep] * B + x[keep], q[r[keep]])
        nz = (cells != 0).any(dim=-1).any(dim=-1)
        flushed += int(nz.sum()) * 3
        sums += (cells * nz[:, None, None]).view(F, B, 3, L)
    hist = th.dequantize(sums, exps, w3.dtype)      # the last block
    sums.zero_()
    return hist, sums, reads, flushed


FORMS = ([(b, "byte") for b in (15, 63, 255)]
         + [(b, form) for form in ("uint16", "f64")
            for b in (15, 63, 255, 1023, 16383)])


@pytest.mark.parametrize("leaf", [-1, 1, 2, 0])
@pytest.mark.parametrize("b,form", FORMS)
def test_leaf_walk_equals_scatter_histogram_to_the_bit(b, form, leaf):
    """The one-scan plan's blocks read each leaf id once and sum every
    (row, feature) of the leaf into its cell once: the walk's histogram
    is the scatter engine's with the same exponents, bit for bit, and
    the sums are zero again after the conversion; where one block cannot
    hold the cells, B4's plan at K = 1 gives the same bits."""
    wide = form == "f64"
    n, f = (9000, 28) if b < 16383 else (5000, 3)
    X, lid, w3 = case(n, f, b, form, leaf, seed=b + leaf + 7)
    Xt, ids, w = t(X), t(lid), t(w3)
    leaf_t = torch.tensor([leaf], dtype=torch.int32)
    exps = wk.fixed_point_exponents(w)
    want = th.scatter_histogram(Xt, ids, w, leaf_t, b, exps)[0]
    if leaf == -1:
        assert not bool(want.any())
    plan = lh.leaf_plan(f, b, wide)
    if not plan.fused:
        assert b > (63 if wide else 255)
        got = b4_walk(Xt, ids, w, leaf_t, b, exps,
                      wk.hist_plan(f, n, b, 1, SMS, False, wide))[0][0]
        assert torch.equal(got, want)
        return
    got, sums, reads, flushed = walk(Xt, ids, w, leaf, b, exps, blocks=3)
    assert got.dtype == w.dtype and torch.equal(got, want)
    assert not bool(sums.any()) and bool((reads == 1).all())
    in_leaf = int((ids == leaf).sum())
    assert (flushed == 0) == (in_leaf == 0)
    # the cells a block flushes: at most its rows' (row, feature) cells
    assert flushed <= 3 * in_leaf * f
    if leaf == 0 and b <= 63:
        assert bool((got[..., b - 1, 2] != 0).any())      # the last bin


@pytest.mark.parametrize("wide", [False, True])
def test_leaf_plans_within_the_budget_at_every_width(wide):
    """At every B up to 65,536 and F from 1 to 2,000: a fused plan's block
    holds the (F, B, 3) cells within the budget, its planes and static
    shared memory fit what an H100 block may opt into and leave the SM
    room for it; and where one block cannot hold the cells, B4's plan at
    K = 1 fits its own budget."""
    cellb = 48 if wide else 24
    for B in (2, 15, 16, 63, 64, 255, 256, 511, 1023, 1024, 4096, 9386,
              16383, 65536):
        for F in (1, 3, 28, 136, 968, 2000):
            plan = lh.leaf_plan(F, B, wide)
            assert bool(plan.fused) == (F * B * cellb
                                        <= lh.LEAF_SMEM_BUDGET)
            if not plan.fused:
                b4 = wk.hist_plan(F, 1 << 20, B, 1, SMS, False, wide)
                assert b4.smem + 1024 <= wk._SMEM_PER_SM
                continue
            assert plan.smem == F * B * cellb
            assert plan.smem + lh.LEAF_STATIC_SMEM <= H100_SMEM_PER_BLOCK
            assert plan.smem + lh.LEAF_STATIC_SMEM + 1024 <= H100_SMEM_PER_SM


def test_leaf_sums_live_at_the_workspace_end():
    """A finished B5 call sums into the workspace's last leaf_sum_words
    words, which list_workspace zeroes and no other kernel's buffers
    reach; the deferred form's sums are the workspace's first words, a
    (1, F, B, 3) int64 view ((1, F, B, 3, 2) when wide)."""
    N, F, B = 1000, 5, 31
    cpu = torch.device("cpu")
    for wide in (False, True):
        work = wk.list_workspace(N, 1, F, B, cpu, wide, rowmajor=True)
        words = wk.leaf_sum_words(F, B, wide)
        tail = lh._sum_region(work, words, cpu, True)
        head = lh._sum_region(work, words, cpu, False)
        assert tail.data_ptr() == work.data_ptr() + 8 * (work.numel() - words)
        assert head.data_ptr() == work.data_ptr()
        assert not bool(tail.any())
        used = wk._work_size(N, 1, F, B, wide)
        assert work.numel() == used + words
        with pytest.raises(lh.LightGBMError, match="work: expected"):
            lh._sum_region(work[:2 * words - 1], words, cpu, True)
    assert not bool(lh._sum_region(None, 7, cpu, True).any())
