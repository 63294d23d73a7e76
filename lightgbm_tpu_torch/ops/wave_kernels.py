"""Wave kernels: the fused partition + child histograms of one wave (B1),
the histogram-only pass on the transposed bins (B3) and on the row-major
bins (B4), each beside its plain torch version.

Ported from the JAX package's ``ops/pallas_wave.py``
(``wave_partition_hist_pallas_ct``, ``wave_histogram_pallas_t`` and
``wave_histogram_pallas``); the CUDA source of all three is
``csrc/wave_fused.cu``.
The contract and layouts are the JAX package's: X_t (F, N) or X (N, F)
uint8, leaf_id (N,) int32, w3 (N, 3) f32, child_id (K,) int32 (-1 =
inactive), cols (W, 10) f32, psrc (W,) int32 (-3 = inactive); histograms
come back as (K, F, B, 3) f32.  The JAX package's B4 splits the weights
into bf16 hi/lo halves for the TPU's matrix unit; the port's kernels list
the rows in a child slot (B1 while it routes them, B3 and B4 by their
ids), sum them in 64-bit fixed point (``fixed_point_exponents``) and
convert to f32 once, so the three give the same bits for the same rows
(and so do B5, ``ops/leaf_hist.py``, and B6, ``ops/sparse_mxu.py``).
The plain versions add in the weights' dtype.

Two further forms follow the tensors given: uint16 bins (``max_bin`` >
255; the JAX package stores such a matrix as uint16 and its kernels
widen any integer bin) take num_bins up to 65,536, with a launch plan
that tiles the bin axis where one (slot, feature) row of B bins would
not fit shared memory (``hist_plan``, ``bin_tiles``) and orders the list
by slot where the slots' rows are too long for several features of all
slots to share a block (``hist_plan`` ``ordered``); float64 weights
w3 (``tpu_use_dp``) select the f64 form, which sums in 128-bit fixed
point (``csrc/fixed_point.cuh``, exponents 126 - frexp_exponent(N *
max|w_c|)) and returns float64 histograms.  The f64 form takes no bf16
rounding.

Two variants of the JAX package's kernels ride every wrapper, as its
keyword arguments: ``logical_cols=F > 0`` says the bins are 4-bit packed
(``ops/pack.py``: X_t (ceil(F/2), N), X (N, ceil(F/2))), and the
histograms are still (K, F, B, 3); ``hilo=False`` is the single bf16
product (``tpu_hist_precision=bf16``): each weight is rounded to bf16 as
the JAX package's ``_round_bf16`` rounds it (``round_bf16``) before the
sums.  (The port's default ``hilo=True`` sums the unrounded weights: its
fixed point needs no hi/lo split.)  The plain versions unpack
(``ops/pack.py``) and round with ``round_bf16``, then run as before.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building it on first use) or raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import _build
from ..utils.log import LightGBMError
from .pack import nibble, packed_column, packed_width, unpack4_t

# csrc/wave_fused.cu: rows a list-pass block takes a tile, list-pass
# blocks a SM, threads of a histogram block, features it may hold and
# copies of its histogram it may keep
_LIST_TILE = 1024
_LIST_BLOCKS_PER_SM = 8
_HIST_THREADS = 1024
_GROUP_MAX = 8
_MAX_COPIES = 32
# dynamic shared memory a block may claim (of the 232,448 bytes an H100
# block can use) and what one SM holds for all its resident blocks
_SMEM_BUDGET = 220 * 1024
_SMEM_PER_SM = 228 * 1024

_num_sms = {}


# ------------------------------------------------------------ plain torch
def _split_rows(leaf_id, cols, psrc, F):
    """(r (N, 10), cj (N,), in_range (N,)): each row's split-table row
    (zeros for rows whose leaf is not split) and its split column."""
    match = leaf_id[None, :] == psrc[:, None]                  # (W, N)
    has = match.any(dim=0)
    slot = torch.argmax(match.to(torch.int32), dim=0)
    r = cols[slot] * has[:, None].to(cols.dtype)               # (N, 10)
    cj = r[:, 1].long()
    return r, cj.clamp(0, F - 1), (cj >= 0) & (cj < F)


def round_bf16(w):
    """w rounded to bf16 precision, in w's dtype, as the JAX package's
    _round_bf16 rounds it (lightgbm_tpu/ops/pallas_wave.py): 0x8000 added
    to the f32 bits and the low 16 bits cleared, so a tie rounds away
    from zero on the magnitude (``tensor.to(torch.bfloat16)`` rounds it
    to even).  The kernels round the same way (fixed_point.cuh)."""
    bits = w.to(torch.float32).contiguous().view(torch.int32)
    out = ((bits + 0x8000) & -0x10000).view(torch.float32)
    return out.to(w.dtype)


def indexable(X):
    """X as a tensor every torch indexing operation takes: uint16 bins
    (a dtype that torch supports only in part) as their int16 view,
    which ``bins_i32`` widens back."""
    return X.view(torch.int16) if X.dtype == torch.uint16 else X


def bins_i32(v):
    """Bins read from ``indexable(X)`` as int32: an int16 view's values
    masked back to 16 bits."""
    if v.dtype == torch.int16:
        return v.to(torch.int32) & 0xFFFF
    return v.to(torch.int32)


def _split_column(X, r_cj, in_range, logical_cols, rowmajor):
    """Each row's bin in its split column cj (0 out of range), read from
    the bins X (X_t (F, N), or row-major (N, F)) or from their packed
    nibbles."""
    N = X.shape[0 if rowmajor else 1]
    rows = torch.arange(N, device=X.device)
    col, high = (packed_column(r_cj, logical_cols) if logical_cols
                 else (r_cj, None))
    Xi = indexable(X)
    raw = bins_i32(Xi[rows, col] if rowmajor else Xi[col, rows])
    if logical_cols:
        raw = nibble(raw, high)
    return raw * in_range.to(torch.int32)


def route_rows_plain(X_t, leaf_id, cols, psrc, bundled: bool = False,
                     logical_cols: int = 0):
    """New leaf ids after one wave's splits (ops/wave.py route_rows): each
    row whose leaf is psrc[w] takes the split in cols[w].  logical_cols
    > 0: X_t holds the packed bins of that many columns."""
    F = logical_cols or X_t.shape[0]
    r, cj, in_range = _split_rows(leaf_id, cols, psrc, F)
    colv = _split_column(X_t, cj, in_range, logical_cols, False)
    return route_rows(r, colv, leaf_id, bundled)


def route_rows_rowmajor(X, leaf_id, cols, psrc, bundled: bool = False,
                        logical_cols: int = 0):
    """route_rows_plain on the row-major bins X (N, F): each row's bin is
    read from its split column X[row, j] (its nibble when packed)."""
    F = logical_cols or X.shape[1]
    r, cj, in_range = _split_rows(leaf_id, cols, psrc, F)
    colv = _split_column(X, cj, in_range, logical_cols, True)
    return route_rows(r, colv, leaf_id, bundled)


def route_rows(r, colv, leaf_id, bundled: bool = False):
    """Split routing shared by the dense and sparse partitions (the JAX
    package's ops/wave.py route_rows): r (N, 10) is each row's split-table
    row (zeros for rows not being split), colv (N,) int32 its bin in the
    split column.  Bundle remap, threshold compare, default-bin redirect,
    right-child move (dense_bin.hpp:190-222)."""
    active = r[:, 0] > 0.5
    dflt = r[:, 4].to(torch.int32)
    if bundled:
        goff = r[:, 7].to(torch.int32)
        span = r[:, 9].to(torch.int32)
        inb = (colv >= goff) & (colv < goff + span)
        colv = torch.where(inb, colv - goff + r[:, 8].to(torch.int32), dflt)
    thr = r[:, 2].to(torch.int32)
    go_left = torch.where(r[:, 3] > 0.5, colv == thr, colv <= thr)
    go_left = torch.where(colv == dflt, r[:, 5] > 0.5, go_left)
    return torch.where(active & ~go_left, r[:, 6].to(torch.int32), leaf_id)


def histogram_plain(X_t, w, num_bins: int):
    """(F, B, 3): hist[f, b] sums the weights w (N, 3) over the rows with
    X_t[f, row] == b, in w's dtype; bins >= num_bins are dropped.  Each
    cell adds its rows in row order."""
    F, N = X_t.shape
    B = int(num_bins)
    x = bins_i32(indexable(X_t)).long()
    in_bins = (x < B).to(w.dtype)                              # (F, N)
    idx = (torch.arange(F, device=X_t.device)[:, None] * B
           + x.clamp(max=B - 1)).reshape(-1)
    out = torch.zeros(F * B, 3, dtype=w.dtype, device=X_t.device)
    out.index_add_(0, idx, (w[None, :, :] * in_bins[:, :, None])
                   .reshape(-1, 3))
    return out.reshape(F, B, 3)


def wave_histogram_plain(X_t, leaf_id, w3, child_id, num_bins: int,
                         logical_cols: int = 0, hilo: bool = True):
    """(K, F, B, 3): hist[k, f, b] sums w3 over the rows with
    leaf_id == child_id[k] and X_t[f, row] == b, in w3's dtype.  Each
    slot sums only its own rows, in row order: the rows of other leaves
    would add zeros, which change no sum.  logical_cols > 0: X_t is
    packed (unpacked here); hilo=False: w3 rounded to bf16 first."""
    if logical_cols:
        X_t = unpack4_t(X_t, logical_cols)
    if not hilo:
        w3 = round_bf16(w3)
    out = []
    Xi = indexable(X_t)
    for k in range(child_id.shape[0]):
        rows = torch.nonzero(leaf_id == child_id[k]).squeeze(1)
        out.append(histogram_plain(Xi[:, rows], w3[rows], num_bins))
    return torch.stack(out)


def wave_histogram_rowmajor_plain(X, leaf_id, w3, child_id, num_bins: int,
                                  logical_cols: int = 0, hilo: bool = True):
    """wave_histogram_plain on the row-major bins X (N, F)."""
    return wave_histogram_plain(X.t(), leaf_id, w3, child_id, num_bins,
                                logical_cols, hilo)


def wave_partition_hist_plain(X_t, leaf_id, w3, child_id, cols, psrc,
                              num_bins: int, bundled: bool = False,
                              logical_cols: int = 0, hilo: bool = True):
    """Plain version of the fused wave step: (new_leaf_id, hist)."""
    new_lid = route_rows_plain(X_t, leaf_id, cols, psrc, bundled,
                               logical_cols)
    return new_lid, wave_histogram_plain(X_t, new_lid, w3, child_id,
                                         num_bins, logical_cols, hilo)


# ----------------------------------------------------------------- kernel
# the bin matrix dtypes and the weight dtypes the kernels take
BIN_DTYPES = (torch.uint8, torch.uint16)
WEIGHT_DTYPES = (torch.float32, torch.float64)
# the most bins a column may have: uint8 bins, and uint16 bins
MAX_BINS = {torch.uint8: 256, torch.uint16: 65536}


def _check(X_t, leaf_id, w3, child_id, num_bins, cols=None, psrc=None,
           rowmajor: bool = False, logical_cols: int = 0,
           hilo: bool = True):
    """Raise on inputs the kernels do not take; returns F, the features
    (logical columns) of the histograms.  X may hold uint8 bins (or
    4-bit packed ones) or uint16 bins; w3 may be float32 or float64 (the
    f64 form, which takes no bf16 rounding)."""
    dev = X_t.device
    F, N = (X_t.shape if X_t.dim() == 2 else (None, None))
    if rowmajor and F is not None:
        N, F = F, N
    Fd = F
    if logical_cols:
        if int(logical_cols) < 0:
            raise LightGBMError("logical_cols must be >= 0, got %s"
                                % logical_cols)
        F, Fd = int(logical_cols), packed_width(logical_cols)
        if X_t.dtype != torch.uint8:
            raise LightGBMError("packed bins are uint8, got %s" % X_t.dtype)
    bdt = X_t.dtype if X_t.dtype in BIN_DTYPES else torch.uint8
    want = [(X_t, bdt, (N, Fd) if rowmajor else (Fd, N),
             "X" if rowmajor else "X_t"),
            (leaf_id, torch.int32, (N,), "leaf_id"),
            (child_id, torch.int32, (child_id.shape[0],), "child_id")]
    if w3 is not None:
        wdt = w3.dtype if w3.dtype in WEIGHT_DTYPES else torch.float32
        want.append((w3, wdt, (N, 3), "w3"))
        if wdt == torch.float64 and not hilo:
            raise LightGBMError("the f64 form takes no bf16 rounding "
                                "(hilo=False with float64 w3)")
    if cols is not None:
        W = cols.shape[0]
        want += [(cols, torch.float32, (W, 10), "cols"),
                 (psrc, torch.int32, (W,), "psrc")]
    for t, dtype, shape, name in want:
        if F is None or t.dtype != dtype or tuple(t.shape) != shape:
            raise LightGBMError("%s: expected %s %s, got %s %s"
                                % (name, dtype, shape, t.dtype,
                                   tuple(t.shape)))
        if t.device != dev:
            raise LightGBMError("%s is on %s, X_t on %s"
                                % (name, t.device, dev))
    if not 1 <= int(num_bins) <= MAX_BINS[bdt]:
        raise LightGBMError("num_bins must be in [1, %d] for %s bins, got %d"
                            % (MAX_BINS[bdt], bdt, num_bins))
    if child_id.shape[0] < 1 or N < 1 or F < 1:
        raise LightGBMError("empty wave histogram input")
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("unsupported device %s" % dev)
    if dev.type == "cuda":
        named = [(X_t, "X_t"), (leaf_id, "leaf_id"), (child_id, "child_id")]
        if w3 is not None:
            named.append((w3, "w3"))
        if cols is not None:
            named += [(cols, "cols"), (psrc, "psrc")]
        for t, name in named:
            if not t.is_contiguous():
                raise LightGBMError("%s must be contiguous" % name)
        check_rows(N)
    return F


# the kernels hold a row in an int and address the bins with 64-bit
# offsets: the row count is their only limit on the shape
MAX_ROWS = 2 ** 31 - 1


def check_rows(n_rows: int) -> None:
    """Refuse a row count the kernels cannot index (N >= 2^31).  F x N
    may exceed 2^31: no kernel forms a 32-bit offset of row * F or
    f * N."""
    if n_rows > MAX_ROWS:
        raise LightGBMError("the kernels take fewer than 2^31 rows "
                            "(N=%d)" % n_rows)


def _sms(dev) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _num_sms:
        _num_sms[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _num_sms[key]


def fixed_point_exponents(w3, rows=None, amax=None):
    """(3,) int32 exponents e_c of the kernels' fixed point, computed on
    w3's device with no host read: e_c = 62 - frexp_exponent(N *
    max|w_c|) for f32 weights (64-bit sums), 126 - it for float64 ones
    (the f64 form's 128-bit sums), so no sum of N values of channel c
    reaches 2^62 (2^126), and rounding a value to a multiple of 2^-e_c
    errs by at most N * max|w_c| / 2^62 (/ 2^126).  w3 is fixed within
    a tree, so the grower computes this once a tree and B1, B3, B4, B5
    and B6 sum the same rows to the same bits.

    A distributed learner passes the GLOBAL row count ``rows`` and the
    all-reduced maximum ``amax`` (3,) of |w3| over the ranks: every rank
    then holds the serial run's exponents, no rank's partial sums can
    overflow, and their exact int64 sum is the serial kernel's sum."""
    n = w3.shape[0] if rows is None else int(rows)
    if amax is None:
        amax = w3.abs().amax(dim=0)
    m = amax.to(torch.float64) * n
    top = 126 if w3.dtype == torch.float64 else 62
    return (top - torch.frexp(m).exponent).to(torch.int32)


# csrc/wave_fused.cu: the slot-ordered pass takes at most this many child
# slots and keeps their offsets in static shared memory
_MAX_ORDERED_SLOTS = 1024
_ORDERED_STATIC_SMEM = 4 * (_MAX_ORDERED_SLOTS + 1)
# a feature group of at least this many features keeps the slot-sliced plan
_ORDERED_BELOW_GROUP = 4


class HistPlan(NamedTuple):
    """The launch plan of B1, B3, B4 and B5 (``hist_plan``)."""
    list_blocks: int   # list-pass blocks
    groups: int        # feature groups x bin tiles (the grid's x axis)
    R: int             # shares of the row list (the grid's y axis)
    KS: int            # child slots a block holds in shared memory
    FS: int            # features a block holds
    copies: int        # interleaved copies of the shared histogram
    smem: int          # dynamic shared memory of a block, bytes
    ordered: int       # 1: the list is ordered by slot (KS = copies = 1)


@lru_cache(maxsize=256)
def hist_plan(F: int, N: int, B: int, K: int, num_sms: int,
              packed: bool = False, wide: bool = False) -> HistPlan:
    """The launch plan of B1, B3 and B4 (``HistPlan``): list-pass blocks
    of _LIST_TILE rows a tile; histogram blocks of _HIST_THREADS threads,
    each over FS features (groups of them) and KS child slots in
    `copies` interleaved (KS, FS, BT, 3) shared histograms of 64-bit
    cells (128-bit when wide, the f64 form) of smem bytes in all, and R
    shares of the compact row list, so that one round of resident blocks
    fills every SM (and no share is empty: each holds at least a block's
    threads of rows when every row is listed).  The copies (a power of
    two up to 32, lane l adding into copy l mod copies) take the shared
    memory that one histogram leaves unused.  packed: the F features lie
    in ceil(F / 2) packed columns, and a block owns FS / 2 of them with
    both nibbles' features (FS even), so the groups split the packed
    columns.

    Bin tiles: where one (slot, feature) row of B bins exceeds the
    budget (B > 9,386 at 64 bits, > 4,693 at 128), each feature group
    is split into tiles of BT = ceil(B / tiles) bins, and ``groups``
    counts feature groups x tiles (``bin_tiles``; the kernel derives BT
    from it the same way), so every B up to 65,536 launches.

    Wide rows: where the slot-sliced plan holds fewer than
    _ORDERED_BELOW_GROUP features a block (K slots of long (slot,
    feature) rows: uint16 bins at B = 1023, byte bins at 255), every
    block of it reads the whole list once a (feature group, slot slice,
    bin tile).  There, for 1 < K <= _MAX_ORDERED_SLOTS, the plan is the
    slot-ordered one (``ordered``): the list passes order the list by
    slot (on X_t also copying the listed rows' weights and bins into
    compact rows, ``list_workspace``), a block holds ONE slot's cells of
    up to _GROUP_MAX features (KS = copies = 1) and one piece of that
    slot's rows (of n listed rows in S = min(R, n / 2048) shares, a slot
    of s rows takes max(1, round(s S / n)) pieces), and a listed row is
    read once a (feature group, bin tile) (``plan_reads``), taken where
    that is fewer reads than the slot-sliced plan's."""
    cellb = 3 * (16 if wide else 8)        # one bin of a (slot, feature)
    tiles = -(-B // max(1, _SMEM_BUDGET // cellb))
    bt = -(-B // tiles)
    cell = bt * cellb                      # one (slot, feature) row
    per = 2 if packed else 1               # features a stored column
    cols = packed_width(F) if packed else F

    def group(ks):
        """(FS, feature groups) of blocks holding ks slots' rows."""
        cs = max(1, min(cols, _GROUP_MAX // per,
                        _SMEM_BUDGET // (ks * per * cell)))
        fgroups = -(-cols // cs)
        return per * -(-cols // fgroups), fgroups   # even the groups out

    ks = max(1, min(K, _SMEM_BUDGET // (per * cell)))
    fs, fgroups = group(ks)
    kslices = -(-K // ks)
    fs1, fgroups1 = group(1)
    if (fs < _ORDERED_BELOW_GROUP and 1 < K <= _MAX_ORDERED_SLOTS
            and fgroups1 < fgroups * kslices):
        groups = fgroups1 * tiles
        smem = fs1 * cell
        per_sm = max(1, min(2048 // _HIST_THREADS, _SMEM_PER_SM // (
            smem + _ORDERED_STATIC_SMEM + 1024)))
        R = max(1, min(65535, -(-N // _HIST_THREADS),
                       (num_sms * per_sm) // groups))
        return HistPlan(_list_blocks(N, num_sms), groups, R, 1, fs1, 1,
                        smem, 1)
    groups = fgroups * tiles
    copies = 1
    while (copies < _MAX_COPIES
           and 2 * copies * ks * fs * cell <= _SMEM_BUDGET):
        copies *= 2
    smem = copies * ks * fs * cell
    per_sm = max(1, min(2048 // _HIST_THREADS,
                        _SMEM_PER_SM // (smem + 1024)))
    R = max(1, min(65535, -(-N // _HIST_THREADS),
                   (num_sms * per_sm) // (groups * kslices)))
    return HistPlan(_list_blocks(N, num_sms), groups, R, ks, fs, copies,
                    smem, 0)


def plan_reads(plan: HistPlan, K: int) -> int:
    """How many times the histogram pass reads each listed row (its list
    entry, weights and group bins): once a block that holds the row's
    slot and its features, i.e. once a (feature group, bin tile), and the
    slot-sliced plan once more for each slice of the K slots."""
    return plan.groups * (1 if plan.ordered else -(-K // plan.KS))


def bin_tiles(F: int, B: int, groups: int, FS: int, packed: bool = False):
    """The bin ranges [b0, b1) the plan's tiles hold, as the kernel
    derives them (csrc/wave_fused.cu bin_tile): the grid's ``groups``
    blocks on its x axis are feature groups of FS features (FS / 2
    packed columns) times tiles of BT = ceil(B / tiles) bins."""
    ps = FS // 2 if packed else FS
    cols = packed_width(F) if packed else F
    tiles = groups // -(-cols // ps)
    bt = -(-B // tiles)
    return [(t * bt, min(B, (t + 1) * bt)) for t in range(tiles)
            if t * bt < B]


def _list_blocks(N: int, num_sms: int) -> int:
    """List-pass blocks: one a tile of rows, at most a few a SM."""
    return max(1, min(-(-N // _LIST_TILE), num_sms * _LIST_BLOCKS_PER_SM))


def _exps(w3, exps):
    """exps checked, or computed from w3 when None."""
    if exps is None:
        return fixed_point_exponents(w3)
    return _exps_checked(exps, w3.device)


def _check_slots(K):
    """The list pass's leaf -> slot table holds 16-bit slots."""
    if K >= 2 ** 15:
        raise LightGBMError("the wave kernels take fewer than 32768 child "
                            "slots (K=%d)" % K)


def _work_size(N, K, F, B, wide):
    """int64 words of a list workspace before its compact rows."""
    return N + K * F * B * 3 * (2 if wide else 1) + 1 + 2 * K


def _compact_words(N, F, wide, bin_bytes, packed=False):
    """int64 words of the slot-ordered pass's compact rows on X_t
    (csrc/wave_fused.cu Compact): N rows of four f32 weights (f64 when
    wide) and the Fd stored bins, rounded up to 32 bytes, and 16 words
    for the 128-byte alignment."""
    fd = packed_width(F) if packed else F
    return N * (-(-((32 if wide else 16) + fd * bin_bytes) // 32) * 4) + 16


def leaf_sum_words(F, B, wide: bool = False) -> int:
    """int64 words of B5's one-scan sums (``ops/leaf_hist.py``): the (F,
    B, 3) fixed-point sums, two words each when wide."""
    return F * B * 3 * (2 if wide else 1)


def list_workspace(N, K, F, B, dev, wide: bool = False,
                   rowmajor: bool = False):
    """The list passes' int64 workspace for N rows and up to K child
    slots of (F, B) histograms: the compact list (N int2), then the K *
    F * B * 3 fixed-point sums (two words each when wide, the f64 form),
    the list's length, K slot counts and K cursors, and, where the plan
    at (F, N, B, K) is slot-ordered (``hist_plan``) on the transposed
    bins X_t (B1, B3; not rowmajor, B4), the compact rows of the listed
    rows' weights and bins (uint16 past 256 bins).  Its last
    ``leaf_sum_words`` words are B5's sums, zeroed here: B5's conversion
    leaves them zero after each finished call, and no other kernel
    touches them.  A grower keeps one in its state and
    hands it to every call, so a call inside a CUDA graph capture
    allocates none; launches on one stream run in order, so they may
    share it, and it is freed with the state."""
    size = _work_size(N, K, F, B, wide)
    if (dev.type == "cuda" and not rowmajor
            and hist_plan(F, N, B, K, _sms(dev), False, wide).ordered):
        size += _compact_words(N, F, wide, 2 if B > 256 else 1)
    tail = leaf_sum_words(F, B, wide)
    work = torch.empty(size + tail, dtype=torch.int64, device=dev)
    work[size:].zero_()
    return work


def _list_buffers(N, K, F, B, dev, hist_shape=None, work=None,
                  wide: bool = False, finish: bool = True, compact=0):
    """(list, acc, work, hist): the pointers of the compact list and of
    the fixed-point sums with the list's length after them, which the
    kernel entry zeroes; the workspace holding both and `compact` words
    of compact rows (``work``, the caller's, or a new one the caller
    keeps until it has launched); the (K, F, B, 3) histogram (or
    hist_shape), f32 (float64 when wide), new each call, or None for a
    deferred-finish launch (finish False)."""
    _check_slots(K)
    size = _work_size(N, K, F, B, wide) + compact
    if work is None:
        work = torch.empty(size, dtype=torch.int64, device=dev)
    elif (work.dtype != torch.int64 or work.device != dev
          or work.dim() != 1 or work.numel() < size
          or not work.is_contiguous()):
        raise LightGBMError("work: expected a contiguous int64 vector of at "
                            "least %d on %s, got %s %s on %s"
                            % (size, dev, work.dtype, tuple(work.shape),
                               work.device))
    hist = (torch.empty(hist_shape or (K, F, B, 3),
                        dtype=torch.float64 if wide else torch.float32,
                        device=dev) if finish else None)
    return work.data_ptr(), work.data_ptr() + 8 * N, work, hist


def _sums_view(work, N, K, F, B, wide: bool):
    """The fixed-point sums a deferred-finish launch left in work: an
    int64 (K, F, B, 3) view, (K, F, B, 3, 2) when wide (low word, high
    word).  It lives until the next launch on the same workspace."""
    shape = (K, F, B, 3, 2) if wide else (K, F, B, 3)
    n = K * F * B * 3 * (2 if wide else 1)
    return work[N:N + n].view(shape)


def _launch_fused(X_t, leaf_id, w3, child_id, cols, psrc, num_bins,
                  bundled, exps, work, F, logical_cols, hilo, finish=True):
    lib = _build.library()
    N = X_t.shape[1]
    K, W, B = child_id.shape[0], cols.shape[0], int(num_bins)
    if W >= 2 ** 15:
        raise LightGBMError("B1 takes fewer than 32768 parents (W=%d)" % W)
    exps = _exps(w3, exps)
    dev = X_t.device
    packed = bool(logical_cols)
    wide = w3.dtype == torch.float64
    plan = hist_plan(F, N, B, K, _sms(dev), packed, wide)
    compact = (_compact_words(N, F, wide, X_t.element_size(), packed)
               if plan.ordered else 0)
    rows, acc, work, hist = _list_buffers(N, K, F, B, dev, work=work,
                                          wide=wide, finish=finish,
                                          compact=compact)
    new_lid = torch.empty(N, dtype=torch.int32, device=dev)
    err = lib.lgbt_wave_fused(
        *[t.data_ptr() for t in (X_t, leaf_id, w3, child_id, cols, psrc,
                                 exps, new_lid)], rows, acc,
        0 if hist is None else hist.data_ptr(),
        F, N, B, K, W, *plan[:6], plan.ordered, int(bundled), int(packed),
        int(not hilo),
        int(X_t.dtype == torch.uint16), int(wide), int(finish),
        _build.stream(dev))
    _build.check(err, "wave_fused")
    if not finish:
        return new_lid, _sums_view(work, N, K, F, B, wide)
    return new_lid, hist


def _launch_hist(X, leaf_id, w3, child_id, num_bins, exps, rowmajor, work,
                 F, logical_cols=0, hilo=True, finish=True):
    """B3 (X_t) or B4 (row-major X): the select pass, the histogram pass
    over its list, the f32 conversion (none when finish is False: the
    sums are returned instead).  F: the histograms' features."""
    lib = _build.library()
    N = X.shape[0 if rowmajor else 1]
    K, B = child_id.shape[0], int(num_bins)
    exps = _exps(w3, exps)
    dev = X.device
    packed = bool(logical_cols)
    wide = w3.dtype == torch.float64
    plan = hist_plan(F, N, B, K, _sms(dev), packed, wide)
    compact = (_compact_words(N, F, wide, X.element_size(), packed)
               if plan.ordered and not rowmajor else 0)
    rows, acc, work, hist = _list_buffers(N, K, F, B, dev, work=work,
                                          wide=wide, finish=finish,
                                          compact=compact)
    err = lib.lgbt_wave_hist(
        *[t.data_ptr() for t in (X, leaf_id, w3, child_id, exps)], rows, acc,
        0 if hist is None else hist.data_ptr(), F, N, B, K, *plan[:6],
        plan.ordered, int(rowmajor), int(packed), int(not hilo),
        int(X.dtype == torch.uint16), int(wide), int(finish),
        _build.stream(dev))
    _build.check(err, "wave_hist")
    if not finish:
        return _sums_view(work, N, K, F, B, wide)
    return hist


def _count(wrapper, logical_cols, hilo, X=None, w3=None, finish=True):
    """One launch of wrapper's kernel, and of its packed, bf16, uint16,
    f64 or deferred-finish form."""
    wrapper.launches += 1
    for form, on in (("packed", logical_cols), ("bf16", not hilo),
                     ("uint16", X is not None and X.dtype == torch.uint16),
                     ("f64", w3 is not None and w3.dtype == torch.float64),
                     ("deferred", not finish)):
        if on:
            wrapper.form_launches[form] += 1


def _slots_plain(ids, child_id):
    """(rows, slots): in row order the rows whose id is a child id, with
    the first slot that holds it."""
    match = ids[None, :] == child_id[:, None]                   # (K, N)
    slot = torch.where(match.any(dim=0),
                       torch.argmax(match.to(torch.int32), dim=0),
                       torch.full_like(ids, -1, dtype=torch.long))
    rows = torch.nonzero(slot >= 0).reshape(-1)
    return rows.to(torch.int32), slot[rows].to(torch.int32)


def route_list_plain(X_t, leaf_id, child_id, cols, psrc,
                     bundled: bool = False, logical_cols: int = 0):
    """(new_leaf_id, rows, slots): the routed ids, and in row order the
    rows whose new id is a child id with the first slot holding it."""
    new_lid = route_rows_plain(X_t, leaf_id, cols, psrc, bundled,
                               logical_cols)
    return (new_lid, *_slots_plain(new_lid, child_id))


def select_list_plain(leaf_id, child_id):
    """(rows, slots): in row order the rows whose leaf id is a child id,
    with the first slot holding it (the select pass of B3 and B4)."""
    return _slots_plain(leaf_id, child_id)


def slot_order_plain(rows, slots, K: int):
    """The slot-ordered list of the plan's wide rows (``hist_plan``
    ``ordered``): (rows, slots, offsets) with the (row, slot) pairs
    grouped by slot in slot order, rows ascending within a slot (the
    kernel's order within a slot is any: its sums are order-free), and
    offsets (K + 1,) int64, slot k's pairs being [offsets[k],
    offsets[k + 1])."""
    by_row = torch.argsort(rows, stable=True)
    order = by_row[torch.argsort(slots[by_row], stable=True)]
    counts = torch.bincount(slots.long(), minlength=K)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    return rows[order], slots[order], offsets


def _list(lid, child_id, N, mode, xt=None, cols=None, psrc=None,
          new_lid=None, F=0, logical_cols=0, ordered=False):
    """The list pass alone: its list sorted by row, or (ordered) the
    slot-ordered passes' list as they wrote it."""
    K = child_id.shape[0]
    _check_slots(K)
    if ordered and K > _MAX_ORDERED_SLOTS:
        raise LightGBMError("the slot-ordered list takes at most %d slots "
                            "(K=%d)" % (_MAX_ORDERED_SLOTS, K))
    dev = lid.device
    rows = torch.empty((N, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1 + 2 * K, dtype=torch.int64, device=dev)
    W = 0 if cols is None else cols.shape[0]
    ptrs = [0 if t is None else t.data_ptr()
            for t in (xt, lid, child_id, cols, psrc, new_lid, rows, count)]
    err = _build.library().lgbt_wave_list(
        *ptrs, count.data_ptr() + 8, F, N, K, W,
        _list_blocks(N, _sms(dev)), mode, int(bool(logical_cols)),
        int(xt is not None and xt.dtype == torch.uint16), int(ordered),
        _build.stream(dev))
    _build.check(err, "wave_list")
    # the checking passes' read of the list's length (off the training
    # path)
    rows = rows[:int(count[0])]  # lint: ignore[sync-scalar-cast] check pass
    if ordered:
        return rows[:, 0], rows[:, 1]
    order = torch.argsort(rows[:, 0])
    return rows[order, 0], rows[order, 1]


def route_list(X_t, leaf_id, child_id, cols, psrc, bundled: bool = False,
               logical_cols: int = 0, ordered: bool = False):
    """B1's routing pass alone, for checking it: route_list_plain's
    contract, with the kernel's list sorted by row; ordered: the
    slot-ordered passes' list as written (slot_order_plain's order on
    the CPU).  Reads the list's length back to the host."""
    F = _check(X_t, leaf_id, None, child_id, 1, cols, psrc,
               logical_cols=logical_cols)
    if X_t.device.type == "cpu":
        new_lid, rows, slots = route_list_plain(X_t, leaf_id, child_id, cols,
                                                psrc, bundled, logical_cols)
        if ordered:
            rows, slots, _ = slot_order_plain(rows, slots,
                                              child_id.shape[0])
        return new_lid, rows, slots
    new_lid = torch.empty_like(leaf_id)
    rows, slots = _list(leaf_id, child_id, X_t.shape[1], 1 + int(bundled),
                        X_t, cols, psrc, new_lid, F, logical_cols, ordered)
    return new_lid, rows, slots


def select_list(leaf_id, child_id, ordered: bool = False):
    """The select pass of B3 and B4 alone, for checking it:
    select_list_plain's contract, with the kernel's list sorted by row;
    ordered: the slot-ordered passes' list as written (slot_order_plain's
    order on the CPU).  Reads the list's length back to the host."""
    if (leaf_id.dtype != torch.int32 or child_id.dtype != torch.int32
            or leaf_id.dim() != 1 or child_id.dim() != 1
            or leaf_id.device != child_id.device or not len(leaf_id)
            or not len(child_id)):
        raise LightGBMError("select_list: expected non-empty 1-D int32 "
                            "leaf_id and child_id on one device")
    if leaf_id.device.type == "cpu":
        rows, slots = select_list_plain(leaf_id, child_id)
        if ordered:
            rows, slots, _ = slot_order_plain(rows, slots,
                                              child_id.shape[0])
        return rows, slots
    if not (leaf_id.is_contiguous() and child_id.is_contiguous()):
        raise LightGBMError("select_list: leaf_id and child_id must be "
                            "contiguous")
    return _list(leaf_id, child_id, leaf_id.shape[0], 0, ordered=ordered)


def wave_partition_hist(X_t, leaf_id, w3, child_id, cols, psrc,
                        num_bins: int, bundled: bool = False, exps=None,
                        work=None, logical_cols: int = 0,
                        hilo: bool = True, finish: bool = True):
    """Fused wave step (kernel B1): route the rows of the wave's parents
    and build the (K, F, B, 3) histograms of the children child_id from
    the new ids.  Returns (new_leaf_id, hist).  exps: the kernel's
    fixed-point exponents (fixed_point_exponents(w3)), computed here when
    None; work: the list passes' workspace (``list_workspace``), a new
    one each call when None.  The plain version uses neither.
    logical_cols > 0: X_t holds the packed bins of that many columns;
    hilo=False: the single bf16 product (module docstring).

    finish=False is the deferred-finish form: the kernel stops before
    the conversion and returns (new_leaf_id, sums), the fixed-point sums
    as an int64 view of work (``_sums_view``), which ranks add exactly
    before ``finish_hist`` converts them.  The plain version returns its
    histogram in the weights' dtype either way."""
    F = _check(X_t, leaf_id, w3, child_id, num_bins, cols, psrc,
               logical_cols=logical_cols, hilo=hilo)
    if X_t.device.type == "cpu":
        return wave_partition_hist_plain(X_t, leaf_id, w3, child_id, cols,
                                         psrc, num_bins, bundled,
                                         logical_cols, hilo)
    out = _launch_fused(X_t, leaf_id, w3, child_id, cols, psrc, num_bins,
                        bundled, exps, work, F, logical_cols, hilo, finish)
    _count(wave_partition_hist, logical_cols, hilo, X_t, w3, finish)
    return out


def wave_histogram(X_t, leaf_id, w3, child_id, num_bins: int, exps=None,
                   work=None, logical_cols: int = 0, hilo: bool = True,
                   finish: bool = True):
    """Histogram-only wave pass (kernel B3): (K, F, B, 3) histograms of
    the rows whose leaf is child_id[k].  exps, work, logical_cols, hilo
    and finish (False: the fixed-point sums, unconverted) as for
    wave_partition_hist."""
    F = _check(X_t, leaf_id, w3, child_id, num_bins,
               logical_cols=logical_cols, hilo=hilo)
    if X_t.device.type == "cpu":
        return wave_histogram_plain(X_t, leaf_id, w3, child_id, num_bins,
                                    logical_cols, hilo)
    out = _launch_hist(X_t, leaf_id, w3, child_id, num_bins, exps, False,
                       work, F, logical_cols, hilo, finish)
    _count(wave_histogram, logical_cols, hilo, X_t, w3, finish)
    return out


def wave_histogram_rowmajor(X, leaf_id, w3, child_id, num_bins: int,
                            exps=None, work=None, logical_cols: int = 0,
                            hilo: bool = True, finish: bool = True):
    """Histogram-only wave pass on the row-major bins X (N, F), or (N,
    ceil(F/2)) packed (kernel B4): the contract of wave_histogram."""
    F = _check(X, leaf_id, w3, child_id, num_bins, rowmajor=True,
               logical_cols=logical_cols, hilo=hilo)
    if X.device.type == "cpu":
        return wave_histogram_rowmajor_plain(X, leaf_id, w3, child_id,
                                             num_bins, logical_cols, hilo)
    out = _launch_hist(X, leaf_id, w3, child_id, num_bins, exps, True, work,
                       F, logical_cols, hilo, finish)
    _count(wave_histogram_rowmajor, logical_cols, hilo, X, w3, finish)
    return out


def finish_hist_plain(sums, child_id, exps=None):
    """The plain versions convert nothing: their "sums" are already the
    histograms, in the weights' dtype (ranks add them in that dtype)."""
    return sums


def finish_hist(sums, child_id, exps):
    """The conversion of a deferred-finish launch alone (B1, B3, B4 and B5
    with finish=False): the (K, F, B, 3) histogram, f32 (float64 from
    the f64 form's two-word sums (K, F, B, 3, 2)), of the int64 sums with
    the tree's fixed-point exponents exps; slot k reads the first slot
    holding child_id[k], as the kernels' own conversion does.  On the
    CPU the sums are the plain versions' histograms, returned as they
    are."""
    if sums.device.type == "cpu":
        return finish_hist_plain(sums, child_id, exps)
    wide = sums.dim() == 5
    if (sums.dtype != torch.int64 or sums.dim() not in (4, 5)
            or (wide and sums.shape[4] != 2) or sums.shape[3] != 3
            or not sums.is_contiguous()):
        raise LightGBMError("finish_hist: expected contiguous int64 sums "
                            "(K, F, B, 3) or (K, F, B, 3, 2), got %s %s"
                            % (sums.dtype, tuple(sums.shape)))
    K, F, B = (int(d) for d in sums.shape[:3])
    if (child_id.dtype != torch.int32 or tuple(child_id.shape) != (K,)
            or child_id.device != sums.device):
        raise LightGBMError("finish_hist: child_id must be int32 (%d,) on "
                            "%s" % (K, sums.device))
    exps = _exps_checked(exps, sums.device)
    hist = torch.empty((K, F, B, 3),
                       dtype=torch.float64 if wide else torch.float32,
                       device=sums.device)
    err = _build.library().lgbt_wave_finish(
        sums.data_ptr(), child_id.data_ptr(), exps.data_ptr(),
        hist.data_ptr(), F, B, K, int(wide), _build.stream(sums.device))
    _build.check(err, "wave_finish")
    finish_hist.launches += 1
    return hist


def _exps_checked(exps, dev):
    """exps, raising unless it is an int32 (3,) tensor on dev."""
    if (exps is None or exps.dtype != torch.int32
            or tuple(exps.shape) != (3,) or exps.device != dev):
        raise LightGBMError("exps: expected int32 (3,) on %s" % dev)
    return exps


# each wrapper's launches, and of them its packed, bf16, uint16, f64 and
# deferred-finish forms'
FORMS = ("packed", "bf16", "uint16", "f64", "deferred")
for _w in (wave_partition_hist, wave_histogram, wave_histogram_rowmajor):
    _w.launches = 0
    _w.form_launches = dict.fromkeys(FORMS, 0)
del _w
finish_hist.launches = 0
