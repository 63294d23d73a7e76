"""The coordinate sparse store: histograms from the non-fill entries only.

Ported from the JAX package's ``ops/sparse_store.py`` (reference analog:
SparseBin/OrderedSparseBin, src/io/sparse_bin.hpp:68,
src/io/ordered_sparse_bin.hpp:26-209, which skip default-bin rows when
they scan a histogram).  ``tpu_sparse=true`` without ``tpu_sparse_kernel``
keeps the store: a flat column-major list of the entries whose bin
differs from the column's fill bin, with each entry's segment id ``col *
B + bin``.  A histogram is one segment sum over the entries, O(nnz) work
instead of O(N x F).  The JAX package computes those sums with
``jax.ops.segment_sum``, outside any Pallas kernel, so the port's are
plain torch.

On the card the sums are exact: every histogram adds the weights
quantized in the tree's 64-bit fixed point (``fixed_point_exponents``;
float64 weights under ``tpu_use_dp`` as four 32-bit limbs of a 128-bit
value) with an integer ``index_add_`` over the segment ids, then
converts as the kernels do (``ops/histogram.py``).  An integer sum does
not depend on the order of its terms (a float ``index_add_`` on CUDA
does), so fused runs equal staged ones, and the store's histograms equal
kernel B6's on the entry-chunk store (``ops/sparse_mxu.py``) bit for
bit: the two stores grow the same trees.  On CPU tensors the sums are
B6's plain version's: the weights added in their dtype, in the store's
entry order (column-major, rows ascending), which is the entry-chunk
store's order too, so on the CPU the two stores also grow the same trees
to the byte.  ``fixed=True`` asks for the fixed point on the CPU (the
card's sums, for the tests).

The fill bin of each column is the slot the histogram view rebuilds
from the leaf sums (FixHistogram, src/treelearner/feature_histogram.hpp:
904-941; ``feature_hist_view(fix_default=True)``) or never reads (the
reserved bin 0 of a multi-feature EFB group), so the store never holds
fill entries and their slots stay zero.  The partition reads a column's
entries through a static window of ``col_cap`` entries (the most any
column holds), so a CUDA graph captures it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .histogram import dequantize, quantize_rows, weight_rows
from .wave_kernels import fixed_point_exponents

# spare cells past a histogram's real ones that take the entries of rows
# in no slot (the JAX package's drop segment), spread by row: on the card
# every add is an atomic, and one spare cell would take them in series
_SPILL = 1024


@dataclass
class SparseDeviceStore:
    """Column-major non-fill entries on the device (JAX
    ``SparseDeviceStore``); ``col_cap`` is the static size of a column's
    window, the most entries any column holds."""
    nz_row: torch.Tensor    # (nnz,) i32 row ids, column-major order
    nz_bin: torch.Tensor    # (nnz,) i32 bin ids
    nz_seg: torch.Tensor    # (nnz,) i32 = col * num_bins + bin
    colptr: torch.Tensor    # (F + 1,) i32
    fill: torch.Tensor      # (F,) i32 fill bin of each column
    col_cap: int
    # entries past the columns' (colptr[F]:) pad the store to a size the
    # ranks agreed on; each carries the drop segment F * B
    padded: bool = False
    # the segments (col * B + bin) an entry can hold, the bins below the
    # column's count but its fill: the cells the data-parallel ranks
    # all-reduce (None: all F * B)
    cells: Optional[torch.Tensor] = None

    @property
    def num_cols(self) -> int:
        return int(self.fill.shape[0])

    @property
    def window_size(self) -> int:
        """Entries in a column's window (0: the store holds no entry)."""
        return self.col_cap if self.nz_row.shape[0] else 0

    def window(self, col_ids, n: int):
        """(rows, bins), each (W, col_cap): the entries of the columns
        col_ids (W,) long; a window slot past its column's entries
        carries row n, which the caller's scatter drops."""
        nnz = self.nz_row.shape[0]
        start = self.colptr[col_ids].long()
        end = self.colptr[col_ids + 1].long()
        idx = start[:, None] + torch.arange(self.col_cap,
                                            device=start.device)[None, :]
        valid = idx < end[:, None]
        idxc = idx.clamp(max=max(nnz - 1, 0))
        rows = torch.where(valid, self.nz_row[idxc], n)
        bins = torch.where(valid, self.nz_bin[idxc], 0)
        return rows, bins


def _store_arrays(binned: np.ndarray, fill: np.ndarray, num_bins: int):
    """The coordinate arrays of an (N, F) bin matrix, in numpy:
    ((nz_row, nz_bin, nz_seg, colptr, fill), col_cap), entries sorted by
    column, then row (JAX ``_store_arrays``).  The entries are found in
    row-major order and sorted by column stably, which gives that order
    without striding across the rows of the transposed matrix."""
    n, f = binned.shape
    flat = np.flatnonzero(binned != np.asarray(fill)[None, :])
    rows, cols = np.divmod(flat, f)
    bins = binned.reshape(-1)[flat].astype(np.int64)
    # a stable sort on 16-bit keys is a radix sort, ~8x faster on ~10M
    # entries than on the int64 column ids (the same order)
    order = np.argsort(cols.astype(np.int16) if f < 2 ** 15 else cols,
                       kind="stable")
    rows, cols, bins = rows[order], cols[order], bins[order]
    counts = np.bincount(cols, minlength=f)
    colptr = np.zeros(f + 1, np.int64)
    np.cumsum(counts, out=colptr[1:])
    col_cap = int(counts.max()) if f else 0
    arrays = (rows.astype(np.int32), bins.astype(np.int32),
              (cols * num_bins + bins).astype(np.int32),
              colptr.astype(np.int32), np.asarray(fill).astype(np.int32))
    return arrays, col_cap


def build_sparse_store(binned: np.ndarray, fill: np.ndarray, num_bins: int,
                       device="cpu"):
    """The store of an (N, F) bin matrix, binned on the host and uploaded
    to ``device`` once.  ``fill``: each column's fill bin
    (``column_fill_bins``); entries equal to it are dropped.  Returns
    (store, col_cap, device_bytes), the bytes as the JAX package counts
    them."""
    (rows, bins, segs, colptr, fill_i), col_cap = _store_arrays(
        binned, fill, num_bins)

    def put(a):
        return torch.as_tensor(a, device=device)

    store = SparseDeviceStore(nz_row=put(rows), nz_bin=put(bins),
                              nz_seg=put(segs), colptr=put(colptr),
                              fill=put(fill_i), col_cap=col_cap)
    device_bytes = 4 * (3 * len(rows) + len(colptr) + len(fill_i))
    return store, col_cap, device_bytes


def sharded_store_parts(binned: np.ndarray, fill: np.ndarray,
                        num_bins: int, n_shards: int):
    """Phase 1 of the sharded build (JAX ``sharded_store_parts``): the
    coordinate arrays of each of n_shards equal row blocks of binned,
    with row ids local to the block.  Returns (parts, nnz_needed,
    col_cap), the most entries and the widest column of any block; the
    ranks of the data-parallel learner, one block each, agree on the
    largest of every rank's before assembling."""
    n, f = binned.shape
    assert n % n_shards == 0, (n, n_shards)
    block = n // n_shards
    parts = [_store_arrays(binned[s * block:(s + 1) * block], fill,
                           num_bins)
             for s in range(n_shards)]
    nnz_needed = max(max(len(p[0][0]) for p in parts), 1)
    col_cap = max(p[1] for p in parts)
    return parts, nnz_needed, col_cap


def assemble_sharded_store(parts, num_cols: int, num_bins: int,
                           nnz_max: int, col_cap: int = 0):
    """Phase 2 (JAX ``assemble_sharded_store``): every block's entries
    padded to nnz_max (pad entries carry row 0, bin 0 and the drop
    segment num_cols * num_bins, which no histogram keeps) and the
    blocks concatenated, in host numpy.  Returns (store, device_bytes),
    the store's arrays numpy until ``upload_store``; col_cap: the agreed
    window (default the widest column of the parts)."""
    n_shards = len(parts)
    drop_seg = num_cols * num_bins

    def pad_to(arr, value):
        out = np.full(nnz_max, value, arr.dtype)
        out[:len(arr)] = arr
        return out

    store = SparseDeviceStore(
        nz_row=np.concatenate([pad_to(p[0][0], 0) for p in parts]),
        nz_bin=np.concatenate([pad_to(p[0][1], 0) for p in parts]),
        nz_seg=np.concatenate([pad_to(p[0][2], drop_seg) for p in parts]),
        colptr=np.concatenate([p[0][3] for p in parts]),
        fill=np.concatenate([p[0][4] for p in parts]),
        col_cap=max([int(col_cap)] + [p[1] for p in parts]),
        padded=any(len(p[0][0]) < nnz_max for p in parts))
    device_bytes = 4 * (3 * n_shards * nnz_max
                        + n_shards * (2 * num_cols + 1))
    return store, device_bytes


def upload_store(store: SparseDeviceStore, device,
                 cells=None) -> SparseDeviceStore:
    """A host-built store (``assemble_sharded_store``'s) on ``device``,
    uploaded once; cells: ``store_cells``'s, for the data-parallel
    all-reduce."""
    def put(a):
        return torch.as_tensor(a, device=device)
    return SparseDeviceStore(
        nz_row=put(store.nz_row), nz_bin=put(store.nz_bin),
        nz_seg=put(store.nz_seg), colptr=put(store.colptr),
        fill=put(store.fill), col_cap=store.col_cap, padded=store.padded,
        cells=cells)


def store_device_bytes(store: SparseDeviceStore) -> int:
    """The device bytes of a built store (JAX ops/learner.py's count on
    reuse)."""
    return 4 * (3 * int(store.nz_row.shape[0]) + 2 * store.num_cols + 1)


def column_fill_bins(num_bin_arr, default_bin_arr, bundle) -> np.ndarray:
    """(G,) int64 fill bin of each device column.

    No bundle: the feature's default bin (feature_hist_view rebuilds it
    with fix_default).  Bundled: multi-feature groups fill with the
    reserved bin 0; single-feature groups carry the feature's own bins, so
    their fill is that feature's default bin."""
    if bundle is None:
        return np.asarray(default_bin_arr, np.int64)
    fill = np.zeros(len(bundle.groups), np.int64)
    for gid, feats in enumerate(bundle.groups):
        if len(feats) == 1:
            fill[gid] = int(default_bin_arr[feats[0]])
    return fill


def _segment_histogram(store: SparseDeviceStore, slot_row, K: int, w3,
                       exps, num_bins: int, num_cols: int, fixed=None,
                       comm=None):
    """(K, F, B, 3) in w3's dtype: the sums of the entries of the rows in
    each slot (slot_row (N,) long, K for rows in no slot), in the fixed
    point (fixed None: on the card) or in w3's dtype in entry order.
    comm: the ranks of the data-parallel learner, each holding a block of
    the rows; their integer sums are all-reduced before the conversion
    (always in the fixed point), so every rank holds the histogram of
    all rows, bit for bit the serial store's fixed-point one."""
    if comm is not None:
        fixed = True
    elif fixed is None:
        fixed = w3.device.type == "cuda"
    FB = num_cols * int(num_bins)
    rows = store.nz_row.long()
    slot = slot_row[rows]
    spill = K * FB + (rows & (_SPILL - 1))
    nz_seg = store.nz_seg.long()
    live = slot < K
    if store.padded:
        live &= nz_seg < FB
    seg = torch.where(live, slot * FB + nz_seg, spill)
    if not fixed:
        acc = torch.zeros((K * FB + _SPILL, 3), dtype=w3.dtype,
                          device=w3.device)
        acc.index_add_(0, seg, w3[rows])
        return acc[:K * FB].reshape(K, num_cols, int(num_bins), 3)
    if exps is None:
        exps = fixed_point_exponents(w3)
    q = quantize_rows(w3, exps)                            # (N, 3, L)
    limbs = q.shape[-1]
    acc = torch.zeros((K * FB + _SPILL, 3 * limbs), dtype=torch.int64,
                      device=w3.device)
    acc.index_add_(0, seg, q.reshape(-1, 3 * limbs)[rows])
    S = acc[:K * FB].reshape(K, num_cols, int(num_bins), 3, limbs)
    if comm is not None:
        S = _all_reduce_cells(S, store.cells, comm)
    return dequantize(S, exps, w3.dtype)


def _all_reduce_cells(S, cells, comm):
    """The ranks' sum of the integer sums S (K, F, B, 3, L): only the
    cells an entry can hold cross the wire (every other cell is zero on
    every rank)."""
    if cells is None:
        S = S.contiguous()
        comm.all_reduce_(S)
        return S
    K, F, B, C, L = S.shape
    flat = S.reshape(K, F * B, C * L)
    part = flat.index_select(1, cells)
    comm.all_reduce_(part)
    out = torch.zeros_like(flat)
    out.index_copy_(1, cells, part)
    return out.reshape(K, F, B, C, L)


def store_cells(bins_per_col, fill, num_bins: int, device):
    """(cells,) long: the segments col * num_bins + bin with bin below the
    column's bin count and not its fill bin, in order: every segment an
    entry of the store can hold."""
    nb = np.asarray(bins_per_col, np.int64)
    fill = np.asarray(fill, np.int64)
    b = np.arange(int(num_bins))[None, :]
    ok = (b < nb[:, None]) & (b != fill[:, None])
    return torch.as_tensor(np.flatnonzero(ok.reshape(-1)), device=device)


def sparse_wave_hists(store: SparseDeviceStore, leaf_id, w3, child_id,
                      num_bins: int, num_cols: int, num_leaves: int,
                      exps=None, fixed=None, comm=None):
    """The slot form (JAX ops/wave.py ``sparse_child_hists``): the (K, F,
    B, 3) histograms of the rows whose leaf is child_id[k] (-1: an
    inactive slot, zeros), leaf ids below num_leaves; fill slots stay
    zero.  One pass over the entries: a leaf -> slot table, each entry's
    slot and segment, one integer index_add_.  A repeated child id's
    slots all hold its histogram, as kernel B6's do.  comm: the
    data-parallel ranks' sum (``_segment_histogram``)."""
    K, dev = child_id.shape[0], w3.device
    ks = torch.arange(K, dtype=torch.long, device=dev)
    cid = child_id.long()
    # leaf -> its first slot; inactive slots write the spare entry L
    tbl = torch.full((num_leaves + 1,), K, dtype=torch.long, device=dev)
    tbl.scatter_reduce_(0, torch.where(cid >= 0, cid, num_leaves), ks,
                        reduce="amin")
    tbl[num_leaves:].fill_(K)
    slot_row = tbl[leaf_id.long().clamp(0, num_leaves)]
    hist = _segment_histogram(store, slot_row, K, w3, exps, num_bins,
                              num_cols, fixed, comm)
    first = tbl[torch.where(cid >= 0, cid, num_leaves).clamp(
        max=num_leaves)]
    keep = (first < K)[:, None, None, None]
    return torch.where(keep, hist.index_select(0, first.clamp(max=K - 1)),
                       torch.zeros((), dtype=hist.dtype, device=dev))


def sparse_leaf_hist(store: SparseDeviceStore, leaf_id, w3, leaf,
                     num_bins: int, num_cols: int, exps=None, fixed=None,
                     comm=None):
    """(F, B, 3): the histogram of ``leaf`` (an int, or a (1,) tensor; -1
    gives zeros) over the weight rows w3 (N, 3), from the non-fill
    entries only; fill slots stay zero.  exps: the tree's fixed-point
    exponents of w3, computed when None; comm: the data-parallel ranks'
    sum (``_segment_histogram``)."""
    leaf = torch.as_tensor(leaf, device=w3.device).reshape(-1)[:1].long()
    slot_row = torch.where((leaf_id.long() == leaf) & (leaf >= 0), 0, 1)
    return _segment_histogram(store, slot_row, 1, w3, exps, num_bins,
                              num_cols, fixed, comm)[0]


def leaf_histogram_sparse(store: SparseDeviceStore, grad, hess, leaf_id,
                          leaf, row_mult, num_bins: int, num_cols: int,
                          exps=None, fixed=None):
    """(F, B, 3) histogram of ``leaf`` from the gradients, hessians and
    row multipliers (None: ones), as the JAX package's
    ``leaf_histogram_sparse`` takes them: ``sparse_leaf_hist`` of the
    weight rows [g * m, h * m, m]."""
    return sparse_leaf_hist(store, leaf_id,
                            weight_rows(grad, hess, row_mult), leaf,
                            num_bins, num_cols, exps, fixed)


def sparse_split_column(store: SparseDeviceStore, j, n: int):
    """Full-N int32 bin column j (an int or a (1,) long tensor): its fill
    bin, and its entries written through the static col_cap window (JAX
    ``sparse_split_column``)."""
    j = torch.as_tensor(j, device=store.fill.device).reshape(1).long()
    col = store.fill[j].expand(n + 1).clone()
    if store.window_size:
        rows, bins = store.window(j, n)
        col[rows[0].long()] = bins[0]
    return col[:n]
