"""Entry-chunk sparse store and its child-histogram kernel (B6).

Ported from the JAX package's ``ops/sparse_mxu.py`` (reference analog:
OrderedSparseBin's nonzero iteration, src/io/ordered_sparse_bin.hpp:26-209):
histogram work in proportion to the non-fill entries, not to N x F.

The store keeps the non-fill entries column-major in fixed ENTRY CHUNKS of
E entries, each chunk owned by one device column (columns are padded to
whole chunks: pad entries carry row N, which no row gather or scatter
keeps, and bin -1, which matches no bin).  Fill-bin slots of every
histogram stay exactly 0; ``feature_hist_view(fix_default=True)`` rebuilds
them from the leaf sums.

``sparse_wave_histogram`` is kernel B6 (CUDA source ``csrc/sparse_hist.cu``)
beside its plain torch version ``chunked_child_hists_plain``.  The kernel
sums in the 64-bit fixed point of the dense kernels with the tree's
exponents (``fixed_point_exponents``), so its non-fill cells equal B3's
on the same rows bit for bit.  Given CPU tensors it runs the plain
version; given CUDA tensors it launches the kernel or raises.  Its
launches are counted in ``sparse_wave_histogram.launches``.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .. import _build
from ..utils.log import LightGBMError
from .wave_kernels import (_SMEM_BUDGET, _SMEM_PER_SM, _exps, check_rows,
                           round_bf16, route_rows)

ENTRY_CHUNK = 512     # entries per chunk
CHUNK_BLOCK = 8       # the chunk count is padded to a multiple of this
# the widest entry chunk the auto_uniform layout may take
MAX_UNIFORM_CHUNK = 16384


@dataclass
class ChunkedSparseStore:
    """Column-major non-fill entries in whole-chunk-per-column layout."""
    ent_row: torch.Tensor    # (NC, E) i32 row ids (pads: N)
    ent_bin: torch.Tensor    # (NC, E) i32 bin ids (pads: -1)
    chunk_col: torch.Tensor  # (NC, 1) i32 owning device column of a chunk
    col_cptr: torch.Tensor   # (F+1,) i32 chunk range of each column
    fill: torch.Tensor       # (F,) i32 fill bin of each column
    cap_chunks: int          # the most chunks any one column holds

    @property
    def num_cols(self) -> int:
        return int(self.fill.shape[0])

    @property
    def window_size(self) -> int:
        """Chunks in a column's window (0: the store holds no entry)."""
        return self.cap_chunks

    def window(self, col_ids, n: int):
        """The entries of the columns col_ids (_window_entries)."""
        return _window_entries(self, col_ids, n)


def build_chunked_store(binned: np.ndarray, fill: np.ndarray,
                        num_bins: int, entry_chunk: int = ENTRY_CHUNK,
                        chunk_block: int = CHUNK_BLOCK,
                        auto_uniform: bool = False, device="cpu"):
    """Host-side build from the (N, F) binned matrix; the arrays land on
    ``device``.  ``fill`` is each column's fill bin
    (sparse_store.column_fill_bins).  Returns (store, device_bytes).

    auto_uniform: when per-column skew is low, widen the entry chunk so
    every column is exactly one chunk (E = the largest column's entry
    count rounded up to the base chunk), as long as the pads stay under
    half the narrow layout's entries and E under MAX_UNIFORM_CHUNK.
    Skewed stores keep the narrow chunks."""
    n, f = binned.shape
    e = int(entry_chunk)
    # non-fill entries in row-major order, then a stable sort by column:
    # column-major with rows ascending in each column.  Scanning the
    # transposed matrix instead strides across rows and is ~10x slower.
    flat = np.flatnonzero(binned != np.asarray(fill)[None, :])
    rows, cols = np.divmod(flat, f)
    bins = binned.reshape(-1)[flat].astype(np.int64)
    # a stable sort on 16-bit keys is a radix sort, ~8x faster on ~10M
    # entries than on the int64 column ids (the same order)
    order = np.argsort(cols.astype(np.int16) if f < 2 ** 15 else cols,
                       kind="stable")
    rows, cols, bins = rows[order], cols[order], bins[order]
    del flat, order
    counts = np.bincount(cols, minlength=f).astype(np.int64)
    cchunks = -(-counts // e)                       # chunks per column
    if auto_uniform and f and len(rows):
        e_uni = max(e, -(-int(counts.max()) // e) * e)
        # all-fill columns cost no chunks in either layout: charge the
        # uniform layout only for its non-empty columns
        nzc = int(np.count_nonzero(counts))
        if (e_uni <= MAX_UNIFORM_CHUNK
                and nzc * e_uni <= 1.5 * max(int(cchunks.sum()), 1) * e):
            e = e_uni
            cchunks = -(-counts // e)               # now <= 1 per column
    col_cptr = np.zeros(f + 1, np.int64)
    np.cumsum(cchunks, out=col_cptr[1:])
    nc = int(col_cptr[-1])
    nc_pad = -(-max(nc, 1) // chunk_block) * chunk_block
    ent_row = np.full((nc_pad, e), n, np.int32)
    ent_bin = np.full((nc_pad, e), -1, np.int32)
    chunk_col = np.zeros(nc_pad, np.int32)
    if nc:
        eptr = np.zeros(f + 1, np.int64)
        np.cumsum(counts, out=eptr[1:])
        within = np.arange(len(rows), dtype=np.int64) - eptr[cols]
        pos = col_cptr[cols] * e + within           # padded flat position
        ent_row.reshape(-1)[pos] = rows
        ent_bin.reshape(-1)[pos] = bins
        chunk_col[:nc] = np.repeat(np.arange(f, dtype=np.int32), cchunks)
    cap_chunks = int(cchunks.max()) if f and nc else 0

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.int32),
                               device=device)

    store = ChunkedSparseStore(
        ent_row=put(ent_row), ent_bin=put(ent_bin),
        chunk_col=put(chunk_col[:, None]), col_cptr=put(col_cptr),
        fill=put(np.asarray(fill, np.int64)), cap_chunks=cap_chunks)
    return store, chunked_device_bytes(store)


def chunked_device_bytes(store: ChunkedSparseStore) -> int:
    """The device bytes of an entry-chunk store, as the JAX package counts
    them."""
    nc, e = (int(d) for d in store.ent_bin.shape)
    return 4 * (2 * nc * e + nc + 2 * store.num_cols + 1)


# ------------------------------------------------------------ plain torch
def chunked_child_hists_plain(store: ChunkedSparseStore, leaf_id, w3,
                              child_id, num_bins: int, num_cols: int,
                              hilo: bool = True):
    """(K, F, B, 3) in w3's dtype: hist[k, f, b] sums w3 over the store's
    entries of column f with bin b whose row's leaf is child_id[k] >= 0.
    Pads, bins outside [0, B) and inactive slots add nothing; fill slots
    stay 0 (the store holds no fill entries).  hilo=False: the single
    bf16 product, w3 rounded to bf16 (round_bf16) first."""
    if not hilo:
        w3 = round_bf16(w3)
    nc, e = store.ent_bin.shape
    n = leaf_id.shape[0]
    K, B = child_id.shape[0], int(num_bins)
    dev = leaf_id.device
    rows = store.ent_row.reshape(-1).long()
    bins = store.ent_bin.reshape(-1).long()
    cols = store.chunk_col[:, 0].long().repeat_interleave(e)
    real = (rows < n) & (bins >= 0) & (bins < B)
    rc = rows.clamp(max=n - 1)
    lid = leaf_id[rc]
    wnz = w3[rc]                                               # (M, 3)
    idx = cols * B + bins.clamp(0, B - 1)
    out = torch.zeros(K, num_cols * B, 3, dtype=w3.dtype, device=dev)
    for k in range(K):
        m = real & (lid == child_id[k]) & (child_id[k] >= 0)
        out[k].index_add_(0, idx, wnz * m[:, None].to(w3.dtype))
    return out.reshape(K, num_cols, B, 3)


def _window_entries(store: ChunkedSparseStore, col_ids, n: int):
    """(rows, bins), each (W, cap_chunks * E): the entries of the columns
    col_ids, read through a window of store.cap_chunks chunks; window
    entries of other columns carry row n (dropped by the caller's
    scatter)."""
    nc, e = store.ent_row.shape
    cap = min(store.cap_chunks, nc)
    start = store.col_cptr[col_ids].long()
    end = store.col_cptr[col_ids + 1].long()
    cs = torch.clamp(start, max=nc - cap)      # window start, edge-clamped
    cidx = cs[:, None] + torch.arange(cap, device=start.device)[None, :]
    ok = ((cidx >= start[:, None]) & (cidx < end[:, None]))[..., None]
    rows = torch.where(ok, store.ent_row[cidx], n)
    bins = torch.where(ok, store.ent_bin[cidx], 0)
    return rows.reshape(len(col_ids), -1), bins.reshape(len(col_ids), -1)


def chunked_split_column(store: ChunkedSparseStore, j, n: int):
    """Full-N int32 bin column j: its fill bin plus its entries."""
    j = torch.as_tensor(j, device=store.fill.device).reshape(1).long()
    col = store.fill[j].expand(n + 1).clone()
    if store.cap_chunks:
        rows, bins = _window_entries(store, j, n)
        col[rows[0].long()] = bins[0]
    return col[:n]


def sparse_route_rows(store, leaf_id, cols, psrc, num_leaves: int,
                      bundled: bool = False):
    """New leaf ids after one wave's splits on a sparse store (this
    module's entry-chunk store or the coordinate store of
    ops/sparse_store.py): each row whose leaf is psrc[w] takes the split
    in cols[w] (the route_rows contract), its bin read from column
    cols[w, 1]: the column's fill bin unless the column holds an entry
    for the row.  Only the entries of the W split columns are read,
    through the store's static window; the routing is plain torch ops
    with no host read and no host-to-device copy, so a CUDA graph can
    capture it."""
    n = leaf_id.shape[0]
    W = psrc.shape[0]
    F = store.num_cols
    dev = leaf_id.device
    slots = torch.arange(W, dtype=torch.long, device=dev)
    # leaf -> slot table (-1: not split in this wave); inactive slots
    # write into a spare entry past the last leaf, cleared after (by a
    # device fill: a Python value assigned to an element is a copy from
    # the host, which a CUDA graph cannot capture)
    tbl = torch.full((num_leaves + 1,), -1, dtype=torch.long, device=dev)
    tbl[torch.where(psrc >= 0, psrc.long(),
                    torch.full_like(slots, num_leaves))] = slots
    tbl[num_leaves:].fill_(-1)
    slot = tbl[leaf_id.long().clamp(0, num_leaves)]
    has = slot >= 0
    r = cols[slot.clamp(min=0)] * has[:, None].to(cols.dtype)  # (N, 10)
    cj = r[:, 1].long()
    in_range = (cj >= 0) & (cj < F)
    colv = store.fill[cj.clamp(0, F - 1)] * in_range.to(torch.int32)
    if store.window_size:
        wcol = cols[:, 1].long().clamp(0, F - 1)
        rows, bins = store.window(wcol, n)
        rows = rows.long()
        # a row takes an entry only from its own slot's column
        mine = (rows < n) & (slot[rows.clamp(max=n - 1)] == slots[:, None])
        buf = torch.cat([colv, colv.new_zeros(1)])
        buf[torch.where(mine, rows, torch.full_like(rows, n))] = bins
        colv = buf[:n] * in_range.to(torch.int32)
    return route_rows(r, colv, leaf_id, bundled)


# ----------------------------------------------------------------- kernel
# csrc/sparse_hist.cu: the leaf -> slot table's static shared memory
_STATIC_SMEM = 2 * 4096 + 4
# threads a block, and where shared memory holds at most two blocks an SM
_THREADS = 512
_THREADS_WIDE = 1024


def _smem_bytes(BT: int, ks: int) -> int:
    """lgbt_sparse_hist_smem in csrc/sparse_hist.cu: one block's shared
    memory (the int64 (KS, BT, 3) histogram of its tile of BT bins, the
    slice's child ids and first holders, the leaf -> slot table)."""
    return 8 * ks * BT * 3 + 8 * ks + _STATIC_SMEM


# the most bins a column may have (the dense kernels' uint16 bins)
MAX_BINS = 65536


@lru_cache(maxsize=64)
def launch_plan(B: int, K: int):
    """(KS, threads, smem, tiles): child slots a block owns, threads a
    block, shared memory a block and tiles of the bin axis.  A block
    covers one device column, KS slots (the K slots split evenly over as
    few slices as fit the budget) and ceil(B / tiles) bins (one tile
    unless one (slot, B, 3) row exceeds the budget: B > 9,044), with
    _THREADS threads, or _THREADS_WIDE where shared memory holds at most
    two blocks an SM (255 bins at K = 32), so an SM keeps up to 2048
    threads of gathers in flight.  Raises past MAX_BINS bins."""
    if not 1 <= B <= MAX_BINS:
        raise LightGBMError("sparse histogram: %d bins is outside [1, %d]"
                            % (B, MAX_BINS))
    row = (_SMEM_BUDGET - _STATIC_SMEM - 8) // (3 * 8)   # bins a slot row
    tiles = -(-B // row)
    bt = -(-B // tiles)
    ks_max = (_SMEM_BUDGET - _STATIC_SMEM) // (bt * 3 * 8 + 8)
    slices = -(-K // ks_max)
    ks = -(-K // slices)
    smem = _smem_bytes(bt, ks)
    threads = (_THREADS_WIDE if _SMEM_PER_SM // (smem + 1024) <= 2
               else _THREADS)
    return ks, threads, smem, tiles


def _check(store, leaf_id, w3, child_id, num_bins, num_cols):
    nc, e = store.ent_bin.shape if store.ent_bin.dim() == 2 else (0, 0)
    n = leaf_id.shape[0] if leaf_id.dim() == 1 else 0
    dev = leaf_id.device
    want = [(store.ent_row, torch.int32, (nc, e), "ent_row"),
            (store.ent_bin, torch.int32, (nc, e), "ent_bin"),
            (store.chunk_col, torch.int32, (nc, 1), "chunk_col"),
            (store.col_cptr, torch.int32, (num_cols + 1,), "col_cptr"),
            (store.fill, torch.int32, (num_cols,), "fill"),
            (leaf_id, torch.int32, (n,), "leaf_id"),
            (w3, torch.float32, (n, 3), "w3"),
            (child_id, torch.int32, (child_id.shape[0],), "child_id")]
    for t, dtype, shape, name in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise LightGBMError("%s: expected %s %s, got %s %s"
                                % (name, dtype, shape, t.dtype,
                                   tuple(t.shape)))
        if t.device != dev:
            raise LightGBMError("%s is on %s, leaf_id on %s"
                                % (name, t.device, dev))
    if nc < 1 or e < 1 or n < 1 or num_cols < 1 or child_id.shape[0] < 1:
        raise LightGBMError("empty sparse histogram input")
    if int(num_bins) < 1:
        raise LightGBMError("num_bins must be positive, got %d" % num_bins)
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("unsupported device %s" % dev)
    if dev.type == "cuda":
        for t, _, _, name in want:
            if not t.is_contiguous():
                raise LightGBMError("%s must be contiguous" % name)
        check_rows(n)


def _launch(store, leaf_id, w3, child_id, num_bins, num_cols, exps, plan,
            hilo=True):
    """B6 on plan (launch_plan's KS, threads and tiles): the (K, F, B, 3)
    histograms; hilo=False rounds the weights to bf16 first."""
    dev = leaf_id.device
    K, B = child_id.shape[0], int(num_bins)
    hist = torch.empty((K, num_cols, B, 3), dtype=torch.float32, device=dev)
    err = _build.library().lgbt_sparse_hist(
        *[t.data_ptr() for t in (store.ent_row, store.ent_bin,
                                 store.col_cptr, leaf_id, w3, child_id, exps,
                                 hist)],
        num_cols, leaf_id.shape[0], B, K, store.ent_bin.shape[1], *plan,
        int(not hilo), _build.stream(dev))
    _build.check(err, "sparse_hist")
    return hist


def sparse_wave_histogram(store: ChunkedSparseStore, leaf_id, w3, child_id,
                          num_bins: int, num_cols: int, exps=None,
                          hilo: bool = True):
    """Kernel B6: the (K, F, B, 3) f32 histograms of the rows whose leaf
    is child_id[k] (-1 = inactive, all zero), from the store's non-fill
    entries only; fill slots stay exactly 0.  exps: the kernel's
    fixed-point exponents (fixed_point_exponents(w3)), computed here when
    None; the plain version does not use them.  hilo=False: the single
    bf16 product (tpu_hist_precision=bf16), each entry's weights rounded
    as the JAX package's _round_bf16 rounds them, in the kernel; the
    exponents stay those of the unrounded weights (csrc/wave_fused.cu
    says why they still bound every sum)."""
    _check(store, leaf_id, w3, child_id, num_bins, num_cols)
    if leaf_id.device.type == "cpu":
        return chunked_child_hists_plain(store, leaf_id, w3, child_id,
                                         num_bins, num_cols, hilo)
    ks, threads, _, tiles = launch_plan(int(num_bins), child_id.shape[0])
    plan = (ks, threads, tiles)
    hist = _launch(store, leaf_id, w3, child_id, num_bins, num_cols,
                   _exps(w3, exps), plan, hilo)
    sparse_wave_histogram.launches += 1
    if not hilo:
        sparse_wave_histogram.form_launches["bf16"] += 1
    return hist


sparse_wave_histogram.launches = 0
# of them the bf16 form's (the sparse store never packs)
sparse_wave_histogram.form_launches = {"bf16": 0}
