"""Wave kernels: the fused partition + child histograms of one wave (B1),
the histogram-only pass on the transposed bins (B3) and on the row-major
bins (B4), each beside its plain torch version.

Ported from the JAX package's ``ops/pallas_wave.py``
(``wave_partition_hist_pallas_ct``, ``wave_histogram_pallas_t`` and
``wave_histogram_pallas``); the CUDA sources are ``csrc/wave_fused.cu``
(B1) and ``csrc/wave_hist.cu`` (B3, B4).
The contract and layouts are the JAX package's: X_t (F, N) or X (N, F)
uint8, leaf_id (N,) int32, w3 (N, 3) f32, child_id (K,) int32 (-1 =
inactive), cols (W, 10) f32, psrc (W,) int32 (-3 = inactive); histograms
come back as (K, F, B, 3) f32.  The JAX package's B4 splits the weights
into bf16 hi/lo halves for the TPU's matrix unit; the port multiplies and
adds in f32 for B3 and B4, and B1 sums in 64-bit fixed point
(``fixed_point_exponents``) and converts to f32 once.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building it on first use) or raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils.log import LightGBMError

# rows staged per tile in the kernel (kTile in csrc/wave_hist.cu)
_TILE = 256
# B1 (csrc/wave_fused.cu): rows a routing block takes a tile, routing
# blocks a SM, threads of a histogram block and features it may hold
_ROUTE_TILE = 1024
_ROUTE_BLOCKS_PER_SM = 8
_FUSED_THREADS = 1024
_FUSED_GROUP_MAX = 8
# dynamic shared memory a block may claim (of the 232,448 bytes an H100
# block can use) and what one SM holds for all its resident blocks
_SMEM_BUDGET = 220 * 1024
_SMEM_PER_SM = 228 * 1024
# the partials scratch is capped at 1/_PARTIAL_FRACTION of the bytes of X_t
_PARTIAL_FRACTION = 2

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


def route_rows_plain(X_t, leaf_id, cols, psrc, bundled: bool = False):
    """New leaf ids after one wave's splits (ops/wave.py route_rows): each
    row whose leaf is psrc[w] takes the split in cols[w]."""
    F, N = X_t.shape
    r, cj, in_range = _split_rows(leaf_id, cols, psrc, F)
    colv = X_t[cj, torch.arange(N, device=X_t.device)].to(
        torch.int32) * in_range.to(torch.int32)
    return route_rows(r, colv, leaf_id, bundled)


def route_rows_rowmajor(X, leaf_id, cols, psrc, bundled: bool = False):
    """route_rows_plain on the row-major bins X (N, F): each row's bin is
    read from its split column X[row, j]."""
    N, F = X.shape
    r, cj, in_range = _split_rows(leaf_id, cols, psrc, F)
    colv = X[torch.arange(N, device=X.device), cj].to(
        torch.int32) * in_range.to(torch.int32)
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
    x = X_t.long()
    in_bins = (x < B).to(w.dtype)                              # (F, N)
    idx = (torch.arange(F, device=X_t.device)[:, None] * B
           + x.clamp(max=B - 1)).reshape(-1)
    out = torch.zeros(F * B, 3, dtype=w.dtype, device=X_t.device)
    out.index_add_(0, idx, (w[None, :, :] * in_bins[:, :, None])
                   .reshape(-1, 3))
    return out.reshape(F, B, 3)


def wave_histogram_plain(X_t, leaf_id, w3, child_id, num_bins: int):
    """(K, F, B, 3): hist[k, f, b] sums w3 over the rows with
    leaf_id == child_id[k] and X_t[f, row] == b, in w3's dtype."""
    return torch.stack([
        histogram_plain(X_t, w3 * (leaf_id == child_id[k]).to(w3.dtype)[
            :, None], num_bins) for k in range(child_id.shape[0])])


def wave_histogram_rowmajor_plain(X, leaf_id, w3, child_id, num_bins: int):
    """wave_histogram_plain on the row-major bins X (N, F)."""
    return wave_histogram_plain(X.t(), leaf_id, w3, child_id, num_bins)


def wave_partition_hist_plain(X_t, leaf_id, w3, child_id, cols, psrc,
                              num_bins: int, bundled: bool = False):
    """Plain version of the fused wave step: (new_leaf_id, hist)."""
    new_lid = route_rows_plain(X_t, leaf_id, cols, psrc, bundled)
    return new_lid, wave_histogram_plain(X_t, new_lid, w3, child_id,
                                         num_bins)


# ----------------------------------------------------------------- kernel
def _check(X_t, leaf_id, w3, child_id, num_bins, cols=None, psrc=None,
           rowmajor: bool = False):
    dev = X_t.device
    F, N = (X_t.shape if X_t.dim() == 2 else (None, None))
    if rowmajor and F is not None:
        N, F = F, N
    want = [(X_t, torch.uint8, (N, F) if rowmajor else (F, N),
             "X" if rowmajor else "X_t"),
            (leaf_id, torch.int32, (N,), "leaf_id"),
            (child_id, torch.int32, (child_id.shape[0],), "child_id")]
    if w3 is not None:
        want.append((w3, torch.float32, (N, 3), "w3"))
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
    if not 1 <= int(num_bins) <= 256:
        raise LightGBMError("num_bins must be in [1, 256], got %d"
                            % num_bins)
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
        if F * N >= 2 ** 31:
            raise LightGBMError("X_t too large for the kernel's int32 row "
                                "index (F*N=%d)" % (F * N))


def _smem_bytes(B: int, K: int, ks: int, warps: int,
                rowmajor: bool = False) -> int:
    """smem_bytes in csrc/wave_hist.cu: one block's dynamic shared memory
    (the row-major variant adds its tile of bin bytes)."""
    return (4 * (warps * ks * B * 3 + warps * 96 + _TILE * 5 + K + 1)
            + (4 * ((_TILE * warps + 3) // 4) if rowmajor else 0))


def launch_plan(F: int, N: int, B: int, K: int, num_sms: int,
                rowmajor: bool = False):
    """B3's and B4's plan (R, rows_per_block, KS, warps): row blocks, rows
    each, child slots per block and warps (= features) per block.  Each
    warp keeps a private (KS, B, 3) histogram in shared memory; R row
    blocks write R partial (K, F, B, 3) blocks, capped at
    1/_PARTIAL_FRACTION of the bytes of X_t.  R aims at one full round of
    resident blocks on every SM."""
    def smem_of(ks, warps):
        return _smem_bytes(B, K, ks, warps, rowmajor)

    ks = K
    warps = min(8, max(F, 1))
    while warps > 1 and smem_of(ks, warps) > _SMEM_BUDGET:
        warps -= 1
    while ks > 1 and smem_of(ks, warps) > _SMEM_BUDGET:
        ks = (ks + 1) // 2
    smem = smem_of(ks, warps)
    if smem > _SMEM_BUDGET:
        raise LightGBMError("wave histogram block does not fit shared "
                            "memory (B=%d, K=%d)" % (B, K))
    fgroups = -(-F // warps)
    kslices = -(-K // ks)
    per_sm = max(1, min(_SMEM_PER_SM // (smem + 1024), 2048 // (32 * warps)))
    partial_bytes = K * F * B * 12
    r_cap = max(1, (F * N) // (_PARTIAL_FRACTION * partial_bytes))
    r_fill = max(1, (num_sms * per_sm) // (fgroups * kslices))
    r_rows = max(1, -(-N // _TILE))
    R = max(1, min(r_cap, r_fill, r_rows, 65535))
    rows_per_block = -(-N // R)
    R = -(-N // rows_per_block)
    return R, rows_per_block, ks, warps


def _sms(dev) -> int:
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _num_sms:
        _num_sms[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _num_sms[key]


def _launch(X_t, leaf_id, w3, child_id, num_bins, rowmajor=False):
    """B3 (X_t) or B4 (row-major X): the histogram-only pass."""
    lib = _build.library()
    F, N = X_t.shape[::-1] if rowmajor else X_t.shape
    K = child_id.shape[0]
    B = int(num_bins)
    R, rpb, ks, warps = launch_plan(F, N, B, K, _sms(X_t.device), rowmajor)
    partial = torch.empty(R * K * F * B * 3, dtype=torch.float32,
                          device=X_t.device)
    hist = torch.empty((K, F, B, 3), dtype=torch.float32,
                       device=X_t.device)
    stream = torch.cuda.current_stream(X_t.device).cuda_stream
    err = lib.lgbt_wave_hist(
        *[t.data_ptr() for t in (X_t, leaf_id, w3, child_id)],
        partial.data_ptr(), hist.data_ptr(), F, N, B, K, R, rpb, ks, warps,
        int(rowmajor), stream)
    _build.check(err, "wave_hist")
    return hist


# ------------------------------------------------------------ B1 (fused)
def fixed_point_exponents(w3):
    """(3,) int32 exponents e_c of B1's 64-bit fixed point, computed on
    w3's device with no host read: e_c = 62 - frexp_exponent(N * max|w_c|),
    so |sum| < 2^62 for any N values of channel c, and rounding each
    value to a multiple of 2^-e_c errs by at most N_cell * N * max|w_c| /
    2^62 in a cell of N_cell rows.  w3 is fixed within a tree, so the
    grower computes this once a tree."""
    n = w3.shape[0]
    m = w3.abs().amax(dim=0).to(torch.float64) * n
    return (62 - torch.frexp(m).exponent).to(torch.int32)


def fused_plan(F: int, N: int, B: int, K: int, num_sms: int):
    """B1's launch plan (route_blocks, groups, R, KS, FS, smem): routing
    blocks of _ROUTE_TILE rows a tile; histogram blocks of
    _FUSED_THREADS threads, each over FS features (groups of them) and KS
    child slots in an int64 (KS, FS, B, 3) shared histogram of smem
    bytes, and R shares of the compact row list, so that one round of
    resident blocks fills every SM."""
    cell = B * 3 * 8                       # one (slot, feature) row
    ks = max(1, min(K, _SMEM_BUDGET // cell))
    fs = max(1, min(F, _FUSED_GROUP_MAX, _SMEM_BUDGET // (ks * cell)))
    groups = -(-F // fs)
    fs = -(-F // groups)                   # even the groups out
    kslices = -(-K // ks)
    smem = ks * fs * cell
    per_sm = max(1, min(2048 // _FUSED_THREADS,
                        _SMEM_PER_SM // (smem + 1024)))
    R = max(1, min(65535, (num_sms * per_sm) // (groups * kslices)))
    route_blocks = max(1, min(-(-N // _ROUTE_TILE),
                              num_sms * _ROUTE_BLOCKS_PER_SM))
    return route_blocks, groups, R, ks, fs, smem


def _launch_fused(X_t, leaf_id, w3, child_id, cols, psrc, num_bins,
                  bundled, exps):
    lib = _build.library()
    F, N = X_t.shape
    K, W, B = child_id.shape[0], cols.shape[0], int(num_bins)
    if max(K, W) >= 2 ** 15:
        raise LightGBMError("B1 takes fewer than 32768 child slots and "
                            "parents (K=%d, W=%d)" % (K, W))
    if exps is None:
        exps = fixed_point_exponents(w3)
    elif (exps.dtype != torch.int32 or tuple(exps.shape) != (3,)
          or exps.device != X_t.device):
        raise LightGBMError("exps: expected int32 (3,) on %s" % X_t.device)
    route_blocks, groups, R, ks, fs, _ = fused_plan(F, N, B, K,
                                                    _sms(X_t.device))
    dev = X_t.device
    new_lid = torch.empty(N, dtype=torch.int32, device=dev)
    rows = torch.empty((N, 2), dtype=torch.int32, device=dev)
    acc = torch.zeros(K * F * B * 3 + 1, dtype=torch.int64, device=dev)
    hist = torch.empty((K, F, B, 3), dtype=torch.float32, device=dev)
    err = lib.lgbt_wave_fused(
        *[t.data_ptr() for t in (X_t, leaf_id, w3, child_id, cols, psrc,
                                 exps, new_lid, rows, acc, hist)],
        F, N, B, K, W, route_blocks, groups, R, ks, fs, int(bundled),
        _build.stream(dev))
    _build.check(err, "wave_fused")
    return new_lid, hist


def route_list_plain(X_t, leaf_id, child_id, cols, psrc,
                     bundled: bool = False):
    """(new_leaf_id, rows, slots): the routed ids, and in row order the
    rows whose new id is a child id with the first slot holding it."""
    new_lid = route_rows_plain(X_t, leaf_id, cols, psrc, bundled)
    match = new_lid[None, :] == child_id[:, None]              # (K, N)
    slot = torch.where(match.any(dim=0),
                       torch.argmax(match.to(torch.int32), dim=0),
                       torch.full_like(new_lid, -1, dtype=torch.long))
    rows = torch.nonzero(slot >= 0).reshape(-1)
    return new_lid, rows.to(torch.int32), slot[rows].to(torch.int32)


def route_list(X_t, leaf_id, child_id, cols, psrc, bundled: bool = False):
    """B1's routing pass alone, for checking it: route_list_plain's
    contract, with the kernel's list sorted by row.  Reads the list's
    length back to the host."""
    _check(X_t, leaf_id, None, child_id, 1, cols, psrc)
    if X_t.device.type == "cpu":
        return route_list_plain(X_t, leaf_id, child_id, cols, psrc, bundled)
    F, N = X_t.shape
    dev = X_t.device
    new_lid = torch.empty(N, dtype=torch.int32, device=dev)
    rows = torch.empty((N, 2), dtype=torch.int32, device=dev)
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    route_blocks = fused_plan(F, N, 1, child_id.shape[0], _sms(dev))[0]
    err = _build.library().lgbt_wave_route(
        *[t.data_ptr() for t in (X_t, leaf_id, child_id, cols, psrc,
                                 new_lid, rows, count)],
        F, N, child_id.shape[0], cols.shape[0], route_blocks, int(bundled),
        _build.stream(dev))
    _build.check(err, "wave_route")
    rows = rows[:int(count)]
    order = torch.argsort(rows[:, 0])
    return new_lid, rows[order, 0], rows[order, 1]


def wave_partition_hist(X_t, leaf_id, w3, child_id, cols, psrc,
                        num_bins: int, bundled: bool = False, exps=None):
    """Fused wave step (kernel B1): route the rows of the wave's parents
    and build the (K, F, B, 3) histograms of the children child_id from
    the new ids.  Returns (new_leaf_id, hist).  exps: the kernel's
    fixed-point exponents (fixed_point_exponents(w3)), computed here when
    None; the plain version does not use them."""
    _check(X_t, leaf_id, w3, child_id, num_bins, cols, psrc)
    if X_t.device.type == "cpu":
        return wave_partition_hist_plain(X_t, leaf_id, w3, child_id, cols,
                                         psrc, num_bins, bundled)
    out = _launch_fused(X_t, leaf_id, w3, child_id, cols, psrc, num_bins,
                        bundled, exps)
    wave_partition_hist.launches += 1
    return out


def wave_histogram(X_t, leaf_id, w3, child_id, num_bins: int):
    """Histogram-only wave pass (kernel B3): (K, F, B, 3) histograms of
    the rows whose leaf is child_id[k]."""
    _check(X_t, leaf_id, w3, child_id, num_bins)
    if X_t.device.type == "cpu":
        return wave_histogram_plain(X_t, leaf_id, w3, child_id, num_bins)
    out = _launch(X_t, leaf_id, w3, child_id, num_bins)
    wave_histogram.launches += 1
    return out


def wave_histogram_rowmajor(X, leaf_id, w3, child_id, num_bins: int):
    """Histogram-only wave pass on the row-major bins X (N, F) (kernel
    B4): the contract of wave_histogram."""
    _check(X, leaf_id, w3, child_id, num_bins, rowmajor=True)
    if X.device.type == "cpu":
        return wave_histogram_rowmajor_plain(X, leaf_id, w3, child_id,
                                             num_bins)
    out = _launch(X, leaf_id, w3, child_id, num_bins, rowmajor=True)
    wave_histogram_rowmajor.launches += 1
    return out


wave_partition_hist.launches = 0
wave_histogram.launches = 0
wave_histogram_rowmajor.launches = 0
