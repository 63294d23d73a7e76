"""Leaf histogram of the exact grower (kernel B5), beside its plain torch
version.

Ported from the JAX package's ``ops/pallas_hist.py``
(``leaf_histogram_pallas``); the CUDA source is ``csrc/leaf_hist.cu``.
The contract is the JAX package's: X (N, F) uint8 row-major bins, grad
and hess (N,) f32, leaf_id (N,) int32, the target leaf, row_mult (N,) f32
or None; the (F, B, 3) f32 histogram sums [g * m, h * m, m] with
m = (leaf_id == leaf) * row_mult.  The JAX package falls back to its XLA
one-hot path where the TPU's VMEM cannot hold a bin width
(``supports_bins``); the port's bins are uint8 (B <= 256) and wide shapes
take more feature groups, so there is no fallback.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building it on first use) or raises.  The wrapper
counts its kernel launches in ``leaf_histogram.launches``.
"""
from __future__ import annotations

import torch

from .. import _build
from ..utils.log import LightGBMError
from .histogram import _weights
from .wave_kernels import _sms, histogram_plain

# rows a tile (= threads a block, kTile in csrc/leaf_hist.cu) and warps
_TILE = 256
_WARPS = _TILE // 32
# dynamic shared memory a block may claim, and what one SM holds
_SMEM_BUDGET = 220 * 1024
_SMEM_PER_SM = 228 * 1024
# the partials scratch is capped at 1/_PARTIAL_FRACTION of the bytes of X
_PARTIAL_FRACTION = 2
# resident blocks a SM the row blocks aim at
_BLOCKS_PER_SM = 2


def leaf_histogram_plain(X, grad, hess, leaf_id, leaf, row_mult,
                         num_bins: int):
    """(F, B, 3): hist[f, b] sums the leaf's masked weights over the rows
    with X[row, f] == b, in grad's dtype."""
    return histogram_plain(X.t(), _weights(grad, hess, leaf_id, leaf,
                                           row_mult), num_bins)


def _leaf_tensor(leaf, dev):
    """The target leaf as a (1,) int32 tensor on dev, built on the device
    (a fill, never a host-to-device copy that would wait for the stream)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.numel() != 1 or leaf.dtype not in (torch.int32, torch.int64):
            raise LightGBMError("leaf: expected one integer, got %s %s"
                                % (leaf.dtype, tuple(leaf.shape)))
        if leaf.device != dev:
            raise LightGBMError("leaf is on %s, X on %s"
                                % (leaf.device, dev))
        return leaf.reshape(1).to(torch.int32)
    return torch.full((1,), int(leaf), dtype=torch.int32, device=dev)


def _check(X, grad, hess, leaf_id, row_mult, num_bins):
    dev = X.device
    N, F = X.shape if X.dim() == 2 else (None, None)
    want = [(X, torch.uint8, (N, F), "X"),
            (grad, torch.float32, (N,), "grad"),
            (hess, torch.float32, (N,), "hess"),
            (leaf_id, torch.int32, (N,), "leaf_id")]
    if row_mult is not None:
        want.append((row_mult, torch.float32, (N,), "row_mult"))
    for t, dtype, shape, name in want:
        if N is None or t.dtype != dtype or tuple(t.shape) != shape:
            raise LightGBMError("%s: expected %s %s, got %s %s"
                                % (name, dtype, shape, t.dtype,
                                   tuple(t.shape)))
        if t.device != dev:
            raise LightGBMError("%s is on %s, X on %s"
                                % (name, t.device, dev))
    if not 1 <= int(num_bins) <= 256:
        raise LightGBMError("num_bins must be in [1, 256], got %d"
                            % num_bins)
    if N < 1 or F < 1:
        raise LightGBMError("empty leaf histogram input")
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("unsupported device %s" % dev)
    if dev.type == "cuda":
        for t, _, _, name in want:
            if not t.is_contiguous():
                raise LightGBMError("%s must be contiguous" % name)
        if F * N >= 2 ** 31:
            raise LightGBMError("X too large for the kernel's int32 row "
                                "index (F*N=%d)" % (F * N))


def _smem_bytes(B: int, Fg: int) -> int:
    """lgbt_leaf_hist_smem in csrc/leaf_hist.cu."""
    return 4 * (Fg * B * 3 + _TILE * 3 + _WARPS + _TILE) + _TILE * Fg


def launch_plan(F: int, N: int, B: int, num_sms: int):
    """(R, rows_per_block, Fg): row blocks, rows each, and features a
    block.  A block holds its group's (Fg, B, 3) histogram and a tile's
    Fg bin bytes in shared memory; the groups are as even as the budget
    allows.  R aims at _BLOCKS_PER_SM blocks on every SM, with the
    partials capped at 1/_PARTIAL_FRACTION of the bytes of X."""
    fixed = _smem_bytes(B, 0)
    fg_max = (_SMEM_BUDGET - fixed) // (12 * B + _TILE)
    if fg_max < 1:
        raise LightGBMError("leaf histogram block does not fit shared "
                            "memory (B=%d)" % B)
    groups = -(-F // fg_max)
    fg = -(-F // groups)
    per_sm = max(1, min(_BLOCKS_PER_SM,
                        _SMEM_PER_SM // (_smem_bytes(B, fg) + 1024)))
    r_fill = max(1, (num_sms * per_sm) // groups)
    r_cap = max(1, (F * N) // (_PARTIAL_FRACTION * F * B * 12))
    r_rows = max(1, -(-N // _TILE))
    R = max(1, min(r_fill, r_cap, r_rows, 2 ** 31 - 1))
    rows_per_block = -(-N // R)
    R = -(-N // rows_per_block)
    return R, rows_per_block, fg


def _launch(X, grad, hess, leaf_id, leaf_t, row_mult, num_bins):
    lib = _build.library()
    N, F = X.shape
    B = int(num_bins)
    R, rpb, fg = launch_plan(F, N, B, _sms(X.device))
    dev = X.device
    partial = torch.empty(R * F * B * 3 if R > 1 else 1,
                          dtype=torch.float32, device=dev)
    hist = torch.empty((F, B, 3), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.lgbt_leaf_hist(
        X.data_ptr(), grad.data_ptr(), hess.data_ptr(),
        row_mult.data_ptr() if row_mult is not None else None,
        leaf_id.data_ptr(), leaf_t.data_ptr(), partial.data_ptr(),
        hist.data_ptr(), F, N, B, R, rpb, fg, stream)
    _build.check(err, "leaf_hist")
    return hist


def leaf_histogram(X, grad, hess, leaf_id, leaf, row_mult, num_bins: int):
    """Leaf histogram (kernel B5): the (F, B, 3) histogram of the rows
    whose leaf id is ``leaf`` (an int or a one-element integer tensor on
    X's device), weighted by row_mult (None for all ones)."""
    _check(X, grad, hess, leaf_id, row_mult, num_bins)
    leaf_t = _leaf_tensor(leaf, X.device)
    if X.device.type == "cpu":
        return leaf_histogram_plain(X, grad, hess, leaf_id, leaf_t,
                                    row_mult, num_bins)
    out = _launch(X, grad, hess, leaf_id, leaf_t, row_mult, num_bins)
    leaf_histogram.launches += 1
    return out


leaf_histogram.launches = 0
