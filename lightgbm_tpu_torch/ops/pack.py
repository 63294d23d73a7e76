"""4-bit bin packing: two bin columns a byte on the device.

Ported from the JAX package's ``ops/pack.py`` (the reference's
``dense_nbits_bin.hpp`` analog).  Where every device column has at most
16 bins (``max_bin <= 15`` plus the reserved zero/missing bin) the bin
matrix is stored packed, which halves its device bytes and the bin bytes
the wave kernels read; kernels B1, B3 and B4 unpack in their loads
(``csrc/wave_fused.cu``), the plain versions with ``unpack4``.

The layout is SPLIT-HALF, not interleaved: packed column ``j`` holds
logical column ``j`` in its low nibble and logical column ``j + Fh`` in
its high nibble, ``Fh = ceil(F / 2)``.  With odd ``F`` the last high
nibble is zero padding, which no unpacking reads as a feature.
"""
from __future__ import annotations

import numpy as np
import torch


def can_pack4(num_bins_per_col) -> bool:
    """True when every device column's bin count fits a nibble."""
    arr = np.asarray(num_bins_per_col)
    return arr.size > 0 and int(arr.max()) <= 16


def packed_width(logical_cols: int) -> int:
    """Stored columns of logical_cols packed columns: ceil(F / 2)."""
    return (int(logical_cols) + 1) // 2


def pack4_host(binned: np.ndarray) -> np.ndarray:
    """(N, F) uint8 bins (< 16) -> (N, ceil(F/2)) packed uint8."""
    n, f = binned.shape
    fh = packed_width(f)
    lo = binned[:, :fh].astype(np.uint8)
    hi = np.zeros((n, fh), dtype=np.uint8)
    hi[:, : f - fh] = binned[:, fh:]
    return (lo | (hi << 4)).astype(np.uint8)


def unpack4(xc, logical_cols: int):
    """Packed (..., Fh) uint8 -> (..., logical_cols) uint8 bins, along the
    last dimension (row-major bins)."""
    return torch.cat([xc & 15, xc >> 4], dim=-1)[..., :logical_cols]


def unpack4_t(xt, logical_cols: int):
    """Packed transposed (Fh, N) uint8 -> (logical_cols, N) uint8 bins."""
    return torch.cat([xt & 15, xt >> 4], dim=0)[:logical_cols]


def packed_column(f, logical_cols: int):
    """(p, high) for logical column ids f (a tensor): the stored column
    that holds each, and whether in its high nibble.  Column f < Fh is
    the low nibble of stored column f, f >= Fh the high nibble of stored
    column f - Fh (the JAX package's ops/predict.py leaf_index_binned)."""
    fh = packed_width(logical_cols)
    high = f >= fh
    return torch.where(high, f - fh, f), high


def nibble(raw, high):
    """The bins in raw (int32 packed bytes): high nibbles where high, low
    ones elsewhere."""
    return torch.where(high, raw >> 4, raw & 15)
