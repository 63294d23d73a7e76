"""Per-leaf weights and sums — the LeafSplits side of a leaf histogram.

Ported from the JAX package's ``ops/histogram.py`` (``_weights`` and
``leaf_sums``).  Rows outside the target leaf contribute zero through the
mask, which also carries the bagging row multipliers; the product order
is the JAX package's, g * (mask * row_mult), so the port's weights equal
its weights bit for bit.
"""
from __future__ import annotations

import torch


def _weights(grad, hess, leaf_id, leaf, row_mult):
    """(N, 3) [g, h, 1] masked to the target leaf and row multipliers.
    ``leaf`` is an int or a one-element integer tensor."""
    mask = (leaf_id == leaf).to(grad.dtype)
    if row_mult is not None:
        mask = mask * row_mult
    return torch.stack([grad * mask, hess * mask, mask], dim=-1)


def weight_rows(grad, hess, row_mult):
    """(N, 3) [g * m, h * m, m], m = row_mult (ones when None): the weight
    rows the histogram kernels sum, made once a tree by the growers (one
    product order for every grower, so their kernels see the same
    bits)."""
    if row_mult is None:
        row_mult = torch.ones_like(grad)
    return torch.stack([grad * row_mult, hess * row_mult, row_mult],
                       dim=-1).contiguous()


def leaf_sums(grad, hess, leaf_id, leaf, row_mult):
    """Leaf total (sum_g, sum_h, count) — LeafSplits::Init
    (leaf_splits.hpp)."""
    return _weights(grad, hess, leaf_id, leaf, row_mult).sum(dim=0)
