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


def leaf_sums(grad, hess, leaf_id, leaf, row_mult):
    """Leaf total (sum_g, sum_h, count) — LeafSplits::Init
    (leaf_splits.hpp)."""
    return _weights(grad, hess, leaf_id, leaf, row_mult).sum(dim=0)
