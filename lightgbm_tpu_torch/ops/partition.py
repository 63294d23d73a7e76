"""Leaf-membership score update — the DataPartition side of a tree.

Ported from the JAX package's ``ops/partition.py``.  Each row carries its
leaf id after growth, so the training score update is a gather of the
tree's (shrunk, clamped) leaf outputs (score_updater.hpp:91-99).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.common import kMaxTreeOutput


def clipped_leaf_values(leaf_value, scale):
    """clip(scale * leaf_value, +-kMaxTreeOutput) in the leaf values' dtype
    — the Shrinkage clamp (tree.h:110-118): one multiply, then the clip.
    A Python scale is rounded to the leaf values' dtype first and
    multiplies as a scalar, with no host-to-device copy."""
    if isinstance(scale, torch.Tensor):
        scale = torch.as_tensor(scale, dtype=leaf_value.dtype,
                                device=leaf_value.device)
    elif leaf_value.dtype == torch.float32:
        scale = float(np.float32(scale))
    return torch.clamp(leaf_value * scale, -kMaxTreeOutput, kMaxTreeOutput)


def score_update_impl(score, leaf_id, leaf_value, scale):
    """score + clip(scale * leaf_value)[clamp(leaf_id, 0, L-1)] — the
    gather form of the partition-side update."""
    vals = clipped_leaf_values(leaf_value, scale)
    idx = torch.clamp(leaf_id.long(), 0, leaf_value.shape[0] - 1)
    return score + vals[idx].to(score.dtype)
