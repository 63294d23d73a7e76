"""Device-side tree application: traversal on binned data and the
partition-side score update (kernel B2, ``csrc/score_update.cu``).

Ported from the JAX package's ``ops/predict.py``.  Decision semantics
match dense_bin.hpp:190-222 (default-bin redirect, numerical <=,
categorical ==).  The validation-set traversal is plain torch: in the JAX
package it is an XLA program, not a kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import _build
from ..utils.common import kMaxTreeOutput
from ..utils.log import LightGBMError
from .partition import clipped_leaf_values


@dataclass
class TraversalArrays:
    """What traversing a tree on binned data needs.  ``num_leaves`` and
    ``depth`` (the deepest leaf's depth) are host ints: they size the
    descent, so it runs a fixed number of steps with no host reads."""
    num_leaves: int
    depth: int
    split_feature: torch.Tensor       # (L-1,) i32 (inner index)
    threshold_bin: torch.Tensor       # (L-1,) i32
    default_bin_for_zero: torch.Tensor  # (L-1,) i32
    default_bin: torch.Tensor         # (L-1,) i32
    is_cat: torch.Tensor              # (L-1,) i32
    left_child: torch.Tensor          # (L-1,) i32
    right_child: torch.Tensor         # (L-1,) i32
    leaf_value: torch.Tensor          # (L,) f32


def traversal_from_grow(tree_arrays, num_leaves: int,
                        depth: int) -> TraversalArrays:
    """View ops.grow.TreeArrays as TraversalArrays (shared buffers)."""
    return TraversalArrays(
        num_leaves=int(num_leaves), depth=int(depth),
        split_feature=tree_arrays.split_feature,
        threshold_bin=tree_arrays.threshold_bin,
        default_bin_for_zero=tree_arrays.default_bin_for_zero,
        default_bin=tree_arrays.default_bin,
        is_cat=tree_arrays.is_cat,
        left_child=tree_arrays.left_child,
        right_child=tree_arrays.right_child,
        leaf_value=tree_arrays.leaf_value,
    )


def traversal_from_host_tree(tree, device) -> TraversalArrays:
    """Upload a models.Tree (with bin thresholds) for traversal on
    ``device``; its leaf values rounded to f32."""
    ni = max(tree.num_leaves - 1, 1)
    nl = max(tree.num_leaves, 2)

    def i32(a):
        return torch.as_tensor(a[:ni].astype("int32"), device=device)

    return TraversalArrays(
        num_leaves=int(tree.num_leaves),
        depth=int(tree.leaf_depth[:tree.num_leaves].max()),
        split_feature=i32(tree.split_feature_inner),
        threshold_bin=i32(tree.threshold_in_bin),
        default_bin_for_zero=i32(tree.default_bin_for_zero),
        default_bin=i32(tree.zero_bin),
        is_cat=i32(tree.decision_type),
        left_child=i32(tree.left_child),
        right_child=i32(tree.right_child),
        leaf_value=torch.as_tensor(tree.leaf_value[:nl], dtype=torch.float32,
                                   device=device),
    )


def leaf_index_binned(tree: TraversalArrays, X, layout=None):
    """Per-row leaf index by iterative descent (Tree::GetLeaf on bins);
    zeros for single-leaf trees.  X: (N, G) binned rows; layout: the
    ops.grow.BundleArrays when X holds EFB group columns."""
    n = X.shape[0]
    dev = X.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    sf = tree.split_feature.long()
    for _ in range(tree.depth):
        nd = node.clamp(min=0)
        f = sf[nd]
        if layout is None:
            b = X[rows, f].to(torch.int32)
        else:
            v = X[rows, layout.group_of.long()[f]].to(torch.int32)
            off = layout.bin_off[f]
            inb = (v >= off) & (v < off + layout.bin_span[f])
            b = torch.where(inb, v - off + layout.bin_adj[f],
                            tree.default_bin[nd])
        thr = tree.threshold_bin[nd]
        cat = tree.is_cat[nd] > 0
        dbz = tree.default_bin_for_zero[nd]
        dflt = tree.default_bin[nd]
        go_left = torch.where(cat, b == thr, b <= thr)
        def_left = torch.where(cat, dbz == thr, dbz <= thr)
        go_left = torch.where(b == dflt, def_left, go_left)
        nxt = torch.where(go_left, tree.left_child[nd],
                          tree.right_child[nd]).long()
        node = torch.where(node >= 0, nxt, node)
    return (~node).to(torch.int32)


def add_tree_to_score(score, X, tree: TraversalArrays, scale, layout=None,
                      out=None):
    """score + clip(scale * leaf_value)[leaf(X)] —
    Tree::AddPredictionToScore with the Shrinkage clamp — written to out
    (a new tensor when None; out may be score itself, updated in
    place)."""
    if tree.num_leaves <= 1:
        return score if out is None else out.copy_(score)
    leaf = leaf_index_binned(tree, X, layout)
    add = clipped_leaf_values(tree.leaf_value, scale)[leaf.long()].to(
        score.dtype)
    return torch.add(score, add, out=out) if out is not None else score + add


# ----------------------------------------------------- score update (B2)
def score_update_plain(score, leaf_id, vals):
    """score + vals[clamp(leaf_id, 0, L-1)]."""
    idx = torch.clamp(leaf_id.long(), 0, vals.shape[0] - 1)
    return score + vals[idx]


def _score_update_fault(score, leaf_id, leaf_value, out):
    """What score_update refuses, or None.  The common case costs one
    boolean expression: at the main path's sizes the wrapper's host work,
    not the kernel, sets the rate of back-to-back launches."""
    n, d = score.numel(), score.get_device()
    if (score.dtype is torch.float32 and score.dim() == 1
            and leaf_id.dtype is torch.int32 and leaf_id.dim() == 1
            and leaf_id.numel() == n and leaf_value.dtype is torch.float32
            and leaf_value.dim() == 1 and leaf_value.numel() >= 1
            and leaf_id.get_device() == d and leaf_value.get_device() == d
            and (out is None or (out.dtype is torch.float32
                                 and out.dim() == 1 and out.numel() == n
                                 and out.get_device() == d))):
        return None
    dev = score.device
    for t, dtype, name in ((score, torch.float32, "score"),
                           (leaf_id, torch.int32, "leaf_id"),
                           (leaf_value, torch.float32, "leaf_value"),
                           (out, torch.float32, "out")):
        if t is None:
            continue
        if t.dtype != dtype or t.dim() != 1:
            return "%s: expected %s of 1 dimension, got %s %s" % (
                name, dtype, t.dtype, tuple(t.shape))
        if t.device != dev:
            return "%s is on %s, score on %s" % (name, t.device, dev)
    if leaf_value.shape[0] < 1:
        return "score_update needs at least one leaf value"
    return "leaf_id and out must have score's shape %s" % (
        tuple(score.shape),)


def score_update(score, leaf_id, leaf_value, scale=1.0, out=None):
    """Partition-side score update (kernel B2): score (N,) f32 plus
    clip(scale * leaf_value, +-kMaxTreeOutput) (L,) f32 gathered at the
    clamped leaf ids (N,) int32, written to out (a new tensor when None;
    out may be score itself, updated in place).  The scale is rounded to
    f32 (by ctypes' float argument on the card).  Bit-equal to
    score_update_plain on clipped_leaf_values."""
    fault = _score_update_fault(score, leaf_id, leaf_value, out)
    if fault is not None:
        raise LightGBMError(fault)
    scale = float(scale)        # rounded to f32 by both paths
    if not score.is_cuda:
        if score.device.type != "cpu":
            raise LightGBMError("unsupported device %s" % score.device)
        new = score_update_plain(score, leaf_id,
                                 clipped_leaf_values(leaf_value, scale))
        return new if out is None else out.copy_(new)
    if out is None:
        out = torch.empty_like(score)
    if not (score.is_contiguous() and leaf_id.is_contiguous()
            and leaf_value.is_contiguous() and out.is_contiguous()):
        raise LightGBMError("score_update takes contiguous tensors")
    err = _build.library().lgbt_score_update(
        score.data_ptr(), leaf_id.data_ptr(), leaf_value.data_ptr(),
        out.data_ptr(), score.shape[0], leaf_value.shape[0], scale,
        kMaxTreeOutput, _build.stream(score.device))
    _build.check(err, "score_update")
    score_update.launches += 1
    return out


score_update.launches = 0


def update_score_from_partition(score, leaf_id, leaf_value, scale,
                                out=None):
    """Train-side update via the final partition (score_updater.hpp:91-99):
    score += clip(scale * leaf_value)[leaf_id], through kernel B2."""
    return score_update(score, leaf_id, leaf_value, scale, out)
