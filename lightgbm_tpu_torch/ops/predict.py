"""Device-side tree application: traversal on binned data, the
partition-side score update (kernel B2, ``csrc/score_update.cu``) and
bulk prediction on raw values through the ranked traversal.

Ported from the JAX package's ``ops/predict.py``.  Decision semantics
match dense_bin.hpp:190-222 (default-bin redirect, numerical <=,
categorical ==).  The validation-set traversal and the ranked traversal
are plain torch: in the JAX package they are XLA programs, not kernels.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .. import _build
from ..device import resolve_device
from ..utils.common import kMaxTreeOutput, kMissingValueRange
from ..utils.log import LightGBMError
from .pack import nibble, packed_column
from .partition import clipped_leaf_values, score_update_impl
from .wave_kernels import bins_i32, indexable


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


def traversal_from_host_tree(tree, device,
                             dtype=torch.float32) -> TraversalArrays:
    """Upload a models.Tree (with bin thresholds) for traversal on
    ``device``; its leaf values rounded to dtype (f32, or float64 for
    the scores of tpu_use_dp)."""
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
        leaf_value=torch.as_tensor(tree.leaf_value[:nl], dtype=dtype,
                                   device=device),
    )


def leaf_index_binned(tree: TraversalArrays, X, layout=None,
                      packed_cols: int = 0):
    """Per-row leaf index by iterative descent (Tree::GetLeaf on bins);
    zeros for single-leaf trees.  X: (N, G) binned rows; layout: the
    ops.grow.BundleArrays when X holds EFB group columns; packed_cols > 0:
    X holds the 4-bit packed bins of that many columns (ops/pack.py),
    column j < ceil(G/2) in the low nibble of stored column j and j >=
    ceil(G/2) in the high nibble of stored column j - ceil(G/2) (the JAX
    package's ``packed=True``)."""
    n = X.shape[0]
    dev = X.device
    if tree.num_leaves <= 1:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    rows = torch.arange(n, device=dev)
    node = torch.zeros(n, dtype=torch.long, device=dev)
    sf = tree.split_feature.long()

    Xi = indexable(X)

    def col_bins(f):
        """Each row's bin in its (device) column f."""
        if not packed_cols:
            return bins_i32(Xi[rows, f])
        p, high = packed_column(f, packed_cols)
        return nibble(bins_i32(Xi[rows, p]), high)

    for _ in range(tree.depth):
        nd = node.clamp(min=0)
        f = sf[nd]
        if layout is None:
            b = col_bins(f)
        else:
            v = col_bins(layout.group_of.long()[f])
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
                      out=None, packed_cols: int = 0):
    """score + clip(scale * leaf_value)[leaf(X)] —
    Tree::AddPredictionToScore with the Shrinkage clamp — written to out
    (a new tensor when None; out may be score itself, updated in
    place).  packed_cols as for leaf_index_binned."""
    if tree.num_leaves <= 1:
        return score if out is None else out.copy_(score)
    leaf = leaf_index_binned(tree, X, layout, packed_cols)
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


def update_score_gather(score, leaf_id, leaf_value, scale, out=None):
    """The gather engine of the score update (the JAX package's
    ``_update_score_gather``, an XLA gather, so plain torch is its port):
    score + clip(scale * leaf_value)[clamp(leaf_id, 0, L-1)] in the
    leaf values' dtype, written to out (a new tensor when None).  It
    takes any dtype: tpu_score_update=gather and the float64 scores of
    tpu_use_dp run it; on f32 it equals B2 to the bit."""
    new = score_update_impl(score, leaf_id, leaf_value, scale)
    return new if out is None else out.copy_(new)


def update_score_from_partition(score, leaf_id, leaf_value, scale,
                                out=None, engine: str = "pallas"):
    """Train-side update via the final partition (score_updater.hpp:91-99):
    score += clip(scale * leaf_value)[leaf_id], through kernel B2
    (engine 'pallas', f32 only) or the gather (engine 'gather'); the
    booster resolves the engine (models/gbdt.py), so nothing here falls
    back."""
    if engine == "gather":
        return update_score_gather(score, leaf_id, leaf_value, scale, out)
    return score_update(score, leaf_id, leaf_value, scale, out)


# --------------------------------------------------------------------------
# Bulk prediction on RAW feature values (the Predictor analog for large
# batches), ported from the JAX package's ranked traversal.  The
# reference predicts row by row on the host with f64 threshold compares
# (predictor.hpp:33-96, tree.h:250-276); the device keeps those f64
# decisions exact without f64 compute by RANK ENCODING: per feature,
# every numerical threshold any tree uses, sorted and made unique on the
# host in f64, and each value replaced by its insertion rank (the count
# of thresholds below it).  Then `value <= threshold` is
# `rank(value) <= index(threshold)`, an int32 compare equal to the host's
# decision.  NaN ranks past every threshold (numpy sorts it last) and
# goes right, as C++ `operator<=` sends it.  Categorical nodes compare
# the int-cast value; the zero-range default redirect becomes a per-node
# "default goes left" bit, computed once on the host.  Routing is
# therefore bit-equal to the host predictor.  Leaf values accumulate in
# f32 with Kahan compensation in tree order, four elementwise operations
# a tree, so every row's arithmetic is its own: a row scores the same
# bits in any batch, on the CPU and on the card.
#
# The JAX package descends with `while any(node >= 0)`; here every tree
# of a block descends a fixed number of steps, the block's deepest leaf
# (a host int from Tree.depth), so a traversal reads nothing back and
# can be captured in a CUDA graph.  A row at a leaf (node < 0) keeps it.
# --------------------------------------------------------------------------

_CAT_SENTINEL = -(2 ** 31) + 1
# bytes of traversal state a (row, tree) at the widest step: the
# (rows, trees) node ids, their int64 gather index, the gathered
# (rows, trees, 6) node records, the feature index, the values and the
# masks (ranked_leaves)
STATE_BYTES_PER_TREE = 64


@dataclass
class RankedTrees:
    """The stacked trees of the ranked traversal, on one device.
    ``nodes[t, i]`` packs internal node i of tree t as (feature,
    threshold rank or category, is_cat, default_left, left, right), so
    one gather a level reads a node's record."""
    nodes: torch.Tensor        # (T, M, 6) i32
    leaf_value: torch.Tensor   # (T, L) f32, shrinkage baked in; 0 for stumps
    hits: torch.Tensor         # (T, 1, K) f32: 1 in the tree's class column
    init: torch.Tensor         # (T,) i32: 0, or -1 (at leaf 0) for stumps
    node_base: torch.Tensor    # (T,) i64: t * M
    leaf_base: torch.Tensor    # (T,) i64: t * L
    depth: np.ndarray          # (T,) host: steps to the tree's deepest leaf

    @property
    def num_trees(self) -> int:
        return int(self.depth.shape[0])

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    def to(self, device) -> "RankedTrees":
        """A copy of the stack on ``device`` (a replica: new tensors even
        on the stack's own device)."""
        def put(t):
            return t.to(device, copy=True)
        return RankedTrees(nodes=put(self.nodes),
                           leaf_value=put(self.leaf_value),
                           hits=put(self.hits), init=put(self.init),
                           node_base=put(self.node_base),
                           leaf_base=put(self.leaf_base), depth=self.depth)


class RankedPredictor:
    """Host-prepared state for bulk prediction: the device tree stack
    plus the host-only rank tables (f64) and categorical feature set."""

    def __init__(self, dev: RankedTrees, thresholds: tuple,
                 cat_features: frozenset, max_feature: int):
        self.dev = dev
        self.thresholds = thresholds
        self.cat_features = cat_features
        self.max_feature = max_feature     # host int: no read per predict
        self._replicas = {}                # devices -> one stack an entry

    def replicas(self, devices) -> list:
        """One copy of the tree stack for each entry of ``devices`` (made
        once for that list, and kept): a device's share of the rows
        traverses its own copy, and two entries that name one card get
        a copy each."""
        devs = [resolve_device(d) for d in devices]
        key = tuple(str(d) for d in devs)
        reps = self._replicas.get(key)
        if reps is None:
            reps = self._replicas[key] = [self.dev.to(d) for d in devs]
        return reps


def build_ranked_predictor(models, num_class: int, num_features: int,
                           device="cuda") -> RankedPredictor:
    """Pack host Trees into stacked arrays on ``device`` plus per-feature
    rank tables.  Raises ValueError when a feature is used both
    numerically and categorically, or a categorical threshold leaves
    int32 (callers fall back to the host path).  All per-node work is
    vectorized over Tree.node_arrays views: O(nodes) numpy."""
    dev = resolve_device(device)
    T = len(models)
    M = max([max(t.num_leaves - 1, 1) for t in models] + [1])
    L = max([max(t.num_leaves, 2) for t in models] + [2])
    feat = np.zeros((T, M), np.int32)
    thr_raw = np.zeros((T, M), np.float64)
    is_cat = np.zeros((T, M), np.int32)
    dleft = np.zeros((T, M), np.int32)
    left = np.full((T, M), -1, np.int32)
    right = np.full((T, M), -1, np.int32)
    leaf_value = np.zeros((T, L), np.float64)
    num_leaves = np.zeros(T, np.int32)
    depth = np.zeros(T, np.int64)
    valid = np.zeros((T, M), bool)           # realized internal nodes
    for t, tree in enumerate(models):
        nl = tree.num_leaves
        ni = max(nl - 1, 0)
        num_leaves[t] = nl
        if ni == 0:
            continue                         # a stump adds 0 (tree.predict)
        leaf_value[t, :nl] = tree.leaf_value[:nl]
        depth[t] = tree.depth()
        na = tree.node_arrays()
        valid[t, :ni] = True
        feat[t, :ni] = na.split_feature
        thr_raw[t, :ni] = na.threshold
        cat = na.decision_type == 1
        is_cat[t, :ni] = cat
        left[t, :ni] = na.left_child
        right[t, :ni] = na.right_child
        # the zero-range default decision per node, host-computable once:
        # numerical `dv <= th`; categorical `int64(dv) == int64(th)` —
        # cast only the cat nodes (a numeric default can be 1e300, whose
        # int cast is undefined)
        with np.errstate(invalid="ignore"):
            dl = na.default_value <= na.threshold
        if cat.any():
            th_i = na.threshold[cat].astype(np.int64)
            if np.abs(th_i).max() > 2 ** 31 - 2:
                # the device compares int32; an out-of-domain cat
                # threshold cannot be encoded without breaking the
                # bit-equal routing contract -> host path
                raise ValueError(
                    "categorical threshold %r exceeds int32"
                    % float(na.threshold[cat][
                        int(np.abs(th_i).argmax())]))
            dl = dl.copy()
            dl[cat] = na.default_value[cat].astype(np.int64) == th_i
        dleft[t, :ni] = dl
    cat_features = frozenset(np.unique(feat[valid & (is_cat > 0)]).tolist())
    num_mask = valid & (is_cat == 0)
    num_features_used = frozenset(np.unique(feat[num_mask]).tolist())
    mixed = cat_features & num_features_used
    if mixed:
        raise ValueError("features used both ways: %s" % sorted(mixed))

    # per-feature sorted-unique numerical thresholds, then every numeric
    # node's rank in its feature's table
    thresholds = [np.empty(0, np.float64)] * max(num_features, 0)
    thr_rank = np.zeros((T, M), np.int32)
    for f in sorted(num_features_used):
        nodes_f = num_mask & (feat == f)
        arr = np.unique(thr_raw[nodes_f])
        if 0 <= f < num_features:
            thresholds[f] = arr
        thr_rank[nodes_f] = np.searchsorted(
            arr, thr_raw[nodes_f], side="left").astype(np.int32)
    cat_mask = valid & (is_cat > 0)
    if cat_mask.any():
        thr_rank[cat_mask] = thr_raw[cat_mask].astype(np.int64).astype(
            np.int32)

    k = max(num_class, 1)
    hits = np.zeros((T, 1, k), np.float32)
    hits[np.arange(T), 0, np.arange(T) % k] = 1.0
    nodes = np.stack([feat, thr_rank, is_cat, dleft, left, right], axis=2)
    trees = RankedTrees(
        nodes=torch.as_tensor(nodes, device=dev),
        leaf_value=torch.as_tensor(leaf_value, dtype=torch.float32,
                                   device=dev),
        hits=torch.as_tensor(hits, device=dev),
        init=torch.as_tensor(np.where(num_leaves > 1, 0, -1).astype(
            np.int32), device=dev),
        node_base=torch.arange(T, dtype=torch.long, device=dev) * M,
        leaf_base=torch.arange(T, dtype=torch.long, device=dev) * L,
        depth=depth)
    max_feature = int(feat.max()) if T else 0
    return RankedPredictor(trees, tuple(thresholds), frozenset(cat_features),
                           max_feature)


def rank_encode(rp: RankedPredictor, features, out=None) -> tuple:
    """Host: (N, F) raw f64 values -> (V, D): the int32 rank/category
    matrix and the bool zero-range mask.  All f64 decisions happen here
    (numpy), once a value.  ``out``: (V, D) arrays of that shape and
    dtype to write into (pinned host memory, for the bulk pipeline)."""
    X = np.asarray(features, np.float64)
    n, F = X.shape
    if out is None:
        out = (np.empty((n, F), np.int32), np.empty((n, F), bool))
    V, D = out
    for f in range(F):
        col = X[:, f]
        if f in rp.cat_features:
            # kept domain |v| <= 2^31-2; anything outside maps to the
            # sentinel, which can never equal an (in-domain, enforced at
            # build) threshold — so out-of-range values route right
            # exactly as the host int64 compare does
            with np.errstate(invalid="ignore"):
                iv = np.where(np.isfinite(col), col, 0.0).astype(np.int64)
            V[:, f] = np.where(
                np.isfinite(col) & (np.abs(iv) <= 2 ** 31 - 2),
                iv, _CAT_SENTINEL)
        else:
            V[:, f] = np.searchsorted(rp.thresholds[f], col, side="left")
    np.logical_and(X > -kMissingValueRange, X <= kMissingValueRange, out=D)
    return V, D


def ranked_leaves(trees: RankedTrees, V, D, t0: int, t1: int):
    """(N, t1 - t0) int32 leaf of each row in trees t0..t1-1 (0 for
    stumps): every tree descends the block's deepest-leaf count of
    steps at once, over a (rows, trees) node state."""
    n = V.shape[0]
    nodes = trees.nodes.view(-1, 6)
    base = trees.node_base[t0:t1]
    node = trees.init[t0:t1].expand(n, t1 - t0)
    for _ in range(int(trees.depth[t0:t1].max(initial=0))):
        g = nodes[node.clamp(min=0) + base]         # (N, tb, 6)
        f = g[..., 0].long()
        v = V.gather(1, f)
        thr = g[..., 1]
        go_left = torch.where(g[..., 2] > 0, v == thr, v <= thr)
        go_left = torch.where(D.gather(1, f), g[..., 3] > 0, go_left)
        nxt = torch.where(go_left, g[..., 4], g[..., 5])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def ranked_predict(trees: RankedTrees, V, D, tree_block=None):
    """(N, K) f32 raw scores on V's device.  Leaf routing is bit-equal to
    the host f64 predictor; values accumulate with Kahan compensation in
    tree order, each step one elementwise operation (no fused
    multiply-add can form), the other classes' columns adding a
    compensated zero, as the JAX package's ``ranked_predict_device``.
    Trees descend ``tree_block`` at a time (all at once when None),
    which bounds the (rows, trees) state and changes no bit."""
    n = V.shape[0]
    T = trees.num_trees
    k = trees.hits.shape[2]
    score = torch.zeros((n, k), dtype=torch.float32, device=V.device)
    comp = torch.zeros_like(score)
    block = T if tree_block is None else max(int(tree_block), 1)
    lv = trees.leaf_value.view(-1)
    for t0 in range(0, T, block):
        t1 = min(t0 + block, T)
        leaf = ranked_leaves(trees, V, D, t0, t1)
        add = lv[leaf + trees.leaf_base[t0:t1]]     # (N, tb)
        for j in range(t1 - t0):
            y = add[:, j:j + 1] * trees.hits[t0 + j] - comp
            t = score + y
            comp = (t - score) - y
            score = t
    return score


def ranked_leaf_indices(trees: RankedTrees, V, D):
    """(N, T) int32 leaf index a tree: the routing-exactness probe."""
    return ranked_leaves(trees, V, D, 0, trees.num_trees)


def ranked_predict_sharded(rp: RankedPredictor, V, D, num_class: int,
                           devices=None, tree_block=None):
    """Row-sharded bulk prediction over several devices (JAX
    ``ops/predict.py ranked_predict_sharded``).  Prediction is parallel
    in rows: the tree stack is replicated to every entry of ``devices``
    (``RankedPredictor.replicas``), the rows are padded to a multiple of
    the entries (zero rows) and each entry traverses its contiguous share
    on its own copy.  A row's arithmetic is its own (``ranked_predict``),
    so the scores are bit-identical to one device's.  With one device,
    or none (the stack's own), it is ``ranked_predict``.

    V (N, F) int32 and D (N, F) bool: numpy arrays or tensors (the rank
    encoding); num_class is the stack's K (the JAX signature's).
    Returns (scores, n): (N + pad, K) f32 on the first entry's device,
    whose rows n: are pad."""
    n = int(V.shape[0])
    if not devices or len(devices) <= 1:
        dev = resolve_device(devices[0]) if devices else rp.dev.device
        trees = rp.dev if dev == rp.dev.device else rp.replicas([dev])[0]
        return ranked_predict(
            trees, torch.as_tensor(V).to(dev, non_blocking=True),
            torch.as_tensor(D).to(dev, non_blocking=True), tree_block), n
    reps = rp.replicas(devices)
    ndev = len(reps)
    per = -(-max(n, 1) // ndev)
    V, D = torch.as_tensor(V), torch.as_tensor(D)
    outs = []
    for i, trees in enumerate(reps):
        lo, hi = min(i * per, n), min((i + 1) * per, n)
        Vi, Di = V[lo:hi], D[lo:hi]
        if hi - lo < per:
            # pad rows traverse from rank 0; they are sliced off
            Vi = torch.cat([Vi, Vi.new_zeros((per - (hi - lo),
                                              V.shape[1]))])
            Di = torch.cat([Di, Di.new_zeros((per - (hi - lo),
                                              D.shape[1]))])
        dev = trees.device
        outs.append(ranked_predict(trees, Vi.to(dev, non_blocking=True),
                                   Di.to(dev, non_blocking=True),
                                   tree_block))
    first = reps[0].device
    return torch.cat([o.to(first) for o in outs]), n
