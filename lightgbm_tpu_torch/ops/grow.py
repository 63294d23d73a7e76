"""Exact (leaf-wise) tree growth, and the device-side tree state that both
growers fill: the flat tree arrays, the EFB layout they read and the
per-feature histogram view.

Ported from the JAX package's ``ops/grow.py``; the NamedTuple pytrees
become dataclasses of tensors with the same fields and layouts.
``grow_tree_exact`` is the serial masked arm of its ``make_grow_core``
with ``hist_mode='pallas'``: one split at a time, the argmax over all
leaves (serial_tree_learner.cpp:203), a masked full-N partition on the
split column, the smaller child's histogram from kernel B5
(``ops/leaf_hist.py``), the larger by parent subtraction.  The JAX
package's ordered-partition capacity ladder, the onehot/scatter engines,
the coordinate sparse store, the feature-parallel and voting arms and
4-bit packing are other arms of that function and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

from .histogram import leaf_sums, weight_rows
from .leaf_hist import leaf_histogram
from .split_finder import (DEFAULT_BIN_FOR_ZERO, FEATURE, GAIN, IS_CAT,
                           LEFT_COUNT, LEFT_OUTPUT, LEFT_SUM_G, RIGHT_COUNT,
                           RIGHT_OUTPUT, RIGHT_SUM_G, SECOND_FEATURE,
                           SECOND_GAIN, SPLIT_VEC_SIZE, THRESHOLD,
                           FeatureMeta, SplitParams, best_splits_batched)
from .wave_kernels import fixed_point_exponents


@dataclass
class GrowStats:
    """Host-side facts about one grown tree."""
    num_leaves: int
    depth: int          # deepest leaf's depth
    waves: int          # histogram passes after the root: a wave's fused
    #                     pass, or one split under exact growth
    host_reads: int     # device->host reads made while growing
    tail_waves: int = 0  # fused iteration: waves replayed one at a time
    #                      after the tree's M masked waves and its read


@dataclass
class BundleArrays:
    """Device-side EFB layout (io/bundle.py BundleLayout uploaded).

    Histograms are built over GROUP columns (G, Bg, 3); the split scan
    runs on per-FEATURE views gathered via ``gather_idx`` with the default
    bin rebuilt by subtraction (FixHistogram, dataset.cpp:764-783)."""
    group_of: torch.Tensor        # (F,) i32 feature -> group column
    bin_off: torch.Tensor         # (F,) i32
    bin_adj: torch.Tensor         # (F,) i32
    bin_span: torch.Tensor        # (F,) i32
    gather_idx: torch.Tensor      # (F, B) i64 into flattened (G*Bg)
    valid_mask: torch.Tensor      # (F, B) bool — non-default, in-range bins


@dataclass
class TreeArrays:
    """Flat SoA tree mirroring tree.h:195-229, device-resident."""
    num_leaves: torch.Tensor          # scalar i32
    split_feature: torch.Tensor       # (L-1,) i32 inner feature index
    threshold_bin: torch.Tensor       # (L-1,) i32
    default_bin_for_zero: torch.Tensor  # (L-1,) i32
    default_bin: torch.Tensor         # (L-1,) i32 (feature's zero bin)
    is_cat: torch.Tensor              # (L-1,) i32
    left_child: torch.Tensor          # (L-1,) i32 (~leaf for leaves)
    right_child: torch.Tensor         # (L-1,) i32
    split_gain: torch.Tensor          # (L-1,) f32
    internal_value: torch.Tensor      # (L-1,) f32
    internal_count: torch.Tensor      # (L-1,) i32
    leaf_parent: torch.Tensor         # (L,) i32
    leaf_value: torch.Tensor          # (L,) f32 (unshrunk outputs)
    leaf_count: torch.Tensor          # (L,) i32
    leaf_depth: torch.Tensor          # (L,) i32
    second_feature: torch.Tensor      # (L-1,) i32
    second_gain: torch.Tensor         # (L-1,) f32

    def to_numpy(self) -> dict:
        """Host copy as a dict of numpy arrays (one transfer per field)."""
        return {f.name: getattr(self, f.name).cpu().numpy()
                for f in fields(self)}

    _LEAF_FIELDS = ("leaf_parent", "leaf_value", "leaf_count", "leaf_depth")
    _FLOAT_FIELDS = ("split_gain", "internal_value", "leaf_value",
                     "second_gain")

    @classmethod
    def new(cls, num_leaves: int, root_count, dtype, dev) -> "TreeArrays":
        """A one-leaf tree of room for num_leaves leaves; root_count is a
        0-dim tensor (the root's row count, kept on the device)."""
        L = num_leaves
        arrays = {f.name: torch.empty(
            () if f.name == "num_leaves" else
            L if f.name in cls._LEAF_FIELDS else L - 1,
            dtype=dtype if f.name in cls._FLOAT_FIELDS else torch.int32,
            device=dev) for f in fields(cls)}
        return cls(**arrays).reset_(root_count)

    def reset_(self, root_count) -> "TreeArrays":
        """Re-initialise in place to a one-leaf tree whose root holds
        root_count rows (a 0-dim tensor): device fills and one
        device-to-device copy, no host transfer."""
        for f in fields(self):
            getattr(self, f.name).zero_()
        self.num_leaves.fill_(1)
        self.leaf_parent.fill_(-1)
        self.second_feature.fill_(-1)
        self.leaf_count[0] = root_count.to(torch.int32)
        return self

    def head(self, num_leaves: int) -> "TreeArrays":
        """Views of the first num_leaves leaves and num_leaves - 1 nodes:
        the tree of a grower whose arrays keep spare trailing slots."""
        return TreeArrays(**{
            f.name: (getattr(self, f.name) if f.name == "num_leaves" else
                     getattr(self, f.name)[:num_leaves if f.name in
                                           self._LEAF_FIELDS
                                           else num_leaves - 1])
            for f in fields(self)})

    def copy_(self, other: "TreeArrays") -> "TreeArrays":
        """Copy other's arrays into this tree's, in place."""
        for f in fields(self):
            getattr(self, f.name).copy_(getattr(other, f.name))
        return self

    def clone(self) -> "TreeArrays":
        """A tree with its own copy of every array."""
        return TreeArrays(**{f.name: getattr(self, f.name).clone()
                             for f in fields(self)})


def feature_hist_view(ghist, sums, meta, bundle, fix_default: bool = False):
    """Group histograms -> per-feature (K, F, B, 3) views with the default
    bin rebuilt by subtraction (FixHistogram, dataset.cpp:764-783).

    ghist: (K, G, Bg, 3); sums: (K, 3).  Without a bundle the group
    columns ARE the features and the view is the identity, unless
    fix_default: the sparse store never holds fill-bin entries, so their
    slots arrive zero and take the remainder sums - (sum of the others)."""
    if bundle is None:
        if not fix_default:
            return ghist
        fidx = torch.arange(ghist.shape[1], device=ghist.device)
        v = ghist.clone()
        v[:, fidx, meta.default_bin.long()] = (sums[:, None, :]
                                               - ghist.sum(dim=2))
        return v
    K = ghist.shape[0]
    flat = ghist.reshape(K, -1, 3)
    v = flat[:, bundle.gather_idx] * bundle.valid_mask[None, ..., None].to(
        ghist.dtype)                                         # (K, F, B, 3)
    F = v.shape[1]
    fidx = torch.arange(F, device=v.device)
    v[:, fidx, meta.default_bin.long()] = sums[:, None, :] - v.sum(dim=2)
    return v


def grow_tree_exact(X, grad, hess, row_mult, feature_mask, meta: FeatureMeta,
                    bundle, *, num_leaves: int, num_bins: int,
                    params: SplitParams, max_depth: int, group_bins: int = 0,
                    cache_hists: bool = True):
    """Grow one tree leaf-wise.  X: (N, G) uint8 row-major bins;
    grad/hess/row_mult: (N,) f32.  Returns (TreeArrays, leaf_id (N,)
    int32, GrowStats).

    The JAX package runs the loop on the device and gates every update on
    ``ok`` (gain > 0).  Here the loop is in Python and needs no gate: a
    split consumes the one leaf it splits and puts its two children in
    its place, so the count of leaves with a positive gain drops by at
    most one a split.  One host read of that count P therefore lets the
    next min(P, budget) splits run unread, each certain to commit; a
    further read when they are done, and the loop stops when P is 0 or
    the tree is full.  Every split indexes with device tensors, so
    nothing else waits on the device."""
    L = num_leaves
    hist_bins = group_bins if bundle is not None else num_bins
    dev = grad.device
    f32, i32 = torch.float32, torch.int32
    n = grad.shape[0]
    leaf_id = torch.zeros(n, dtype=i32, device=dev)
    leaf_ids = torch.arange(L, dtype=torch.long, device=dev)
    # B5's weight rows and fixed-point exponents, once a tree as the wave
    # grower makes them: every leaf histogram of the tree, and wave
    # growth's at width 1, then sums the same rows to the same bits
    w3 = weight_rows(grad, hess, row_mult)
    exps = fixed_point_exponents(w3)

    def hist_of(lid, leaf):
        return leaf_histogram(X, grad, hess, lid, leaf, row_mult, hist_bins,
                              w3=w3, exps=exps)

    def best_of(hists_k, sums_k, depths_k):
        return best_splits_batched(
            hists_k, sums_k, depths_k, meta, feature_mask, params, max_depth,
            hist_view=lambda h, s: feature_hist_view(h, s, meta, bundle))

    # ---- root
    root_sums = leaf_sums(grad, hess, leaf_id, 0, row_mult)
    hist0 = hist_of(leaf_id, 0)
    if cache_hists:
        hists = torch.zeros((L,) + tuple(hist0.shape), dtype=f32, device=dev)
        hists[0] = hist0
    bests = torch.full((L, SPLIT_VEC_SIZE), -float("inf"), dtype=f32,
                       device=dev)
    bests[0] = best_of(hist0[None], root_sums[None],
                       torch.zeros(1, dtype=i32, device=dev))[0]
    tree = TreeArrays.new(L, root_sums[2], f32, dev)
    default_bin = meta.default_bin

    nn = host_reads = 0
    while True:
        # the one host read of a batch: leaves with a positive gain, and
        # the deepest leaf so far
        host = torch.stack([(bests[:, GAIN] > 0.0).sum().to(i32),
                            tree.leaf_depth.max()]).tolist()
        host_reads += 1
        pending, depth = int(host[0]), int(host[1])
        if pending == 0 or nn == L - 1:
            break
        for _ in range(min(pending, L - 1 - nn)):
            node, new_leaf = nn, nn + 1
            bl = torch.argmax(bests[:, GAIN]).reshape(1)    # (1,) long
            info = bests.index_select(0, bl)[0]             # (V,)
            f = info[FEATURE].long().reshape(1)
            thr = info[THRESHOLD].to(i32)
            dbz = info[DEFAULT_BIN_FOR_ZERO].to(i32)
            cat = info[IS_CAT] > 0.5
            fdef = default_bin.index_select(0, f)[0]
            dleft = torch.where(cat, dbz == thr, dbz <= thr)

            # ---- partition (dense_bin.hpp:190-222): the split column,
            # remapped out of its EFB group, routes the leaf's rows
            j = (f if bundle is None
                 else bundle.group_of.index_select(0, f).long())
            col = X.index_select(1, j)[:, 0].to(i32)
            if bundle is not None:
                goff, span, adj = (a.index_select(0, f)[0] for a in (
                    bundle.bin_off, bundle.bin_span, bundle.bin_adj))
                col = torch.where((col >= goff) & (col < goff + span),
                                  col - goff + adj, fdef)
            go_left = torch.where(cat, col == thr, col <= thr)
            go_left = torch.where(col == fdef, dleft, go_left)
            leaf_id = torch.where((leaf_id == bl.to(i32)) & ~go_left,
                                  new_leaf, leaf_id)

            # ---- tree bookkeeping (tree.cpp:55-110)
            bl32 = bl.to(i32)
            parent = tree.leaf_parent.index_select(0, bl)
            gp = parent.clamp(min=0).long()
            lc, rc = tree.left_child, tree.right_child
            was_left = lc.index_select(0, gp) == ~bl32
            has_p = parent >= 0
            lc.index_copy_(0, gp, torch.where(has_p & was_left, node,
                                              lc.index_select(0, gp)))
            rc.index_copy_(0, gp, torch.where(has_p & ~was_left, node,
                                              rc.index_select(0, gp)))
            lc[node] = ~bl32[0]
            rc[node] = ~new_leaf
            depth1 = tree.leaf_depth.index_select(0, bl) + 1    # (1,)
            tree.num_leaves = tree.num_leaves + 1
            tree.split_feature[node] = f[0].to(i32)
            tree.threshold_bin[node] = thr
            tree.default_bin_for_zero[node] = dbz
            tree.default_bin[node] = fdef
            tree.is_cat[node] = cat.to(i32)
            tree.split_gain[node] = info[GAIN]
            tree.internal_value[node] = tree.leaf_value.index_select(0,
                                                                     bl)[0]
            tree.internal_count[node] = (info[LEFT_COUNT]
                                         + info[RIGHT_COUNT]).to(i32)
            tree.second_feature[node] = info[SECOND_FEATURE].to(i32)
            sg = info[SECOND_GAIN]
            tree.second_gain[node] = torch.where(torch.isfinite(sg), sg,
                                                 torch.zeros_like(sg))
            pair = torch.cat([bl, leaf_ids[new_leaf:new_leaf + 1]])
            tree.leaf_parent.index_fill_(0, pair, node)
            tree.leaf_value.index_copy_(0, pair,
                                        info[LEFT_OUTPUT:RIGHT_OUTPUT + 1])
            tree.leaf_count.index_copy_(
                0, pair, torch.stack([info[LEFT_COUNT],
                                      info[RIGHT_COUNT]]).to(i32))
            tree.leaf_depth.index_copy_(0, pair, depth1.expand(2))

            # ---- children: the smaller scanned (B5), the larger by
            # parent subtraction, or scanned when the cache is off
            left_small = info[LEFT_COUNT] < info[RIGHT_COUNT]
            sl = torch.where(left_small, pair, pair.flip(0))  # small, large
            hist_small = hist_of(leaf_id, sl[:1])
            if cache_hists:
                hist_large = hists.index_select(0, bl)[0] - hist_small
            else:
                hist_large = hist_of(leaf_id, sl[1:])
            hists2 = torch.stack([hist_small, hist_large])
            lr_sums = torch.stack([info[LEFT_SUM_G:LEFT_COUNT + 1],
                                   info[RIGHT_SUM_G:RIGHT_COUNT + 1]])
            sums2 = torch.where(left_small, lr_sums, lr_sums.flip(0))
            if cache_hists:
                hists.index_copy_(0, sl, hists2)
            bests.index_copy_(0, sl, best_of(hists2, sums2,
                                             depth1.expand(2)))
            nn += 1
    stats = GrowStats(num_leaves=nn + 1, depth=depth, waves=nn,
                      host_reads=host_reads)
    return tree, leaf_id, stats
