"""Wave growth — best-first tree construction, the top-W leaves per wave.

Ported from the JAX package's ``ops/wave.py`` (``make_wave_core``) on the
dense serial path: batched wave order, compact split lookup, larger
children by parent subtraction against a per-leaf histogram cache, and
the packed split search over all 2W children at once.

Each wave is one fused pass (kernel B1, ``wave_partition_hist``) that
routes the rows of the W chosen leaves and builds the W smaller-child
histograms; the root histogram and the no-cache larger-child pass go
through the histogram-only kernel (B3, ``wave_histogram``).  With
``tpu_histogram_mode=pallas`` the bins stay row-major (N, G): the
partition runs as plain tensor ops on the split columns
(``route_rows_rowmajor``) and every histogram, the root's included, comes
from the row-major kernel (B4, ``wave_histogram_rowmajor``).  B1, B3 and
B4 share one histogram pass and take the tree's fixed-point exponents,
so on the card every dense histogram is the f32 rounding of an exact sum
and the three dataflows grow the same trees to the byte.

The body of the JAX package's ``lax.while_loop`` is ``WaveGrower.wave``:
a function over explicit state (``WaveState``: leaf ids, the histogram
cache, the per-leaf best splits, the tree, and device scalars for the
split count, the stop flag and the waves done) that writes in place and
commits every split through a mask, the JAX package's drop-index
scatters becoming writes to a spare slot past the end of each array.  A
wave whose slots are all invalid is an exact no-op on the state, and no
call of the body reads the device, so a fixed number of waves can run
unread (``ops/fused_iter.py`` replays them as CUDA graphs).
``grow_tree`` is the staged driver: the same body, with one host read a
wave (the count of valid splits, the k == 0 stop test, and the depth the
wave leaves) between its selection and its commit.

On the entry-chunk sparse store (``ops/sparse_mxu.py``, the JAX
package's ``sparse_mxu`` engine) every histogram -- the root's one slot,
each wave's smaller children and the no-cache larger children -- comes
from kernel B6, in the same fixed point with the same exponents
(``sparse_wave_histogram``); the partition reads only the entries of the W
split columns (``sparse_route_rows``, plain torch), and the histogram view
rebuilds the fill-bin slots the store never holds (``fix_default``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .grow import GrowStats, TreeArrays, feature_hist_view
from .histogram import weight_rows
from .split_finder import (DEFAULT_BIN_FOR_ZERO, FEATURE, GAIN, IS_CAT,
                           LEFT_COUNT, LEFT_OUTPUT, LEFT_SUM_G, LEFT_SUM_H,
                           RIGHT_COUNT, RIGHT_OUTPUT, RIGHT_SUM_G,
                           RIGHT_SUM_H, SECOND_FEATURE, SECOND_GAIN,
                           SPLIT_VEC_SIZE, THRESHOLD, FeatureMeta,
                           SplitParams, best_splits_batched)
from .sparse_mxu import (ChunkedSparseStore, sparse_route_rows,
                         sparse_wave_histogram)
from .wave_kernels import (fixed_point_exponents, route_rows_plain,
                           route_rows_rowmajor, wave_histogram,
                           wave_histogram_rowmajor, wave_partition_hist)


def _stable_topk(gains, W):
    """Top-W of gains, ties broken by lower index (lax.top_k's order)."""
    vals, idx = torch.sort(gains, descending=True, stable=True)
    return vals[:W], idx[:W]


def _put(dst, idx, mask, val):
    """dst[idx] = val where mask; the other writes land in dst's last
    slot, a spare past the end of the array's real entries (the JAX
    package's mode='drop' scatter)."""
    dst[torch.where(mask, idx, dst.shape[0] - 1)] = val


@dataclass
class WaveState:
    """Everything a wave reads and writes, allocated once: the leaf ids,
    the per-leaf histogram cache and best splits (a spare row past the
    L leaves), the tree (``TreeArrays`` of room for L + 1 leaves: one
    spare slot past its nodes and one past its leaves), device scalars
    for the splits made (nn), the stop flag and the waves that split,
    and ``status`` (done, nn, deepest leaf, waves): the one int32 (4,)
    vector a driver reads."""
    leaf_id: torch.Tensor     # (N,) i32
    hists: torch.Tensor       # (L + 1, Fh, B, 3) f32, or (0,) without cache
    bests: torch.Tensor       # (L + 1, SPLIT_VEC_SIZE) f32
    tree: TreeArrays          # room for L + 1 leaves
    nn: torch.Tensor          # () i32 splits made
    done: torch.Tensor        # () bool a wave found no valid split
    waves: torch.Tensor       # () i32 waves that committed a split
    status: torch.Tensor      # (4,) i32


class Pick(NamedTuple):
    """A wave's selection: the top-W leaves, which of them split, their
    count and the deepest leaf once they have."""
    parent: torch.Tensor      # (W,) long leaf ids, gains descending
    valid: torch.Tensor       # (W,) bool, a prefix
    k: torch.Tensor           # () i32
    depth: torch.Tensor       # () i32


class WaveGrower:
    """The wave grower of one learner: its bins (X: (G, N) uint8
    transposed, (N, G) row-major for hist_mode 'pallas', or a
    ChunkedSparseStore), feature metadata and static sizes.

    hist_mode 'pallas_ct' fuses the partition and the smaller children's
    histograms (B1); 'pallas_t' is the JAX package's dataflow of that
    name, the partition as plain tensor ops and the histograms through
    B3; 'pallas' is the same on the row-major bins, through B4.  The
    mode has no meaning on the sparse store."""

    def __init__(self, X, meta: FeatureMeta, bundle, *, num_leaves: int,
                 num_bins: int, params: SplitParams, max_depth: int,
                 wave_width: int, group_bins: int = 0,
                 cache_hists: bool = True, hist_mode: str = "pallas_ct"):
        self.X, self.meta, self.bundle = X, meta, bundle
        self.L = num_leaves
        self.W = max(1, min(wave_width, num_leaves - 1))
        self.num_bins = num_bins
        self.hist_bins = group_bins if bundle is not None else num_bins
        self.params, self.max_depth = params, max_depth
        self.cache_hists, self.hist_mode = cache_hists, hist_mode
        self.sparse = isinstance(X, ChunkedSparseStore)
        if self.sparse:
            self.hist_cols = X.num_cols
        else:
            self.hist_cols = X.shape[1 if hist_mode == "pallas" else 0]

    def new_state(self, n: int, dev) -> WaveState:
        """Buffers for growing trees over n rows on dev (set by
        ``root``; the histogram cache starts zero, and a row a tree has
        not written is read only by masked-off slots)."""
        L, f32, i32 = self.L, torch.float32, torch.int32
        hists = (torch.zeros((L + 1, self.hist_cols, self.hist_bins, 3),
                             dtype=f32, device=dev)
                 if self.cache_hists else torch.empty(0, device=dev))
        return WaveState(
            leaf_id=torch.empty(n, dtype=i32, device=dev), hists=hists,
            bests=torch.empty((L + 1, SPLIT_VEC_SIZE), dtype=f32,
                              device=dev),
            tree=TreeArrays.new(L + 1, torch.zeros((), device=dev), f32,
                                dev),
            nn=torch.empty((), dtype=i32, device=dev),
            done=torch.empty((), dtype=torch.bool, device=dev),
            waves=torch.empty((), dtype=i32, device=dev),
            status=torch.empty(4, dtype=i32, device=dev))

    # ------------------------------------------------------------- pieces
    def _child_hists(self, lid, ids, w3, exps):
        if self.sparse:
            return sparse_wave_histogram(self.X, lid, w3, ids,
                                         self.hist_bins, self.X.num_cols,
                                         exps=exps)
        if self.hist_mode == "pallas":
            return wave_histogram_rowmajor(self.X, lid, w3, ids,
                                           self.hist_bins, exps=exps)
        return wave_histogram(self.X, lid, w3, ids, self.hist_bins,
                              exps=exps)

    def _best_of_many(self, hists_k, sums_k, depths_k, feature_mask):
        meta, bundle, sparse = self.meta, self.bundle, self.sparse
        return best_splits_batched(
            hists_k, sums_k, depths_k, meta, feature_mask, self.params,
            self.max_depth,
            hist_view=lambda h, s: feature_hist_view(h, s, meta, bundle,
                                                     fix_default=sparse))

    def tree_of(self, st: WaveState) -> TreeArrays:
        """The state's tree without its spare slots (views)."""
        return st.tree.head(self.L)

    # --------------------------------------------------------------- root
    def root(self, st: WaveState, w3, exps, feature_mask) -> None:
        """Reset the state to the one-leaf tree of the weight rows w3 (N,
        3) and their fixed-point exponents exps: every row in leaf 0, its
        histogram (one child slot) and best split."""
        L, dev, i32 = self.L, w3.device, torch.int32
        st.leaf_id.zero_()
        root_sums = w3.sum(dim=0)
        hist0 = self._child_hists(st.leaf_id,
                                  torch.zeros(1, dtype=i32, device=dev), w3,
                                  exps)[0]
        if self.cache_hists:
            st.hists[0] = hist0
        st.bests.fill_(-float("inf"))
        st.bests[0] = self._best_of_many(
            hist0[None], root_sums[None], torch.zeros(1, dtype=i32,
                                                      device=dev),
            feature_mask)[0]
        st.tree.reset_(root_sums[2])
        st.nn.zero_()
        st.done.fill_(L <= 1)
        st.waves.zero_()

    # --------------------------------------------------------------- wave
    def pick(self, st: WaveState) -> Pick:
        """The top-W leaves by gain and which of them split (a positive
        gain, within the leaf budget)."""
        L, W = self.L, self.W
        gw, parent = _stable_topk(st.bests[:L, GAIN], W)
        rank = torch.arange(W, dtype=torch.long, device=gw.device)
        valid = (gw > 0.0) & (rank < (L - 1) - st.nn)
        depth = st.tree.leaf_depth[:L]
        grown = torch.where(valid, depth[parent] + 1, 0).amax()
        return Pick(parent, valid, valid.sum().to(torch.int32),
                    torch.maximum(depth.amax(), grown))

    def commit(self, st: WaveState, p: Pick, w3, exps, feature_mask):
        """Split the valid leaves of pick p: route their rows, build the
        children's histograms and best splits, and record the splits in
        the tree -- every write masked by p.valid, so a pick with no
        valid slot changes nothing."""
        L, W, meta, bundle = self.L, self.W, self.meta, self.bundle
        dev = w3.device
        f32, i32 = torch.float32, torch.int32
        parent, valid, k = p.parent, p.valid, p.k
        rank = torch.arange(W, dtype=torch.long, device=dev)
        # invalid slots may point at unsplit leaves whose packed vectors
        # are all -inf; they are never committed, so zero them
        info = torch.where(valid[:, None], st.bests[parent],
                           torch.zeros((), dtype=f32, device=dev))
        node = st.nn.long() + rank
        newleaf = node + 1

        f_w = info[:, FEATURE].long()
        thr_w = info[:, THRESHOLD].to(i32)
        dbz_w = info[:, DEFAULT_BIN_FOR_ZERO].to(i32)
        cat_w = info[:, IS_CAT] > 0.5
        fdef_w = meta.default_bin[f_w]
        dleft_w = torch.where(cat_w, dbz_w == thr_w, dbz_w <= thr_w)
        if bundle is not None:
            col_w = bundle.group_of[f_w]
            goff_w = bundle.bin_off[f_w]
            adj_w = bundle.bin_adj[f_w]
            span_w = bundle.bin_span[f_w]
        else:
            col_w = f_w
            goff_w = torch.zeros(W, dtype=i32, device=dev)
            adj_w = torch.zeros(W, dtype=i32, device=dev)
            span_w = torch.full((W,), self.num_bins, dtype=i32, device=dev)
        cols = torch.stack([
            torch.ones(W, dtype=f32, device=dev),      # 0: active
            col_w.to(f32),                             # 1: device column
            thr_w.to(f32),                             # 2: threshold bin
            cat_w.to(f32),                             # 3: categorical
            fdef_w.to(f32),                            # 4: default bin
            dleft_w.to(f32),                           # 5: default left
            newleaf.to(f32),                           # 6: right leaf id
            goff_w.to(f32),                            # 7: group offset
            adj_w.to(f32),                             # 8: bin adjust
            span_w.to(f32),                            # 9: bin span
        ], dim=-1).contiguous()                        # (W, 10)
        psrc = torch.where(valid, parent, -3).to(i32)

        # ---- partition + smaller-children histograms (one pass)
        left_small = info[:, LEFT_COUNT] < info[:, RIGHT_COUNT]
        small_id = torch.where(left_small, parent, newleaf)
        large_id = torch.where(left_small, newleaf, parent)
        cid = torch.where(valid, small_id, -1).to(i32)
        X, bundled = self.X, bundle is not None
        if self.sparse:
            lid = sparse_route_rows(X, st.leaf_id, cols, psrc, L, bundled)
            hist_small = self._child_hists(lid, cid, w3, exps)
        elif self.hist_mode == "pallas_ct":
            lid, hist_small = wave_partition_hist(
                X, st.leaf_id, w3, cid, cols, psrc, self.hist_bins,
                bundled=bundled, exps=exps)
        else:
            route = (route_rows_rowmajor if self.hist_mode == "pallas"
                     else route_rows_plain)
            lid = route(X, st.leaf_id, cols, psrc, bundled)
            hist_small = self._child_hists(lid, cid, w3, exps)
        st.leaf_id.copy_(lid)
        if self.cache_hists:
            hist_large = st.hists[parent] - hist_small
        else:
            hist_large = self._child_hists(
                st.leaf_id, torch.where(valid, large_id, -1).to(i32), w3,
                exps)

        left_sums = torch.stack([info[:, LEFT_SUM_G], info[:, LEFT_SUM_H],
                                 info[:, LEFT_COUNT]], dim=-1)
        right_sums = torch.stack([info[:, RIGHT_SUM_G],
                                  info[:, RIGHT_SUM_H],
                                  info[:, RIGHT_COUNT]], dim=-1)
        small_sums = torch.where(left_small[:, None], left_sums, right_sums)
        large_sums = torch.where(left_small[:, None], right_sums, left_sums)

        # ---- split search for all 2W children
        tree = st.tree
        depth = tree.leaf_depth[parent] + 1                 # (W,)
        bests_k = self._best_of_many(torch.cat([hist_small, hist_large]),
                                     torch.cat([small_sums, large_sums]),
                                     torch.cat([depth, depth]),
                                     feature_mask)          # (2W, V)

        # ---- masked commit: invalid slots write the spare slots
        if self.cache_hists:
            _put(st.hists, small_id, valid, hist_small)
            _put(st.hists, large_id, valid, hist_large)
        _put(st.bests, small_id, valid, bests_k[:W])
        _put(st.bests, large_id, valid, bests_k[W:])

        # ---- tree bookkeeping for the committed splits
        node32 = node.to(i32)
        tparent = tree.leaf_parent[parent].long()
        gp = tparent.clamp(min=0)
        was_left = tree.left_child[gp] == (~parent).to(i32)
        fix = valid & (tparent >= 0)
        lc, rc = tree.left_child, tree.right_child
        _put(lc, gp, fix & was_left, node32)
        _put(rc, gp, fix & ~was_left, node32)
        _put(lc, node, valid, (~parent).to(i32))
        _put(rc, node, valid, (~newleaf).to(i32))
        internal_value = tree.leaf_value[parent]
        tree.num_leaves.add_(k)
        for name, val in (
                ("split_feature", f_w.to(i32)), ("threshold_bin", thr_w),
                ("default_bin_for_zero", dbz_w),
                ("default_bin", fdef_w.to(i32)), ("is_cat", cat_w.to(i32)),
                ("split_gain", info[:, GAIN]),
                ("internal_value", internal_value),
                ("internal_count", (info[:, LEFT_COUNT]
                                    + info[:, RIGHT_COUNT]).to(i32)),
                ("second_feature", info[:, SECOND_FEATURE].to(i32))):
            _put(getattr(tree, name), node, valid, val)
        sg = info[:, SECOND_GAIN]
        _put(tree.second_gain, node, valid,
             torch.where(torch.isfinite(sg), sg, torch.zeros_like(sg)))
        for leaf, value, count in ((parent, LEFT_OUTPUT, LEFT_COUNT),
                                   (newleaf, RIGHT_OUTPUT, RIGHT_COUNT)):
            _put(tree.leaf_parent, leaf, valid, node32)
            _put(tree.leaf_value, leaf, valid, info[:, value])
            _put(tree.leaf_count, leaf, valid, info[:, count].to(i32))
            _put(tree.leaf_depth, leaf, valid, depth)
        st.nn.add_(k)
        st.done.copy_((k == 0) | (st.nn == L - 1))
        st.waves.add_((k > 0).to(i32))

    def wave(self, st: WaveState, w3, exps, feature_mask) -> None:
        """One masked wave: pick, then commit, with no host read."""
        self.commit(st, self.pick(st), w3, exps, feature_mask)

    def write_status(self, st: WaveState) -> None:
        """st.status = (done, nn, deepest leaf, waves), for one read."""
        done = st.done | (st.nn == self.L - 1)
        st.status.copy_(torch.stack([
            done.to(torch.int32), st.nn,
            st.tree.leaf_depth[:self.L].amax(), st.waves]))


def grow_tree(X, grad, hess, row_mult, feature_mask, meta: FeatureMeta,
              bundle, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int, wave_width: int,
              group_bins: int = 0, cache_hists: bool = True,
              hist_mode: str = "pallas_ct"):
    """Grow one tree, staged: a WaveGrower's body with one host read a
    wave.  X: (G, N) uint8 transposed bins, (N, G) row-major bins for
    hist_mode 'pallas', or a ChunkedSparseStore; grad/hess/row_mult: (N,)
    f32.  Returns (TreeArrays, leaf_id (N,) int32, GrowStats)."""
    g = WaveGrower(X, meta, bundle, num_leaves=num_leaves,
                   num_bins=num_bins, params=params, max_depth=max_depth,
                   wave_width=wave_width, group_bins=group_bins,
                   cache_hists=cache_hists, hist_mode=hist_mode)
    st = g.new_state(grad.shape[0], grad.device)
    w3 = weight_rows(grad, hess, row_mult)                 # (N, 3)
    # the kernels' fixed-point exponents (B1, B3, B4, B6): w3 is fixed
    # within the tree, so the root and every child carry the same scale
    exps = fixed_point_exponents(w3)
    g.root(st, w3, exps, feature_mask)
    nn = depth = waves = host_reads = 0
    while nn < num_leaves - 1:
        p = g.pick(st)
        # the one host read per wave: valid count + the depth after it
        k, depth = torch.stack([p.k, p.depth]).tolist()
        host_reads += 1
        if k == 0:
            break
        g.commit(st, p, w3, exps, feature_mask)
        waves += 1
        nn += k
    stats = GrowStats(num_leaves=nn + 1, depth=depth, waves=waves,
                      host_reads=host_reads)
    return g.tree_of(st), st.leaf_id, stats
