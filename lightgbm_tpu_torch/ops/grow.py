"""Exact (leaf-wise) tree growth, and the device-side tree state that both
growers fill: the flat tree arrays, the EFB layout they read and the
per-feature histogram view.

Ported from the JAX package's ``ops/grow.py``; the NamedTuple pytrees
become dataclasses of tensors with the same fields and layouts.
``ExactGrower`` is the serial masked arm of its ``make_grow_core`` with
``hist_mode='pallas'``: one split at a time, the argmax over all leaves
(serial_tree_learner.cpp:203), a masked full-N partition on the split
column, the smaller child's histogram from kernel B5
(``ops/leaf_hist.py``), the larger by parent subtraction.  Its split is
a function over explicit state (``GrowState``, which the wave grower
shares with it, as it shares ``Grower``'s root and status and
``record_splits``' tree bookkeeping) gated on ``ok`` (gain > 0, within
the leaf budget) as the JAX package gates its loop body, so
the fused iteration (``ops/fused_iter.py``) replays a fixed number of
splits unread; ``grow_tree_exact`` is the staged driver, one host read a
batch of splits certain to commit.  With ``hist_mode`` 'onehot' or
'scatter' the leaf histograms come from the JAX package's XLA engines
(``ops/histogram.py engine_histogram``) over the masked rows, and the
bins may be 4-bit packed, as the JAX package packs them on those
engines; its capacity tiers (a gather of each leaf's rows) are not
ported.  Under a comm (``parallel/comm.py``) the growers run the JAX
package's distributed arms: the base ``Grower`` under a comm is the
data-parallel arm, which all-reduces the root
sums and every histogram, the kernels' fixed-point sums before their
conversion (``Grower._reduce_hist``), with the exponents of the global
row count and |w| maximum (``Grower.exponents``); ``VotingGrower`` keeps
local histograms and all-reduces only the features the ranks vote for;
``FeatureParallelGrower`` holds every row of a block of features, folds
the ranks' best splits and takes the go-left mask of the rank that owns
the split's feature.  On the
coordinate sparse store (``ops/sparse_store.py``, ``hist_mode``
'sparse') a leaf histogram is one integer segment sum over the store's
entries (``sparse_leaf_hist``) and the split column comes from the
column's entries through its static window (``sparse_split_column``).
Under ``tpu_use_dp`` (dtype float64) the weights,
histograms, best splits and the tree's values are float64 and B5 runs
its f64 form.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Optional

import torch

from .histogram import ENGINE_MODES, engine_histogram, weight_rows
from .leaf_hist import leaf_histogram
from .pack import nibble, packed_column
from .sparse_store import (SparseDeviceStore, sparse_leaf_hist,
                           sparse_split_column)
from .split_finder import (DEFAULT_BIN_FOR_ZERO, FEATURE, GAIN, IS_CAT,
                           LEFT_COUNT, LEFT_OUTPUT, LEFT_SUM_G, RIGHT_COUNT,
                           RIGHT_OUTPUT, RIGHT_SUM_G, SECOND_FEATURE,
                           SECOND_GAIN, SPLIT_VEC_SIZE, THRESHOLD,
                           FeatureMeta, SplitParams, best_splits_batched,
                           depth_gate, find_best_splits,
                           per_feature_candidates)
from .wave_kernels import (bins_i32, finish_hist, fixed_point_exponents,
                           indexable, list_workspace)


@dataclass
class GrowStats:
    """Host-side facts about one grown tree."""
    num_leaves: int
    depth: int          # deepest leaf's depth
    passes: int         # passes after the root that split: waves under
    #                     wave growth, splits under exact growth
    host_reads: int     # device->host reads made while growing
    tail_passes: int = 0  # fused iteration: the masked passes its tail
    #                       graphs ran (waves or gated splits, no-op
    #                       ones past the tree's end included)


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




def _put(dst, idx, mask, val):
    """dst[idx] = val where mask; the other writes land in dst's last
    slot, a spare past the end of the array's real entries (the JAX
    package's mode='drop' scatter).  idx and mask are tensors of one
    shape (never 0-dim: a 0-dim index would be read back as an int)."""
    dst[torch.where(mask, idx, dst.shape[0] - 1)] = val


class SplitFields(NamedTuple):
    """The split of each of k leaves, unpacked from their packed best
    split vectors info (k, V): all (k,) tensors."""
    feature: torch.Tensor     # long inner feature index
    threshold: torch.Tensor   # i32 threshold bin
    dbz: torch.Tensor         # i32 default bin for zero
    is_cat: torch.Tensor      # bool
    fdef: torch.Tensor        # i32 the feature's default (zero) bin
    dleft: torch.Tensor       # bool the default bin goes left

    @classmethod
    def of(cls, info, meta: FeatureMeta) -> "SplitFields":
        i32 = torch.int32
        f = info[:, FEATURE].long()
        thr = info[:, THRESHOLD].to(i32)
        dbz = info[:, DEFAULT_BIN_FOR_ZERO].to(i32)
        cat = info[:, IS_CAT] > 0.5
        return cls(f, thr, dbz, cat, meta.default_bin[f],
                   torch.where(cat, dbz == thr, dbz <= thr))


def record_splits(tree: TreeArrays, parent, newleaf, node, mask, info,
                  split: SplitFields, depth) -> None:
    """Record in tree the splits of leaves parent (k,) long into nodes
    node (k,) long, each left child keeping its parent's id and each
    right child taking newleaf's (tree.cpp:55-110): the grandparents'
    child links, the nodes' fields from info (k, V) and split, and both
    children's parent, output, count and depth (k,).  Only where mask
    (k,) bool; the other writes land in the spare slots."""
    i32 = torch.int32
    node32 = node.to(i32)
    tparent = tree.leaf_parent[parent].long()
    gp = tparent.clamp(min=0)
    lc, rc = tree.left_child, tree.right_child
    was_left = lc[gp] == (~parent).to(i32)
    fix = mask & (tparent >= 0)
    _put(lc, gp, fix & was_left, node32)
    _put(rc, gp, fix & ~was_left, node32)
    _put(lc, node, mask, (~parent).to(i32))
    _put(rc, node, mask, (~newleaf).to(i32))
    internal_value = tree.leaf_value[parent]
    tree.num_leaves.add_(mask.sum(dtype=i32))
    sg = info[:, SECOND_GAIN]
    for name, val in (
            ("split_feature", split.feature.to(i32)),
            ("threshold_bin", split.threshold),
            ("default_bin_for_zero", split.dbz),
            ("default_bin", split.fdef.to(i32)),
            ("is_cat", split.is_cat.to(i32)),
            ("split_gain", info[:, GAIN]),
            ("internal_value", internal_value),
            ("internal_count", (info[:, LEFT_COUNT]
                                + info[:, RIGHT_COUNT]).to(i32)),
            ("second_feature", info[:, SECOND_FEATURE].to(i32)),
            ("second_gain", torch.where(torch.isfinite(sg), sg,
                                        torch.zeros_like(sg)))):
        _put(getattr(tree, name), node, mask, val)
    for leaf, value, count in ((parent, LEFT_OUTPUT, LEFT_COUNT),
                               (newleaf, RIGHT_OUTPUT, RIGHT_COUNT)):
        _put(tree.leaf_parent, leaf, mask, node32)
        _put(tree.leaf_value, leaf, mask, info[:, value])
        _put(tree.leaf_count, leaf, mask, info[:, count].to(i32))
        _put(tree.leaf_depth, leaf, mask, depth)


@dataclass
class GrowState:
    """Everything a grower's masked pass reads and writes, allocated
    once: the leaf ids, the per-leaf histogram cache and best splits (a
    spare row past the L leaves), the tree (``TreeArrays`` of room for
    L + 1 leaves: one spare slot past its nodes and one past its
    leaves), device scalars for the splits made (nn), the stop flag and,
    under wave growth, the waves that split; ``status`` (done, nn,
    deepest leaf, passes that split): the one int32 (4,) vector a grow
    loop reads; and the list passes' workspace of the dense kernels on the
    card (``list_workspace``), which every histogram call of the state
    shares."""
    leaf_id: torch.Tensor     # (N,) i32
    hists: torch.Tensor       # (L + 1, G, B, 3), or (0,) without cache
    bests: torch.Tensor       # (L + 1, SPLIT_VEC_SIZE) (the grower's dtype)
    tree: TreeArrays          # room for L + 1 leaves
    nn: torch.Tensor          # () i32 splits made
    done: torch.Tensor        # () bool a pass found nothing to split
    status: torch.Tensor      # (4,) i32
    work: Optional[torch.Tensor]    # int64, or None (CPU, sparse store)
    waves: Optional[torch.Tensor]   # () i32 waves that split; None under
    #                                 exact growth, where a pass that
    #                                 splits is a split (nn)


class Grower:
    """What the exact and the wave grower share: the bins X, feature
    metadata and static sizes, the state, the root and the status.  A
    subclass sets ``hist_cols`` (the histograms' columns) and
    ``slots`` (the most child slots a histogram call takes) and
    provides ``_child_hists``.  dtype: float32, or float64 under
    tpu_use_dp (the weights, histograms, best splits and tree values)."""

    sparse = False
    slots = 1
    counts_waves = False
    # whether a comm's ranks each hold a block of the rows (and then
    # their sums and exponents are global), or all of them
    shards_rows = True
    # the histogram engine: a kernel mode, or an XLA engine of
    # ENGINE_MODES (which needs no list workspace)
    hist_mode = "pallas"

    def __init__(self, X, meta: FeatureMeta, bundle, *, num_leaves: int,
                 num_bins: int, params: SplitParams, max_depth: int,
                 group_bins: int = 0, cache_hists: bool = True,
                 dtype=torch.float32, comm=None,
                 global_rows: Optional[int] = None, rank_rows=None):
        """comm: the ranks' HostComm (None, or one rank: serial growth),
        each rank holding a block of the rows (global_rows: their
        total; rank_rows: each rank's count, in rank order, its block
        the next in the rows' order); the histograms are the ranks' sum
        (data parallelism; the voting and feature arms are
        subclasses)."""
        self.X, self.meta, self.bundle = X, meta, bundle
        self.L = num_leaves
        self.num_bins = num_bins
        self.hist_bins = group_bins if bundle is not None else num_bins
        self.params, self.max_depth = params, max_depth
        self.cache_hists = cache_hists
        self.dtype = dtype
        self.comm = comm if comm is not None and comm.size > 1 else None
        self.row_comm = self.comm if self.shards_rows else None
        if self.row_comm is not None and self.sparse and rank_rows is None:
            raise ValueError("a sparse store over row-sharded ranks needs "
                             "rank_rows, each rank's row count")
        self.global_rows = global_rows
        self.rank_rows = None if rank_rows is None else tuple(rank_rows)

    @property
    def defer(self) -> bool:
        """Whether a data-parallel histogram all-reduces the kernels'
        fixed-point sums before their conversion: the dense kernels'
        f32 form.  The f64 form keeps 128-bit sums in two words, which a
        word-wise sum would not carry, so it all-reduces its finished
        float64 histograms (as the JAX package psums); so do the XLA
        engines and the plain versions, in the weights' dtype."""
        return (self.comm is not None and not self.sparse
                and self.hist_mode not in ENGINE_MODES
                and self.dtype != torch.float64)

    def _reduce_hist(self, compute, ids, exps):
        """compute(finish) -> this rank's histograms of leaves ids; under
        a comm the ranks' sum: the deferred-finish form's int64 sums
        all-reduced exactly, then ``finish_hist`` (two's-complement
        addition is exact and order-free, so every rank holds the serial
        kernel's histogram over all rows), or the finished histograms
        all-reduced."""
        if self.comm is None:
            return compute(True)
        return self._finish_reduced(compute(not self.defer), ids, exps)

    def _finish_reduced(self, out, ids, exps):
        """All-reduce a launch's output (sums, or a histogram) over the
        ranks, and convert it when it is the sums."""
        self.comm.all_reduce_(out)
        return finish_hist(out, ids, exps) if self.defer else out

    def exponents(self, w3):
        """The tree's fixed-point exponents: of the global row count and
        the all-reduced maximum of |w3| when the rows are sharded, so
        every rank holds the serial run's."""
        if self.row_comm is None:
            return fixed_point_exponents(w3)
        amax = (w3.abs().amax(dim=0) if w3.shape[0]
                else torch.zeros(3, dtype=w3.dtype, device=w3.device))
        self.row_comm.all_reduce_(amax, "max")
        # kept for the voting arm's conversions of its sums
        self.exps = fixed_point_exponents(w3, rows=self.global_rows,
                                          amax=amax)
        return self.exps

    def new_state(self, n: int, dev) -> GrowState:
        """Buffers for growing trees over n rows on dev (set by ``root``;
        the histogram cache starts zero, and a row a tree has not
        written is read only by masked-off slots)."""
        L, ft, i32 = self.L, self.dtype, torch.int32
        hists = (torch.zeros((L + 1, self.hist_cols, self.hist_bins, 3),
                             dtype=self._cache_dtype(dev), device=dev)
                 if self.cache_hists else torch.empty(0, device=dev))
        work = (list_workspace(n, self.slots, self.hist_cols,
                               self.hist_bins, dev, ft == torch.float64,
                               rowmajor=self.hist_mode == "pallas")
                if dev.type == "cuda" and not self.sparse
                and self.hist_mode not in ENGINE_MODES else None)
        return GrowState(
            leaf_id=torch.empty(n, dtype=i32, device=dev), hists=hists,
            bests=torch.empty((L + 1, SPLIT_VEC_SIZE), dtype=ft,
                              device=dev),
            tree=TreeArrays.new(L + 1, torch.zeros((), device=dev), ft,
                                dev),
            nn=torch.empty((), dtype=i32, device=dev),
            done=torch.empty((), dtype=torch.bool, device=dev),
            status=torch.empty(4, dtype=i32, device=dev), work=work,
            waves=(torch.empty((), dtype=i32, device=dev)
                   if self.counts_waves else None))

    def _cache_dtype(self, dev):
        """The dtype of the leaves' cached histograms: the grower's."""
        return self.dtype

    def _root_hists(self, st, lid, ids, w3, exps):
        """The root's histogram (one child slot): _child_hists'."""
        return self._child_hists(st, lid, ids, w3, exps)

    def tree_of(self, st: GrowState) -> TreeArrays:
        """The state's tree without its spare slots (views)."""
        return st.tree.head(self.L)

    def _best_of(self, hists_k, sums_k, depths_k, feature_mask):
        meta, bundle, sparse = self.meta, self.bundle, self.sparse
        return best_splits_batched(
            hists_k, sums_k, depths_k, meta, feature_mask, self.params,
            self.max_depth,
            hist_view=lambda h, s: feature_hist_view(h, s, meta, bundle,
                                                     fix_default=sparse))

    def root(self, st: GrowState, w3, exps, feature_mask) -> None:
        """Reset the state to the one-leaf tree of the weight rows w3 (N,
        3) and their fixed-point exponents exps: every row in leaf 0, its
        histogram (one child slot) and best split."""
        dev, i32 = w3.device, torch.int32
        st.leaf_id.zero_()
        root_sums = self._root_sums(w3)
        hist0 = self._root_hists(st, st.leaf_id,
                                 torch.zeros(1, dtype=i32, device=dev), w3,
                                 exps)[0]
        if self.cache_hists:
            st.hists[0] = hist0
        st.bests.fill_(-float("inf"))
        st.bests[0] = self._best_of(hist0[None], root_sums[None],
                                    torch.zeros(1, dtype=i32, device=dev),
                                    feature_mask)[0]
        st.tree.reset_(root_sums[2])
        st.nn.zero_()
        st.done.fill_(self.L <= 1)
        if st.waves is not None:
            st.waves.zero_()

    def _root_sums(self, w3):
        """(3,) the root's sums of the weight rows; with the rows sharded,
        over every rank's rows.  A dense store's histograms are summed
        from the rows alone, so the ranks' partial sums are all-reduced
        (3 floats a tree, as the JAX package psums).  A sparse store
        derives each feature's fill bin from the leaf's sums, so the
        rounding of a sum of partial sums would move every fill bin of
        the root, and near-ties with them; it gathers the ranks' weight
        rows in rank order (each padded to the largest block) and sums
        them as the one (N, 3) tensor the serial run sums, for the
        serial run's bits.  That costs O(N) a tree: every rank receives
        and holds 12 bytes for each row of every rank."""
        if self.row_comm is None:
            return w3.sum(dim=0)
        if not self.sparse:
            return self.row_comm.all_reduce_(w3.sum(dim=0))
        cap = max(self.rank_rows)
        padded = torch.zeros((cap, 3), dtype=w3.dtype, device=w3.device)
        padded[:w3.shape[0]] = w3
        parts = self.row_comm.all_gather(padded)
        return torch.cat([parts[r, :n] for r, n in
                          enumerate(self.rank_rows)]).sum(dim=0)

    def _done(self, st: GrowState):
        """() bool: the next pass can split nothing."""
        return st.done | (st.nn == self.L - 1)

    def write_status(self, st: GrowState) -> None:
        """st.status = (done, nn, deepest leaf, passes that split), for
        one read."""
        st.status.copy_(torch.stack([
            self._done(st).to(torch.int32), st.nn,
            st.tree.leaf_depth[:self.L].amax(),
            st.nn if st.waves is None else st.waves]))


class ExactGrower(Grower):
    """The exact (leaf-wise) grower of one learner: its row-major bins X
    (N, G) uint8 or uint16 (with packed_cols > 0, the 4-bit packed bins
    of that many columns, under the XLA engines only), feature metadata
    and static sizes; hist_mode 'pallas' (B5), 'onehot' or 'scatter'.

    ``split`` is the body of the JAX package's ``lax.while_loop``: the
    leaf of largest gain (the first, as ``jnp.argmax``), its rows
    routed, the tree recorded, the smaller child's histogram from B5 and
    the larger's by parent subtraction, and the children's best splits --
    every write gated on ``ok`` (a positive gain within the leaf budget)
    through the spare slots, so a split that is not ok is an exact no-op
    on the state, and nothing reads the device: a fixed number of splits
    can run unread (``ops/fused_iter.py`` replays them as CUDA graphs)."""

    def __init__(self, X, meta: FeatureMeta, bundle, *,
                 hist_mode: str = "pallas", packed_cols: int = 0, **kw):
        # the coordinate sparse store (JAX hist_mode 'sparse')
        self.sparse = isinstance(X, SparseDeviceStore)
        super().__init__(X, meta, bundle, **kw)
        self.hist_mode = hist_mode
        self.packed_cols = 0 if self.sparse else int(packed_cols)
        self.hist_cols = (X.num_cols if self.sparse
                          else self.packed_cols or X.shape[1])

    def _child_hists(self, st, lid, ids, w3, exps):
        """B5, the XLA engine or the coordinate store's segment sum: the
        (1, G, B, 3) histogram of the rows in leaf ids, a (1,) device
        tensor (-1: no row, a zero histogram); all ranks' rows under the
        data-parallel learner."""
        if self.sparse:
            return sparse_leaf_hist(self.X, lid, w3, ids, self.hist_bins,
                                    self.hist_cols, exps,
                                    comm=self.row_comm)[None]
        if self.hist_mode in ENGINE_MODES:
            return self._reduce_hist(lambda finish: engine_histogram(
                self.hist_mode, self.X, lid, w3, ids.to(torch.int32),
                self.hist_bins, exps, self.packed_cols), ids, exps)

        def b5(finish):
            h = leaf_histogram(self.X, None, None, lid, ids, None,
                               self.hist_bins, w3=w3, exps=exps,
                               work=st.work, finish=finish)
            # the deferred form's int64 sums are (1, G, B, 3) already
            return h if h.dtype == torch.int64 else h[None]
        return self._reduce_hist(b5, ids.to(torch.int32), exps)

    def _go_left(self, sp: SplitFields, n: int):
        """(N,) bool: the rows that go left at split sp (dense_bin.hpp:
        190-222): its column, remapped out of its EFB group, against the
        threshold, the default bin routed by default_left."""
        bundle = self.bundle
        f = sp.feature
        j = f if bundle is None else bundle.group_of[f].long()
        col = self._split_column(j, n)
        if bundle is not None:
            goff, span, adj = (a[f] for a in (
                bundle.bin_off, bundle.bin_span, bundle.bin_adj))
            col = torch.where((col >= goff) & (col < goff + span),
                              col - goff + adj, sp.fdef)
        go_left = torch.where(sp.is_cat, col == sp.threshold,
                              col <= sp.threshold)
        return torch.where(col == sp.fdef, sp.dleft, go_left)

    def _split_column(self, j, n: int):
        """(N,) int32: each of the n rows' bin in device column j, a (1,)
        long tensor (its nibble when packed; from the store's entries on
        the coordinate store)."""
        if self.sparse:
            return sparse_split_column(self.X, j, n)
        Xi = indexable(self.X)
        if not self.packed_cols:
            return bins_i32(Xi.index_select(1, j)[:, 0])
        p, high = packed_column(j, self.packed_cols)
        return nibble(bins_i32(Xi.index_select(1, p)[:, 0]), high)

    def split(self, st: GrowState, w3, exps, feature_mask) -> None:
        """One gated split (SerialTreeLearner::Train, :203-207): split the
        leaf of largest gain if its gain is positive and the tree has
        room, with no host read."""
        L = self.L
        i32 = torch.int32
        bl = torch.argmax(st.bests[:L, GAIN]).reshape(1)   # (1,) long
        info = st.bests.index_select(0, bl)                # (1, V)
        ok = (info[:, GAIN] > 0.0) & (st.nn < L - 1)       # (1,)
        node = st.nn.long().reshape(1)
        new_leaf = node + 1
        sp = SplitFields.of(info, self.meta)

        # ---- partition (dense_bin.hpp:190-222): the split column,
        # remapped out of its EFB group, routes the leaf's rows
        go_left = self._go_left(sp, st.leaf_id.shape[0])
        st.leaf_id.copy_(torch.where(ok & (st.leaf_id == bl.to(i32))
                                     & ~go_left, new_leaf.to(i32),
                                     st.leaf_id))

        # ---- tree bookkeeping
        depth1 = st.tree.leaf_depth[bl] + 1               # (1,)
        record_splits(st.tree, bl, new_leaf, node, ok, info, sp, depth1)

        # ---- children: the smaller scanned (B5), the larger by parent
        # subtraction, or scanned when the cache is off; a split that is
        # not ok scans no row
        left_small = info[:, LEFT_COUNT] < info[:, RIGHT_COUNT]   # (1,)
        pair = torch.cat([bl, new_leaf])                   # (left, right)
        ok2 = ok.expand(2)
        sl = torch.where(left_small, pair, pair.flip(0))   # small, large
        scan = torch.where(ok2, sl, -1).to(i32)
        hist_small = self._child_hists(st, st.leaf_id, scan[:1], w3,
                                       exps)[0]
        if self.cache_hists:
            hist_large = st.hists.index_select(0, bl)[0] - hist_small
        else:
            hist_large = self._child_hists(st, st.leaf_id, scan[1:], w3,
                                           exps)[0]
        hists2 = torch.stack([hist_small, hist_large])
        lr_sums = torch.stack([info[0, LEFT_SUM_G:LEFT_COUNT + 1],
                               info[0, RIGHT_SUM_G:RIGHT_COUNT + 1]])
        sums2 = torch.where(left_small, lr_sums, lr_sums.flip(0))
        if self.cache_hists:
            _put(st.hists, sl, ok2, hists2)
        _put(st.bests, sl, ok2, self._best_of(hists2, sums2,
                                              depth1.expand(2),
                                              feature_mask))
        st.nn.add_(ok[0].to(i32))
        st.done.logical_or_(~ok[0])

    def _done(self, st: GrowState):
        """() bool: done once a split found no positive gain, the tree is
        full or no leaf has a positive gain (the next split could not
        commit)."""
        return super()._done(st) | ~(st.bests[:self.L, GAIN] > 0.0).any()


class VotingGrower(ExactGrower):
    """The voting-parallel arm of exact growth (PV-Tree,
    voting_parallel_tree_learner.cpp:164-300; JAX ``ops/grow.py``
    ``best_of_voting``): the rows are sharded as under the data-parallel
    learner, but a leaf's histogram stays this rank's.  Each rank
    proposes its top_k features by gain (less its own gain shift)
    weighted by its share of the leaf's rows, with min_data_in_leaf and
    min_sum_hessian_in_leaf divided by the number of ranks; a ``max``
    all-reduce of the (F,) proposals and the global top_k pick the
    features whose histograms, alone, are summed over the ranks; the
    split is the best of those.  Equal to data-parallel growth when
    top_k covers every feature."""

    def __init__(self, X, meta, bundle, *, voting_k: int, **kw):
        super().__init__(X, meta, bundle, **kw)
        self.voting_k = int(voting_k)
        machines = self.comm.size if self.comm is not None else 1
        self.machines = machines
        p = self.params
        self.local_params = p._replace(
            min_data_in_leaf=p.min_data_in_leaf / machines,
            min_sum_hessian_in_leaf=p.min_sum_hessian_in_leaf / machines)

    @property
    def defer(self) -> bool:
        """The dense kernels' int64 sums stand for the leaves' histograms
        without an EFB layout (whose per-feature view rebuilds the
        default bin from float totals); with one, the f32 histograms."""
        return super().defer and self.bundle is None

    def _reduce_hist(self, compute, ids, exps):
        """A leaf's histogram stays this rank's: its unconverted sums
        where they can be added exactly (a copy: the sums live in the
        workspace the next launch reuses)."""
        if self.comm is None:
            return compute(True)
        out = compute(not self.defer)
        return out.clone() if self.defer else out

    def _cache_dtype(self, dev):
        """On the card the leaves' unconverted int64 sums are cached (a
        larger child is the parent's less the smaller's, exactly)."""
        return (torch.int64 if self.defer and dev.type == "cuda"
                else self.dtype)

    def _best_of(self, hists_k, sums_k, depths_k, feature_mask):
        """The K leaves' votes and their selected histograms each travel
        in one collective (a (K, F) max, a (K, k, B, 3) sum).  On the
        card hists_k holds the kernels' int64 sums: the proposals read
        their conversion, and the selected features' sums are added over
        the ranks exactly and then converted, so a selected histogram is
        the serial kernel's to the bit; elsewhere the f32 histograms are
        summed."""
        meta, bundle = self.meta, self.bundle
        ninf = -float("inf")
        exact = hists_k.dtype == torch.int64
        slots = torch.arange(hists_k.shape[0], dtype=torch.int32,
                             device=hists_k.device)
        local = finish_hist(hists_k, slots, self.exps) if exact else hists_k
        # each rank's leaf totals: one column's bins hold every row
        local_sums = local[:, 0].sum(dim=1)                   # (K, 3)
        hist = feature_hist_view(local, local_sums, meta, bundle)
        K, F = hist.shape[0], hist.shape[1]
        k = min(self.voting_k, F)
        cand, _, _, _, shift = per_feature_candidates(
            hist, local_sums, meta, self.local_params)
        gains = (cand.gain - shift[:, None]).masked_fill(
            ~feature_mask[None, :], ninf)                     # (K, F)
        mean_cnt = torch.clamp(sums_k[:, 2] / self.machines, min=1.0)
        weighted = gains * (local_sums[:, 2] / mean_cnt)[:, None]
        weighted = torch.where(torch.isfinite(gains), weighted,
                               torch.full_like(weighted, ninf))
        kth = torch.topk(weighted, k, dim=1).values[:, -1:]
        proposal = torch.where(weighted >= kth, weighted,
                               torch.full_like(weighted, ninf))
        self.comm.all_reduce_(proposal, "max")
        sel = torch.sort(proposal, dim=1, descending=True,
                         stable=True).indices[:, :k]          # (K, k)
        src = hists_k if exact else hist
        hist_sel = torch.gather(
            src, 1, sel[:, :, None, None].expand(-1, -1, *src.shape[2:])
        ).contiguous()                                        # (K, k, B, 3)
        self.comm.all_reduce_(hist_sel)
        if exact:
            hist_sel = finish_hist(hist_sel, slots, self.exps)
        out = []
        for i in range(K):
            si = sel[i]
            sub = FeatureMeta(num_bin=meta.num_bin[si],
                              default_bin=meta.default_bin[si],
                              is_categorical=meta.is_categorical[si])
            b = find_best_splits(hist_sel[i:i + 1], sums_k[i:i + 1], sub,
                                 feature_mask[si], self.params)
            fl = b[:, FEATURE].long().clamp(0, k - 1)
            b[:, FEATURE] = si[fl].to(b.dtype)
            sf = b[:, SECOND_FEATURE]
            b[:, SECOND_FEATURE] = torch.where(
                sf >= 0, si[sf.long().clamp(0, k - 1)].to(b.dtype), sf)
            out.append(b)
        return depth_gate(torch.cat(out), depths_k, self.max_depth)


class FeatureParallelGrower(ExactGrower):
    """The feature-parallel arm of exact growth
    (feature_parallel_tree_learner.cpp:52-76; JAX ``ops/grow.py``
    ``best_of_feature_parallel``): every rank holds all rows of a
    contiguous block of features (X (N, F_local) row-major, features
    [offset, offset + F_local) of the padded F; padded features take one
    bin and never split).  A rank finds the best split of its block; an
    all-gather of the packed splits and a strict-``>`` fold over the ranks
    (the earlier rank keeps a tie: the smaller feature index, as
    SplitInfo::MaxReducer) pick the global one, and the rank that owns its
    feature computes the rows' go-left mask, which a ``max`` all-reduce
    hands to every rank.  ``meta`` is the padded global metadata,
    ``local_meta`` the block's."""

    # every rank holds all rows: its sums and exponents are the serial
    # ones, and its histograms (of its own features) are its own
    shards_rows = False

    def __init__(self, X, meta, bundle, *, local_meta: FeatureMeta,
                 feature_offset: int, **kw):
        super().__init__(X, meta, bundle, **kw)
        self.local_meta = local_meta
        self.offset = int(feature_offset)

    def _reduce_hist(self, compute, ids, exps):
        return compute(True)

    def _best_of(self, hists_k, sums_k, depths_k, feature_mask):
        lo, fl = self.offset, self.hist_cols
        b = find_best_splits(hists_k, sums_k, self.local_meta,
                             feature_mask[lo:lo + fl], self.params)
        b[:, FEATURE] += lo
        sf = b[:, SECOND_FEATURE]
        b[:, SECOND_FEATURE] = torch.where(sf >= 0, sf + lo, sf)
        gathered = self.comm.all_gather(b)               # (R, K, V)
        best = gathered[0]
        for other in gathered[1:]:
            take = other[:, GAIN] > best[:, GAIN]
            win = torch.where(take[:, None], other, best)
            lose = torch.where(take[:, None], best, other)
            # merged runner-up: the loser's winner competes with the
            # winner's own runner-up
            use = (torch.isfinite(lose[:, GAIN]) & (lose[:, GAIN] > 0.0)
                   & (lose[:, GAIN] > win[:, SECOND_GAIN]))
            win[:, SECOND_GAIN] = torch.where(use, lose[:, GAIN],
                                              win[:, SECOND_GAIN])
            win[:, SECOND_FEATURE] = torch.where(use, lose[:, FEATURE],
                                                 win[:, SECOND_FEATURE])
            best = win
        return depth_gate(best.clone(), depths_k, self.max_depth)

    def _go_left(self, sp: SplitFields, n: int):
        lo, fl = self.offset, self.hist_cols
        f = sp.feature
        own = (f >= lo) & (f < lo + fl)
        col = self._split_column((f - lo).clamp(0, fl - 1), n)
        go_left = torch.where(sp.is_cat, col == sp.threshold,
                              col <= sp.threshold)
        go_left = torch.where(col == sp.fdef, sp.dleft, go_left)
        mask = (go_left & own).to(torch.uint8)
        self.comm.all_reduce_(mask, "max")
        return mask > 0


def exact_grower_class(parallel: str, comm):
    """The exact grower of a learner: voting and feature parallelism
    have arms of their own; data parallelism is ExactGrower's comm."""
    if comm is None or comm.size <= 1:
        return ExactGrower
    return {"voting": VotingGrower,
            "feature": FeatureParallelGrower}.get(parallel, ExactGrower)


def grow_tree_exact(X, grad, hess, row_mult, feature_mask, meta: FeatureMeta,
                    bundle, *, num_leaves: int, num_bins: int,
                    params: SplitParams, max_depth: int, group_bins: int = 0,
                    cache_hists: bool = True, hist_mode: str = "pallas",
                    packed_cols: int = 0, dtype=torch.float32, comm=None,
                    parallel: str = "data", **dist_kw):
    """Grow one tree leaf-wise, staged: an ExactGrower's gated split with
    one host read a batch of splits certain to commit.  X: (N, G) uint8
    or uint16 row-major bins; grad/hess/row_mult: (N,) in dtype (float32,
    or float64 under tpu_use_dp); hist_mode and packed_cols as for
    ExactGrower.  Returns (TreeArrays, leaf_id (N,) int32, GrowStats).

    A split consumes the one leaf it splits and puts its two children in
    its place, so the count of leaves with a positive gain drops by at
    most one a split.  One host read of that count P therefore lets the
    next min(P, budget) splits run unread, each certain to commit (its
    gate always true); a further read when they are done, and the loop
    stops when P is 0 or the tree is full.

    comm, parallel ('data', 'voting', 'feature') and dist_kw
    (global_rows; voting_k; local_meta and feature_offset): the
    distributed arms (``exact_grower_class``).  The
    ranks hold the same best splits, so they read the same counts and
    make the same collectives."""
    L = num_leaves
    cls = exact_grower_class(parallel, comm)
    if cls is ExactGrower:
        dist_kw = {k: dist_kw.get(k) for k in ("global_rows",
                                                 "rank_rows")}
    g = cls(X, meta, bundle, num_leaves=L, num_bins=num_bins,
            params=params, max_depth=max_depth, group_bins=group_bins,
            cache_hists=cache_hists, hist_mode=hist_mode,
            packed_cols=packed_cols, dtype=dtype, comm=comm, **dist_kw)
    st = g.new_state(grad.shape[0], grad.device)
    # B5's weight rows and fixed-point exponents, once a tree as the wave
    # grower makes them: every leaf histogram of the tree, and wave
    # growth's at width 1, then sums the same rows to the same bits
    w3 = weight_rows(grad, hess, row_mult)
    exps = g.exponents(w3)
    g.root(st, w3, exps, feature_mask)
    nn = host_reads = 0
    while True:
        # the one host read of a batch: leaves with a positive gain, and
        # the deepest leaf so far
        host = torch.stack([  # lint: ignore[sync-tolist] the batch's read
            (st.bests[:L, GAIN] > 0.0).sum().to(torch.int32),
            st.tree.leaf_depth[:L].max()]).tolist()
        host_reads += 1
        pending, depth = int(host[0]), int(host[1])
        if pending == 0 or nn == L - 1:
            break
        for _ in range(min(pending, L - 1 - nn)):
            g.split(st, w3, exps, feature_mask)
            nn += 1
    stats = GrowStats(num_leaves=nn + 1, depth=depth, passes=nn,
                      host_reads=host_reads)
    return g.tree_of(st), st.leaf_id, stats
