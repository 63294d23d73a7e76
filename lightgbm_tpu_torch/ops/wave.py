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
a function over explicit state (``ops/grow.py GrowState``: leaf ids, the
histogram cache, the per-leaf best splits, the tree, and device scalars
for the split count, the stop flag and the waves done) that writes in
place and commits every split through a mask, the JAX package's
drop-index scatters becoming writes to a spare slot past the end of each
array; the tree bookkeeping is exact growth's (``record_splits``).  A
wave whose slots are all invalid is an exact no-op on the state, and no
call of the body reads the device, so a fixed number of waves can run
unread (``ops/fused_iter.py`` replays them as CUDA graphs).
``grow_tree`` is the staged driver: the same body, with one host read a
wave (the count of valid splits, the k == 0 stop test, and the depth the
wave leaves) between its selection and its commit.

Under ``tpu_wave_order=exact`` (the JAX package's exact-order waves) a
wave commits only the prefix of its candidates that the leaf-wise order
would split before any child made earlier in the same wave, and sends
the rows routed to the other candidates' right children back to their
parents; the fixed-point histograms do not depend on the slot, so the
trees equal exact growth's (``ops/grow.py``) at any width.

With ``tpu_histogram_mode=onehot`` or ``scatter`` the bins are
row-major, the partition is the plain routing and every histogram comes
from the JAX package's XLA engine of that name (``ops/histogram.py
engine_histogram``: the (C, W) child-match contraction of its wave
engine, or per-feature integer scatters), the root's included.  The
bins may be uint16 (more than 256 bins a column) on every dense path,
and under ``tpu_use_dp`` the weights, histograms, best splits and the
tree's values are float64: the kernels run their f64 form.

On the entry-chunk sparse store (``ops/sparse_mxu.py``, the JAX
package's ``sparse_mxu`` engine) every histogram -- the root's one slot,
each wave's smaller children and the no-cache larger children -- comes
from kernel B6, in the same fixed point with the same exponents
(``sparse_wave_histogram``); on the coordinate store
(``ops/sparse_store.py``, its ``sparse`` engine) from one integer segment
sum over the entries with the W children's slot table and a drop segment
for the rows in no slot (``sparse_wave_hists``, plain torch, as the JAX
package sums it outside any kernel), to the same bits.  On either store
the partition reads only the entries of the W split columns through the
store's static window (``sparse_route_rows``, plain torch), and the
histogram view rebuilds the fill-bin slots the store never holds
(``fix_default``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .grow import (GrowState, GrowStats, Grower, SplitFields, _put,
                   record_splits)
from .histogram import ENGINE_MODES, engine_histogram, weight_rows
from .split_finder import (GAIN, LEFT_COUNT, LEFT_SUM_G, LEFT_SUM_H,
                           RIGHT_COUNT, RIGHT_SUM_G, RIGHT_SUM_H,
                           FeatureMeta, SplitParams)
from .sparse_mxu import (ChunkedSparseStore, sparse_route_rows,
                         sparse_wave_histogram)
from .sparse_store import (SparseDeviceStore, sparse_leaf_hist,
                           sparse_wave_hists)
from .wave_kernels import (fixed_point_exponents, route_rows_plain,
                           route_rows_rowmajor, wave_histogram,
                           wave_histogram_rowmajor, wave_partition_hist)


def _stable_topk(gains, W):
    """Top-W of gains, ties broken by lower index (lax.top_k's order)."""
    vals, idx = torch.sort(gains, descending=True, stable=True)
    return vals[:W], idx[:W]


class Pick(NamedTuple):
    """A wave's selection: the top-W leaves and their gains, which of
    them split, their count and the deepest leaf once they have."""
    parent: torch.Tensor      # (W,) long leaf ids, gains descending
    gain: torch.Tensor        # (W,) f32 their gains
    valid: torch.Tensor       # (W,) bool, a prefix
    k: torch.Tensor           # () i32
    depth: torch.Tensor       # () i32


class WaveGrower(Grower):
    """The wave grower of one learner: its bins (X: (G, N) uint8
    transposed, (N, G) row-major for hist_mode 'pallas', a
    ChunkedSparseStore or a SparseDeviceStore), feature metadata and
    static sizes.

    hist_mode 'pallas_ct' fuses the partition and the smaller children's
    histograms (B1); 'pallas_t' is the JAX package's dataflow of that
    name, the partition as plain tensor ops and the histograms through
    B3; 'pallas' is the same on the row-major bins, through B4.  The
    mode has no meaning on the sparse store.

    wave_order 'batched' commits every valid slot of a wave; 'exact'
    commits the prefix of slots that the leaf-wise order would split
    before any child made earlier in the wave (``_exact_prefix``), and
    rolls the rest back, so the trees equal exact growth's at any
    width.

    hist_mode 'onehot' and 'scatter' are the JAX package's XLA engines on
    the row-major bins, with the plain routing.

    packed_cols > 0: X holds the 4-bit packed bins of that many columns
    (ops/pack.py), which every kernel and the plain routing unpack;
    hilo=False: the single bf16 product in every wave histogram (the
    dense root stays unrounded, as the JAX package's one-hot root); the
    f64 form (dtype float64) and the XLA engines sum unrounded weights,
    as the JAX package's f64 and XLA paths do."""

    counts_waves = True

    def __init__(self, X, meta: FeatureMeta, bundle, *, wave_width: int,
                 hist_mode: str = "pallas_ct", wave_order: str = "batched",
                 packed_cols: int = 0, hilo: bool = True, **kw):
        self.sparse = isinstance(X, (ChunkedSparseStore, SparseDeviceStore))
        super().__init__(X, meta, bundle, **kw)
        self.exact_order = wave_order == "exact"
        self.W = max(1, min(wave_width, self.L - 1))
        self.slots = self.W
        self.hist_mode = hist_mode
        # the coordinate store: plain torch segment sums, no kernel
        self.coord = isinstance(X, SparseDeviceStore)
        self.packed_cols = 0 if self.sparse else int(packed_cols)
        self.engine = hist_mode in ENGINE_MODES and not self.sparse
        self.rowmajor = hist_mode == "pallas" or self.engine
        self.hilo = (bool(hilo) or self.dtype == torch.float64
                     or self.engine)
        if self.sparse:
            self.hist_cols = X.num_cols
        else:
            self.hist_cols = (self.packed_cols
                              or X.shape[1 if self.rowmajor else 0])

    def _child_hists(self, st, lid, ids, w3, exps, hilo=None):
        """The (K, G, B, 3) histograms of the leaves ids (B3, B4 or B6),
        in the grower's precision unless hilo says otherwise; all ranks'
        rows under the data-parallel learner (``_reduce_hist``)."""
        hilo = self.hilo if hilo is None else hilo
        if self.coord:
            return sparse_wave_hists(self.X, lid, w3, ids, self.hist_bins,
                                     self.X.num_cols, self.L, exps=exps,
                                     comm=self.row_comm)
        if self.sparse:
            return sparse_wave_histogram(self.X, lid, w3, ids,
                                         self.hist_bins, self.X.num_cols,
                                         exps=exps, hilo=hilo)
        if self.engine:
            return self._reduce_hist(lambda finish: engine_histogram(
                self.hist_mode, self.X, lid, w3, ids, self.hist_bins, exps,
                self.packed_cols), ids, exps)
        kernel = (wave_histogram_rowmajor if self.hist_mode == "pallas"
                  else wave_histogram)
        return self._reduce_hist(lambda finish: kernel(
            self.X, lid, w3, ids, self.hist_bins, exps=exps, work=st.work,
            logical_cols=self.packed_cols, hilo=hilo, finish=finish), ids,
            exps)

    def _root_hists(self, st, lid, ids, w3, exps):
        """The root's histogram: the JAX package takes the dense root
        from its f32 one-hot engine, whatever the precision of the wave
        kernels, the entry-chunk store's root from the sparse kernel in
        it, and the coordinate store's from ``leaf_histogram_sparse``."""
        if self.coord:
            return sparse_leaf_hist(self.X, lid, w3, ids, self.hist_bins,
                                    self.X.num_cols, exps,
                                    comm=self.row_comm)[None]
        return self._child_hists(st, lid, ids, w3, exps,
                                 hilo=self.hilo if self.sparse else True)

    # --------------------------------------------------------------- wave
    def pick(self, st: GrowState) -> Pick:
        """The top-W leaves by gain and which of them split (a positive
        gain, within the leaf budget); depth counts every valid slot,
        which under exact order may not all commit."""
        L, W = self.L, self.W
        gw, parent = _stable_topk(st.bests[:L, GAIN], W)
        rank = torch.arange(W, dtype=torch.long, device=gw.device)
        valid = (gw > 0.0) & (rank < (L - 1) - st.nn)
        depth = st.tree.leaf_depth[:L]
        grown = torch.where(valid, depth[parent] + 1, 0).amax()
        return Pick(parent, gw, valid, valid.sum().to(torch.int32),
                    torch.maximum(depth.amax(), grown))

    def _exact_prefix(self, p: Pick, bests_k, small_id, large_id):
        """(commit (W,) bool, kc () i32): the leaf-wise order splits the
        candidates in rank order until a child made earlier in the wave
        outranks the next one -- a larger gain, or an equal gain and a
        smaller leaf id (the first maximum, as the argmax of exact
        growth) -- so commit the valid slots before that one."""
        W, dev = self.W, bests_k.device
        sg, lg = bests_k[:W, GAIN], bests_k[W:, GAIN]
        ninf = torch.full_like(sg, -float("inf"))
        cg = torch.where(p.valid, torch.maximum(sg, lg), ninf)
        # the leaf id of each candidate's better child (ties: smaller id)
        cid = torch.where((sg > lg) | ((sg == lg) & (small_id <= large_id)),
                          small_id, large_id)
        # the best child over the candidates before each one: a (W, W)
        # table, row t over the columns j < t
        rank = torch.arange(W, device=dev)
        before = rank[None, :] < rank[:, None]
        mx = torch.where(before, cg[None, :], ninf[None, :]).amax(dim=1)
        mid = torch.where(before & (cg[None, :] == mx[:, None]),
                          cid[None, :], self.L + 1).amin(dim=1)
        stop = (mx > p.gain) | ((mx == p.gain) & (mid < p.parent))
        kc = torch.minimum((~stop).to(torch.int32).cumprod(0).sum(), p.k)
        return rank < kc, kc.to(torch.int32)

    def commit(self, st: GrowState, p: Pick, w3, exps, feature_mask):
        """Split the valid leaves of pick p (under exact order, the
        committed prefix of them): route their rows, build the
        children's histograms and best splits, and record the splits in
        the tree -- every write masked, so a pick with no valid slot
        changes nothing."""
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

        sp = SplitFields.of(info, meta)
        f_w = sp.feature
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
            sp.threshold.to(f32),                      # 2: threshold bin
            sp.is_cat.to(f32),                         # 3: categorical
            sp.fdef.to(f32),                           # 4: default bin
            sp.dleft.to(f32),                          # 5: default left
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
            hist_small = self._child_hists(st, lid, cid, w3, exps)
        elif self.hist_mode == "pallas_ct":
            lid, hist_small = wave_partition_hist(
                X, st.leaf_id, w3, cid, cols, psrc, self.hist_bins,
                bundled=bundled, exps=exps, work=st.work,
                logical_cols=self.packed_cols, hilo=self.hilo,
                finish=not self.defer)
            if self.comm is not None:
                # the ranks' W smaller children, summed once a wave
                hist_small = self._finish_reduced(hist_small, cid, exps)
        else:
            route = (route_rows_rowmajor if self.rowmajor
                     else route_rows_plain)
            lid = route(X, st.leaf_id, cols, psrc, bundled,
                        logical_cols=self.packed_cols)
            hist_small = self._child_hists(st, lid, cid, w3, exps)
        st.leaf_id.copy_(lid)
        if self.cache_hists:
            hist_large = st.hists[parent] - hist_small
        else:
            hist_large = self._child_hists(
                st, st.leaf_id, torch.where(valid, large_id, -1).to(i32), w3,
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
        bests_k = self._best_of(torch.cat([hist_small, hist_large]),
                                torch.cat([small_sums, large_sums]),
                                torch.cat([depth, depth]),
                                feature_mask)               # (2W, V)

        if self.exact_order:
            # the leaf-wise prefix; the rows routed to the right child of
            # a valid slot that does not commit go back to its parent:
            # one gather over the leaf ids through an (L + 1) remap, no
            # pass over the bins (its histograms are dropped below)
            commit, k = self._exact_prefix(p, bests_k, small_id, large_id)
            remap = torch.arange(L + 1, dtype=i32, device=dev)
            _put(remap, newleaf, valid & ~commit, parent.to(i32))
            st.leaf_id.copy_(remap.index_select(0, st.leaf_id))
        else:
            commit = valid

        # ---- masked commit: other slots write the spare slots
        if self.cache_hists:
            _put(st.hists, small_id, commit, hist_small)
            _put(st.hists, large_id, commit, hist_large)
        _put(st.bests, small_id, commit, bests_k[:W])
        _put(st.bests, large_id, commit, bests_k[W:])

        # ---- tree bookkeeping for the committed splits
        record_splits(tree, parent, newleaf, node, commit, info, sp, depth)
        st.nn.add_(k)
        st.done.copy_((k == 0) | (st.nn == L - 1))
        st.waves.add_((k > 0).to(i32))

    def wave(self, st: GrowState, w3, exps, feature_mask) -> None:
        """One masked wave: pick, then commit, with no host read."""
        self.commit(st, self.pick(st), w3, exps, feature_mask)


def grow_tree(X, grad, hess, row_mult, feature_mask, meta: FeatureMeta,
              bundle, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int, wave_width: int,
              group_bins: int = 0, cache_hists: bool = True,
              hist_mode: str = "pallas_ct", wave_order: str = "batched",
              packed_cols: int = 0, hilo: bool = True,
              dtype=torch.float32, comm=None, global_rows=None,
              rank_rows=None):
    """Grow one tree, staged: a WaveGrower's body with one host read a
    wave.  X: (G, N) uint8 or uint16 transposed bins, (N, G) row-major
    bins for hist_mode 'pallas', 'onehot' and 'scatter' (with
    packed_cols > 0, 4-bit packed: ceil(G / 2) stored columns), or a
    sparse store; grad/hess/row_mult: (N,) in dtype (float32, or
    float64 under tpu_use_dp); hilo=False: the single bf16 product.
    Returns (TreeArrays, leaf_id (N,) int32, GrowStats).

    The read comes between a wave's selection and its commit: the count
    of valid slots (k == 0 ends the tree) and, under batched order, the
    depth once they have split; under exact order, where not every valid
    slot commits, the splits and depth the state holds (its status).

    comm (global_rows the ranks' rows, rank_rows each rank's): the
    data-parallel waves of the JAX package (its ops/wave.py:598-722):
    the root sums and histogram, the W smaller children once a wave and
    the larger children where no cached parent gives them are summed
    over the ranks; every rank then picks and commits the same splits
    and routes its own rows."""
    g = WaveGrower(X, meta, bundle, num_leaves=num_leaves,
                   num_bins=num_bins, params=params, max_depth=max_depth,
                   wave_width=wave_width, group_bins=group_bins,
                   cache_hists=cache_hists, hist_mode=hist_mode,
                   wave_order=wave_order, packed_cols=packed_cols, hilo=hilo,
                   dtype=dtype, comm=comm, global_rows=global_rows,
                   rank_rows=rank_rows)
    st = g.new_state(grad.shape[0], grad.device)
    w3 = weight_rows(grad, hess, row_mult)                 # (N, 3)
    # the kernels' fixed-point exponents (B1, B3, B4, B6): w3 is fixed
    # within the tree, so the root and every child carry the same scale
    # (under a comm, of the ranks' rows: Grower.exponents)
    exps = (fixed_point_exponents(w3) if g.row_comm is None
            else g.exponents(w3))
    g.root(st, w3, exps, feature_mask)
    nn = depth = waves = host_reads = 0
    while nn < num_leaves - 1:
        p = g.pick(st)
        if g.exact_order:
            g.write_status(st)
            k, nn, depth = torch.cat(  # lint: ignore[sync-tolist] wave read
                [p.k[None], st.status[1:3]]).tolist()
        else:
            # the one host read per wave: valid count + the depth after it
            k, depth = torch.stack(  # lint: ignore[sync-tolist] wave read
                [p.k, p.depth]).tolist()
        host_reads += 1
        if k == 0:
            break
        g.commit(st, p, w3, exps, feature_mask)
        waves += 1
        if not g.exact_order:
            nn += k
    stats = GrowStats(num_leaves=nn + 1, depth=depth, passes=waves,
                      host_reads=host_reads)
    return g.tree_of(st), st.leaf_id, stats
