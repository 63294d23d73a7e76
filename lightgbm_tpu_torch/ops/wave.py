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
and the three dataflows grow the same trees to the byte.  The JAX
package's ``lax.while_loop`` is a Python loop here with ONE host read per
wave: the number of valid splits (the k == 0 stop test) together with
the chosen parent ids, from which the host tracks leaf depths.

On the entry-chunk sparse store (``ops/sparse_mxu.py``, the JAX
package's ``sparse_mxu`` engine) every histogram -- the root's one slot,
each wave's smaller children and the no-cache larger children -- comes
from kernel B6, in the same fixed point with the same exponents
(``sparse_wave_histogram``); the partition reads only the entries of the W
split columns (``sparse_route_rows``, plain torch), and the histogram view
rebuilds the fill-bin slots the store never holds (``fix_default``).
"""
from __future__ import annotations

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


def _put_where(dst, idx, mask, val):
    """dst[idx[mask]] = val[mask] without a boolean index, which would read
    the mask's count back to the host: the unmasked writes land in a spare
    slot past the end."""
    buf = torch.cat([dst, dst.new_zeros(1)])
    buf[torch.where(mask, idx, torch.full_like(idx, dst.shape[0]))] = val
    dst.copy_(buf[:-1])


def _stable_topk(gains, W):
    """Top-W of gains, ties broken by lower index (lax.top_k's order)."""
    vals, idx = torch.sort(gains, descending=True, stable=True)
    return vals[:W], idx[:W]


def grow_tree(X, grad, hess, row_mult, feature_mask, meta: FeatureMeta,
              bundle, *, num_leaves: int, num_bins: int,
              params: SplitParams, max_depth: int, wave_width: int,
              group_bins: int = 0, cache_hists: bool = True,
              hist_mode: str = "pallas_ct"):
    """Grow one tree.  X: (G, N) uint8 transposed bins, (N, G) row-major
    bins for hist_mode 'pallas', or a ChunkedSparseStore; grad/hess/
    row_mult: (N,) f32.  Returns (TreeArrays, leaf_id (N,) int32,
    GrowStats).

    hist_mode 'pallas_ct' fuses the partition and the smaller children's
    histograms (B1); 'pallas_t' is the JAX package's dataflow of that
    name, the partition as plain tensor ops and the histograms through
    B3; 'pallas' is the same on the row-major bins, through B4.  The
    mode has no meaning on the sparse store."""
    L = num_leaves
    W = max(1, min(wave_width, L - 1))
    hist_bins = group_bins if bundle is not None else num_bins
    dev = grad.device
    f32, i32 = torch.float32, torch.int32
    n = grad.shape[0]
    sparse = isinstance(X, ChunkedSparseStore)
    w3 = weight_rows(grad, hess, row_mult)                 # (N, 3)
    leaf_id = torch.zeros(n, dtype=i32, device=dev)
    # the kernels' fixed-point exponents (B1, B3, B4, B6): w3 is fixed
    # within the tree, so the root and every child carry the same scale
    exps = fixed_point_exponents(w3)

    def child_hists(lid, ids):
        if sparse:
            return sparse_wave_histogram(X, lid, w3, ids, hist_bins,
                                         X.num_cols, exps=exps)
        if hist_mode == "pallas":
            return wave_histogram_rowmajor(X, lid, w3, ids, hist_bins,
                                           exps=exps)
        return wave_histogram(X, lid, w3, ids, hist_bins, exps=exps)

    def best_of_many(hists_k, sums_k, depths_k):
        return best_splits_batched(
            hists_k, sums_k, depths_k, meta, feature_mask, params,
            max_depth,
            hist_view=lambda h, s: feature_hist_view(h, s, meta, bundle,
                                                     fix_default=sparse))

    # ---- root: one child slot, leaf 0
    root_sums = w3.sum(dim=0)
    root_ids = torch.zeros(1, dtype=i32, device=dev)
    hist0 = child_hists(leaf_id, root_ids)[0]
    Fh, B = hist0.shape[0], hist0.shape[1]
    if cache_hists:
        hists = torch.zeros((L, Fh, B, 3), dtype=f32, device=dev)
        hists[0] = hist0
    bests = torch.full((L, SPLIT_VEC_SIZE), -float("inf"), dtype=f32,
                       device=dev)
    bests[0] = best_of_many(hist0[None], root_sums[None],
                            torch.zeros(1, dtype=i32, device=dev))[0]

    tree = TreeArrays.new(L, root_sums[2], f32, dev)

    rank = torch.arange(W, dtype=torch.long, device=dev)
    host_depth = [0] * L
    nn = 0
    waves = host_reads = 0
    default_bin = meta.default_bin
    while nn < L - 1:
        gw, lw = _stable_topk(bests[:, GAIN], W)
        budget = (L - 1) - nn
        valid = (gw > 0.0) & (rank < budget)
        # the one host read per wave: valid count + parent ids
        host = torch.cat([valid.sum().reshape(1), lw]).tolist()
        host_reads += 1
        k = int(host[0])
        if k == 0:
            break
        waves += 1
        parent = lw                                        # (W,) long
        # invalid slots may point at unsplit leaves whose packed vectors
        # are all -inf; they are never committed, so zero them
        info = torch.where(valid[:, None], bests[parent],
                           torch.zeros((), dtype=f32, device=dev))
        node = nn + rank
        newleaf = node + 1

        f_w = info[:, FEATURE].long()
        thr_w = info[:, THRESHOLD].to(i32)
        dbz_w = info[:, DEFAULT_BIN_FOR_ZERO].to(i32)
        cat_w = info[:, IS_CAT] > 0.5
        fdef_w = default_bin[f_w]
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
            span_w = torch.full((W,), num_bins, dtype=i32, device=dev)
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
        psrc = torch.where(valid, parent, torch.full_like(parent, -3)).to(
            i32)

        # ---- partition + smaller-children histograms (one pass)
        left_small = info[:, LEFT_COUNT] < info[:, RIGHT_COUNT]
        small_id = torch.where(left_small, parent, newleaf)
        large_id = torch.where(left_small, newleaf, parent)
        cid = torch.where(valid, small_id, torch.full_like(small_id, -1)).to(
            i32)
        if sparse:
            leaf_id = sparse_route_rows(X, leaf_id, cols, psrc, L,
                                        bundle is not None)
            hist_small = child_hists(leaf_id, cid)
        elif hist_mode == "pallas_ct":
            leaf_id, hist_small = wave_partition_hist(
                X, leaf_id, w3, cid, cols, psrc, hist_bins,
                bundled=bundle is not None, exps=exps)
        else:
            route = (route_rows_rowmajor if hist_mode == "pallas"
                     else route_rows_plain)
            leaf_id = route(X, leaf_id, cols, psrc, bundle is not None)
            hist_small = child_hists(leaf_id, cid)
        if cache_hists:
            hist_large = hists[parent] - hist_small
        else:
            lid_large = torch.where(valid, large_id,
                                    torch.full_like(large_id, -1)).to(i32)
            hist_large = child_hists(leaf_id, lid_large)

        left_sums = torch.stack([info[:, LEFT_SUM_G], info[:, LEFT_SUM_H],
                                 info[:, LEFT_COUNT]], dim=-1)
        right_sums = torch.stack([info[:, RIGHT_SUM_G],
                                  info[:, RIGHT_SUM_H],
                                  info[:, RIGHT_COUNT]], dim=-1)
        small_sums = torch.where(left_small[:, None], left_sums, right_sums)
        large_sums = torch.where(left_small[:, None], right_sums, left_sums)

        # ---- split search for all 2W children
        depth = tree.leaf_depth[parent] + 1                 # (W,)
        bests_k = best_of_many(torch.cat([hist_small, hist_large]),
                               torch.cat([small_sums, large_sums]),
                               torch.cat([depth, depth]))   # (2W, V)

        # valid slots are a prefix (gains sorted descending): commit [:k]
        c = slice(0, k)
        p_c, nl_c, node_c = parent[c], newleaf[c], node[c]
        s_c, l_c = small_id[c], large_id[c]
        if cache_hists:
            hists[s_c] = hist_small[c]
            hists[l_c] = hist_large[c]
        bests[s_c] = bests_k[:W][c]
        bests[l_c] = bests_k[W:][c]

        # ---- tree bookkeeping for the k committed splits
        tparent = tree.leaf_parent[p_c].long()
        gp = tparent.clamp(min=0)
        was_left = tree.left_child[gp] == (~p_c).to(i32)
        fix = tparent >= 0
        lc, rc = tree.left_child, tree.right_child
        _put_where(lc, gp, fix & was_left, node_c.to(i32))
        _put_where(rc, gp, fix & ~was_left, node_c.to(i32))
        lc[node_c] = (~p_c).to(i32)
        rc[node_c] = (~nl_c).to(i32)
        inf_c = info[c]
        internal_value = tree.leaf_value[p_c]
        tree.num_leaves = tree.num_leaves + k
        tree.split_feature[node_c] = f_w[c].to(i32)
        tree.threshold_bin[node_c] = thr_w[c]
        tree.default_bin_for_zero[node_c] = dbz_w[c]
        tree.default_bin[node_c] = fdef_w[c].to(i32)
        tree.is_cat[node_c] = cat_w[c].to(i32)
        tree.split_gain[node_c] = inf_c[:, GAIN]
        tree.internal_value[node_c] = internal_value
        tree.internal_count[node_c] = (inf_c[:, LEFT_COUNT]
                                       + inf_c[:, RIGHT_COUNT]).to(i32)
        tree.leaf_parent[p_c] = node_c.to(i32)
        tree.leaf_parent[nl_c] = node_c.to(i32)
        tree.leaf_value[p_c] = inf_c[:, LEFT_OUTPUT]
        tree.leaf_value[nl_c] = inf_c[:, RIGHT_OUTPUT]
        tree.leaf_count[p_c] = inf_c[:, LEFT_COUNT].to(i32)
        tree.leaf_count[nl_c] = inf_c[:, RIGHT_COUNT].to(i32)
        tree.leaf_depth[p_c] = depth[c]
        tree.leaf_depth[nl_c] = depth[c]
        tree.second_feature[node_c] = inf_c[:, SECOND_FEATURE].to(i32)
        sg = inf_c[:, SECOND_GAIN]
        tree.second_gain[node_c] = torch.where(torch.isfinite(sg), sg,
                                               torch.zeros_like(sg))
        for j in range(k):
            p = int(host[1 + j])
            host_depth[p] = host_depth[nn + j + 1] = host_depth[p] + 1
        nn += k
    stats = GrowStats(num_leaves=nn + 1, depth=max(host_depth[:nn + 1]),
                      waves=waves, host_reads=host_reads)
    return tree, leaf_id, stats
