#!/usr/bin/env python3
"""Where two builds of the port part ways on chip_smoke.py's sparse run.

Trains chip_smoke.py's sparse recipe (the flagship params on the
Bosch-shaped data, tpu_sparse with kernel B6) and writes the model text.
Given the model text of another build (``--against``), it finds the first
split where the two models differ and, at that split, recomputes the gain
of each side's choice from the exact histogram of the node's rows: the
same f32 weight rows the grower used, summed in float64 by the plain
version of B6 (no kernel), then the split search in float64.  It also
gives each choice's gain from this build's B6 histogram of the node
(f32, one rounding a cell), so a near-tie shows beside the f32 spacing.

    # the other build (e.g. the parent commit unpacked into _parent/)
    python3 sparse_model_diff.py --package _parent --out parent.txt
    # this build, compared with it
    python3 sparse_model_diff.py --out change.txt --against parent.txt

The last line of standard output is one JSON object with what was found.
"""
import argparse
import json
import os
import sys
import time

import numpy as np



def node_paths(tree):
    """{path: node} over a tree: a path is the string of 'L' and 'R' steps
    from the root; node >= 0 is an internal node, ~node a leaf."""
    if tree.num_leaves <= 1:
        return {"": ~0}
    out, todo = {}, [("", 0)]
    while todo:
        path, n = todo.pop()
        out[path] = n
        if n >= 0:
            todo += [(path + "L", int(tree.left_child[n])),
                     (path + "R", int(tree.right_child[n]))]
    return out


def split_at(tree, n):
    """The split of internal node n as the model text gives it, or None
    for a leaf."""
    if n < 0:
        return None
    return {"node": n, "feature": int(tree.split_feature[n]),
            "threshold": float(tree.threshold[n]),
            "split_gain": float(tree.split_gain[n]),
            "count": int(tree.internal_count[n])}


def first_difference(mine, theirs):
    """(tree, path) of the first place, in this build's split order, where
    the two lists of trees split differently (another split, or a split
    in one and a leaf in the other) below identical ancestors; None if
    the trees are equal."""
    for t, (a, b) in enumerate(zip(mine, theirs)):
        pa, pb = node_paths(a), node_paths(b)
        found = []
        for path, na in pa.items():
            nb = pb.get(path)
            if nb is None:
                continue                   # below a difference
            sa, sb = split_at(a, na), split_at(b, nb)
            same = (sa is None and sb is None) or (
                sa is not None and sb is not None
                and (sa["feature"], sa["threshold"])
                == (sb["feature"], sb["threshold"]))
            if not same:
                order = min(na if na >= 0 else 1 << 30,
                            nb if nb >= 0 else 1 << 30)
                found.append((order, path))
        if found:
            return t, min(found)[1]
    if len(mine) != len(theirs):
        return min(len(mine), len(theirs)), ""
    return None


def rows_leaves(tree, n):
    """The leaf indices under node n (n itself when it is a leaf)."""
    out, todo = [], [n]
    while todo:
        m = todo.pop()
        if m < 0:
            out.append(~m)
        else:
            todo += [int(tree.left_child[m]), int(tree.right_child[m])]
    return out


def witness(learner, grad, hess, row_mult, leaf_id, leaves, candidates):
    """The best split of each candidate real feature, and of all features
    ("best"), over the rows whose final leaf (this build's tree) is in
    ``leaves``: from the float64 plain histogram of those rows and from
    this build's B6 histogram of them (f32).  A gain of -inf: no split
    beats the leaf."""
    import torch

    from lightgbm_tpu_torch.ops import grow
    from lightgbm_tpu_torch.ops import sparse_mxu as sm
    from lightgbm_tpu_torch.ops import split_finder as sf
    from lightgbm_tpu_torch.ops.histogram import weight_rows
    td = learner.train_data
    leaves = torch.as_tensor(leaves, dtype=torch.int32,
                             device=leaf_id.device)
    in_node = torch.isin(leaf_id, leaves)
    lid = torch.where(in_node, 0, 1).to(torch.int32)
    cid = torch.zeros(1, dtype=torch.int32, device=leaf_id.device)
    w3 = weight_rows(grad, hess, row_mult)
    store = learner.X
    B = learner.group_bins if td.bundle is not None else learner.num_bins
    out = {"rows": int(in_node.sum())}
    for name, h, w in (
            ("float64", sm.chunked_child_hists_plain(
                store, lid, w3.double(), cid, B, store.num_cols),
             w3.double()),
            ("b6_f32", sm.sparse_wave_histogram(
                store, lid, w3, cid, B, store.num_cols), w3)):
        sums = (w * in_node[:, None].to(w.dtype)).sum(dim=0)[None]
        res = {}
        for real in candidates + [None]:
            if real is None:               # every feature: the best split
                mask = learner._full_mask
            else:
                mask = torch.zeros_like(learner._full_mask)
                mask[td.real_to_inner[real]] = True
            best = sf.best_splits_batched(
                h, sums.to(h.dtype), torch.zeros(1, dtype=torch.int32,
                                                 device=h.device),
                learner.meta, mask, learner.params, learner.config.max_depth,
                hist_view=lambda g, s: grow.feature_hist_view(
                    g, s, learner.meta, learner.bundle_arrays,
                    fix_default=True))[0]
            gain = float(best[sf.GAIN])
            inner = int(best[sf.FEATURE])
            res["best" if real is None else str(real)] = (
                {"gain": gain} if not np.isfinite(gain) else {
                    "gain": gain, "feature": td.real_feature_index(inner),
                    "threshold": float(td.feature_bin_mapper(inner)
                                       .bin_to_value(
                                           int(best[sf.THRESHOLD]))),
                    "left_count": float(best[sf.LEFT_COUNT])})
        out[name] = res
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", default=None,
                    help="directory holding the lightgbm_tpu_torch to "
                         "train with (default: this checkout's)")
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="sparse training rows (chip_smoke.py's default)")
    ap.add_argument("--out", required=True, help="model text written here")
    ap.add_argument("--against", default=None,
                    help="model text of the other build to compare with")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    if args.package:
        sys.path.insert(0, os.path.abspath(args.package))
    import torch
    if not torch.cuda.is_available():
        print("sparse_model_diff: no CUDA device", file=sys.stderr)
        sys.exit(2)
    import lightgbm_tpu_torch as lgb
    from chip_smoke import ITERS, make_sparse_data, sparse_params
    print("package: %s" % os.path.dirname(lgb.__file__), flush=True)

    from lightgbm_tpu_torch.ops import learner as learner_mod
    seen = []
    real_train = learner_mod.SerialTreeLearner.train_device

    def spy(self, grad, hess, row_mult=None):
        out = real_train(self, grad, hess, row_mult)
        seen.append((self, grad.float().clone(), hess.float().clone(),
                     row_mult, out[1].clone()))
        return out

    if args.against:
        learner_mod.SerialTreeLearner.train_device = spy
    t0 = time.perf_counter()
    Xs, ys = make_sparse_data(args.rows, 7)
    params = sparse_params()
    ds = lgb.Dataset(Xs, label=ys, params=params).construct()
    t_set = time.perf_counter() - t0
    t0 = time.perf_counter()
    booster = lgb.train(params, ds, ITERS)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    gbdt = booster._gbdt
    dev_trees = [i for i, d in enumerate(gbdt._models_dev) if d is not None]
    text = booster.model_to_string()
    with open(args.out, "w") as f:
        f.write(text)
    result = {"rows": args.rows, "trees": len(gbdt.models),
              "set_up_s": t_set, "train_s": t_train}
    print("trained %d trees in %.1f s (set-up %.1f s); model text in %s"
          % (len(gbdt.models), t_train, t_set, args.out), flush=True)
    if args.against:
        with open(args.against) as f:
            other = lgb.Booster(model_str=f.read())._gbdt.models
        mine = gbdt.models
        where = first_difference(mine, other)
        result["first_difference"] = where
        if where is not None and where[0] < min(len(mine), len(other)):
            t, path = where
            na, nb = node_paths(mine[t])[path], node_paths(other[t])[path]
            result["this"], result["other"] = (split_at(mine[t], na),
                                               split_at(other[t], nb))
            print("first difference: tree %d at path %r: this %s, other %s"
                  % (t, path, result["this"], result["other"]), flush=True)
            if t in dev_trees:
                learner, grad, hess, row_mult, leaf_id = seen[
                    dev_trees.index(t)]
                if row_mult is None:
                    row_mult = learner._ones
                cands = sorted({s["feature"] for s in (result["this"],
                                                       result["other"])
                                if s is not None})
                result["witness"] = witness(
                    learner, grad, hess, row_mult, leaf_id,
                    rows_leaves(mine[t], na), cands)
                print("witness: %s" % result["witness"], flush=True)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
