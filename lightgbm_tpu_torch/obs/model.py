"""Model observability: split audit trail + importance evolution.

The port's copy of the JAX package's ``obs/model.py`` (which imports no
jax).

Two event families on the obs timeline (events.py, schema v5):

* ``split_audit`` -- one event per materialized tree listing every realized
  split: feature, bin threshold, real-valued threshold, gain, child row
  counts, and the runner-up candidate the winner beat (``second_feature`` /
  ``second_gain`` threaded from the device split search,
  ops/split_finder.py SECOND_*).  The ``margin`` (gain - second_gain) is
  the cheapest single signal for "was this split decisive or a coin flip".
* ``importance`` -- top-k sparse split/gain importance vectors at a cadence
  (``obs_importance_every``), so importance can be read as a trajectory
  instead of a single end-of-training snapshot.

Everything here works on host numpy arrays of already-materialized
models/tree.py Trees -- nothing touches the device.  Readers
(``importance_history``, ``audit_margin_stats``) operate on the event
dicts returned by events.read_events and back Booster.importance_history
and the ``obs explain`` report (query.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# Cap on splits recorded per tree: a 64k-leaf tree would otherwise write a
# multi-MB event line.  Splits are recorded in node order (creation order),
# so the cap keeps the earliest -- highest-level -- splits.
MAX_AUDIT_SPLITS = 512


def tree_split_records(tree, max_splits: int = MAX_AUDIT_SPLITS
                       ) -> Tuple[List[dict], bool]:
    """Per-split audit records for one materialized Tree.

    Child row counts are reconstructed from the final arrays: a side that
    stayed a leaf keeps its count in ``leaf_count``; a side that split
    again had its leaf_count overwritten, but the child internal node's
    ``internal_count`` preserves the side's row count at split time.
    """
    ni = int(tree.num_leaves) - 1
    if ni <= 0:
        return [], False
    truncated = ni > max_splits
    records: List[dict] = []
    for i in range(min(ni, max_splits)):
        def side_count(child):
            c = int(child)
            return int(tree.leaf_count[~c]) if c < 0 \
                else int(tree.internal_count[c])
        left_cnt = side_count(tree.left_child[i])
        right_cnt = side_count(tree.right_child[i])
        rec = {
            "node": i,
            "feature": int(tree.split_feature[i]),
            "bin": int(tree.threshold_in_bin[i]),
            "threshold": float(tree.threshold[i]),
            "gain": float(tree.split_gain[i]),
            "count": int(tree.internal_count[i]),
            "left_count": left_cnt,
            "right_count": right_cnt,
            "cat": bool(tree.decision_type[i] == 1),
        }
        sf = int(tree.second_feature[i])
        if sf >= 0:
            sg = float(tree.second_gain[i])
            rec["second_feature"] = sf
            rec["second_gain"] = sg
            rec["margin"] = float(tree.split_gain[i]) - sg
        records.append(rec)
    return records, truncated


def emit_split_audit(obs, it: int, tree_index: int, tree,
                     max_splits: int = MAX_AUDIT_SPLITS) -> None:
    """Write one ``split_audit`` event for a materialized tree (skips
    stubs -- a tree with no splits has nothing to audit)."""
    splits, truncated = tree_split_records(tree, max_splits)
    if not splits:
        return
    obs.event("split_audit", it=int(it), tree=int(tree_index),
              num_leaves=int(tree.num_leaves),
              shrinkage=float(tree.shrinkage),
              truncated=bool(truncated), splits=splits)


def emit_importance(obs, it: int, split_counts: np.ndarray,
                    gains: np.ndarray, topk: int = 20) -> None:
    """Write one top-k sparse ``importance`` event.

    ``split_counts`` / ``gains`` are the dense per-real-feature vectors
    from GBDT.feature_importance; top-k is chosen by gain (the more
    discriminative of the two), ties broken by feature index.
    """
    gains = np.asarray(gains, dtype=np.float64)
    split_counts = np.asarray(split_counts, dtype=np.float64)
    used = np.nonzero((gains > 0) | (split_counts > 0))[0]
    if len(used) == 0:
        return
    order = used[np.argsort(-gains[used], kind="stable")]
    if topk > 0:
        order = order[:topk]
    obs.event("importance", it=int(it),
              n_features=int(len(gains)),
              n_used=int(len(used)),
              features=[int(f) for f in order],
              split=[int(split_counts[f]) for f in order],
              gain=[float(gains[f]) for f in order])


# ------------------------------------------------------------------ readers

def importance_history(events: Sequence[dict],
                       importance_type: str = "split") -> List[dict]:
    """``importance`` events -> ``[{"it", "importance": {feature: value}}]``.

    ``importance_type``: 'split' (number of uses) or 'gain' (total gain).
    Only the last run in the timeline is considered (a timeline can hold
    several runs back to back).
    """
    if importance_type not in ("split", "gain"):
        raise ValueError("importance_type must be 'split' or 'gain', got %r"
                         % (importance_type,))
    # restart at the last run_header, like query.timeline_metrics
    start = 0
    for i, ev in enumerate(events):
        if ev.get("ev") == "run_header":
            start = i
    out: List[dict] = []
    for ev in events[start:]:
        if ev.get("ev") != "importance":
            continue
        feats = ev.get("features") or []
        vals = ev.get(importance_type) or []
        out.append({"it": int(ev.get("it", -1)),
                    "importance": {int(f): float(v)
                                   for f, v in zip(feats, vals)}})
    return out


def audit_margin_stats(events: Sequence[dict]) -> Dict[int, dict]:
    """Aggregate ``split_audit`` margins per winning feature.

    Returns ``{feature: {"splits", "total_gain", "contested",
    "min_margin_rel", "median_margin_rel", "runner_ups": {feat: n}}}``
    where margin_rel = margin / gain (0 = coin flip, 1 = unopposed among
    contested splits).  Uncontested splits (no runner-up) count toward
    ``splits`` but not the margin percentiles.
    """
    margins: Dict[int, List[float]] = {}
    stats: Dict[int, dict] = {}
    for ev in events:
        if ev.get("ev") != "split_audit":
            continue
        for s in ev.get("splits") or []:
            f = int(s.get("feature", -1))
            st = stats.setdefault(f, {"splits": 0, "total_gain": 0.0,
                                      "contested": 0, "runner_ups": {}})
            st["splits"] += 1
            st["total_gain"] += float(s.get("gain", 0.0))
            if "second_feature" in s:
                st["contested"] += 1
                g = float(s.get("gain", 0.0))
                if g > 0:
                    margins.setdefault(f, []).append(
                        float(s.get("margin", 0.0)) / g)
                sf = int(s["second_feature"])
                st["runner_ups"][sf] = st["runner_ups"].get(sf, 0) + 1
    for f, st in stats.items():
        rel = margins.get(f)
        if rel:
            st["min_margin_rel"] = float(np.min(rel))
            st["median_margin_rel"] = float(np.median(rel))
        else:
            st["min_margin_rel"] = None
            st["median_margin_rel"] = None
    return stats
