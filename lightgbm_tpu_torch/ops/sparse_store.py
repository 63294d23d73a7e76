"""The fill bin of each device column of a sparse store.

Ported from the JAX package's ``ops/sparse_store.py`` (``column_fill_bins``
only; its coordinate store is not in this port).  A sparse store keeps only
the entries whose bin differs from the column's fill bin; the histogram
view rebuilds the fill slot from the leaf sums (FixHistogram,
src/treelearner/feature_histogram.hpp:904-941).
"""
from __future__ import annotations

import numpy as np


def column_fill_bins(num_bin_arr, default_bin_arr, bundle) -> np.ndarray:
    """(G,) int64 fill bin of each device column.

    No bundle: the feature's default bin (feature_hist_view rebuilds it
    with fix_default).  Bundled: multi-feature groups fill with the
    reserved bin 0; single-feature groups carry the feature's own bins, so
    their fill is that feature's default bin."""
    if bundle is None:
        return np.asarray(default_bin_arr, np.int64)
    fill = np.zeros(len(bundle.groups), np.int64)
    for gid, feats in enumerate(bundle.groups):
        if len(feats) == 1:
            fill[gid] = int(default_bin_arr[feats[0]])
    return fill
