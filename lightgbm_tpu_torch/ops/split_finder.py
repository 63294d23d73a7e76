"""Vectorized best-split search over (feature, bin) histograms — torch.

Parity target: src/treelearner/feature_histogram.hpp:78-387, ported from
the JAX package's ``ops/split_finder.py``.  Every pass is a masked
cumulative sum over the whole (K, F, B) histogram batch, so the split
search for all K leaves of a wave is a handful of tensor ops with no
per-feature loop.  Tie-breaking reproduces the reference's iteration
order:

* dir=-1 passes iterate bins high->low with strict ``>`` updates, so equal
  gains keep the LARGER threshold; dir=+1 keeps the smaller.
* across passes, earlier passes win ties (strict ``>`` replacement);
* across features, the smaller feature index wins ties (``argmax`` picks
  the first max).

The batch dimension K replaces the JAX package's ``vmap``.  Constants
enter as Python scalars (``masked_fill``, scalar arithmetic): a constant
built with ``torch.tensor(..., device=cuda)`` is a host-to-device copy,
which waits for the device's queue to drain, and the exact grower runs
this search once a split.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

kEpsilon = 1e-15

# packed SplitInfo layout (one float vector per leaf; device-resident)
GAIN = 0
FEATURE = 1
THRESHOLD = 2
DEFAULT_BIN_FOR_ZERO = 3
LEFT_OUTPUT = 4
RIGHT_OUTPUT = 5
LEFT_SUM_G = 6
LEFT_SUM_H = 7
LEFT_COUNT = 8
RIGHT_SUM_G = 9
RIGHT_SUM_H = 10
RIGHT_COUNT = 11
IS_CAT = 12
# runner-up feature and its gain; SECOND_FEATURE is -1 and SECOND_GAIN 0
# when no other feature had a valid split
SECOND_FEATURE = 13
SECOND_GAIN = 14
SPLIT_VEC_SIZE = 15


@dataclass
class FeatureMeta:
    """Per-inner-feature tensors on the training device."""
    num_bin: torch.Tensor         # (F,) int32
    default_bin: torch.Tensor     # (F,) int32
    is_categorical: torch.Tensor  # (F,) bool


class SplitParams(NamedTuple):
    """Python-scalar hyperparameters."""
    lambda_l1: float
    lambda_l2: float
    min_gain_to_split: float
    min_data_in_leaf: float
    min_sum_hessian_in_leaf: float
    use_missing: bool


def _leaf_split_gain(sum_g, sum_h, l1, l2):
    """GetLeafSplitGain (feature_histogram.hpp:230-236)."""
    reg = torch.clamp(sum_g.abs() - l1, min=0.0)
    return reg * reg / (sum_h + l2)


def _leaf_output(sum_g, sum_h, l1, l2):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:244-249)."""
    reg = torch.clamp(sum_g.abs() - l1, min=0.0)
    return -torch.sign(sum_g) * reg / (sum_h + l2)


def _prefix_sum(x):
    """Prefix sums over the bin axis, accumulated in float64 and rounded
    once to x's dtype.  A GPU scan adds in another order than the CPU's
    running sum; with the wider accumulator both round the same sums to the
    same values, so prefixes that are equal (an empty bin adds 0) stay
    exactly equal on every device and tied thresholds resolve alike."""
    return torch.cumsum(x.double(), dim=-1).to(x.dtype)


def _suffix_sum(x):
    """sr[..., t] = sum_{b >= t} x[..., b]."""
    return torch.flip(_prefix_sum(torch.flip(x, (-1,))), (-1,))


def _argmax_prefer_last(x):
    """argmax over the last axis returning the LAST index among ties."""
    n = x.shape[-1]
    return n - 1 - torch.argmax(torch.flip(x, (-1,)), dim=-1)


class _Cand(NamedTuple):
    gain: torch.Tensor       # (K, F) candidate gain, -inf when invalid
    threshold: torch.Tensor  # (K, F) int64
    dbz: torch.Tensor        # (K, F) int64 default_bin_for_zero
    left_g: torch.Tensor     # (K, F)
    left_h: torch.Tensor     # (K, F) includes the +kEpsilon seed
    left_c: torch.Tensor     # (K, F)


def _take(x, pick):
    """x[k, f, pick[k, f]] for (K, F, B) x and (K, F) pick."""
    return torch.gather(x, -1, pick.unsqueeze(-1)).squeeze(-1)


def _numerical_pass(g, h, c, meta: FeatureMeta, params: SplitParams,
                    total_g, total_h_eps, total_cnt, min_gain_shift,
                    mode: str) -> _Cand:
    """One FindBestThresholdSequence pass over all K leaves and features.

    mode: 'zero_left' (dbz=0), 'natural' (dbz=default_bin),
          'zero_right' (dbz=num_bin-1)."""
    K, F, B = g.shape
    dev = g.device
    bins = torch.arange(B, device=dev)
    num_bin = meta.num_bin.long()
    default_bin = meta.default_bin.long()
    valid = bins[None, :] < num_bin[:, None]                   # (F, B)
    if mode in ("zero_left", "zero_right"):
        keep = valid & (bins[None, :] != default_bin[:, None])
    else:
        keep = valid
    zero = torch.zeros((), dtype=g.dtype, device=dev)
    gk = torch.where(keep, g, zero)
    hk = torch.where(keep, h, zero)
    ck = torch.where(keep, c, zero)

    eps = kEpsilon
    if mode != "zero_right":
        # dir = -1: split point t puts bins >= t on the right,
        # threshold = t - 1
        right_g = _suffix_sum(gk)
        right_h = _suffix_sum(hk) + eps
        right_c = _suffix_sum(ck)
        left_g = total_g - right_g
        left_h = total_h_eps - right_h
        left_c = total_cnt - right_c
        t_ok = (bins[None, :] >= 1) & valid
        threshold = (bins[None, :] - 1).expand(F, B)
        prefer_last = True
    else:
        # dir = +1: threshold = t
        left_g = _prefix_sum(gk)
        left_h = _prefix_sum(hk) + eps
        left_c = _prefix_sum(ck)
        right_g = total_g - left_g
        right_h = total_h_eps - left_h
        right_c = total_cnt - left_c
        t_ok = (bins[None, :] <= num_bin[:, None] - 2) & valid
        threshold = bins[None, :].expand(F, B)
        prefer_last = False

    ok = (t_ok
          & (right_c >= params.min_data_in_leaf)
          & (right_h >= params.min_sum_hessian_in_leaf)
          & (left_c >= params.min_data_in_leaf)
          & (left_h >= params.min_sum_hessian_in_leaf))
    gain = (_leaf_split_gain(left_g, left_h, params.lambda_l1,
                             params.lambda_l2)
            + _leaf_split_gain(right_g, right_h, params.lambda_l1,
                               params.lambda_l2))
    ok = ok & (gain > min_gain_shift)
    gain = gain.masked_fill(~ok, -float("inf"))

    pick = (_argmax_prefer_last(gain) if prefer_last
            else torch.argmax(gain, dim=-1))                   # (K, F)
    if mode == "zero_left":
        dbz = torch.zeros(K, F, dtype=torch.long, device=dev)
    elif mode == "natural":
        dbz = default_bin.expand(K, F)
    else:
        dbz = (num_bin - 1).expand(K, F)
    return _Cand(
        gain=_take(gain, pick),
        threshold=torch.gather(threshold.expand(K, F, B), -1,
                               pick.unsqueeze(-1)).squeeze(-1),
        dbz=dbz,
        left_g=_take(left_g, pick),
        left_h=_take(left_h, pick),
        left_c=_take(left_c, pick),
    )


def _categorical_pass(g, h, c, meta: FeatureMeta, params: SplitParams,
                      total_g, total_h_eps, total_cnt,
                      min_gain_shift) -> _Cand:
    """One-vs-rest categorical scan (feature_histogram.hpp:100-198); the
    left side is the single category bin t; ties keep the larger t."""
    K, F, B = g.shape
    dev = g.device
    bins = torch.arange(B, device=dev)
    valid = bins[None, :] < meta.num_bin.long()[:, None]
    eps = kEpsilon

    other_c = total_cnt - c
    other_h = total_h_eps - h - eps
    other_g = total_g - g
    ok = (valid
          & (c >= params.min_data_in_leaf)
          & (h >= params.min_sum_hessian_in_leaf)
          & (other_c >= params.min_data_in_leaf)
          & (other_h >= params.min_sum_hessian_in_leaf))
    gain = (_leaf_split_gain(other_g, other_h, params.lambda_l1,
                             params.lambda_l2)
            + _leaf_split_gain(g, h + eps, params.lambda_l1,
                               params.lambda_l2))
    ok = ok & (gain > min_gain_shift)
    gain = gain.masked_fill(~ok, -float("inf"))
    pick = _argmax_prefer_last(gain)
    return _Cand(
        gain=_take(gain, pick),
        threshold=pick,
        dbz=meta.default_bin.long().expand(K, F),
        left_g=_take(g, pick),
        left_h=_take(h, pick) + eps,
        left_c=_take(c, pick),
    )


def _merge(best: _Cand, cand: _Cand) -> _Cand:
    """A later candidate replaces only on strictly greater gain."""
    take = cand.gain > best.gain
    return _Cand(*[torch.where(take, cn, bn) for cn, bn in zip(cand, best)])


def per_feature_candidates(hist, sums, meta: FeatureMeta,
                           params: SplitParams):
    """Each feature's best split candidate for each of K leaves (JAX
    ``ops/split_finder.py per_feature_candidates``): (best, total_g,
    total_h_eps, total_cnt, min_gain_shift), best a _Cand of (K, F)
    tensors whose gain is the raw gain (the shift not yet subtracted;
    -inf: unsplittable) and the totals (K,).  The voting-parallel
    learner proposes its local top-k features from these
    (voting_parallel_tree_learner.cpp:255-300)."""
    g, h, c = hist[..., 0], hist[..., 1], hist[..., 2]
    dtype = g.dtype
    eps = kEpsilon
    total_g = sums[:, 0].to(dtype)
    total_h_eps = sums[:, 1].to(dtype) + 2 * eps
    total_cnt = sums[:, 2].to(dtype)
    gain_shift = _leaf_split_gain(total_g, total_h_eps, params.lambda_l1,
                                  params.lambda_l2)
    min_gain_shift = gain_shift + params.min_gain_to_split       # (K,)

    col = (lambda x: x[:, None, None])
    args = (g, h, c, meta, params, col(total_g), col(total_h_eps),
            col(total_cnt), col(min_gain_shift))
    if params.use_missing:
        best = _numerical_pass(*args, mode="zero_left")
        best = _merge(best, _numerical_pass(*args, mode="natural"))
        best = _merge(best, _numerical_pass(*args, mode="zero_right"))
    else:
        best = _numerical_pass(*args, mode="natural")
    cat = _categorical_pass(*args)
    is_cat = meta.is_categorical[None, :]
    best = _Cand(*[torch.where(is_cat, cn, bn) for cn, bn in zip(cat, best)])
    return best, total_g, total_h_eps, total_cnt, min_gain_shift


def find_best_splits(hist, sums, meta: FeatureMeta, feature_mask,
                     params: SplitParams):
    """Best split of each of K leaves.

    hist: (K, F, B, 3) [sum_grad, sum_hess, count]; sums: (K, 3) leaf
    totals; feature_mask: (F,) bool.  Returns (K, SPLIT_VEC_SIZE) packed
    vectors; gain=-inf marks an unsplittable leaf."""
    dtype = hist.dtype
    eps = kEpsilon
    best, total_g, total_h_eps, total_cnt, min_gain_shift = \
        per_feature_candidates(hist, sums, meta, params)

    ninf = -float("inf")
    masked = best.gain.masked_fill(~feature_mask[None, :], ninf)  # (K, F)
    f = torch.argmax(masked, dim=-1)                              # (K,)
    fi = f[:, None]
    bgain = torch.gather(masked, 1, fi)[:, 0]
    masked2 = masked.scatter(1, fi, -float("inf"))
    f2 = torch.argmax(masked2, dim=-1)
    g2 = torch.gather(masked2, 1, f2[:, None])[:, 0]

    def at_f(x):
        return torch.gather(x, 1, fi)[:, 0]

    lg, lh, lc = at_f(best.left_g), at_f(best.left_h), at_f(best.left_c)
    rg = total_g - lg
    rh = total_h_eps - lh
    rc = total_cnt - lc
    g2_ok = torch.isfinite(g2)
    out = torch.stack([
        (bgain - min_gain_shift).masked_fill(~torch.isfinite(bgain), ninf),
        f.to(dtype),
        at_f(best.threshold).to(dtype),
        at_f(best.dbz).to(dtype),
        _leaf_output(lg, lh, params.lambda_l1, params.lambda_l2),
        _leaf_output(rg, rh, params.lambda_l1, params.lambda_l2),
        lg,
        lh - eps,
        lc,
        rg,
        rh - eps,
        rc,
        meta.is_categorical[f].to(dtype),
        torch.where(g2_ok, f2, torch.full_like(f2, -1)).to(dtype),
        torch.where(g2_ok, g2 - min_gain_shift, torch.zeros_like(g2)),
    ], dim=-1)
    return out


def best_splits_batched(hists_k, sums_k, depths_k, meta: FeatureMeta,
                        feature_mask, params: SplitParams, max_depth: int,
                        hist_view=None):
    """Packed best-split search over K leaves at once, with the max_depth
    gate (a leaf at depth >= max_depth keeps its vector but has its gain
    forced to -inf).  ``hist_view`` maps the raw (K, G, Bg, 3) group
    histograms and (K, 3) sums to per-feature (K, F, B, 3) views (EFB
    gather / default-bin fix)."""
    hv = hist_view(hists_k, sums_k) if hist_view is not None else hists_k
    return depth_gate(find_best_splits(hv, sums_k, meta, feature_mask,
                                       params), depths_k, max_depth)


def depth_gate(out, depths_k, max_depth: int):
    """The max_depth gate: a leaf at depth >= max_depth keeps its packed
    vector with its gain forced to -inf (in place; returns out)."""
    if max_depth > 0:
        gate = depths_k < max_depth
        out[:, GAIN] = torch.where(gate, out[:, GAIN],
                                   torch.full_like(out[:, GAIN],
                                                   -float("inf")))
    return out
