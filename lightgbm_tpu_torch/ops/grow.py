"""Device-side tree state: the flat tree arrays the wave grower fills, the
EFB layout it reads, and the per-feature histogram view.

Ported from the JAX package's ``ops/grow.py``; the NamedTuple pytrees
become dataclasses of tensors with the same fields and layouts.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch


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
