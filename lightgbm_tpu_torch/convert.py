"""Carrying state across from the JAX package.

Two doors, neither of which imports the JAX package: a grown tree's flat
arrays handed over as numpy (``tree_arrays_from_numpy``), and a trained
model handed over as the text model format both packages read and write
(``booster_from_model_string``).
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from .basic import Booster
from .device import resolve_device
from .ops.grow import TreeArrays

_INT_FIELDS = {"num_leaves", "split_feature", "threshold_bin",
               "default_bin_for_zero", "default_bin", "is_cat",
               "left_child", "right_child", "internal_count", "leaf_parent",
               "leaf_count", "leaf_depth", "second_feature"}


def tree_arrays_from_numpy(d, device="cuda") -> TreeArrays:
    """The port's TreeArrays from the JAX package's TreeArrays given as a
    mapping of field name -> numpy array (``{f: np.asarray(getattr(t, f))
    for f in t._fields}``).  Integer fields become int32, float fields
    float32, copied to ``device``."""
    dev = resolve_device(device)
    out = {}
    for f in fields(TreeArrays):
        if f.name not in d:
            raise KeyError("TreeArrays field %r missing" % f.name)
        dtype = np.int32 if f.name in _INT_FIELDS else np.float32
        out[f.name] = torch.tensor(np.asarray(d[f.name], dtype=dtype),
                                   device=dev)
    return TreeArrays(**out)


def booster_from_model_string(s: str, device="cuda") -> Booster:
    """A Booster on ``device`` from model text written by either
    package."""
    return Booster(model_str=s, device=device)
