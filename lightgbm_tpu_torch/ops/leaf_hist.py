"""Leaf histogram of the exact grower (kernel B5), beside its plain torch
version.

Ported from the JAX package's ``ops/pallas_hist.py``
(``leaf_histogram_pallas``).  The contract is the JAX package's: X (N, F)
uint8 or uint16 row-major bins, grad and hess (N,) f32 (or float64, the
f64 form of ``tpu_use_dp``), leaf_id (N,) int32, the target leaf,
row_mult (N,) or None; the (F, B, 3) histogram, in the weights' dtype,
sums [g * m, h * m, m] with m = (leaf_id == leaf) * row_mult.  The JAX
package falls back to its XLA one-hot path where the TPU's VMEM cannot
hold a bin width (``supports_bins``, above ~2048 bins); the port plans
every bin count up to 65,536, and there is no fallback.

The kernel (``csrc/leaf_hist.cu``, ``leaf_plan``) is one launch of a
persistent grid that reads the leaf ids once: each warp picks out the
leaf's rows with a ballot and adds their weight rows w3 into its block's
shared histogram of all F features; each block adds its non-zero cells
into the int64 sums, and a second launch converts them and zeroes them
for the next call (so no memset).  The sums are the tree's 64-bit fixed
point (``fixed_point_exponents``), exact and order-free, so B5 gives B4's
histogram at K = 1 to the bit, and exact growth trains the model text of
wave growth at width 1.  Where one block cannot hold the cells (uint16
at 1023 bins, f64 past 63 bins at the flagship's 28 features), B5 runs
B4's row-major pass with one child slot (``csrc/wave_fused.cu``,
``lgbt_wave_hist``: a select pass lists the leaf's rows, the histogram
pass, a conversion).  The leaf stays a device tensor: a call reads only
shapes and makes no host read and no host-to-device copy, so the fused
iteration captures it; a leaf id no row holds (-1) gives a zero
histogram.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel (building it on first use) or raises.  The wrapper
counts its calls in ``leaf_histogram.launches`` and their device
operations in ``leaf_histogram.device_launches``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .. import _build
from ..utils.log import LightGBMError
from .histogram import _weights, weight_rows
from .wave_kernels import (BIN_DTYPES, MAX_BINS, WEIGHT_DTYPES, _exps,
                           _list_buffers, _sms, _sums_view, check_rows,
                           hist_plan, histogram_plain, leaf_sum_words,
                           wave_histogram_rowmajor_plain)

# csrc/leaf_hist.cu: a block's static shared memory (the warps' queues of
# 160 rows)
LEAF_STATIC_SMEM = 4 * 32 * 160
# the cells a block holds: within the 232,448 bytes an H100 block may opt
# into, beside the static shared memory
LEAF_SMEM_BUDGET = 200 * 1024


class LeafPlan(NamedTuple):
    """B5's launch plan (``leaf_plan``); the kernel entry launches one
    block of 1024 threads on each SM (the card's resident blocks)."""
    fused: int      # 1: the one-scan kernel; 0: B4's plan at K = 1
    smem: int       # dynamic shared memory of a block, bytes


@lru_cache(maxsize=256)
def leaf_plan(F: int, B: int, wide: bool = False) -> LeafPlan:
    """The one-scan kernel's plan where one block's shared memory holds the
    (F, B, 3) cells of 64 bits (128 when wide); ``fused`` 0 where it
    cannot (B4's plan then).  A thread block cluster holding them in
    distributed shared memory ran 3-24x slower than B4's plan on an H100
    (csrc/leaf_hist.cu)."""
    smem = F * B * 3 * (16 if wide else 8)
    return LeafPlan(0, 0) if smem > LEAF_SMEM_BUDGET else LeafPlan(1, smem)


def plan_launches(plan: LeafPlan, finish: bool = True) -> int:
    """Device operations of one call on plan given a workspace: the
    one-scan kernel and the conversion (a memset and the kernel when
    deferred); B4's chain is a memset, the select pass, the histogram
    pass and the conversion (none when deferred)."""
    if not plan.fused:
        return 4 if finish else 3
    return 2


def leaf_histogram_plain(X, grad, hess, leaf_id, leaf, row_mult,
                         num_bins: int):
    """(F, B, 3): hist[f, b] sums the leaf's masked weights over the rows
    with X[row, f] == b, in grad's dtype."""
    return histogram_plain(X.t(), _weights(grad, hess, leaf_id, leaf,
                                           row_mult), num_bins)


def _leaf_tensor(leaf, dev):
    """The target leaf as a (1,) int32 tensor on dev, built on the device
    (a fill, never a host-to-device copy that would wait for the stream)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.numel() != 1 or leaf.dtype not in (torch.int32, torch.int64):
            raise LightGBMError("leaf: expected one integer, got %s %s"
                                % (leaf.dtype, tuple(leaf.shape)))
        if leaf.device != dev:
            raise LightGBMError("leaf is on %s, X on %s"
                                % (leaf.device, dev))
        return leaf.reshape(1).to(torch.int32)
    return torch.full((1,), int(leaf), dtype=torch.int32, device=dev)


def _check(X, grad, hess, leaf_id, row_mult, num_bins, w3, exps):
    """Raise on inputs the path does not take, reading shapes only.
    Given w3, neither the kernel nor the plain version reads grad, hess
    or row_mult, and they go unchecked (None is fine): the grower's
    splits pass w3 alone."""
    dev = X.device
    N, F = X.shape if X.dim() == 2 else (None, None)
    bdt = X.dtype if X.dtype in BIN_DTYPES else torch.uint8
    want = [(X, bdt, (N, F), "X"),
            (leaf_id, torch.int32, (N,), "leaf_id")]
    if w3 is None:
        wdt = (grad.dtype if isinstance(grad, torch.Tensor)
               and grad.dtype in WEIGHT_DTYPES else torch.float32)
        want += [(grad, wdt, (N,), "grad"),
                 (hess, wdt, (N,), "hess")]
        if row_mult is not None:
            want.append((row_mult, wdt, (N,), "row_mult"))
    else:
        wdt = w3.dtype if w3.dtype in WEIGHT_DTYPES else torch.float32
        want.append((w3, wdt, (N, 3), "w3"))
    if exps is not None:
        want.append((exps, torch.int32, (3,), "exps"))
    for t, dtype, shape, name in want:
        if N is None or t.dtype != dtype or tuple(t.shape) != shape:
            raise LightGBMError("%s: expected %s %s, got %s %s"
                                % (name, dtype, shape, t.dtype,
                                   tuple(t.shape)))
        if t.device != dev:
            raise LightGBMError("%s is on %s, X on %s"
                                % (name, t.device, dev))
    if not 1 <= int(num_bins) <= MAX_BINS[bdt]:
        raise LightGBMError("num_bins must be in [1, %d] for %s bins, got %d"
                            % (MAX_BINS[bdt], bdt, num_bins))
    if N < 1 or F < 1:
        raise LightGBMError("empty leaf histogram input")
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("unsupported device %s" % dev)
    if dev.type == "cuda":
        for t, _, _, name in want:
            if not t.is_contiguous():
                raise LightGBMError("%s must be contiguous" % name)
        check_rows(N)


def _launch(X, w3, leaf_id, leaf_t, num_bins, exps, plan, work=None,
            finish=True):
    """B4's chain at K = 1: the select pass, the histogram pass and the
    conversion on plan (hist_plan's first six fields; one slot, so never
    the slot-ordered pass); returns the (F, B, 3) histogram, or with
    finish False the (1, F, B, 3) fixed-point sums (an int64 view of the
    workspace; ``wave_kernels.finish_hist`` converts them)."""
    N, F = X.shape
    B = int(num_bins)
    wide = w3.dtype == torch.float64
    rows, acc, work, hist = _list_buffers(N, 1, F, B, X.device, (F, B, 3),
                                          work, wide, finish)
    err = _build.library().lgbt_wave_hist(
        *[t.data_ptr() for t in (X, leaf_id, w3, leaf_t, exps)], rows, acc,
        0 if hist is None else hist.data_ptr(), F, N, B, 1, *plan, 0, 1, 0,
        0, int(X.dtype == torch.uint16), int(wide), int(finish),
        _build.stream(X.device))
    _build.check(err, "leaf_hist")
    if not finish:
        return _sums_view(work, N, 1, F, B, wide)
    return hist


def _sum_region(work, words, dev, tail):
    """`words` int64 words of work: its last ones (tail, B5's zeroed
    sums) or its first ones (the deferred form's sums, zeroed
    by the launch); a new zeroed region when work is None."""
    if work is None:
        return torch.zeros(words, dtype=torch.int64, device=dev)
    if (work.dtype != torch.int64 or work.device != dev or work.dim() != 1
            or work.numel() < 2 * words or not work.is_contiguous()):
        raise LightGBMError("work: expected a contiguous int64 vector of at "
                            "least %d on %s (list_workspace), got %s %s on "
                            "%s" % (2 * words, dev, work.dtype,
                                    tuple(work.shape), work.device))
    return work[work.numel() - words:] if tail else work[:words]


def _launch_fused(X, w3, leaf_id, leaf_t, num_bins, exps, plan, work=None,
                  finish=True):
    """The one-scan kernel on plan (``leaf_plan``, fused): the (F, B, 3)
    histogram, or with finish False the (1, F, B, 3) int64 sums ((1, F,
    B, 3, 2) when wide), a view of the workspace's first words that lives
    until the next launch on it.  A finished call sums into the
    workspace's last ``leaf_sum_words`` words, which must be zero
    (``list_workspace`` zeroes them and every finished call's conversion
    leaves them so)."""
    N, F = X.shape
    B = int(num_bins)
    wide = w3.dtype == torch.float64
    dev = X.device
    words = leaf_sum_words(F, B, wide)
    sums = _sum_region(work, words, dev, finish)
    hist = (torch.empty((F, B, 3), dtype=w3.dtype, device=dev) if finish
            else None)
    err = _build.library().lgbt_leaf_hist(
        *[t.data_ptr() for t in (X, leaf_id, w3, leaf_t, exps, sums)],
        0 if hist is None else hist.data_ptr(), F, N, B,
        int(X.dtype == torch.uint16), int(wide), int(not finish),
        _build.stream(dev))
    _build.check(err, "leaf_hist")
    if not finish:
        return sums.view((1, F, B, 3, 2) if wide else (1, F, B, 3))
    return hist


def leaf_histogram(X, grad, hess, leaf_id, leaf, row_mult, num_bins: int,
                   *, w3=None, exps=None, work=None, finish: bool = True):
    """Leaf histogram (kernel B5): the (F, B, 3) histogram of the rows
    whose leaf id is ``leaf`` (an int or a one-element integer tensor on
    X's device), weighted by row_mult (None for all ones).

    w3: the kernel's weight rows, ``weight_rows(grad, hess, row_mult)``;
    exps: their fixed-point exponents, ``fixed_point_exponents(w3)``.
    Each is computed here when None; the grower computes both once a
    tree and passes grad, hess and row_mult as None.  Given w3, the
    plain version sums w3 masked to the leaf, which equals its sum of
    grad, hess and row_mult to the bit.  work: the list passes'
    workspace (``ops/wave_kernels.py list_workspace`` at K = 1), a new one
    each call when None (its last ``leaf_sum_words`` words zero, as
    ``list_workspace`` makes them); the plain version does not use it.

    The kernel's plan is ``leaf_plan``'s, from shapes alone, so no call
    reads the leaf's row count back to the host; where it is not fused,
    B4's at K = 1 (``hist_plan``, planned from N: a small leaf's short
    list takes fewer of the plan's shares on the device).

    finish=False is the deferred-finish form: the kernel stops before the
    conversion and returns the (1, F, B, 3) int64 fixed-point sums (a
    view of the workspace), which a distributed learner adds over the
    ranks before ``wave_kernels.finish_hist``; the plain version returns
    its (F, B, 3) histogram either way."""
    _check(X, grad, hess, leaf_id, row_mult, num_bins, w3, exps)
    leaf_t = _leaf_tensor(leaf, X.device)
    if X.device.type == "cpu":
        if w3 is not None:
            # B4's plain version at K = 1: w3 masked to the leaf, the same
            # weights as _weights' to the bit (m in {0, 1} multiplies last)
            return wave_histogram_rowmajor_plain(X, leaf_id, w3, leaf_t,
                                                 num_bins)[0]
        return leaf_histogram_plain(X, grad, hess, leaf_id, leaf_t,
                                    row_mult, num_bins)
    if w3 is None:
        w3 = weight_rows(grad, hess, row_mult)
    N, F = X.shape
    wide = w3.dtype == torch.float64
    exps = _exps(w3, exps)
    plan = leaf_plan(F, int(num_bins), wide)
    if plan.fused:
        out = _launch_fused(X, w3, leaf_id, leaf_t, num_bins, exps, plan,
                            work, finish)
    else:
        out = _launch(X, w3, leaf_id, leaf_t, num_bins, exps,
                      hist_plan(F, N, int(num_bins), 1, _sms(X.device),
                                False, wide)[:6], work, finish)
    leaf_histogram.launches += 1
    leaf_histogram.device_launches += plan_launches(plan, finish)
    for form, on in (("uint16", X.dtype == torch.uint16),
                     ("f64", wide), ("deferred", not finish)):
        if on:
            leaf_histogram.form_launches[form] += 1
    return out


leaf_histogram.launches = 0
# the device operations of those calls (plan_launches)
leaf_histogram.device_launches = 0
# the launches of its uint16, f64 and deferred-finish forms
leaf_histogram.form_launches = {"uint16": 0, "f64": 0, "deferred": 0}
