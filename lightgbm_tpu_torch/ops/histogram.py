"""Per-leaf weights and sums — the LeafSplits side of a leaf histogram —
and the JAX package's XLA histogram engines, ``onehot`` and ``scatter``.

Ported from the JAX package's ``ops/histogram.py`` (``_weights``,
``leaf_sums``, ``_scatter_accumulate``, ``_onehot_accumulate``,
``leaf_histogram_scatter``, ``leaf_histogram_onehot``, and the wave
engine's child-match contraction of its ``ops/wave.py``).  Rows outside
the target leaf contribute zero through the mask, which also carries the
bagging row multipliers; the product order is the JAX package's, g *
(mask * row_mult), so the port's weights equal its weights bit for bit.

The engines are computations the JAX package runs outside any Pallas
kernel, so plain torch is their port (``engine_histogram``, on row-major
bins X (N, G), uint8, uint16 or 4-bit packed):

* ``onehot``: chunks of rows as a (C, G * B) one-hot in the weights'
  dtype, contracted with the (C, 3K) child-masked weights by
  ``torch.matmul`` with TF32 off (the JAX package's (C, W) child-match
  contraction, ``ops/wave.py`` ``_slot_hist``; one slot at the root and
  under exact growth).
* ``scatter``: per-feature ``index_add_`` of the weights quantized in the
  tree's fixed point (``fixed_point_exponents``): f32 weights as one
  int64 each, float64 weights (``tpu_use_dp``) as four signed 32-bit
  limbs of their 128-bit value.  Integer sums are exact and order-free
  (a float ``index_add_`` on CUDA is not deterministic), so fused runs
  equal staged ones, and the conversion is the kernels' (``to_f32``,
  ``to_f64`` of ``csrc/fixed_point.cuh``): scatter's histograms equal
  B5's to the bit on the same rows.

The JAX package's exact grower histograms only a leaf's rows, gathered
into capacity tiers (its ``ops/grow.py``); the port's engines run over
every row with the others masked to zero, which gives the same sums (a
masked row adds an exact zero) with no host read, so the fused iteration
captures them.
"""
from __future__ import annotations

import torch

from .pack import packed_column, unpack4
from .wave_kernels import bins_i32, indexable


def _weights(grad, hess, leaf_id, leaf, row_mult):
    """(N, 3) [g, h, 1] masked to the target leaf and row multipliers.
    ``leaf`` is an int or a one-element integer tensor."""
    mask = (leaf_id == leaf).to(grad.dtype)
    if row_mult is not None:
        mask = mask * row_mult
    return torch.stack([grad * mask, hess * mask, mask], dim=-1)


def weight_rows(grad, hess, row_mult):
    """(N, 3) [g * m, h * m, m], m = row_mult (ones when None): the weight
    rows the histogram kernels sum, made once a tree by the growers (one
    product order for every grower, so their kernels see the same
    bits)."""
    if row_mult is None:
        row_mult = torch.ones_like(grad)
    return torch.stack([grad * row_mult, hess * row_mult, row_mult],
                       dim=-1).contiguous()


def leaf_sums(grad, hess, leaf_id, leaf, row_mult):
    """Leaf total (sum_g, sum_h, count) — LeafSplits::Init
    (leaf_splits.hpp)."""
    return _weights(grad, hess, leaf_id, leaf, row_mult).sum(dim=0)


# ------------------------------------------------------- the XLA engines
ENGINE_MODES = ("onehot", "scatter")
# elements of one one-hot chunk (C x G x B): the chunk's rows shrink as
# the bins widen, so a chunk holds at most this many (256 MB in f32)
_ONEHOT_ELEMS = 1 << 26


def _child_weights(leaf_id, w3, child_id):
    """(N, K, 3): w3 masked to the rows whose leaf id is child_id[k] (an
    inactive slot, -1, holds no row)."""
    match = ((leaf_id[:, None] == child_id[None, :])
             & (child_id[None, :] >= 0)).to(w3.dtype)        # (N, K)
    return match[:, :, None] * w3[:, None, :]


def _rows(X, lo, hi, logical_cols):
    """Rows lo:hi of the row-major bins as int64, unpacked."""
    xc = indexable(X)[lo:hi]
    if logical_cols:
        return unpack4(xc, logical_cols).long()
    return bins_i32(xc).long()


def _column(X, f: int, logical_cols):
    """Column f of the row-major bins as int64, unpacked."""
    Xi = indexable(X)
    if not logical_cols:
        return bins_i32(Xi[:, f]).long()
    p, high = packed_column(torch.tensor(f), logical_cols)
    raw = bins_i32(Xi[:, int(p)])
    return (raw >> 4 if bool(high) else raw & 15).long()


def onehot_histogram(X, leaf_id, w3, child_id, num_bins: int,
                     logical_cols: int = 0):
    """(K, G, B, 3) in w3's dtype: each chunk's (C, G * B) one-hot
    contracted with its (C, 3K) child-masked weights; bins >= B drop."""
    n = X.shape[0]
    G = logical_cols or X.shape[1]
    B, K = int(num_bins), child_id.shape[0]
    chunk = max(256, min(n, _ONEHOT_ELEMS // max(G * B, 1)))
    acc = torch.zeros((G * B, 3 * K), dtype=w3.dtype, device=w3.device)
    feat = torch.arange(G, device=w3.device) * B
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            x = _rows(X, lo, hi, logical_cols)                  # (C, G)
            oh = torch.zeros((hi - lo, G * B), dtype=w3.dtype,
                             device=w3.device)
            inb = x < B
            oh.scatter_(1, (feat[None, :] + x.clamp(max=B - 1)),
                        inb.to(w3.dtype))
            wm = _child_weights(leaf_id[lo:hi], w3[lo:hi],
                                child_id).reshape(hi - lo, 3 * K)
            acc += oh.t() @ wm
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return acc.reshape(G, B, K, 3).permute(2, 0, 1, 3).contiguous()


def _pow2(e, dtype):
    """2^e (e an int64 tensor, possibly past 1023) as two factors whose
    product scales exactly."""
    h = e // 2
    one = torch.ones(e.shape, dtype=dtype, device=e.device)
    return torch.ldexp(one, h), torch.ldexp(one, e - h)


def _quantize64(w3, exps):
    """(N, 3) int64: each value of f32 w3 rounded to the nearest multiple
    of 2^-e_c (ties to even), as the kernels' quantize."""
    a, b = _pow2(exps.long(), torch.float64)
    return torch.round(w3.double() * a * b).long()


def _limbs128(w3, exps):
    """(N, 3, 4) int64: each float64 value's 128-bit fixed point
    round(|w| 2^e_c) as four 32-bit limbs, low first, each carrying the
    value's sign (the kernels' quantize128)."""
    a, b = _pow2(exps.long(), torch.float64)
    m = torch.round(w3.abs() * a * b)                          # < 2^126
    limbs = []
    for shift in (96, 64, 32):
        p = float(2.0 ** shift)
        top = torch.floor(m / p)
        limbs.append(top)
        m = m - top * p                                        # exact
    limbs.append(m)
    sign = torch.where(w3 < 0, -1, 1).to(torch.int64)
    return torch.stack([sign * t.long() for t in reversed(limbs)], dim=-1)


def _digits(S):
    """The 32-bit digits, low first, of the integer sum_i S[..., i]
    2^(32 i) (S int64 limb sums), by carry propagation."""
    out, c = [], torch.zeros_like(S[..., 0])
    for i in range(4):
        t = S[..., i] + c
        out.append(t & 0xFFFFFFFF)
        c = t >> 32
    return out


def _to_f64(S, exps):
    """The float64 values of 128-bit sums given as limb sums S (..., 3,
    4), as the kernels' to_f64 rounds them: the magnitude hi * 2^64 +
    lo, each 64-bit half converted correctly rounded, then the sign and
    2^-e_c."""
    neg = _digits(S)[3] >= 2 ** 31
    d = _digits(torch.where(neg[..., None], -S, S))
    two32 = float(2.0 ** 32)
    lo = d[1].double() * two32 + d[0].double()   # one rounding: exact terms
    hi = d[3].double() * two32 + d[2].double()
    m = hi * float(2.0 ** 64) + lo
    a, b = _pow2(-exps.long(), torch.float64)
    return torch.where(neg, -m, m) * a * b


def quantize_rows(w3, exps):
    """(N, 3, L) int64: the weight rows in the tree's fixed point, one
    64-bit value a weight for f32 w3 (L = 1), four 32-bit limbs of its
    128-bit value for float64 w3 (L = 4)."""
    if w3.dtype == torch.float64:
        return _limbs128(w3, exps)
    return _quantize64(w3, exps)[..., None]


def dequantize(S, exps, dtype):
    """Integer sums S (..., 3, L) of quantize_rows' values back to dtype,
    as the kernels convert them (``to_f32``, ``to_f64``)."""
    if dtype == torch.float64:
        return _to_f64(S, exps).contiguous()
    a, b = _pow2(-exps.long(), torch.float64)
    return (S[..., 0].double() * a * b).to(torch.float32).contiguous()


_SPILL = 1024


def scatter_histogram(X, leaf_id, w3, child_id, num_bins: int, exps,
                      logical_cols: int = 0):
    """(K, G, B, 3) in w3's dtype: per feature, an int64 ``index_add_``
    of each listed row's quantized weights at slot * B + bin, then the
    kernels' conversion; bins >= B drop."""
    n, dev = X.shape[0], w3.device
    G = logical_cols or X.shape[1]
    B, K = int(num_bins), child_id.shape[0]
    q = quantize_rows(w3, exps)
    L = q.shape[-1]
    match = (leaf_id[:, None] == child_id[None, :]) & (child_id >= 0)
    slot = torch.where(match.any(dim=1),
                       torch.argmax(match.to(torch.int32), dim=1),
                       torch.full_like(leaf_id, K, dtype=torch.long))
    # rows in no slot (or past the bins) add into _SPILL spare cells
    # after the K * B real ones, spread by row: on the card every add is
    # an atomic, and one spare cell would take them all in series
    acc = torch.zeros((G, K * B + _SPILL, 3 * L), dtype=torch.int64,
                      device=dev)
    qf = q.reshape(n, 3 * L)
    spill = K * B + (torch.arange(n, device=dev) & (_SPILL - 1))
    for f in range(G):
        x = _column(X, f, logical_cols)
        idx = torch.where((x < B) & (slot < K), slot * B + x, spill)
        acc[f].index_add_(0, idx, qf)
    S = acc[:, :K * B].reshape(G, K, B, 3, L).permute(1, 0, 2, 3, 4)
    # a repeated child id's slots all hold the first one's sums
    first = torch.argmax((child_id[:, None] == child_id[None, :])
                         .to(torch.int32), dim=1)
    return dequantize(S.index_select(0, first), exps, w3.dtype)


def engine_histogram(mode, X, leaf_id, w3, child_id, num_bins: int, exps,
                     logical_cols: int = 0):
    """(K, G, B, 3) histograms of the rows whose leaf id is child_id[k]
    (-1: an inactive slot, zeros) by the XLA engine ``mode``, on the
    row-major bins X (N, G) (logical_cols > 0: 4-bit packed); exps: the
    tree's fixed-point exponents (read by ``scatter`` only).  The first
    slot holding a repeated id gets its rows, as in the kernels; the
    others, too, for onehot."""
    if mode == "onehot":
        return onehot_histogram(X, leaf_id, w3, child_id, num_bins,
                                logical_cols)
    return scatter_histogram(X, leaf_id, w3, child_id, num_bins, exps,
                             logical_cols)
