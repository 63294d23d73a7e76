"""Objective functions — gradients and hessians in f32 on the device.

Ported from the JAX package's ``objectives.py``: the regression losses
L2, L1, Huber, Fair and Poisson (regression_objective.hpp),
``BinaryLogloss`` (binary_objective.hpp:13-154, with is_unbalance and
scale_pos_weight) and the multiclass softmax and one-vs-all objectives
(multiclass_objective.hpp) and ``LambdarankNDCG`` (rank_objective.hpp).
A multiclass score is (num_class, num_data), the reference's
column-major flat layout (``score[k * num_data + i]``); its gradients
come back flat, as the JAX package returns them.  Lambdarank's pairwise
lambdas run on the device in plain torch over padded query buckets (the
JAX package's ``_lambdarank_device`` is XLA, not a Pallas kernel), with
static shapes and no host read, so the fused iteration captures them in
its tree graph.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .io.metadata import Metadata
from .utils.config import Config
from .utils.log import Log


class ObjectiveFunction:
    name = "base"

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        self.num_data = num_data
        self.device = device
        self.label = (None if metadata.label is None else
                      torch.as_tensor(np.asarray(metadata.label,
                                                 np.float32), device=device))
        self.weights = (None if metadata.weights is None else
                        torch.as_tensor(np.asarray(metadata.weights,
                                                   np.float32),
                                        device=device))

    def get_gradients(self, score):
        raise NotImplementedError

    def convert_output(self, x):
        return x

    def is_constant_hessian(self) -> bool:
        return False

    def boost_from_average(self) -> bool:
        return False

    def skip_empty_class(self) -> bool:
        return False

    def num_tree_per_iteration(self) -> int:
        return 1

    def to_string(self) -> str:
        return self.name


class RegressionL2loss(ObjectiveFunction):
    """g = score - label, h = 1."""
    name = "regression"

    def get_gradients(self, score):
        g = score - self.label
        h = torch.ones_like(score)
        if self.weights is not None:
            return g * self.weights, h * self.weights
        return g, h

    def is_constant_hessian(self) -> bool:
        return self.weights is None

    def boost_from_average(self) -> bool:
        return True


# f32(sqrt(2 pi)), as the JAX package's f32 jnp.sqrt computes it
_SQRT_2PI = float(np.sqrt(np.float32(2 * math.pi)))


def _approx_hessian_with_gaussian(score, label, g, eta, w=1.0):
    """Common::ApproximateHessianWithGaussian (utils/common.h:486-495)."""
    x = (score - label).abs()
    a = 2.0 * g.abs() * w
    c = torch.clamp((score.abs() + label.abs()) * eta, min=1.0e-10)
    return w * torch.exp(-x * x / (2.0 * c * c)) * a / (c * _SQRT_2PI)


class RegressionL1loss(ObjectiveFunction):
    """regression_objective.hpp:78-146: the sign gradient and the
    gaussian-approximated hessian."""
    name = "regression_l1"

    def __init__(self, config: Config):
        self.eta = float(config.gaussian_eta)

    def get_gradients(self, score):
        w = self.weights if self.weights is not None else 1.0
        g = torch.where(score - self.label >= 0.0, 1.0, -1.0) * w
        return g, _approx_hessian_with_gaussian(score, self.label, g,
                                                self.eta, w)

    def boost_from_average(self) -> bool:
        return True


class RegressionHuberLoss(ObjectiveFunction):
    """regression_objective.hpp:149-230."""
    name = "huber"

    def __init__(self, config: Config):
        self.delta = float(config.huber_delta)
        self.eta = float(config.gaussian_eta)

    def get_gradients(self, score):
        diff = score - self.label
        w = self.weights if self.weights is not None else 1.0
        small = diff.abs() <= self.delta
        g = torch.where(small, diff, torch.where(
            diff >= 0.0, self.delta, -self.delta)) * w
        h_large = _approx_hessian_with_gaussian(score, self.label, g,
                                                self.eta, w)
        return g, torch.where(small, torch.ones_like(score) * w, h_large)

    def boost_from_average(self) -> bool:
        return True


class RegressionFairLoss(ObjectiveFunction):
    """regression_objective.hpp:235-296."""
    name = "fair"

    def __init__(self, config: Config):
        self.c = float(config.fair_c)

    def get_gradients(self, score):
        x = score - self.label
        g = self.c * x / (x.abs() + self.c)
        h = self.c * self.c / ((x.abs() + self.c) ** 2)
        return _apply_weights(g, h, self.weights)

    def boost_from_average(self) -> bool:
        return True


class RegressionPoissonLoss(ObjectiveFunction):
    """regression_objective.hpp:299-355: this line's Poisson works on the
    raw score, with h = score + max_delta_step."""
    name = "poisson"

    def __init__(self, config: Config):
        self.max_delta_step = float(config.poisson_max_delta_step)

    def get_gradients(self, score):
        return _apply_weights(score - self.label,
                              score + self.max_delta_step, self.weights)

    def boost_from_average(self) -> bool:
        return True


def _apply_weights(g, h, w):
    if w is None:
        return g, h
    return g * w, h * w


def _positive(label):
    return label > 0


class BinaryLogloss(ObjectiveFunction):
    """binary_objective.hpp:13-154; ``is_pos`` picks the positive rows
    from the labels (one class against the rest, under OVA)."""
    name = "binary"

    def __init__(self, config: Optional[Config] = None, is_pos=None,
                 sigmoid: Optional[float] = None):
        if config is not None:
            self.sigmoid = float(config.sigmoid)
            self.scale_pos_weight = float(config.scale_pos_weight)
            self.is_unbalance = bool(config.is_unbalance)
        else:
            self.sigmoid = 1.0 if sigmoid is None else float(sigmoid)
            self.scale_pos_weight = 1.0
            self.is_unbalance = False
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero",
                      self.sigmoid)
        self._is_pos = is_pos if is_pos is not None else _positive

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        pos_mask = self._is_pos(np.asarray(metadata.label))
        cnt_pos = int(pos_mask.sum())
        cnt_neg = int(num_data - cnt_pos)
        self.trainable = not (cnt_pos == 0 or cnt_neg == 0)
        if not self.trainable:
            Log.warning("Only contain one class.")
        lw = [1.0, 1.0]
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                lw[0] = cnt_pos / cnt_neg
            else:
                lw[1] = cnt_neg / cnt_pos
        lw[1] *= self.scale_pos_weight
        Log.info("Number of positive: %d, number of negative: %d",
                 cnt_pos, cnt_neg)
        self.sign = torch.as_tensor(
            np.where(pos_mask, 1.0, -1.0).astype(np.float32), device=device)
        self.label_weight = torch.as_tensor(
            np.where(pos_mask, lw[1], lw[0]).astype(np.float32),
            device=device)

    def get_gradients(self, score):
        if not self.trainable:
            z = torch.zeros(self.num_data, dtype=score.dtype,
                            device=score.device)
            return z, z
        # binary_objective.hpp:94-97
        response = -self.sign * self.sigmoid / (
            1.0 + torch.exp(self.sign * self.sigmoid * score))
        abs_resp = response.abs()
        g = response * self.label_weight
        h = abs_resp * (self.sigmoid - abs_resp) * self.label_weight
        if self.weights is not None:
            g = g * self.weights
            h = h * self.weights
        return g, h

    def convert_output(self, x):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(x)))

    def skip_empty_class(self) -> bool:
        return True

    def to_string(self) -> str:
        return "binary sigmoid:%g" % self.sigmoid


class MulticlassSoftmax(ObjectiveFunction):
    """multiclass_objective.hpp:16-137: softmax over the classes,
    h = 2p(1 - p)."""
    name = "multiclass"

    def __init__(self, config: Optional[Config] = None,
                 num_class: Optional[int] = None):
        self.num_class = int(config.num_class if config is not None
                             else num_class)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        lab = np.asarray(metadata.label).astype(np.int32)
        if lab.min() < 0 or lab.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d)", self.num_class)
        self.label_int = torch.as_tensor(lab, device=device)

    def get_gradients(self, score):
        score = score.reshape(self.num_class, self.num_data)
        p = torch.exp(score - score.amax(dim=0, keepdim=True))
        p = p / p.sum(dim=0, keepdim=True)
        classes = torch.arange(self.num_class, device=score.device)
        onehot = (classes[:, None] == self.label_int[None, :]).to(p.dtype)
        g = p - onehot
        h = 2.0 * p * (1.0 - p)
        if self.weights is not None:
            g = g * self.weights[None, :]
            h = h * self.weights[None, :]
        return g.reshape(-1), h.reshape(-1)

    def convert_output(self, x):
        x = np.asarray(x, dtype=np.float64)
        e = np.exp(x - x.max(axis=-1, keepdims=True))
        return e / e.sum(axis=-1, keepdims=True)

    def skip_empty_class(self) -> bool:
        return True

    def num_tree_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return "multiclass num_class:%d" % self.num_class


def _make_is_pos(i: int):
    return lambda label: np.asarray(label).astype(np.int32) == i


class MulticlassOVA(ObjectiveFunction):
    """multiclass_objective.hpp:139-248: one BinaryLogloss a class."""
    name = "multiclassova"

    def __init__(self, config: Optional[Config] = None,
                 num_class: Optional[int] = None, sigmoid: float = 1.0):
        if config is not None:
            self.num_class = int(config.num_class)
            self.sigmoid = float(config.sigmoid)
            self.binary = [BinaryLogloss(config, is_pos=_make_is_pos(i))
                           for i in range(self.num_class)]
        else:
            self.num_class = int(num_class)
            self.sigmoid = float(sigmoid)
            self.binary = [BinaryLogloss(sigmoid=sigmoid,
                                         is_pos=_make_is_pos(i))
                           for i in range(self.num_class)]

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        for b in self.binary:
            b.init(metadata, num_data, device)

    def get_gradients(self, score):
        score = score.reshape(self.num_class, self.num_data)
        gh = [b.get_gradients(score[i]) for i, b in enumerate(self.binary)]
        return (torch.cat([g for g, _ in gh]),
                torch.cat([h for _, h in gh]))

    def convert_output(self, x):
        return 1.0 / (1.0 + np.exp(-self.sigmoid * np.asarray(x)))

    def skip_empty_class(self) -> bool:
        return True

    def num_tree_per_iteration(self) -> int:
        return self.num_class

    def to_string(self) -> str:
        return "multiclassova num_class:%d sigmoid:%g" % (self.num_class,
                                                          self.sigmoid)


def default_label_gain(size: int = 31) -> List[float]:
    """label_gain = 2^i - 1 (src/io/config.cpp:273-277)."""
    return [float((1 << i) - 1) for i in range(size)]


def get_discounts(n: int) -> np.ndarray:
    """DCG position discount 1/log2(2+i) (dcg_calculator.cpp:22-25)."""
    return 1.0 / np.log2(2.0 + np.arange(n))


def _max_dcg_at_k(k: int, label: np.ndarray, label_gain: np.ndarray) -> float:
    """DCGCalculator::CalMaxDCGAtK (dcg_calculator.cpp:28-50)."""
    k = min(k, len(label))
    sorted_label = np.sort(label.astype(np.int32))[::-1][:k]
    return float((label_gain[sorted_label] * get_discounts(k)).sum())


# f32 entries of the pairwise (block, w, w) tensors a query block holds:
# about 64 MB each, as the JAX package's blocks
_PAIR_BLOCK_ENTRIES = 16_000_000


class LambdarankNDCG(ObjectiveFunction):
    """rank_objective.hpp:19-244: pairwise lambdas weighted by |delta NDCG|,
    with the exact sigmoid instead of the reference's lookup table, as
    in the JAX package.

    The queries are bucketed by padded width (powers of two), each
    bucket a (Qb, w) table of row indices; a bucket's queries run in
    blocks whose pairwise (block, w, w) tensors stay near 64 MB each.
    ``get_gradients`` is device torch with static shapes and no host
    read; ``get_gradients_host`` is the reference-shaped numpy oracle."""
    name = "lambdarank"

    def __init__(self, config: Optional[Config] = None):
        config = config or Config()
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero",
                      self.sigmoid)
        self.label_gain = np.asarray(config.label_gain
                                     or default_label_gain())
        self.optimize_pos_at = int(config.max_position)

    def init(self, metadata: Metadata, num_data: int, device) -> None:
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal("Lambdarank tasks (objective=lambdarank) require "
                      "query information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.labels_np = np.asarray(metadata.label)
        self.weights_np = (None if metadata.weights is None
                           else np.asarray(metadata.weights))
        self.num_queries = len(self.qb) - 1
        self.inverse_max_dcgs = np.zeros(self.num_queries)
        for q in range(self.num_queries):
            lab = self.labels_np[self.qb[q]:self.qb[q + 1]]
            m = _max_dcg_at_k(self.optimize_pos_at, lab, self.label_gain)
            self.inverse_max_dcgs[q] = 1.0 / m if m > 0.0 else m
        self._build_device_layout()

    def _build_device_layout(self) -> None:
        """Per bucket of padded width w: the (Qb, w) row indices (padding
        clamped), valid mask, labels, the queries' counts and inverse max
        DCGs, the discounts, and the rows with their table positions
        (row-major), all on the device; and the block of queries whose
        pairwise tensors stay near _PAIR_BLOCK_ENTRIES."""
        dev = self.device
        counts = np.diff(self.qb)
        self._gain = torch.as_tensor(self.label_gain.astype(np.float32),
                                     device=dev)
        widths = np.maximum(
            2, 2 ** np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64))
        self._buckets = []
        for w in np.unique(widths):
            qs = np.flatnonzero(widths == w)
            c = counts[qs]
            w = int(w)
            slot = np.arange(w)[None, :]
            valid = slot < c[:, None]
            idx = np.minimum(self.qb[:-1][qs][:, None] + slot,
                             self.num_data - 1)
            labels = np.where(valid, self.labels_np[idx].astype(np.int64), 0)
            qi, si = np.nonzero(valid)

            def put(a, dtype):
                return torch.as_tensor(np.ascontiguousarray(a, dtype=dtype),
                                       device=dev)
            self._buckets.append({
                "idx": put(idx, np.int64), "valid": put(valid, np.bool_),
                "labels": put(labels, np.int64),
                "counts": put(c, np.int64),
                "inv": put(self.inverse_max_dcgs[qs], np.float32),
                "discounts": put(get_discounts(w), np.float32),
                "rows": put(idx[valid], np.int64),
                "tabpos": put(qi * w + si, np.int64),
                "block": max(1, min(len(qs), _PAIR_BLOCK_ENTRIES // (w * w))),
            })

    def pair_block_bytes(self) -> int:
        """Bytes of one f32 pairwise (block, w, w) tensor at the largest
        bucket's block: what each of a block's temporaries takes."""
        return max(4 * b["block"] * int(b["discounts"].numel()) ** 2
                   for b in self._buckets)

    def get_gradients(self, score):
        """The lambdas and hessians at score (N,), f32 on the score's
        device, scattered back from each bucket's table."""
        score = score.to(torch.float32)
        lam = torch.zeros(self.num_data, dtype=torch.float32,
                          device=score.device)
        hes = torch.zeros_like(lam)
        for b in self._buckets:
            s = torch.where(b["valid"], score[b["idx"]], -math.inf)
            nq = s.shape[0]
            parts = [_lambdarank_block(
                s[q:q + b["block"]], b["labels"][q:q + b["block"]],
                b["counts"][q:q + b["block"]], b["inv"][q:q + b["block"]],
                b["discounts"], self._gain, self.sigmoid)
                for q in range(0, nq, b["block"])]
            lb = torch.cat([p[0] for p in parts]).reshape(-1)[b["tabpos"]]
            hb = torch.cat([p[1] for p in parts]).reshape(-1)[b["tabpos"]]
            lam.index_copy_(0, b["rows"], lb)
            hes.index_copy_(0, b["rows"], hb)
        return _apply_weights(lam, hes, self.weights)

    def get_gradients_host(self, score):
        """Reference-shaped numpy path (rank_objective.hpp:100-190), the
        tests' oracle: (lambdas, hessians) as f32 numpy arrays."""
        score = np.asarray(score, dtype=np.float64)
        lambdas = np.zeros(self.num_data, dtype=np.float32)
        hessians = np.zeros(self.num_data, dtype=np.float32)
        for q in range(self.num_queries):
            s, e = self.qb[q], self.qb[q + 1]
            self._one_query(score[s:e], self.labels_np[s:e],
                            self.inverse_max_dcgs[q],
                            lambdas[s:e], hessians[s:e])
        if self.weights_np is not None:
            lambdas *= self.weights_np
            hessians *= self.weights_np
        return lambdas, hessians

    def _one_query(self, score, label, inv_max_dcg, out_l, out_h):
        cnt = len(score)
        if cnt <= 1 or inv_max_dcg <= 0:
            return
        sorted_idx = np.argsort(-score, kind="stable")
        ranked_score = score[sorted_idx]
        ranked_label = label[sorted_idx].astype(np.int32)
        best_score = ranked_score[0]
        worst_idx = cnt - 1
        if worst_idx > 0 and ranked_score[worst_idx] == -np.inf:
            worst_idx -= 1
        worst_score = ranked_score[worst_idx]
        discounts = get_discounts(cnt)
        gains = self.label_gain[ranked_label]
        # pair (i = higher rank, j = lower rank) matrices in ranked order
        valid = ranked_label[:, None] > ranked_label[None, :]
        finite = np.isfinite(ranked_score)
        valid &= finite[:, None] & finite[None, :]
        delta_score = ranked_score[:, None] - ranked_score[None, :]
        dcg_gap = gains[:, None] - gains[None, :]
        paired_discount = np.abs(discounts[:, None] - discounts[None, :])
        delta_ndcg = dcg_gap * paired_discount * inv_max_dcg
        if best_score != worst_score:
            delta_ndcg = delta_ndcg / (0.01 + np.abs(delta_score))
        p_lambda = 2.0 / (1.0 + np.exp(2.0 * delta_score * self.sigmoid))
        p_hess = p_lambda * (2.0 - p_lambda)
        p_lambda = np.where(valid, -p_lambda * delta_ndcg, 0.0)
        p_hess = np.where(valid, 2.0 * p_hess * delta_ndcg, 0.0)
        lam = p_lambda.sum(axis=1) - p_lambda.sum(axis=0)
        hes = p_hess.sum(axis=1) + p_hess.sum(axis=0)
        out_l[sorted_idx] += lam.astype(np.float32)
        out_h[sorted_idx] += hes.astype(np.float32)


def _lambdarank_block(s, labels, counts, inv_max_dcg, discounts, gain,
                      sigmoid):
    """Pairwise lambdas of a block of padded queries (the JAX package's
    ``_lambdarank_one_query``, vectorized over the block): s (B, w)
    scores with -inf padding, labels (B, w), counts (B,), inv_max_dcg
    (B,).  Returns (lam, hes), each (B, w) in the queries' own order."""
    order = torch.argsort(-s, dim=1, stable=True)
    rs = torch.gather(s, 1, order)
    rl = torch.gather(labels, 1, order)
    gains = gain[rl]
    finite = torch.isfinite(rs)
    valid = ((rl[:, :, None] > rl[:, None, :]) & finite[:, :, None]
             & finite[:, None, :])
    delta_score = rs[:, :, None] - rs[:, None, :]
    dcg_gap = gains[:, :, None] - gains[:, None, :]
    paired_discount = (discounts[:, None] - discounts[None, :]).abs()
    delta_ndcg = dcg_gap * paired_discount * inv_max_dcg[:, None, None]
    best_score = rs[:, 0]
    wi = torch.clamp(counts - 1, min=0)
    wi = torch.where((wi > 0) & torch.isneginf(
        torch.gather(rs, 1, wi[:, None])[:, 0]), wi - 1, wi)
    worst_score = torch.gather(rs, 1, wi[:, None])[:, 0]
    spread = (best_score != worst_score)[:, None, None]
    norm = torch.where(spread, 1.0 / (0.01 + delta_score.abs()), 1.0)
    delta_ndcg = delta_ndcg * norm
    p_lambda = 2.0 / (1.0 + torch.exp(2.0 * delta_score * sigmoid))
    p_hess = p_lambda * (2.0 - p_lambda)
    p_lambda = torch.where(valid, -p_lambda * delta_ndcg, 0.0)
    p_hess = torch.where(valid, 2.0 * p_hess * delta_ndcg, 0.0)
    lam = p_lambda.sum(dim=2) - p_lambda.sum(dim=1)
    hes = p_hess.sum(dim=2) + p_hess.sum(dim=1)
    live = ((counts > 1) & (inv_max_dcg > 0.0))[:, None]
    lam = torch.where(live, lam, 0.0)
    hes = torch.where(live, hes, 0.0)
    # back to the queries' own order
    return (torch.empty_like(lam).scatter_(1, order, lam),
            torch.empty_like(hes).scatter_(1, order, hes))


_OBJECTIVES = {
    "regression": RegressionL2loss, "regression_l2": RegressionL2loss,
    "mean_squared_error": RegressionL2loss, "mse": RegressionL2loss,
    "regression_l1": RegressionL1loss, "mean_absolute_error": RegressionL1loss,
    "mae": RegressionL1loss,
    "huber": RegressionHuberLoss,
    "fair": RegressionFairLoss,
    "poisson": RegressionPoissonLoss,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax, "softmax": MulticlassSoftmax,
    "multiclassova": MulticlassOVA, "multiclass_ova": MulticlassOVA,
    "ova": MulticlassOVA, "ovr": MulticlassOVA,
    "lambdarank": LambdarankNDCG,
}


def create_objective(name: str,
                     config: Config) -> Optional[ObjectiveFunction]:
    """ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:9-35)."""
    if name in ("none", "null", "custom", "na"):
        return None
    cls = _OBJECTIVES.get(name)
    if cls is None:
        Log.fatal("Unknown objective type name: %s", name)
    if cls is RegressionL2loss:
        return cls()
    return cls(config)


def load_objective_from_string(s: str) -> Optional[ObjectiveFunction]:
    """Round-trip from model files (objective_function.cpp:37-56); an
    objective neither package knows loads as None (raw scores)."""
    toks = s.split()
    if not toks:
        return None
    name = toks[0]
    kv = dict(t.partition(":")[::2] for t in toks[1:] if ":" in t)
    if name == "binary":
        return BinaryLogloss(sigmoid=float(kv.get("sigmoid", 1.0)))
    if name == "multiclass":
        return MulticlassSoftmax(num_class=int(kv.get("num_class", 2)))
    if name == "multiclassova":
        return MulticlassOVA(num_class=int(kv.get("num_class", 2)),
                             sigmoid=float(kv.get("sigmoid", 1.0)))
    cls = _OBJECTIVES.get(name)
    if cls is None:
        Log.warning("objective %s is not in lightgbm_tpu_torch; predictions "
                    "are raw scores", name)
        return None
    if cls is RegressionL2loss:
        return cls()
    return cls(Config())
