"""Evaluation metrics: the regression losses (L2, RMSE, L1, Huber, Fair,
Poisson), binary logloss, binary error, AUC, the multiclass logloss and
error, and the ranking metrics NDCG and MAP with query weights —
host-side numpy, copied from the JAX package's ``metrics.py`` (parity
targets src/metric/regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp, rank_metric.hpp and map_metric.hpp).  Each metric
declares ``factor_to_bigger_better`` as the reference does.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from .io.metadata import Metadata
from .objectives import (ObjectiveFunction, _max_dcg_at_k,
                         default_label_gain, get_discounts)
from .utils.config import Config
from .utils.log import Log

kEpsilon = 1e-15


class Metric:
    name = "base"
    # early stopping maximizes factor*score: loss-style metrics use -1
    # (regression_metric.hpp:29, binary_metric.hpp:54), AUC/NDCG/MAP use +1
    # (binary_metric.hpp:170, rank_metric.hpp:81, map_metric.hpp:65)
    factor_to_bigger_better = -1.0

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = None if metadata.label is None else np.asarray(metadata.label)
        self.weights = None if metadata.weights is None else np.asarray(metadata.weights)
        if self.weights is None:
            self.sum_weights = float(num_data)
        else:
            self.sum_weights = float(self.weights.sum())

    def get_names(self) -> List[str]:
        return [self.name]

    def eval(self, score: np.ndarray,
             objective: Optional[ObjectiveFunction]) -> List[float]:
        raise NotImplementedError


class _PointwiseRegressionMetric(Metric):
    def loss_on_point(self, label, score):
        raise NotImplementedError

    def average_loss(self, sum_loss, sum_weights):
        return sum_loss / sum_weights

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64)
        # regression metrics apply objective->ConvertOutput when present
        # (regression_metric.hpp:70-84); identity for plain regression
        if objective is not None:
            score = np.asarray(objective.convert_output(score)).reshape(-1)
        loss = self.loss_on_point(self.label, score)
        if self.weights is not None:
            loss = loss * self.weights
        return [float(self.average_loss(loss.sum(), self.sum_weights))]


class L2Metric(_PointwiseRegressionMetric):
    name = "l2"

    def loss_on_point(self, label, score):
        return (score - label) ** 2


class RMSEMetric(_PointwiseRegressionMetric):
    name = "rmse"

    def loss_on_point(self, label, score):
        return (score - label) ** 2

    def average_loss(self, sum_loss, sum_weights):
        return np.sqrt(sum_loss / sum_weights)


class L1Metric(_PointwiseRegressionMetric):
    name = "l1"

    def loss_on_point(self, label, score):
        return np.abs(score - label)


class HuberLossMetric(_PointwiseRegressionMetric):
    name = "huber"

    def __init__(self, config: Config):
        self.delta = float(config.huber_delta)

    def loss_on_point(self, label, score):
        diff = score - label
        return np.where(np.abs(diff) <= self.delta,
                        0.5 * diff * diff,
                        self.delta * (np.abs(diff) - 0.5 * self.delta))


class FairLossMetric(_PointwiseRegressionMetric):
    name = "fair"

    def __init__(self, config: Config):
        self.c = float(config.fair_c)

    def loss_on_point(self, label, score):
        x = np.abs(score - label)
        return self.c * x - self.c * self.c * np.log(1.0 + x / self.c)


class PoissonMetric(_PointwiseRegressionMetric):
    name = "poisson"

    def loss_on_point(self, label, score):
        score = np.maximum(score, 1e-10)
        return score - label * np.log(score)


class _PointwiseBinaryMetric(Metric):
    """binary_metric.hpp:20-108: score converted to probability via the
    objective's sigmoid when available."""

    def loss_on_point(self, label, prob):
        raise NotImplementedError

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        if objective is not None:
            prob = np.asarray(objective.convert_output(score)).reshape(-1)
        else:
            prob = score
        loss = self.loss_on_point(self.label, prob)
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum() / self.sum_weights)]


class BinaryLoglossMetric(_PointwiseBinaryMetric):
    name = "binary_logloss"

    def loss_on_point(self, label, prob):
        pos = label > 0
        p = np.where(pos, prob, 1.0 - prob)
        return -np.log(np.maximum(p, kEpsilon))


class BinaryErrorMetric(_PointwiseBinaryMetric):
    name = "binary_error"

    def loss_on_point(self, label, prob):
        return np.where(prob <= 0.5, label > 0, label <= 0).astype(np.float64)


class AUCMetric(Metric):
    """Weighted AUC via sorted rank-sum with tie blocks
    (binary_metric.hpp:157-259)."""
    name = "auc"
    factor_to_bigger_better = 1.0

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        label = self.label
        w = self.weights if self.weights is not None else np.ones_like(score)
        pos = (label > 0).astype(np.float64)
        order = np.argsort(-score, kind="stable")
        s, p, ww = score[order], pos[order], w[order]
        wpos = ww * p
        wneg = ww * (1.0 - p)
        # tie groups share credit: accum += neg_before * pos_in + 0.5*neg_in*pos_in
        boundaries = np.nonzero(np.diff(s))[0] + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(s)]])
        cpos = np.concatenate([[0.0], np.cumsum(wpos)])
        cneg = np.concatenate([[0.0], np.cumsum(wneg)])
        pos_in = cpos[ends] - cpos[starts]
        neg_in = cneg[ends] - cneg[starts]
        neg_before = cneg[starts]
        accum = (neg_before * pos_in + 0.5 * neg_in * pos_in).sum()
        total_pos = wpos.sum()
        total_neg = wneg.sum()
        if total_pos <= 0 or total_neg <= 0:
            return [1.0]
        # reference accumulates "correctly ordered" mass from the top; the
        # closed form equals 1 - wrong/total
        return [float(1.0 - accum / (total_pos * total_neg))]


class _MulticlassMetric(Metric):
    """multiclass_metric.hpp: the (num_class, num_data) score converted
    row by row through the objective."""

    def __init__(self, config: Config):
        self.num_class = int(config.num_class)

    def loss_on_point(self, label, probs):
        raise NotImplementedError

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(
            self.num_class, self.num_data).T
        if objective is not None:
            probs = np.asarray(objective.convert_output(score))
        else:
            probs = score
        loss = self.loss_on_point(self.label.astype(np.int32), probs)
        if self.weights is not None:
            loss = loss * self.weights
        return [float(loss.sum() / self.sum_weights)]


class MultiSoftmaxLoglossMetric(_MulticlassMetric):
    name = "multi_logloss"

    def loss_on_point(self, label, probs):
        p = probs[np.arange(len(label)), label]
        return -np.log(np.maximum(p, kEpsilon))


class MultiErrorMetric(_MulticlassMetric):
    name = "multi_error"

    def loss_on_point(self, label, probs):
        return (np.argmax(probs, axis=1) != label).astype(np.float64)


class NDCGMetric(Metric):
    """rank_metric.hpp + dcg_calculator.cpp; a query without a positive
    label counts as NDCG 1."""
    name = "ndcg"
    factor_to_bigger_better = 1.0

    def __init__(self, config: Config):
        self.eval_at = list(config.ndcg_eval_at or [1, 2, 3, 4, 5])
        self.label_gain = np.asarray(config.label_gain
                                     or default_label_gain())

    def init(self, metadata: Metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("For NDCG metric (metric=ndcg), there should be query "
                      "information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.query_weights = metadata.query_weights
        nq = len(self.qb) - 1
        self.sum_query_weights = (
            float(nq) if self.query_weights is None
            else float(np.asarray(self.query_weights).sum()))
        self.inv_max_dcgs = np.zeros((nq, len(self.eval_at)))
        for q in range(nq):
            lab = self.label[self.qb[q]:self.qb[q + 1]]
            for j, k in enumerate(self.eval_at):
                m = _max_dcg_at_k(k, lab, self.label_gain)
                self.inv_max_dcgs[q, j] = 1.0 / m if m > 0.0 else -1.0

    def get_names(self) -> List[str]:
        return ["ndcg@%d" % k for k in self.eval_at]

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        nq = len(self.qb) - 1
        result = np.zeros(len(self.eval_at))
        for q in range(nq):
            s, e = self.qb[q], self.qb[q + 1]
            qw = (1.0 if self.query_weights is None
                  else float(self.query_weights[q]))
            if self.inv_max_dcgs[q, 0] <= 0.0:
                result += qw
                continue
            lab = self.label[s:e].astype(np.int32)
            order = np.argsort(-score[s:e], kind="stable")
            dcg_all = self.label_gain[lab[order]] * get_discounts(len(lab))
            for j, k in enumerate(self.eval_at):
                kk = min(k, len(lab))
                result[j] += dcg_all[:kk].sum() * self.inv_max_dcgs[q, j] * qw
        return [float(r / self.sum_query_weights) for r in result]


class MapMetric(Metric):
    """map_metric.hpp:16-140.  The precision denominator is the eval_at
    slot's index (i + 1), as the reference's (map_metric.hpp:88-90) and
    the JAX package's are, not the textbook position."""
    name = "map"
    factor_to_bigger_better = 1.0

    def __init__(self, config: Config):
        self.eval_at = list(config.ndcg_eval_at or [1, 2, 3, 4, 5])

    def init(self, metadata: Metadata, num_data: int) -> None:
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("For MAP metric (metric=map), there should be query "
                      "information")
        self.qb = np.asarray(metadata.query_boundaries)
        self.query_weights = metadata.query_weights
        nq = len(self.qb) - 1
        self.sum_query_weights = (
            float(nq) if self.query_weights is None
            else float(np.asarray(self.query_weights).sum()))

    def get_names(self) -> List[str]:
        return ["map@%d" % k for k in self.eval_at]

    def eval(self, score, objective) -> List[float]:
        score = np.asarray(score, dtype=np.float64).reshape(-1)
        nq = len(self.qb) - 1
        result = np.zeros(len(self.eval_at))
        for q in range(nq):
            s, e = self.qb[q], self.qb[q + 1]
            qw = (1.0 if self.query_weights is None
                  else float(self.query_weights[q]))
            lab = self.label[s:e]
            hits = lab[np.argsort(-score[s:e], kind="stable")] > 0.5
            num_hit = 0
            sum_ap = 0.0
            cur_left = 0
            for i, k in enumerate(self.eval_at):
                cur_k = min(k, len(lab))
                for j in range(cur_left, cur_k):
                    if hits[j]:
                        num_hit += 1
                        sum_ap += num_hit / (i + 1.0)
                result[i] += (sum_ap / cur_k) * qw if cur_k > 0 else 0.0
                cur_left = cur_k
        return [float(r / self.sum_query_weights) for r in result]


_METRIC_FACTORY = {
    "l2": L2Metric, "mean_squared_error": L2Metric, "mse": L2Metric,
    "l2_root": RMSEMetric, "root_mean_squared_error": RMSEMetric,
    "rmse": RMSEMetric,
    "l1": L1Metric, "mean_absolute_error": L1Metric, "mae": L1Metric,
    "huber": HuberLossMetric,
    "fair": FairLossMetric,
    "poisson": PoissonMetric,
    "binary_logloss": BinaryLoglossMetric,
    "binary_error": BinaryErrorMetric,
    "auc": AUCMetric,
    "ndcg": NDCGMetric,
    "map": MapMetric, "mean_average_precision": MapMetric,
    "multi_logloss": MultiSoftmaxLoglossMetric,
    "multi_error": MultiErrorMetric,
}
# the metrics that take the config
_CONFIGURED = (HuberLossMetric, FairLossMetric, _MulticlassMetric,
               NDCGMetric, MapMetric)


def create_metric(name: str, config: Config) -> Optional[Metric]:
    """Metric::CreateMetric (metric.cpp:10-40); None for names neither
    package knows (the reference ignores them too)."""
    cls = _METRIC_FACTORY.get(name)
    if cls is None:
        return None
    return cls(config) if issubclass(cls, _CONFIGURED) else cls()
