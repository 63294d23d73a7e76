"""Row-wise predictor with prediction early stopping (host, f64), as the
JAX package's ``predictor.py``.

Parity targets: src/application/predictor.hpp:24-96 and
src/boosting/prediction_early_stop.cpp — margin-based stop callbacks
(binary: 2|margin|, multiclass: top1-top2 gap) checked every
``round_period`` trees.
"""
from __future__ import annotations

import time

from typing import Callable, Optional

import numpy as np

from .models.gbdt import GBDT
from .obs.metrics import observe_predict
from .utils.log import Log


class PredictionEarlyStopInstance:
    """(callback, round_period) pair (include/LightGBM/prediction_early_stop.h).

    ``batch_callback`` is the vectorized form — (rows, k) margins in,
    bool stop-mask out — used by the tree-major predict loop; a custom
    instance that only supplies the scalar ``callback`` still works
    (the loop falls back to row-by-row evaluation of just the active
    rows)."""

    def __init__(self, callback: Callable[[np.ndarray], bool],
                 round_period: int,
                 batch_callback: Optional[Callable[[np.ndarray],
                                                   np.ndarray]] = None):
        self.callback = callback
        self.round_period = round_period
        self.batch_callback = batch_callback


def create_prediction_early_stop_instance(type_: str, round_period: int,
                                          margin_threshold: float
                                          ) -> PredictionEarlyStopInstance:
    if type_ == "none":
        return PredictionEarlyStopInstance(
            lambda pred: False, 1 << 30,
            lambda preds: np.zeros(preds.shape[0], dtype=bool))
    if type_ == "multiclass":
        def cb_multi(pred):
            if len(pred) < 2:
                Log.fatal("Multiclass early stopping needs predictions to be "
                          "of length two or larger")
            top2 = np.partition(pred, -2)[-2:]
            return (top2[1] - top2[0]) > margin_threshold

        def cb_multi_batch(preds):
            if preds.shape[1] < 2:
                Log.fatal("Multiclass early stopping needs predictions to be "
                          "of length two or larger")
            top2 = np.partition(preds, -2, axis=1)[:, -2:]
            return (top2[:, 1] - top2[:, 0]) > margin_threshold
        return PredictionEarlyStopInstance(cb_multi, round_period,
                                           cb_multi_batch)
    if type_ == "binary":
        def cb_binary(pred):
            if len(pred) != 1:
                Log.fatal("Binary early stopping needs predictions to be of "
                          "length one")
            return 2.0 * abs(pred[0]) > margin_threshold

        def cb_binary_batch(preds):
            if preds.shape[1] != 1:
                Log.fatal("Binary early stopping needs predictions to be of "
                          "length one")
            return 2.0 * np.abs(preds[:, 0]) > margin_threshold
        return PredictionEarlyStopInstance(cb_binary, round_period,
                                           cb_binary_batch)
    Log.fatal("Unknown early stopping type: %s", type_)


class Predictor:
    """Per-row predictor (predictor.hpp) honoring pred_early_stop."""

    def __init__(self, gbdt: GBDT, num_iteration: int = -1,
                 raw_score: bool = False, predict_leaf_index: bool = False,
                 pred_contrib: bool = False,
                 early_stop: bool = False, early_stop_freq: int = 10,
                 early_stop_margin: float = 10.0):
        self.gbdt = gbdt
        self.num_iteration = num_iteration
        self.raw_score = raw_score
        self.predict_leaf_index = predict_leaf_index
        self.pred_contrib = pred_contrib
        k = gbdt.num_tree_per_iteration
        if early_stop and not predict_leaf_index:
            kind = "multiclass" if k > 1 else "binary"
            self.early_stop = create_prediction_early_stop_instance(
                kind, early_stop_freq, early_stop_margin)
        else:
            self.early_stop = create_prediction_early_stop_instance(
                "none", early_stop_freq, early_stop_margin)

    def predict(self, features: np.ndarray) -> np.ndarray:
        t0 = time.perf_counter()
        out = self._predict_impl(features)
        # row accounting from the INPUT (a 1-D request is one row):
        # converted k=1 outputs are 1-D and multiclass outputs are
        # (n, k) — both count n rows, never ndim quirks
        rows = 1 if np.ndim(features) <= 1 else np.shape(features)[0]
        observe_predict(rows, time.perf_counter() - t0)
        return out

    def _predict_impl(self, features: np.ndarray) -> np.ndarray:
        features = np.ascontiguousarray(np.asarray(features, dtype=np.float64))
        if features.ndim == 1:
            features = features.reshape(1, -1)
        if self.predict_leaf_index:
            return self.gbdt.predict_leaf_index(features, self.num_iteration)
        if self.pred_contrib:
            # attribution debug path (host, f64): gain-weighted per-feature
            # contributions; early stopping does not apply — the whole
            # point is seeing every tree's share
            return self.gbdt.pred_contrib(features, self.num_iteration)
        gbdt = self.gbdt
        gbdt._materialize()
        k = gbdt.num_tree_per_iteration
        num_used = gbdt._used_trees(self.num_iteration)
        n = features.shape[0]
        out = np.zeros((n, k), dtype=np.float64)
        period = self.early_stop.round_period
        if period >= num_used:
            out = gbdt.predict_raw(features, self.num_iteration)
        else:
            # early-stopped traversal, tree-major over the still-active
            # rows: each tree is ONE batched descent over the rows that
            # haven't hit their margin yet, and the stop check at every
            # period boundary is a vectorized margin test — same
            # per-row semantics as the reference's OMP row loop
            # (predictor.hpp:33-96) at batch throughput
            active = np.arange(n)
            fa = features       # re-gathered only when the set shrinks
            for t in range(num_used):
                out[active, t % k] += gbdt.models[t].predict(fa)
                if (t + 1) % (period * k) == 0:
                    margins = out[active]
                    if self.early_stop.batch_callback is not None:
                        stop = np.asarray(
                            self.early_stop.batch_callback(margins))
                    else:   # custom scalar-only instance
                        stop = np.fromiter(
                            (self.early_stop.callback(m) for m in margins),
                            dtype=bool, count=len(active))
                    if stop.any():
                        active = active[~stop]
                        if active.size == 0:
                            break
                        fa = features[active]
        if self.raw_score or gbdt.objective is None:
            return out[:, 0] if k == 1 else out
        conv = np.asarray(gbdt.objective.convert_output(
            out if k > 1 else out[:, 0]))
        return conv
