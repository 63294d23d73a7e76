"""InfiniteBoost booster (src/boosting/infiniteboost.hpp,
arXiv:1706.01109), as the JAX package's ``models/infiniteboost.py``.

Trees are grown with shrinkage 1, then each new tree is re-weighted so
the ensemble converges to a capacity-bounded F: with eta = 2/(m+1),
F -> (1 - eta) F + min(eta * capacity, 0.2) * tree, and the tree's final
weight is min(capacity * m / (n(n+1)/2), 0.2 * sum(1..m) / (n(n+1)/2))
(infiniteboost.hpp:70-113).  The (1 - eta) multiply of the train and
valid scores is in place on the device (ScoreUpdater::MultiplyScore).

n is ``config.num_iterations``, read when the booster is built.
``train`` takes the count of rounds out of the params before it builds
the booster, as the JAX package's does, so under ``train`` n is the
default 100 whatever the count of rounds.

As in the JAX package, tree indices count past the boost_from_average
stub tree.
"""
from __future__ import annotations

import numpy as np

from .gbdt import GBDT

MAXIMAL_CONTRIBUTION = 0.2


class InfiniteBoost(GBDT):
    def __init__(self, config, device, train_data=None, objective=None,
                 training_metrics=()):
        super().__init__(config, device, train_data, objective,
                         training_metrics)
        self.capacity = float(config.capacity)
        # the ensemble is built with unit shrinkage (infiniteboost.hpp:41)
        self.shrinkage_rate = 1.0
        n = config.num_iterations
        self.normalization = n * (n + 1) / 2.0
        self.current_normalization = 0.0

    def train_one_iter(self, gradients=None, hessians=None,
                       is_eval: bool = True) -> bool:
        stop = super().train_one_iter(gradients, hessians, False)
        if stop:
            return stop
        self._update_tree_weight()
        if is_eval:
            self.output_metric(self.iter)
        return False

    def _multiply(self, row, factor: float) -> None:
        """row *= factor in f32, in place."""
        row.mul_(float(np.float32(factor)))

    def _update_tree_weight(self) -> None:
        """infiniteboost.hpp:70-113."""
        m = self.iter
        eta = 2.0 / (m + 1)
        tree_contribution = min(eta * self.capacity, MAXIMAL_CONTRIBUTION)
        self.current_normalization += m
        k = self.num_tree_per_iteration
        self._materialize()
        trees = [self.models[self._stub_offset() + (m - 1) * k + tid]
                 for tid in range(k)]
        for tid, tree in enumerate(trees):
            # take GBDT's contribution out, scale F by (1 - eta), add the
            # tree back with the capped contribution
            tree.shrink(-1.0)
            for vi in range(len(self.valid_data)):
                self._apply_tree_to_valid(tree, vi, tid)
                self._multiply(self._valid_score_dev[vi][tid], 1.0 - eta)
            self._apply_tree_to_train(tree, tid)
            self._multiply(self._score_dev[tid], 1.0 - eta)
        for tid, tree in enumerate(trees):
            tree.shrink(-tree_contribution)
            for vi in range(len(self.valid_data)):
                self._apply_tree_to_valid(tree, vi, tid)
            self._apply_tree_to_train(tree, tid)
            tree.shrink(1.0 / tree_contribution * min(
                self.capacity * m / self.normalization,
                MAXIMAL_CONTRIBUTION * self.current_normalization
                / self.normalization))
        self._models_changed()
