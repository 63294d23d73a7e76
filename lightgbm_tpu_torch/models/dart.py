"""DART booster (src/boosting/dart.hpp:50-186), as the JAX package's
``models/dart.py``.

Each iteration drops a random subset of the earlier trees (uniformly or
in proportion to their weights) from the training score before the
gradients are taken, trains the new tree on what is left, then
normalizes the dropped trees -- the ``k/(k+1)`` scheme or
``xgboost_dart_mode`` -- on the host Trees and applies the changes to the
train and valid scores by traversals of the bins.  The drops draw from
``utils/random.Random(drop_seed)``, the reference's sequence.

As in the JAX package (and unlike the reference), tree indices count past
the boost_from_average stub tree.
"""
from __future__ import annotations

from typing import List

from ..utils.random import Random
from .gbdt import GBDT


class DART(GBDT):
    def __init__(self, config, device, train_data=None, objective=None,
                 training_metrics=()):
        super().__init__(config, device, train_data, objective,
                         training_metrics)
        self.random_for_drop = Random(config.drop_seed)
        self.sum_weight = 0.0
        self.tree_weight: List[float] = []
        self.drop_index: List[int] = []
        self._score_dropped_this_iter = False

    def _tree_at(self, iteration: int, tid: int):
        return self.models[self._stub_offset()
                           + iteration * self.num_tree_per_iteration + tid]

    def train_one_iter(self, gradients=None, hessians=None,
                       is_eval: bool = True) -> bool:
        self._score_dropped_this_iter = False
        stop = super().train_one_iter(gradients, hessians, False)
        if stop:
            return stop
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        if is_eval:
            return self.eval_and_check_early_stopping()
        return False

    def _score_for_objective(self):
        # DroppingTrees runs once an iteration, when the scores are read
        # (DART::GetTrainingScore, dart.hpp:69-79)
        if not self._score_dropped_this_iter:
            self._dropping_trees()
            self._score_dropped_this_iter = True
        return super()._score_for_objective()

    def _dropping_trees(self) -> None:
        cfg = self.config
        self.drop_index = []
        is_skip = self.random_for_drop.next_float() < cfg.skip_drop
        if not is_skip and self.iter > 0:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                inv_avg = (len(self.tree_weight) / self.sum_weight
                           if self.sum_weight > 0 else 0.0)
                if cfg.max_drop > 0 and self.sum_weight > 0:
                    drop_rate = min(drop_rate,
                                    cfg.max_drop * inv_avg / self.sum_weight)
                for i in range(self.iter):
                    if (self.random_for_drop.next_float()
                            < drop_rate * self.tree_weight[i] * inv_avg):
                        self.drop_index.append(i)
            else:
                if cfg.max_drop > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / float(self.iter))
                for i in range(self.iter):
                    if self.random_for_drop.next_float() < drop_rate:
                        self.drop_index.append(i)
        if self.drop_index:
            self._materialize()
        # take the dropped trees out of the training score
        for i in self.drop_index:
            for tid in range(self.num_tree_per_iteration):
                tree = self._tree_at(i, tid)
                tree.shrink(-1.0)
                self._apply_tree_to_train(tree, tid)
        if self.drop_index:
            self._models_changed()
        k = float(len(self.drop_index))
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        elif not self.drop_index:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (cfg.learning_rate + k)

    def _normalize(self) -> None:
        """dart.hpp:139-176: each dropped tree scaled to its new weight in
        the valid scores and back into the train score, in three
        shrinks."""
        cfg = self.config
        k = float(len(self.drop_index))
        for i in self.drop_index:
            for tid in range(self.num_tree_per_iteration):
                tree = self._tree_at(i, tid)
                if not cfg.xgboost_dart_mode:
                    tree.shrink(1.0 / (k + 1.0))
                    for vi in range(len(self.valid_data)):
                        self._apply_tree_to_valid(tree, vi, tid)
                    tree.shrink(-k)
                else:
                    tree.shrink(self.shrinkage_rate)
                    for vi in range(len(self.valid_data)):
                        self._apply_tree_to_valid(tree, vi, tid)
                    tree.shrink(-k / cfg.learning_rate)
                self._apply_tree_to_train(tree, tid)
            if not cfg.uniform_drop:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * (
                        1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)
        if self.drop_index:
            self._models_changed()
