"""GBDT booster: the staged training loop, scores, eval, model I/O.

Ported from the JAX package's ``models/gbdt.py`` (parity target
src/boosting/gbdt.cpp).  Mirrored behaviors: the boost_from_average stub
tree on the first iteration (gbdt.cpp:339-362), the degenerate-class skip
(gbdt.cpp:166-205), bagging as a per-row 0/1 multiplier (gbdt.cpp:242-324),
the stop on a tree without splits (gbdt.cpp:440-448) and the model text
format (gbdt.cpp:817-971).

One iteration is staged -- gradients, then tree growth (ops/wave.py or
ops/grow.py), then the partition-side score update (kernel B2), each its
own step on the device -- or fused (``tpu_fused_iter``,
ops/fused_iter.py): the three as a few CUDA graph replays with a few
host reads a tree.  Both train
the same model text to the byte.  The validation-set traversal follows
either, as in the JAX package.  Scores are (1, N) f32 device tensors,
updated in place (the fused iteration's graphs hold their address);
trees stay on the device until a host view is needed.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..io.dataset import TrainingData
from ..metrics import Metric
from ..objectives import ObjectiveFunction, load_objective_from_string
from ..ops import predict as dev_predict
from ..ops.learner import SerialTreeLearner, materialize_tree
from ..utils.common import parse_kv_lines
from ..utils.config import Config
from ..utils.log import Log
from .tree import Tree

kEpsilon = 1e-15


class GBDT:
    """Gradient Boosting Decision Tree (boosting.h:21-261 interface)."""

    def __init__(self, config: Config, device,
                 train_data: Optional[TrainingData] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 training_metrics: Sequence[Metric] = ()):
        self.config = config
        self.device = device
        # host Trees; None entries wait for materialization from the
        # aligned _models_dev / _models_shrink slots
        self.models: List[Optional[Tree]] = []
        self._models_dev: List[Optional[object]] = []
        self._models_shrink: List[float] = []
        self.iter = 0
        self.num_init_iteration = 0
        self.boost_from_average_used = False
        self.num_class = config.num_class
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.objective = objective
        self.shrinkage_rate = config.learning_rate
        self.train_data: Optional[TrainingData] = None
        self.learner: Optional[SerialTreeLearner] = None
        self.training_metrics: List[Metric] = list(training_metrics)
        self.valid_data: List[TrainingData] = []
        self.valid_metrics: List[List[Metric]] = []
        self._valid_X_dev: List[torch.Tensor] = []
        self._valid_score_dev: List[torch.Tensor] = []
        self._score_dev: Optional[torch.Tensor] = None
        self.num_tree_per_iteration = 1
        # per-tree growth facts of the latest iterations (waves, host
        # reads, depth) — what chip runs report
        self.grow_stats: list = []
        # (FusedIteration or None,) once resolved for the learner and
        # objective (_resolve_fused_iter); None until then
        self._fused_state = None
        if train_data is not None:
            self.reset_training_data(config, train_data, objective,
                                     training_metrics)

    # ----------------------------------------------------------------- setup
    def reset_training_data(self, config: Config, train_data: TrainingData,
                            objective: Optional[ObjectiveFunction],
                            training_metrics: Sequence[Metric]) -> None:
        """GBDT::ResetTrainingData (gbdt.cpp:76-208) for a fresh booster."""
        if config.num_class != 1:
            Log.fatal("lightgbm_tpu_torch trains one tree per iteration "
                      "(num_class=1)")
        if config.early_stopping_round > 0:
            Log.fatal("early_stopping_round is not in lightgbm_tpu_torch "
                      "yet")
        self.config = config
        self.objective = objective
        self.shrinkage_rate = config.learning_rate
        self.train_data = train_data
        self.num_data = train_data.num_data
        self.learner = SerialTreeLearner(config, train_data, self.device)
        self._fused_state = None
        self.training_metrics = list(training_metrics)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        init = train_data.metadata.init_score
        self.has_init_score = init is not None
        score0 = np.zeros((1, self.num_data), dtype=np.float32)
        if self.has_init_score:
            if len(init) != self.num_data:
                Log.fatal("number of class for initial score error")
            score0[0] = np.asarray(init, dtype=np.float64)
        self._score_dev = torch.as_tensor(score0, device=self.device)
        # degenerate class handling (gbdt.cpp:166-205)
        self.class_need_train = True
        self.class_default_output = 0.0
        if objective is not None and objective.skip_empty_class():
            cnt_pos = int((np.asarray(train_data.metadata.label) > 0).sum())
            if cnt_pos == 0:
                self.class_need_train = False
                self.class_default_output = -np.log(1.0 / kEpsilon - 1.0)
            elif cnt_pos == self.num_data:
                self.class_need_train = False
                self.class_default_output = -np.log(kEpsilon)
        # bagging state (gbdt.cpp ResetBaggingConfig, :134-160)
        self.bag_data_cnt = self.num_data
        self.row_mult: Optional[torch.Tensor] = None
        if config.bagging_fraction < 1.0 and config.bagging_freq > 0:
            self.bag_data_cnt = int(config.bagging_fraction * self.num_data)

    def add_valid_dataset(self, valid_data: TrainingData,
                          valid_metrics: Sequence[Metric]) -> None:
        """GBDT::AddValidDataset (gbdt.cpp:210-240) before training."""
        if self.models:
            Log.fatal("add validation data before the first iteration")
        score = np.zeros((1, valid_data.num_data), dtype=np.float32)
        init = valid_data.metadata.init_score
        if init is not None:
            score[0] = np.asarray(init, dtype=np.float64)
        self.valid_data.append(valid_data)
        self._valid_X_dev.append(torch.as_tensor(valid_data.binned,
                                                 device=self.device))
        self._valid_score_dev.append(torch.as_tensor(score,
                                                     device=self.device))
        self.valid_metrics.append(list(valid_metrics))

    # ------------------------------------------------------ score management
    @property
    def train_score(self) -> np.ndarray:
        """Host copy of the training scores, (1, N) float64."""
        return self._score_dev.cpu().numpy().astype(np.float64)

    def valid_score_host(self, i: int) -> np.ndarray:
        return self._valid_score_dev[i].cpu().numpy().astype(np.float64)

    # ---------------------------------------------------- model realization
    def _materialize(self) -> None:
        """Host Trees for every pending device tree (one transfer each)."""
        for i, m in enumerate(self.models):
            if m is not None:
                continue
            tree = materialize_tree(self._models_dev[i].to_numpy(),
                                    self.train_data, self.config.num_leaves)
            tree.shrink(self._models_shrink[i])
            self.models[i] = tree
            self._models_dev[i] = None

    def _append_host_tree(self, tree: Tree) -> None:
        self.models.append(tree)
        self._models_dev.append(None)
        self._models_shrink.append(1.0)

    def _add_constant(self, value: float) -> None:
        """Add value to every score, in place."""
        c = torch.tensor(value, dtype=torch.float32, device=self.device)
        self._score_dev.add_(c)
        for vi in range(len(self.valid_data)):
            self._valid_score_dev[vi].add_(c)

    # --------------------------------------------------------------- bagging
    def _bagging(self, it: int) -> None:
        """Re-draw the bag on schedule (gbdt.cpp:265-324): an exact-count
        sample by ranking per-row random keys, deterministic per
        seed+iteration."""
        cfg = self.config
        if self.bag_data_cnt < self.num_data and it % cfg.bagging_freq == 0:
            rng = np.random.default_rng(cfg.bagging_seed + it)
            keys = rng.random(self.num_data)
            idx = np.argpartition(keys, self.bag_data_cnt)[:self.bag_data_cnt]
            mult = np.zeros(self.num_data, dtype=np.float32)
            mult[idx] = 1.0
            self.row_mult = torch.as_tensor(mult, device=self.device)

    # ------------------------------------------------------------- iteration
    def _resolve_fused_iter(self):
        """``tpu_fused_iter`` (auto/on/off) resolved to a FusedIteration,
        or None for the staged chain; resolved once for the learner and
        objective, which reset_training_data rebuilds.

        auto fuses when eligible and the learner runs on CUDA (the
        hand-written kernels are live under wave and exact growth alike,
        and the host's launches are what the graphs remove); on the CPU
        it stays staged.  on fuses
        wherever eligible; an explicit request is never dropped
        silently, so ineligibility warns.  off never fuses.  (The learner
        refuses any other value when it is built.)"""
        if self._fused_state is not None:
            return self._fused_state[0]
        mode = str(self.config.tpu_fused_iter).strip().lower()
        fused = None
        if mode != "off":
            from ..ops import fused_iter
            ok, why = fused_iter.fused_supported(self)
            if not ok and mode == "on":
                Log.warning("tpu_fused_iter=on but the fused iteration is "
                            "unavailable (%s); using the staged chain", why)
            if ok and (mode == "on" or self.device.type == "cuda"):
                fused = fused_iter.FusedIteration(
                    self.learner, self.objective.get_gradients,
                    self.num_data)
        self._fused_state = (fused,)
        return fused

    def train_one_iter(self, is_eval: bool = True) -> bool:
        """GBDT::TrainOneIter (gbdt.cpp:339-458), staged; True = stop."""
        cfg = self.config
        if (not self.models and cfg.boost_from_average
                and not self.has_init_score
                and self.objective is not None
                and self.objective.boost_from_average()):
            label = np.asarray(self.train_data.metadata.label,
                               dtype=np.float64)
            init_score = float(label.sum() / self.num_data)
            stub = Tree(2)
            stub.split(0, 0, False, 0, 0, 0.0, init_score, init_score,
                       0, self.num_data, -1.0, 0, 0, 0.0)
            self._add_constant(init_score)
            self._append_host_tree(stub)
            self.boost_from_average_used = True

        if not self.class_need_train:
            if not self.models:
                out = self.class_default_output
                tree = Tree(2)
                tree.split(0, 0, False, 0, 0, 0.0, out, out,
                           0, self.num_data, -1.0, 0, 0, 0.0)
                self._add_constant(out)
                self._append_host_tree(tree)
            else:
                self._append_host_tree(Tree(2))
            self.iter += 1
            return False

        if self.objective is None:
            Log.fatal("No object function provided")
        # the shrinkage travels as a host float (rounded to f32 by both
        # updates), never as a device tensor copied over each iteration;
        # the train score is updated in place
        scale = self.shrinkage_rate
        fused = self._resolve_fused_iter()
        if fused is not None:
            # gradients, growth and the score update in one schedule; the
            # tree is the fused iteration's buffer, so the model keeps a
            # copy
            self._bagging(self.iter)
            dev_tree, leaf_id, stats = fused.run(
                self._score_dev[0], self.row_mult,
                self.learner.sample_feature_mask(), scale)
            self.learner.last_stats = stats
            stored = dev_tree.clone()
        else:
            grad, hess = self.objective.get_gradients(self._score_dev[0])
            self._bagging(self.iter)
            dev_tree, leaf_id, stats = self.learner.train_device(
                grad, hess, self.row_mult)
            dev_predict.update_score_from_partition(
                self._score_dev[0], leaf_id, dev_tree.leaf_value, scale,
                out=self._score_dev[0])
            stored = dev_tree
        self.grow_stats.append(stats)
        ta = dev_predict.traversal_from_grow(dev_tree, stats.num_leaves,
                                             stats.depth)
        for vi in range(len(self.valid_data)):
            self._valid_score_dev[vi] = dev_predict.add_tree_to_score(
                self._valid_score_dev[vi][0], self._valid_X_dev[vi], ta,
                scale, self.learner.bundle_arrays)[None, :]
        self.models.append(None)
        self._models_dev.append(stored)
        self._models_shrink.append(self.shrinkage_rate)
        if stats.num_leaves <= 1:
            # no leaf met the split requirements (gbdt.cpp:440-448)
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements.")
            self.models.pop()
            self._models_dev.pop()
            self._models_shrink.pop()
            return True
        self.iter += 1
        return False

    # ------------------------------------------------------------------ eval
    def get_eval_at(self, data_idx: int) -> List[float]:
        """GBDT::GetEvalAt (gbdt.cpp:588-609)."""
        out: List[float] = []
        if data_idx == 0:
            for m in self.training_metrics:
                out.extend(m.eval(self.train_score, self.objective))
        else:
            i = data_idx - 1
            for m in self.valid_metrics[i]:
                out.extend(m.eval(self.valid_score_host(i), self.objective))
        return out

    def eval_names(self, data_idx: int) -> List[str]:
        ms = (self.training_metrics if data_idx == 0
              else self.valid_metrics[data_idx - 1])
        return [n for m in ms for n in m.get_names()]

    # --------------------------------------------------------------- predict
    def total_iterations(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def _used_trees(self, num_iteration: int) -> int:
        num_used = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_used else 0)
            num_used = min(ni * self.num_tree_per_iteration, len(self.models))
        return num_used

    def predict_raw(self, features: np.ndarray,
                    num_iteration: int = -1) -> np.ndarray:
        """Raw scores (N,) on real-valued features, summed over trees in
        float64 on the host (gbdt_prediction.cpp PredictRaw)."""
        self._materialize()
        features = np.ascontiguousarray(np.asarray(features,
                                                   dtype=np.float64))
        out = np.zeros(features.shape[0], dtype=np.float64)
        for t in range(self._used_trees(num_iteration)):
            out += self.models[t].predict(features)
        return out

    def predict(self, features: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False) -> np.ndarray:
        raw = self.predict_raw(features, num_iteration)
        if raw_score or self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw))

    # ------------------------------------------------------------- model I/O
    def save_model_to_string(self, num_iteration: int = -1) -> str:
        """GBDT::SaveModelToString (gbdt.cpp:817-861)."""
        self._materialize()
        lines = ["tree"]
        lines.append("num_class=%d" % self.num_class)
        lines.append("num_tree_per_iteration=%d"
                     % self.num_tree_per_iteration)
        lines.append("label_index=%d" % self.label_idx)
        lines.append("max_feature_idx=%d" % self.max_feature_idx)
        if self.objective is not None:
            lines.append("objective=%s" % self.objective.to_string())
        if self.boost_from_average_used:
            lines.append("boost_from_average")
        lines.append("feature_names=" + " ".join(self.feature_names))
        lines.append("feature_infos=" + " ".join(self.feature_infos))
        lines.append("")
        for i in range(self._used_trees(num_iteration)):
            lines.append("Tree=%d" % i)
            lines.append(self.models[i].to_string())
        lines.append("")
        lines.append("feature importances:")
        for cnt, name in self.feature_importance_pairs():
            lines.append("%s=%d" % (name, cnt))
        return "\n".join(lines) + "\n"

    def load_model_from_string(self, model_str: str) -> bool:
        """GBDT::LoadModelFromString (gbdt.cpp:875-971).  Header keys this
        port does not use (e.g. a drift fingerprint) are ignored."""
        self.models, self._models_dev, self._models_shrink = [], [], []
        lines = model_str.splitlines()
        header_lines = []
        for line in lines:
            if line.startswith("Tree="):
                break
            header_lines.append(line)
        kv = parse_kv_lines(header_lines)
        for key in ("num_class", "label_index", "max_feature_idx"):
            if key not in kv:
                Log.fatal("Model file doesn't specify %s", key)
        self.num_class = int(kv["num_class"])
        self.num_tree_per_iteration = int(kv.get("num_tree_per_iteration",
                                                 self.num_class))
        if self.num_tree_per_iteration != 1:
            Log.fatal("lightgbm_tpu_torch loads single-output models only")
        self.label_idx = int(kv["label_index"])
        self.max_feature_idx = int(kv["max_feature_idx"])
        self.boost_from_average_used = any(
            ln.strip() == "boost_from_average" for ln in header_lines)
        if "feature_names" in kv:
            self.feature_names = kv["feature_names"].split(" ")
            if len(self.feature_names) != self.max_feature_idx + 1:
                Log.fatal("Wrong size of feature_names")
        if "feature_infos" in kv:
            self.feature_infos = kv["feature_infos"].split(" ")
        if "objective" in kv:
            self.objective = load_objective_from_string(kv["objective"])
        for part in "\n".join(lines).split("Tree=")[1:]:
            body = []
            for bl in part.splitlines()[1:]:
                if bl.startswith("feature importances"):
                    break
                body.append(bl)
            block = "\n".join(body).strip()
            if block:
                self._append_host_tree(Tree.from_string(block))
        self.num_init_iteration = len(self.models)
        self.iter = 0
        return True

    # ------------------------------------------------------------ importance
    def feature_importance_pairs(self) -> List[Tuple[int, str]]:
        """Split-count importance, descending, stable (gbdt.cpp:973-997)."""
        counts = self.feature_importance()
        pairs = [(int(counts[i]), self.feature_names[i]
                  if i < len(self.feature_names) else "Column_%d" % i)
                 for i in range(len(counts)) if counts[i] > 0]
        pairs.sort(key=lambda p: -p[0])
        return pairs

    def feature_importance(self, importance_type: str = "split"):
        """'split' = times a feature is used; 'gain' = total gain of the
        splits using it."""
        if importance_type not in ("split", "gain"):
            raise KeyError("importance_type must be split or gain")
        self._materialize()
        gain = importance_type == "gain"
        out = np.zeros(self.max_feature_idx + 1,
                       dtype=np.float64 if gain else np.int64)
        for tree in self.models:
            for i in range(tree.num_leaves - 1):
                if tree.split_gain[i] > 0:
                    out[tree.split_feature[i]] += (tree.split_gain[i]
                                                   if gain else 1)
        return out
