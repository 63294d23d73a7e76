"""GBDT booster: the staged training loop, scores, eval, early stopping,
rollback, model I/O.

Ported from the JAX package's ``models/gbdt.py`` (parity target
src/boosting/gbdt.cpp).  Mirrored behaviors: the boost_from_average stub
tree on the first iteration (gbdt.cpp:339-362), K = num_tree_per_iteration
trees an iteration (multiclass), the degenerate-class skip with its
constant stub (gbdt.cpp:166-205), bagging as a per-row 0/1 multiplier
(gbdt.cpp:242-324), the stop on an iteration without splits
(gbdt.cpp:440-448), early stopping on the valid metrics with the pop of
the trees past the best iteration (gbdt.cpp:479-585), rollback
(gbdt.cpp:460-477), the model text format (gbdt.cpp:817-971) and its JSON
dump (gbdt.cpp:665-699), and custom gradients (a Python ``fobj``), which
always take the staged chain.

One tree is staged -- gradients, then tree growth (ops/wave.py or
ops/grow.py), then the partition-side score update (kernel B2), each its
own step on the device -- or fused (``tpu_fused_iter``,
ops/fused_iter.py): the three as a few CUDA graph replays with a few
host reads a tree.  Both train the same model text to the byte.  Only
GBDT's own one-tree iteration fuses, as in the JAX package: multiclass
and the boosting modes (models/dart.py, goss.py, infiniteboost.py) stay
staged.  The validation-set traversal follows either.  Scores are
(K, N) f32 device tensors, updated in place, a row a class (the fused
iteration's graphs hold the address of row 0); trees stay on the device
until a host view is needed.
"""
from __future__ import annotations

import json
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..io.dataset import TrainingData
from ..metrics import Metric
from ..objectives import ObjectiveFunction, load_objective_from_string
from ..obs import NULL_OBSERVER, observer_from_config
from ..obs.timers import NULL_ORCH, OrchestrationClock
from ..ops import predict as dev_predict
from ..ops.learner import SerialTreeLearner, materialize_tree
from ..parallel.comm import reduce_metrics, sum_across_ranks, vote_stop
from ..parallel.mesh import create_tree_learner
from ..utils.common import parse_kv_lines
from ..utils.config import Config
from ..utils.log import Log
from .tree import Tree

kEpsilon = 1e-15


def _stub_tree(value: float, num_data: int) -> Tree:
    """A two-leaf tree whose leaves both output value: the
    boost_from_average and empty-class stubs."""
    tree = Tree(2)
    tree.split(0, 0, False, 0, 0, 0.0, value, value, 0, num_data, -1.0, 0,
               0, 0.0)
    return tree


def _device_rows(device) -> list:
    """The run header's devices: the training device's identity, and on
    a card its name, memory and SM count."""
    if device.type != "cuda":
        return [{"id": 0, "platform": "cpu", "kind": "cpu"}]
    props = torch.cuda.get_device_properties(device)
    return [{"id": int(device.index or 0), "platform": "gpu",
             "kind": str(props.name), "memory_bytes": int(props.total_memory),
             "sm_count": int(props.multi_processor_count)}]


class GBDT:
    """Gradient Boosting Decision Tree (boosting.h:21-261 interface)."""

    def __init__(self, config: Config, device,
                 train_data: Optional[TrainingData] = None,
                 objective: Optional[ObjectiveFunction] = None,
                 training_metrics: Sequence[Metric] = ()):
        self.config = config
        self.device = device
        # the devices bulk prediction shards its rows over (None: the
        # booster's own; Booster.set_predict_devices)
        self.predict_devices = None
        # host Trees; None entries wait for materialization from the
        # aligned _models_dev / _models_shrink slots
        self.models: List[Optional[Tree]] = []
        self._models_dev: List[Optional[object]] = []
        self._models_shrink: List[float] = []
        # bumped by every change to the trees (append, pop, load, merge,
        # in-place reweighting): the device predictor's cache key
        self.model_generation = 0
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
        self.early_stopping_round = config.early_stopping_round
        self.train_data: Optional[TrainingData] = None
        self.learner: Optional[SerialTreeLearner] = None
        self.training_metrics: List[Metric] = list(training_metrics)
        self.valid_data: List[TrainingData] = []
        self.valid_metrics: List[List[Metric]] = []
        self._valid_X_dev: List[torch.Tensor] = []
        self._valid_score_dev: List[torch.Tensor] = []
        # early stopping bookkeeping a (valid set, metric)
        self.best_score: List[List[float]] = []
        self.best_iter: List[List[int]] = []
        self.best_msg: List[List[str]] = []
        self._score_dev: Optional[torch.Tensor] = None
        self.num_tree_per_iteration = (
            objective.num_tree_per_iteration() if objective is not None
            else max(1, self.num_class))
        # per-tree growth facts of the latest iterations (waves, host
        # reads, depth) — what chip runs report
        self.grow_stats: list = []
        # (FusedIteration or None,) once resolved for the learner and
        # objective (_resolve_fused_iter); None until then
        self._fused_state = None
        # the run observer (obs/): NULL until reset_training_data builds
        # one from the obs_* params
        self._obs = NULL_OBSERVER
        self._metrics = None
        # the serving-time drift reference (obs/drift.py): completed
        # lazily from the dataset's fingerprint, or read from model text
        self._drift_fingerprint: Optional[dict] = None
        # the last eval pass's values, the fingerprint's eval snapshot
        self._last_eval_results: List[dict] = []
        if train_data is not None:
            self.reset_training_data(config, train_data, objective,
                                     training_metrics)

    # ----------------------------------------------------------------- setup
    def reset_training_data(self, config: Config, train_data: TrainingData,
                            objective: Optional[ObjectiveFunction],
                            training_metrics: Sequence[Metric]) -> None:
        """GBDT::ResetTrainingData (gbdt.cpp:76-208) for a fresh booster."""
        self.config = config
        self.objective = objective
        self.early_stopping_round = config.early_stopping_round
        self.shrinkage_rate = config.learning_rate
        if objective is not None:
            self.num_tree_per_iteration = objective.num_tree_per_iteration()
        self.train_data = train_data
        self.num_data = train_data.num_data
        self.learner = create_tree_learner(config, train_data, self.device)
        self._resolve_score_engine(config)
        self._reset_observer(config)
        self._fused_state = None
        self.training_metrics = list(training_metrics)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = train_data.feature_infos()
        k = self.num_tree_per_iteration
        init = train_data.metadata.init_score
        self.has_init_score = init is not None
        score0 = np.zeros((k, self.num_data), dtype=np.float64)
        if self.has_init_score:
            if (len(init) % self.num_data != 0
                    or len(init) // self.num_data != k):
                Log.fatal("number of class for initial score error")
            score0[:] = np.asarray(init, dtype=np.float64).reshape(
                k, self.num_data)
        # continued training (a loaded model, then new training data):
        # the trees' f64 host sums on the raw rows join the init score,
        # rounded to the scores' dtype once (f32, or float64 under
        # tpu_use_dp)
        score0 += self._existing_raw_scores(train_data, "training")
        self._score_dev = torch.as_tensor(score0.astype(self._score_np),
                                          device=self.device)
        # degenerate class handling (gbdt.cpp:166-205)
        self.class_need_train = [True] * k
        self.class_default_output = [0.0] * k
        if objective is not None and objective.skip_empty_class():
            label = np.asarray(train_data.metadata.label)
            if k > 1:
                counts = [int((label.astype(np.int32) == i).sum())
                          for i in range(k)]
            else:
                counts = [int((label > 0).sum())]
            for i, cnt in enumerate(counts):
                if cnt == self.num_data:
                    self.class_need_train[i] = False
                    self.class_default_output[i] = -np.log(kEpsilon)
                elif cnt == 0:
                    self.class_need_train[i] = False
                    self.class_default_output[i] = -np.log(
                        1.0 / kEpsilon - 1.0)
        # bagging state (gbdt.cpp ResetBaggingConfig, :134-160)
        self.bag_data_cnt = self.num_data
        self.row_mult: Optional[torch.Tensor] = None
        if config.bagging_fraction < 1.0 and config.bagging_freq > 0:
            self.bag_data_cnt = int(config.bagging_fraction * self.num_data)

    def _resolve_score_engine(self, config: Config) -> None:
        """The scores' dtype (the learner's: float64 under tpu_use_dp)
        and the train-side score update's engine, as the JAX package
        resolves them (its models/gbdt.py and ops/predict.py): auto and
        pallas take kernel B2, gather the gather; float64 scores take
        the gather, as there (B2 is f32-only).  The learner has already
        refused any other value."""
        self.score_dtype = self.learner.dtype
        self._score_np = (np.float64 if self.score_dtype == torch.float64
                          else np.float32)
        se = str(config.tpu_score_update).strip().lower()
        self._score_engine = ("gather" if se == "gather"
                              or self.score_dtype == torch.float64
                              else "pallas")

    def _reset_observer(self, config: Config) -> None:
        """Build the run observer (obs/) for this training dataset and
        emit the run header, the dataset's construction and quality
        profile, and the learner's queued autotune events.  All-default
        obs params keep the shared NULL observer: the hot path then pays
        one attribute load and an empty call a hook."""
        if self._obs.enabled:
            self._obs.close()
        self._obs = obs = observer_from_config(config,
                                               comm=self._dist_comm())
        self._metrics = None
        self._obs_split_audit = bool(config.obs_split_audit)
        self._obs_importance_every = int(config.obs_importance_every or 0)
        self._obs_importance_topk = int(config.obs_importance_topk or 20)
        if obs.enabled:
            obs.run_header(
                backend=self.device.type, devices=_device_rows(self.device),
                params={k: str(v) for k, v in config.raw.items()},
                context=dict(self.learner.obs_info(),
                             torch=torch.__version__,
                             cuda=str(torch.version.cuda or "")))
            # the continuous host sampling profiler (obs/prof.py,
            # obs_prof_hz) runs for the run; close() flushes its last
            # window
            obs.prof_arm()
            from ..obs import REGISTRY
            self._metrics = {"trees": REGISTRY.counter(
                "lgbm_trees_built_total",
                "trees grown on device by the training loop")}
            td = self.train_data
            if td.num_bin_arr is not None:
                REGISTRY.counter(
                    "lgbm_dataset_bins_built_total",
                    "feature-discretization bins constructed for training "
                    "datasets").inc(int(np.sum(td.num_bin_arr)))
            if td.construct_stats is not None:
                obs.event("dataset_construct", **td.construct_stats)
            if td.data_profile is not None and bool(config.obs_data_profile):
                # may raise under obs_health=fatal, before any iteration
                from ..obs import dataquality
                label = dataquality.label_profile(td.metadata.label)
                dataquality.emit_data_profile(
                    obs, td.data_profile, label,
                    dataquality.build_findings(td.data_profile, label,
                                               td.feature_names),
                    health_mode=str(config.obs_health or "off")
                    .strip().lower())
        self.learner.set_observer(obs)

    def reset_config(self, config: Config) -> None:
        """GBDT::ResetConfig (gbdt.cpp:64-74): new training parameters
        for the trees to come; the scores and the trees stay.  The learner
        is built anew (the dense bins uploaded again; a sparse store of
        the kind it runs is kept)."""
        self._materialize()
        self.config = config
        self.early_stopping_round = config.early_stopping_round
        self.shrinkage_rate = config.learning_rate
        old = self.learner
        # a sparse store is reused: train_data is unchanged, so the store
        # is too (JAX models/gbdt.py reset_config)
        self.learner = create_tree_learner(
            config, self.train_data, self.device,
            device_store=old.X if old is not None and old.sparse else None)
        self._resolve_score_engine(config)
        # the run's observer follows the rebuilt learner
        self.learner.set_observer(self._obs)
        self._fused_state = None
        self.bag_data_cnt = self.num_data
        self.row_mult = None
        if config.bagging_fraction < 1.0 and config.bagging_freq > 0:
            self.bag_data_cnt = int(config.bagging_fraction * self.num_data)

    def _existing_raw_scores(self, data: TrainingData,
                             what: str) -> np.ndarray:
        """(K, N) float64 raw scores of the trees the booster already
        holds (a loaded or merged model) on data's raw rows, through the
        f64 host path; zeros when it holds none."""
        k = self.num_tree_per_iteration
        if not self.models:
            return np.zeros((k, data.num_data), dtype=np.float64)
        if data.raw_data is None:
            Log.fatal("continued training needs the raw rows of the %s "
                      "data (keep_raw) to score the loaded trees", what)
        return self.predict_raw(data.raw_data, allow_device=False).T

    def add_valid_dataset(self, valid_data: TrainingData,
                          valid_metrics: Sequence[Metric]) -> None:
        """GBDT::AddValidDataset (gbdt.cpp:210-240): its (K, N) scores
        start at its init score plus, when the booster already holds
        trees (continued training), their f64 host sums on its raw
        rows."""
        if self.iter > 0:
            Log.fatal("add validation data before the first iteration")
        k = self.num_tree_per_iteration
        score = np.zeros((k, valid_data.num_data), dtype=np.float64)
        init = valid_data.metadata.init_score
        if init is not None:
            score[:] = np.asarray(init, dtype=np.float64).reshape(
                k, valid_data.num_data)
        score += self._existing_raw_scores(valid_data, "validation")
        score = score.astype(self._score_np)
        self.valid_data.append(valid_data)
        self._valid_X_dev.append(torch.as_tensor(valid_data.binned,
                                                 device=self.device))
        self._valid_score_dev.append(torch.as_tensor(score,
                                                     device=self.device))
        self.valid_metrics.append(list(valid_metrics))
        self.best_score.append([-np.inf] * len(valid_metrics))
        self.best_iter.append([0] * len(valid_metrics))
        self.best_msg.append([""] * len(valid_metrics))

    # ------------------------------------------------------ score management
    @property
    def train_score(self) -> np.ndarray:
        """Host copy of the training scores, (K, N) float64."""
        return self._score_dev.cpu().numpy().astype(np.float64)

    def valid_score_host(self, i: int) -> np.ndarray:
        return self._valid_score_dev[i].cpu().numpy().astype(np.float64)

    def _apply_tree_to_train(self, tree: Tree, tid: int) -> None:
        """Add a tree's output (its host leaf values) to row tid of the
        train score, in place (JAX models/gbdt.py _apply_tree_to_train):
        by a device traversal of the learner's bins when the tree has bin
        thresholds and the learner keeps a dense matrix; else (a sparse
        store, a tree loaded from text) by the f64 host traversal of the
        kept raw rows, added to the scores on the host and written back
        once.  Without either it raises, as the JAX package does."""
        if tree.num_leaves <= 1:
            return
        X, packed = self.learner.row_major_bins()
        if X is None or not getattr(tree, "has_bin_thresholds", True):
            raw = self.train_data.raw_data
            if raw is not None:
                row = self._score_dev[tid]
                s = row.cpu().numpy().astype(np.float64) + tree.predict(raw)
                row.copy_(torch.as_tensor(s.astype(self._score_np)))
                return
            if X is None:
                Log.fatal("tpu_sparse=true keeps no dense device matrix to "
                          "traverse; DART/rollback/continued training need "
                          "the raw data (keep_raw) under the sparse store")
            Log.fatal("Cannot apply a loaded model to binned-only data; "
                      "keep raw data when continuing training")
        row = self._score_dev[tid]
        # the training bins may be 4-bit packed; the valid sets never are
        dev_predict.add_tree_to_score(
            row, X, dev_predict.traversal_from_host_tree(
                tree, self.device, self.score_dtype),
            1.0, self.learner.bundle_arrays, out=row,
            packed_cols=self.learner.packed_cols if packed else 0)

    def _apply_tree_to_valid(self, tree: Tree, vi: int, tid: int) -> None:
        """As _apply_tree_to_train, for row tid of valid set vi."""
        if tree.num_leaves <= 1:
            return
        row = self._valid_score_dev[vi][tid]
        dev_predict.add_tree_to_score(
            row, self._valid_X_dev[vi],
            dev_predict.traversal_from_host_tree(tree, self.device,
                                                 self.score_dtype), 1.0,
            self.learner.bundle_arrays, out=row)

    def _stub_offset(self) -> int:
        """1 when models[0] is the boost_from_average stub: DART and
        InfiniteBoost index their iterations' trees past it."""
        return 1 if self.boost_from_average_used else 0

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

    def _models_changed(self) -> None:
        """Record a change to the trees: a new model generation."""
        self.model_generation += 1

    def _append_host_tree(self, tree: Tree) -> None:
        self.models.append(tree)
        self._models_dev.append(None)
        self._models_shrink.append(1.0)
        self._models_changed()

    def _pop_models(self, count: int) -> None:
        for _ in range(count):
            self.models.pop()
            self._models_dev.pop()
            self._models_shrink.pop()
        self._models_changed()

    def merge_init_models(self, base: "GBDT") -> None:
        """Put a base model's trees in front of this booster's (the
        JAX package's continued training through ``train(init_model=)``):
        the scores already start from the base model's raw scores (the
        init score), so only the trees join."""
        self.merge_from(base)
        self.boost_from_average_used = base.boost_from_average_used

    def merge_from(self, other: "GBDT") -> None:
        """GBDT::MergeFrom (gbdt.h:47-62): the other model's trees come
        first, as if this booster had continued from it, and they become
        the init iterations.  The scores are not replayed (the reference
        merges only the model arrays).  Copies, so a later in-place
        change (rollback's shrink) of one booster leaves the other as it
        was."""
        import copy
        self._materialize()
        other._materialize()
        trees = [copy.deepcopy(t) for t in other.models]
        self.models = trees + self.models
        self._models_dev = [None] * len(trees) + self._models_dev
        self._models_shrink = [1.0] * len(trees) + self._models_shrink
        self.num_init_iteration = (len(trees)
                                   // max(other.num_tree_per_iteration, 1))
        self._models_changed()

    def _add_constant(self, value: float, tid=None) -> None:
        """Add value to every score (tid None) or to row tid, in place."""
        c = torch.tensor(value, dtype=self.score_dtype, device=self.device)
        for s in [self._score_dev] + self._valid_score_dev:
            (s if tid is None else s[tid]).add_(c)

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

    def _bagging_with_grad(self, it: int, grad, hess):
        """Hook: bagging ignores the gradients; GOSS overrides it."""
        self._bagging(it)
        return grad, hess

    def _score_for_objective(self):
        """The score the objective's gradients are taken at: row 0 for one
        tree an iteration, the flat (K N,) view otherwise.  DART overrides
        it to drop trees first."""
        if self.num_tree_per_iteration == 1:
            return self._score_dev[0]
        return self._score_dev.reshape(-1)

    # ------------------------------------------------------------- iteration
    def _resolve_fused_iter(self):
        """``tpu_fused_iter`` (auto/on/off) resolved to a FusedIteration,
        or None for the staged chain; resolved once for the learner and
        objective, which reset_training_data rebuilds.

        auto fuses when eligible and the learner runs on CUDA (the
        hand-written kernels are live under wave and exact growth alike,
        and the host's launches are what the graphs remove), or where the
        autotuner measured the fused cell the winner (tpu_autotune); on
        the CPU it otherwise stays staged.  on fuses
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
            # auto also fuses where the autotuner measured the fused
            # cell the winner of this shape bucket
            if ok and (mode == "on" or self.device.type == "cuda"
                       or self.learner.fused_autotune):
                fused = fused_iter.FusedIteration(
                    self.learner, self.objective.get_gradients,
                    self.num_data, score_engine=self._score_engine)
                # its captures are the run's compiles (obs/compile.py)
                fused.observer = self._obs
        self._fused_state = (fused,)
        return fused

    def train_one_iter(self, gradients=None, hessians=None,
                       is_eval: bool = True) -> bool:
        """GBDT::TrainOneIter (gbdt.cpp:339-458), K trees; True = stop.

        gradients and hessians: custom host arrays of K * N values in the
        reference's class-major layout (a Python fobj's); they go to the
        device once, as one (2, K, N) f32 copy, and force the staged
        chain, as in the JAX package.  As there, an iteration without
        splits is looked for when is_eval is set or every 16th iteration;
        Booster.update passes is_eval=False."""
        cfg = self.config
        k = self.num_tree_per_iteration
        obs = self._obs
        it0 = self.iter
        obs.iter_begin(it0)
        # what the loop is doing, for /statusz and incident evidence
        # (obs/incident.py): a host dict update
        obs.stamp_context(stage="boost", it=it0, trees=len(self.models))
        # the host glue between device submissions (obs/timers.py): the
        # iter event's host_orchestration_s
        oc = OrchestrationClock() if obs.enabled else NULL_ORCH
        start_models = len(self.models)
        if (not self.models and cfg.boost_from_average
                and not self.has_init_score and self.num_class <= 1
                and self.objective is not None
                and self.objective.boost_from_average()):
            label = np.asarray(self.train_data.metadata.label,
                               dtype=np.float64)
            # the ranks' label sum over their rows (GlobalSyncUpBySum),
            # so every rank starts from the same score
            total, count = sum_across_ranks(
                self._row_comm(), [label.sum(), self.num_data])
            init_score = float(total / count)
            self._add_constant(init_score)
            self._append_host_tree(_stub_tree(init_score, self.num_data))
            self.boost_from_average_used = True

        custom = gradients is not None and hessians is not None
        fused = None if custom else self._resolve_fused_iter()
        grad = hess = None
        if fused is not None:
            # gradients, growth and the score update in one schedule
            self._bagging(self.iter)
            obs.lap("boost")
        else:
            oc.enter()
            if custom:
                gh = np.empty((2, k * self.num_data), dtype=np.float32)
                gh[0] = np.asarray(gradients, dtype=np.float32).reshape(-1)
                gh[1] = np.asarray(hessians, dtype=np.float32).reshape(-1)
                grad, hess = torch.as_tensor(gh, device=self.device)
            else:
                if self.objective is None:
                    Log.fatal("No object function provided")
                grad, hess = self.objective.get_gradients(
                    self._score_for_objective())
            oc.exit()
            grad, hess = self._bagging_with_grad(
                self.iter, grad.reshape(k, self.num_data),
                hess.reshape(k, self.num_data))
            # "boost": the objective's gradients and bagging
            obs.lap("boost", (grad, hess))
        # health monitors (obs/health.py): launch the finiteness and
        # magnitude reductions now, read them once below
        health = obs.health
        health_leaves = None
        if health is not None and health.due(it0):
            health.stage_gradients(grad, hess)
            health_leaves = []
        # the shrinkage travels as a host float (rounded to f32 by both
        # updates), read after the gradients (DART sets it as it drops
        # trees); every score is updated in place
        scale = self.shrinkage_rate
        grown = []
        for tid in range(k):
            if not self.class_need_train[tid]:
                tree = Tree(2)
                if len(self.models) < k:
                    out = self.class_default_output[tid]
                    tree = _stub_tree(out, self.num_data)
                    self._add_constant(out, tid)
                self._append_host_tree(tree)
                continue
            row = self._score_dev[tid]
            oc.enter()
            if fused is not None:
                # the tree is the fused iteration's buffer, so the model
                # keeps a copy
                t0 = obs.entry_start()
                obs.entry_args("fused_iter", fused.run,
                               (row, self.row_mult), names=("score",
                                                            "row_mult"))
                dev_tree, leaf_id, stats = fused.run(
                    row, self.row_mult, self.learner.sample_feature_mask(),
                    scale)
                obs.entry_end("fused_iter", t0, (dev_tree, leaf_id, row))
                obs.lap("grow", leaf_id)
                self.learner.last_stats = stats
                stored = dev_tree.clone()
                obs.lap("partition", row)
            else:
                dev_tree, leaf_id, stats = self.learner.train_device(
                    grad[tid], hess[tid], self.row_mult)
                obs.lap("grow", leaf_id)
                dev_predict.update_score_from_partition(
                    row, leaf_id, dev_tree.leaf_value, scale, out=row,
                    engine=self._score_engine)
                stored = dev_tree
                obs.lap("partition", row)
            oc.exit()
            self.grow_stats.append(stats)
            oc.enter()
            ta = dev_predict.traversal_from_grow(dev_tree, stats.num_leaves,
                                                 stats.depth)
            for vi in range(len(self.valid_data)):
                vrow = self._valid_score_dev[vi][tid]
                dev_predict.add_tree_to_score(
                    vrow, self._valid_X_dev[vi], ta, scale,
                    self.learner.bundle_arrays, out=vrow)
            if self.valid_data:
                obs.lap("update", self._valid_score_dev[-1])
            oc.exit()
            self.models.append(None)
            self._models_dev.append(stored)
            self._models_shrink.append(self.shrinkage_rate)
            self._models_changed()
            grown.append(stats.num_leaves)
            if health_leaves is not None:
                health_leaves.append(dev_tree.leaf_value)
            if self._metrics is not None:
                self._metrics["trees"].inc()
        # before the opt-in reads below (health, eval, model obs): the
        # host glue of the tree submissions only
        host_orch = oc.host_seconds()
        # the ranks' arrival skew (obs_straggler_every): a fence on this
        # iteration's scores and a collective, on the sampling cadence
        obs.straggler_sample(it0, self._score_dev)
        if health_leaves is not None:
            # one read of the staged scalars; may raise under
            # obs_health=fatal
            health.stage_leaf_values(health_leaves)
            health.run_checks(obs, it0)

        should_continue = bool(grown)
        if grown and (is_eval or self.iter % 16 == 0):
            should_continue = any(nl > 1 for nl in grown)
            # the ranks' stop vote: their trees are the same, so they
            # agree; the vote pins it, so no rank stops alone and leaves
            # the others waiting in the next collective
            should_continue = not vote_stop(self._dist_comm(),
                                            not should_continue)
        if not should_continue:
            self._pop_degenerate_iterations()
            obs.iter_end(it0, value=self._score_dev, stopped=True,
                         host_orchestration_s=host_orch)
            return True
        self.iter += 1
        self._emit_model_obs(it0, start_models)
        stop = False
        if is_eval:
            stop = self.eval_and_check_early_stopping()
            obs.lap("eval")
        obs.iter_end(it0, value=self._score_dev,
                     host_orchestration_s=host_orch)
        return stop

    def _emit_model_obs(self, it0: int, start_models: int) -> None:
        """Split-audit and importance events of this iteration
        (obs/model.py).  Both read the trees to the host, so both are
        opt-in: ``obs_split_audit`` audits every iteration's new trees,
        ``obs_importance_every=N`` snapshots the top-k importance every N
        iterations."""
        if not self._obs.enabled:
            return
        every = self._obs_importance_every
        imp_due = every > 0 and (it0 % every) == 0
        if not self._obs_split_audit and not imp_due:
            return
        from ..obs import model as obs_model
        self._materialize()
        if self._obs_split_audit:
            for t in range(start_models, len(self.models)):
                obs_model.emit_split_audit(self._obs, it0, t,
                                           self.models[t])
        if imp_due:
            obs_model.emit_importance(
                self._obs, it0, self.feature_importance("split"),
                self.feature_importance("gain"),
                self._obs_importance_topk)

    def _pop_degenerate_iterations(self) -> None:
        """No leaf met the split requirements: drop this iteration's K
        trees (gbdt.cpp:440-448)."""
        Log.warning("Stopped training because there are no more leaves "
                    "that meet the split requirements.")
        self._pop_models(self.num_tree_per_iteration)

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:460-477): subtract the trees
        at cur_iter * K + tid from the scores and pop the last K.  The
        index counts from the first model, the boost_from_average stub
        included, as the JAX package's does."""
        if self.iter <= 0:
            return
        self._materialize()
        k = self.num_tree_per_iteration
        cur_iter = self.iter + self.num_init_iteration - 1
        for tid in range(k):
            tree = self.models[cur_iter * k + tid]
            tree.shrink(-1.0)
            self._apply_tree_to_train(tree, tid)
            for vi in range(len(self.valid_data)):
                self._apply_tree_to_valid(tree, vi, tid)
        self._pop_models(k)
        self.iter -= 1

    # ------------------------------------------------------------------ eval
    def _dist_comm(self):
        """The training dataset's comm of more than one rank, or None:
        present only for rank-sharded datasets (io/dataset.py
        from_binned / from_matrix with a comm), the signal that metric
        values are over this rank's rows and stop decisions need a
        vote.  A closed comm (its run_ranks pool has exited) counts as
        none."""
        comm = (getattr(self.train_data, "_comm", None)
                if self.train_data is not None else None)
        if comm is not None and comm.size > 1 and not comm.closed:
            return comm
        return None

    def _row_comm(self):
        """``_dist_comm`` where the ranks hold different rows (the data-
        and voting-parallel learners); None under the feature-parallel
        learner, whose ranks all hold every row."""
        comm = self._dist_comm()
        if comm is None or self.learner is None \
                or getattr(self.learner, "parallel", "data") == "feature":
            return None
        return comm

    def _reduce_scores(self, scores, num_local_rows):
        """Row-weighted cross-rank mean of per-metric scores: a metric
        evaluates over this rank's rows, and the weighted mean by row
        count gives the row average every rank then agrees on, which
        keeps the early-stopping bookkeeping (and its model pop-back)
        the same on every rank.  (A metric that does not decompose, as
        AUC, gets the ranks' row-weighted mean, as in the JAX
        package.)"""
        comm = self._row_comm()
        if comm is None:
            return scores
        red = reduce_metrics(
            comm, {str(i): float(s) for i, s in enumerate(scores)},
            weight=float(num_local_rows))
        return [red[str(i)] for i in range(len(scores))]

    def eval_and_check_early_stopping(self) -> bool:
        """GBDT::EvalAndCheckEarlyStopping (gbdt.cpp:479-500): on a met
        criterion the trees of the last early_stopping_round iterations
        are popped."""
        best_msg = self.output_metric(self.iter)
        # a unanimous vote: with reduced metrics every rank computed the
        # same answer, so this guards against a rank that diverged
        if not vote_stop(self._dist_comm(), bool(best_msg)):
            return False
        Log.info("Early stopping at iteration %d, the best iteration round "
                 "is %d", self.iter, self.iter - self.early_stopping_round)
        Log.info("Output of best iteration round:\n%s", best_msg)
        self._pop_models(self.early_stopping_round
                         * self.num_tree_per_iteration)
        return True

    def output_metric(self, it: int) -> str:
        """GBDT::OutputMetric (gbdt.cpp:527-585): log the metrics every
        output_freq iterations and track each valid metric's best; the
        best message of a metric that has not improved for
        early_stopping_round iterations, else ''."""
        esr = self.early_stopping_round
        need_output = (it % self.config.output_freq) == 0
        ret = ""
        msg_lines: List[str] = []
        meet_pairs: List[Tuple[int, int]] = []
        # the metric values are also the timeline's eval event
        eval_results: List[dict] = []
        if need_output:
            for m in self.training_metrics:
                scores = self._reduce_scores(
                    m.eval(self.train_score, self.objective), self.num_data)
                for name, s in zip(m.get_names(), scores):
                    line = "Iteration:%d, training %s : %g" % (it, name, s)
                    Log.info(line)
                    eval_results.append({"dataset": "training",
                                         "metric": name, "value": float(s)})
                    if esr > 0:
                        msg_lines.append(line)
        if need_output or esr > 0:
            for i in range(len(self.valid_metrics)):
                for j, m in enumerate(self.valid_metrics[i]):
                    test_scores = self._reduce_scores(
                        m.eval(self.valid_score_host(i), self.objective),
                        self.valid_data[i].num_data)
                    for name, s in zip(m.get_names(), test_scores):
                        line = "Iteration:%d, valid_%d %s : %g" % (
                            it, i + 1, name, s)
                        if need_output:
                            Log.info(line)
                            eval_results.append(
                                {"dataset": "valid_%d" % (i + 1),
                                 "metric": name, "value": float(s)})
                        if esr > 0:
                            msg_lines.append(line)
                    if not ret and esr > 0:
                        cur = m.factor_to_bigger_better * test_scores[-1]
                        if cur > self.best_score[i][j]:
                            self.best_score[i][j] = cur
                            self.best_iter[i][j] = it
                            meet_pairs.append((i, j))
                        elif it - self.best_iter[i][j] >= esr:
                            ret = self.best_msg[i][j]
        if eval_results:
            self._last_eval_results = eval_results
            self._drift_fingerprint = None   # eval snapshot went stale
            if self._obs.enabled:
                self._obs.event("eval", it=it, results=eval_results)
        msg = "\n".join(msg_lines)
        for i, j in meet_pairs:
            self.best_msg[i][j] = msg
        return ret

    def get_eval_at(self, data_idx: int) -> List[float]:
        """GBDT::GetEvalAt (gbdt.cpp:588-609); the ranks' row-weighted
        mean under a distributed learner (``_reduce_scores``), so the
        early-stopping callback decides alike on every rank."""
        out: List[float] = []
        if data_idx == 0:
            for m in self.training_metrics:
                out.extend(m.eval(self.train_score, self.objective))
            return self._reduce_scores(out, self.num_data)
        i = data_idx - 1
        for m in self.valid_metrics[i]:
            out.extend(m.eval(self.valid_score_host(i), self.objective))
        return self._reduce_scores(out, self.valid_data[i].num_data)

    def eval_names(self, data_idx: int) -> List[str]:
        ms = (self.training_metrics if data_idx == 0
              else self.valid_metrics[data_idx - 1])
        return [n for m in ms for n in m.get_names()]

    # --------------------------------------------------------------- predict
    def num_model_per_iteration(self) -> int:
        return self.num_tree_per_iteration

    def total_iterations(self) -> int:
        return len(self.models) // self.num_tree_per_iteration

    def _used_trees(self, num_iteration: int) -> int:
        num_used = len(self.models)
        if num_iteration > 0:
            ni = num_iteration + (1 if self.boost_from_average_used else 0)
            num_used = min(ni * self.num_tree_per_iteration, len(self.models))
        return num_used

    def predict_raw(self, features: np.ndarray, num_iteration: int = -1,
                    allow_device: bool = True) -> np.ndarray:
        """Raw scores (N, K) on real-valued features, tree t adding to
        class t % K (gbdt_prediction.cpp PredictRaw): through the ranked
        traversal on the booster's device where ``tpu_predict`` says so
        (_device_bulk_predict), else summed in float64 on the host, in
        tree order, by the host library (native.py) or the Python trees
        (the same bits).  allow_device=False pins the exact f64 host
        path."""
        self._materialize()
        features = np.ascontiguousarray(np.asarray(features,
                                                   dtype=np.float64))
        k = self.num_tree_per_iteration
        num_used = self._used_trees(num_iteration)
        if allow_device:
            dev = self._device_bulk_predict(features, num_used, k)
            if dev is not None:
                return dev
        from .. import native
        nat = native.predict_raw(
            [(self.models[t], t % k) for t in range(num_used)], k, features)
        if nat is not None:
            return nat
        out = np.zeros((features.shape[0], k), dtype=np.float64)
        for t in range(num_used):
            out[:, t % k] += self.models[t].predict(features)
        return out

    # ------------------------------------------------- device bulk predict
    _DEVICE_PREDICT_MIN_ROWS = 100_000
    # trees a traversal block descends together: the (rows, trees) state
    # is counted into the chunk budget (_predict_chunk_rows)
    _TREE_BLOCK = 32

    @staticmethod
    def _predict_chunk_rows(n_features: int, tree_block: int) -> int:
        """Rows per device-predict chunk: V (i32) and D (bool) cost 5
        bytes a feature a row, the traversal's state
        STATE_BYTES_PER_TREE a tree of the block a row.  The one-deep
        pipeline keeps two chunks' inputs resident, so a chunk gets
        1.5 GB."""
        bytes_per_row = (max(n_features, 1) * 5
                         + dev_predict.STATE_BYTES_PER_TREE
                         * max(tree_block, 1))
        return min(4_000_000, max(65_536, 1_500_000_000 // bytes_per_row))

    def _device_bulk_predict(self, features, num_used, k):
        """Rank-encoded bulk prediction on the booster's device, or
        over the entries of set_predict_devices (ops/predict.py
        ranked_predict_sharded): f64-exact routing as int compares, Kahan f32
        accumulation.  None when the host path runs instead:
        tpu_predict=false; under auto, a booster off the card or fewer
        than _DEVICE_PREDICT_MIN_ROWS rows; a model whose features mix
        categorical and numerical decisions (with a warning); or fewer
        columns than the model uses."""
        from ..utils.config import _FALSE_SET, _TRUE_SET
        cfg = str(getattr(self.config, "tpu_predict", "auto")).strip().lower()
        if cfg in _FALSE_SET:
            return None
        device = self.device
        if cfg not in _TRUE_SET:       # auto
            if (device.type != "cuda"
                    or features.shape[0] < self._DEVICE_PREDICT_MIN_ROWS):
                return None
        # keyed on the model generation: a rollback followed by a new
        # iteration restores the tree count with another last tree
        key = (num_used, k, self.model_generation, features.shape[1])
        if getattr(self, "_ranked_pred_key", None) != key:
            try:
                self._ranked_pred = dev_predict.build_ranked_predictor(
                    self.models[:num_used], k, features.shape[1], device)
            except ValueError as e:    # mixed cat/num feature use
                Log.warning("device bulk predict unavailable (%s); "
                            "using the host predictor", e)
                self._ranked_pred = None
            self._ranked_pred_key = key
        rp = self._ranked_pred
        if rp is None:
            return None
        if features.shape[1] < rp.max_feature + 1:
            return None                # fewer columns than the model uses
        block = min(max(rp.dev.num_trees, 1), self._TREE_BLOCK)
        # several devices (set_predict_devices) each take a share of a
        # chunk's rows, so a chunk holds as many budgets as there are
        # distinct devices; the scores land on the first entry's
        devices = [resolve_device(d)
                   for d in (self.predict_devices or [device])]
        first = devices[0]
        chunk = (self._predict_chunk_rows(features.shape[1], block)
                 * len(set(devices)))
        out = np.empty((features.shape[0], k), np.float64)
        pin = any(d.type == "cuda" for d in devices)

        def dispatch(part):
            """Encode into pinned memory, copy and traverse, with no
            wait: the scores land in pinned memory behind an event."""
            shape = part.shape
            V = torch.empty(shape, dtype=torch.int32, pin_memory=pin)
            D = torch.empty(shape, dtype=torch.bool, pin_memory=pin)
            dev_predict.rank_encode(rp, part, out=(V.numpy(), D.numpy()))
            # rows shard over the devices, the trees replicate: the bits
            # of one device (ops/predict.py)
            score, n = dev_predict.ranked_predict_sharded(
                rp, V, D, k, devices=devices, tree_block=block)
            score = score[:n]
            if first.type != "cuda":
                return score, None
            with torch.cuda.device(first):
                # the copy and its event on the first entry's stream
                host = torch.empty(score.shape, dtype=score.dtype,
                                   pin_memory=True)
                host.copy_(score, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            return host, done

        def drain(lo, host, done):
            if done is not None:
                # the drain's one wait: the chunk's scores in pinned
                # memory, read by the host next
                done.synchronize()  # lint: ignore[sync-synchronize] drain
            out[lo:lo + host.shape[0]] = host.numpy()

        # one-deep pipeline: encode chunk i+1 on the host while the
        # device computes chunk i; drain is the only wait
        pending = None
        for lo in range(0, features.shape[0], chunk):
            host, done = dispatch(features[lo:lo + chunk])
            if pending is not None:
                drain(*pending)
            pending = (lo, host, done)
        if pending is not None:
            drain(*pending)
        return out

    def predict(self, features: np.ndarray, num_iteration: int = -1,
                raw_score: bool = False,
                pred_leaf: bool = False) -> np.ndarray:
        """(N,) for one tree an iteration, else (N, K); converted by the
        objective unless raw_score.  pred_leaf: (N, trees) leaf indices."""
        if pred_leaf:
            return self.predict_leaf_index(features, num_iteration)
        raw = self.predict_raw(features, num_iteration)
        if raw.shape[1] == 1:
            raw = raw[:, 0]
        if raw_score or self.objective is None:
            return raw
        return np.asarray(self.objective.convert_output(raw))

    def predict_leaf_index(self, features: np.ndarray,
                           num_iteration: int = -1) -> np.ndarray:
        """(N, trees) leaf index of each row in each tree (host f64)."""
        self._materialize()
        features = np.ascontiguousarray(np.asarray(features,
                                                   dtype=np.float64))
        num_used = self._used_trees(num_iteration)
        cols = [self.models[t].predict_leaf_index(features)
                for t in range(num_used)]
        return (np.stack(cols, axis=1) if cols
                else np.zeros((features.shape[0], 0), np.int32))

    def pred_contrib(self, features: np.ndarray, num_iteration: int = -1,
                     per: str = "feature") -> np.ndarray:
        """Prediction attribution (host-only, f64 exact).

        per='tree': (N, num_used) matrix of each tree's contribution —
        column t sums into raw-score class t % num_tree_per_iteration, so
        summing the columns of a class reproduces predict_raw exactly.

        per='feature': gain-weighted path attribution per tree
        (Tree.predict_contrib), summed over trees.  Returns
        (N, num_features + 1) for single-output models — the last column
        is the bias (stub trees and zero-gain paths) — and
        (N, k, num_features + 1) for multi-class.  Rows sum to the raw
        score by construction.
        """
        if per not in ("feature", "tree"):
            raise KeyError("pred_contrib per must be 'feature' or 'tree'")
        self._materialize()
        features = np.ascontiguousarray(np.asarray(features,
                                                   dtype=np.float64))
        n = features.shape[0]
        k = self.num_tree_per_iteration
        num_used = self._used_trees(num_iteration)
        if per == "tree":
            out = np.zeros((n, num_used), dtype=np.float64)
            for t in range(num_used):
                out[:, t] = self.models[t].predict(features)
            return out
        nf = self.max_feature_idx + 1
        out = np.zeros((n, k, nf + 1), dtype=np.float64)
        for t in range(num_used):
            out[:, t % k, :] += self.models[t].predict_contrib(features, nf)
        return out[:, 0, :] if k == 1 else out

    # ------------------------------------------------------------- model I/O
    def drift_fingerprint(self) -> Optional[dict]:
        """The serving-time drift reference (obs/drift.py): the dataset's
        per-feature binned histograms completed with the training-score
        distribution and the last eval snapshot; cached (each eval pass
        invalidates it).  A model loaded from a text that carries a
        ``drift_fingerprint=`` line takes that one.  As in the JAX
        package, the model text carries the line whenever the training
        dataset was fingerprinted: built in memory, or opened from a
        directory whose header carries the fingerprint (save_binned of a
        fingerprinted dataset); a streamed or binary-file dataset
        carries none."""
        if self._drift_fingerprint is not None:
            return self._drift_fingerprint
        base = getattr(self.train_data, "_drift_fingerprint", None)
        if base is None:
            return None
        from ..obs import drift
        # a rank of a distributed learner holds only its rows: its text
        # carries the shared feature fingerprint and the reduced eval
        # snapshot, no score histogram, so the ranks' texts are equal
        score = (self.train_score if self._score_dev is not None
                 and self._row_comm() is None else None)
        self._drift_fingerprint = drift.attach_scores(
            base, train_score=score, objective=self.objective,
            eval_results=self._last_eval_results)
        return self._drift_fingerprint

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
        fp = self.drift_fingerprint()
        if fp is not None:
            # one compact-JSON header line (the JAX package's): a process
            # that loads the text gets the serving-time drift reference
            lines.append("drift_fingerprint=%s"
                         % json.dumps(fp, sort_keys=True,
                                      separators=(",", ":")))
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
        """GBDT::LoadModelFromString (gbdt.cpp:875-971); a
        ``drift_fingerprint=`` line becomes the serving-time drift
        reference (obs/drift.py)."""
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
        if "drift_fingerprint" in kv:
            try:
                self._drift_fingerprint = json.loads(kv["drift_fingerprint"])
            except ValueError as e:
                Log.warning("ignoring malformed drift_fingerprint in "
                            "model text: %s", e)
        for part in "\n".join(lines).split("Tree=")[1:]:
            body = []
            for bl in part.splitlines()[1:]:
                if bl.startswith("feature importances"):
                    break
                body.append(bl)
            block = "\n".join(body).strip()
            if block:
                self._append_host_tree(Tree.from_string(block))
        self.num_init_iteration = (len(self.models)
                                   // max(self.num_tree_per_iteration, 1))
        self.iter = 0
        self._models_changed()
        return True

    def sub_model_name(self) -> str:
        return "tree"

    def dump_model(self, num_iteration: int = -1) -> str:
        """GBDT::DumpModel JSON (gbdt.cpp:665-699), the JAX package's
        characters for the same model text."""
        self._materialize()
        out = ['{"name":"%s",' % self.sub_model_name(),
               '"num_class":%d,' % self.num_class,
               '"num_tree_per_iteration":%d,' % self.num_tree_per_iteration,
               '"label_index":%d,' % self.label_idx,
               '"max_feature_idx":%d,' % self.max_feature_idx]
        if self.objective is not None:
            out.append('"objective":"%s",' % self.objective.to_string())
        out.append('"feature_names":[%s],' % ",".join(
            '"%s"' % n for n in self.feature_names))
        out.append('"tree_info":[')
        out.append(",".join('{"tree_index":%d,%s}'
                            % (i, self.models[i].to_json())
                            for i in range(self._used_trees(num_iteration))))
        out.append("]}")
        return "\n".join(out)

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
