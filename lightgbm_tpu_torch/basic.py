"""Python-facing Dataset and Booster: the JAX package's ``basic.py``
surface for in-memory matrices, dense or scipy sparse, and text files.

Semantics kept: lazy Dataset construction, validation sets binned with the
training set's mappers, the parameter dict with its aliases, training,
evaluation, prediction (raw, converted, leaf indices, contributions,
prediction early stopping), serving (``Booster.serve``) and the text model
round trip, and continued training from a model (``_InnerPredictor``:
the init scores through the f64 host trees).  A Booster, trained or
loaded from model text, lives on
``device`` ("cuda" unless the caller asks for "cpu"); bulk prediction and
serving run the ranked traversal there.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from .device import resolve_device
from .io.dataset import TrainingData
from .io.sparse import (SparseColumns, from_scipy, is_scipy_sparse,
                        iter_dense_row_chunks)
from .metrics import create_metric
from .models.factory import create_boosting
from .models.gbdt import GBDT
from .objectives import create_objective
from .obs.metrics import observe_predict
from .utils.config import Config
from .utils.log import LightGBMError

__all__ = ["Dataset", "Booster", "LightGBMError"]


def _matrix(data):
    """A dense float64 array, or SparseColumns for scipy sparse input,
    which stays sparse (binned column by column, never densified)."""
    if isinstance(data, SparseColumns):
        return data
    if is_scipy_sparse(data):
        return from_scipy(data)
    return np.asarray(data, dtype=np.float64)


class Dataset:
    """Lazily constructed training dataset (python-package basic.py:546)."""

    def __init__(self, data, label=None, max_bin=None, reference=None,
                 weight=None, init_score=None, feature_name="auto",
                 categorical_feature="auto", params=None):
        """data: a dense matrix, a scipy sparse matrix, or the path of a
        CSV/TSV/LibSVM text file (io/dataset.py TrainingData.from_file:
        the label column, header, ignored and categorical columns from
        ``params``, and the .weight/.query/.init side files)."""
        self.data = data if isinstance(data, str) else _matrix(data)
        self.label = None if label is None else np.asarray(label)
        self.reference = reference
        self.weight = weight
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        if max_bin is not None:
            self.params.setdefault("max_bin", max_bin)
        self._handle: Optional[TrainingData] = None
        self._predictor: Optional["_InnerPredictor"] = None

    def construct(self) -> "Dataset":
        """Bin the raw data (no-op when already constructed).  Dense rows
        are kept (``raw_data``) for continued training."""
        if self._handle is not None:
            return self
        cfg = Config(dict(self.params))
        ref_td = None
        if self.reference is not None:
            ref_td = self.reference.construct()._handle
        if isinstance(self.data, str):
            self._handle = TrainingData.from_file(self.data, cfg,
                                                  reference=ref_td,
                                                  keep_raw=True)
            if self.label is not None:
                self._handle.metadata.set_label(self.label)
            for name, value in (("weight", self.weight),
                                ("init_score", self.init_score)):
                if value is not None:
                    self._handle.metadata.set_field(name, value)
            self._fill_init_score()
            return self
        names = (None if self.feature_name in (None, "auto")
                 else list(self.feature_name))
        cats = []
        if self.categorical_feature not in (None, "auto"):
            spec = self.categorical_feature
            for c in ([spec] if isinstance(spec, (int, str)) else spec):
                if isinstance(c, str):
                    if not names or c not in names:
                        raise LightGBMError("Unknown categorical column %r"
                                            % c)
                    c = names.index(c)
                cats.append(int(c))
        build = (TrainingData.from_csc
                 if isinstance(self.data, SparseColumns)
                 else TrainingData.from_matrix)
        kw = {} if isinstance(self.data, SparseColumns) else {
            "keep_raw": True}
        self._handle = build(
            self.data, label=self.label, config=cfg, weights=self.weight,
            init_score=self.init_score, categorical_feature=cats,
            feature_names=names, reference=ref_td, **kw)
        self._fill_init_score()
        return self

    def _set_predictor(self, predictor: "_InnerPredictor") -> "Dataset":
        """Continued training: the init scores become the predictor's raw
        scores on this data (at construction, or now if constructed)."""
        self._predictor = predictor
        if self._handle is not None:
            self._fill_init_score()
        return self

    def _fill_init_score(self) -> None:
        """(K, N) class-major init scores from the predictor's f64 host
        trees (JAX basic.py:252-264), on the kept rows or, for sparse
        data, on bounded dense row chunks."""
        if self._predictor is None:
            return
        handle = self._handle
        if handle.raw_data is not None:
            raw = self._predictor.predict_raw_for_init(handle.raw_data)
        elif isinstance(self.data, SparseColumns):
            raw = np.concatenate(
                [self._predictor.predict_raw_for_init(block)
                 for _, block in iter_dense_row_chunks(self.data)])
        else:
            raise LightGBMError("continued training needs the raw rows of "
                                "the training data")
        handle.metadata.set_init_score(raw.T.reshape(-1))

    def create_valid(self, data, label=None, weight=None, init_score=None,
                     params=None) -> "Dataset":
        """Validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       init_score=init_score, params=params or self.params)

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self._handle is not None and reference is not self.reference:
            raise LightGBMError("Cannot set reference after the Dataset "
                                "was constructed")
        self.reference = reference
        return self

    def _update_params(self, params: Optional[dict]) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    def num_data(self) -> int:
        if self._handle is not None or isinstance(self.data, str):
            return self.construct()._handle.num_data
        if isinstance(self.data, SparseColumns):
            return self.data.num_row
        return int(self.data.shape[0])

    def num_feature(self) -> int:
        if self._handle is not None or isinstance(self.data, str):
            return self.construct()._handle.num_total_features
        if isinstance(self.data, SparseColumns):
            return self.data.num_col
        return int(self.data.shape[1])

    def get_label(self):
        if self._handle is not None and self._handle.metadata.label is not None:
            return np.asarray(self._handle.metadata.label)
        return self.label


class _InnerPredictor:
    """Continued-training score provider (JAX basic.py:446-473): a model
    from a Booster, a model file or model text, whose raw scores seed a
    new training run."""

    def __init__(self, booster: Optional["Booster"] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        if booster is not None:
            self.gbdt = booster._gbdt
            return
        if model_file is not None:
            with open(model_file) as f:
                model_str = f.read()
        if model_str is None:
            raise LightGBMError("Need booster, model_file or model_str")
        # only its host trees run: it lives on the CPU
        self.gbdt = GBDT(Config(), resolve_device("cpu"))
        self.gbdt.load_model_from_string(model_str)

    def predict_raw_for_init(self, features: np.ndarray) -> np.ndarray:
        """(N, K) raw scores on the exact f64 host path: the init scores
        of continued training must not take the f32 device traversal."""
        return self.gbdt.predict_raw(features, allow_device=False)


class Booster:
    """Training-capable model wrapper (python-package basic.py:1171).

    Built from ``train_set`` (training on ``device``) or from model text
    (``model_file`` or ``model_str``), which then predicts and serves on
    ``device``: "cuda" by default, raising without a card, or "cpu"."""

    def __init__(self, params: Optional[dict] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None, device="cuda"):
        self.params = dict(params or {})
        self._valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self._train_set = train_set
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                "met %s" % type(train_set).__name__)
            self.device = resolve_device(device)
            cfg = Config(self.params)
            handle = train_set._update_params(self.params).construct()._handle
            objective = create_objective(cfg.objective, cfg)
            if objective is not None:
                objective.init(handle.metadata, handle.num_data, self.device)
            metrics = self._make_metrics(cfg, handle)
            self._cfg = cfg
            self._gbdt = create_boosting(cfg.boosting_type, cfg,
                                         self.device, handle, objective,
                                         metrics)
            if train_set._predictor is not None:
                # continued training: the scores start from the init
                # model's raw scores; its trees go in front
                self._gbdt.merge_init_models(train_set._predictor.gbdt)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self.device = resolve_device(device)
            self._cfg = Config(self.params)
            self._gbdt = GBDT(self._cfg, self.device)
            self._gbdt.load_model_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file to create booster instance")

    @staticmethod
    def _make_metrics(cfg: Config, handle: TrainingData) -> list:
        out = []
        for name in cfg.metrics():
            m = create_metric(name, cfg)
            if m is not None:
                m.init(handle.metadata, handle.num_data)
                out.append(m)
        return out

    # ------------------------------------------------------------- training
    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """Register a validation set; its scores follow every new tree."""
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            "met %s" % type(data).__name__)
        if data.reference is None:
            data.set_reference(self._train_set)
        handle = data._update_params(self.params).construct()._handle
        self._gbdt.add_valid_dataset(handle,
                                     self._make_metrics(self._cfg, handle))
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        return self

    def update(self) -> bool:
        """One boosting iteration; True when it grew no split (its trees
        are then dropped).  As in the JAX package, the booster's own
        early_stopping_round is not evaluated here (train() runs the
        early_stopping callback instead)."""
        return self._gbdt.train_one_iter(False)

    def rollback_one_iter(self) -> "Booster":
        """Undo the most recent boosting iteration."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_parameter(self, params: dict) -> "Booster":
        """New parameters for the iterations to come, as the JAX
        package's: learning_rate alone sets the shrinkage of the next
        trees; any other key rebuilds the config and the learner, with
        the scores and the trees kept."""
        params = dict(params or {})
        self.params.update(params)
        if "learning_rate" in params:
            self._gbdt.shrinkage_rate = float(params["learning_rate"])
        rest = [k for k in params if k != "learning_rate"]
        if rest:
            if "objective" in rest:
                raise LightGBMError("Cannot change objective during "
                                    "training; create a new Booster "
                                    "instead")
            cfg = Config(dict(self.params))
            if self._gbdt.train_data is not None:
                self._gbdt.reset_config(cfg)
            else:
                self._gbdt.config = cfg
        return self

    def current_iteration(self) -> int:
        return self._gbdt.total_iterations()

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_model_per_iteration()

    def num_trees(self) -> int:
        self._gbdt._materialize()
        return len(self._gbdt.models)

    # ----------------------------------------------------------------- eval
    def eval_train(self) -> List[tuple]:
        return self._eval(0, "training")

    def eval_valid(self) -> List[tuple]:
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._eval(i + 1, name))
        return out

    def eval(self, data: Dataset, name: str) -> List[tuple]:
        if data is self._train_set:
            return self._eval(0, name)
        for i, vs in enumerate(self._valid_sets):
            if data is vs:
                return self._eval(i + 1, name)
        raise LightGBMError("Data should be train set or a validation set")

    def _eval(self, data_idx: int, name: str) -> List[tuple]:
        g = self._gbdt
        metrics = (g.training_metrics if data_idx == 0
                   else g.valid_metrics[data_idx - 1])
        higher = [m.factor_to_bigger_better > 0
                  for m in metrics for _ in m.get_names()]
        return [(name, mname, s, hb) for mname, s, hb in
                zip(g.eval_names(data_idx), g.get_eval_at(data_idx), higher)]

    # -------------------------------------------------------------- predict
    def predict(self, data, num_iteration: int = -1, raw_score: bool = False,
                pred_leaf: bool = False, pred_contrib: bool = False,
                data_has_header: bool = False, is_reshape: bool = True,
                pred_early_stop: bool = False,
                pred_early_stop_freq: int = 10,
                pred_early_stop_margin: float = 10.0):
        """Predict rows of a dense or scipy sparse matrix, or of a text
        file (its path; ``data_has_header`` skips its first line, and its
        label column, the first, is dropped as the CLI drops it): (N,)
        for one tree an iteration, (N, K) for K.  Sparse input is
        densified a bounded row chunk at a time.  num_iteration <= 0 uses every tree
        (not best_iteration, as in the JAX package).

        Raw and converted scores go through the ranked traversal on the
        booster's device where ``tpu_predict`` says so (true; auto: on
        the card from 100,000 rows), else through the float64 host
        trees.  ``pred_leaf``: (N, trees) leaf indices;
        ``pred_contrib``: (N, num_features + 1) gain-weighted
        contributions, the last column the bias, rows summing to the raw
        score (GBDT.pred_contrib); ``pred_early_stop``: the margin-based
        early stop of predictor.py.  Each call's rows and seconds land
        in the metrics registry (obs/metrics.py observe_predict)."""
        if isinstance(data, Dataset):
            raise TypeError("Cannot use Dataset instance for prediction, "
                            "please use raw data instead")
        t0 = time.perf_counter()
        if isinstance(data, str):
            from .io import parser as _parser
            data = _parser.parse_file(data,
                                      has_header=data_has_header).features
        out, rows = self._predict_data(data, num_iteration, raw_score,
                                       pred_leaf, pred_contrib,
                                       pred_early_stop, pred_early_stop_freq,
                                       pred_early_stop_margin)
        observe_predict(rows, time.perf_counter() - t0)
        return out

    def _predict_data(self, data, num_iteration, raw_score, pred_leaf,
                      pred_contrib, pred_early_stop=False,
                      pred_early_stop_freq=10, pred_early_stop_margin=10.0):
        """-> (predictions, input row count)."""
        early_predictor = None
        if pred_early_stop and not (pred_leaf or pred_contrib):
            from .predictor import Predictor
            early_predictor = Predictor(
                self._gbdt, num_iteration=num_iteration,
                raw_score=raw_score, early_stop=True,
                early_stop_freq=pred_early_stop_freq,
                early_stop_margin=pred_early_stop_margin)

        def run(block):
            if early_predictor is not None:
                return early_predictor._predict_impl(block)
            if pred_contrib:
                return self._gbdt.pred_contrib(block,
                                               num_iteration=num_iteration)
            return self._gbdt.predict(block, num_iteration=num_iteration,
                                      raw_score=raw_score,
                                      pred_leaf=pred_leaf)

        mat = _matrix(data)
        if isinstance(mat, SparseColumns):
            outs = [run(block) for _, block in iter_dense_row_chunks(mat)]
            return ((np.concatenate(outs) if outs
                     else np.zeros(0, dtype=np.float64)), mat.num_row)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        return run(mat), mat.shape[0]

    def serve(self, num_iteration: int = -1, **overrides):
        """A ``ServingPredictor`` for this model (serve/scheduler.py):
        concurrent callers ``submit()`` feature rows and get futures;
        requests coalesce into padded power-of-two buckets, each a CUDA
        graph on the card, with ``pred_early_stop`` and ``pred_contrib``
        served from the same queue.  Configured from the ``serve_*``
        parameters; keyword ``overrides`` take precedence (``max_batch``,
        ``max_delay_ms``, ``bucket_min``, ``donate``,
        ``batch_event_every``, ``queue_limit``, ``request_deadline_ms``,
        ``request_event_every``, ``slo_p99_ms``, ``slo_qps``,
        ``slo_window_s``, ``slo_every_s``, ``slo_mode``,
        ``num_features``, ``devices``).  Close it, or use it as a context
        manager, to flush the queue and stop the worker thread.  The
        predictor takes this booster's trees once, when it is built: a
        later update, rollback or reload of the booster does not reach
        it (build another).  Drift
        monitoring (``obs_drift_every``) and the live telemetry plane
        (``obs_http_port``) are not in the port yet and raise."""
        from .serve import ServingPredictor
        cfg = self._cfg
        if int(cfg.obs_http_port) >= 0:
            raise LightGBMError("obs_http_port: the live telemetry plane "
                                "is not in lightgbm_tpu_torch yet")
        kw = {"max_batch": cfg.serve_max_batch,
              "max_delay_ms": cfg.serve_max_delay_ms,
              "bucket_min": cfg.serve_bucket_min,
              "donate": cfg.serve_donate,
              "batch_event_every": cfg.serve_batch_event_every,
              "queue_limit": cfg.serve_queue_limit,
              "request_deadline_ms": cfg.serve_request_deadline_ms,
              "request_event_every": cfg.serve_request_event_every,
              "slo_p99_ms": cfg.serve_slo_p99_ms,
              "slo_qps": cfg.serve_slo_qps,
              "slo_window_s": cfg.serve_slo_window_s,
              "slo_every_s": cfg.serve_slo_every_s,
              # burn-rate alerts follow the health channel's consequence
              # mode; obs_health=off still warns
              "slo_mode": (cfg.obs_health if cfg.obs_health != "off"
                           else "warn"),
              "drift_every": cfg.obs_drift_every}
        kw.update(overrides)
        return ServingPredictor(self._gbdt, num_iteration=num_iteration,
                                **kw)

    # ------------------------------------------------------------- model io
    def model_to_string(self, num_iteration: int = -1) -> str:
        return self._gbdt.save_model_to_string(num_iteration)

    def save_model(self, filename: str,
                   num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def feature_importance(self, importance_type: str = "split"):
        return self._gbdt.feature_importance(importance_type)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    # ---------------------------------------------------------- chip facts
    def grow_stats(self) -> list:
        """Per-tree growth facts of this booster's training (waves, host
        reads while growing, depth, leaves), oldest first."""
        return list(self._gbdt.grow_stats)
