"""Python-facing Dataset and Booster: the JAX package's ``basic.py``
surface for in-memory matrices (dense, scipy sparse or pandas), text
files, binary dataset files and pre-binned directories
(``save_binned``/``from_binned``, io/binned_format.py).

Semantics kept: lazy Dataset construction, validation sets binned with the
training set's mappers, the metadata setters and getters (label, weight,
group, init_score), row subsets, pandas category columns coded against
the training frame's categories (the ``pandas_categorical`` line of the
model text), the parameter dict with its aliases, training (with a
custom objective ``fobj(preds, train_data) -> (grad, hess)`` through
``Booster.update``), evaluation (with ``feval``), prediction (raw,
converted, leaf indices, contributions, prediction early stopping),
serving (``Booster.serve``), the text model round trip and its JSON dump,
pickling through the model text, and continued training from a model
(``_InnerPredictor``: the init scores through the f64 host trees).  A
Booster, trained, loaded from model text or unpickled, lives on
``device`` ("cuda" unless the caller asks for "cpu"); bulk prediction and
serving run the ranked traversal there.
"""
from __future__ import annotations

import json
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
from .utils.log import LightGBMError, Log

__all__ = ["Dataset", "Booster", "LightGBMError"]


def _matrix(data):
    """A dense float64 array, or SparseColumns for scipy sparse input,
    which stays sparse (binned column by column, never densified)."""
    if isinstance(data, SparseColumns):
        return data
    if is_scipy_sparse(data):
        return from_scipy(data)
    return np.asarray(data, dtype=np.float64)


def _is_pandas_frame(data) -> bool:
    try:
        import pandas as pd
    except ImportError:
        return False
    return isinstance(data, pd.DataFrame)


def _values(a):
    """A pandas Series or DataFrame's values; anything else as it is."""
    try:
        import pandas as pd
    except ImportError:
        return a
    if isinstance(a, (pd.Series, pd.DataFrame)):
        return a.values
    return a


# bool / int / uint / float columns train as they are
_PANDAS_OK_KINDS = "biuf"


def _data_from_pandas(data, feature_name, categorical_feature,
                      pandas_categorical):
    """Code the category-dtype columns and resolve auto names, as the
    reference's pandas path does (python-package basic.py:224-291).

    ``pandas_categorical=None`` (a training frame): the category lists of
    its columns are recorded and returned.  Otherwise (a validation or
    prediction frame) each category column is coded against the training
    lists, so the integer codes agree whatever order the frames saw the
    categories in.  A NaN or unseen category codes to -1, as in the JAX
    package.  Returns ``(matrix, feature_name, categorical_feature,
    pandas_categorical)``."""
    cat_cols = [c for c in data.columns if str(data[c].dtype) == "category"]
    if pandas_categorical is None:
        pandas_categorical = [list(data[c].cat.categories) for c in cat_cols]
    elif len(cat_cols) != len(pandas_categorical):
        raise LightGBMError(
            "train and valid dataset categorical_feature do not match.")
    if cat_cols:
        data = data.copy()      # the caller's frame stays as it was
        for c, train_cats in zip(cat_cols, pandas_categorical):
            if list(data[c].cat.categories) != list(train_cats):
                data[c] = data[c].cat.set_categories(train_cats)
            data[c] = data[c].cat.codes
    if categorical_feature is not None:
        if categorical_feature == "auto":
            categorical_feature = [str(c) for c in cat_cols]
        else:
            categorical_feature = (list(categorical_feature)
                                   + [str(c) for c in cat_cols])
    if feature_name == "auto":
        feature_name = [str(c) for c in data.columns]
    bad = [str(c) for c, dt in zip(data.columns, data.dtypes)
           if getattr(dt, "kind", "O") not in _PANDAS_OK_KINDS]
    if bad:
        raise LightGBMError(
            "DataFrame.dtypes for data must be int, float or bool; found "
            "unsupported dtypes in fields: " + ", ".join(bad))
    return (data.values.astype(np.float64), feature_name,
            categorical_feature, pandas_categorical)


def _json_default_numpy(obj):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError("Cannot serialize %s in pandas_categorical"
                    % type(obj).__name__)


def _dump_pandas_categorical(pandas_categorical) -> str:
    return json.dumps(pandas_categorical, default=_json_default_numpy)


def _parse_pandas_categorical(model_str: str):
    """The list a model text's trailing ``pandas_categorical:`` line holds
    (python-package basic.py:283-291), or None."""
    idx = model_str.rfind("pandas_categorical:")
    if idx < 0:
        return None
    line = model_str[idx + len("pandas_categorical:"):].splitlines()[0]
    try:
        return json.loads(line)
    except ValueError:
        return None


def _categorical_indices(spec, names) -> List[int]:
    """Column indices of a categorical_feature spec: ints, or names
    resolved against the feature names (with auto names, Column_<i>)."""
    if spec in (None, "auto"):
        return []
    out = []
    for c in ([spec] if isinstance(spec, (int, str)) else spec):
        if not isinstance(c, str):
            out.append(int(c))
        elif names and c in names:
            out.append(names.index(c))
        elif (not names and c.startswith("Column_")
              and c[len("Column_"):].isdigit()):
            out.append(int(c[len("Column_"):]))
        else:
            raise LightGBMError("Unknown categorical column %r (known "
                                "feature names: %s)"
                                % (c, names or "auto Column_<i>"))
    return out


class Dataset:
    """Lazily constructed training dataset (python-package basic.py:546)."""

    def __init__(self, data, label=None, max_bin=None, reference=None,
                 weight=None, group=None, init_score=None, silent=False,
                 feature_name="auto", categorical_feature="auto",
                 params=None, free_raw_data=True):
        """data: a dense matrix, a pandas DataFrame (kept until
        construct(): its category columns are coded against the
        reference's categories), a scipy sparse matrix, or the path of a
        pre-binned directory (save_binned), of a binary dataset file
        (save_binary) or of a CSV/TSV/LibSVM text file (io/dataset.py
        TrainingData.from_file: the label column, header, ignored and
        categorical columns from ``params``, the .weight/.query/.init
        side files, and two-round streaming of large files or under
        ``use_two_round_loading``/``ooc_binned_dir``).  group: query
        sizes."""
        if isinstance(data, str) or _is_pandas_frame(data):
            self.data = data
        else:
            self.data = _matrix(data)
        self.label = None if label is None else np.asarray(_values(label))
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.silent = silent
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        if max_bin is not None:
            self.params.setdefault("max_bin", max_bin)
        self.free_raw_data = free_raw_data
        self.pandas_categorical = None
        self.used_indices: Optional[np.ndarray] = None
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
            if TrainingData.can_load_binned(self.data):
                self._handle = TrainingData.from_binned(self.data)
            elif TrainingData.can_load_binary(self.data):
                self._handle = TrainingData.load_binary(self.data)
            else:
                # the rows are kept for continued training; a file that
                # streams keeps them only when a model is to continue
                keep = (self._predictor is not None
                        or not TrainingData.wants_stream(self.data, cfg))
                self._handle = TrainingData.from_file(
                    self.data, cfg, reference=ref_td, keep_raw=keep)
            md = self._handle.metadata
            if self.label is not None:
                md.set_label(self.label)
            for name, value in (("weight", self.weight),
                                ("group", self.group),
                                ("init_score", self.init_score)):
                if value is not None:
                    md.set_field(name, value)
            self._fill_init_score()
            return self
        if _is_pandas_frame(self.data):
            ref_pc = (self.reference.pandas_categorical
                      if self.reference is not None else None)
            (self.data, self.feature_name, self.categorical_feature,
             self.pandas_categorical) = _data_from_pandas(
                self.data, self.feature_name, self.categorical_feature,
                ref_pc)
        names = (None if self.feature_name in (None, "auto")
                 else list(self.feature_name))
        cats = _categorical_indices(self.categorical_feature, names)
        if isinstance(self.data, SparseColumns):
            build, kw = TrainingData.from_csc, {}
        else:
            build, kw = TrainingData.from_matrix, {"keep_raw": True}
        self._handle = build(
            self.data, label=self.label, config=cfg, weights=self.weight,
            init_score=self.init_score, categorical_feature=cats,
            feature_names=names, reference=ref_td, group=self.group, **kw)
        self._fill_init_score()
        return self

    # rows a chunk of bin_rows (float64, 8 bytes a column) takes
    _BIN_ROWS = 65536

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
        data, on bounded dense row chunks; a dataset that keeps only its
        bins (a pre-binned directory, where the JAX package sets no init
        score) on the values its bins stand for
        (``TrainingData.bin_rows``), in chunks of _BIN_ROWS."""
        if self._predictor is None:
            return
        handle = self._handle
        if handle.raw_data is not None:
            raw = self._predictor.predict_raw_for_init(handle.raw_data)
        elif isinstance(self.data, SparseColumns):
            raw = np.concatenate(
                [self._predictor.predict_raw_for_init(block)
                 for _, block in iter_dense_row_chunks(self.data)])
        elif handle.bin_rows(0, 1) is not None:
            raw = np.concatenate(
                [self._predictor.predict_raw_for_init(
                    handle.bin_rows(lo, lo + self._BIN_ROWS))
                 for lo in range(0, handle.num_data, self._BIN_ROWS)])
        else:
            raise LightGBMError("continued training needs the raw rows of "
                                "the training data")
        handle.metadata.set_init_score(raw.T.reshape(-1))

    def create_valid(self, data, label=None, weight=None, group=None,
                     init_score=None, silent=False,
                     params=None) -> "Dataset":
        """Validation Dataset binned with this one's mappers."""
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score, silent=silent,
                       params=params or self.params,
                       free_raw_data=self.free_raw_data)

    def set_reference(self, reference: "Dataset") -> "Dataset":
        if self._handle is not None and reference is not self.reference:
            raise LightGBMError("Cannot set reference after the Dataset "
                                "was constructed")
        self.reference = reference
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """A Dataset of the rows ``used_indices``, binned with this one's
        mappers: the rows of the binned matrix (TrainingData.subset) for
        dense data, the rows of the sparse columns
        (SparseColumns.take_rows) binned anew for sparse data."""
        self.construct()
        used_indices = np.asarray(used_indices)
        label = None if self.label is None else self.label[used_indices]
        weight = (None if self.weight is None
                  else np.asarray(self.weight)[used_indices])
        params = params or self.params
        if isinstance(self.data, SparseColumns):
            sub = Dataset(self.data.take_rows(used_indices), label=label,
                          reference=self, weight=weight, params=params,
                          free_raw_data=self.free_raw_data)
        else:
            handle = self._handle.subset(used_indices)
            # the rows, where kept; a binary file's Dataset keeps none,
            # and its subset only ever uses the handle
            sub = Dataset(handle.raw_data if handle.raw_data is not None
                          else self.data, label=label, reference=self,
                          weight=weight, params=params,
                          free_raw_data=self.free_raw_data)
            sub._handle = handle
        sub.used_indices = used_indices
        return sub

    # ------------------------------------------------------------- metadata
    def set_label(self, label) -> "Dataset":
        """Set the target vector."""
        self.label = None if label is None else np.asarray(_values(label))
        if self._handle is not None:
            self._handle.metadata.set_label(self.label)
        return self

    def get_label(self):
        """The target vector, or None before it is set."""
        if (self._handle is not None
                and self._handle.metadata.label is not None):
            return np.asarray(self._handle.metadata.label)
        return self.label

    def set_weight(self, weight) -> "Dataset":
        """Set the row weights."""
        self.weight = weight
        if self._handle is not None:
            self._handle.metadata.set_weights(weight)
        return self

    def get_weight(self):
        """The row weights, or None."""
        if (self._handle is not None
                and self._handle.metadata.weights is not None):
            return np.asarray(self._handle.metadata.weights)
        return self.weight

    def set_group(self, group) -> "Dataset":
        """Set the query sizes (ranking)."""
        self.group = group
        if self._handle is not None:
            self._handle.metadata.set_query_counts(group)
        return self

    def get_group(self):
        """The query sizes, or None."""
        if (self._handle is not None
                and self._handle.metadata.query_boundaries is not None):
            return np.diff(self._handle.metadata.query_boundaries)
        return self.group

    def set_init_score(self, init_score) -> "Dataset":
        """Set the initial scores every prediction starts from."""
        self.init_score = init_score
        if self._handle is not None:
            self._handle.metadata.set_init_score(init_score)
        return self

    def get_init_score(self):
        """The initial scores, or None."""
        if self._handle is not None:
            return self._handle.metadata.init_score
        return self.init_score

    def set_field(self, field_name: str, data) -> None:
        """Set a metadata field by name (label, weight, group or query,
        init_score)."""
        self.construct()
        self._handle.metadata.set_field(field_name, data)

    def get_field(self, field_name: str):
        """A metadata field by name (group: the query boundaries)."""
        self.construct()
        return self._handle.metadata.get_field(field_name)

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """Set the categorical columns (indices or names); a constructed
        Dataset keeps its binning, with a warning."""
        if (self._handle is not None
                and categorical_feature != self.categorical_feature):
            Log.warning("categorical_feature in Dataset is overridden; new "
                        "categorical_feature is %s", str(categorical_feature))
        self.categorical_feature = categorical_feature
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """Set the feature names (a list of str)."""
        self.feature_name = feature_name
        if feature_name not in (None, "auto") and self._handle is not None:
            self._handle.feature_names = list(feature_name)
        return self

    def get_feature_name(self) -> List[str]:
        """The feature names (auto names resolved at construction)."""
        self.construct()
        return list(self._handle.feature_names)

    def _update_params(self, params: Optional[dict]) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    # ------------------------------------------------------------------ info
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

    def save_binary(self, filename: str) -> "Dataset":
        """Write the binned dataset as a binary file, which
        ``Dataset(filename)`` (of either package) loads without binning."""
        self.construct()._handle.save_binary(filename)
        return self

    def save_binned(self, path: str) -> "Dataset":
        """Write the binned dataset as a pre-binned directory
        (io/binned_format.py), which ``Dataset(path)``,
        ``Dataset.from_binned`` and ``train(params, path)`` (of either
        package) open without binning."""
        self.construct()._handle.save_binned(path)
        return self

    @classmethod
    def from_binned(cls, path: str, params=None, comm=None,
                    row_range=None) -> "Dataset":
        """Open a pre-binned directory (save_binned, or the streaming
        ``ooc_binned_dir`` ingest).  Its shards stay mmap-backed and
        page to the card when a booster trains on it; ``row_range``
        opens only those rows, and a ``comm`` of more than one rank
        (parallel/comm.py) this rank's share of them, for the
        distributed learners (TrainingData.from_binned)."""
        ds = cls(path, params=params)
        ds._handle = TrainingData.from_binned(path, comm=comm,
                                              row_range=row_range)
        return ds


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
                 model_str: Optional[str] = None, silent: bool = False,
                 device="cuda"):
        self.params = dict(params or {})
        self._valid_sets: List[Optional[Dataset]] = []
        self.name_valid_sets: List[str] = []
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.pandas_categorical = None
        self._attr: Dict[str, str] = {}
        self._train_data_name = "training"
        self._train_set = train_set
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                "met %s" % type(train_set).__name__)
            self.device = resolve_device(device)
            cfg = Config(self.params)
            handle = train_set._update_params(self.params).construct()._handle
            self.pandas_categorical = train_set.pandas_categorical
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
            self._load_from_string(model_str, device)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file to create booster instance")

    def _load_from_string(self, model_str: str, device) -> None:
        self.device = resolve_device(device)
        self._cfg = Config(self.params)
        self._gbdt = GBDT(self._cfg, self.device)
        self._gbdt.load_model_from_string(model_str)
        self.pandas_categorical = _parse_pandas_categorical(model_str)

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

    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when it grew no split (its trees
        are then dropped).  With ``fobj(preds, train_data) -> (grad,
        hess)`` the gradients are the caller's, at the raw training
        scores (python-package basic.py:1331-1412): one copy of the
        scores to the host and one of the gradients to the device, on the
        staged chain.  As in the JAX package, the booster's own
        early_stopping_round is not evaluated here (train() runs the
        early_stopping callback instead)."""
        if train_set is not None and train_set is not self._train_set:
            raise LightGBMError("Resetting train set inside update is not "
                                "supported yet")
        if fobj is None:
            return self._gbdt.train_one_iter(None, None, False)
        if self._train_set is None:
            raise LightGBMError("Custom objective needs the train Dataset, "
                                "but it was released by free_dataset()")
        grad, hess = fobj(self._inner_predict(0), self._train_set)
        return self._boost(grad, hess)

    def _boost(self, grad, hess) -> bool:
        grad = np.asarray(grad, dtype=np.float32)
        hess = np.asarray(hess, dtype=np.float32)
        if len(grad) != len(hess):
            raise ValueError("Lengths of gradient(%d) and hessian(%d) "
                             "don't match" % (len(grad), len(hess)))
        return self._gbdt.train_one_iter(grad, hess, False)

    def _inner_predict(self, data_idx: int) -> np.ndarray:
        """The raw scores of the training (0) or a validation set, as
        fobj and feval get them: (N,), or K * N class-major."""
        g = self._gbdt
        raw = g.train_score if data_idx == 0 else g.valid_score_host(
            data_idx - 1)
        return raw[0] if raw.shape[0] == 1 else raw.reshape(-1)

    def set_train_data(self, train_set: Dataset) -> "Booster":
        """Swap the training dataset and keep the model
        (LGBM_BoosterResetTrainingData, GBDT::ResetTrainingData,
        gbdt.cpp:64-208): the scores on the new rows start from the
        trees' f64 host sums on its raw rows."""
        cfg = Config(dict(self.params))
        handle = train_set._update_params(self.params).construct()._handle
        objective = create_objective(cfg.objective, cfg)
        if objective is not None:
            objective.init(handle.metadata, handle.num_data, self.device)
        self._gbdt.reset_training_data(cfg, handle, objective,
                                       self._make_metrics(cfg, handle))
        self._train_set = train_set
        self._cfg = cfg
        return self

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

    # ------------------------------------------------------- attributes
    def attr(self, key: str):
        """A user attribute (basic.py:1769), or None when unset."""
        return self._attr.get(key)

    def set_attr(self, **kwargs) -> "Booster":
        """Set string attributes; a None value deletes the key
        (basic.py:1785-1800; other values raise)."""
        for key, value in kwargs.items():
            if value is None:
                self._attr.pop(key, None)
            elif not isinstance(value, str):
                raise ValueError("Set attr only accepts strings")
            else:
                self._attr[key] = value
        return self

    def set_train_data_name(self, name: str) -> "Booster":
        """The training set's name in the evaluation output."""
        self._train_data_name = name
        return self

    def free_dataset(self) -> "Booster":
        """Let go of the Python Dataset objects (basic.py:1281-1283).  The
        binned data stays with the booster, so training, prediction and
        the built-in metrics go on; fobj and feval, which take the
        Dataset, then raise.  The validation slots stay (as None), so a
        later add_valid keeps the evaluation indices."""
        self._train_set = None
        self._valid_sets = [None] * len(self._valid_sets)
        return self

    # ----------------------------------------------------------------- eval
    def eval_train(self, feval=None) -> List[tuple]:
        """(data name, metric, value, higher is better) on the training
        data, the built-in metrics then feval's."""
        return self._eval(0, self._train_data_name, feval)

    def eval_valid(self, feval=None) -> List[tuple]:
        """As eval_train, on every validation set."""
        out = []
        for i, name in enumerate(self.name_valid_sets):
            out.extend(self._eval(i + 1, name, feval))
        return out

    def eval(self, data: Dataset, name: str, feval=None) -> List[tuple]:
        """As eval_train, on the training set or a validation set."""
        if data is self._train_set:
            return self._eval(0, name, feval)
        for i, vs in enumerate(self._valid_sets):
            if data is vs:
                return self._eval(i + 1, name, feval)
        raise LightGBMError("Data should be train set or a validation set")

    def _eval(self, data_idx: int, name: str, feval=None) -> List[tuple]:
        """feval(preds, data) -> (name, value, higher is better) or a list
        of them, given the raw scores (JAX basic.py:713-750)."""
        g = self._gbdt
        metrics = (g.training_metrics if data_idx == 0
                   else g.valid_metrics[data_idx - 1])
        higher = [m.factor_to_bigger_better > 0
                  for m in metrics for _ in m.get_names()]
        out = [(name, mname, s, hb) for mname, s, hb in
               zip(g.eval_names(data_idx), g.get_eval_at(data_idx), higher)]
        if feval is not None:
            ds = (self._train_set if data_idx == 0
                  else self._valid_sets[data_idx - 1])
            if ds is None:
                raise LightGBMError("Custom eval needs the Dataset, but it "
                                    "was released by free_dataset()")
            ret = feval(self._inner_predict(data_idx), ds)
            for fname, val, hb in (ret if isinstance(ret, list) else [ret]):
                out.append((name, fname, val, hb))
        return out

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
        elif _is_pandas_frame(data):
            data = _data_from_pandas(data, None, None,
                                     self.pandas_categorical)[0]
        out, rows = self._predict_data(data, num_iteration, raw_score,
                                       pred_leaf, pred_contrib,
                                       pred_early_stop, pred_early_stop_freq,
                                       pred_early_stop_margin)
        observe_predict(rows, time.perf_counter() - t0)
        return out

    def _predict_drift(self):
        """The booster's DriftMonitor (obs/drift.py) for the synchronous
        predict path, made on first use (the ServingPredictor builds its
        own): with ``obs_drift_every`` > 0, an enabled observer and a
        fingerprinted model; ``False`` caches 'checked, unavailable'."""
        mon = self.__dict__.get("_drift_monitor")
        if mon is not None:
            return mon or None
        cfg = self._cfg
        obs = self._gbdt._obs
        mon = False
        if int(cfg.obs_drift_every or 0) > 0 and obs.enabled:
            fp = self._gbdt.drift_fingerprint()
            if fp is not None:
                from .obs.drift import DriftMonitor
                m = DriftMonitor(
                    fp, observer=obs,
                    mode=(cfg.obs_health if cfg.obs_health != "off"
                          else "warn"),
                    every_rows=cfg.obs_drift_every,
                    window_rows=cfg.obs_drift_window,
                    psi_threshold=cfg.obs_drift_psi,
                    topk=cfg.obs_drift_topk,
                    min_labels=cfg.obs_drift_min_labels)
                if m.enabled:
                    mon = m
        self._drift_monitor = mon
        return mon or None

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

        drift = self._predict_drift()

        def run(block):
            if drift is not None:
                drift.observe_features(block)
            if early_predictor is not None:
                out = early_predictor._predict_impl(block)
            elif pred_contrib:
                return self._gbdt.pred_contrib(block,
                                               num_iteration=num_iteration)
            else:
                out = self._gbdt.predict(block,
                                         num_iteration=num_iteration,
                                         raw_score=raw_score,
                                         pred_leaf=pred_leaf)
            if drift is not None and not pred_leaf:
                drift.observe_scores(out, raw=raw_score)
            return out

        mat = _matrix(data)
        if isinstance(mat, SparseColumns):
            outs = [run(block) for _, block in iter_dense_row_chunks(mat)]
            return ((np.concatenate(outs) if outs
                     else np.zeros(0, dtype=np.float64)), mat.num_row)
        if mat.ndim == 1:
            mat = mat.reshape(1, -1)
        return run(mat), mat.shape[0]

    def set_predict_devices(self, devices=None) -> "Booster":
        """Shard the rows of device bulk prediction over ``devices`` (a
        list such as ["cuda:0", "cuda:1"]; entries may repeat a device),
        the trees replicated to each, as the JAX package predicts over
        its local devices (ops/predict.py ranked_predict_sharded: the
        scores are one device's bits).  None: the booster's device."""
        self._gbdt.predict_devices = list(devices) if devices else None
        return self

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
        it (build another).  The booster's run observer (``observer``
        overrides it) receives the programs' captures, the sampled
        batches and requests, the SLO snapshots and the close-time
        ``serve_summary``; with ``obs_http_port`` >= 0 it also serves the
        live plane (obs/live.py), and with ``obs_drift_every`` > 0 and a
        fingerprinted model a DriftMonitor watches the traffic
        (obs/drift.py; overrides ``drift_every``, ``drift_window``,
        ``drift_psi``, ``drift_topk``, ``drift_min_labels``)."""
        from .serve import ServingPredictor
        cfg = self._cfg
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
              "drift_every": cfg.obs_drift_every,
              "drift_window": cfg.obs_drift_window,
              "drift_psi": cfg.obs_drift_psi,
              "drift_topk": cfg.obs_drift_topk,
              "drift_min_labels": cfg.obs_drift_min_labels,
              "observer": self._gbdt._obs}
        kw.update(overrides)
        # the live plane: a serving process exposes the endpoints a
        # training run does; the SLO headline and queue depth ride in
        # through the observer's flight providers
        obs = kw.get("observer")
        if (int(cfg.obs_http_port) >= 0 and obs is not None
                and obs.enabled):
            obs.ensure_live_server(int(cfg.obs_http_port),
                                   str(cfg.obs_http_addr or "127.0.0.1"))
        return ServingPredictor(self._gbdt, num_iteration=num_iteration,
                                **kw)

    # ------------------------------------------------------------- model io
    def model_to_string(self, num_iteration: int = -1) -> str:
        """The model text, then the ``pandas_categorical:`` line (the
        training frame's category lists, or null), as the JAX package
        writes it."""
        return (self._gbdt.save_model_to_string(num_iteration)
                + "\npandas_categorical:%s\n"
                % _dump_pandas_categorical(self.pandas_categorical))

    def save_model(self, filename: str,
                   num_iteration: int = -1) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration))
        return self

    def dump_model(self, num_iteration: int = -1) -> dict:
        """The model as a JSON-compatible dict (GBDT::DumpModel)."""
        return json.loads(self._gbdt.dump_model(num_iteration))

    def feature_importance(self, importance_type: str = "split"):
        return self._gbdt.feature_importance(importance_type)

    def importance_history(self, importance_type: str = "split") -> list:
        """The importance trajectory of the run's telemetry: the
        ``importance`` events written every ``obs_importance_every``
        iterations, as ``[{"it", "importance": {feature_index: value}}]``;
        empty when importance tracking was off."""
        from .obs.model import importance_history
        return importance_history(self.telemetry(), importance_type)

    def telemetry(self) -> list:
        """A copy of the run observer's in-memory event timeline (obs/):
        empty unless an ``obs_*`` param enabled telemetry."""
        return list(self._gbdt._obs.timeline)

    def finalize_telemetry(self, status: str = "ok") -> None:
        """Emit the run_end event and close the timeline's writer; train
        and cv call it after the boosting loop (``status="aborted"`` when
        it raised).  Idempotent, and a no-op without telemetry."""
        self._gbdt._obs.close(status=status)

    def feature_name(self) -> List[str]:
        return list(self._gbdt.feature_names)

    def num_feature(self) -> int:
        return self._gbdt.max_feature_idx + 1

    # ---------------------------------------------------------- chip facts
    def grow_stats(self) -> list:
        """Per-tree growth facts of this booster's training (waves, host
        reads while growing, depth, leaves), oldest first."""
        return list(self._gbdt.grow_stats)

    # ------------------------------------------------------------- pickling
    def __getstate__(self):
        """The model text (JAX basic.py:985-1004) and the device type: an
        unpickled booster predicts on the same kind of device, and a
        CUDA pickle raises where there is no card."""
        return {"params": self.params,
                "model_str": self.model_to_string(),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score,
                "attr": dict(self._attr),
                "train_data_name": self._train_data_name,
                "device": self.device.type}

    def __setstate__(self, state):
        self.params = state["params"]
        self.best_iteration = state.get("best_iteration", -1)
        self.best_score = state.get("best_score", {})
        self._attr = dict(state.get("attr", {}))
        self._train_data_name = state.get("train_data_name", "training")
        self._train_set = None
        self._valid_sets = []
        self.name_valid_sets = []
        self._load_from_string(state["model_str"],
                               state.get("device", "cuda"))

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, memo):
        out = Booster(params=dict(self.params),
                      model_str=self.model_to_string(),
                      device=self.device)
        out.best_iteration = self.best_iteration
        out._attr = dict(self._attr)
        return out
