"""scikit-learn API wrappers: the JAX package's ``sklearn.py``
(python-package sklearn.py:15-623).

LGBMModel, LGBMRegressor, LGBMClassifier (label encoding,
``predict_proba``, ``classes_``) and LGBMRanker with the same constructor
surface, plus ``device`` ("cuda" unless the caller asks for "cpu", carried
by ``get_params``, ``clone`` and ``GridSearchCV``); custom objective and
metric wrapping (grad/hess signatures, sklearn.py:15-121), eval sets,
early stopping, and pickling through the booster's model text.
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, Dataset
from .engine import train
from .utils.log import LightGBMError

try:
    from sklearn.base import BaseEstimator, ClassifierMixin, RegressorMixin
    from sklearn.preprocessing import LabelEncoder
    _SKLEARN_INSTALLED = True
except ImportError:  # pragma: no cover - sklearn is in the image
    _SKLEARN_INSTALLED = False

    class BaseEstimator:  # type: ignore
        pass

    class ClassifierMixin:  # type: ignore
        pass

    class RegressorMixin:  # type: ignore
        pass


def _objective_function_wrapper(func: Callable):
    """Wrap sklearn-style objective fun(y_true, y_pred [,group]) -> (g,h)
    into the engine's fobj(preds, dataset) (sklearn.py:15-76)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            grad, hess = func(labels, preds)
        elif argc == 3:
            grad, hess = func(labels, preds, dataset.get_group())
        else:
            raise TypeError("Self-defined objective should have 2 or 3 "
                            "arguments")
        return grad, hess
    return inner


def _eval_function_wrapper(func: Callable):
    """Wrap fun(y_true, y_pred [,weight [,group]]) -> (name, val,
    is_higher_better)
    (sklearn.py:78-121)."""

    def inner(preds, dataset):
        labels = dataset.get_label()
        argc = func.__code__.co_argcount
        if argc == 2:
            return func(labels, preds)
        if argc == 3:
            return func(labels, preds, dataset.get_weight())
        if argc == 4:
            return func(labels, preds, dataset.get_weight(),
                        dataset.get_group())
        raise TypeError("Self-defined eval function should have 2, 3, or 4 "
                        "arguments")
    return inner


class LGBMModel(BaseEstimator):
    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, max_bin: int = 255,
                 subsample_for_bin: int = 200000,
                 objective: Optional[str] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 1, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: int = 0, n_jobs: int = -1, silent: bool = True,
                 device: str = "cuda", **kwargs):
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.max_bin = max_bin
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.silent = silent
        self.device = device
        self._other_params = dict(kwargs)
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._best_iteration = -1
        self._objective_default = "regression"

    # sklearn clone support
    def get_params(self, deep=True):
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "max_bin", "subsample_for_bin", "objective",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "silent", "device")}
        params.update(self._other_params)
        return params

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
            if k not in self.get_params():
                self._other_params[k] = v
        return self

    def _make_params(self) -> Dict[str, Any]:
        obj = self.objective
        fobj = None
        if callable(obj):
            fobj = _objective_function_wrapper(obj)
            obj = "none"
        elif obj is None:
            obj = self._objective_default
        params = {
            "boosting_type": self.boosting_type,
            "objective": obj,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "max_bin": self.max_bin,
            "subsample_for_bin": self.subsample_for_bin,
            "min_split_gain": self.min_split_gain,
            "min_child_weight": self.min_child_weight,
            "min_child_samples": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "seed": self.random_state,
            "verbose": -1 if self.silent else 1,
        }
        params.update(self._other_params)
        return params, fobj

    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, verbose=False, feature_name="auto",
            categorical_feature="auto", callbacks=None):
        """Fit the estimator (scikit-learn contract)."""
        params, fobj = self._make_params()
        feval = (_eval_function_wrapper(eval_metric) if callable(eval_metric)
                 else None)
        if isinstance(eval_metric, (str, list)):
            params["metric"] = eval_metric

        train_set = Dataset(X, label=y, weight=sample_weight, group=group,
                            init_score=init_score, params=params,
                            free_raw_data=False)
        valid_sets: List[Dataset] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                if vx is X and vy is y:
                    valid_sets.append(train_set)
                    continue
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(train_set.create_valid(
                    vx, vy, weight=vw, group=vg, init_score=vi))
        self._evals_result = {}
        self._Booster = train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None, valid_names=eval_names,
            fobj=fobj, feval=feval,
            early_stopping_rounds=early_stopping_rounds,
            evals_result=self._evals_result, verbose_eval=verbose,
            feature_name=feature_name, categorical_feature=categorical_feature,
            callbacks=callbacks, device=self.device)
        self._best_iteration = self._Booster.best_iteration
        self._n_features = (X.shape[1] if hasattr(X, "shape")
                            else np.asarray(X).shape[1])
        return self

    def predict(self, X, raw_score=False, num_iteration=-1):
        """Predict targets for X."""
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted, call fit before "
                                "predict")
        return self._Booster.predict(
            X, raw_score=raw_score,
            num_iteration=self._resolve_num_iteration(num_iteration))

    @property
    def n_features_(self):
        return self._n_features

    @property
    def best_iteration_(self):
        return self._best_iteration

    @property
    def booster_(self):
        return self._Booster

    def _resolve_num_iteration(self, num_iteration: int) -> int:
        """<=0 falls back to the early-stopped best iteration (shared by
        predict/predict_proba/apply so they always agree)."""
        if num_iteration <= 0 and self._best_iteration > 0:
            return self._best_iteration
        return num_iteration

    def apply(self, X, num_iteration=-1):
        """Per-row leaf indices of every tree (sklearn.py apply); uses
        the early-stopped best iteration like predict()."""
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted")
        return self._Booster.predict(
            X, num_iteration=self._resolve_num_iteration(num_iteration),
            pred_leaf=True)

    @property
    def evals_result_(self):
        return self._evals_result

    @property
    def feature_importances_(self):
        if self._Booster is None:
            raise LightGBMError("Estimator not fitted")
        return self._Booster.feature_importance()

    # deprecated method-form aliases kept for drop-in compatibility
    # (sklearn.py:457-463)
    def booster(self):
        """Deprecated alias of :attr:`booster_` (emits DeprecationWarning)."""
        warnings.warn("Use attribute booster_ instead.",
                      DeprecationWarning)
        return self.booster_

    def feature_importance(self):
        """Deprecated alias of :attr:`feature_importances_` (emits
        DeprecationWarning)."""
        warnings.warn("Use attribute feature_importances_ instead.",
                      DeprecationWarning)
        return self.feature_importances_


class LGBMRegressor(LGBMModel, RegressorMixin):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._objective_default = "regression"


class LGBMClassifier(LGBMModel, ClassifierMixin):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._objective_default = "binary"

    def fit(self, X, y, **kwargs):
        """Fit the classifier; encodes labels and picks the objective."""
        self._le = LabelEncoder().fit(y) if _SKLEARN_INSTALLED else None
        if self._le is not None:
            y_enc = self._le.transform(y)
            self._classes = self._le.classes_
        else:
            self._classes = np.unique(y)
            y_enc = np.searchsorted(self._classes, y)
        self._n_classes = len(self._classes)
        if self._n_classes > 2:
            if not callable(self.objective):
                self.objective = self.objective or "multiclass"
            self._other_params.setdefault("num_class", self._n_classes)
            self._objective_default = "multiclass"
        else:
            self._objective_default = "binary"
        return super().fit(X, y_enc.astype(np.float64), **kwargs)

    def predict(self, X, raw_score=False, num_iteration=-1):
        probs = self.predict_proba(X, raw_score=raw_score,
                                   num_iteration=num_iteration)
        if raw_score:
            return probs
        if probs.ndim > 1:
            idx = np.argmax(probs, axis=1)
        else:
            idx = (probs > 0.5).astype(int)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, num_iteration=-1):
        """Class probability estimates for X."""
        out = super().predict(X, raw_score=raw_score,
                              num_iteration=num_iteration)
        if raw_score:
            return out
        if out.ndim == 1:
            return np.stack([1.0 - out, out], axis=1) if not raw_score else out
        return out

    @property
    def classes_(self):
        return self._classes

    @property
    def n_classes_(self):
        return self._n_classes


class LGBMRanker(LGBMModel):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._objective_default = "lambdarank"

    def fit(self, X, y, group=None, **kwargs):
        """Fit the ranker; group gives query sizes."""
        if group is None:
            raise ValueError("Should set group for ranking task")
        return super().fit(X, y, group=group, **kwargs)
