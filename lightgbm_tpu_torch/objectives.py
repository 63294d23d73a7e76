"""Objective functions — gradients and hessians in f32 on the device.

Ported from the JAX package's ``objectives.py``: the regression losses
L2, L1, Huber, Fair and Poisson (regression_objective.hpp),
``BinaryLogloss`` (binary_objective.hpp:13-154, with is_unbalance and
scale_pos_weight) and the multiclass softmax and one-vs-all objectives
(multiclass_objective.hpp).  A multiclass score is (num_class, num_data),
the reference's column-major flat layout (``score[k * num_data + i]``);
its gradients come back flat, as the JAX package returns them.
Lambdarank is a later slice; naming it raises.
"""
from __future__ import annotations

import math
from typing import Optional

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
}
# objectives of the JAX package that this port does not have yet
_NOT_PORTED = ("lambdarank",)


def create_objective(name: str,
                     config: Config) -> Optional[ObjectiveFunction]:
    """ObjectiveFunction::CreateObjectiveFunction
    (objective_function.cpp:9-35)."""
    if name in ("none", "null", "custom", "na"):
        return None
    if name in _NOT_PORTED:
        Log.fatal("objective=%s is not in lightgbm_tpu_torch yet (it has "
                  "%s)", name, ", ".join(sorted(_OBJECTIVES)))
    cls = _OBJECTIVES.get(name)
    if cls is None:
        Log.fatal("Unknown objective type name: %s", name)
    if cls is RegressionL2loss:
        return cls()
    return cls(config)


def load_objective_from_string(s: str) -> Optional[ObjectiveFunction]:
    """Round-trip from model files (objective_function.cpp:37-56); an
    objective this port lacks loads as None (raw scores)."""
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
