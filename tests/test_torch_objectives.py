"""The port's objectives and metrics compute what the JAX package's do.

* gradients and hessians of L1, Huber, Fair, Poisson, softmax (K = 3)
  and OVA (K = 3), with and without row weights, to rtol 1e-6 and an
  atol of 1e-6 x the largest magnitude (f32 on both sides: torch's and
  XLA's exp may differ by an ulp, which the logloss hessian's
  |r| (sigmoid - |r|) amplifies where |r| nears sigmoid);
* each objective's ``to_string`` is the JAX package's and loads back
  through ``load_objective_from_string`` to the same objective;
* the new metrics (L1, Huber, Fair, Poisson, multi_logloss,
  multi_error) give the JAX package's values to rtol 1e-9 (host
  float64 on both sides), with and without weights;
* lambdarank, NDCG and MAP without query information raise, naming the
  objective or metric (tests/test_torch_lambdarank.py holds them with it).
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu import metrics as jmetrics
from lightgbm_tpu import objectives as jobj
from lightgbm_tpu.io.metadata import Metadata as JMetadata
from lightgbm_tpu.utils.config import Config as JConfig
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch import metrics as tmetrics
from lightgbm_tpu_torch import objectives as tobj
from lightgbm_tpu_torch.io.metadata import Metadata as TMetadata
from lightgbm_tpu_torch.utils.config import Config as TConfig
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

N = 600
K = 3
PARAMS = {"huber_delta": 0.7, "fair_c": 0.9, "gaussian_eta": 1.3,
          "poisson_max_delta_step": 0.6, "sigmoid": 1.2}
OBJECTIVES = ["regression_l1", "huber", "fair", "poisson", "multiclass",
              "multiclassova"]


def _labels(name, rng):
    if name.startswith("multiclass"):
        return rng.integers(0, K, size=N).astype(np.float64)
    if name == "poisson":
        return rng.poisson(1.5, size=N).astype(np.float64)
    return rng.normal(size=N) * 2.0


def _params(objective):
    more = {"num_class": K} if objective.startswith("multiclass") else {}
    return dict(PARAMS, objective=objective, **more)


def _metadata(cls, label, weights):
    md = cls(N)
    md.set_label(label)
    md.set_weights(weights)
    return md


def _pair(name, weighted, seed=3):
    """(jax objective, port objective, score (K or 1, N) f32) on the same
    labels, weights and params."""
    rng = np.random.default_rng(seed)
    label = _labels(name, rng)
    weights = rng.uniform(0.2, 2.0, size=N) if weighted else None
    k = K if name.startswith("multiclass") else 1
    score = (rng.normal(size=(k, N)) * 1.5).astype(np.float32)
    params = _params(name)
    jo = jobj.create_objective(name, JConfig(dict(params)))
    to = tobj.create_objective(name, TConfig(dict(params)))
    jo.init(_metadata(JMetadata, label, weights), N)
    to.init(_metadata(TMetadata, label, weights), N, torch.device("cpu"))
    return jo, to, score


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", OBJECTIVES)
def test_gradients_match_the_jax_package(name, weighted):
    jo, to, score = _pair(name, weighted)
    flat = score.reshape(-1) if score.shape[0] > 1 else score[0]
    gj, hj = (np.asarray(a) for a in jo.get_gradients(flat))
    gt, ht = to.get_gradients(torch.from_numpy(flat.copy()))
    assert gt.dtype == ht.dtype == torch.float32
    assert gt.shape == ht.shape == (flat.size,)
    for got, want in ((gt.numpy(), gj), (ht.numpy(), hj)):
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert to.num_tree_per_iteration() == jo.num_tree_per_iteration()
    assert to.boost_from_average() == jo.boost_from_average()
    assert to.skip_empty_class() == jo.skip_empty_class()


@pytest.mark.parametrize("name", OBJECTIVES + ["regression", "binary"])
def test_to_string_round_trips(name):
    params = _params(name)
    jo = jobj.create_objective(name, JConfig(dict(params)))
    to = tobj.create_objective(name, TConfig(dict(params)))
    text = to.to_string()
    assert text == jo.to_string()
    back = tobj.load_objective_from_string(text)
    assert type(back) is type(to) and back.to_string() == text
    assert type(jobj.load_objective_from_string(text)).__name__ == \
        type(to).__name__
    raw = np.random.default_rng(1).normal(size=(5, K))
    x = raw if name.startswith("multiclass") else raw[:, 0]
    np.testing.assert_allclose(back.convert_output(x),
                               jo.convert_output(x), rtol=1e-12)


def test_ova_positive_rows_are_one_class_each():
    """OVA's binary objective of class i counts the rows labelled i as
    positive (_make_is_pos), as the JAX package's does."""
    jo, to, _ = _pair("multiclassova", False)
    for i in range(K):
        np.testing.assert_array_equal(to.binary[i].sign.numpy(),
                                      np.asarray(jo.binary[i].sign))


METRICS = [("l1", "regression_l1"), ("huber", "huber"), ("fair", "fair"),
           ("poisson", "poisson"), ("multi_logloss", "multiclass"),
           ("multi_error", "multiclass"), ("multi_logloss", "multiclassova"),
           ("multi_error", "multiclassova")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric,objective", METRICS)
def test_metrics_match_the_jax_package(metric, objective, weighted):
    rng = np.random.default_rng(7)
    label = _labels(objective, rng)
    weights = rng.uniform(0.2, 2.0, size=N) if weighted else None
    k = K if objective.startswith("multiclass") else 1
    score = rng.normal(size=(k, N)) * 1.5
    if objective == "poisson":
        score = np.abs(score)
    params = _params(objective)
    jc, tc = JConfig(dict(params)), TConfig(dict(params))
    jm, tm = (jmetrics.create_metric(metric, jc),
              tmetrics.create_metric(metric, tc))
    assert type(tm).__name__ == type(jm).__name__
    assert tm.factor_to_bigger_better == jm.factor_to_bigger_better
    assert tm.get_names() == jm.get_names()
    jm.init(_metadata(JMetadata, label, weights), N)
    tm.init(_metadata(TMetadata, label, weights), N)
    jo = jobj.create_objective(objective, jc)
    to = tobj.create_objective(objective, tc)
    np.testing.assert_allclose(tm.eval(score, to), jm.eval(score, jo),
                               rtol=1e-9)


@pytest.mark.parametrize("params,match", [
    ({"objective": "lambdarank"}, "objective=lambdarank"),
    ({"objective": "binary", "metric": "map"}, "metric=map"),
    ({"objective": "no_such_objective"}, "Unknown objective type name"),
])
def test_what_the_port_lacks_raises(params, match):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(lgb.LightGBMError, match=match):
        lgb.train(dict(params, verbose=-1), lgb.Dataset(X, label=y), 1,
                  device="cpu")
