"""The port takes the JAX package's params: the same keys, aliases, typed
values and unknown-key errors, and a clear error for every engine knob
whose engine the port does not have yet."""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu.utils import config as jcfg
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.utils import config as tcfg
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def test_keys_aliases_and_values_match_the_jax_package():
    assert tcfg.ALIAS_TABLE == jcfg.ALIAS_TABLE
    assert tcfg.PARAMETER_SET == jcfg.PARAMETER_SET
    params = {"num_leaf": 31, "shrinkage_rate": 0.05, "min_data": 5,
              "sub_feature": 0.8, "boost": "gbdt", "max_bin": 15,
              "objective": "binary", "tpu_wave_width": 8}
    assert (tcfg.key_alias_transform(dict(params))
            == jcfg.key_alias_transform(dict(params)))
    assert vars(tcfg.Config(params)) == vars(jcfg.Config(params))
    for mod in (tcfg, jcfg):
        with pytest.raises(Exception, match="Unknown parameter: no_such"):
            mod.key_alias_transform({"no_such_key": 1}, raise_unknown=True)


@pytest.mark.parametrize("knob,value,name", [
    # data, voting and feature are ported (parallel/mesh.py); a learner
    # no package has is still refused by name
    ("tree_learner", "mesh", "tree learner"),
    # ported since, but this data has no queries: the error names them
    ("objective", "lambdarank", "objective=lambdarank"),
    ("metric", "ndcg", "metric=ndcg"),
])
def test_engines_the_port_lacks_raise(knob, value, name):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbose": -1, knob: value}
    with pytest.raises(lgb.LightGBMError, match=name):
        lgb.train(params, lgb.Dataset(X, label=y), 1, device="cpu")


@pytest.mark.parametrize("knob,value,attr,want", [
    ("tpu_wave_compact", True, "wave_compact", True),
    ("tpu_hist_precision", "bf16", "hist_hilo", False),
    # max_bin 255: a forced true that cannot pack warns and trains on
    # byte bins, as in the JAX package
    ("tpu_bin_pack", "true", "packed_cols", 0),
    # float64 histograms, split search and trees (the kernels' f64 form)
    ("tpu_use_dp", True, "dtype", torch.float64),
    # tpu_sparse alone: the coordinate sparse store (ops/sparse_store.py)
    ("tpu_sparse", True, "hist_mode", "sparse"),
])
def test_engine_knobs_the_port_now_takes(knob, value, attr, want, capsys):
    """Knobs whose kernels the port has since gained resolve as the JAX
    package resolves them instead of raising: compaction under wave
    growth on a transposed kernel, the single bf16 product, and 4-bit
    packing (with the JAX package's warning where a forced true cannot
    be honoured), and the coordinate sparse store under tpu_sparse
    alone."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbose": 1, "tpu_growth": "wave",
              knob: value}
    booster = lgb.train(params, lgb.Dataset(X, label=y), 1, device="cpu")
    assert getattr(booster._gbdt.learner, attr) == want
    if knob == "tpu_bin_pack":
        err = capsys.readouterr()
        assert "tpu_bin_pack=true ignored" in err.out + err.err


def test_unknown_wave_order_is_fatal():
    """tpu_wave_order takes auto, batched and exact (exact-order waves);
    any other value is fatal with the JAX package's message."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    y = (X[:, 0] > 0).astype(float)
    params = {"objective": "binary", "verbose": -1, "tpu_growth": "wave",
              "tpu_wave_order": "leafwise"}
    with pytest.raises(lgb.LightGBMError,
                       match="Unknown tpu_wave_order leafwise"):
        lgb.train(params, lgb.Dataset(X, label=y), 1, device="cpu")


def _train(params, rows=200):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(rows, 4))
    y = (X[:, 0] > 0).astype(float)
    return lgb.train(dict({"objective": "binary", "verbose": -1}, **params),
                     lgb.Dataset(X, label=y), 1, device="cpu")


@pytest.mark.parametrize("params,match", [
    ({"tpu_growth": "exact", "tpu_histogram_mode": "pallas_ct"},
     "requires tpu_growth=wave"),
    ({"tpu_growth": "exact", "tpu_histogram_mode": "pallas_t"},
     "requires tpu_growth=wave"),
    ({"tpu_growth": "exact", "tpu_sparse": True, "tpu_sparse_kernel": True},
     "requires wave growth"),
    ({"tpu_growth": "wave", "tpu_wave_width": 0}, "tpu_wave_width"),
])
def test_fatal_engine_combinations(params, match):
    with pytest.raises(lgb.LightGBMError, match=match):
        _train(params)


@pytest.mark.parametrize("params,growth,mode", [
    ({"tpu_growth": "exact"}, "exact", "pallas"),
    ({"tpu_histogram_mode": "pallas"}, "exact", "pallas"),
    ({"tpu_growth": "exact", "tpu_histogram_mode": "pallas"}, "exact",
     "pallas"),
    ({"tpu_growth": "wave", "tpu_histogram_mode": "pallas"}, "wave",
     "pallas"),
    ({}, "wave", "pallas_ct"),
    # a leftover bad wave width does not stop exact growth (the JAX
    # package checks it only under wave growth)
    ({"tpu_growth": "exact", "tpu_wave_width": 0}, "exact", "pallas"),
    # the XLA engines: wave growth under auto (the JAX package's choice
    # on its accelerator), exact growth when asked
    ({"tpu_histogram_mode": "onehot"}, "wave", "onehot"),
    ({"tpu_histogram_mode": "scatter"}, "wave", "scatter"),
    ({"tpu_growth": "exact", "tpu_histogram_mode": "onehot"}, "exact",
     "onehot"),
    ({"tpu_growth": "exact", "tpu_histogram_mode": "scatter"}, "exact",
     "scatter"),
])
def test_growth_and_histogram_mode_resolution(params, growth, mode):
    """The JAX package's resolution: auto growth is exact with 'pallas';
    exact growth with 'auto' takes the port's per-leaf kernel B5 (the
    JAX package's TPU prior would pick its XLA onehot engine); 'onehot'
    and 'scatter' run the XLA engines on row-major bins."""
    learner = _train(params)._gbdt.learner
    assert (learner.growth, learner.hist_mode) == (growth, mode)
    assert learner.X.shape[0] == (200 if mode in ("pallas", "onehot",
                                                  "scatter") else 4)
