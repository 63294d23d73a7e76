"""The three dense wave dataflows of the port on the CPU: the fused wave
step (``pallas_ct``, B1), the plain partition before the histogram-only
pass (``pallas_t``, B3) and the same on row-major bins (``pallas``, B4);
and the exponents handed to the exact grower's B5 and the sparse store's
B6.

Every grower computes the tree's weight rows and fixed-point exponents
once and hands the same tensors to each histogram call (the kernels sum
in that fixed point; the plain versions ignore it), and the trees stay
the ones these params trained before the exponents reached B3 and B4:
the model texts' digests are pinned.  On the CPU the three modes add in
the same f32 order, so their model texts are equal to the byte as well.
"""
import hashlib

import pytest
import torch

import numpy as np
import scipy.sparse as sps

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import grow as grow_mod
from lightgbm_tpu_torch.ops import wave as wave_mod
from torch_cases import NO_CACHE, parity_data
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

# sha256 of the model text (first 16 hex digits, the trailing
# pandas_categorical line included) by (EFB bundles, cache)
PINNED = {(False, True): "97fe13e7a0a6b77c", (False, False): "22aaf4ce6ecad82f",
          (True, True): "5ad967e27098ce84", (True, False): "90244229f76e3de6"}
ITERS = 3


def _train(mode, bundled, cache):
    X, s = parity_data(3, 2000, bundled)
    p = dict({"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
              "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
              "tpu_wave_width": 4, "tpu_histogram_mode": mode},
             **({} if cache else NO_CACHE))
    booster = lgb.train(p, lgb.Dataset(X, label=(s > 0).astype(float)),
                        ITERS, device="cpu")
    assert (booster._gbdt.train_data.bundle is not None) == bundled
    assert booster._gbdt.learner.hist_mode == mode
    assert booster._gbdt.learner.cache_hists == cache
    return booster


def _trees_text(booster):
    """The model text without its drift_fingerprint= line (the dataset's
    profile and the scores' histogram, which the pinned digests predate):
    the trees the digests pin."""
    return "\n".join(l for l in booster.model_to_string().split("\n")
                     if not l.startswith("drift_fingerprint="))


@pytest.mark.parametrize("mode,wrapper", [("pallas_t", "wave_histogram"),
                                          ("pallas",
                                           "wave_histogram_rowmajor")])
@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_grow_tree_passes_the_tree_exponents(monkeypatch, mode, wrapper,
                                             bundled, cache):
    """grow_tree computes fixed_point_exponents once a tree and passes
    that tensor as exps= to every B3 (pallas_t) or B4 (pallas) call, the
    root's included; the trees are the pinned ones."""
    made, calls = [], []
    real_exps = wave_mod.fixed_point_exponents
    real_hist = getattr(wave_mod, wrapper)

    def exps_spy(w3):
        made.append(real_exps(w3))
        return made[-1]

    def hist_spy(*args, exps=None, **kw):
        calls.append((exps, made[-1] if made else None))
        return real_hist(*args, exps=exps, **kw)

    monkeypatch.setattr(wave_mod, "fixed_point_exponents", exps_spy)
    monkeypatch.setattr(wave_mod, wrapper, hist_spy)
    booster = _train(mode, bundled, cache)
    stats = booster.grow_stats()
    waves = sum(s.passes for s in stats)
    assert len(made) == len(stats) == ITERS
    assert len(calls) == len(stats) + waves * (1 if cache else 2)
    assert all(got is latest for got, latest in calls)
    text = _trees_text(booster)
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == PINNED[
        (bundled, cache)]


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_dense_dataflows_train_the_same_model_text(bundled, cache):
    """pallas_ct, pallas_t and pallas give byte-identical model text."""
    texts = [_trees_text(_train(m, bundled, cache))
             for m in ("pallas_ct", "pallas_t", "pallas")]
    assert texts[0] == texts[1] == texts[2]
    assert hashlib.sha256(texts[0].encode()).hexdigest()[:16] == PINNED[
        (bundled, cache)]


def _spy(monkeypatch, mod, wrapper):
    """(made, calls): every fixed_point_exponents result of the grower
    module mod, and for each call of its histogram wrapper the (w3, exps)
    it was given beside the latest exponents made."""
    made, calls = [], []
    real_exps = mod.fixed_point_exponents
    real_hist = getattr(mod, wrapper)

    def exps_spy(w3):
        made.append((w3, real_exps(w3)))
        return made[-1][1]

    def hist_spy(*args, **kw):
        calls.append((args, kw, made[-1] if made else None))
        return real_hist(*args, **kw)

    monkeypatch.setattr(mod, "fixed_point_exponents", exps_spy)
    monkeypatch.setattr(mod, wrapper, hist_spy)
    return made, calls


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_grow_tree_exact_passes_the_tree_weights_and_exponents(
        monkeypatch, bundled, cache):
    """grow_tree_exact makes w3 and fixed_point_exponents(w3) once a tree
    and passes both tensors to every B5 call, the root's (the first call
    of a tree, leaf 0) included; w3 is the wave grower's [g*m, h*m, m]
    (weight_rows of the tree's gradients and row multipliers), and the
    calls pass it alone: grad, hess and row_mult are None, the leaf a
    (1,) device tensor."""
    made, calls = _spy(monkeypatch, grow_mod, "leaf_histogram")
    rows = []
    real_rows = grow_mod.weight_rows

    def rows_spy(grad, hess, row_mult):
        rows.append(real_rows(grad, hess, row_mult))
        assert torch.equal(rows[-1], torch.stack(
            [grad * row_mult, hess * row_mult, row_mult], dim=-1))
        return rows[-1]

    monkeypatch.setattr(grow_mod, "weight_rows", rows_spy)
    X, s = parity_data(3, 2000, bundled)
    p = dict({"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
              "tpu_growth": "exact", "tpu_histogram_mode": "pallas"},
             **({} if cache else NO_CACHE))
    booster = lgb.train(p, lgb.Dataset(X, label=(s > 0).astype(float)),
                        ITERS, device="cpu")
    assert booster._gbdt.learner.cache_hists == cache
    stats = booster.grow_stats()
    splits = sum(st.passes for st in stats)
    assert len(made) == len(rows) == len(stats) == ITERS
    assert all(w3 is r for (w3, _), r in zip(made, rows))
    assert len(calls) == len(stats) + splits * (1 if cache else 2)
    roots, tree = 0, None
    for args, kw, (w3, exps) in calls:
        assert kw["w3"] is w3 and kw["exps"] is exps
        assert args[1] is args[2] is args[5] is None
        leaf = args[4]
        assert isinstance(leaf, torch.Tensor) and leaf.shape == (1,)
        if w3 is not tree:               # a tree's first call: its root
            tree = w3
            roots += 1
            assert int(leaf) == 0
    assert roots == len(stats)


@pytest.mark.parametrize("cache", [True, False])
def test_sparse_grower_passes_the_tree_exponents(monkeypatch, cache):
    """On the entry-chunk store grow_tree passes the tree's exponents to
    every B6 call, the root's (one child slot) included."""
    made, calls = _spy(monkeypatch, wave_mod, "sparse_wave_histogram")
    rng = np.random.default_rng(0)
    X = np.where(rng.random((2000, 8)) < 0.2, rng.normal(size=(2000, 8)),
                 0.0)
    X[:, 0] = rng.normal(size=2000)
    y = (X[:, 0] + 0.7 * X[:, 1] > 0).astype(float)
    p = dict({"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
              "tpu_growth": "wave", "tpu_wave_width": 4, "tpu_sparse": True,
              "tpu_sparse_kernel": True}, **({} if cache else NO_CACHE))
    booster = lgb.train(p, lgb.Dataset(sps.csr_matrix(X), label=y), ITERS,
                        device="cpu")
    assert booster._gbdt.learner.hist_mode == "sparse_mxu"
    stats = booster.grow_stats()
    waves = sum(st.passes for st in stats)
    assert len(made) == len(stats) == ITERS
    assert len(calls) == len(stats) + waves * (1 if cache else 2)
    for args, kw, (w3, exps) in calls:
        assert kw["exps"] is exps and args[2] is w3
    assert sum(args[3].shape[0] == 1 for args, _, _ in calls) == len(stats)
