"""The three dense wave dataflows of the port on the CPU: the fused wave
step (``pallas_ct``, B1), the plain partition before the histogram-only
pass (``pallas_t``, B3) and the same on row-major bins (``pallas``, B4).

Every dense mode computes the tree's fixed-point exponents once and hands
the same tensor to each histogram call (the kernels sum in that fixed
point; the plain versions ignore it), and the trees stay the ones these
params trained before the exponents reached B3 and B4: the model texts'
digests are pinned.  On the CPU the three modes add in the same f32
order, so their model texts are equal to the byte as well.
"""
import hashlib

import pytest

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import wave as wave_mod
from torch_cases import NO_CACHE, parity_data

# sha256 of the model text (first 16 hex digits) by (EFB bundles, cache)
PINNED = {(False, True): "86bbc6cf2d62d2ff", (False, False): "c717324944a7c0cc",
          (True, True): "fb4913900216e057", (True, False): "e57ce3fab1ea4f0d"}
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
    waves = sum(s.waves for s in stats)
    assert len(made) == len(stats) == ITERS
    assert len(calls) == len(stats) + waves * (1 if cache else 2)
    assert all(got is latest for got, latest in calls)
    text = booster.model_to_string()
    assert hashlib.sha256(text.encode()).hexdigest()[:16] == PINNED[
        (bundled, cache)]


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("cache", [True, False])
def test_dense_dataflows_train_the_same_model_text(bundled, cache):
    """pallas_ct, pallas_t and pallas give byte-identical model text."""
    texts = [_train(m, bundled, cache).model_to_string()
             for m in ("pallas_ct", "pallas_t", "pallas")]
    assert texts[0] == texts[1] == texts[2]
    assert hashlib.sha256(texts[0].encode()).hexdigest()[:16] == PINNED[
        (bundled, cache)]
