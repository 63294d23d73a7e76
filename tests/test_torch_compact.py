"""Spectator-row compaction (``tpu_wave_compact``) in the port, on the CPU.

Under wave growth with a transposed wave kernel (pallas_ct, pallas_t) the
knob is taken (``learner.wave_compact``) and the ordinary full B1/B3 pass
runs under it (``ops/learner.py resolve_wave_compact`` says why).  The
JAX package's compaction skips only rows of no parent, which neither move
nor land in a child slot, so its trees are the full pass's: the port's
model text must be equal to the byte, fused and staged, on packed bins
and under bf16 too, and equal in structure to the JAX package's
compaction oracle.  Elsewhere the knob warns, as in the JAX package, and
changes nothing.
"""
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from torch_cases import NO_CACHE, parity_data, structure
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def _run(params, rounds=3, seed=3):
    X, s = parity_data(seed, 2000, False)
    base = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": 4}
    return lgbt.train(dict(base, **params),
                      lgbt.Dataset(X, label=(s > 0).astype(float)), rounds,
                      device="cpu")


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas_t"])
@pytest.mark.parametrize("more", [
    {}, {"tpu_fused_iter": "on"}, NO_CACHE, {"tpu_wave_order": "exact"},
    {"max_bin": 15}, {"tpu_hist_precision": "bf16"}])
def test_compact_trains_the_full_pass_model_text(mode, more):
    p = dict(more, tpu_histogram_mode=mode)
    full = _run(p)
    compact = _run(dict(p, tpu_wave_compact=True))
    assert full._gbdt.learner.wave_compact is False
    assert compact._gbdt.learner.wave_compact is True
    assert compact.model_to_string() == full.model_to_string()


@pytest.mark.parametrize("params", [
    {"tpu_histogram_mode": "pallas"},
    {"tpu_growth": "exact", "tpu_histogram_mode": "pallas"}])
def test_compact_elsewhere_warns_and_changes_nothing(params, capsys):
    got = _run(dict(params, tpu_wave_compact=True, verbose=1), rounds=2)
    err = capsys.readouterr()
    assert "tpu_wave_compact=true ignored" in err.out + err.err
    assert got._gbdt.learner.wave_compact is False
    assert got.model_to_string() == _run(params, rounds=2).model_to_string()


def test_compact_grows_the_jax_compaction_oracle_trees():
    X, s = parity_data(15, 2500, False)
    y = (s > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 4, "tpu_histogram_mode": "pallas_ct",
         "tpu_pallas_interpret": True, "tpu_hist_precision": "hilo",
         "tpu_wave_compact": True}
    bj = lgbj.train(p, lgbj.Dataset(X, label=y), 3, verbose_eval=False)
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), 3, device="cpu")
    assert bj._gbdt.learner.wave_compact and bt._gbdt.learner.wave_compact
    assert structure(bt.model_to_string()) == structure(bj.model_to_string())
