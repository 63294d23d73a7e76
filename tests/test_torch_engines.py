"""The JAX package's other dense engines in the port: the XLA histogram
engines ``tpu_histogram_mode=onehot|scatter`` (wave and exact growth),
``tpu_use_dp`` (float64 histograms, split search, trees and scores) and
``tpu_score_update=gather``.

What must agree, and how closely:

* engine histograms: the port's ``onehot`` and ``scatter`` against the
  JAX package's ``leaf_histogram_onehot`` and ``leaf_histogram_scatter``
  with rtol 1e-5 and atol 1e-5 x max|w| (f32 sums in another order), on
  byte, two-byte and 4-bit packed bins;
* ``scatter``'s fixed point: its sums are the exact integer sums of the
  quantized weights (computed here with Python integers) rounded once,
  to the bit, in the f32 form (64-bit) and the f64 form (128-bit);
* trees under the engines (wave growth at W = 32 and exact growth)
  against the JAX package's runs of the same engine: partitions exactly
  (split features, child pointers, leaf counts, decision types and every
  training row's leaf; thresholds may sit anywhere in an empty bin gap,
  module docstring of tests/test_torch_wide_bins.py), leaf values to
  rtol 1e-5 with atol 1e-5 x the largest leaf;
* ``tpu_use_dp`` against the JAX package run inside
  ``jax.enable_x64(True)`` (outside it the JAX package's float64 is
  float32): its exact grower on ``onehot``, the port's exact growth on
  B5, onehot and scatter and its wave growth at width 1 on the three
  dataflows (which equals exact growth), leaf values and predictions to
  rtol 1e-12 (double-grade).  The JAX package's wave grower does not
  trace under x64 (its while_loop carries an int32 that becomes int64),
  so the port's W = 32 float64 runs are held to fused = staged;
* ``gather`` against the JAX package's ``_update_score_gather``, to the
  bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.ops.histogram import (leaf_histogram_onehot,
                                        leaf_histogram_scatter)
from lightgbm_tpu.ops.predict import _update_score_gather
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import predict as tp
from lightgbm_tpu_torch.ops import wave_kernels as wk
from lightgbm_tpu_torch.ops.pack import pack4_host
from torch_cases import leaf_values, t
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "max_bin": 63, "verbose": -1}
WAVE = {"tpu_growth": "wave", "tpu_wave_width": 32}
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def data(seed, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * X[:, 4]
         + 0.2 * rng.normal(size=n))
    return X, (s > 0).astype(float)


def partition(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def _jax_run(params, X, y, rounds=3, x64=False):
    def run():
        b = lgbj.train(params, lgbj.Dataset(X, label=y), rounds)
        return (b.model_to_string(), b.predict(X, pred_leaf=True),
                b.predict(X))
    if x64:
        with jax.enable_x64(True):
            return run()
    return run()


def _port_run(params, X, y, rounds=3):
    b = lgbt.train(params, lgbt.Dataset(X, label=y), rounds, device="cpu")
    return b, b.model_to_string()


def _assert_same_trees(want, bt, st, X, rtol):
    sj, leaves_j, pred_j = want
    assert partition(st) == partition(sj)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True), leaves_j)
    lt, lj = leaf_values(st), leaf_values(sj)
    np.testing.assert_allclose(lt, lj, rtol=rtol,
                               atol=rtol * np.abs(lj).max())
    np.testing.assert_allclose(bt.predict(X), pred_j, rtol=rtol,
                               atol=rtol * np.abs(pred_j).max())


# ------------------------------------------------------- engine histograms
def _leaf_case(n, f, b, seed, packed=False):
    rng = np.random.default_rng(seed)
    X = rng.integers(0, b + 1, size=(n, f)).astype(
        np.uint16 if b > 255 else np.uint8)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.random(n).astype(np.float32) + 0.1
    lid = rng.integers(0, 3, size=n).astype(np.int32)
    rm = (rng.random(n) > 0.2).astype(np.float32)
    return X, g, h, lid, rm


@pytest.mark.parametrize("mode", ["onehot", "scatter"])
@pytest.mark.parametrize("n,f,b,packed", [(3000, 7, 63, False),
                                          (2000, 4, 700, False),
                                          (2500, 5, 15, True),
                                          (1000, 3, 255, False)])
def test_engine_histograms_match_the_jax_package(mode, n, f, b, packed):
    """One leaf's (F, B, 3) histogram (a bin past num_bins drops)."""
    X, g, h, lid, rm = _leaf_case(n, f, b, seed=n + b)
    if packed:
        X = np.minimum(X, 15).astype(np.uint8)
    w = np.stack([g * rm, h * rm, rm], -1).astype(np.float32)
    w3 = t(w) * t((lid == 1).astype(np.float32))[:, None]
    exps = wk.fixed_point_exponents(t(w))
    Xd = t(pack4_host(X)) if packed else t(X)
    got = th.engine_histogram(mode, Xd, t(lid), t(w), t(np.array(
        [1], np.int32)), b, exps, f if packed else 0)[0]
    fn = leaf_histogram_onehot if mode == "onehot" else leaf_histogram_scatter
    want = np.asarray(fn(jnp.asarray(X), jnp.asarray(g), jnp.asarray(h),
                         jnp.asarray(lid), 1, jnp.asarray(rm), num_bins=b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(w).max()))
    assert float(w3.abs().sum()) > 0


@pytest.mark.parametrize("wide", [False, True])
def test_scatter_sums_the_fixed_point_exactly(wide):
    """scatter's cells are the exact sums of the quantized weights,
    rounded once as the kernels round them; several child slots, an
    inactive one and a repeated id (which takes the first's sums)."""
    rng = np.random.default_rng(5)
    n, f, b = 1500, 3, 9
    X = rng.integers(0, b, size=(n, f)).astype(np.uint8)
    lid = rng.integers(0, 4, size=n).astype(np.int32)
    w = rng.normal(size=(n, 3)) * np.array([1e3, 1e-3, 1.0])
    w = w.astype(np.float64 if wide else np.float32)
    cid = np.array([2, -1, 0, 2], np.int32)
    exps = wk.fixed_point_exponents(t(w))
    got = th.scatter_histogram(t(X), t(lid), t(w), t(cid), b, exps).numpy()
    e = [int(v) for v in exps]
    assert max(e) > (90 if wide else 30)
    for k, c in enumerate(cid):
        for j in range(f):
            for bin_ in range(b):
                rows = np.nonzero((lid == c) & (X[:, j] == bin_))[0]
                for ch in range(3):
                    q = sum(int(np.round(np.ldexp(float(w[r, ch]), e[ch])))
                            for r in rows)
                    if wide:
                        # the kernels' to_f64: each 64-bit half of the
                        # magnitude converted, then hi * 2^64 + lo
                        m = abs(q)
                        hi, lo = float(m >> 64), float(m & (2 ** 64 - 1))
                        want = np.ldexp(hi * 2.0 ** 64 + lo, -e[ch])
                        want = float(-want if q < 0 else want)
                    else:
                        want = float(np.float32(np.ldexp(float(q), -e[ch])))
                    assert got[k, j, bin_, ch] == want, (k, j, bin_, ch)


# ----------------------------------------------------------------- trees
ENGINE_CASES = [("onehot", "wave"), ("scatter", "wave"),
                ("onehot", "exact"), ("scatter", "exact")]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode,growth", ENGINE_CASES)
def test_engines_train_the_jax_package_trees(mode, growth, seed):
    X, y = data(seed)
    p = dict(BASE, tpu_histogram_mode=mode, tpu_growth=growth)
    if growth == "wave":
        p.update(WAVE)
    bt, st = _port_run(p, X, y)
    learner = bt._gbdt.learner
    assert (learner.hist_mode, learner.growth) == (mode, growth)
    assert learner.X.shape == (len(X), 5)                 # row-major
    _assert_same_trees(_jax_run(p, X, y), bt, st, X, 1e-5)


@pytest.mark.parametrize("mode,growth", ENGINE_CASES)
def test_engines_take_wide_and_packed_bins(mode, growth):
    """max_bin 511 (uint16) and max_bin 15 (4-bit packed under wave
    growth and under exact growth on the engines, as in the JAX
    package)."""
    X, y = data(2)
    for max_bin, packed in ((511, False), (15, True)):
        p = dict(BASE, tpu_histogram_mode=mode, tpu_growth=growth,
                 max_bin=max_bin)
        if growth == "wave":
            p.update(WAVE)
        bt, st = _port_run(p, X, y)
        assert bool(bt._gbdt.learner.packed_cols) == packed
        sj, leaves_j, _ = _jax_run(p, X, y)
        assert partition(st) == partition(sj)
        np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                      leaves_j)


@pytest.mark.parametrize("mode,growth", ENGINE_CASES)
def test_engines_fused_equals_staged(mode, growth):
    X, y = data(3)
    p = dict(BASE, tpu_histogram_mode=mode, tpu_growth=growth)
    if growth == "wave":
        p.update(WAVE)
    texts = [_port_run(dict(p, tpu_fused_iter=f), X, y)[1]
             for f in ("on", "off")]
    assert texts[0] == texts[1]


# ---------------------------------------------------------- tpu_use_dp
DP_PORT = [
    {"tpu_growth": "exact", "tpu_histogram_mode": "pallas"},
    {"tpu_growth": "exact", "tpu_histogram_mode": "onehot"},
    {"tpu_growth": "exact", "tpu_histogram_mode": "scatter"},
    {"tpu_growth": "wave", "tpu_wave_width": 1,
     "tpu_histogram_mode": "pallas_ct"},
    {"tpu_growth": "wave", "tpu_wave_width": 1,
     "tpu_histogram_mode": "pallas_t"},
    {"tpu_growth": "wave", "tpu_wave_width": 1,
     "tpu_histogram_mode": "pallas"},
]


@pytest.mark.parametrize("seed", [0, 2])
@pytest.mark.parametrize("more", DP_PORT,
                         ids=lambda m: "%s-%s" % (m["tpu_growth"],
                                                  m["tpu_histogram_mode"]))
def test_use_dp_trains_the_jax_package_x64_trees(more, seed):
    X, y = data(seed)
    p = dict(BASE, tpu_use_dp=True)
    want = _jax_run(dict(p, tpu_growth="exact", tpu_histogram_mode="onehot"),
                    X, y, x64=True)
    bt, st = _port_run(dict(p, **more), X, y)
    gb = bt._gbdt
    assert gb.learner.dtype == torch.float64
    assert gb._score_dev.dtype == torch.float64
    assert gb._score_engine == "gather"
    _assert_same_trees(want, bt, st, X, 1e-12)


@pytest.mark.parametrize("more", [dict(WAVE, tpu_histogram_mode="pallas_ct"),
                                  dict(WAVE, tpu_histogram_mode="scatter"),
                                  {"tpu_growth": "exact"}])
def test_use_dp_fused_equals_staged(more):
    X, y = data(4)
    p = dict(BASE, tpu_use_dp=True, **more)
    texts = [_port_run(dict(p, tpu_fused_iter=f), X, y)[1]
             for f in ("on", "off")]
    assert texts[0] == texts[1]


def test_use_dp_auto_stays_on_the_kernels():
    """Under tpu_use_dp the JAX package's auto takes its onehot engine
    (its Pallas kernels are f32-only); the port's auto takes its kernels'
    f64 form."""
    X, y = data(0)
    bt, _ = _port_run(dict(BASE, tpu_use_dp=True), X, y)
    learner = bt._gbdt.learner
    assert (learner.growth, learner.hist_mode) == ("wave", "pallas_ct")
    assert learner.obs_info()["dtype"] == "float64"


def test_use_dp_refuses_the_sparse_kernel():
    X, y = data(0)
    p = dict(BASE, tpu_use_dp=True, tpu_sparse=True, tpu_sparse_kernel=True)
    with pytest.raises(lgbt.LightGBMError, match="tpu_use_dp"):
        _port_run(p, X, y)


# ---------------------------------------------------------------- gather
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_matches_the_jax_package(dtype):
    rng = np.random.default_rng(7)
    n, L = 5000, 31
    score = rng.normal(size=n).astype(dtype)
    lid = rng.integers(-1, L + 1, size=n).astype(np.int32)
    lv = (rng.normal(size=L) * 60).astype(dtype)
    got = tp.update_score_gather(t(score), t(lid), t(lv), 0.3)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(_update_score_gather(
            jnp.asarray(score), jnp.asarray(lid), jnp.asarray(lv),
            jnp.asarray(0.3, dtype)))
    assert got.dtype == torch.from_numpy(score).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.float32:
        b2 = tp.score_update(t(score), t(lid), t(lv), 0.3)
        assert torch.equal(got, b2)


def test_gather_trains_the_same_text_as_b2():
    X, y = data(1)
    texts = []
    for se in ("gather", "pallas", "auto"):
        bt, st = _port_run(dict(BASE, tpu_score_update=se, **WAVE), X, y)
        assert bt._gbdt._score_engine == ("gather" if se == "gather"
                                          else "pallas")
        texts.append(st)
    assert texts[0] == texts[1] == texts[2]


# ----------------------------------------------------- the autotuner
def test_forced_probes_under_use_dp_keep_the_f64_form(tmp_path):
    """Under tpu_use_dp the autotuner probes only the wave-kernel cells
    the port's resolution runs there (their f64 form), never the bf16
    precision (pinned), and buckets two-byte bins by their padded width
    (max_bin 511: 512)."""
    from lightgbm_tpu_torch.ops import autotune as tat
    tat.install_probe_hooks(timer=lambda: 0.0, force=True)
    try:
        X, y = data(0)
        p = dict(BASE, num_leaves=7, max_bin=511, tpu_use_dp=True,
                 tpu_growth="wave", tpu_autotune="force",
                 tpu_autotune_waves=1,
                 tpu_autotune_cache=str(tmp_path / "c.json"))
        b = lgbt.train(p, lgbt.Dataset(X, label=y), 1, device="cpu")
    finally:
        tat.clear_probe_hooks()
    learner = b._gbdt.learner
    assert learner.autotune_shape.bin_pad == 512
    assert learner.autotune_pins.precision
    cells = [c for c, _ in learner.autotune.probes]
    assert len(cells) > 1 and all(c.hist_hilo for c in cells)
    assert {c.hist_mode for c in cells} <= {"pallas_ct", "pallas_t"}
    assert learner.dtype == torch.float64


def test_cell_traffic_counts_two_byte_bins_and_f64():
    """A probe run's bytes: a bin of a bucket past 256 padded bins reads
    two bytes, and the f64 form's weights, histograms and score update
    are float64 (the gather)."""
    from lightgbm_tpu_torch.obs import roofline
    from lightgbm_tpu_torch.ops import autotune as tat
    cell = tat.Cell("pallas_t", 2, True, False)
    n, F = 1000, 28
    for B, bb in ((256, 1), (512, 2)):
        for wide, vb in ((False, 12), (True, 24)):
            flops, nbytes = roofline.cell_traffic(
                tat.ShapeBucket(F, B, 4, n), cell, wide)
            root = n * 4 + n * (F * bb + vb) + 4 + F * B * vb
            w1 = n * 4 + n * (F * bb + vb) + 4 + F * B * vb
            w2 = n * 4 + n * (F * bb + vb) + 8 + 2 * F * B * vb
            upd = n * 20 + 4 * 8 if wide else n * 12 + 4 * 4
            assert nbytes == root + w1 + w2 + upd
            assert flops == 3 * n * F * 3 + n
