"""The single bf16 product (``tpu_hist_precision=bf16``) in the port
against the JAX package, on the CPU.

The JAX package's wave kernels round each weight of ``match * w3`` to
bf16 (``_round_bf16``: 0x8000 added to the f32 bits, the low 16 cleared,
so ties round away from zero) and add the bf16 values in f32.  The port's
plain versions round with ``round_bf16`` and add in f32, so both sum the
same bf16 values in other orders: histograms must agree within 1e-5 x
the histogram's largest |cell|.  The dense root stays unrounded on both
sides (the JAX package takes it from its f32 one-hot engine); the sparse
root is B6's, rounded.

Training under bf16 grows the JAX bf16 oracle's trees on pinned seeds,
with leaf values within rtol 1e-4, and on every seed of 0-19 at three
settings partitions the training rows alike (an empty bin gap may take
either of two thresholds), with leaf values within 1e-4 of the largest
leaf (the sweep's record is in that test's docstring).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import sparse_mxu as jsm
from lightgbm_tpu.ops.pallas_wave import (wave_histogram_pallas,
                                          wave_histogram_pallas_t,
                                          wave_partition_hist_pallas_ct)
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.ops import sparse_mxu as tsm
from lightgbm_tpu_torch.ops.pack import pack4_host
from lightgbm_tpu_torch.ops import wave_kernels as wk
from torch_cases import (NO_CACHE, bundled_case, leaf_values, parity_data,
                         sparse_bundled_case, sparse_case, structure, t,
                         unbundled_case, wave_data)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

TIE = np.float32(1 + 2.0 ** -8)        # halfway between 1 and 1 + 2^-7


def _round_np(w):
    """The JAX package's _round_bf16 in numpy bit arithmetic."""
    bits = np.ascontiguousarray(w, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x8000)) & np.uint32(0xFFFF0000)).view(
        np.float32)


def _close(got, want):
    """Within 1e-5 x the histogram's largest |cell|."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def _with_ties(w3, seed):
    """w3 with +-TIE in about a tenth of its entries."""
    w = np.array(w3, np.float32)
    rng = np.random.default_rng(seed)
    tie = rng.random(w.shape) < 0.1
    w[tie] = np.where(w[tie] < 0, -TIE, TIE)
    return w


def test_round_bf16_rounds_ties_away_from_zero():
    """round_bf16 is _round_bf16 to the bit on random, tie, negative,
    tiny and huge values; a tie goes away from zero where torch's cast
    goes to even."""
    rng = np.random.default_rng(0)
    w = np.concatenate([rng.normal(size=5000).astype(np.float32),
                        [TIE, -TIE, 1 + 3 * 2.0 ** -8, 0.0, -0.0, 1e-40,
                         3e38, -3e38, 2.0 ** -126]]).astype(np.float32)
    got = wk.round_bf16(t(w)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32),
                                  _round_np(w).view(np.uint32))
    assert wk.round_bf16(t(np.array([TIE])))[0] == 1 + 2.0 ** -7
    assert wk.round_bf16(t(np.array([-TIE])))[0] == -(1 + 2.0 ** -7)
    assert t(np.array([TIE])).to(torch.bfloat16).float()[0] == 1.0
    # float64 input: rounded through f32, returned in float64
    assert wk.round_bf16(torch.tensor([float(TIE)],
                                      dtype=torch.float64))[0] == 1 + 2 ** -7


def test_tie_fixture_pins_the_kernels_rounding():
    """One row of weight TIE in one bin: the JAX package's bf16 kernel
    and the port's plain bf16 version both give 1 + 2^-7 (half away from
    zero), not 1 (half to even)."""
    X = np.zeros((256, 2), np.uint8)
    lid = np.full(256, 5, np.int32)
    lid[7] = 0
    w3 = np.zeros((256, 3), np.float32)
    w3[7] = [TIE, -TIE, TIE]
    cid = np.zeros(1, np.int32)
    want = np.asarray(wave_histogram_pallas_t(
        jnp.asarray(X.T), jnp.asarray(lid), jnp.asarray(w3),
        jnp.asarray(cid), 4, interpret=True, hilo=False))
    got = wk.wave_histogram(t(X.T), t(lid), t(w3), t(cid), 4,
                            hilo=False).numpy()
    r = 1 + 2.0 ** -7
    np.testing.assert_array_equal(got[0, :, 0], [[r, -r, r]] * 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bundled", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_bf16_fused_plain_matches_pallas_ct(bundled, packed):
    X, lid, w3, cid, b, cols, psrc = (bundled_case() if bundled
                                      else unbundled_case())
    w3 = _with_ties(w3, 1)
    f = X.shape[1]
    Xs = pack4_host(X) if packed else X
    lc = f if packed else 0
    want_lid, want = wave_partition_hist_pallas_ct(
        jnp.asarray(Xs.T), jnp.asarray(lid), jnp.asarray(w3),
        jnp.asarray(cid), jnp.asarray(cols), jnp.asarray(psrc), b,
        bundled=bundled, interpret=True, logical_cols=lc, hilo=False)
    got_lid, got = wk.wave_partition_hist(
        t(Xs.T), t(lid), t(w3), t(cid), t(cols), t(psrc), b,
        bundled=bundled, logical_cols=lc, hilo=False)
    np.testing.assert_array_equal(got_lid.numpy(), np.asarray(want_lid))
    _close(got.numpy(), want)
    # the plain bf16 form is the hilo form on the rounded weights
    same = wk.wave_partition_hist(t(Xs.T), t(lid), t(_round_np(w3)),
                                  t(cid), t(cols), t(psrc), b,
                                  bundled=bundled, logical_cols=lc)[1]
    assert torch.equal(got, same)


@pytest.mark.parametrize("f,k", [(7, 5), (28, 3), (9, 1)])
def test_bf16_hist_plain_matches_pallas_t_and_pallas(f, k):
    X, lid, w3, cid, b = wave_data(n=2600, f=f, b=31, k=k, seed=f * k)
    w3 = _with_ties(w3, f)
    want_t = wave_histogram_pallas_t(
        jnp.asarray(X.T), jnp.asarray(lid), jnp.asarray(w3),
        jnp.asarray(cid), b, interpret=True, hilo=False)
    want_r = wave_histogram_pallas(
        jnp.asarray(X), jnp.asarray(lid), jnp.asarray(w3), jnp.asarray(cid),
        b, interpret=True, hilo=False)
    got_t = wk.wave_histogram(t(X.T), t(lid), t(w3), t(cid), b, hilo=False)
    got_r = wk.wave_histogram_rowmajor(t(X), t(lid), t(w3), t(cid), b,
                                       hilo=False)
    _close(got_t.numpy(), want_t)
    _close(got_r.numpy(), want_r)
    assert torch.equal(got_t, got_r)
    # and the rounding matters: the hilo sums differ
    assert not torch.equal(got_t, wk.wave_histogram(t(X.T), t(lid), t(w3),
                                                    t(cid), b))


@pytest.mark.parametrize("kind", ["plain", "bundled"])
def test_bf16_sparse_plain_matches_the_jax_kernel(kind):
    """B6's plain bf16 form against sparse_wave_histogram_mxu(hilo=False)
    in interpret mode; the sparse store never packs."""
    if kind == "bundled":
        X, fill, lid, w3, b = sparse_bundled_case()
        cid = np.array([1, 4, -1, 8], np.int32)
    else:
        X, fill, lid, w3 = sparse_case(L=12)
        b = 14
        cid = np.array([0, 2, 4, -1, 7], np.int32)
    w3 = _with_ties(w3, 2)
    f = X.shape[1]
    js = jsm.build_chunked_store(X, fill, b, entry_chunk=128)[0]
    ts = tsm.build_chunked_store(X, fill, b, entry_chunk=128)[0]
    want = jsm.sparse_wave_histogram_mxu(
        js, jnp.asarray(lid), jnp.asarray(w3), jnp.asarray(cid), b, f,
        interpret=True, hilo=False)
    got = tsm.sparse_wave_histogram(ts, t(lid), t(w3), t(cid), b, f,
                                    hilo=False)
    _close(got.numpy(), want)
    assert torch.equal(got, tsm.sparse_wave_histogram(
        ts, t(lid), t(_round_np(w3)), t(cid), b, f))


# ---------------------------------------------------------------- training
def _params(width, more=None):
    return dict({"objective": "binary", "num_leaves": 15,
                 "min_data_in_leaf": 20, "max_bin": 63, "verbose": -1,
                 "metric": "auc", "tpu_growth": "wave",
                 "tpu_wave_width": width, "tpu_histogram_mode": "pallas_ct",
                 "tpu_pallas_interpret": True,
                 "tpu_hist_precision": "bf16"}, **(more or {}))


# (wave width, pinned seed, max_bin): seeds on which the JAX bf16 oracle
# and the port grow the same trees, thresholds included
CASES = [(4, 15, 63), (14, 15, 63), (4, 3, 15)]
# every seed of 0-19 at the three settings, none left out
SWEEP = [(w, seed, mb) for w, mb in ((4, 63), (14, 63), (4, 15))
         for seed in range(20)]
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


@pytest.mark.parametrize("width,seed,max_bin", CASES)
def test_bf16_training_grows_the_jax_bf16_oracle_trees(width, seed, max_bin):
    X, s = parity_data(seed, 2500, False)
    Xv, sv = parity_data(seed + 1000, 600, False)
    y, yv = (s > 0).astype(float), (sv > 0).astype(float)
    p = _params(width, {"max_bin": max_bin})
    ej, et = {}, {}
    bj = lgbj.train(p, lgbj.Dataset(X, label=y), 3,
                    valid_sets=[lgbj.Dataset(Xv, label=yv)], evals_result=ej,
                    verbose_eval=False)
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), 3,
                    valid_sets=[lgbt.Dataset(Xv, label=yv)], evals_result=et,
                    device="cpu")
    assert bj._gbdt.learner.hist_hilo is False
    assert bt._gbdt.learner.hist_hilo is False
    assert bt._gbdt.learner.packed_cols == bj._gbdt.learner.packed_cols
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert structure(st) == structure(sj)
    lj, lt = leaf_values(sj), leaf_values(st)
    np.testing.assert_allclose(lt, lj, rtol=1e-4,
                               atol=1e-5 * np.abs(lj).max())
    assert abs(et["valid_0"]["auc"][-1] - ej["valid_0"]["auc"][-1]) <= 1e-6
    # the rounding is really on: hi/lo grows other leaf values
    bh = lgbt.train(dict(p, tpu_hist_precision="hilo"),
                    lgbt.Dataset(X, label=y), 3, device="cpu")
    assert bh.model_to_string() != st


@pytest.mark.parametrize("width,seed,max_bin", SWEEP)
def test_bf16_training_partitions_the_rows_as_the_jax_oracle(width, seed,
                                                             max_bin):
    """Every seed of 0-19: the same partitions of the training rows as the
    JAX bf16 oracle, and leaf values within 1e-4 of the largest leaf.

    The record of the sweep (CPU): all 60 runs partition the rows alike.
    On 46 the texts' trees are equal, thresholds included; on 14 (seeds
    0 and 4 at width 4, 4 at width 14, and 0, 4-7, 9-12, 14, 15 at
    max_bin 15) one side puts the empty zero bin of a normal feature on
    the other side of a split, threshold 1e-20 against -1e-20: the same
    rows either way, the two gains 2e-7 to 2.5e-6 of themselves apart
    (f32 summation order).  58 runs hold every leaf within rtol 1e-4 of
    the oracle's; seeds 5 and 11 at max_bin 15 each have one leaf 1.6e-4
    and 2.1e-4 of itself apart (6.8e-5 and 2.4e-5 of the largest leaf),
    hence the tolerance here, a tenth of the hi/lo oracle tests' 1e-3 of
    the largest leaf (tests/test_torch_train_parity.py)."""
    X, s = parity_data(seed, 2500, False)
    y = (s > 0).astype(float)
    p = _params(width, {"max_bin": max_bin})
    bj = lgbj.train(p, lgbj.Dataset(X, label=y), 3, verbose_eval=False)
    bt = lgbt.train(p, lgbt.Dataset(X, label=y), 3, device="cpu")
    sj, st = bj.model_to_string(), bt.model_to_string()

    def partition(text):
        return [ln for ln in text.splitlines() if ln.startswith(PARTITION)]

    assert partition(st) == partition(sj)
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    lj = leaf_values(sj)
    np.testing.assert_allclose(leaf_values(st), lj, rtol=0,
                               atol=1e-4 * np.abs(lj).max())


@pytest.mark.parametrize("more", [{}, {"tpu_histogram_mode": "pallas_t"},
                                  {"tpu_histogram_mode": "pallas"},
                                  {"tpu_wave_order": "exact"}, NO_CACHE])
def test_bf16_fused_trains_the_staged_model_text(more):
    X, s = parity_data(3, 2000, False)
    y = (s > 0).astype(float)
    p = _params(4, more)
    fused = lgbt.train(dict(p, tpu_fused_iter="on"), lgbt.Dataset(X, label=y),
                       3, device="cpu")
    staged = lgbt.train(dict(p, tpu_fused_iter="off"),
                        lgbt.Dataset(X, label=y), 3, device="cpu")
    assert fused._gbdt._fused_state[0] is not None
    assert fused.model_to_string() == staged.model_to_string()


@pytest.mark.parametrize("precision,growth,hilo", [
    ("auto", "wave", True), ("hilo", "wave", True), ("bf16", "wave", False),
    ("bf16", "exact", False), ("auto", "exact", True)])
def test_precision_resolves(precision, growth, hilo):
    """The port's auto stays unrounded on every device (its fixed-point
    kernels gain nothing from bf16); exact growth records bf16 and, as in
    the JAX package, its leaf histograms ignore it."""
    X, s = parity_data(3, 1500, False)
    y = (s > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
         "tpu_growth": growth, "tpu_hist_precision": precision}
    if growth == "exact":
        p["tpu_histogram_mode"] = "pallas"
    b = lgbt.train(p, lgbt.Dataset(X, label=y), 2, device="cpu")
    assert b._gbdt.learner.hist_hilo is hilo
    if growth == "exact":
        ref = lgbt.train(dict(p, tpu_hist_precision="hilo"),
                         lgbt.Dataset(X, label=y), 2, device="cpu")
        assert b.model_to_string() == ref.model_to_string()
    with pytest.raises(lgbt.LightGBMError, match="tpu_hist_precision"):
        lgbt.train(dict(p, tpu_hist_precision="fp8"),
                   lgbt.Dataset(X, label=y), 1, device="cpu")


def test_bf16_sparse_training_grows_the_jax_tpu_trees(monkeypatch):
    """On the TPU the JAX package's sparse store sums the bf16-rounded
    weights (sparse_wave_histogram_mxu(hilo=False)); on the CPU it runs
    its f32 reference whatever the precision.  With the reference given
    the weights rounded as the TPU kernel rounds them, the JAX package
    grows the port's bf16 sparse trees (root included: B6 rounds it, as
    the TPU kernel does).  The Bosch-shaped data's skew makes bf16 cost
    AUC there (PERF.md); both packages pay it alike."""
    import scipy.sparse as sps
    from lightgbm_tpu.ops import sparse_mxu as jsm2

    ref = jsm2.chunked_child_hists_ref

    def rounded(X, lid, w3, *a, **k):
        # _round_bf16's bit arithmetic, traced
        bits = jax.lax.bitcast_convert_type(w3.astype(jnp.float32),
                                            jnp.uint32)
        w = jax.lax.bitcast_convert_type(
            (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000),
            jnp.float32)
        return ref(X, lid, w, *a, **k)

    monkeypatch.setattr(jsm2, "chunked_child_hists_ref", rounded)
    rng = np.random.default_rng(6)
    n = 3000
    X = np.where(rng.random((n, 12)) < 0.2, rng.normal(size=(n, 12)), 0.0)
    X[:, 0] = rng.normal(size=n)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3]
         + 0.3 * rng.normal(size=n) > 0).astype(float)
    C = sps.csr_matrix(X)
    p = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 4, "tpu_sparse": True, "tpu_sparse_kernel": True,
         "tpu_hist_precision": "bf16"}
    bj = lgbj.train(p, lgbj.Dataset(C, label=y), 3, verbose_eval=False)
    bt = lgbt.train(p, lgbt.Dataset(C, label=y), 3, device="cpu")
    sj, st = bj.model_to_string(), bt.model_to_string()
    assert structure(st) == structure(sj)
    lj, lt = leaf_values(sj), leaf_values(st)
    np.testing.assert_allclose(lt, lj, rtol=1e-4,
                               atol=1e-5 * np.abs(lj).max())
    # and the rounding is on: the unrounded run grows other values
    hilo = lgbt.train(dict(p, tpu_hist_precision="hilo"),
                      lgbt.Dataset(C, label=y), 3, device="cpu")
    assert hilo.model_to_string() != st
