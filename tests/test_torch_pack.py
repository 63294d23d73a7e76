"""4-bit packed bins (``tpu_bin_pack``) in the port against the JAX
package, on the CPU.

* ``ops/pack.py``: ``pack4_host`` gives the JAX package's bytes for odd and
  even column counts, ``unpack4``/``unpack4_t`` invert it and
  ``can_pack4`` answers as the JAX package's does.
* The plain versions of B1, B3 and B4 on packed bins match the JAX
  package's Pallas kernels run in interpret mode with ``logical_cols=F``:
  leaf ids exactly, histograms with tests/test_torch_wave_kernels.py's
  tolerance (rtol 1e-5, atol 1e-5 x max|w|) on weights cut to the 16
  significant bits that the kernels' bf16 hi/lo split keeps exactly.
* Training at ``max_bin=15`` under ``tpu_bin_pack=auto`` uploads
  ceil(F/2) columns and trains the model text of ``tpu_bin_pack=false``
  to the byte on every dense dataflow; it grows the JAX oracle's trees
  with ``packed_cols == F`` on both sides; rollback and DART traverse the
  packed training bins to the unpacked run's scores.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import pack as jpack
from lightgbm_tpu.ops.pallas_wave import (wave_histogram_pallas,
                                          wave_histogram_pallas_t,
                                          wave_partition_hist_pallas_ct)
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.ops import pack as tpack
from lightgbm_tpu_torch.ops import wave_kernels as wk
from torch_cases import (NO_CACHE, SAMPLED, assert_hist_close, bundled_case,
                         parity_data, structure, t, unbundled_case,
                         wave_data)
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def _hilo_exact(w3):
    """w3 cut to 16 significant bits: exact under the bf16 hi/lo split."""
    bits = np.ascontiguousarray(w3, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFFF00)).view(np.float32)


@pytest.mark.parametrize("f", [1, 2, 7, 13, 28])
def test_pack4_host_gives_the_jax_packages_bytes(f):
    rng = np.random.default_rng(f)
    X = rng.integers(0, 16, size=(301, f), dtype=np.uint8)
    got = tpack.pack4_host(X)
    np.testing.assert_array_equal(got, jpack.pack4_host(X))
    assert got.shape == (301, (f + 1) // 2) == (301, tpack.packed_width(f))
    np.testing.assert_array_equal(tpack.unpack4(t(got), f).numpy(), X)
    np.testing.assert_array_equal(
        tpack.unpack4_t(t(got.T.copy()), f).numpy(), X.T)
    np.testing.assert_array_equal(
        tpack.unpack4(t(got), f).numpy(),
        np.asarray(jpack.unpack4(jnp.asarray(got), f)))
    if f % 2:                            # the padding nibble stays zero
        assert not (got[:, -1] >> 4).any()


@pytest.mark.parametrize("bins", [[16, 3, 2], [17, 2], [2], [], [15, 16, 1]])
def test_can_pack4_answers_as_the_jax_package(bins):
    assert tpack.can_pack4(bins) == jpack.can_pack4(bins)


def _packed(X):
    return tpack.pack4_host(X)


@pytest.mark.parametrize("bundled", [False, True])
def test_packed_fused_plain_matches_pallas_ct(bundled):
    X, lid, w3, cid, b, cols, psrc = (bundled_case() if bundled
                                      else unbundled_case())
    f = X.shape[1]
    Xp, wq = _packed(X), _hilo_exact(w3)
    want_lid, want = wave_partition_hist_pallas_ct(
        jnp.asarray(Xp.T), jnp.asarray(lid), jnp.asarray(wq),
        jnp.asarray(cid), jnp.asarray(cols), jnp.asarray(psrc), b,
        bundled=bundled, interpret=True, logical_cols=f)
    got_lid, got = wk.wave_partition_hist(
        t(Xp.T), t(lid), t(wq), t(cid), t(cols), t(psrc), b,
        bundled=bundled, logical_cols=f)
    np.testing.assert_array_equal(got_lid.numpy(), np.asarray(want_lid))
    assert (got_lid.numpy() != lid).any()       # some rows really moved
    assert got.shape == (len(cid), f, b, 3)
    assert_hist_close(got.numpy(), np.asarray(want), wq)
    # the packed plain version is the byte bins' to the bit
    byte_lid, byte = wk.wave_partition_hist(
        t(X.T), t(lid), t(wq), t(cid), t(cols), t(psrc), b, bundled=bundled)
    assert torch.equal(got_lid, byte_lid) and torch.equal(got, byte)
    listed = wk.route_list(t(Xp.T), t(lid), t(cid), t(cols), t(psrc),
                           bundled, logical_cols=f)
    for a, z in zip(listed, wk.route_list_plain(t(X.T), t(lid), t(cid),
                                                t(cols), t(psrc), bundled)):
        assert torch.equal(a, z)


@pytest.mark.parametrize("f,k", [(7, 5), (8, 3), (1, 2), (13, 1)])
def test_packed_hist_plain_matches_pallas_t_and_pallas(f, k):
    """B3 on packed X_t and B4 on packed row-major X, odd and even F."""
    X, lid, w3, cid, b = wave_data(n=2600, f=f, b=16, k=k, seed=f + k)
    Xp, wq = _packed(X), _hilo_exact(w3)
    want_t = np.asarray(wave_histogram_pallas_t(
        jnp.asarray(Xp.T), jnp.asarray(lid), jnp.asarray(wq),
        jnp.asarray(cid), b, interpret=True, logical_cols=f))
    want_r = np.asarray(wave_histogram_pallas(
        jnp.asarray(Xp), jnp.asarray(lid), jnp.asarray(wq),
        jnp.asarray(cid), b, interpret=True, logical_cols=f))
    got_t = wk.wave_histogram(t(Xp.T), t(lid), t(wq), t(cid), b,
                              logical_cols=f)
    got_r = wk.wave_histogram_rowmajor(t(Xp), t(lid), t(wq), t(cid), b,
                                       logical_cols=f)
    assert got_t.shape == got_r.shape == (k, f, b, 3)
    assert_hist_close(got_t.numpy(), want_t, wq)
    assert_hist_close(got_r.numpy(), want_r, wq)
    assert torch.equal(got_t, wk.wave_histogram(t(X.T), t(lid), t(wq),
                                                t(cid), b))
    assert torch.equal(got_r, got_t)


def test_packed_routing_reads_the_nibble():
    """Route rows on packed bins, transposed and row-major: the split
    column f < Fh is the low nibble of stored column f, f >= Fh the high
    nibble of stored column f - Fh (the JAX package's predict.py
    formula), and never the padding nibble of odd F."""
    X, lid, _, _, _, cols, psrc = unbundled_case()
    f = X.shape[1]                              # 7: Fh = 4, one pad nibble
    Xp = _packed(X)
    want = wk.route_rows_plain(t(X.T), t(lid), t(cols), t(psrc))
    assert torch.equal(wk.route_rows_plain(t(Xp.T), t(lid), t(cols),
                                           t(psrc), logical_cols=f), want)
    assert torch.equal(wk.route_rows_rowmajor(t(Xp), t(lid), t(cols),
                                              t(psrc), logical_cols=f), want)
    # a split on the last feature (the high nibble of stored column 2)
    cols = cols.copy()
    cols[0, 1] = f - 1
    want = wk.route_rows_plain(t(X.T), t(lid), t(cols), t(psrc))
    assert torch.equal(wk.route_rows_plain(t(Xp.T), t(lid), t(cols),
                                           t(psrc), logical_cols=f), want)


def test_packed_wrapper_validates_the_stored_width():
    X, lid, w3, cid, b = wave_data(n=500, f=7, b=16)
    Xp = _packed(X)
    with pytest.raises(lgbt.LightGBMError, match="X_t"):
        wk.wave_histogram(t(Xp.T), t(lid), t(w3), t(cid), b, logical_cols=9)
    with pytest.raises(lgbt.LightGBMError, match="X"):
        wk.wave_histogram_rowmajor(t(X), t(lid), t(w3), t(cid), b,
                                   logical_cols=7)


# ---------------------------------------------------------------- training
def _data(seed=3, n=2500, bundled=False):
    """parity_data; bundled: its four mostly-zero exclusive columns made
    two-valued, so that their EFB group column has at most 16 bins and
    packs."""
    X, s = parity_data(seed, n, bundled)
    if bundled:
        X[:, 6:] = (X[:, 6:] != 0) * (2.0 + np.arange(4))
    return X, (s > 0).astype(float)


def _train(params, X, y, rounds=3, **kw):
    base = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
            "max_bin": 15, "verbose": -1, "tpu_growth": "wave",
            "tpu_wave_width": 4}
    return lgbt.train(dict(base, **params), lgbt.Dataset(X, label=y), rounds,
                      device="cpu", **kw)


@pytest.mark.parametrize("more", [
    {}, {"tpu_histogram_mode": "pallas_t"}, {"tpu_histogram_mode": "pallas"},
    {"tpu_fused_iter": "on"}, {"tpu_wave_order": "exact"}, NO_CACHE, SAMPLED,
    {"tpu_histogram_mode": "pallas", "tpu_fused_iter": "on"}])
@pytest.mark.parametrize("bundled", [False, True])
def test_packed_training_equals_the_byte_bins(more, bundled):
    X, y = _data(bundled=bundled)
    byte = _train(dict(more, tpu_bin_pack="false"), X, y)
    packed = _train(dict(more, tpu_bin_pack="auto"), X, y)
    lb, lp = byte._gbdt.learner, packed._gbdt.learner
    assert (packed._gbdt.train_data.bundle is not None) == bundled
    G = lb.X.shape[1 if lb.hist_mode == "pallas" else 0]
    assert lb.packed_cols == 0 and lp.packed_cols == G
    assert lp.X.numel() == (G + 1) // 2 * len(y)
    assert packed.model_to_string() == byte.model_to_string()


@pytest.mark.parametrize("params,warns", [
    ({"tpu_bin_pack": "true", "max_bin": 63}, "at most 16 bins"),
    ({"tpu_bin_pack": "true", "tpu_growth": "exact",
      "tpu_histogram_mode": "pallas"}, "wave growth"),
    ({"tpu_bin_pack": "auto", "max_bin": 63}, None),
    ({"tpu_bin_pack": "auto", "tpu_growth": "exact",
      "tpu_histogram_mode": "pallas"}, None)])
def test_packing_resolves_as_the_jax_package(params, warns, capsys):
    """What packs, and the JAX package's warning where a forced true
    cannot be honoured (not an error); exact growth never packs."""
    X, y = _data()
    booster = _train(dict(params, verbose=1), X, y, rounds=1)
    err = capsys.readouterr()
    text = err.out + err.err
    assert booster._gbdt.learner.packed_cols == 0
    if warns:
        assert "tpu_bin_pack=true ignored" in text and warns in text
    else:
        assert "tpu_bin_pack=true ignored" not in text


@pytest.mark.parametrize("width,seed", [(4, 3), (14, 5)])
def test_packed_training_grows_the_jax_oracle_trees(width, seed):
    """The ROADMAP's forced oracle path at max_bin = 15: both packages
    pack (packed_cols == F) and grow the same trees."""
    X, y = _data(seed=seed)
    params = {"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 20, "max_bin": 15, "verbose": -1,
              "tpu_growth": "wave", "tpu_wave_width": width,
              "tpu_histogram_mode": "pallas_ct",
              "tpu_pallas_interpret": True, "tpu_hist_precision": "hilo"}
    bj = lgbj.train(params, lgbj.Dataset(X, label=y), 3,
                    verbose_eval=False)
    bt = lgbt.train(params, lgbt.Dataset(X, label=y), 3, device="cpu")
    assert bj._gbdt.learner.packed_cols == X.shape[1]
    assert bt._gbdt.learner.packed_cols == X.shape[1]
    assert structure(bt.model_to_string()) == structure(bj.model_to_string())


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas"])
def test_rollback_and_dart_traverse_the_packed_bins(mode):
    """Booster.rollback_one_iter and DART's drops subtract trees by a
    traversal of the training bins: on the packed bins they give the
    unpacked run's scores to the bit."""
    X, y = _data()
    scores = {}
    for pack in ("false", "auto"):
        b = _train({"tpu_bin_pack": pack, "tpu_histogram_mode": mode}, X, y,
                   rounds=4)
        b.rollback_one_iter()
        d = _train({"tpu_bin_pack": pack, "tpu_histogram_mode": mode,
                    "boosting": "dart", "drop_rate": 0.5, "skip_drop": 0.0},
                   X, y, rounds=5)
        assert d._gbdt.learner.packed_cols == (X.shape[1] if pack == "auto"
                                               else 0)
        scores[pack] = (b._gbdt.train_score, d._gbdt.train_score,
                        d.model_to_string())
    for a, z in zip(scores["false"], scores["auto"]):
        if isinstance(a, str):
            assert a == z
        else:
            np.testing.assert_array_equal(a, z)


def test_packed_traversal_matches_the_jax_package():
    """leaf_index_binned(packed_cols=F) on the packed bins equals the JAX
    package's leaf_index_binned(packed=True) and the byte bins' leaves."""
    from lightgbm_tpu.ops import predict as jpred
    from lightgbm_tpu_torch.ops import predict as tpred

    X, y = _data()
    b = _train({}, X, y, rounds=2)
    b._gbdt._materialize()
    tree = b._gbdt.models[-1]
    Xb = b._gbdt.train_data.binned
    Xp = tpack.pack4_host(Xb)
    f = Xb.shape[1]
    ta = tpred.traversal_from_host_tree(tree, torch.device("cpu"))
    got = tpred.leaf_index_binned(ta, t(Xp), packed_cols=f)
    assert torch.equal(got, tpred.leaf_index_binned(ta, t(Xb)))
    ja = jpred.traversal_from_host_tree(tree, jnp.float32)
    want = jpred.leaf_index_binned(ja, jnp.asarray(Xp), packed=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,f,b,k", [(2_000_000, 28, 16, 32),
                                     (2_000_000, 28, 16, 1),
                                     (10_500_000, 27, 16, 32),
                                     (3000, 1, 16, 5), (5000, 968, 16, 32)])
def test_packed_launch_plan(n, f, b, k):
    """The packed plan: a block owns FS / 2 packed columns and both of
    their nibbles' features (FS even, at most the kernel's 8), the groups
    cover the ceil(F/2) packed columns, the shared histogram fits the
    budget, and the byte bins' plan is unchanged."""
    plan = wk.hist_plan(f, n, b, k, 132, True)
    _, groups, R, ks, fs, copies, smem, _ = plan
    fh = (f + 1) // 2
    assert fs % 2 == 0 and 2 <= fs <= wk._GROUP_MAX
    assert groups * fs // 2 >= fh > (groups - 1) * fs // 2
    assert smem == copies * ks * fs * b * 3 * 8 <= wk._SMEM_BUDGET
    assert 1 <= R <= 65535 and 1 <= ks <= k
    assert wk.hist_plan(f, n, b, k, 132) == wk.hist_plan(f, n, b, k, 132,
                                                         False)


def test_infiniteboost_and_continued_training_traverse_the_packed_bins():
    """InfiniteBoost's re-weighting and init_model's seeded scores apply
    host trees by traversals of the training bins: packed, the byte
    bins' scores and text."""
    X, y = _data()
    out = {}
    for pack in ("false", "auto"):
        inf = _train({"tpu_bin_pack": pack, "boosting": "infinite"}, X, y,
                     rounds=3)
        base = _train({"tpu_bin_pack": pack}, X, y, rounds=2)
        cont = _train({"tpu_bin_pack": pack}, X, y, rounds=2,
                      init_model=base)
        assert cont._gbdt.learner.packed_cols == (X.shape[1]
                                                  if pack == "auto" else 0)
        out[pack] = (inf._gbdt.train_score, inf.model_to_string(),
                     cont._gbdt.train_score, cont.model_to_string())
    for a, z in zip(out["false"], out["auto"]):
        if isinstance(a, str):
            assert a == z
        else:
            np.testing.assert_array_equal(a, z)
