"""Two-byte bins: ``max_bin`` > 255 through the port's kernels B1, B3, B4
and B5 (their plain versions on the CPU) against the JAX package.

A column of more than 256 bins makes the bin matrix uint16 in both
packages (EFB groups stay at most 256 bins, but a wider feature is a
group of its own).  The JAX side runs the oracle settings
(``tpu_growth=wave, tpu_wave_width=32, tpu_histogram_mode=pallas_ct |
pallas_t | pallas, tpu_pallas_interpret=true``; its exact grower runs its
Pallas leaf kernel in interpret mode by itself).  What must agree:

* the trees' partitions: split features, child pointers, leaf counts and
  decision types exactly, and the leaf of every training row
  (``pred_leaf``).  At 511 bins over 3,000 rows most bins hold a row or
  none, so a split's threshold may sit anywhere in an empty gap where
  the two packages' sums tie up to rounding: thresholds are not
  compared, the partitions they make are;
* the plain versions' histograms on uint16 bins: to the JAX package's
  ``wave_histogram_reference`` and ``leaf_histogram_scatter`` with rtol
  1e-5 and atol 1e-5 x max|w| (f32 sums in another order);
* the launch plan's bin tiles: they cover [0, B) exactly once and a
  block's shared memory stays within the budget, for B up to 65,536.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.ops.histogram import leaf_histogram_scatter
from lightgbm_tpu.ops.pallas_wave import wave_histogram_reference
from lightgbm_tpu_torch.ops import leaf_hist as lh
from lightgbm_tpu_torch.ops import wave_kernels as wk
from torch_cases import t
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

BASE = {"objective": "binary", "num_leaves": 15, "min_data_in_leaf": 20,
        "max_bin": 511, "verbose": -1}
ORACLE = {"tpu_growth": "wave", "tpu_wave_width": 32,
          "tpu_pallas_interpret": True, "tpu_hist_precision": "hilo"}
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")
MODES = ["pallas_ct", "pallas_t", "pallas", "exact"]


def wide_data(seed, n=3000):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 5))
    s = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * X[:, 4]
         + 0.2 * rng.normal(size=n))
    return X, (s > 0).astype(float)


def efb_data(seed, n=3000):
    """A 300-bin singleton, a 40-bin column and five mutually exclusive
    columns of a few bins each (one EFB group)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 7))
    X[:, 0] = rng.normal(size=n)
    X[:, 1] = rng.integers(0, 40, size=n)
    owner = rng.integers(0, 6, size=n)
    for j in range(5):
        X[:, 2 + j] = np.where(owner == j, rng.integers(1, 6, size=n), 0)
    s = (X[:, 0] + 0.05 * X[:, 1] + 0.4 * X[:, 2] - 0.3 * X[:, 4]
         + 0.2 * rng.normal(size=n))
    return X, (s > 0.5).astype(float)


def partition(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def _params(base, mode):
    """(JAX params, port params) of a mode: the oracle's wave settings,
    or exact growth with 'pallas' in both."""
    if mode == "exact":
        p = dict(base, tpu_growth="exact", tpu_histogram_mode="pallas")
        return p, p
    return (dict(base, tpu_histogram_mode=mode, **ORACLE),
            dict(base, tpu_histogram_mode=mode, tpu_growth="wave",
                 tpu_wave_width=32))


def _same_trees(X, y, pj, pt, rounds=3):
    bj = lgbj.train(pj, lgbj.Dataset(X, label=y), rounds)
    bt = lgbt.train(pt, lgbt.Dataset(X, label=y), rounds, device="cpu")
    assert bt.num_trees() == bj.num_trees() >= rounds
    assert partition(bt.model_to_string()) == partition(bj.model_to_string())
    np.testing.assert_array_equal(bt.predict(X, pred_leaf=True),
                                  bj.predict(X, pred_leaf=True))
    return bt


def test_the_bins_are_uint16_in_both_packages():
    X, y = wide_data(0)
    dj = lgbj.Dataset(X, label=y, params=BASE).construct()._handle
    dt = lgbt.Dataset(X, label=y, params=BASE).construct()._handle
    assert dt.binned.dtype == np.uint16 == np.asarray(dj.binned).dtype
    np.testing.assert_array_equal(dt.binned, np.asarray(dj.binned))
    assert int(dt.num_bin_arr.max()) > 256


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", MODES)
def test_max_bin_511_trains_the_jax_package_trees(mode, seed):
    X, y = wide_data(seed)
    bt = _same_trees(X, y, *_params(BASE, mode))
    learner = bt._gbdt.learner
    assert learner.X.dtype == torch.uint16
    want = "pallas" if mode == "exact" else mode
    assert learner.hist_mode == want
    assert learner.X.shape[0] == (len(X) if want == "pallas" else 5)


@pytest.mark.parametrize("mode", MODES)
def test_efb_with_a_wide_singleton_trains_the_jax_package_trees(mode):
    X, y = efb_data(1)
    base = dict(BASE, max_bin=300)
    dt = lgbt.Dataset(X, label=y, params=base).construct()._handle
    groups = dt.bundle.num_group_bins
    assert len(groups) < X.shape[1] and groups.max() > 256
    assert dt.binned.dtype == np.uint16
    bt = _same_trees(X, y, *_params(base, mode))
    assert bt._gbdt.learner.group_bins == groups.max()


@pytest.mark.parametrize("mode", ["pallas_ct", "pallas", "exact"])
def test_uint16_fused_equals_staged(mode):
    X, y = wide_data(2)
    p = _params(BASE, mode)[1]
    texts = [lgbt.train(dict(p, tpu_fused_iter=f), lgbt.Dataset(X, label=y),
                        3, device="cpu").model_to_string()
             for f in ("on", "off")]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("b,k", [(300, 1), (511, 4), (1023, 3),
                                 (4000, 2)])
def test_uint16_plain_versions_match_the_jax_references(b, k):
    rng = np.random.default_rng(b)
    n, f = 2500, 4
    X = rng.integers(0, b, size=(n, f)).astype(np.uint16)
    lid = rng.integers(0, 2 * k, size=n).astype(np.int32)
    w3 = rng.normal(size=(n, 3)).astype(np.float32)
    cid = rng.permutation(2 * k)[:k].astype(np.int32)
    want = np.asarray(wave_histogram_reference(
        jnp.asarray(X), jnp.asarray(lid), jnp.asarray(w3), jnp.asarray(cid),
        b))
    atol = 1e-5 * float(np.abs(w3).max())
    for got in (wk.wave_histogram(t(X.T), t(lid), t(w3), t(cid), b),
                wk.wave_histogram_rowmajor(t(X), t(lid), t(w3), t(cid), b)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)
    g, h = w3[:, 0], np.abs(w3[:, 1])
    leaf = int(cid[0])
    got = lh.leaf_histogram(t(X), t(g), t(h), t(lid), leaf, None, b)
    want = np.asarray(leaf_histogram_scatter(
        jnp.asarray(X), jnp.asarray(g), jnp.asarray(h), jnp.asarray(lid),
        leaf, None, num_bins=b))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


def test_uint16_routing_reads_two_byte_bins():
    """B1's plain routing on bins past 32,767 (an int16 would read them
    negative) in both layouts."""
    rng = np.random.default_rng(3)
    n = 1000
    X = rng.integers(30000, 65535, size=(n, 3)).astype(np.uint16)
    lid = np.zeros(n, np.int32)
    cols = np.array([[1, 2, 50000, 0, 0, 0, 1, 0, 0, 65535]], np.float32)
    psrc = np.zeros(1, np.int32)
    want = np.where(X[:, 2] <= 50000, 0, 1)
    for got in (wk.route_rows_plain(t(X.T), t(lid), t(cols), t(psrc)),
                wk.route_rows_rowmajor(t(X), t(lid), t(cols), t(psrc))):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("B", [256, 1024, 9387, 16383, 65536])
def test_hist_plan_bin_tiles_cover_every_bin_once(B, wide):
    for F, K in ((28, 32), (4, 1), (3, 8)):
        plan = wk.hist_plan(F, 2_000_000, B, K, 132, False, wide)
        _, groups, _, ks, fs, copies, smem, _ = plan
        tiles = wk.bin_tiles(F, B, groups, fs)
        covered = np.zeros(B, int)
        for b0, b1 in tiles:
            covered[b0:b1] += 1
        assert (covered == 1).all()
        bt = max(b1 - b0 for b0, b1 in tiles)
        assert smem == copies * ks * fs * bt * 3 * (16 if wide else 8)
        assert smem <= wk._SMEM_BUDGET
        assert (len(tiles) > 1) == (B * 3 * (16 if wide else 8)
                                    > wk._SMEM_BUDGET)


def test_uint16_wrappers_check_their_bin_counts():
    """uint16 bins take up to 65,536 bins, uint8 ones 256, packed ones
    only uint8."""
    X = torch.zeros((3, 10), dtype=torch.uint16)
    lid = torch.zeros(10, dtype=torch.int32)
    w3 = torch.ones((10, 3))
    cid = torch.zeros(1, dtype=torch.int32)
    assert wk.wave_histogram(X, lid, w3, cid, 65536).shape == (1, 3, 65536,
                                                               3)
    with pytest.raises(wk.LightGBMError, match="65536"):
        wk.wave_histogram(X, lid, w3, cid, 65537)
    with pytest.raises(wk.LightGBMError, match="256"):
        wk.wave_histogram(X.to(torch.uint8), lid, w3, cid, 300)
    with pytest.raises(wk.LightGBMError, match="packed"):
        wk.wave_histogram(X, lid, w3, cid, 16, logical_cols=6)


def test_uint16_directory_pages_its_shards(tmp_path):
    """A pre-binned directory of uint16 bins pages to the device in its
    dtype and trains the in-memory dataset's model."""
    X, y = wide_data(4)
    p = dict(BASE, tpu_histogram_mode="pallas_ct", tpu_growth="wave",
             tpu_wave_width=32)
    lgbt.Dataset(X, label=y, params=p).save_binned(str(tmp_path / "d"))
    bd = lgbt.train(p, str(tmp_path / "d"), 3, device="cpu")
    bm = lgbt.train(p, lgbt.Dataset(X, label=y), 3, device="cpu")
    learner = bd._gbdt.learner
    assert learner.upload_stats["paged"]
    assert learner.X.dtype == torch.uint16
    assert learner.upload_stats["bytes"] == 2 * X.size
    assert partition(bd.model_to_string()) == partition(bm.model_to_string())


def test_the_sparse_store_takes_wide_bins():
    """The entry-chunk store's entries hold int32 bins, so max_bin 300 on
    CSR input needs no more than the learner's refusal lifted: the port
    grows the JAX package's trees (partitions) through B6's plain
    version."""
    import scipy.sparse as sps
    rng = np.random.default_rng(6)
    n, f = 2500, 8
    X = np.where(rng.random((n, f)) < 0.3, rng.normal(size=(n, f)), 0.0)
    X[:, 0] = rng.normal(size=n)
    y = (X[:, 0] + 0.7 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(
        float)
    p = dict(BASE, max_bin=300, tpu_sparse=True, tpu_sparse_kernel=True,
             tpu_growth="wave", tpu_wave_width=4)
    C = sps.csr_matrix(X)
    bj = lgbj.train(p, lgbj.Dataset(C, label=y), 3)
    bt = lgbt.train(p, lgbt.Dataset(C, label=y), 3, device="cpu")
    learner = bt._gbdt.learner
    assert learner.hist_mode == "sparse_mxu" and learner.num_bins > 256
    assert partition(bt.model_to_string()) == partition(bj.model_to_string())
    np.testing.assert_array_equal(bt.predict(C, pred_leaf=True),
                                  bj.predict(C, pred_leaf=True))
