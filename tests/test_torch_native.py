"""The port's host library (lightgbm_tpu_torch/native.py over
csrc/host/native.cpp) against its Python fallbacks and the JAX package's
native results, and the device predictor's cache against the current
model after a rollback.

Binning, value->bin and raw scores must be equal to the fallback's (raw
scores within rtol 1e-15: both sum the trees in the same order, so they
are the same bits); parsing within 1e-12 of the Python parser.
"""
import os

import numpy as np
import pytest

import jax

from lightgbm_tpu import native as jnative
from lightgbm_tpu.io.binning import BinMapper as JBinMapper
from lightgbm_tpu_torch import native
from lightgbm_tpu_torch.io import parser
from lightgbm_tpu_torch.io.binning import NUMERICAL, BinMapper
from lightgbm_tpu_torch.models.tree import Tree
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _values(seed, n=5000):
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=n) * (rng.random(n) > 0.3)   # some zeros
    vals[rng.random(n) < 0.01] = np.nan
    if seed % 2:
        vals = np.round(vals, 1)                         # repeated values
    return vals[vals != 0.0]


def test_library_builds_under_the_port_build_dir():
    assert native.available()
    path = native.lib_path
    assert path.parent == native.BUILD_DIR
    assert native.BUILD_DIR == (
        __import__("pathlib").Path(REPO) / "lightgbm_tpu_torch" / "_build")
    assert path.name.startswith("liblgbt_native_")
    assert path.exists()


@pytest.mark.parametrize("seed", range(6))
def test_find_bin_matches_fallback_and_jax_native(seed):
    vals = _values(seed)
    total = 5000
    mn = BinMapper()
    mn.find_bin(vals, total, 63, 3, 5, NUMERICAL)
    with native.disabled():
        mp = BinMapper()
        mp.find_bin(vals, total, 63, 3, 5, NUMERICAL)
    mj = JBinMapper()
    mj.find_bin(vals, total, 63, 3, 5, NUMERICAL)
    for other in (mp, mj):
        assert mn.num_bin == other.num_bin
        np.testing.assert_array_equal(mn.bin_upper_bound,
                                      other.bin_upper_bound)
        assert mn.is_trivial == other.is_trivial
        assert mn.default_bin == other.default_bin
        assert mn.min_val == other.min_val and mn.max_val == other.max_val
        assert mn.sparse_rate == other.sparse_rate
    if jnative.available():
        res = jnative.find_bin_numerical(vals, total, 63, 3, 5)
        np.testing.assert_array_equal(res[0], mn.bin_upper_bound)
        assert res[1:] == (mn.is_trivial, mn.min_val, mn.max_val,
                           mn.default_bin, mn.sparse_rate)


@pytest.mark.parametrize("max_bin,mdib,msd", [(255, 1, 1), (15, 3, 50),
                                              (63, 0, 1000)])
def test_find_bin_edge_settings(max_bin, mdib, msd):
    """Few bins, a large min_data_in_bin and a filter that makes the
    feature trivial: the native and Python bins agree."""
    vals = _values(7, 3000)
    got, want = BinMapper(), BinMapper()
    got.find_bin(vals, 3000, max_bin, mdib, msd, NUMERICAL)
    with native.disabled():
        want.find_bin(vals, 3000, max_bin, mdib, msd, NUMERICAL)
    np.testing.assert_array_equal(got.bin_upper_bound, want.bin_upper_bound)
    assert (got.is_trivial, got.default_bin) == (want.is_trivial,
                                                 want.default_bin)


@pytest.mark.parametrize("seed", range(3))
def test_value_to_bin_matches_python(seed):
    rng = np.random.default_rng(seed)
    m = BinMapper()
    m.find_bin(_values(seed), 5000, 63, 3, 5, NUMERICAL)
    xs = rng.normal(size=(40, 25)) * 2
    xs[0, :5] = [0.0, 1e-21, -1e-21, np.nan, np.inf]
    got = native.value_to_bin(m.bin_upper_bound, xs)
    assert got.shape == xs.shape and got.dtype == np.int64
    np.testing.assert_array_equal(got, m.value_to_bin(xs))


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)
    return str(path)


@pytest.mark.parametrize("fmt", ["tsv", "csv", "space"])
def test_parse_file_matches_python_dense(tmp_path, fmt):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(50, 4))
    y = rng.integers(0, 2, 50)
    sep = {"tsv": "\t", "csv": ",", "space": " "}[fmt]
    path = str(tmp_path / ("data." + fmt))
    np.savetxt(path, np.column_stack([y, X]), fmt="%.17g", delimiter=sep)
    feat, lab = native.parse_file(path, False, 0)
    parsed = parser.parse_file(path)
    assert parsed.format == fmt
    np.testing.assert_allclose(feat, parsed.features, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lab, parsed.label, rtol=0, atol=1e-12)
    # with a header line, and the label in another column
    with open(path) as f:
        body = f.read()
    hpath = _write(tmp_path / ("h." + fmt),
                   sep.join("c%d" % i for i in range(5)) + "\n" + body)
    feat, lab = native.parse_file(hpath, True, 2)
    parsed = parser.parse_file(hpath, has_header=True, label_idx=2)
    np.testing.assert_allclose(feat, parsed.features, rtol=0, atol=1e-12)
    np.testing.assert_allclose(lab, parsed.label, rtol=0, atol=1e-12)


def test_parse_file_matches_python_libsvm(tmp_path):
    path = _write(tmp_path / "data.svm",
                  "1 0:0.5 3:-1.25 7:2\n0 2:3.5\n1 1:1e-3 7:-0.5\n"
                  "0 0:1 1:2 2:3 3:4\n")
    feat, lab = native.parse_file(path, False, 0)
    parsed = parser.parse_file(path)
    assert parsed.format == "libsvm"
    np.testing.assert_array_equal(feat, parsed.features)
    np.testing.assert_array_equal(lab, parsed.label)
    assert feat.shape == (4, 8)


def _tree():
    t = Tree(4)
    t.split(0, 0, False, 1, 0, 0.5, -1.0, 1.0, 10, 20, 5.0, 0, 0, 0.0)
    t.split(1, 2, False, 3, 2, -0.2, 0.5, 2.0, 8, 12, 3.0, 1, 1, 0.0)
    t.split(0, 1, False, 2, 1, 0.1, -0.3, 0.7, 4, 6, 1.0, 0, 0, 0.25)
    return t


def test_native_predict_matches_python():
    t = _tree()
    rng = np.random.default_rng(1)
    X = rng.normal(size=(100, 3))
    X[::7, 0] = 0.0   # the zero-redirect rows
    X[::5, 1] = 1e-21
    py = t.predict(X)
    nat = native.predict_raw([(t, 0)], 1, X)
    np.testing.assert_allclose(nat[:, 0], py, rtol=1e-15)


def test_booster_host_path_equals_python_trees():
    """predict_raw(allow_device=False) on a trained multiclass booster:
    the native sums equal the Python trees' (rtol 1e-15)."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.default_rng(3)
    X = rng.normal(size=(600, 5))
    X[::9, 2] = 0.0
    y = (X[:, 0] > 0).astype(int) + (X[:, 1] > 0.5)
    bst = lgb.train({"objective": "multiclass", "num_class": 3,
                     "num_leaves": 7, "verbose": -1},
                    lgb.Dataset(X, label=y), 4, device="cpu")
    got = bst._gbdt.predict_raw(X, allow_device=False)
    with native.disabled():
        want = bst._gbdt.predict_raw(X, allow_device=False)
    assert got.shape == (600, 3)
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=0)


def test_dataset_bins_equal_with_native_and_fallback():
    import lightgbm_tpu_torch as lgb
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 6))
    X[rng.random(X.shape) < 0.2] = 0.0
    X[:, 5] = np.round(X[:, 5], 1)
    y = (X[:, 0] > 0).astype(float)
    a = lgb.Dataset(X, label=y, params={"max_bin": 63}).construct()._handle
    with native.disabled():
        b = lgb.Dataset(X, label=y,
                        params={"max_bin": 63}).construct()._handle
    assert a.binned.tobytes() == b.binned.tobytes()
    for ma, mb in zip(a.bin_mappers, b.bin_mappers):
        np.testing.assert_array_equal(ma.bin_upper_bound, mb.bin_upper_bound)


def test_missing_compiler_falls_back_with_a_warning(monkeypatch, capsys):
    """Only a missing compiler leads to the Python fallback: a fresh
    lookup with no compiler and no built library warns once."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_compiler", lambda: None)
    monkeypatch.setattr(native, "_digest", lambda: "no-such-build")
    assert native.get_lib() is None
    assert native.find_bin_numerical(np.ones(3), 3, 63, 1, 1) is None
    assert "no C++ compiler" in capsys.readouterr().err


def test_build_error_raises_with_the_command(monkeypatch, tmp_path):
    """A compile error of the port's own source raises, naming the
    command and the compiler's output; it never falls back."""
    from lightgbm_tpu_torch.utils.log import LightGBMError
    bad = tmp_path / "host"
    bad.mkdir()
    (bad / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE_DIR", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(LightGBMError, match="broken.cpp") as err:
        native.build()
    assert "$ " in str(err.value) and "error" in str(err.value)


@pytest.mark.parametrize("boosting", [
    {}, {"boosting": "dart", "drop_rate": 0.9, "skip_drop": 0.0,
         "drop_seed": 4}])
def test_device_predictor_follows_rollback_and_update(boosting):
    """3 rounds, a predict through the ranked traversal (tpu_predict=true),
    rollback_one_iter, a new learning rate, one more round: the device
    path predicts the current model (within 2e-6 of the f64 host trees),
    not the cached one of the same tree count.  DART drops (and so
    rescales) earlier trees in the new round too."""
    import lightgbm_tpu_torch as lgb
    rng = np.random.default_rng(5)
    X = rng.normal(size=(800, 5))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    params = {"objective": "binary", "num_leaves": 7, "verbose": -1,
              "tpu_predict": "true", **boosting}
    bst = lgb.train(params, lgb.Dataset(X, label=y), 3, device="cpu")
    gbdt = bst._gbdt
    before = bst.predict(X, raw_score=True)
    gen = gbdt.model_generation
    bst.rollback_one_iter()
    bst.reset_parameter({"learning_rate": 0.9})
    bst.update()
    assert gbdt.model_generation > gen
    assert bst.num_trees() == 3
    dev = bst.predict(X, raw_score=True)
    gbdt.config.tpu_predict = "false"
    host = bst.predict(X, raw_score=True)
    assert np.abs(host - before).max() > 1e-3      # the model did change
    np.testing.assert_allclose(dev, host, rtol=0, atol=2e-6)
