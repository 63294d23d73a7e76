"""The port's Python API against the JAX package's.

* Dataset setters and getters (label, weight, group, init_score),
  ``set_field``/``get_field`` and the feature names give what the JAX
  package's give on the same inputs (exactly: the same float32/float64
  casts);
* ``subset`` over dense rows (TrainingData.subset) and over scipy sparse
  rows (SparseColumns.take_rows) gives the JAX package's binned rows and
  metadata exactly;
* ``save_binary`` files load in the other package, both ways: the same
  bins, mappers, EFB groups and metadata, and a binary file trains the
  model text of the data it was written from;
* ``attr``/``set_attr``, ``free_dataset``, pickling and ``deepcopy`` (on
  ``device="cpu"``): the same predictions to the bit, the attributes and
  the device kept; a pickle of a CUDA booster raises where there is no
  card instead of landing on the CPU;
* ``dump_model`` equals the JAX package's dict, and its JSON text the
  JAX package's characters, for every reference-written golden model.
"""
import copy
import glob
import os
import pickle

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu_torch.io.dataset import TrainingData as TTrainingData
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "golden")
PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
          "min_data_in_leaf": 10, "verbose": -1}


def _data(seed=0, n=600, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[:, 3] = np.where(rng.random(n) < 0.7, 0.0, X[:, 3])
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    return X, y


def _both(X, **kw):
    return (lgbt.Dataset(X, params=dict(PARAMS), **kw),
            lgbj.Dataset(X, params=dict(PARAMS), **kw))


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(a).dtype == np.asarray(b).dtype


def test_setters_and_getters_match_jax():
    X, y = _data()
    rng = np.random.default_rng(1)
    w = rng.random(len(y)) + 0.5
    init = rng.normal(size=len(y))
    group = np.full(6, 100)
    dt, dj = _both(X, label=y)
    for d in (dt, dj):
        d.construct()
        d.set_weight(w)
        d.set_group(group)
        d.set_init_score(init)
        d.set_feature_name(["f%d" % i for i in range(X.shape[1])])
    for getter in ("get_label", "get_weight", "get_group", "get_init_score"):
        _same(getattr(dt, getter)(), getattr(dj, getter)())
    for field in ("label", "weight", "group", "init_score"):
        _same(dt.get_field(field), dj.get_field(field))
    _same(dt._handle.metadata.query_weights, dj._handle.metadata.query_weights)
    assert dt.get_feature_name() == dj.get_feature_name() == [
        "f%d" % i for i in range(X.shape[1])]
    for d in (dt, dj):
        d.set_field("label", 1.0 - y)
        d.set_field("group", np.full(3, 200))
    for field in ("label", "group"):
        _same(dt.get_field(field), dj.get_field(field))
    # before construction the getters give what was passed
    lazy = lgbt.Dataset(X, label=y, weight=w, group=group)
    assert lazy.get_weight() is w and lazy.get_group() is group
    np.testing.assert_array_equal(lazy.get_label(), y)


@pytest.mark.parametrize("sparse", [False, True])
def test_subset_matches_jax(sparse):
    X, y = _data(2)
    w = np.random.default_rng(3).random(len(y)) + 0.5
    data = sps.csr_matrix(X) if sparse else X
    dt, dj = _both(data, label=y, weight=w)
    idx = np.sort(np.random.default_rng(4).choice(len(y), 250,
                                                  replace=False))
    st, sj = dt.subset(idx).construct(), dj.subset(idx).construct()
    assert st.used_indices is idx or np.array_equal(st.used_indices, idx)
    _same(st._handle.binned, sj._handle.binned)
    _same(st.get_label(), sj.get_label())
    _same(st.get_weight(), sj.get_weight())
    assert st.num_data() == 250
    # the subset trains the model text of the same rows binned alike
    a = lgbt.train(PARAMS, st, 2, device="cpu").model_to_string()
    b = lgbt.train(PARAMS, dt.create_valid(data[idx], label=y[idx],
                                           weight=w[idx]), 2,
                   device="cpu").model_to_string()
    assert a == b


def _same_dataset(a, b):
    assert a.num_data == b.num_data
    assert a.num_total_features == b.num_total_features
    assert list(a.used_feature_idx) == list(b.used_feature_idx)
    assert list(a.feature_names) == list(b.feature_names)
    assert a.max_bin == b.max_bin
    assert ([None if m is None else m.to_dict() for m in a.bin_mappers]
            == [None if m is None else m.to_dict() for m in b.bin_mappers])
    assert ((a.bundle is None and b.bundle is None)
            or [list(g) for g in a.bundle.groups]
            == [list(g) for g in b.bundle.groups])
    _same(a.binned, b.binned)
    for field in ("label", "weights", "query_boundaries", "init_score"):
        _same(getattr(a.metadata, field), getattr(b.metadata, field))


@pytest.mark.parametrize("bundled", [False, True])
def test_binary_files_load_across_packages(tmp_path, bundled):
    X, y = _data(5)
    if bundled:
        rng = np.random.default_rng(6)
        owner = rng.integers(0, 6, size=len(y))
        for j in range(3):
            X[:, 3 + j] = np.where(owner == j, rng.normal(size=len(y)) + 2,
                                   0.0)
    w = np.random.default_rng(7).random(len(y)) + 0.5
    dt, dj = _both(X, label=y, weight=w, group=np.full(6, 100))
    dt.save_binary(str(tmp_path / "t.bin"))
    dj.save_binary(str(tmp_path / "j.bin"))
    assert (dt._handle.bundle is not None) == bundled
    for path, written in (("t.bin", dt), ("j.bin", dj)):
        path = str(tmp_path / path)
        assert TTrainingData.can_load_binary(path)
        assert JTrainingData.can_load_binary(path)
        _same_dataset(lgbt.Dataset(path).construct()._handle,
                      written._handle)
        _same_dataset(lgbj.Dataset(path).construct()._handle,
                      written._handle)
    assert not TTrainingData.can_load_binary(
        os.path.join(GOLDEN, "binary.train"))
    want = lgbt.train(PARAMS, lgbt.Dataset(X, label=y, weight=w), 2,
                      device="cpu").model_to_string()
    got = lgbt.train(PARAMS, lgbt.Dataset(str(tmp_path / "j.bin")), 2,
                     device="cpu").model_to_string()
    # a binary dataset file carries no drift fingerprint in either package:
    # the in-memory text's drift_fingerprint= line is the one difference
    assert "\ndrift_fingerprint=" in want
    assert "drift_fingerprint=" not in got
    assert got.splitlines() == [ln for ln in want.splitlines()
                                if not ln.startswith("drift_fingerprint=")]


def _booster():
    X, y = _data(8)
    return lgbt.train(PARAMS, lgbt.Dataset(X, label=y), 3,
                      device="cpu"), X


def test_attributes_and_free_dataset():
    bst, X = _booster()
    assert bst.attr("a") is None
    bst.set_attr(a="1", b="2")
    assert (bst.attr("a"), bst.attr("b")) == ("1", "2")
    bst.set_attr(a=None)
    assert bst.attr("a") is None
    with pytest.raises(ValueError):
        bst.set_attr(c=3)
    assert bst.importance_history() == []
    assert bst.set_train_data_name("train") is bst
    assert bst.eval_train()[0][0] == "train"
    bst.free_dataset()
    # the binned data stays: training, prediction and the built-in
    # metrics go on; fobj and feval need the freed Dataset
    bst.update()
    assert bst.current_iteration() == 4
    assert bst.eval_train()
    with pytest.raises(lgbt.LightGBMError, match="free_dataset"):
        bst.eval_train(feval=lambda p, d: ("x", 0.0, False))
    with pytest.raises(lgbt.LightGBMError, match="free_dataset"):
        bst.update(fobj=lambda p, d: (p, p))


def test_pickle_and_deepcopy_predict_the_same_bits():
    bst, X = _booster()
    bst.set_attr(note="kept")
    bst.best_iteration = 2
    want = bst.predict(X, raw_score=True)
    for other in (pickle.loads(pickle.dumps(bst)), copy.deepcopy(bst),
                  copy.copy(bst)):
        assert other.device.type == "cpu"
        assert other.attr("note") == "kept"
        assert other.best_iteration == 2
        np.testing.assert_array_equal(other.predict(X, raw_score=True), want)
        assert other.model_to_string() == bst.model_to_string()
    state = bst.__getstate__()
    assert state["device"] == "cpu"
    if not torch.cuda.is_available():
        state["device"] = "cuda"
        with pytest.raises(lgbt.LightGBMError, match="needs CUDA"):
            lgbt.Booster.__new__(lgbt.Booster).__setstate__(state)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(GOLDEN,
                                                               "*.model"))),
                         ids=os.path.basename)
def test_dump_model_matches_jax(path):
    t = lgbt.Booster(model_file=path, device="cpu")
    j = lgbj.Booster(model_file=path)
    assert t._gbdt.dump_model() == j._gbdt.dump_model()
    assert t.dump_model() == j.dump_model()
    d = t.dump_model(num_iteration=1)
    assert len(d["tree_info"]) == t.num_model_per_iteration() + (
        1 if t._gbdt.boost_from_average_used else 0)
