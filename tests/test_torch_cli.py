"""The port's command line and file path against the JAX package's.

``lightgbm_tpu.cli.main`` and ``lightgbm_tpu_torch.cli.main`` run
in-process on copies of ``tests/data/golden`` (TSV data, models and
predictions written by the unmodified reference CLI) and of
``examples/binary_classification`` (the reference's own train.conf), both
with ``device_type=cpu``, ``num_trees=5`` and the oracle's wave params.

What must agree, and how closely:

* trees: split features, child pointers, leaf counts and decision types
  exactly, against the oracle (``tpu_histogram_mode=pallas_ct``,
  ``tpu_pallas_interpret=true``) and against its f32 ``onehot`` mode;
  leaf values to rtol 1e-5 against ``onehot``, with atol 1e-5 x the
  largest leaf for leaves of balanced labels near 0 (ROADMAP's standing
  notes: balanced leaves differ by up to 7e-5 relative).  Thresholds may
  differ
  where the split's bin gap is empty in the training rows (the binary
  files have such gaps): the partitions must agree, so the training rows'
  leaf indices under both models are compared instead of the threshold
  values.  On the multiclass file, near-tie splits flip at 15 and 31
  leaves between the JAX package's own two modes, so it trains 7 leaves;
* predictions of the reference-written models: the output files equal,
  text for text, and within rtol 1e-6 of the reference's ``.pred``;
* the C++ converter's code compiles and predicts the model's scores; the
  PMML document is well formed and equals the JAX package's;
* the file options (side files, label by name, header, ignored and
  categorical columns) give the JAX package's bins and metadata.
"""
import ctypes
import os
import shutil
import subprocess
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu.cli as jcli
import lightgbm_tpu_torch as lgbt
import lightgbm_tpu_torch.cli as tcli
from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch.io.dataset import TrainingData as TTrainingData
from lightgbm_tpu_torch.utils.config import Config as TConfig
from lightgbm_tpu_torch.utils.log import LightGBMError
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")
EXAMPLE = os.path.join(os.path.dirname(HERE), "examples",
                       "binary_classification")

COMMON = ["device_type=cpu", "num_trees=5", "verbose=-1", "tpu_growth=wave",
          "tpu_wave_width=32"]
ORACLE = ["tpu_histogram_mode=pallas_ct", "tpu_pallas_interpret=true",
          "tpu_hist_precision=hilo"]
F32 = ["tpu_histogram_mode=onehot"]
STRUCTURE = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


@pytest.fixture
def work(tmp_path, monkeypatch):
    for name in os.listdir(GOLDEN):
        shutil.copy(os.path.join(GOLDEN, name), tmp_path)
    ex = tmp_path / "example"
    shutil.copytree(EXAMPLE, ex)
    monkeypatch.chdir(tmp_path)
    return tmp_path


def _structure(text):
    return [ln for ln in text.splitlines() if ln.startswith(STRUCTURE)]


def _leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value")])


def _load_tsv(path):
    data = np.loadtxt(path, delimiter="\t", ndmin=2)
    return data[:, 1:], data[:, 0]


def _leaves(text, X):
    return lgbt.Booster(model_str=text, device="cpu").predict(
        X, pred_leaf=True)


def _train_both(args, out, f32=True):
    """The port's model text, the oracle's and (f32) the onehot run's."""
    jcli.main(args + ORACLE + ["output_model=%s.oracle" % out])
    if f32:
        jcli.main(args + F32 + ["output_model=%s.f32" % out])
    tcli.main(args + ORACLE + ["output_model=%s.port" % out])
    return [open("%s.%s" % (out, k)).read() if k != "f32" or f32 else None
            for k in ("port", "oracle", "f32")]


def _assert_same_trees(port, oracle, f32, X):
    """The oracle's trees and partitions; leaf values to the f32 run's
    (f32 None: to the oracle's, within its bf16 hi/lo rounding, 1e-3 of
    the largest leaf)."""
    assert port.count("Tree=") == oracle.count("Tree=") > 0
    assert _structure(port) == _structure(oracle)
    # the thresholds' partitions of the training rows
    np.testing.assert_array_equal(_leaves(port, X), _leaves(oracle, X))
    if f32 is None:
        want = _leaf_values(oracle)
        np.testing.assert_allclose(_leaf_values(port), want, rtol=0,
                                   atol=1e-3 * np.abs(want).max())
        return
    assert _structure(port) == _structure(f32)
    want = _leaf_values(f32)
    np.testing.assert_allclose(_leaf_values(port), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


CASES = {"binary": ["objective=binary", "metric=binary_logloss,auc"],
         "regression": ["objective=regression", "metric=l2"],
         "multiclass": ["objective=multiclass", "num_class=3",
                        "metric=multi_logloss", "num_leaves=7"]}


@pytest.mark.parametrize("task", sorted(CASES))
def test_cli_trains_the_jax_trees_on_golden_files(work, task):
    args = (["task=train", "data=%s.train" % task,
             "valid_data=%s.test" % task, "max_bin=63",
             "is_training_metric=true"] + CASES[task] + COMMON)
    port, oracle, f32 = _train_both(args, task)
    X, _ = _load_tsv("%s.train" % task)
    _assert_same_trees(port, oracle, f32, X)
    # K trees an iteration; regression's first is boost_from_average's stub
    trees = {"binary": 5, "regression": 6, "multiclass": 15}[task]
    assert port.count("Tree=") == trees


def test_cli_trains_the_reference_example_config(work, monkeypatch):
    """The reference's examples/binary_classification/train.conf, with the
    command line winning over the file (num_trees, output_model).  At its
    255 bins the JAX package's f32 onehot run flips a near-tie split of
    the third tree that the oracle and the port make alike, so leaf values
    are held to the oracle's.  (Its data is golden/binary.train, which the
    test above holds to the onehot run at 63 bins.)"""
    monkeypatch.chdir(work / "example")
    port, oracle, _ = _train_both(["config=train.conf"] + COMMON, "example",
                                  f32=False)
    X, _ = _load_tsv("binary.train")
    _assert_same_trees(port, oracle, None, X)
    assert not os.path.exists("LightGBM_model.txt")


@pytest.mark.parametrize("task", ["binary", "regression", "multiclass"])
def test_cli_predicts_reference_models_as_jax(work, task):
    args = ["task=predict", "input_model=%s.model" % task,
            "data=%s.test" % task, "device_type=cpu", "verbose=-1"]
    jcli.main(args + ["output_result=jax.pred"])
    tcli.main(args + ["output_result=port.pred"])
    port = open("port.pred").read()
    assert port == open("jax.pred").read()
    got = np.loadtxt("port.pred", ndmin=2)
    ref = np.loadtxt("%s.pred" % task, ndmin=2).reshape(got.shape)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    if task == "multiclass":
        assert got.shape == (400, 3) and "\t" in port.splitlines()[0]


def test_cli_predict_raw_and_leaf_index(work):
    args = ["task=predict", "input_model=binary.model", "data=binary.test",
            "device_type=cpu", "verbose=-1"]
    for extra in (["predict_raw_score=true"], ["predict_leaf_index=true"]):
        jcli.main(args + extra + ["output_result=jax.pred"])
        tcli.main(args + extra + ["output_result=port.pred"])
        assert open("port.pred").read() == open("jax.pred").read()


def test_convert_model_compiles_and_predicts(work):
    tcli.main(["task=convert_model", "input_model=binary.model",
               "convert_model=gen.cpp", "verbose=-1"])
    jcli.main(["task=convert_model", "input_model=binary.model",
               "convert_model=gen_jax.cpp", "verbose=-1"])
    assert open("gen.cpp").read() == open("gen_jax.cpp").read()
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "gen.cpp", "-o",
                    str(work / "gen.so")], check=True)
    lib = ctypes.CDLL(str(work / "gen.so"))
    lib.LGBMTPU_GenPredictRaw.restype = None
    X, _ = _load_tsv("binary.test")
    want = lgbt.Booster(model_file="binary.model", device="cpu").predict(
        X, raw_score=True)
    out = np.zeros(1)
    for i in range(0, len(X), 7):
        row = np.ascontiguousarray(X[i], dtype=np.float64)
        lib.LGBMTPU_GenPredictRaw(
            row.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        assert round(out[0], 5) == round(want[i], 5)


@pytest.mark.parametrize("task", ["binary", "multiclass"])
def test_pmml_is_well_formed_and_equals_jax(work, task):
    from lightgbm_tpu.pmml import convert_model_file_to_pmml as jpmml
    from lightgbm_tpu_torch.pmml import convert_model_file_to_pmml
    convert_model_file_to_pmml("%s.model" % task, "port.pmml")
    jpmml("%s.model" % task, "jax.pmml")
    text = open("port.pmml").read()
    assert text == open("jax.pmml").read()
    root = ET.fromstring(text)
    segs = root.findall(".//{http://www.dmg.org/PMML-4_2}Segment")
    assert len(segs) == open("%s.model" % task).read().count("Tree=")
    assert text == lgbt.model_to_pmml(
        lgbt.Booster(model_file="%s.model" % task, device="cpu")._gbdt)


def _header_file(path, rng, n=600):
    """A CSV with a header: an integer categorical column, the label in
    the fourth column, a column to ignore."""
    X = rng.normal(size=(n, 5))
    X[:, 1] = rng.integers(0, 6, n)
    y = ((X[:, 0] + (X[:, 1] == 2) - 0.5 * X[:, 4]) > 0).astype(float)
    cols = [X[:, 0], X[:, 1], X[:, 2], y, X[:, 3], X[:, 4]]
    names = ["a", "cat", "noise", "target", "b", "c"]
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        for row in np.column_stack(cols):
            f.write(",".join("%.17g" % v for v in row) + "\n")
    return X, y


FILE_OPTIONS = {"has_header": "true", "label_column": "name:target",
                "ignore_column": "name:noise", "categorical_column": "name:cat",
                "max_bin": "63", "min_data_in_leaf": "5"}


def test_file_options_bin_as_jax(work):
    _header_file("h.csv", np.random.default_rng(0))
    got = TTrainingData.from_file("h.csv", TConfig(dict(FILE_OPTIONS)))
    want = JTrainingData.from_file("h.csv", JConfig(dict(FILE_OPTIONS)))
    assert got.feature_names == want.feature_names == ["a", "cat", "b", "c"]
    assert got.binned.tobytes() == np.asarray(want.binned).tobytes()
    np.testing.assert_array_equal(got.metadata.label, want.metadata.label)
    np.testing.assert_array_equal(got.is_categorical_arr,
                                  want.is_categorical_arr)
    assert got.is_categorical_arr.tolist() == [False, True, False, False]
    assert got.feature_infos() == want.feature_infos()
    # the label by index, no header: the same label column
    np.savetxt("plain.csv", np.loadtxt("h.csv", delimiter=",", skiprows=1),
               delimiter=",", fmt="%.17g")
    by_index = TTrainingData.from_file("plain.csv", TConfig(
        {"label_column": "3", "max_bin": "63"}))
    np.testing.assert_array_equal(by_index.metadata.label,
                                  want.metadata.label)


def test_file_options_train_as_jax(work):
    X, _ = _header_file("h.csv", np.random.default_rng(1))
    args = (["task=train", "data=h.csv", "objective=binary",
             "num_leaves=7"] + ["%s=%s" % kv for kv in FILE_OPTIONS.items()]
            + COMMON)
    port, oracle, f32 = _train_both(args, "h")
    assert "feature_names=a cat b c" in port
    _assert_same_trees(port, oracle, f32, X[:, [0, 1, 3, 4]])


def _side_files(work, rng):
    X, y = _load_tsv("binary.train")
    np.savetxt("binary.train.weight", rng.uniform(0.5, 2.0, len(y)),
               fmt="%.17g")
    np.savetxt("binary.train.init", rng.normal(size=len(y)) * 0.3,
               fmt="%.17g")
    return X, y


def test_side_files_load_as_jax(work):
    _side_files(work, np.random.default_rng(2))
    got = TTrainingData.from_file("binary.train", TConfig({}))
    want = JTrainingData.from_file("binary.train", JConfig({}))
    for name in ("weight", "init_score"):
        assert got.metadata.get_field(name) is not None
        np.testing.assert_array_equal(got.metadata.get_field(name),
                                      want.metadata.get_field(name))
    # a .query file loads, and lambdarank trains on its queries
    # (tests/test_torch_lambdarank.py holds those trees to the JAX CLI's)
    q = TTrainingData.from_file("lambdarank.train", TConfig({}))
    qj = JTrainingData.from_file("lambdarank.train", JConfig({}))
    np.testing.assert_array_equal(q.metadata.query_boundaries,
                                  qj.metadata.query_boundaries)
    assert q.metadata.num_queries() == qj.metadata.num_queries() > 1
    tcli.main(["task=train", "data=lambdarank.train", "objective=lambdarank",
               "output_model=rank.txt"] + COMMON)
    text = open("rank.txt").read()
    assert "objective=lambdarank" in text and text.count("Tree=") == 5


def test_side_files_train_as_jax(work):
    X, _ = _side_files(work, np.random.default_rng(3))
    args = (["task=train", "data=binary.train", "objective=binary",
             "num_leaves=7", "max_bin=63"] + COMMON)
    port, oracle, f32 = _train_both(args, "side")
    _assert_same_trees(port, oracle, f32, X)


def test_dataset_and_predict_from_a_path(work):
    X, y = _header_file("h.csv", np.random.default_rng(4))
    params = dict(FILE_OPTIONS, objective="binary", num_leaves=7,
                  verbose=-1)
    ds = lgbt.Dataset("h.csv", params=params)
    assert ds.num_data() == 600 and ds.num_feature() == 4
    np.testing.assert_array_equal(ds.get_label(), y)
    bst = lgbt.train(params, ds, 3, device="cpu")
    X4 = X[:, [0, 1, 3, 4]]
    want = bst.predict(X4)
    # a file to predict: the header skipped, its first column the label
    with open("p.csv", "w") as f:
        f.write("label,a,cat,b,c\n")
        for yy, row in zip(y, X4):
            f.write(",".join("%.17g" % v for v in (yy, *row)) + "\n")
    np.testing.assert_array_equal(bst.predict("p.csv", data_has_header=True),
                                  want)
    # a valid set from a path, binned with the training set's mappers
    valid = ds.create_valid("h.csv")
    assert valid.construct()._handle.binned.tobytes() == \
        ds._handle.binned.tobytes()


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(work):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the error path cannot run")
    args = ["task=train", "data=binary.train", "num_trees=1",
            "output_model=m.txt", "verbose=-1"]
    with pytest.raises(LightGBMError, match="needs CUDA"):
        tcli.main(args)
    with pytest.raises(LightGBMError, match="needs CUDA"):
        tcli.main(args + ["device_type=gpu"])
    tcli.main(args + ["device=cpu"])
    assert open("m.txt").read().startswith("tree\n")
    with pytest.raises(LightGBMError, match="needs CUDA"):
        tcli.main(["task=predict", "input_model=m.txt", "data=binary.test",
                   "output_result=p.txt"])


@pytest.mark.parametrize("argv,match", [
    # the distributed learners are ported; a learner no package has is
    # refused by name
    (["task=train", "data=binary.train", "tree_learner=mesh"],
     "tree learner"),
    # a task no package has (lint is a subcommand of its own now:
    # tests/test_torch_lint.py)
    (["task=refit"], "Unknown task"),
    # one torch.profiler at a time: the whole-run trace and the window
    (["task=train", "data=binary.train", "tpu_profile_dir=prof",
      "obs_trace_iters=0:1", "obs_trace_dir=tr"], "tpu_profile_dir"),
    (["task=train", "data=binary.train", "obs_events_path=."],
     "obs_events_path"),
    # a directory opens only as a pre-binned dataset
    (["task=train", "data=.", "device_type=cpu"], "directory")])
def test_cli_refuses_what_the_port_lacks(work, argv, match):
    with open("sparse.svm", "w") as f:
        f.write("1 0:0.5 3:1.25\n0 1:2.0\n1 2:0.75 3:0.5\n")
    with pytest.raises(LightGBMError, match=match):
        tcli.main(argv + ["device_type=cpu"])


def test_cli_ooc_binned_dir_on_libsvm_trains_in_memory(work, capsys):
    """Two-round streaming reads dense text only: asked for a directory
    of a LibSVM file, both packages parse it in memory and write no
    directory; the port warns that it writes none."""
    with open("sparse.svm", "w") as f:
        f.write("1 0:0.5 3:1.25\n0 1:2.0\n1 2:0.75 3:0.5\n0 0:1.5\n")
    args = ["task=train", "data=sparse.svm", "ooc_binned_dir=svm_binned",
            "num_trees=1", "min_data_in_leaf=1", "verbose=1"]
    tcli.main(args + ["device_type=cpu", "output_model=t.txt"])
    err = capsys.readouterr()
    assert "no directory is written" in err.out + err.err
    assert not os.path.exists("svm_binned")
    jcli.main(args + ["device_type=cpu", "output_model=j.txt"])
    assert not os.path.exists("svm_binned")
    for name in ("t.txt", "j.txt"):
        assert open(name).read().startswith("tree\n")


def test_python_dash_m_entry_point(work):
    """``python -m lightgbm_tpu_torch`` with a config file on the CPU."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(HERE),
               OMP_NUM_THREADS="1")
    with open("t.conf", "w") as f:
        f.write("task = train\ndata = regression.train\n"
                "objective = regression  # a comment\nnum_trees = 2\n")
    out = subprocess.run(
        [os.sys.executable, "-m", "lightgbm_tpu_torch", "config=t.conf",
         "device_type=cpu", "output_model=cli.txt", "num_leaves=7",
         "verbose=-1"], env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    text = open("cli.txt").read()
    # boost_from_average's stub tree and two more
    assert text.count("Tree=") == 3 and "objective=regression" in text
