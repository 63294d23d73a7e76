"""The port's LGBM_* API surface (lightgbm_tpu_torch/c_api.py): the flows
of the JAX package's tests/test_c_api.py (the reference's
tests/c_api_test/test.py) on the port, on the CPU (LGBM_SetDevice), and
its boosters against ``lightgbm_tpu_torch.train`` and the JAX package's
c_api.

A booster trained through the API writes ``train``'s model text to the
byte.  Against the JAX package's c_api on the oracle config of ROADMAP
(``tpu_histogram_mode=pallas_ct``, ``tpu_pallas_interpret=true``, hi/lo
precision) the trees' structure is equal; leaf values agree to rtol 1e-5
with the f32 ``onehot`` run, with atol 1e-5 x the largest leaf for
balanced leaves near 0 (ROADMAP C, standing notes).
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu import c_api as jc_api
from lightgbm_tpu_torch import c_api
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.utils.log import LightGBMError

jax.config.update("jax_platforms", "cpu")

STRUCTURE = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")
WAVE = "tpu_growth=wave tpu_wave_width=32"
ORACLE = "tpu_histogram_mode=pallas_ct tpu_pallas_interpret=true " \
         "tpu_hist_precision=hilo"
F32 = "tpu_histogram_mode=onehot"


@pytest.fixture(autouse=True, scope="module")
def on_the_cpu():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    c_api.LGBM_SetDevice("cpu")
    yield
    c_api.LGBM_SetDevice("cuda")
    torch.set_num_threads(threads)


def make_data(seed=0, n=600, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.3 * X[:, 1] > 0).astype(np.float64)
    return X, y


def structure(text):
    return [ln for ln in text.splitlines() if ln.startswith(STRUCTURE)]


def trees(text):
    """Each tree's lines, without its Tree=i header."""
    body = text.split("feature importances:")[0]
    return [blk.split("\n", 1)[1].strip() for blk in body.split("Tree=")[1:]]


def leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value")])


def test_dataset_roundtrip(tmp_path):
    X, y = make_data()
    h = c_api.LGBM_DatasetCreateFromMat(X, "max_bin=63", label=y)
    assert c_api.LGBM_DatasetGetNumData(h) == 600
    assert c_api.LGBM_DatasetGetNumFeature(h) == 6
    c_api.LGBM_DatasetSetField(h, "weight", np.ones(600))
    assert len(c_api.LGBM_DatasetGetField(h, "weight")) == 600
    path = str(tmp_path / "ds.bin")
    c_api.LGBM_DatasetSaveBinary(h, path)
    h2 = c_api.LGBM_DatasetCreateFromFile(path)
    assert c_api.LGBM_DatasetGetNumData(h2) == 600
    c_api.LGBM_DatasetFree(h)
    c_api.LGBM_DatasetFree(h2)
    with pytest.raises(LightGBMError, match="Invalid handle"):
        c_api.LGBM_DatasetGetNumData(h)


def test_dataset_from_a_binned_directory_and_text_file(tmp_path):
    X, y = make_data(seed=4)
    out = str(tmp_path / "binned")
    lgbt.Dataset(X, label=y, params={"max_bin": 63}).save_binned(out)
    h = c_api.LGBM_DatasetCreateFromFile(out, "max_bin=63")
    assert c_api.LGBM_DatasetGetNumData(h) == 600
    path = str(tmp_path / "d.tsv")
    np.savetxt(path, np.column_stack([y, X]), delimiter="\t", fmt="%.17g")
    h2 = c_api.LGBM_DatasetCreateFromFile(
        path, "max_bin=63 use_two_round_loading=true")
    params = "objective=binary verbose=-1 num_leaves=15 max_bin=63"
    texts = []
    for ds in (h, h2):
        bst = c_api.LGBM_BoosterCreate(ds, params)
        for _ in range(3):
            c_api.LGBM_BoosterUpdateOneIter(bst)
        texts.append(c_api.LGBM_BoosterSaveModelToString(bst))
    want = lgbt.train({"objective": "binary", "verbose": -1,
                       "num_leaves": 15, "max_bin": 63},
                      lgbt.Dataset(X, label=y), 3, device="cpu")
    assert texts == [want.model_to_string()] * 2


def test_csr_csc():
    from scipy import sparse as sp
    X, y = make_data(n=100)
    csr = sp.csr_matrix(X)
    h = c_api.LGBM_DatasetCreateFromCSR(csr.indptr, csr.indices, csr.data,
                                        X.shape[1])
    assert c_api.LGBM_DatasetGetNumData(h) == 100
    csc = sp.csc_matrix(X)
    h2 = c_api.LGBM_DatasetCreateFromCSC(csc.indptr, csc.indices, csc.data,
                                         X.shape[0])
    assert c_api.LGBM_DatasetGetNumData(h2) == 100


def test_booster_train_eval_predict(tmp_path):
    X, y = make_data()
    Xv, yv = make_data(seed=1)
    train = c_api.LGBM_DatasetCreateFromMat(
        X, "objective=binary metric=binary_logloss verbose=-1", label=y)
    valid = c_api.LGBM_DatasetCreateFromMat(
        Xv, "objective=binary verbose=-1", label=yv, reference=train)
    bst = c_api.LGBM_BoosterCreate(
        train, "objective=binary metric=binary_logloss verbose=-1")
    c_api.LGBM_BoosterAddValidData(bst, valid)
    for _ in range(20):
        assert c_api.LGBM_BoosterUpdateOneIter(bst) == 0
    assert c_api.LGBM_BoosterGetCurrentIteration(bst) == 20
    ev = c_api.LGBM_BoosterGetEval(bst, 1)
    assert len(ev) == 1 and ev[0] < 0.4
    pred = c_api.LGBM_BoosterPredictForMat(bst, Xv)
    assert ((pred > 0.5) == (yv > 0)).mean() > 0.9
    path = str(tmp_path / "model.txt")
    c_api.LGBM_BoosterSaveModel(bst, -1, path)
    bst2 = c_api.LGBM_BoosterCreateFromModelfile(path)
    np.testing.assert_allclose(c_api.LGBM_BoosterPredictForMat(bst2, Xv),
                               pred, rtol=1e-14)
    v = c_api.LGBM_BoosterGetLeafValue(bst, 1, 0)
    c_api.LGBM_BoosterSetLeafValue(bst, 1, 0, v * 2)
    assert c_api.LGBM_BoosterGetLeafValue(bst, 1, 0) == pytest.approx(v * 2)
    # the changed leaf reaches prediction (the device predictor's cache
    # follows the model generation)
    assert not np.array_equal(c_api.LGBM_BoosterPredictForMat(bst, Xv),
                              pred)


def test_custom_update():
    X, y = make_data()
    train = c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y)
    bst = c_api.LGBM_BoosterCreate(train,
                                   "objective=none verbose=-1 num_leaves=15")
    p = np.zeros(len(y))
    for _ in range(10):
        prob = 1.0 / (1.0 + np.exp(-p))
        c_api.LGBM_BoosterUpdateOneIterCustom(bst, prob - y,
                                              prob * (1 - prob))
        p = c_api.LGBM_BoosterPredictForMat(bst, X, predict_type=1)
    assert ((p > 0) == (y > 0)).mean() > 0.9


def test_push_rows_and_sampled_column():
    X, y = make_data(seed=1)
    n, f = X.shape
    sample_idx = np.arange(0, n, 3)
    h = c_api.LGBM_DatasetCreateFromSampledColumn(
        [X[sample_idx, c] for c in range(f)],
        [np.arange(len(sample_idx)) for _ in range(f)], f,
        [len(sample_idx)] * f, len(sample_idx), n, "max_bin=63 verbose=-1")
    for start in (400, 0, 200):          # any order
        c_api.LGBM_DatasetPushRows(h, X[start:start + 200], start)
    assert c_api.LGBM_DatasetGetNumData(h) == n
    c_api.LGBM_DatasetSetField(h, "label", y)
    bst = c_api.LGBM_BoosterCreate(
        h, "objective=binary verbose=-1 num_leaves=15")
    for _ in range(10):
        c_api.LGBM_BoosterUpdateOneIter(bst)
    pred = c_api.LGBM_BoosterPredictForMat(bst, X)
    assert ((pred > 0.5) == (y > 0)).mean() > 0.9


def test_push_rows_refuses_overlaps_and_unfinished_use():
    X, _ = make_data(seed=2)
    ref = c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1")
    h = c_api.LGBM_DatasetCreateByReference(ref, 600)
    c_api.LGBM_DatasetPushRows(h, X[:300], 0)
    with pytest.raises(LightGBMError, match="still streaming"):
        c_api.LGBM_DatasetGetNumData(h)
    with pytest.raises(LightGBMError, match="overlaps"):
        c_api.LGBM_DatasetPushRows(h, X[200:400], 200)
    with pytest.raises(LightGBMError, match="exceeds"):
        c_api.LGBM_DatasetPushRows(h, X[:400], 300)
    c_api.LGBM_DatasetPushRows(h, X[300:], -1)
    assert c_api.LGBM_DatasetGetNumData(h) == 600


def test_subset_feature_names_and_error():
    X, y = make_data(seed=2)
    h = c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y)
    c_api.LGBM_DatasetSetFeatureNames(h, ["f%d" % i for i in range(6)])
    assert c_api.LGBM_DatasetGetFeatureNames(h)[0] == "f0"
    sub = c_api.LGBM_DatasetGetSubset(h, np.arange(100))
    assert c_api.LGBM_DatasetGetNumData(sub) == 100
    c_api.LGBM_SetLastError("boom")
    assert c_api.LGBM_GetLastError() == "boom"
    assert c_api.LGBM_APIHandleException(ValueError("x")) == -1
    assert c_api.LGBM_GetLastError() == "x"


def test_booster_aux_functions():
    X, y = make_data(seed=3)
    train = c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y)
    bst = c_api.LGBM_BoosterCreate(
        train, "objective=binary verbose=-1 num_leaves=15 metric=auc")
    for _ in range(5):
        c_api.LGBM_BoosterUpdateOneIter(bst)
    assert c_api.LGBM_BoosterGetNumFeature(bst) == 6
    assert c_api.LGBM_BoosterGetEvalCounts(bst) == 1
    assert c_api.LGBM_BoosterGetEvalNames(bst) == ["auc"]
    assert c_api.LGBM_BoosterGetNumPredict(bst, 0) == len(y)
    assert c_api.LGBM_BoosterGetPredict(bst, 0).shape == (len(y),)
    assert len(c_api.LGBM_BoosterGetFeatureNames(bst)) == 6
    assert c_api.LGBM_BoosterGetNumClasses(bst) == 1
    assert c_api.LGBM_BoosterCalcNumPredict(bst, 10, 0) == 10
    assert c_api.LGBM_BoosterCalcNumPredict(bst, 10, 2) == 50
    assert len(c_api.LGBM_BoosterFeatureImportance(bst)) == 6
    assert c_api.LGBM_BoosterDumpModel(bst).startswith("{")
    indptr, indices, data = [0], [], []
    for r in range(20):
        for ci in range(6):
            if X[r, ci] != 0:
                indices.append(ci)
                data.append(X[r, ci])
        indptr.append(len(indices))
    np.testing.assert_allclose(
        c_api.LGBM_BoosterPredictForCSR(bst, indptr, indices, data, 6),
        c_api.LGBM_BoosterPredictForMat(bst, X[:20]), rtol=1e-12)
    c_api.LGBM_BoosterResetParameter(bst, "learning_rate=0.5")
    c_api.LGBM_BoosterRollbackOneIter(bst)
    assert c_api.LGBM_BoosterGetCurrentIteration(bst) == 4
    bst2 = c_api.LGBM_BoosterCreate(
        train, "objective=binary verbose=-1 num_leaves=7")
    c_api.LGBM_BoosterUpdateOneIter(bst2)
    n_before = c_api.LGBM_BoosterGetCurrentIteration(bst)
    c_api.LGBM_BoosterMerge(bst, bst2)
    assert c_api.LGBM_BoosterGetCurrentIteration(bst) == n_before + 1
    # the merged trees come first
    merged = trees(c_api.LGBM_BoosterSaveModelToString(bst))
    assert merged[0] == trees(c_api.LGBM_BoosterSaveModelToString(bst2))[0]
    assert len(merged) == n_before + 1


def test_reset_training_data_keeps_the_model():
    X, y = make_data(seed=5)
    X2, y2 = make_data(seed=6)
    params = "objective=binary verbose=-1 num_leaves=7"
    bst = c_api.LGBM_BoosterCreate(
        c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y), params)
    c_api.LGBM_BoosterUpdateOneIter(bst)
    ds2 = c_api.LGBM_DatasetCreateFromMat(X2, "verbose=-1", label=y2)
    c_api.LGBM_BoosterResetTrainingData(bst, ds2)
    assert c_api.LGBM_BoosterGetNumPredict(bst, 0) == len(y2)
    # the new rows' scores start from the kept tree
    raw = c_api.LGBM_BoosterGetPredict(bst, 0)
    np.testing.assert_allclose(
        raw, c_api.LGBM_BoosterPredictForMat(bst, X2, predict_type=1),
        rtol=1e-6, atol=1e-6)
    c_api.LGBM_BoosterUpdateOneIter(bst)
    assert c_api.LGBM_BoosterGetCurrentIteration(bst) == 2


def test_metrics_scrape_reads_the_port_registry():
    X, y = make_data(seed=7)
    bst = c_api.LGBM_BoosterCreate(
        c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y),
        "objective=binary verbose=-1 num_leaves=7")
    c_api.LGBM_BoosterUpdateOneIter(bst)
    c_api.LGBM_BoosterPredictForMat(bst, X[:10])
    assert "lgbm_predict" in c_api.LGBM_MetricsScrape("prometheus")
    assert c_api.LGBM_MetricsScrape("json").startswith("{")
    with pytest.raises(LightGBMError, match="unknown format"):
        c_api.LGBM_MetricsScrape("xml")


def test_booster_device_follows_params_and_set_device():
    X, y = make_data(seed=8)
    ds = c_api.LGBM_DatasetCreateFromMat(X, "verbose=-1", label=y)
    bst = c_api.LGBM_BoosterCreate(ds, "objective=binary verbose=-1")
    assert c_api._get(bst).device.type == "cpu"
    if not torch.cuda.is_available():
        c_api.LGBM_SetDevice("cuda")
        try:
            with pytest.raises(LightGBMError, match="needs CUDA"):
                c_api.LGBM_BoosterCreate(ds, "objective=binary verbose=-1")
            # device_type=cpu in the parameters asks for the CPU
            bst = c_api.LGBM_BoosterCreate(
                ds, "objective=binary verbose=-1 device_type=cpu")
            assert c_api._get(bst).device.type == "cpu"
        finally:
            c_api.LGBM_SetDevice("cpu")


def test_api_trains_train_text_and_the_jax_trees():
    """The API's booster: train's text to the byte; the JAX package's
    c_api trees on the oracle config (structure exact, leaf values to
    the f32 run within rtol 1e-5 and atol 1e-5 x the largest leaf)."""
    X, y = make_data(seed=0, n=2000, f=8)
    params = "objective=binary verbose=-1 num_leaves=15 max_bin=63 " + WAVE

    def run(api, more):
        ds = api.LGBM_DatasetCreateFromMat(X, "max_bin=63 verbose=-1",
                                           label=y)
        bst = api.LGBM_BoosterCreate(ds, params + " " + more)
        for _ in range(4):
            api.LGBM_BoosterUpdateOneIter(bst)
        return api.LGBM_BoosterSaveModelToString(bst)

    port = run(c_api, ORACLE)
    want = lgbt.train(dict(p.split("=") for p in (params + " " + ORACLE)
                           .split()), lgbt.Dataset(X, label=y), 4,
                      device="cpu").model_to_string()
    assert port == want
    oracle, f32 = run(jc_api, ORACLE), run(jc_api, F32)
    assert structure(port) == structure(oracle) == structure(f32)
    ref = leaf_values(f32)
    np.testing.assert_allclose(leaf_values(port), ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
