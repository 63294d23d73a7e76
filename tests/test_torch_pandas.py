"""pandas input in the port, against the JAX package.

* a frame with a category column trains the trees its integer codes
  train with that column categorical (tpu_growth=exact, as the JAX
  package's tests/test_pandas_categorical.py);
* the saved model's ``pandas_categorical:`` line equals the JAX
  package's for the same frame, and a model loaded from the text codes
  predict frames with it;
* a frame whose categories come in another order predicts the same
  values (to the bit) as the frame in the training order, in the port
  and in a booster loaded from the text; a valid frame is coded against
  the training frame's categories;
* a pandas Series label, and non-numeric columns raise.
"""
import numpy as np
import pandas as pd
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PARAMS = {"objective": "binary", "verbose": -1, "num_leaves": 15,
          "min_data_in_leaf": 5, "max_bin": 63, "tpu_growth": "exact"}


def _frame(n=600, seed=0):
    rng = np.random.default_rng(seed)
    cats = ["red", "green", "blue", "violet"]
    c = rng.integers(0, 4, size=n)
    x0 = rng.normal(size=n)
    y = ((c == 2) * 1.5 + x0 > 0.5).astype(np.float64)
    df = pd.DataFrame({"num0": x0,
                       "color": pd.Categorical.from_codes(c, categories=cats),
                       "num1": rng.normal(size=n)})
    return df, c, y


def _trees(text):
    return text[text.index("Tree="):text.index("feature importances")]


def test_category_frame_trains_its_codes_and_saves_the_jax_line():
    df, codes, y = _frame()
    bt = lgbt.train(PARAMS, lgbt.Dataset(df, label=pd.Series(y)), 4,
                    device="cpu")
    X = np.column_stack([df["num0"].values, codes.astype(float),
                         df["num1"].values])
    bm = lgbt.train(PARAMS, lgbt.Dataset(X, label=y,
                                         categorical_feature=[1]), 4,
                    device="cpu")
    st = bt.model_to_string()
    assert _trees(st) == _trees(bm.model_to_string())
    assert bt.feature_name() == ["num0", "color", "num1"]
    np.testing.assert_array_equal(bt.predict(df), bm.predict(X))
    bj = lgbj.train(PARAMS, lgbj.Dataset(df, label=y), 4,
                    verbose_eval=False)
    line = [ln for ln in st.splitlines()
            if ln.startswith("pandas_categorical:")]
    assert line == [ln for ln in bj.model_to_string().splitlines()
                    if ln.startswith("pandas_categorical:")]
    assert line == ['pandas_categorical:[["red", "green", "blue", '
                    '"violet"]]']
    # a matrix-trained model writes null
    assert bm.model_to_string().rstrip().endswith("pandas_categorical:null")


def test_reordered_categories_predict_the_same(tmp_path):
    df, _, y = _frame()
    bst = lgbt.train(PARAMS, lgbt.Dataset(df, label=y), 4, device="cpu")
    test, _, _ = _frame(seed=3)
    shuffled = test.copy()
    shuffled["color"] = shuffled["color"].cat.reorder_categories(
        ["violet", "blue", "red", "green"])
    want = bst.predict(test)
    np.testing.assert_array_equal(bst.predict(shuffled), want)
    assert list(shuffled["color"].cat.categories)[0] == "violet"
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    loaded = lgbt.Booster(model_file=path, device="cpu")
    assert loaded.pandas_categorical == [["red", "green", "blue", "violet"]]
    np.testing.assert_array_equal(loaded.predict(shuffled), want)
    np.testing.assert_array_equal(
        lgbj.Booster(model_file=path).predict(shuffled), want)


def test_valid_frame_is_coded_against_the_training_categories():
    df, _, y = _frame()
    dv, _, yv = _frame(seed=9)
    dv_shuffled = dv.copy()
    dv_shuffled["color"] = dv_shuffled["color"].cat.reorder_categories(
        ["violet", "blue", "red", "green"])
    curves = []
    for valid in (dv, dv_shuffled):
        train = lgbt.Dataset(df, label=y)
        evals = {}
        lgbt.train(dict(PARAMS, metric="auc"), train, 4,
                   valid_sets=[train.create_valid(valid, label=yv)],
                   evals_result=evals, verbose_eval=False, device="cpu")
        curves.append(evals["valid_0"]["auc"])
    assert curves[0] == curves[1]
    bad = df.assign(text=["a"] * len(df))
    with pytest.raises(lgbt.LightGBMError, match="unsupported dtypes"):
        lgbt.Dataset(bad, label=y).construct()
