"""The port's plotting.py against the JAX package's (matplotlib's Agg
backend; graphviz's ``.source``, which needs no ``dot``).

* ``plot_importance``'s bars are ``feature_importance`` (split and gain),
  labelled with the feature names, zero importances left out;
* ``create_tree_digraph(...).source`` equals the JAX package's for the
  same model text (a reference-written golden model and a port-trained
  one), with ``show_info``;
* ``plot_metric`` draws each dataset's curve of an evals_result dict and
  of a fitted estimator;
* importance histories: a list works as in the JAX package; a Booster
  trained without importance tracking falls back to the snapshot plot;
  an obs timeline path is read by the port's obs/query.py.
"""
import json
import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

import jax  # noqa: E402

import lightgbm_tpu as lgbj  # noqa: E402
import lightgbm_tpu_torch as lgbt  # noqa: E402

jax.config.update("jax_platforms", "cpu")

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "golden")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    plt.close("all")


@pytest.fixture(scope="module")
def trained():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(500, 5))
    y = (X[:, 0] - 0.5 * X[:, 2] > 0).astype(float)
    evals = {}
    ds = lgbt.Dataset(X[:400], label=y[:400],
                      feature_name=["f%d" % i for i in range(5)])
    bst = lgbt.train({"objective": "binary", "num_leaves": 7, "verbose": -1,
                      "metric": ["auc", "binary_logloss"]}, ds, 5,
                     valid_sets=[ds.create_valid(X[400:], label=y[400:])],
                     valid_names=["valid"], evals_result=evals,
                     verbose_eval=False, device="cpu")
    return bst, evals


@pytest.mark.parametrize("kind", ["split", "gain"])
def test_plot_importance_bars_are_feature_importance(trained, kind):
    bst, _ = trained
    ax = lgbt.plot_importance(bst, importance_type=kind)
    imp = bst.feature_importance(kind)
    names = bst.feature_name()
    want = sorted([(n, v) for n, v in zip(names, imp) if v > 0],
                  key=lambda x: x[1])
    widths = [p.get_width() for p in ax.patches]
    np.testing.assert_array_equal(widths, [v for _, v in want])
    assert [t.get_text() for t in ax.get_yticklabels()] == [
        n for n, _ in want]
    ax = lgbt.plot_importance(bst, importance_type=kind, max_num_features=2)
    assert len(ax.patches) == 2


def test_tree_digraph_source_matches_jax(trained):
    bst, _ = trained
    for text in (open(os.path.join(GOLDEN, "binary.model")).read(),
                 bst.model_to_string()):
        t = lgbt.Booster(model_str=text, device="cpu")
        j = lgbj.Booster(model_str=text)
        for kw in ({"tree_index": 0},
                   {"tree_index": 1, "precision": 5,
                    "show_info": ["split_gain", "internal_value",
                                  "leaf_count"]}):
            assert (lgbt.create_tree_digraph(t, **kw).source
                    == lgbj.create_tree_digraph(j, **kw).source)
    with pytest.raises(IndexError):
        lgbt.create_tree_digraph(bst, tree_index=99)


def test_plot_metric(trained):
    _, evals = trained
    ax = lgbt.plot_metric(evals, metric="auc")
    (line,) = ax.get_lines()
    np.testing.assert_array_equal(line.get_ydata(), evals["valid"]["auc"])
    with pytest.raises(TypeError):
        lgbt.plot_metric([1, 2])


def test_importance_history_sources(trained, tmp_path):
    bst, _ = trained
    hist = [{"it": 0, "importance": {0: 1.0, 2: 3.0}},
            {"it": 1, "importance": {0: 2.0, 2: 5.0, 4: 1.0}}]
    ax = lgbt.plot_importance_history(hist, max_num_features=2)
    assert [ln.get_label() for ln in ax.get_lines()] == ["Column_2",
                                                         "Column_0"]
    events = [{"ev": "run_header"},
              {"ev": "importance", "it": 3, "features": [1, 4],
               "split": [2, 7], "gain": [0.5, 1.5]}]
    from lightgbm_tpu.obs.model import importance_history as jhist
    from lightgbm_tpu_torch.plotting import importance_history as thist
    assert thist(events, "gain") == jhist(events, "gain")
    ax = lgbt.plot_importance(events)
    assert [p.get_width() for p in ax.patches] == [2.0, 7.0]
    # a Booster trained without importance tracking: the snapshot plot
    assert bst.importance_history() == []
    ax = lgbt.plot_importance(bst)
    assert len(ax.patches) > 0
    with pytest.raises(ValueError, match="No importance events"):
        lgbt.plot_importance_history(bst)
    # an obs timeline file, read by the port's obs/query.py
    path = tmp_path / "timeline.jsonl"
    path.write_text("".join(json.dumps(dict(e, t=0.0, run="r")) + "\n"
                            for e in events[1:]))
    ax = lgbt.plot_importance_history(str(path), importance_type="gain")
    assert [ln.get_label() for ln in ax.get_lines()] == ["Column_4",
                                                         "Column_1"]
    with pytest.raises(FileNotFoundError):
        lgbt.plot_importance_history(str(tmp_path / "missing.jsonl"))
