"""sparse_model_diff.py's comparison (the first split, in split order,
where two models part below identical ancestors) and its witness (the
gains at a node recomputed from the node's rows)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps

import lightgbm_tpu_torch as lgb

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import sparse_model_diff as smd  # noqa: E402
from torch_cases import one_torch_thread  # noqa: F401 (autouse)


def _train():
    rng = np.random.default_rng(0)
    X = np.where(rng.random((1500, 8)) < 0.3, rng.normal(size=(1500, 8)),
                 0.0)
    X[:, 0] = rng.normal(size=1500)
    y = (X[:, 0] + 0.7 * X[:, 1] > 0).astype(float)
    p = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
         "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
         "tpu_wave_width": 2, "tpu_sparse": True, "tpu_sparse_kernel": True}
    return lgb.train(p, lgb.Dataset(sps.csr_matrix(X), label=y), 3,
                     device="cpu")


@pytest.fixture(scope="module")
def text():
    return _train().model_to_string()


def _trees(text):
    return lgb.Booster(model_str=text, device="cpu")._gbdt.models


@pytest.mark.parametrize("tree,node", [(0, 0), (1, 2), (2, 5)])
def test_first_difference_is_the_changed_split(text, tree, node):
    """Equal models have no difference; moving one split's threshold
    makes that split, and only it, the first difference, at its path."""
    a, b = _trees(text), _trees(text)
    assert smd.first_difference(a, b) is None
    b[tree].threshold[node] += 0.25
    path = {n: p for p, n in smd.node_paths(b[tree]).items()}[node]
    assert smd.first_difference(a, b) == (tree, path)
    # the rows of the split's node are those of the leaves below it
    leaves = smd.rows_leaves(a[tree], node)
    assert len(leaves) == len(set(leaves)) >= 2


def test_witness_gives_the_trained_split(monkeypatch):
    """At a trained split the witness, from the grower's own weight rows
    and final leaf ids, finds the model's feature and threshold, in
    float64 and from the sparse histogram in f32, with the model's gain."""
    from lightgbm_tpu_torch.ops import learner as learner_mod
    seen = []
    real = learner_mod.SerialTreeLearner.train_device

    def spy(self, grad, hess, row_mult=None):
        out = real(self, grad, hess, row_mult)
        seen.append((self, grad.clone(), hess.clone(), out[1].clone()))
        return out

    monkeypatch.setattr(learner_mod.SerialTreeLearner, "train_device", spy)
    booster = _train()
    booster.model_to_string()
    tree = booster._gbdt.models[1]
    learner, grad, hess, leaf_id = seen[1]
    f = int(tree.split_feature[0])
    got = smd.witness(learner, grad, hess, learner._ones, leaf_id,
                      smd.rows_leaves(tree, 0), [f])
    assert got["rows"] == len(leaf_id)
    for side in ("float64", "b6_f32"):
        best = got[side]["best"]
        assert best == got[side][str(f)]
        assert best["feature"] == f
        assert best["threshold"] == tree.threshold[0]
        assert best["gain"] == pytest.approx(tree.split_gain[0], rel=1e-5)
