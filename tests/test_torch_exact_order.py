"""Exact-order waves (``tpu_wave_order=exact``) in the port, mirroring
tests/test_wave_exact_order.py.

A wave commits the prefix of its candidates that the leaf-wise order
would split before any child made earlier in the same wave, and rolls
the rest back.  The port's histograms are the same bits at any width
(B1, B3, B4 and B6 sum in one fixed point; on the CPU the plain
versions add each cell's rows in row order), so:

* the exact-order model text at W in {4, 8, 30} equals the W = 1 text
  and the ``tpu_growth=exact`` text to the byte, on ``pallas_ct``,
  ``pallas_t``, row-major ``pallas`` and the sparse store (against its
  W = 1 text only: exact growth refuses the sparse store), binary and
  L2, with and without EFB bundles;
* against the JAX package's exact-order run on its own fixture
  (tests/test_wave_exact_order.py ``_data(1)``, W = 8): the same
  partitions (split features, child pointers, leaf counts, decision
  types) as its interpret-mode ``pallas_ct`` run and its f32 ``onehot``
  run -- not the threshold values: at 255 bins and 5 rows a leaf many
  best splits border an empty bin, where two thresholds make one
  partition and the summation order picks one (the JAX package's two
  runs pick differently too; ROADMAP C) --
  leaf values to tests/test_torch_exact_train.py's tolerance (rtol 1e-5,
  atol 1e-5 x the largest leaf) against the f32 run and within 1e-3 of
  the largest leaf of the bf16 hi/lo ``pallas_ct`` run (ROADMAP C);
* a wave whose second candidate a child of the first outranks commits
  one split, sends the second candidate's routed rows back and writes
  only spare slots for it: the state equals one batched wave at W = 1;
* ``resolve_wave_order`` and ``resolve_wave_width`` agree with the JAX
  package's over a grid of configs.
"""
import itertools

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import jax

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import learner as jlearner
from lightgbm_tpu.utils import config as jcfg
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.ops import learner as tlearner
from lightgbm_tpu_torch.ops.histogram import weight_rows
from lightgbm_tpu_torch.ops.split_finder import GAIN
from lightgbm_tpu_torch.ops.wave_kernels import fixed_point_exponents
from lightgbm_tpu_torch.utils import config as tcfg
from torch_cases import labels, leaf_values, parity_data, parity_params
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

ROUNDS = 5
PARTITION = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def _partitions(model):
    return [ln for ln in model.splitlines() if ln.startswith(PARTITION)]


def _sparse_data(seed, n=2500):
    rng = np.random.default_rng(seed)
    X = np.where(rng.random((n, 10)) < 0.25, rng.normal(size=(n, 10)), 0.0)
    X[:, 0] = rng.normal(size=n)
    s = X[:, 0] + 0.7 * X[:, 1] + 0.5 * X[:, 2] * X[:, 3] + 0.3 * X[:, 9]
    return sps.csr_matrix(X), s + 0.2 * rng.normal(size=n)


def _text(params, X, y, **more):
    booster = lgb.train(dict(params, **more), lgb.Dataset(X, label=y),
                        ROUNDS, device="cpu")
    return booster.model_to_string(), booster


# (objective, histogram mode or "sparse", EFB bundles)
CASES = [("binary", "pallas_ct", False), ("regression", "pallas_t", False),
         ("binary", "pallas", True), ("regression", "pallas_ct", True),
         ("binary", "sparse", False), ("regression", "sparse", False)]


@pytest.mark.parametrize("width", [4, 8, 30])
@pytest.mark.parametrize("objective,mode,bundled", CASES)
def test_exact_order_trains_the_leaf_wise_model_text(objective, mode,
                                                     bundled, width):
    params = parity_params(objective, {"num_leaves": 31,
                                       "tpu_growth": "wave"})
    if mode == "sparse":
        X, s = _sparse_data(4)
        params.update(tpu_sparse=True, tpu_sparse_kernel=True)
    else:
        X, s = parity_data(7, 2500, bundled)
        params["tpu_histogram_mode"] = mode
    y = labels(objective, s)
    text, booster = _text(params, X, y, tpu_wave_order="exact",
                          tpu_wave_width=width)
    learner = booster._gbdt.learner
    assert (learner.wave_order, learner.wave_width) == ("exact", width)
    assert learner.hist_mode == ("sparse_mxu" if mode == "sparse" else mode)
    assert (booster._gbdt.train_data.bundle is not None) == bundled
    w1, _ = _text(params, X, y, tpu_wave_width=1)
    assert text == w1
    if mode != "sparse":
        exact, _ = _text(params, X, y, tpu_growth="exact",
                         tpu_histogram_mode="pallas")
        assert text == exact
    # the waves a tree took: more than batched order's, fewer than its
    # splits once a wave commits more than one
    stats = booster.grow_stats()
    assert all(1 <= st.passes <= st.num_leaves - 1 for st in stats)
    assert sum(st.passes for st in stats) < sum(st.num_leaves - 1
                                               for st in stats)


def _jax_data(seed, n=2500, f=8):
    """tests/test_wave_exact_order.py ``_data`` (binary)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[:, -1] = rng.integers(0, 6, size=n)
    y = (X[:, 0] + 0.5 * X[:, 1] - 0.2 * X[:, 2] > 0).astype(np.float64)
    return X, y


def test_exact_order_grows_the_jax_package_trees():
    X, y = _jax_data(1)
    params = {"verbose": -1, "num_leaves": 31, "min_data_in_leaf": 5,
              "objective": "binary", "tpu_growth": "wave",
              "tpu_wave_order": "exact", "tpu_wave_width": 8,
              "tpu_histogram_mode": "pallas_ct",
              "tpu_pallas_interpret": True}
    bj = lgbj.train(params, lgbj.Dataset(X, label=y), ROUNDS)
    bf = lgbj.train(dict(params, tpu_histogram_mode="onehot"),
                    lgbj.Dataset(X, label=y), ROUNDS)
    assert bj._gbdt.learner.wave_order == "exact"
    bt = lgb.train(params, lgb.Dataset(X, label=y), ROUNDS, device="cpu")
    assert bt._gbdt.learner.wave_order == "exact"
    sj, sf, st = (bj.model_to_string(), bf.model_to_string(),
                  bt.model_to_string())
    assert bt.num_trees() == bj.num_trees() == ROUNDS
    assert _partitions(st) == _partitions(sj) == _partitions(sf)
    lt, lf, lj = leaf_values(st), leaf_values(sf), leaf_values(sj)
    np.testing.assert_allclose(lt, lf, rtol=1e-5,
                               atol=1e-5 * np.abs(lf).max())
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3 * np.abs(lj).max())


def _state(order, width):
    """A wave grower of the given order and width over a trained
    booster's bins, its state after the root split, and the tree's
    weight rows, exponents and feature mask."""
    X, s = parity_data(7, 2500, False)
    params = parity_params("binary", {"num_leaves": 31, "tpu_growth": "wave",
                                      "tpu_histogram_mode": "pallas_ct",
                                      "tpu_wave_order": order,
                                      "tpu_wave_width": width})
    booster = lgb.train(params, lgb.Dataset(X, label=labels("binary", s)),
                        1, device="cpu")
    gbdt = booster._gbdt
    grower = gbdt.learner.wave_grower()
    st = grower.new_state(gbdt.num_data, torch.device("cpu"))
    g, h = gbdt.objective.get_gradients(gbdt._score_dev[0])
    w3 = weight_rows(g, h, None)
    args = (w3, fixed_point_exponents(w3), gbdt.learner._full_mask)
    grower.root(st, *args)
    grower.wave(st, *args)                     # the root's one split
    assert int(st.nn) == 1
    # the second leaf keeps its split but a gain that any child of the
    # first outranks
    st.bests[1, GAIN] = 1e-6
    return grower, st, args


def _heads(grower, st):
    tree = grower.tree_of(st)
    out = {f: getattr(tree, f).clone() for f in tree.__dataclass_fields__}
    L = grower.L
    out.update(leaf_id=st.leaf_id.clone(), bests=st.bests[:L].clone(),
               hists=st.hists[:L].clone(), nn=st.nn.clone(),
               waves=st.waves.clone(), done=st.done.clone())
    return out


def test_outranked_candidate_is_rolled_back():
    """Two valid candidates, leaf 0 and leaf 1, where a child of leaf 0
    outranks leaf 1: the wave commits one split; B1 routed leaf 1's rows
    too, and they are back in leaf 1; the uncommitted slot wrote only
    spare slots, so every state tensor equals that of one batched wave
    at width 1 from the same state, bit for bit."""
    grower, st, args = _state("exact", 4)
    before = st.leaf_id.clone()
    p = grower.pick(st)
    assert p.parent[:2].tolist() == [0, 1] and int(p.k) == 2
    grower.commit(st, p, *args)
    assert int(st.nn) == 2 and int(st.tree.num_leaves) == 3
    in1 = before == 1
    assert torch.equal(st.leaf_id[in1], before[in1])
    assert set(st.leaf_id[before == 0].tolist()) == {0, 2}
    ref, ref_st, ref_args = _state("batched", 1)
    ref.wave(ref_st, *ref_args)
    got, want = _heads(grower, st), _heads(ref, ref_st)
    for name in want:
        x, y = got[name], want[name]
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        assert torch.equal(x, y), name


def _configs():
    for objective, boosting, order, width, leaves in itertools.product(
            ("binary", "lambdarank", "regression"),
            ("gbdt", "dart", "goss"), ("auto", "batched", "exact"),
            (-1, 4), (15, 63, 255)):
        yield ({"objective": objective, "boosting": boosting,
                "tpu_wave_order": order, "tpu_wave_width": width,
                "verbose": -1}, leaves)


def test_wave_order_and_width_resolve_as_the_jax_package():
    for params, leaves in _configs():
        tc, jc = tcfg.Config(dict(params)), jcfg.Config(dict(params))
        order = tlearner.resolve_wave_order(tc)
        assert order == jlearner.resolve_wave_order(jc), params
        assert (tlearner.resolve_wave_width(tc, leaves, order)
                == jlearner.resolve_wave_width(jc, leaves, order)), params
    for mod, cfg in ((tlearner, tcfg), (jlearner, jcfg)):
        with pytest.raises(Exception, match="Unknown tpu_wave_order"):
            mod.resolve_wave_order(cfg.Config({"tpu_wave_order": "fast"}))
