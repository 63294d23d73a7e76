"""The port's distributed learners against the JAX package's, on the CPU.

The port runs a rank a thread here (``parallel/comm.py run_ranks``: the
collectives over shared slots and a barrier, with a short timeout so a
hang fails); the JAX package runs its learners on the virtual 8-device
CPU mesh of tests/conftest.py.  The fixtures are tests/test_parallel.py's:
the 1003 x 8 matrix (rank r holds the rows the JAX mesh gives device r)
and ``wide_data`` (1500 x 23).  Each JAX learner is built once a module.
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.ops.learner import SerialTreeLearner as JSerial
from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu.utils.config import Config as JConfig
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.ops import fused_iter
from lightgbm_tpu_torch.ops import wave_kernels as wk
from lightgbm_tpu_torch.ops.learner import (SerialTreeLearner,
                                            materialize_tree)
from lightgbm_tpu_torch.parallel import comm as pcomm
from lightgbm_tpu_torch.parallel import mesh
from lightgbm_tpu_torch.utils.config import Config
from lightgbm_tpu_torch.utils.log import LightGBMError
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
TIMEOUT = 60.0        # a collective that waits longer fails the test


def _ranks(size, fn):
    return pcomm.run_ranks(size, fn, barrier_timeout=TIMEOUT)


def row_block(n, size, rank):
    """(lo, hi, pad): the rows [lo, hi) the JAX package's data mesh gives
    device ``rank`` of ``size`` for n rows (contiguous blocks of
    ceil(n / size) after padding the rows with ``pad_rows``), and the pad
    rows that block holds past the data (each with a row_mult of 0 in the
    JAX package, so they add nothing to a histogram)."""
    per = (n + mesh.pad_rows(n, size)) // size
    lo, hi = min(rank * per, n), min((rank + 1) * per, n)
    return lo, hi, per - (hi - lo)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, f = 1003, 8
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    g = (1.0 / (1.0 + np.exp(-np.zeros(n))) - y).astype(np.float32)
    h = np.full(n, 0.25, dtype=np.float32)
    return X, y, g, h


@pytest.fixture(scope="module")
def wide_data():
    rng = np.random.default_rng(3)
    n, f = 1500, 23
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.7 * X[:, 1] * X[:, 2]
         + 0.1 * rng.normal(size=n) > 0).astype(np.float64)
    g = (0.5 - y).astype(np.float32)
    h = np.full(n, 0.25, dtype=np.float32)
    return X, y, g, h


DP_PARAMS = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1}
WIDE_PARAMS = {"num_leaves": 31, "min_data_in_leaf": 10, "verbose": -1,
               "top_k": 64}


@pytest.fixture(scope="module")
def jax_dp(data):
    X, y, g, h = data
    cfg = JConfig(dict(DP_PARAMS))
    td = JTrainingData.from_matrix(X, label=y, config=cfg)
    tree_s, leaf_s = JSerial(cfg, td).train(g, h)
    dp = jmesh.DataParallelTreeLearner(cfg, td,
                                       jmesh.make_data_mesh(jax.devices()))
    tree_dev, leaf_d = dp.train_device(g, h)
    return tree_s, np.asarray(leaf_s), dp.materialize(tree_dev), \
        np.asarray(leaf_d)


def _dist_trees(X, y, g, h, params, size, rows=None):
    """Each rank's (host tree, leaf ids) of one tree grown by the port's
    distributed learner: the binning of all rows (as the JAX mesh's), and
    rank r's rows the JAX mesh's device r's (``rows``: every rank all
    rows, for the feature-parallel learner)."""
    full = TrainingData.from_matrix(X, label=y, config=Config(dict(params)))

    def rank(comm):
        if rows == "all":
            lo, hi = 0, len(y)
        else:
            lo, hi, _ = row_block(len(y), comm.size, comm.rank)
        local = full.subset(np.arange(lo, hi))
        local._comm = comm
        learner = mesh.create_tree_learner(Config(dict(params)), local, CPU)
        tree, lid, _ = learner.train_device(torch.tensor(g[lo:hi]),
                                            torch.tensor(h[lo:hi]))
        host = materialize_tree(tree.to_numpy(), local, params["num_leaves"])
        return host, lid.numpy(), type(learner).__name__
    return full, _ranks(size, rank)


def _sig(t):
    nl = t.num_leaves
    return (nl, t.split_feature[:nl - 1].tolist(),
            t.threshold_in_bin[:nl - 1].tolist(),
            np.round(t.leaf_value[:nl], 6).tolist())


def test_data_parallel_matches_the_jax_data_parallel_learner(data, jax_dp):
    X, y, g, h = data
    tree_s, leaf_s, tree_d, leaf_d = jax_dp
    # the port's wave learner (B1 on the CPU: its plain version) in the
    # leaf-wise node order of the JAX package's CPU learners
    _, out = _dist_trees(X, y, g, h, dict(DP_PARAMS, tree_learner="data",
                                          tpu_wave_order="exact"), 8)
    assert {o[2] for o in out} == {"DataParallelTreeLearner"}
    port = out[0][0]
    # every rank grew the same tree
    assert all(_sig(o[0]) == _sig(port) for o in out)
    nl = tree_d.num_leaves
    assert port.num_leaves == nl == tree_s.num_leaves
    for ref in (tree_d, tree_s):
        np.testing.assert_array_equal(port.split_feature[:nl - 1],
                                      ref.split_feature[:nl - 1])
        np.testing.assert_array_equal(port.threshold_in_bin[:nl - 1],
                                      ref.threshold_in_bin[:nl - 1])
        np.testing.assert_allclose(port.leaf_value[:nl],
                                   ref.leaf_value[:nl], rtol=1e-4)
    lid = np.concatenate([o[1] for o in out])
    np.testing.assert_array_equal(lid, leaf_d)
    np.testing.assert_array_equal(lid, leaf_s)


def test_data_parallel_exact_growth_matches_jax(data, jax_dp):
    """tree_learner=data under tpu_growth=exact: B5's per-leaf
    histograms summed over the ranks."""
    X, y, g, h = data
    _, _, tree_d, leaf_d = jax_dp
    _, out = _dist_trees(X, y, g, h, dict(DP_PARAMS, tree_learner="data",
                                          tpu_growth="exact"), 2)
    port = out[0][0]
    nl = tree_d.num_leaves
    assert _sig(port)[:3] == _sig(tree_d)[:3]
    np.testing.assert_allclose(port.leaf_value[:nl], tree_d.leaf_value[:nl],
                               rtol=1e-4)
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out]),
                                  leaf_d)


@pytest.fixture(scope="module")
def jax_wide(wide_data):
    X, y, g, h = wide_data
    cfg = JConfig(dict(WIDE_PARAMS))
    td = JTrainingData.from_matrix(X, label=y, config=cfg)
    tree_s, _ = JSerial(cfg, td).train(g, h)
    fp = jmesh.FeatureParallelTreeLearner(cfg, td)
    tree_f, leaf_f = fp.train(g, h)
    small = JConfig(dict(WIDE_PARAMS, top_k=5))
    vt = jmesh.VotingParallelTreeLearner(small, td)
    tree_v = vt.materialize(vt.train_device(g, h)[0])
    return tree_s, tree_f, np.asarray(leaf_f), tree_v


def test_feature_parallel_matches_jax_exactly(wide_data, jax_wide):
    X, y, g, h = wide_data
    tree_s, tree_f, leaf_f, _ = jax_wide
    # 4 ranks over 23 features: 6 a rank, one padded feature on the last
    _, out = _dist_trees(X, y, g, h, dict(WIDE_PARAMS,
                                          tree_learner="feature"), 4,
                         rows="all")
    assert {o[2] for o in out} == {"FeatureParallelTreeLearner"}
    assert _sig(out[0][0]) == _sig(tree_f) == _sig(tree_s)
    for o in out:
        np.testing.assert_array_equal(o[1], leaf_f)


def test_feature_parallel_equals_serial_exact_growth_text(wide_data):
    """Three ranks over 23 features (8 a rank, one padded): the text
    equals the serial learner's exact growth to the byte."""
    X, y, _, _ = wide_data
    params = dict(WIDE_PARAMS, objective="binary", tpu_growth="exact",
                  enable_bundle=False)
    serial = lgbt.train(params, lgbt.Dataset(X, label=y), 2, device="cpu")

    def rank(comm):
        p = dict(params, tree_learner="feature")
        ds = lgbt.Dataset(X, label=y)
        ds._handle = TrainingData.from_matrix(X, label=y,
                                              config=Config(dict(p)),
                                              comm=comm)
        return lgbt.train(p, ds, 2, device="cpu").model_to_string()
    texts = _ranks(3, rank)
    assert texts[0] == texts[2] == serial.model_to_string()


def test_voting_covering_every_feature_equals_serial(wide_data, jax_wide):
    X, y, g, h = wide_data
    tree_s = jax_wide[0]
    _, out = _dist_trees(X, y, g, h, dict(WIDE_PARAMS,
                                          tree_learner="voting"), 2)
    assert {o[2] for o in out} == {"VotingParallelTreeLearner"}
    assert _sig(out[0][0]) == _sig(tree_s)


def test_voting_top_k_5_matches_the_jax_voting_learner(wide_data,
                                                       jax_wide):
    X, y, g, h = wide_data
    tree_v = jax_wide[3]
    _, out = _dist_trees(X, y, g, h, dict(WIDE_PARAMS, top_k=5,
                                          tree_learner="voting"), 8)
    port = out[0][0]
    assert port.num_leaves == tree_v.num_leaves == 31
    assert _sig(port)[:3] == _sig(tree_v)[:3]
    nl = port.num_leaves
    np.testing.assert_allclose(port.leaf_value[:nl], tree_v.leaf_value[:nl],
                               rtol=1e-4)


@pytest.mark.parametrize("learner", ["data", "voting", "feature"])
def test_world_size_one_is_the_serial_learner(data, learner):
    """tree_learner=data|voting|feature with one rank trains the serial
    learner's text byte for byte, as the JAX package falls back on one
    device."""
    X, y, _, _ = data
    params = {"objective": "binary", "num_leaves": 15,
              "min_data_in_leaf": 5, "verbose": -1}
    want = lgbt.train(params, lgbt.Dataset(X, label=y), 3,
                      device="cpu").model_to_string()

    def rank(comm):
        p = dict(params, tree_learner=learner)
        ds = lgbt.Dataset(X, label=y)
        ds._handle = TrainingData.from_matrix(X, label=y,
                                              config=Config(dict(p)),
                                              comm=comm)
        b = lgbt.train(p, ds, 3, device="cpu")
        assert type(b._gbdt.learner) is SerialTreeLearner
        return b.model_to_string()
    assert _ranks(1, rank)[0] == want
    b = lgbt.train(dict(params, tree_learner=learner),
                   lgbt.Dataset(X, label=y), 3, device="cpu")
    assert b.model_to_string() == want


# ------------------------------------------------------------- the comm
def test_thread_comm_collectives():
    def rank(comm):
        t = torch.tensor([comm.rank + 1.0, -comm.rank], dtype=torch.float64)
        s = comm.all_reduce_(t.clone())
        m = comm.all_reduce_(t.clone(), "max")
        g = comm.all_gather(torch.tensor([comm.rank], dtype=torch.int64))
        b = comm.broadcast_(torch.tensor([comm.rank * 10]), 2)
        objs = comm.allgather_obj({"r": comm.rank})
        return (s.tolist(), m.tolist(), g.reshape(-1).tolist(), b.tolist(),
                objs, comm.stats["calls"])
    out = _ranks(3, rank)
    for s, m, g, b, objs, calls in out:
        assert s == [6.0, -3.0] and m == [3.0, 0.0]
        assert g == [0, 1, 2] and b == [20]
        assert objs == [{"r": 0}, {"r": 1}, {"r": 2}] and calls == 4
    one = pcomm.SingleProcessComm()
    t = torch.ones(2)
    assert one.all_reduce_(t) is t and one.all_gather(t).shape == (1, 2)
    with pytest.raises(LightGBMError, match="sum' or 'max"):
        one.all_reduce_(t, "min")


def test_host_agreement_helpers():
    """sync_up_by_min adopts the ranks' minimum; sync_config_across_ranks
    makes the RNG-bearing keys the ranks' minima in the live config and
    its raw dict; vote_stop is unanimous; sum_across_ranks adds in rank
    order."""
    def rank(comm):
        cfg = Config({"data_random_seed": 10 - comm.rank,
                      "feature_fraction": 0.5 + 0.1 * comm.rank})
        pcomm.sync_config_across_ranks(comm, cfg)
        return (pcomm.sync_up_by_min(comm, 7 - 2 * comm.rank),
                cfg.data_random_seed, cfg.raw["feature_fraction"],
                pcomm.vote_stop(comm, comm.rank != 1),
                pcomm.vote_stop(comm, True),
                pcomm.sum_across_ranks(comm, [comm.rank, 0.5]))
    for out in _ranks(3, rank):
        assert out == (3, 8, 0.5, False, True, [3.0, 1.5])


def test_barrier_timeout_names_the_missing_ranks():
    import time

    def fault(rank, seq):
        if rank == 1 and seq == 1:
            time.sleep(1.5)

    def rank(comm):
        comm.all_reduce_(torch.ones(1))
        comm.all_reduce_(torch.ones(1))
    with pytest.raises(pcomm.BarrierTimeoutError) as e:
        pcomm.run_ranks(3, rank, fault=fault, barrier_timeout=0.5)
    assert e.value.missing == [1] and e.value.arrived == [0, 2]
    assert "ranks [1] never did" in str(e.value)


def test_backend_and_bootstrap_rules(monkeypatch):
    assert pcomm.pick_backend("cpu", 4) == "gloo"
    # no card here: the CUDA request falls to gloo as well
    assert pcomm.pick_backend("cuda", 2) == "gloo"
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert isinstance(pcomm.distributed_init(Config({})),
                      pcomm.SingleProcessComm)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(LightGBMError, match="coordinator"):
        pcomm.distributed_init(Config({}))
    # the explicit argument wins over the environment
    assert isinstance(pcomm.distributed_init(Config({}), num_processes=1),
                      pcomm.SingleProcessComm)
    assert row_block(1003, 8, 7) == (882, 1003, 5)
    assert mesh.feature_block(23, 8, 7) == (21, 3)
    assert mesh.pad_rows(1003, 8) == 5


def test_the_kernels_deferred_finish_plain_forms():
    """On the CPU the deferred-finish form is the plain histogram, and the
    conversion alone returns it; the exponents of global rows and maxima
    equal the exponents of the union of the ranks' rows."""
    rng = np.random.default_rng(1)
    X_t = torch.as_tensor(rng.integers(0, 7, size=(3, 50), dtype=np.uint8))
    lid = torch.as_tensor(rng.integers(0, 3, size=50), dtype=torch.int32)
    w3 = torch.as_tensor(rng.normal(size=(50, 3)), dtype=torch.float32)
    ids = torch.tensor([0, 2], dtype=torch.int32)
    sums = wk.wave_histogram(X_t, lid, w3, ids, 7, finish=False)
    assert torch.equal(sums, wk.wave_histogram(X_t, lid, w3, ids, 7))
    assert wk.finish_hist(sums, ids, None) is sums
    parts = (w3[:20], w3[20:])
    amax = torch.maximum(*[p.abs().amax(dim=0) for p in parts])
    assert torch.equal(wk.fixed_point_exponents(parts[0], rows=50,
                                                amax=amax),
                       wk.fixed_point_exponents(w3))


def test_distributed_learners_run_staged(data):
    X, y, _, _ = data

    def rank(comm):
        p = {"objective": "binary", "num_leaves": 7, "verbose": -1,
             "tree_learner": "data", "tpu_fused_iter": "on"}
        lo, hi = comm.rank * len(y) // 2, (comm.rank + 1) * len(y) // 2
        ds = lgbt.Dataset(X[lo:hi], label=y[lo:hi])
        ds._handle = TrainingData.from_matrix(
            X[lo:hi], label=y[lo:hi], config=Config(dict(p)), comm=comm)
        b = lgbt.train(p, ds, 2, device="cpu")
        info = b._gbdt.learner.collective_info()
        return (fused_iter.fused_supported(b._gbdt), info,
                b._gbdt.learner.last_collective)
    (ok, why), info, last = _ranks(2, rank)[0]
    assert not ok and why == "distributed learner"
    assert info["global_rows"] == len(y)
    assert info["all_reduce"]["per_wave_bytes"] > 0
    assert last["calls"] > 0 and last["bytes"] > 0


def test_data_parallel_sparse_trains_through_train(data):
    """tree_learner=data with tpu_sparse=true through ``train`` on
    rank-sharded datasets: the coordinate store on every rank (it was
    refused before), the ranks' texts equal, and the first tree's splits
    those of the dense data-parallel run on the same (distributed)
    bins."""
    X, y, _, _ = data
    X = np.where(np.abs(X) < 0.8, 0.0, X)
    p = {"objective": "binary", "verbose": -1, "num_leaves": 7,
         "min_data_in_leaf": 5, "tree_learner": "data",
         "tpu_growth": "exact"}

    def rank(comm):
        lo, hi, _ = row_block(len(y), comm.size, comm.rank)
        out = []
        for sparse in (True, False):
            q = dict(p, tpu_sparse=sparse)
            ds = lgbt.Dataset(X[lo:hi], label=y[lo:hi])
            ds._handle = TrainingData.from_matrix(
                X[lo:hi], label=y[lo:hi], config=Config(dict(q)),
                comm=comm)
            b = lgbt.train(q, ds, 2, device="cpu")
            assert (type(b._gbdt.learner).__name__
                    == "DataParallelTreeLearner")
            assert b._gbdt.learner.sparse_mode == ("sparse" if sparse
                                                   else "")
            out.append(b.model_to_string())
        return out
    texts = _ranks(2, rank)
    assert texts[0][0] == texts[1][0]

    def first_tree(text):
        tree = text.split("Tree=1")[0].split("Tree=0")[1]
        return [ln for ln in tree.splitlines()
                if ln.startswith(("split_feature=", "threshold="))]
    assert first_tree(texts[0][0]) == first_tree(texts[0][1])
