"""The sparse stores under the port's distributed learners, against the
JAX package's on the CPU.

* ``sharded_store_parts`` / ``assemble_sharded_store`` build the JAX
  package's arrays at 1, 2 and 4 row blocks.
* The data-parallel learner on the coordinate store (``tpu_sparse=true``):
  each rank's store holds its rows with local ids, padded to the entries
  and window the ranks agree on, and the ranks all-reduce the integer
  fixed-point sums before the conversion, so every rank holds the serial
  store's fixed-point histogram of all rows to the bit.  Its trees are
  the JAX data-parallel learner's on the 8-device CPU mesh.
* The gates: voting and feature-parallel learners train dense under
  ``tpu_sparse=true``, and the data-parallel learner drops
  ``tpu_sparse_kernel=true`` for the coordinate store, each with the
  JAX package's warning (its ops/learner.py:236-261).

The port runs a rank a thread (``run_ranks``); the fixtures are pinned.
"""
import numpy as np
import pytest
import torch

import jax

from lightgbm_tpu.io.dataset import TrainingData as JTrainingData
from lightgbm_tpu.ops import sparse_store as jss
from lightgbm_tpu.parallel import mesh as jmesh
from lightgbm_tpu.utils import log as jlog
from lightgbm_tpu.utils.config import Config as JConfig
from lightgbm_tpu_torch.io.dataset import TrainingData
from lightgbm_tpu_torch.ops import sparse_store as tss
from lightgbm_tpu_torch.ops.learner import materialize_tree
from lightgbm_tpu_torch.ops.wave_kernels import fixed_point_exponents
from lightgbm_tpu_torch.parallel import comm as pcomm
from lightgbm_tpu_torch.parallel import mesh
from lightgbm_tpu_torch.utils import log as tlog
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import sparse_case
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

CPU = torch.device("cpu")
TIMEOUT = 60.0
STORE_FIELDS = ("nz_row", "nz_bin", "nz_seg", "colptr", "fill")


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_store_parts_are_the_jax_arrays(shards):
    X, fill, _, _ = sparse_case(n=2000)
    jparts, jnnz, jcap = jss.sharded_store_parts(X, fill, 14, shards)
    tparts, tnnz, tcap = tss.sharded_store_parts(X, fill, 14, shards)
    assert (tnnz, tcap) == (jnnz, jcap)
    for jp, tp in zip(jparts, tparts):
        assert jp[1] == tp[1]
        for ja, ta in zip(jp[0], tp[0]):
            np.testing.assert_array_equal(ta, ja)
    jstore, jbytes = jss.assemble_sharded_store(jparts, X.shape[1], 14,
                                                jnnz + 5)
    tstore, tbytes = tss.assemble_sharded_store(tparts, X.shape[1], 14,
                                                tnnz + 5)
    assert tbytes == jbytes
    assert tstore.padded and tstore.col_cap == jcap
    for name in STORE_FIELDS:
        np.testing.assert_array_equal(getattr(tstore, name),
                                      np.asarray(getattr(jstore, name)))


@pytest.fixture(scope="module")
def sparse_data():
    rng = np.random.default_rng(0)
    n, f = 1003, 12
    X = np.where(rng.random((n, f)) < 0.9, 0.0, rng.normal(size=(n, f)))
    y = (X[:, 0] + X[:, 3] + 0.2 * rng.normal(size=n) > 0.05)
    g = (0.5 - y).astype(np.float32)
    h = np.full(n, 0.25, dtype=np.float32)
    return X, y.astype(np.float64), g, h


BASE = {"num_leaves": 15, "min_data_in_leaf": 5, "verbose": -1}


def _row_block(n, size, rank):
    """The rows the JAX data mesh gives device ``rank`` of ``size``."""
    per = (n + mesh.pad_rows(n, size)) // size
    return min(rank * per, n), min((rank + 1) * per, n)


def _port_trees(X, y, g, h, params, size, rows="blocks"):
    full = TrainingData.from_matrix(X, label=y, config=Config(dict(params)))

    def rank(comm):
        lo, hi = ((0, len(y)) if rows == "all"
                  else _row_block(len(y), comm.size, comm.rank))
        local = full.subset(np.arange(lo, hi))
        local._comm = comm
        learner = mesh.create_tree_learner(Config(dict(params)), local, CPU)
        tree, lid, _ = learner.train_device(torch.tensor(g[lo:hi]),
                                            torch.tensor(h[lo:hi]))
        host = materialize_tree(tree.to_numpy(), local, params["num_leaves"])
        return host, lid.numpy(), learner
    return pcomm.run_ranks(size, rank, barrier_timeout=TIMEOUT)


def _structure(t):
    nl = t.num_leaves
    return (nl, np.asarray(t.split_feature[:nl - 1]).tolist(),
            np.asarray(t.threshold_in_bin[:nl - 1]).tolist())


@pytest.fixture
def warnings(monkeypatch):
    """The warnings each package logs, by package."""
    got = {"jax": [], "port": []}
    for key, mod in (("jax", jlog), ("port", tlog)):
        def warn(msg, *args, _key=key):
            got[_key].append(msg % args if args else msg)
        monkeypatch.setattr(mod.Log, "warning", staticmethod(warn))
    return got


@pytest.mark.parametrize("growth", ["auto", "wave"])
def test_data_parallel_coordinate_store_grows_the_jax_trees(
        sparse_data, growth):
    """2 ranks on the coordinate store against the JAX data-parallel
    sparse learner on 8 devices: the same splits, leaf values within the
    dense DP tolerance (rtol 1e-4), the same leaf of every row."""
    X, y, g, h = sparse_data
    params = dict(BASE, tree_learner="data", tpu_sparse=True,
                  tpu_growth=growth)
    if growth == "wave":
        params["tpu_wave_order"] = "exact"
    cfg = JConfig(dict(params))
    td = JTrainingData.from_matrix(X, label=y, config=cfg)
    dp = jmesh.DataParallelTreeLearner(cfg, td,
                                       jmesh.make_data_mesh(jax.devices()))
    assert dp.sparse_on
    tree_dev, leaf_d = dp.train_device(g, h)
    jt = dp.materialize(tree_dev)
    out = _port_trees(X, y, g, h, params, 2)
    for host, _, learner in out:
        assert type(learner).__name__ == "DataParallelTreeLearner"
        assert isinstance(learner.X, tss.SparseDeviceStore)
        assert learner.growth == ("exact" if growth == "auto" else "wave")
        assert _structure(host) == _structure(out[0][0]) == _structure(jt)
    nl = jt.num_leaves
    np.testing.assert_allclose(out[0][0].leaf_value[:nl],
                               jt.leaf_value[:nl], rtol=1e-4)
    np.testing.assert_array_equal(np.concatenate([o[1] for o in out]),
                                  np.asarray(leaf_d)[:len(y)])
    # the ranks' stores share one shape: the agreed entries and window
    shapes = {(int(o[2].X.nz_row.shape[0]), o[2].X.col_cap) for o in out}
    assert len(shapes) == 1


@pytest.mark.parametrize("compact", [False, True])
def test_data_parallel_store_histograms_are_the_serial_fixed_point(
        compact):
    """Each rank's all-reduced slot histogram equals the serial store's
    fixed-point histogram over all rows, bit for bit (the card's sums),
    with the exponents of all rows; all-reducing only the cells an entry
    can hold (``store_cells``) changes no bit."""
    X, fill, leaf_id, w3 = sparse_case(n=3001)
    child = torch.tensor([0, 3, -1, 5], dtype=torch.int32)
    serial, _, _ = tss.build_sparse_store(X, fill, 14)
    exps = fixed_point_exponents(torch.tensor(w3))
    want = tss.sparse_wave_hists(serial, torch.tensor(leaf_id),
                                 torch.tensor(w3), child, 14, X.shape[1],
                                 12, exps=exps, fixed=True)
    want_leaf = tss.sparse_leaf_hist(serial, torch.tensor(leaf_id),
                                     torch.tensor(w3), 3, 14, X.shape[1],
                                     exps=exps, fixed=True)

    def rank(comm):
        lo, hi = _row_block(len(X), comm.size, comm.rank)
        parts, nnz, cap = tss.sharded_store_parts(X[lo:hi], fill, 14, 1)
        agreed = comm.allgather_obj([nnz, cap])
        store, _ = tss.assemble_sharded_store(
            parts, X.shape[1], 14, max(a[0] for a in agreed),
            max(a[1] for a in agreed))
        cells = (tss.store_cells([14] * X.shape[1], fill, 14, CPU)
                 if compact else None)
        store = tss.upload_store(store, CPU, cells)
        lid = torch.tensor(leaf_id[lo:hi])
        w = torch.tensor(w3[lo:hi])
        return (tss.sparse_wave_hists(store, lid, w, child, 14, X.shape[1],
                                      12, exps=exps, comm=comm),
                tss.sparse_leaf_hist(store, lid, w, 3, 14, X.shape[1],
                                     exps=exps, comm=comm))
    for hist, leaf in pcomm.run_ranks(3, rank, barrier_timeout=TIMEOUT):
        assert torch.equal(hist, want)
        assert torch.equal(leaf, want_leaf)


@pytest.mark.parametrize("learner", ["voting", "feature"])
def test_voting_and_feature_train_dense_under_tpu_sparse(
        sparse_data, warnings, learner):
    """tpu_sparse=true under the voting and feature-parallel learners:
    both packages warn and train the dense tree."""
    X, y, g, h = sparse_data
    params = dict(BASE, tree_learner=learner, tpu_sparse=True,
                  tpu_growth="exact", top_k=64, enable_bundle=False)
    cfg = JConfig(dict(params))
    td = JTrainingData.from_matrix(X, label=y, config=cfg)
    if learner == "voting":
        jl = jmesh.VotingParallelTreeLearner(cfg, td)
        jt = jl.materialize(jl.train_device(g, h)[0])
    else:
        jt, _ = jmesh.FeatureParallelTreeLearner(cfg, td).train(g, h)
    out = _port_trees(X, y, g, h, params, 2,
                      rows="all" if learner == "feature" else "blocks")
    want = ("tpu_sparse=true ignored: the sparse device store supports "
            "the serial and data-parallel learners only")
    assert want in warnings["jax"]
    assert warnings["port"].count(want) == 2          # once a rank
    dense = _port_trees(X, y, g, h, dict(params, tpu_sparse=False), 2,
                        rows="all" if learner == "feature" else "blocks")
    for (host, _, lr), (dhost, _, _) in zip(out, dense):
        assert not lr.sparse and torch.is_tensor(lr.X)
        assert _structure(host) == _structure(dhost) == _structure(jt)
        np.testing.assert_array_equal(host.leaf_value, dhost.leaf_value)


def test_data_parallel_drops_the_sparse_kernel(sparse_data, warnings):
    """tpu_sparse_kernel=true under the data-parallel learner: warned and
    dropped for the coordinate store (exact growth under auto), in both
    packages; the trees are the coordinate store's."""
    X, y, g, h = sparse_data
    params = dict(BASE, tree_learner="data", tpu_sparse=True,
                  tpu_sparse_kernel=True)
    cfg = JConfig(dict(params))
    td = JTrainingData.from_matrix(X, label=y, config=cfg)
    dp = jmesh.DataParallelTreeLearner(cfg, td,
                                       jmesh.make_data_mesh(jax.devices()))
    assert dp.hist_mode == "sparse" and dp.growth == "exact"
    jt = dp.materialize(dp.train_device(g, h)[0])
    out = _port_trees(X, y, g, h, params, 2)
    want = ("tpu_sparse_kernel=true ignored under the data-parallel "
            "learner (the mesh sparse grow shards the coordinate store)")
    assert want in warnings["jax"]
    assert warnings["port"].count(want) == 2
    for host, _, lr in out:
        assert lr.sparse_mode == "sparse" and lr.growth == "exact"
        assert isinstance(lr.X, tss.SparseDeviceStore)
        assert _structure(host) == _structure(jt)
