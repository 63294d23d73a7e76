"""The distributed tree learners: data-, voting- and feature-parallel.

Ported from the JAX package's ``parallel/mesh.py`` (the name is kept so a
reader finds the counterpart; there is no mesh here).  The JAX package
drives one SPMD program over a device mesh from one process and psums
inside it; the port runs one process a rank, each with one device, and
its growers call the comm's collectives (``parallel/comm.py``) where the
JAX package's grow programs psum (``ops/wave.py``, ``ops/grow.py``):

* data-parallel: each rank holds a contiguous block of the rows (its own
  ``TrainingData``, from ``from_matrix(comm=)`` or ``from_binned(comm=)``)
  and the histograms are summed over the ranks -- once a wave under wave
  growth, the kernels' int64 fixed-point sums before their conversion,
  so every rank holds the serial kernel's histogram of all rows and picks
  the same splits (data_parallel_tree_learner.cpp:148-222); the root's
  weight rows are gathered and summed as the serial run sums them, so
  the leaves' sums are the serial run's bits too.  With ``tpu_sparse``
  each rank holds the coordinate store of its rows, padded to the size
  the ranks agree on, and the integer sums of the cells an entry can
  hold are all-reduced (the JAX package's sharded store);
* voting-parallel: the same row blocks, exact growth, and only the
  features the ranks vote for cross the wire
  (voting_parallel_tree_learner.cpp:164-300);
* feature-parallel: every rank holds all rows, grows histograms of a
  contiguous block of features, and the ranks fold their best splits;
  the owner of the split's feature sends the go-left mask
  (feature_parallel_tree_learner.cpp:52-76).

Each rank keeps its own scores, gradients and leaf ids: a rank's rows are
its local rows, so no pad rows are needed to give the ranks equal shapes
(only the feature-parallel learner pads its features, ``pad_rows``).

The distributed wave learner keeps the serial prior of kernels (B1 where
``ncols x bin_pad <= 2560``, ops/autotune.py); the JAX package kept
``pallas_t`` under its data mesh only because it had no data-parallel
measurement on the TPU.  The port's kernels give the same bits either
way.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io.dataset import TrainingData
from ..ops.learner import DISTRIBUTED_LEARNERS, SerialTreeLearner, _val
from ..ops.sparse_store import (assemble_sharded_store,
                                sharded_store_parts, store_cells,
                                upload_store)
from ..ops.split_finder import FeatureMeta
from ..utils.config import Config
from ..utils.log import Log

_KINDS = {"data": "data", "data_parallel": "data",
          "voting": "voting", "voting_parallel": "voting",
          "feature": "feature", "feature_parallel": "feature"}


def pad_rows(n: int, num_shards: int) -> int:
    """Rows padded so each shard holds the same count."""
    return (-n) % num_shards


def feature_block(num_features: int, size: int, rank: int):
    """(offset, width): the contiguous feature block of ``rank`` of the
    feature-parallel learner, the features padded to a multiple of the
    ranks (JAX ``mesh.py``: a padded feature takes one bin)."""
    f = max(int(num_features), 1)
    width = (f + pad_rows(f, size)) // size
    return rank * width, width


def _record_collectives(learner, before) -> None:
    """A grown tree's collective traffic: ``last_collective`` (calls,
    bytes, host seconds) and, under an enabled observer, the
    ``lgbm_collective_bytes_total`` counter."""
    st = learner.comm.stats
    delta = {k: st[k] - before[k] for k in st}
    learner.last_collective = delta
    if learner._m_coll is not None:
        learner._m_coll.inc(delta["bytes"])


class _Distributed:
    """What the three learners share: the comm, the collective counter and
    the per-tree traffic record."""

    distributed = True
    _m_coll = None
    last_collective = None
    # each rank's rows, in rank order (the row-sharded learners)
    rank_rows = None

    def set_observer(self, obs) -> None:
        SerialTreeLearner.set_observer(self, obs)
        self._m_coll = None
        if getattr(obs, "enabled", False):
            from ..obs import REGISTRY
            self._m_coll = REGISTRY.counter(
                "lgbm_collective_bytes_total",
                "bytes moved by the learners' tensor collectives during "
                "tree growth")

    def _grow_kw(self) -> dict:
        kw = super()._grow_kw()
        kw.update(comm=self.comm, global_rows=self.global_rows,
                  rank_rows=self.rank_rows)
        return kw

    def _exact_kw(self) -> dict:
        kw = super()._exact_kw()
        kw["parallel"] = self.parallel
        return kw

    def train_device(self, grad, hess, row_mult=None):
        before = dict(self.comm.stats)
        out = SerialTreeLearner.train_device(self, grad, hess, row_mult)
        _record_collectives(self, before)
        return out

    def obs_info(self) -> dict:
        info = SerialTreeLearner.obs_info(self)
        info.update(rank=int(self.comm.rank),
                    world_size=int(self.comm.size),
                    collectives=self.collective_info())
        return info


class DataParallelTreeLearner(_Distributed, SerialTreeLearner):
    """Row-sharded learner: this rank's rows, histograms summed over the
    ranks.  ``train_data`` holds this rank's rows; the ranks must have
    built it with one binning (``from_matrix(comm=)``, ``from_binned``)."""

    parallel = "data"

    def __init__(self, config: Config, train_data: TrainingData, device,
                 comm):
        self.comm = comm
        self.rank_rows = tuple(int(n) for n in comm.allgather_obj(
            int(train_data.num_data)))
        self.global_rows = sum(self.rank_rows)
        super().__init__(config, train_data, device)
        Log.info("%s: rank %d of %d, %d of %d rows", type(self).__name__,
                 comm.rank, comm.size, train_data.num_data,
                 self.global_rows)

    def _coordinate_store(self, binned, fill, nbins: int, device):
        """This rank's block of the coordinate store, with local row ids,
        padded to the entries and column window the ranks agree on (the
        most of any rank's), so every rank's store has one shape (JAX
        ``parallel/mesh.py``: the sparse analog of the distributed
        bin-mapper agreement); its cells are the segments an entry can
        hold, the only ones its histograms' all-reduce sends."""
        parts, nnz, col_cap = sharded_store_parts(binned, fill, nbins, 1)
        agreed = self.comm.allgather_obj([int(nnz), int(col_cap)])
        nnz = max(a[0] for a in agreed)
        col_cap = max(a[1] for a in agreed)
        store, nbytes = assemble_sharded_store(parts, binned.shape[1],
                                               nbins, nnz, col_cap)
        td = self.train_data
        bins_per_col = (td.bundle.num_group_bins if td.bundle is not None
                        else td.num_bin_arr if td.num_features else [1])
        cells = store_cells(bins_per_col, fill, nbins, device)
        return upload_store(store, device, cells), nbytes

    def collective_info(self) -> dict:
        """The learner's collectives and their bytes: a wave all-reduces
        the W smaller children's K x F x B x 3 sums, 8 bytes each (the
        int64 fixed point of the f32 form, or the f64 form's finished
        histograms); exact growth one leaf's F x B x 3."""
        f = max(self.train_data.num_features, 1)
        b = int(self.num_bins)
        info = {"learner": type(self).__name__, "axis": "data",
                "n_devices": int(self.comm.size),
                "n_processes": int(self.comm.size),
                "global_rows": int(self.global_rows)}
        if self.growth == "wave":
            info["all_reduce"] = {
                "what": "wave histogram sums (W splits a collective)",
                "per_wave_bytes": f * b * 3 * int(self.wave_width) * 8}
        else:
            info["all_reduce"] = {"what": "per-leaf histogram",
                                  "per_leaf_bytes": f * b * 3 * 8}
        return info


class VotingParallelTreeLearner(DataParallelTreeLearner):
    """Data-parallel with PV-Tree top-k histogram exchange under exact
    growth (``ops/grow.py VotingGrower``).  Exact when top_k >= the
    number of features."""

    parallel = "voting"

    def _resolve_growth(self, config, growth):
        return _exact_growth(config, "voting")

    def _exact_kw(self) -> dict:
        kw = super()._exact_kw()
        kw["voting_k"] = int(self.config.top_k)
        return kw

    def collective_info(self) -> dict:
        info = super().collective_info()
        k = int(self.config.top_k)
        size = 8 if self.dtype == torch.float64 else 4
        info["all_reduce"] = {
            "what": "PV-Tree voted histograms (top_k features a leaf) and "
                    "the (F,) proposals",
            "per_leaf_bytes": k * int(self.num_bins) * 3 * size
            + max(self.train_data.num_features, 1) * size, "top_k": k}
        return info


def _exact_growth(config: Config, kind: str) -> str:
    """The voting and feature-parallel learners run exact growth (the JAX
    package's grow program for them); a wave-only kernel refuses."""
    mode = _val(config, "tpu_histogram_mode")
    if mode in ("pallas_ct", "pallas_t"):
        Log.fatal("tpu_histogram_mode=%s is wave-only; the %s-parallel "
                  "learner's exact engine does not support it",
                  config.tpu_histogram_mode, kind)
    return "exact"


class FeatureParallelTreeLearner(_Distributed, SerialTreeLearner):
    """Feature-sharded learner: every rank holds all rows and grows the
    histograms of its contiguous block of features (exact growth,
    ``ops/grow.py FeatureParallelGrower``).  Refuses EFB bundles, as the
    JAX package does."""

    parallel = "feature"
    pages = False

    def __init__(self, config: Config, train_data: TrainingData, device,
                 comm):
        if train_data.bundle is not None:
            Log.fatal("The feature-parallel learner requires "
                      "enable_bundle=false (dataset was built with EFB)")
        self.comm = comm
        self.offset, self.width = feature_block(train_data.num_features,
                                                comm.size, comm.rank)
        self.global_rows = int(train_data.num_data)
        super().__init__(config, train_data, device)
        Log.info("Feature-parallel learner: rank %d of %d, features "
                 "[%d, %d) of %d", comm.rank, comm.size, self.offset,
                 self.offset + self.width, train_data.num_features)

    def _resolve_growth(self, config, growth):
        return _exact_growth(config, "feature")

    def _padded(self, arr, fill):
        f = len(arr)
        total = self.width * self.comm.size
        return np.concatenate([np.asarray(arr, np.int64),
                               np.full(max(total - f, 0), fill, np.int64)])

    def _feature_meta(self, train_data, device) -> FeatureMeta:
        """The padded global metadata (a padded feature takes one bin);
        the block's is ``local_meta``."""
        if train_data.num_features == 0:
            nb, db, cat = np.array([1]), np.array([0]), np.array([False])
        else:
            nb, db = train_data.num_bin_arr, train_data.default_bin_arr
            cat = train_data.is_categorical_arr
        num_bin = self._padded(nb, 1)
        default = self._padded(db, 0)
        is_cat = self._padded(np.asarray(cat, np.int64), 0).astype(bool)
        lo, hi = self.offset, self.offset + self.width

        def meta(a, b, c):
            return FeatureMeta(
                num_bin=torch.as_tensor(a.astype(np.int32), device=device),
                default_bin=torch.as_tensor(b.astype(np.int32),
                                            device=device),
                is_categorical=torch.as_tensor(c, device=device))
        self.local_meta = meta(num_bin[lo:hi], default[lo:hi],
                               is_cat[lo:hi])
        return meta(num_bin, default, is_cat)

    def _host_bins(self, train_data: TrainingData) -> np.ndarray:
        """This rank's block of feature columns of all rows (padded
        columns are zeros)."""
        binned = train_data.binned
        n = train_data.num_data
        lo = self.offset
        block = np.zeros((n, self.width), binned.dtype if binned.size
                         else np.uint8)
        hi = min(lo + self.width, binned.shape[1])
        if hi > lo:
            block[:, :hi - lo] = binned[:, lo:hi]
        return block

    def _exact_kw(self) -> dict:
        kw = super()._exact_kw()
        kw.update(local_meta=self.local_meta, feature_offset=self.offset)
        return kw

    def collective_info(self) -> dict:
        """A split all-gathers the ranks' packed best splits (15 floats
        each) and all-reduces the owner's (N,) go-left mask (a byte a
        row)."""
        size = 8 if self.dtype == torch.float64 else 4
        return {"learner": type(self).__name__, "axis": "feature",
                "n_devices": int(self.comm.size),
                "n_processes": int(self.comm.size),
                "global_rows": int(self.train_data.num_data),
                "all_gather": {"what": "packed SplitInfo a split",
                               "per_split_bytes":
                                   15 * size * int(self.comm.size)},
                "all_reduce": {"what": "the go-left mask a split",
                               "per_split_bytes":
                                   int(self.train_data.num_data)}}


def create_tree_learner(config: Config, train_data: TrainingData, device,
                        comm=None, device_store=None):
    """TreeLearner::CreateTreeLearner (tree_learner.h:19-82): 'serial', or
    'data'/'voting'/'feature' (and their ``_parallel`` aliases) over the
    ranks of ``comm`` (default: the training data's); with one rank, or
    none, the serial learner, as the JAX package falls back on one
    device."""
    ltype = _val(config, "tree_learner")
    if ltype not in ("serial",) + DISTRIBUTED_LEARNERS:
        Log.fatal("Unknown tree learner type %s", config.tree_learner)
    if comm is None:
        comm = getattr(train_data, "_comm", None)
    if (comm is None or comm.size <= 1 or getattr(comm, "closed", False)
            or ltype == "serial"):
        return SerialTreeLearner(config, train_data, device,
                                 device_store=device_store)
    kind = _KINDS[ltype]
    cls = {"data": DataParallelTreeLearner,
           "voting": VotingParallelTreeLearner,
           "feature": FeatureParallelTreeLearner}[kind]
    return cls(config, train_data, device, comm)
