"""Training dataset: binned column store + metadata (host side, numpy).

Parity target: src/io/dataset.cpp + src/io/dataset_loader.cpp, the
in-memory ``from_matrix``, sparse ``from_csc`` and text-file
``from_file`` paths of the JAX package's ``io/dataset.py``, its row
``subset`` and its binary dataset files (``save_binary``/``load_binary``,
the same format: a file either package writes loads in the other), and
its out-of-core paths: two-round streaming (``from_streamed``, and
``from_file`` for large files or under ``use_two_round_loading`` /
``ooc_binned_dir``; io/streaming.py) and the pre-binned directory
format (``save_binned``/``from_binned``; io/binned_format.py), whose
shards stay mmap-backed until something asks for the whole matrix.
The binned matrix is a dense row-major ``(num_data, num_used_columns)``
uint8/uint16 array; with EFB its columns are feature groups
(io/bundle.py).  Binned bytes, mapper dicts and the bundle layout are
byte-identical to the JAX package's on the same input.

Reference flow mirrored here (dataset_loader.cpp:159-216,661-840):
sample rows -> per-feature BinMapper.find_bin -> drop trivial features ->
EFB on the binning sample -> bin all rows -> metadata check.
"""
from __future__ import annotations

import json
import os
import time
import zipfile
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..utils.config import Config
from ..utils.log import Log
from ..utils.random import Random
from .binning import CATEGORICAL, NUMERICAL, BinMapper
from .bundle import (BundleLayout, bin_rows_grouped, build_layout,
                     find_feature_groups)
from .metadata import Metadata
from . import parser as _parser
from .streaming import _peak_rss_bytes

# dense text files larger than this stream in two rounds
# (io/streaming.py) instead of being parsed whole, as in the JAX package
STREAM_BYTES = 256 << 20


class TrainingData:
    """The constructed dataset the tree learner consumes (the C++
    ``Dataset``, include/LightGBM/dataset.h:280)."""

    def __init__(self):
        self.num_data: int = 0
        self.num_total_features: int = 0
        # per total-feature BinMapper
        self.bin_mappers: List[Optional[BinMapper]] = []
        # inner (used) feature -> real feature index
        self.used_feature_idx: List[int] = []
        # real -> inner (-1 if unused), used_feature_map_ in the reference
        self.real_to_inner: Dict[int, int] = {}
        # the mmap-backed shard reader (io/binned_format.py) of a dataset
        # opened from, or streamed to, a pre-binned directory; the binned
        # property builds the matrix from it only on demand, so the
        # learner's paged upload never makes the whole host matrix
        self._binned_reader = None
        self._binned: Optional[np.ndarray] = None    # (N, F_used or G)
        self.metadata: Metadata = Metadata()
        self.feature_names: List[str] = []
        self.max_bin: int = 255
        # learner-facing per-inner-feature arrays
        self.num_bin_arr: Optional[np.ndarray] = None
        self.default_bin_arr: Optional[np.ndarray] = None
        self.is_categorical_arr: Optional[np.ndarray] = None
        # EFB layout (io/bundle.py); None = binned holds per-feature bins
        self.bundle: Optional[BundleLayout] = None
        # the float64 rows, kept (keep_raw) where a loaded model must be
        # scored on them (continued training)
        self.raw_data: Optional[np.ndarray] = None
        # the data-quality profile of the binning sample
        # (obs/dataquality.py, obs_data_profile); None where the binning
        # was copied from a reference
        self.data_profile: Optional[dict] = None
        # the per-feature drift fingerprint of the binning sample
        # (obs/drift.py feature_fingerprint, obs_drift_fingerprint): the
        # serving-time reference a model carries in its text
        self._drift_fingerprint: Optional[dict] = None
        # the construction's accounting for the dataset_construct event
        # (rows, phase seconds, peak RSS)
        self.construct_stats: Optional[dict] = None
        # the ranks' comm of a rank-sharded dataset (from_matrix or
        # from_binned with a comm of more than one rank), else None
        self._comm = None

    @property
    def binned(self) -> Optional[np.ndarray]:
        """The (N, F_used or G) bin matrix; built from the directory's
        shards on first access when the dataset is reader-backed."""
        if self._binned is None and self._binned_reader is not None:
            r = self._binned_reader
            lo, hi = r.row_range
            if (lo, hi) == (0, r.num_data):
                self._binned = r.matrix()
            else:
                self._binned = np.ascontiguousarray(r.rows(lo, hi))
        return self._binned

    @binned.setter
    def binned(self, value) -> None:
        self._binned = value

    # ------------------------------------------------------------- construct
    @classmethod
    def from_matrix(cls, data: np.ndarray, label=None,
                    config: Optional[Config] = None, weights=None,
                    init_score=None,
                    categorical_feature: Sequence[int] = (),
                    feature_names: Optional[List[str]] = None,
                    reference: Optional["TrainingData"] = None,
                    keep_raw: bool = False, group=None,
                    comm=None) -> "TrainingData":
        """comm: a HostComm of more than one rank (parallel/comm.py) makes
        ``data`` this rank's block of rows and constructs the bin mappers
        distributed (``_construct_mappers_distributed``), or, under
        ``tree_learner=feature``, all rows (binned as one process would);
        the dataset keeps the comm (``_comm``), which the booster's
        learner, metrics and observer read."""
        config = config or Config()
        data = np.ascontiguousarray(np.asarray(data, dtype=np.float64))
        if data.ndim != 2:
            Log.fatal("Data must be 2-dimensional")
        self = cls()
        self.num_data, self.num_total_features = data.shape
        self.max_bin = config.max_bin
        self.feature_names = list(feature_names) if feature_names else [
            "Column_%d" % i for i in range(self.num_total_features)]
        cats = set(int(c) for c in categorical_feature)
        self._comm = comm if (comm is not None and comm.size > 1) else None
        # the feature-parallel learner gives every rank all rows (as the
        # reference loads all data on every machine): the usual binning,
        # the same on every rank
        all_rows = str(config.tree_learner).strip().lower() in (
            "feature", "feature_parallel")
        if reference is not None:
            self._align_with(reference, data)
        elif self._comm is not None and not all_rows:
            rss0, t0 = _peak_rss_bytes(), time.time()
            # ranks agree on the RNG-bearing keys before any sampling
            # (GlobalSyncUpByMin, application.cpp:118-199)
            from ..parallel.comm import sync_config_across_ranks
            sync_config_across_ranks(comm, config)
            self._construct_mappers_distributed(data, config, cats, comm)
            t1 = time.time()
            self._bin_data(data)
            self._note_construct_stats("matrix", t1 - t0, time.time() - t1,
                                       rss0)
        else:
            rss0, t0 = _peak_rss_bytes(), time.time()
            self._construct_mappers(data, config, cats)
            t1 = time.time()
            self._bin_data(data)
            self._note_construct_stats("matrix", t1 - t0, time.time() - t1,
                                       rss0)
        if keep_raw:
            self.raw_data = data
        self._set_metadata(label, weights, init_score, group)
        return self

    @classmethod
    def from_file(cls, filename: str, config: Optional[Config] = None,
                  reference: Optional["TrainingData"] = None,
                  keep_raw: bool = False) -> "TrainingData":
        """CSV/TSV/space/LibSVM text file (dataset_loader.cpp:159-216):
        parse, label column, header names as feature names, ignored and
        categorical columns, then the ``.weight``/``.query``/``.init``
        side files.  A pre-binned directory opens as it is
        (``from_binned``).

        A dense file streams in two rounds (io/streaming.py, the
        reference's two-round loading) when ``wants_stream`` says so and
        ``keep_raw`` does not ask for its float64 rows; under
        ``ooc_binned_dir`` a training file (no ``reference``) is also
        persisted there as a binned directory, which then backs the
        dataset.  Otherwise the file is parsed in memory."""
        config = config or Config()
        if cls.can_load_binned(filename):
            return cls.from_binned(filename)
        if os.path.isdir(filename):
            Log.fatal("%s is a directory but not a pre-binned dataset "
                      "directory (no header.json)", filename)
        label_idx = 0
        header_names: Optional[List[str]] = None
        if config.has_header:
            header_names = _parser.read_header(filename)
        if config.label_column:
            lc = config.label_column
            if lc.startswith("name:"):
                name = lc[5:]
                if not header_names or name not in header_names:
                    Log.fatal("Could not find label column %s in data file",
                              name)
                label_idx = header_names.index(name)
            else:
                label_idx = int(lc)
        feature_names = None
        if header_names:
            feature_names = [n for i, n in enumerate(header_names)
                             if i != label_idx]
        categorical = _resolve_columns(config.categorical_column,
                                       feature_names)
        ignore = _resolve_columns(config.ignore_column, feature_names)
        from . import streaming as _streaming
        if cls.wants_stream(filename, config) and not keep_raw:
            if _streaming.stream_supported(filename, config.has_header):
                return cls._stream_file(filename, config, reference,
                                        label_idx, feature_names,
                                        categorical, ignore)
            if config.ooc_binned_dir and reference is None:
                # the JAX package parses it in memory and writes no
                # directory; the port does the same and says so
                Log.warning("ooc_binned_dir=%s ignored: out-of-core "
                            "streaming reads dense CSV/TSV/space files, "
                            "and %s is LibSVM; it is parsed in memory and "
                            "no directory is written "
                            "(Dataset(...).save_binned writes its bins)",
                            config.ooc_binned_dir, filename)
        parsed = _parser.parse_file(filename, has_header=config.has_header,
                                    label_idx=label_idx)
        data = parsed.features
        if ignore:
            keep = [i for i in range(data.shape[1]) if i not in ignore]
            data = data[:, keep]
            if feature_names:
                feature_names = [feature_names[i] for i in keep]
            categorical = {keep.index(c) for c in categorical if c in keep}
        self = cls.from_matrix(data, label=parsed.label, config=config,
                               categorical_feature=sorted(categorical),
                               feature_names=feature_names,
                               reference=reference, keep_raw=keep_raw)
        self.metadata.init_from_file(filename)
        return self

    @staticmethod
    def wants_stream(filename: str, config: Config) -> bool:
        """Whether from_file streams a dense file: asked for
        (``use_two_round_loading``, ``ooc_binned_dir``) or larger than
        ``STREAM_BYTES`` (JAX io/dataset.py:374-421)."""
        try:
            size = os.path.getsize(filename)
        except OSError:
            size = 0
        return bool(config.use_two_round_loading or config.ooc_binned_dir
                    or size > STREAM_BYTES)

    @classmethod
    def _stream_file(cls, filename: str, config: Config, reference,
                     label_idx: int, feature_names, categorical: set,
                     ignore: set) -> "TrainingData":
        """from_file's two-round path: the column count of ``ignore``
        comes from the first data lines only, and the side files load
        after the stream (and refresh a persisted directory's
        metadata)."""
        from . import binned_format as _bf
        from . import streaming as _streaming
        out_dir = (str(config.ooc_binned_dir)
                   if config.ooc_binned_dir and reference is None else None)
        self = cls()
        self.feature_names = feature_names or []
        keep = None
        if ignore:
            with open(filename, "r") as fh:
                if config.has_header:
                    fh.readline()
                head = [fh.readline() for _ in range(2)]
            probe = _parser.parse_text("".join(head), has_header=False,
                                       label_idx=label_idx)
            keep = [i for i in range(probe.features.shape[1])
                    if i not in ignore]
            if feature_names:
                self.feature_names = [feature_names[i] for i in keep]
            categorical = {keep.index(c) for c in categorical if c in keep}
        _streaming.stream_load(self, filename, config, label_idx,
                               categorical, keep, reference=reference,
                               out_dir=out_dir)
        if not self.feature_names:
            self.feature_names = ["Column_%d" % i
                                  for i in range(self.num_total_features)]
        self.metadata.init_from_file(filename)
        if out_dir:
            _bf.update_metadata(out_dir, self.metadata)
        return self

    @classmethod
    def from_csc(cls, sp, label=None, config: Optional[Config] = None,
                 weights=None, init_score=None,
                 categorical_feature: Sequence[int] = (),
                 feature_names: Optional[List[str]] = None,
                 reference: Optional["TrainingData"] = None,
                 group=None) -> "TrainingData":
        """Sparse ingestion without densification (SparseBin analog,
        sparse_bin.hpp:68 + dataset_loader.cpp:840-930).

        sp: io.sparse.SparseColumns.  Bin mappers come from each column's
        sampled NONZERO values (zeros are implicit in find_bin's total
        count, as the dense path drops them), EFB runs on the sample
        rebuilt sparsely, and binned columns are a default-bin fill plus a
        nonzero scatter: the N x F float64 matrix never exists."""
        config = config or Config()
        self = cls()
        n = sp.num_row
        self.num_data = n
        self.num_total_features = sp.num_col
        self.max_bin = config.max_bin
        self.feature_names = list(feature_names) if feature_names else [
            "Column_%d" % i for i in range(sp.num_col)]
        cats = set(int(c) for c in categorical_feature)
        if reference is not None:
            if sp.num_col != reference.num_total_features:
                Log.fatal("Validation data has %d features, train data "
                          "has %d", sp.num_col,
                          reference.num_total_features)
            self._copy_binning_from(reference)
            self._bin_sparse(sp)
        else:
            rss0, t0 = _peak_rss_bytes(), time.time()
            self._construct_mappers_sparse(sp, config, cats)
            t1 = time.time()
            self._bin_sparse(sp)
            self._note_construct_stats("csc", t1 - t0, time.time() - t1,
                                       rss0)
        self._set_metadata(label, weights, init_score, group)
        return self

    def _note_construct_stats(self, source: str, sketch_s: float,
                              bin_s: float, rss_before: int,
                              chunks: int = 1, write_s: float = 0.0,
                              workers: int = 1, **extra) -> None:
        """The dataset_construct event's fields (the JAX package's); an
        in-memory pass is one chunk, one worker and no shard write."""
        peak = _peak_rss_bytes()
        self.construct_stats = {
            "source": source, "rows": int(self.num_data),
            "chunks": int(chunks),
            "sketch_s": round(float(sketch_s), 6),
            "bin_s": round(float(bin_s), 6),
            "write_s": round(float(write_s), 6),
            "construct_s": round(float(sketch_s + bin_s + write_s), 6),
            "peak_rss_bytes": int(peak),
            "rss_growth_bytes": max(int(peak) - int(rss_before), 0),
            "workers": int(workers)}
        self.construct_stats.update(extra)

    def _profile_quality(self, get_col, sample_size: int, categorical: set,
                         config: Config) -> None:
        """The data-quality profile of the binning sample, which the
        booster emits as a ``data_profile`` event (``obs_data_profile``,
        on by default), and its drift fingerprint
        (``obs_drift_fingerprint``, on by default)."""
        if bool(config.obs_drift_fingerprint):
            from ..obs import drift
            self._drift_fingerprint = drift.feature_fingerprint(
                self.bin_mappers, get_col, self.num_total_features,
                sample_size, self.feature_names)
        if bool(config.obs_data_profile):
            from ..obs import dataquality
            self.data_profile = dataquality.profile_columns(
                self.bin_mappers, get_col, self.num_total_features,
                sample_size, categorical)

    def _set_metadata(self, label, weights, init_score, group=None) -> None:
        """The metadata fields; ``group`` holds the query sizes."""
        if label is not None:
            self.metadata.set_label(label)
        else:
            self.metadata.num_data = self.num_data
        if weights is not None:
            self.metadata.set_weights(weights)
        if init_score is not None:
            self.metadata.set_init_score(init_score)
        if group is not None:
            self.metadata.set_query_counts(group)

    def _sample_rows(self, config: Config) -> np.ndarray:
        """Row ids of the binning sample (dataset_loader.cpp:159-216)."""
        n = self.num_data
        rng = Random(config.data_random_seed)
        sample_idx = rng.sample(n, min(config.bin_construct_sample_cnt, n))
        if len(sample_idx) == 0:
            sample_idx = np.arange(n, dtype=np.int32)
        return sample_idx

    def _construct_mappers(self, data: np.ndarray, config: Config,
                           categorical: set) -> None:
        self._fit_mappers_from_sample(data[self._sample_rows(config)],
                                      config, categorical)

    def _fit_mappers_from_sample(self, sample: np.ndarray, config: Config,
                                 categorical: set) -> None:
        """Mappers, EFB and the quality profile from the drawn binning
        sample (the shared tail of one-round and two-round loading)."""
        total_sample = len(sample)
        # filter_cnt formula from dataset_loader.cpp:491-492
        filter_cnt = int(config.min_data_in_leaf * total_sample
                         / max(self.num_data, 1))

        self.bin_mappers = []
        for f in range(self.num_total_features):
            col = sample[:, f]
            col = col[~np.isnan(col)]
            nonzero = col[col != 0.0]
            m = BinMapper()
            bin_type = CATEGORICAL if f in categorical else NUMERICAL
            m.find_bin(nonzero, total_sample, config.max_bin,
                       config.min_data_in_bin, filter_cnt, bin_type)
            self.bin_mappers.append(m)
        self._finish_mappers(config, lambda: np.stack(
            [self.bin_mappers[r].value_to_bin(sample[:, r])
             .astype(np.uint16) for r in self.used_feature_idx], axis=1))
        self._profile_quality(lambda f: sample[:, f], total_sample,
                              categorical, config)

    def _construct_mappers_distributed(self, data: np.ndarray,
                                       config: Config, categorical: set,
                                       comm) -> None:
        """Distributed bin finding (dataset_loader.cpp:733-833; JAX
        ``io/dataset.py``): the features are split evenly across the
        ranks, each rank bins its block from a sample of its OWN rows,
        and the mappers are all-gathered so every rank holds the same
        full set.  EFB: rank 0 groups the features on its sample and the
        groups reach every rank (every rank's histograms need one
        layout)."""
        F = self.num_total_features
        n_local = data.shape[0]
        total_n = int(sum(comm.allgather_obj(int(n_local))))
        sample_idx = self._sample_rows(config)
        sample = data[sample_idx]
        total_sample = len(sample_idx)
        # filter_cnt against the GLOBAL row count (dataset_loader.cpp:491)
        filter_cnt = int(config.min_data_in_leaf * total_sample
                         / max(total_n, 1))
        bounds = np.linspace(0, F, comm.size + 1).astype(int)
        start, end = int(bounds[comm.rank]), int(bounds[comm.rank + 1])
        mine = []
        for f in range(start, end):
            col = sample[:, f]
            col = col[~np.isnan(col)]
            m = BinMapper()
            m.find_bin(col[col != 0.0], total_sample, config.max_bin,
                       config.min_data_in_bin, filter_cnt,
                       CATEGORICAL if f in categorical else NUMERICAL)
            mine.append(m.to_dict())
        self.bin_mappers = [BinMapper.from_dict(d)
                            for part in comm.allgather_obj(mine)
                            for d in part]
        if len(self.bin_mappers) != F:
            Log.fatal("distributed bin finding gathered %d mappers for %d "
                      "features", len(self.bin_mappers), F)
        bundle_cfg = config.enable_bundle
        # the groups come from rank 0 below, not from each rank's sample
        config.enable_bundle = False
        try:
            self._finish_mappers(config, None)
        finally:
            config.enable_bundle = bundle_cfg
        # this rank's sample: the profile reflects its block of rows; the
        # drift fingerprint is rank 0's on every rank, so the ranks' model
        # texts stay equal
        self._profile_quality(lambda f: sample[:, f], total_sample,
                              categorical, config)
        self._drift_fingerprint = comm.allgather_obj(
            self._drift_fingerprint)[0]
        if (config.enable_bundle and len(self.used_feature_idx) > 1
                and config.tree_learner not in ("feature",
                                                "feature_parallel")):
            groups = None
            if comm.rank == 0:
                layout = find_feature_groups(
                    np.stack([self.bin_mappers[r].value_to_bin(sample[:, r])
                              .astype(np.uint16)
                              for r in self.used_feature_idx], axis=1),
                    self.num_bin_arr, self.default_bin_arr,
                    config.max_conflict_rate, config.min_data_in_leaf,
                    total_n)
                if layout is not None:
                    groups = [list(map(int, g)) for g in layout.groups]
            groups = comm.allgather_obj(groups)[0]
            if groups is not None:
                self.bundle = build_layout(groups, self.num_bin_arr,
                                           self.default_bin_arr)
                if comm.rank == 0:
                    Log.info("EFB bundled %d features into %d groups",
                             len(self.used_feature_idx),
                             self.bundle.num_groups)

    def _construct_mappers_sparse(self, sp, config: Config,
                                  categorical: set) -> None:
        n = sp.num_row
        sample_idx = self._sample_rows(config)
        total_sample = len(sample_idx)
        # row -> sample position (or -1): each column's sampled nonzeros
        # come from one O(column nnz) lookup
        sample_pos = np.full(n, -1, dtype=np.int64)
        sample_pos[np.asarray(sample_idx, dtype=np.int64)] = \
            np.arange(total_sample)
        filter_cnt = int(config.min_data_in_leaf * total_sample / max(n, 1))

        self.bin_mappers = []
        col_sample = []
        for f in range(sp.num_col):
            rows, vals = sp.column(f)
            pos = sample_pos[rows]
            sel = pos >= 0
            sv, spos = vals[sel], pos[sel]
            # NaN entries stay in the sample: the dense EFB sample bins
            # them with value_to_bin, and only find_bin drops them
            col_sample.append((spos, sv))
            fb = sv[~np.isnan(sv)]
            m = BinMapper()
            bin_type = CATEGORICAL if f in categorical else NUMERICAL
            m.find_bin(fb[fb != 0.0], total_sample, config.max_bin,
                       config.min_data_in_bin, filter_cnt, bin_type)
            self.bin_mappers.append(m)
        del sample_pos

        def binned_sample():
            # the sample's bins rebuilt sparsely: default fill + scatter
            out = np.empty((total_sample, len(self.used_feature_idx)),
                           np.uint16)
            for i, r in enumerate(self.used_feature_idx):
                col = np.full(total_sample, self.default_bin_arr[i],
                              np.uint16)
                spos, sv = col_sample[r]
                if len(spos):
                    col[spos] = self.bin_mappers[r].value_to_bin(sv)
                out[:, i] = col
            return out
        self._finish_mappers(config, binned_sample)

        def sampled_column(f):
            # the sampled column with its implicit zeros (NaN kept)
            spos, sv = col_sample[f]
            col = np.zeros(total_sample, dtype=np.float64)
            if len(spos):
                col[spos] = sv
            return col
        self._profile_quality(sampled_column, total_sample, categorical,
                              config)

    def _finish_mappers(self, config: Config, binned_sample) -> None:
        """The shared tail of mapper construction: used features, the
        per-feature arrays, the single-bucket warning, and EFB on the
        binning sample (Dataset::Construct, dataset.cpp:229-235), whose
        (S, F_used) uint16 bins binned_sample() builds."""
        self.used_feature_idx = [i for i, m in enumerate(self.bin_mappers)
                                 if m is not None and not m.is_trivial]
        if not self.used_feature_idx:
            Log.warning("There are no meaningful features, as all feature "
                        "values are constant.")
        self.real_to_inner = {r: i for i, r in
                              enumerate(self.used_feature_idx)}
        self._build_feature_arrays()
        single = [i for i, m in enumerate(self.bin_mappers)
                  if m is not None and m.num_bin <= 1]
        if single:
            head = ",".join(str(i) for i in single[:20])
            Log.warning(
                "%d feature(s) binned into a single bucket (constant, "
                "never splittable): %s%s", len(single), head,
                ",..." if len(single) > 20 else "")
        if (config.enable_bundle and len(self.used_feature_idx) > 1
                and config.tree_learner not in ("feature",
                                                "feature_parallel")):
            self.bundle = find_feature_groups(
                binned_sample(), self.num_bin_arr, self.default_bin_arr,
                config.max_conflict_rate, config.min_data_in_leaf,
                self.num_data)
            if self.bundle is not None:
                Log.info("EFB bundled %d features into %d groups",
                         len(self.used_feature_idx), self.bundle.num_groups)

    def _bin_sparse(self, sp) -> None:
        """Binned matrix from CSC columns: a default-bin fill plus the
        nonzero scatter of each column (no float64 intermediate)."""
        n = sp.num_row
        f_used = len(self.used_feature_idx)

        def dense_binned_col(i):
            r = self.used_feature_idx[i]
            mapper = self.bin_mappers[r]
            rows, vals = sp.column(r)
            col = np.full(n, mapper.value_to_bin(0.0), dtype=np.int64)
            if len(rows):
                col[rows] = mapper.value_to_bin(vals)
            return col

        if self.bundle is not None:
            self.binned = bin_rows_grouped(dense_binned_col, self.bundle,
                                           self.default_bin_arr)
            return
        max_num_bin = int(self.num_bin_arr.max()) if f_used else 2
        dtype = np.uint8 if max_num_bin <= 256 else np.uint16
        out = np.empty((n, f_used), dtype=dtype)
        for i in range(f_used):
            out[:, i] = dense_binned_col(i).astype(dtype)
        self.binned = out

    def _align_with(self, reference: "TrainingData",
                    data: np.ndarray) -> None:
        """Valid set shares the train set's mappers and EFB layout
        (dataset_loader.cpp:220-261 CreateValid path)."""
        if data.shape[1] != reference.num_total_features:
            Log.fatal("Validation data has %d features, train data has %d",
                      data.shape[1], reference.num_total_features)
        self._copy_binning_from(reference)
        self._bin_data(data)

    def _copy_binning_from(self, reference: "TrainingData") -> None:
        """Share the train set's binning state: mappers, used features,
        per-feature arrays and EFB layout (dataset_loader.cpp:220-261)."""
        self.bin_mappers = reference.bin_mappers
        self.used_feature_idx = list(reference.used_feature_idx)
        self.real_to_inner = dict(reference.real_to_inner)
        self.num_bin_arr = reference.num_bin_arr
        self.default_bin_arr = reference.default_bin_arr
        self.is_categorical_arr = reference.is_categorical_arr
        self.max_bin = reference.max_bin
        self.bundle = reference.bundle

    def _build_feature_arrays(self) -> None:
        used = self.used_feature_idx
        self.num_bin_arr = np.asarray(
            [self.bin_mappers[r].num_bin for r in used], dtype=np.int32)
        self.default_bin_arr = np.asarray(
            [self.bin_mappers[r].default_bin for r in used], dtype=np.int32)
        self.is_categorical_arr = np.asarray(
            [self.bin_mappers[r].bin_type == CATEGORICAL for r in used],
            dtype=bool)

    def _bin_data(self, data: np.ndarray) -> None:
        n = data.shape[0]
        self.num_data = n
        f_used = len(self.used_feature_idx)
        if self.bundle is not None:
            def getcol(i):
                r = self.used_feature_idx[i]
                return self.bin_mappers[r].value_to_bin(data[:, r])
            self.binned = bin_rows_grouped(getcol, self.bundle,
                                           self.default_bin_arr)
            return
        max_num_bin = int(self.num_bin_arr.max()) if f_used else 2
        dtype = np.uint8 if max_num_bin <= 256 else np.uint16
        out = np.zeros((n, f_used), dtype=dtype)
        for i, r in enumerate(self.used_feature_idx):
            out[:, i] = self.bin_mappers[r].value_to_bin(
                data[:, r]).astype(dtype)
        self.binned = out

    # ------------------------------------------------------------- accessors
    @property
    def num_features(self) -> int:
        return len(self.used_feature_idx)

    def real_feature_index(self, inner_idx: int) -> int:
        return self.used_feature_idx[inner_idx]

    def feature_bin_mapper(self, inner_idx: int) -> BinMapper:
        return self.bin_mappers[self.used_feature_idx[inner_idx]]

    def feature_infos(self) -> List[str]:
        """Per total-feature info string for the model file
        (dataset.h:514-526)."""
        out = []
        for i in range(self.num_total_features):
            if self.real_to_inner.get(i, -1) == -1:
                out.append("none")
            else:
                out.append(self.bin_mappers[i].bin_info())
        return out

    def bin_rows(self, lo: int = 0, hi: Optional[int] = None):
        """(hi - lo, num_total_features) float64: the rows' bins as the
        value each bin stands for (``BinMapper.bin_to_value``: a
        numerical bin's upper bound, a categorical bin's category; 0 in
        the unused columns), or None where the bins are EFB groups.  A
        tree grown on these bins routes each such row as the training
        routed its bins, so a model continues training on a dataset
        that keeps only its bins (a pre-binned directory)."""
        if self.bundle is not None or self.binned is None:
            return None
        binned = self.binned[lo:hi]
        out = np.zeros((binned.shape[0], self.num_total_features))
        for inner, real in enumerate(self.used_feature_idx):
            m = self.bin_mappers[real]
            table = (np.asarray(m.bin_upper_bound, np.float64)
                     if m.bin_type == NUMERICAL
                     else np.asarray(m.bin_2_categorical, np.float64))
            out[:, real] = table[binned[:, inner]]
        return out

    def subset(self, indices: np.ndarray) -> "TrainingData":
        """The rows ``indices`` of the binned matrix and the metadata,
        sharing this dataset's mappers and EFB layout (dataset.cpp:399
        CopySubset; query fields do not carry over, as in the JAX
        package)."""
        out = TrainingData()
        out.num_data = len(indices)
        out.num_total_features = self.num_total_features
        out._copy_binning_from(self)
        out.feature_names = self.feature_names
        out.binned = self.binned[indices]
        out.metadata = self.metadata.subset(indices)
        if self.raw_data is not None:
            out.raw_data = self.raw_data[indices]
        return out

    # ------------------------------------------------------- binary file I/O
    _BINARY_MAGIC = "lightgbm_tpu.dataset.v1"

    def save_binary(self, filename: str) -> None:
        """Binary dataset file (dataset.cpp:489 SaveBinaryFile analog): the
        JAX package's npz layout, a JSON ``meta`` entry (magic, sizes,
        used features, names, max_bin, mapper dicts, EFB groups) beside
        the binned matrix and the metadata arrays."""
        meta = {
            "magic": self._BINARY_MAGIC,
            "num_data": self.num_data,
            "num_total_features": self.num_total_features,
            "used_feature_idx": self.used_feature_idx,
            "feature_names": self.feature_names,
            "max_bin": self.max_bin,
            "bin_mappers": [None if m is None else m.to_dict()
                            for m in self.bin_mappers],
            "bundle_groups": (None if self.bundle is None
                              else [list(map(int, g))
                                    for g in self.bundle.groups]),
        }
        arrays = {"binned": self.binned}
        md = self.metadata
        for key, value in (("label", md.label), ("weights", md.weights),
                           ("query_boundaries", md.query_boundaries),
                           ("init_score", md.init_score)):
            if value is not None:
                arrays[key] = value
        # through a handle: np.savez_compressed(<str>) would append .npz
        # to a name such as train.bin
        with open(filename, "wb") as f:
            np.savez_compressed(f, meta=json.dumps(meta), **arrays)

    @classmethod
    def can_load_binary(cls, filename: str) -> bool:
        """Whether ``filename`` is a binary dataset file of this format."""
        try:
            with np.load(filename, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"]))
            return meta.get("magic") == cls._BINARY_MAGIC
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            return False

    @classmethod
    def load_binary(cls, filename: str) -> "TrainingData":
        """A dataset save_binary (of either package) wrote."""
        with np.load(filename, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            if meta.get("magic") != cls._BINARY_MAGIC:
                Log.fatal("Not a lightgbm_tpu binary dataset file: %s",
                          filename)
            self = cls()
            self.num_data = meta["num_data"]
            self.num_total_features = meta["num_total_features"]
            self.used_feature_idx = list(meta["used_feature_idx"])
            self.real_to_inner = {r: i for i, r in
                                  enumerate(self.used_feature_idx)}
            self.feature_names = meta["feature_names"]
            self.max_bin = meta["max_bin"]
            self.bin_mappers = [None if d is None else BinMapper.from_dict(d)
                                for d in meta["bin_mappers"]]
            self._build_feature_arrays()
            groups = meta.get("bundle_groups")
            if groups is not None:
                self.bundle = build_layout(groups, self.num_bin_arr,
                                           self.default_bin_arr)
            self.binned = z["binned"]
            self.metadata = Metadata(self.num_data)
            if "label" in z:
                self.metadata.label = z["label"]
            if "weights" in z:
                self.metadata.weights = z["weights"]
            if "query_boundaries" in z:
                self.metadata.query_boundaries = z["query_boundaries"]
            if "init_score" in z:
                self.metadata.init_score = z["init_score"]
        return self

    # ------------------------------------------- the pre-binned directory
    @classmethod
    def from_streamed(cls, data, label=None, config: Optional[Config] = None,
                      weights=None, group=None, init_score=None,
                      categorical_feature: Sequence[int] = (),
                      feature_names: Optional[List[str]] = None,
                      reference: Optional["TrainingData"] = None,
                      out_dir: Optional[str] = None,
                      chunk_rows: Optional[int] = None) -> "TrainingData":
        """Two-round construction (io/streaming.py) from an in-memory
        matrix, a ``.npy`` path or SparseColumns; text files stream
        through from_file.  ``out_dir`` persists the result as a binned
        directory, which then backs the dataset (no host matrix)."""
        from . import binned_format as _bf
        from . import streaming as _streaming
        config = config or Config()
        chunk = int(chunk_rows or config.ooc_chunk_rows
                    or _streaming.DEFAULT_CHUNK_ROWS)
        if hasattr(data, "colptr"):          # SparseColumns
            source = _streaming.SparseSource(data, label=label,
                                             chunk_rows=chunk)
        else:
            source = _streaming.MatrixSource(data, label=label,
                                             chunk_rows=chunk)
        self = cls()
        self.feature_names = list(feature_names) if feature_names else []
        cats = set(int(c) for c in categorical_feature)
        _streaming.stream_construct(self, source, config, categorical=cats,
                                    reference=reference, out_dir=out_dir)
        if not self.feature_names:
            self.feature_names = ["Column_%d" % i
                                  for i in range(self.num_total_features)]
        self._set_metadata(None, weights, init_score, group)
        if out_dir and (weights is not None or group is not None
                        or init_score is not None):
            _bf.update_metadata(out_dir, self.metadata)
        return self

    def save_binned(self, path: str) -> None:
        """Persist as a pre-binned directory (io/binned_format.py), which
        later runs open without binning."""
        from . import binned_format as _bf
        _bf.save_training_data(self, path)

    @classmethod
    def can_load_binned(cls, path) -> bool:
        """Whether ``path`` is a pre-binned dataset directory."""
        from . import binned_format as _bf
        return _bf.is_binned_dir(path)

    @classmethod
    def from_binned(cls, path: str, verify=None, row_range=None,
                    comm=None) -> "TrainingData":
        """Open a pre-binned dataset directory, written by either
        package.  The shards stay mmap-backed: no bin matrix exists
        until something asks for ``binned``, and the learner pages the
        shards to the card (ops/learner.py ``paged_device_matrix``).

        ``row_range=(start, stop)`` opens only those rows (their shards
        and metadata rows).  ``verify``: None runs a full CRC scan for a
        whole-dataset open and lazy per-shard CRCs for a row range;
        True, "lazy" or False force a mode.  A ``comm`` of more than one
        rank opens this rank's share, rows [rank * total // size,
        (rank + 1) * total // size) unless row_range says otherwise, for
        the distributed learners: the mappers come from the shared
        header, so the ranks bin alike with no collective."""
        from . import binned_format as _bf
        rss0, t0 = _peak_rss_bytes(), time.time()
        multi = comm is not None and comm.size > 1
        sharded = multi or row_range is not None
        if verify is None:
            verify = "lazy" if sharded else True
        if multi and row_range is None:
            total = int(_bf._read_header(str(path))["num_data"])
            row_range = (comm.rank * total // comm.size,
                         (comm.rank + 1) * total // comm.size)
        reader = _bf.BinnedReader(path, verify=verify, row_range=row_range)
        h = reader.header
        self = cls()
        lo, hi = reader.row_range
        self.num_data = hi - lo
        self.num_total_features = int(h["num_total_features"])
        self.used_feature_idx = list(h["used_feature_idx"])
        self.real_to_inner = {r: i for i, r in
                              enumerate(self.used_feature_idx)}
        self.feature_names = list(h["feature_names"])
        self.max_bin = int(h["max_bin"])
        self.bin_mappers = [None if d is None else BinMapper.from_dict(d)
                            for d in h["bin_mappers"]]
        self._build_feature_arrays()
        groups = h.get("bundle_groups")
        if groups is not None:
            self.bundle = build_layout(groups, self.num_bin_arr,
                                       self.default_bin_arr)
        self._binned_reader = reader
        self._comm = comm if multi else None
        # the training world's drift fingerprint rides in the header
        # (written by save_binned from a fingerprinted dataset)
        self._drift_fingerprint = h.get("drift_fingerprint")
        self.metadata = Metadata(self.num_data)

        def rows_of(arr):
            """The opened rows of a per-row sidecar, copied out of its
            memmap."""
            if arr is None or not sharded or arr.shape[0] == hi - lo:
                return None if arr is None else np.asarray(arr)
            return np.array(arr[lo:hi])

        self.metadata.label = rows_of(
            reader.load_metadata_array("label", mmap=sharded))
        self.metadata.weights = rows_of(
            reader.load_metadata_array("weights", mmap=sharded))
        qb = reader.load_metadata_array("query_boundaries")
        if qb is not None and sharded:
            Log.fatal("from_binned(row_range=) does not open ranking "
                      "(query_boundaries) datasets: query groups straddle "
                      "the cut")
        self.metadata.query_boundaries = qb
        self.metadata._update_query_weights()
        self.metadata.init_score = rows_of(
            reader.load_metadata_array("init_score", mmap=sharded))
        # sketch_s and bin_s stay 0: opening the format bins nothing
        extra = {"load_s": round(time.time() - t0, 6)}
        if sharded:
            extra["row_range"] = [int(lo), int(hi)]
            extra["world_size"] = int(comm.size) if multi else 1
        self._note_construct_stats("binned", 0.0, 0.0, rss0,
                                   chunks=reader.num_shards, **extra)
        return self


def _resolve_columns(spec: str, feature_names: Optional[List[str]]) -> set:
    """Parse 'name:a,b,c' or '0,1,2' column specs (dataset_loader.cpp:22-120
    SetHeader column-role resolution)."""
    out: set = set()
    if not spec:
        return out
    if spec.startswith("name:"):
        names = spec[5:].split(",")
        if feature_names:
            for nm in names:
                if nm in feature_names:
                    out.add(feature_names.index(nm))
                else:
                    Log.warning("Could not find column %s in data file", nm)
    else:
        for tok in spec.split(","):
            tok = tok.strip()
            if tok:
                out.add(int(tok))
    return out
