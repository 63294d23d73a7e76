"""Tree learner: host facade over the wave grower (ops/wave.py) and the
exact grower (ops/grow.py).

Ported from the JAX package's ``ops/learner.py`` (``SerialTreeLearner``).
The learner uploads the bin matrix once: transposed for the wave kernels
B1/B3, row-major for ``tpu_histogram_mode=pallas`` (B4 under wave growth,
B5 under exact growth) and for the XLA engines ``onehot`` and
``scatter`` (ops/histogram.py), or, with ``tpu_sparse`` and
``tpu_sparse_kernel``, only the non-fill entries in the entry-chunk
sparse store (ops/sparse_mxu.py), or, with ``tpu_sparse`` alone, in the
coordinate store (ops/sparse_store.py), whose auto growth is exact.  A
column of more than 256 bins makes the matrix uint16, as in the JAX
package; the kernels take both widths.
``tpu_use_dp`` makes the weights, histograms, split search and tree
values float64 (the kernels' f64 form).  A dataset backed by a pre-binned directory
(io/binned_format.py) pages its shards to the card one at a time
(``paged_device_matrix``), so the host never holds the whole matrix.
Under wave growth on the dense matrix, where every
column has at most 16 bins (``max_bin <= 15``), ``tpu_bin_pack=auto`` (or
``true``) stores it 4-bit packed, two columns a byte (ops/pack.py), as
the JAX package does; ``tpu_hist_precision=bf16`` selects the single
bf16 product of the wave kernels.  It samples feature_fraction masks,
feeds gradients to the grower and materializes finished trees
(real-valued thresholds resolved in float64 from the BinMappers).  Engine knobs that select
something this port does not have raise instead of being ignored.  At
construction the measured autotuner (ops/autotune.py) records, and under
``tpu_autotune=measure/force`` on the card probes, the kernel cell the
learner runs; its events wait for the run observer (``set_observer``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..io.dataset import TrainingData
from ..models.tree import Tree
from ..obs.events import NULL_OBSERVER
from ..utils.common import avoid_inf
from ..utils.config import Config, _FALSE_SET, _TRUE_SET
from ..utils.log import Log
from ..utils.random import Random
# kernel-selection policy lives in ops/autotune.py (the measured
# autotuner's prior); re-exported here, as the JAX package's learner does
from .autotune import (_order_sensitive, bin_pad, prior_hist_hilo,
                       prior_hist_mode, resolve_wave_order,
                       resolve_wave_width)
from .grow import BundleArrays, ExactGrower, grow_tree_exact
from .histogram import ENGINE_MODES
from .pack import can_pack4, pack4_host
from .sparse_mxu import (ChunkedSparseStore, build_chunked_store,
                         chunked_device_bytes)
from .sparse_store import (SparseDeviceStore, build_sparse_store,
                           column_fill_bins, store_device_bytes)
from .split_finder import FeatureMeta, SplitParams
from .wave import WaveGrower, grow_tree

# auto histogram-cache budget when histogram_pool_size is unset (-1)
_AUTO_HIST_CACHE_MB = 2048.0


def hist_cache_enabled(config: Config, num_leaves: int, num_cols: int,
                       num_bins: int, dtype_bytes: int) -> bool:
    """HistogramPool policy (feature_histogram.hpp:398-565): cache per-leaf
    histograms (larger child by subtraction) only while the (L, F, B, 3)
    cache fits the histogram_pool_size budget; otherwise recompute both
    children and warn with the number."""
    need_mb = (num_leaves * max(num_cols, 1) * max(num_bins, 2) * 3
               * dtype_bytes) / 1e6
    budget = float(config.histogram_pool_size)
    if budget <= 0:
        budget = _AUTO_HIST_CACHE_MB
    if need_mb <= budget:
        return True
    Log.warning(
        "Histogram cache would need %.0f MB (num_leaves=%d x %d columns x "
        "%d bins x 3 x %dB) > histogram_pool_size budget %.0f MB; disabling "
        "the per-leaf histogram cache (children are recomputed instead of "
        "obtained by subtraction).", need_mb, num_leaves, num_cols,
        num_bins, dtype_bytes, budget)
    return False


def build_bundle_arrays(train_data: TrainingData, device):
    """(BundleArrays, group_bins) for the grower, or (None, 0) when the
    dataset has no EFB layout."""
    bund = train_data.bundle
    if bund is None:
        return None, 0
    num_bin = np.asarray(train_data.num_bin_arr, np.int64)
    default = np.asarray(train_data.default_bin_arr, np.int64)
    B = int(num_bin.max())
    Bg = int(bund.num_group_bins.max())
    b = np.arange(B)[None, :]
    gb = bund.bin_off[:, None] + b - bund.bin_adj[:, None]
    valid = (b < num_bin[:, None]) & (b != default[:, None])
    flat_idx = bund.group_of[:, None].astype(np.int64) * Bg + gb
    flat_idx = np.clip(flat_idx, 0, len(bund.num_group_bins) * Bg - 1)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    arrays = BundleArrays(
        group_of=i32(bund.group_of), bin_off=i32(bund.bin_off),
        bin_adj=i32(bund.bin_adj), bin_span=i32(bund.bin_span),
        gather_idx=torch.as_tensor(flat_idx, dtype=torch.long,
                                   device=device),
        valid_mask=torch.as_tensor(valid, device=device),
    )
    return arrays, Bg


def build_split_params(config: Config) -> SplitParams:
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        min_gain_to_split=float(config.min_gain_to_split),
        min_data_in_leaf=float(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        use_missing=bool(config.use_missing),
    )


# the distributed learners' tree_learner values (parallel/mesh.py); with
# one rank each trains as the serial learner
DISTRIBUTED_LEARNERS = ("data", "voting", "feature", "data_parallel",
                        "voting_parallel", "feature_parallel")


def _unsupported(knob: str, value) -> None:
    Log.fatal("%s=%s selects an engine lightgbm_tpu_torch does not have "
              "yet (this port runs serial wave or exact growth with its "
              "kernels or the onehot/scatter engines, on the dense matrix "
              "or a sparse store)", knob, value)


def resolve_sparse(config: Config, parallel: str = "") -> str:
    """Which sparse store runs, as the JAX package resolves tpu_sparse and
    tpu_sparse_kernel (its ops/learner.py): '' (the dense matrix),
    'sparse' (the coordinate store, ops/sparse_store.py: tpu_sparse=true
    alone, under wave or exact growth, f32 or tpu_use_dp weights) or
    'sparse_mxu' (the entry-chunk store and kernel B6, with
    tpu_sparse_kernel=true: wave growth and f32 weights only).  The
    pallas kernels are dense-only.  parallel: the distributed learner
    ('' serial): the voting and feature-parallel learners train dense
    and the data-parallel learner on the coordinate store, each
    dropping the knob it cannot take with the JAX package's warning."""
    sparse = bool(config.tpu_sparse)
    kernel = bool(config.tpu_sparse_kernel)
    if sparse and parallel in ("voting", "feature"):
        Log.warning("tpu_sparse=true ignored: the sparse device store "
                    "supports the serial and data-parallel learners only")
        sparse = False
    if kernel and not sparse:
        Log.warning("tpu_sparse_kernel=true has no effect without "
                    "tpu_sparse=true")
        return ""
    if not sparse:
        return ""
    mode = str(config.tpu_histogram_mode).strip().lower()
    if mode.startswith("pallas"):
        Log.fatal("tpu_sparse=true is incompatible with "
                  "tpu_histogram_mode=%s (the pallas kernels are "
                  "dense-only)", config.tpu_histogram_mode)
    if kernel and parallel == "data":
        Log.warning("tpu_sparse_kernel=true ignored under the data-parallel "
                    "learner (the mesh sparse grow shards the coordinate "
                    "store)")
        kernel = False
    if not kernel:
        return "sparse"
    if str(config.tpu_growth).strip().lower() == "exact":
        Log.fatal("tpu_sparse_kernel=true requires wave growth "
                  "(tpu_growth=exact scans per leaf)")
    if bool(config.tpu_use_dp):
        # the JAX package runs its f32 kernel's XLA reference in f64
        # here; kernel B6 sums f32 weights, and no plain version stands
        # in for a kernel
        Log.fatal("tpu_use_dp=true with tpu_sparse_kernel=true: kernel B6 "
                  "of the entry-chunk store sums f32 weights (drop "
                  "tpu_use_dp, or train on the dense matrix or the "
                  "coordinate store)")
    return "sparse_mxu"


def _val(config: Config, name: str) -> str:
    return str(getattr(config, name)).strip().lower()


def resolve_growth(config: Config, sparse: str) -> str:
    """'wave' or 'exact', as the JAX package resolves tpu_growth on its
    accelerator (its ops/learner.py): auto is exact with
    tpu_histogram_mode=pallas, whose kernel is the exact grower's
    per-leaf histogram, and on the coordinate store (sparse 'sparse',
    whose auto growth the JAX package keeps exact), and wave otherwise
    (onehot, scatter and the entry-chunk store included); the wave-only
    kernels refuse exact growth."""
    growth = _val(config, "tpu_growth")
    mode = _val(config, "tpu_histogram_mode")
    if growth == "auto":
        growth = ("exact" if sparse == "sparse"
                  or (mode == "pallas" and not sparse) else "wave")
    if growth == "exact" and mode in ("pallas_ct", "pallas_t"):
        Log.fatal("tpu_histogram_mode=%s requires tpu_growth=wave (this "
                  "kernel is wave-only)", config.tpu_histogram_mode)
    return growth


def check_engine_params(config: Config, parallel: str = ""):
    """Raise on knob values whose engine this port lacks; accept the
    values that resolve to the engines it has.  Returns (sparse, growth):
    the sparse store that runs ('' for none, resolve_sparse under the
    learner ``parallel``) and the growth schedule (resolve_growth)."""
    def val(name):
        return _val(config, name)

    sparse = resolve_sparse(config, parallel)
    checks = [
        ("tree_learner", ("serial",) + DISTRIBUTED_LEARNERS),
        ("tpu_growth", ("auto", "wave", "exact")),
        ("tpu_histogram_mode", ("auto", "pallas", "pallas_ct", "pallas_t")
         + ENGINE_MODES),
        ("tpu_score_update", ("auto", "pallas", "gather")),
        ("tpu_fused_iter", ("auto", "on", "off")),
        ("tpu_autotune", ("off", "prior", "measure", "force")),
        ("tpu_wave_lookup", ("auto", "onehot", "compact", "gather")),
    ]
    for name, ok in checks:
        if val(name) not in ok:
            _unsupported(name, getattr(config, name))
    if val("tpu_hist_precision") not in ("auto", "hilo", "bf16"):
        Log.fatal("Unknown tpu_hist_precision %s (expected auto/hilo/bf16)",
                  config.tpu_hist_precision)
    if val("tpu_bin_pack") not in _TRUE_SET | _FALSE_SET | {"auto"}:
        Log.fatal("tpu_bin_pack: value %s cannot be parsed as auto/bool",
                  config.tpu_bin_pack)
    if int(config.tpu_wave_chunk) <= 0:
        Log.fatal("tpu_wave_chunk must be positive, got %s",
                  config.tpu_wave_chunk)
    growth = resolve_growth(config, sparse)
    # the wave width is read, and so checked, only under wave growth: an
    # exact-growth config with a leftover bad width keeps training, as in
    # the JAX package
    w = int(config.tpu_wave_width)
    if growth == "wave" and w <= 0 and w != -1:
        Log.fatal("tpu_wave_width must be positive or -1 (auto), got %d", w)
    return sparse, growth


def resolve_bin_pack(config: Config, growth: str, sparse: bool,
                     bins_per_col, hist_mode: str = "") -> bool:
    """Pack the bins 4-bit where the JAX package packs them (its
    ops/learner.py): tpu_bin_pack auto or true, wave growth or exact
    growth on the onehot/scatter engines, the dense matrix,
    ``tree_learner=serial`` (the distributed learners keep byte bins,
    even when one rank falls back to the serial learner) and at most 16
    bins in every device column.  A forced true that cannot be honoured
    warns, as there, with its reasons."""
    cfg = _val(config, "tpu_bin_pack")
    forced = cfg in _TRUE_SET
    fits = can_pack4(bins_per_col)
    growth_ok = growth == "wave" or (growth == "exact"
                                     and hist_mode in ENGINE_MODES)
    serial = _val(config, "tree_learner") == "serial"
    if ((forced or cfg == "auto") and growth_ok and not sparse and fits
            and serial):
        return True
    if forced:
        reasons = []
        if sparse:
            reasons.append("the dense device store (tpu_sparse keeps "
                           "coordinates, there are no bin bytes to pack)")
        elif not growth_ok:
            reasons.append("wave growth or exact growth with the "
                           "onehot/scatter histogram kernels")
        if not serial:
            reasons.append("the serial (single-shard) learner")
        if not fits:
            reasons.append("at most 16 bins per column (max_bin<=15 plus "
                           "the reserved zero/missing bin)")
        Log.warning("tpu_bin_pack=true ignored: packing requires %s",
                    " and ".join(reasons))
    return False


def resolve_wave_compact(config: Config, growth: str, hist_mode: str) -> bool:
    """tpu_wave_compact: accepted under wave growth with a transposed wave
    kernel (pallas_ct, pallas_t), elsewhere the JAX package's warning.
    The port records the choice and runs the ordinary full B1/B3 pass
    under it.  The JAX package's compaction gathers the rows of the
    wave's parents into capacity tiers (an XLA gather) because its TPU
    kernels touch every row; the port's list passes already send only
    the children's rows to the histogram pass, so a gather would save at
    most a leaf id read per spectator row at the price of another pass
    over every row (PERF.md, Findings).  The trees are the same either
    way."""
    if not bool(config.tpu_wave_compact):
        return False
    if growth == "wave" and hist_mode in ("pallas_ct", "pallas_t"):
        return True
    Log.warning("tpu_wave_compact=true ignored: requires wave growth with "
                "a transposed wave kernel (pallas_ct/pallas_t) (resolved "
                "growth=%s, histogram mode=%s)", growth, hist_mode)
    return False


def paged_device_matrix(train_data: TrainingData, row_major: bool, device):
    """The bin matrix of a reader-backed dataset, paged to ``device`` shard
    by shard (JAX ops/learner.py ``paged_device_matrix``): X_t (G, N) for
    the transposed dataflows, X (N, G) for ``pallas`` and the XLA
    engines, in the shards' dtype (uint8, or uint16 past 256 bins).
    Returns ``(X, stats)``, or ``(None, None)`` when the dataset has no
    reader (the caller then uploads ``binned`` in one go).

    X is allocated on the card once.  A shard is an F-order (rows, G)
    memmap, so its ``.T`` is a C-contiguous (G, rows) block: each shard
    is copied into one staging buffer (pinned on CUDA, the size of the
    largest shard) in the layout of its destination, ``X[:, lo:hi]`` (a
    2-D strided copy) or ``X[lo:hi]``, and the next shard waits for that
    copy.  Host memory above the process's holds a mapped shard and the
    staging buffer, never the matrix."""
    reader = train_data._binned_reader
    if (reader is None or reader.dtype not in (np.uint8, np.uint16)
            or reader.num_columns == 0):
        return None, None
    lo, hi = reader.row_range
    n, g = hi - lo, reader.num_columns
    if n == 0:
        return None, None
    t0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    dtype = torch.uint16 if reader.dtype == np.uint16 else torch.uint8
    X = torch.empty((n, g) if row_major else (g, n), dtype=dtype,
                    device=device)
    cap = max(min(int(reader.shards[i]["rows"]), n)
              for i in reader.active_shards)
    stage = torch.empty(cap * g, dtype=dtype, pin_memory=cuda)
    stage_np = stage.numpy()
    copied = None          # the event of the last copy out of the stage
    shards = 0
    for off, view in reader.iter_rows():
        rows = view.shape[0]
        if copied is not None:
            # the stage is reused: its last copy out must be done
            copied.synchronize()  # lint: ignore[sync-synchronize] stage
        shape = (rows, g) if row_major else (g, rows)
        np.copyto(stage_np[:rows * g].reshape(shape),
                  view if row_major else view.T)
        dst = X[off:off + rows] if row_major else X[:, off:off + rows]
        dst.copy_(stage[:rows * g].view(shape), non_blocking=cuda)
        if cuda:
            copied = torch.cuda.Event()
            copied.record(torch.cuda.current_stream(X.device))
        shards += 1
    if copied is not None:
        # the stage is freed: its last copy out must be done
        copied.synchronize()  # lint: ignore[sync-synchronize] stage
    width = X.element_size()
    stats = {"paged": True, "shards": shards, "bytes": int(n * g * width),
             "staging_bytes": int(cap * g * width),
             "seconds": time.perf_counter() - t0}
    return X, stats


class SerialTreeLearner:
    # the distributed learners of parallel/mesh.py say True, and which
    # they are
    distributed = False
    parallel = ""
    # whether a reader-backed dataset pages its shards to the card
    pages = True

    def __init__(self, config: Config, train_data: TrainingData, device,
                 device_store=None):
        """``device_store``: a sparse store of train_data built by an
        earlier learner (reset_config), reused where this learner runs
        the same kind of store."""
        self.sparse_mode, self.growth = check_engine_params(config,
                                                            self.parallel)
        self.growth = self._resolve_growth(config, self.growth)
        self.sparse = bool(self.sparse_mode)
        self.config = config
        # the histograms', split search's and trees' dtype
        self.dtype = torch.float64 if config.tpu_use_dp else torch.float32
        self.train_data = train_data
        self.device = device
        self.num_leaves = config.num_leaves
        self.num_bins = (int(train_data.num_bin_arr.max())
                         if train_data.num_features else 2)
        self.meta = self._feature_meta(train_data, device)
        self.params = build_split_params(config)
        self.bundle_arrays, self.group_bins = build_bundle_arrays(
            train_data, device)
        ncols = (len(train_data.bundle.num_group_bins)
                 if train_data.bundle is not None
                 else max(train_data.num_features, 1))
        nbins = (self.group_bins if train_data.bundle is not None
                 else self.num_bins)
        mode = _val(config, "tpu_histogram_mode")
        if self.sparse:
            mode = self.sparse_mode
        elif self.growth == "exact":
            # exact growth takes B5 ('pallas'), or the XLA engine asked
            # for.  With 'auto' the JAX package's TPU prior picks its XLA
            # onehot engine here (ops/autotune.py); the port's is B5
            mode = mode if mode in ENGINE_MODES else "pallas"
        elif mode == "auto":
            # the JAX package's prior: the fused kernel while the
            # accumulator block is narrow, the histogram-only kernel with
            # a separate partition above that bound.  Under tpu_use_dp the
            # JAX package takes its onehot engine, because its Pallas
            # kernels are f32-only; the port's kernels have an f64 form,
            # so its auto stays on them
            mode = prior_hist_mode(ncols, bin_pad(nbins))
        self.hist_mode = mode
        self.hist_hilo = prior_hist_hilo(config)
        self.wave_compact = resolve_wave_compact(config, self.growth, mode)
        bins_per_col = (train_data.bundle.num_group_bins
                        if train_data.bundle is not None
                        else train_data.num_bin_arr)
        # the logical columns of the 4-bit packed bins, 0 for byte bins
        self.packed_cols = (ncols if resolve_bin_pack(
            config, self.growth, self.sparse, bins_per_col, mode) else 0)
        self.cache_hists = hist_cache_enabled(
            config, self.num_leaves, ncols, nbins,
            8 if self.dtype == torch.float64 else 4)
        # the order and width are read only under wave growth, as in the
        # JAX package
        self.wave_order = (resolve_wave_order(config)
                           if self.growth == "wave" else "batched")
        self.wave_width = (resolve_wave_width(config, self.num_leaves,
                                              self.wave_order)
                           if self.growth == "wave" else 1)
        self.sparse_device_bytes = 0
        # how the bins reached the device (the paged upload's shards,
        # bytes and seconds, or the one-shot upload's)
        self.upload_stats = None
        if not self.sparse and not self.packed_cols and self.pages:
            # a reader-backed dataset pages its shards to the card (the
            # JAX package pages byte bins only; packed bins and the
            # sparse store read train_data.binned)
            self.X, self.upload_stats = paged_device_matrix(
                train_data, self.row_major, device)
        want = (SparseDeviceStore if self.sparse_mode == "sparse"
                else ChunkedSparseStore)
        if self.sparse and isinstance(device_store, want):
            # reset_config: the same train_data, so the same store
            self.X = device_store
            self.sparse_device_bytes = (
                store_device_bytes(self.X) if want is SparseDeviceStore
                else chunked_device_bytes(self.X))
        elif self.sparse:
            binned = self._host_bins(train_data)
            # only the non-fill entries go to the device
            fill = (column_fill_bins(train_data.num_bin_arr,
                                     train_data.default_bin_arr,
                                     train_data.bundle)
                    if train_data.num_features else np.zeros(1, np.int64))
            if self.sparse_mode == "sparse":
                self.X, self.sparse_device_bytes = self._coordinate_store(
                    binned, fill, nbins, device)
            else:
                # a low-skew store takes one wide chunk a column
                # (auto_uniform)
                self.X, self.sparse_device_bytes = build_chunked_store(
                    binned, fill, nbins, auto_uniform=True, device=device)
        elif self.upload_stats is None:
            t0 = time.perf_counter()
            binned = self._host_bins(train_data)
            if binned.dtype not in (np.uint8, np.uint16):
                Log.fatal("lightgbm_tpu_torch needs uint8 or uint16 bins, "
                          "got %s", binned.dtype)
            if self.packed_cols:
                binned = pack4_host(binned)       # (N, ceil(G / 2))
            # the bin matrix, uploaded once per booster: row-major (N, G)
            # for the 'pallas' kernels and the XLA engines, else
            # transposed (G, N)
            self.X = torch.as_tensor(np.ascontiguousarray(
                binned if self.row_major else binned.T), device=device)
            self.upload_stats = {"paged": False, "shards": 1,
                                 "bytes": int(binned.nbytes),
                                 "seconds": time.perf_counter() - t0}
        self._ones = torch.ones(train_data.num_data, dtype=self.dtype,
                                device=device)
        self._full_mask = torch.ones(self.meta.num_bin.shape[0],
                                     dtype=torch.bool, device=device)
        # feature_fraction RNG persists across trees
        # (serial_tree_learner.cpp:40-96 Init + :257-275 BeforeTrain)
        self._feature_rng = Random(config.feature_fraction_seed)
        self.last_stats = None
        self._obs = NULL_OBSERVER
        # construction-time events (the autotuner's probes and decision),
        # recorded once set_observer attaches the run's observer
        self._pending_events = []
        self._autotune(config, ncols, nbins)

    def _coordinate_store(self, binned, fill, nbins: int, device):
        """(store, device bytes): the coordinate store of this learner's
        bins (the data-parallel learner pads it to the ranks' agreed
        size)."""
        store, _, nbytes = build_sparse_store(binned, fill, nbins,
                                              device=device)
        return store, nbytes

    def _resolve_growth(self, config: Config, growth: str) -> str:
        """The growth schedule: the serial resolution (the voting and
        feature-parallel learners run exact growth)."""
        return growth

    @staticmethod
    def _feature_meta(train_data: TrainingData, device) -> FeatureMeta:
        """The device FeatureMeta of the used features."""
        if train_data.num_features == 0:
            # every feature was trivial: one constant dummy column still
            # yields the boost-from-average stump, as in the reference
            return FeatureMeta(
                num_bin=torch.tensor([2], dtype=torch.int32, device=device),
                default_bin=torch.tensor([0], dtype=torch.int32,
                                         device=device),
                is_categorical=torch.tensor([False], device=device))
        return FeatureMeta(
            num_bin=torch.as_tensor(train_data.num_bin_arr, device=device),
            default_bin=torch.as_tensor(train_data.default_bin_arr,
                                        device=device),
            is_categorical=torch.as_tensor(train_data.is_categorical_arr,
                                           device=device))

    # --------------------------------------------------------- autotuning
    def _autotune(self, config: Config, ncols: int, nbins: int) -> None:
        """The measured kernel autotuner (ops/autotune.py).  Everything
        resolved above (hist_mode, wave_width, hist_hilo, wave_compact) is
        the prior; under tpu_autotune=measure/force on the card decide()
        probes the candidate cells on the uploaded bins and the winner
        replaces the prior (and is cached on disk).  Under off (the
        default) it only records the prior's decision.  The probes'
        kernel launches are counted apart (``autotune_launches``), and
        every launch counter is as it was before them."""
        from . import autotune as at
        from .fused_iter import COUNTERS, _counts, _set_counts
        bucket = at.ShapeBucket(int(ncols), int(bin_pad(nbins)),
                                int(self.num_leaves),
                                at.row_bucket(self.train_data.num_data))
        prior = at.Cell(self.hist_mode, int(self.wave_width),
                        bool(self.hist_hilo), self.wave_compact, fused=False)
        pins = at.Pins(
            # explicit user choices and quality gates, never tuned
            kernel=_val(config, "tpu_histogram_mode") != "auto",
            width=(int(config.tpu_wave_width) > 0
                   or (_order_sensitive(config)
                       and self.wave_order != "exact")),
            # the f64 form takes no bf16 rounding: its precision is fixed
            precision=(_val(config, "tpu_hist_precision") != "auto"
                       or self.dtype == torch.float64),
            compact="tpu_wave_compact" in config.raw,
            fused=_val(config, "tpu_fused_iter") != "auto")
        # the distributed learners keep the prior: a probe would run the
        # ranks' collectives (and the kernels give the same bits either
        # way)
        eligible = (self.growth == "wave" and not self.sparse
                    and self.hist_mode in at.WAVE_ONLY_MODES
                    and not self.distributed)
        before = _counts()
        dec = at.decide(config, bucket, prior, pins, eligible,
                        probe=self._make_autotune_probe() if eligible
                        else None, device=self.device,
                        wide=self.dtype == torch.float64)
        self.autotune_launches = {
            k.__name__ + ("" if form is None else "_" + form): a - b
            for (k, form), a, b in zip(COUNTERS, _counts(), before)
            if a != b}
        _set_counts(before, [0] * len(before))
        self.autotune, self.autotune_shape, self.autotune_pins = (dec, bucket,
                                                                 pins)
        self.autotune_mode, self.autotune_source = dec.mode, dec.source
        self._pending_events.extend(dec.events)
        # the measured staged-vs-fused verdict of this shape bucket; the
        # booster's tpu_fused_iter=auto resolution reads it
        # (models/gbdt.py _resolve_fused_iter)
        self.fused_autotune = bool(dec.cell.fused)
        if dec.cell != prior:
            self.hist_mode = dec.cell.hist_mode
            self.wave_width = int(dec.cell.wave_width)
            self.hist_hilo = bool(dec.cell.hist_hilo)
            self.wave_compact = bool(dec.cell.compact)

    def _make_autotune_probe(self):
        """Probe factory for ops/autotune.py: builds a candidate cell's
        wave grower on the uploaded bins (the learner's statics, the
        cell's kernel, width, precision and compaction) with the JAX
        package's synthetic L2 gradients (score - t against a target t
        from -1 to 1 over the rows, hessian 0.25, so splits have gain),
        and returns a run closure that grows one tree from a zero score
        and updates the score, waiting through obs/timers.fence.  A
        staged cell's run is the staged chain: gradients, the grower's
        waves with their host reads, B2, with the host glue between
        them.  A fused cell's run is ops/fused_iter.py's graph replays;
        its first, untimed run is the eager warm-up and the captures, and
        its ``close`` frees the graphs' pools (under the capture lock)."""
        from ..obs.timers import fence
        from .fused_iter import FusedIteration
        from .predict import update_score_from_partition
        n = self.train_data.num_data
        dev = self.device
        target = torch.linspace(-1.0, 1.0, n, dtype=self.dtype, device=dev)
        hess = torch.full((n,), 0.25, dtype=self.dtype, device=dev)
        scale = 0.1

        def grad(score):
            return score - target, hess

        def probe(cell):
            kw = self._wave_kw(cell)
            score = torch.zeros(n, dtype=self.dtype, device=dev)
            if cell.fused:
                fused = FusedIteration(
                    self, grad, n, grower=WaveGrower(
                        self.X, self.meta, self.bundle_arrays, **kw),
                    score_engine="gather" if self.dtype == torch.float64
                    else "pallas")

                def run():
                    score.zero_()
                    fused.run(score, None, self._full_mask, scale)
                    fence(score)
                run.close = fused.release
                return run

            def run():
                score.zero_()
                g, h = grad(score)
                tree, leaf_id, _ = grow_tree(
                    self.X, g, h, self._ones, self._full_mask, self.meta,
                    self.bundle_arrays, **kw)
                update_score_from_partition(
                    score, leaf_id, tree.leaf_value, scale, out=score,
                    engine="gather" if self.dtype == torch.float64
                    else "pallas")
                fence(score)
            return run

        return probe

    # -------------------------------------------------------- observability
    def set_observer(self, obs) -> None:
        self._obs = obs
        if self._pending_events and obs.enabled:
            # construction-time events, now that the run header exists
            for ev, fields in self._pending_events:
                obs.event(ev, **fields)
            del self._pending_events[:]

    def obs_info(self) -> dict:
        """Static run-header context: the engines and knobs this learner
        resolved to (the 'auto' params after resolution)."""
        return {
            "learner": type(self).__name__,
            "growth": self.growth,
            "hist_mode": self.hist_mode,
            "wave_width": int(self.wave_width),
            "wave_order": self.wave_order,
            "hist_hilo": bool(self.hist_hilo),
            "wave_compact": bool(self.wave_compact),
            "autotune_mode": self.autotune_mode,
            "autotune_source": self.autotune_source,
            "fused": bool(self.fused_autotune),
            "packed_cols": int(self.packed_cols),
            "num_leaves": int(self.num_leaves),
            "num_bins": int(self.num_bins),
            "dtype": "float64" if self.dtype == torch.float64
                     else "float32",
            "cache_hists": bool(self.cache_hists),
        }

    def sample_feature_mask(self):
        f = self.train_data.num_features
        if self.config.feature_fraction >= 1.0 or f == 0:
            return self._full_mask
        used_cnt = int(f * self.config.feature_fraction)
        idx = self._feature_rng.sample(f, used_cnt)
        # the padded features of the feature-parallel learner stay off
        mask = np.zeros(self._full_mask.shape[0], dtype=bool)
        mask[idx] = True
        return torch.as_tensor(mask, device=self.device)

    @staticmethod
    def _host_bins(train_data: TrainingData) -> np.ndarray:
        """The host bin matrix (built from a directory's shards if the
        dataset is reader-backed); one zero column where no feature is
        used."""
        binned = train_data.binned
        if binned.shape[1] == 0:
            binned = np.zeros((train_data.num_data, 1), np.uint8)
        return binned

    @property
    def row_major(self) -> bool:
        """Whether the dense bins are uploaded row-major (N, G): for
        'pallas' (B4, B5) and the XLA engines; the transposed kernels
        read (G, N)."""
        return self.hist_mode == "pallas" or self.hist_mode in ENGINE_MODES

    def row_major_bins(self):
        """(X, packed): the training bins as (N, G) rows for a traversal,
        the upload or a transposed view of it, and whether they are 4-bit
        packed ((N, ceil(G / 2)), ops/pack.py); (None, False) on a
        sparse store, which keeps no dense matrix."""
        if self.sparse:
            return None, False
        X = self.X if self.row_major else self.X.t()
        return X, bool(self.packed_cols)

    def _grow_kw(self) -> dict:
        return dict(num_leaves=self.num_leaves, num_bins=self.num_bins,
                    params=self.params, max_depth=self.config.max_depth,
                    group_bins=self.group_bins, cache_hists=self.cache_hists,
                    dtype=self.dtype)

    def _exact_kw(self) -> dict:
        """The exact grower's arguments: its engine and the packed
        columns (the XLA engines only), and the shared ones."""
        return dict(hist_mode=self.hist_mode, packed_cols=self.packed_cols,
                    **self._grow_kw())

    def _wave_kw(self, cell=None) -> dict:
        """The wave grower's arguments: this learner's, or an autotune
        cell's kernel, width and precision on this learner's statics."""
        if cell is None:
            width, mode, hilo = (self.wave_width, self.hist_mode,
                                 self.hist_hilo)
        else:
            width, mode, hilo = (int(cell.wave_width), cell.hist_mode,
                                 bool(cell.hist_hilo))
        return dict(wave_width=width, hist_mode=mode,
                    wave_order=self.wave_order,
                    packed_cols=self.packed_cols, hilo=hilo,
                    **self._grow_kw())

    def wave_grower(self) -> WaveGrower:
        """The wave grower of this learner's bins and config (what the
        fused iteration, ops/fused_iter.py, replays)."""
        return WaveGrower(self.X, self.meta, self.bundle_arrays,
                          **self._wave_kw())

    def exact_grower(self) -> ExactGrower:
        """The exact grower of this learner's row-major bins and config
        (what the fused iteration replays under exact growth)."""
        return ExactGrower(self.X, self.meta, self.bundle_arrays,
                           **self._exact_kw())

    def train_device(self, grad, hess, row_mult=None):
        """Grow one tree on the device: (TreeArrays, leaf_id, GrowStats)."""
        if row_mult is None:
            row_mult = self._ones
        args = (self.X, grad.to(self.dtype), hess.to(self.dtype),
                row_mult.to(self.dtype), self.sample_feature_mask(),
                self.meta, self.bundle_arrays)
        t0 = self._obs.entry_start()
        self._obs.entry_args("tree_grow", self.train_device, args,
                             names=("X", "grad", "hess", "row_mult",
                                    "feature_mask"))
        if self.growth == "exact":
            tree, leaf_id, stats = grow_tree_exact(*args, **self._exact_kw())
        else:
            tree, leaf_id, stats = grow_tree(*args, **self._wave_kw())
        self._obs.entry_end("tree_grow", t0, (tree, leaf_id))
        self.last_stats = stats
        return tree, leaf_id, stats


def materialize_tree(host_tree: dict, train_data: TrainingData,
                     max_leaves: int) -> Tree:
    """Tree arrays (host numpy dict, TreeArrays field names) -> models.Tree
    with real-valued thresholds resolved host-side in float64
    (Dataset::RealThreshold, dataset.h:457-462)."""
    nl = int(host_tree["num_leaves"])
    tree = Tree(max(max_leaves, 2))
    tree.num_leaves = nl
    if nl <= 1:
        return tree
    ni = nl - 1
    h = host_tree
    tree.split_feature_inner[:ni] = h["split_feature"][:ni]
    tree.threshold_in_bin[:ni] = h["threshold_bin"][:ni]
    tree.default_bin_for_zero[:ni] = h["default_bin_for_zero"][:ni]
    tree.zero_bin[:ni] = h["default_bin"][:ni]
    tree.decision_type[:ni] = h["is_cat"][:ni].astype(np.int8)
    tree.has_categorical = bool(h["is_cat"][:ni].any())
    tree.left_child[:ni] = h["left_child"][:ni]
    tree.right_child[:ni] = h["right_child"][:ni]
    tree.split_gain[:ni] = h["split_gain"][:ni]
    tree.internal_value[:ni] = h["internal_value"][:ni]
    tree.internal_count[:ni] = h["internal_count"][:ni]
    tree.leaf_parent[:nl] = h["leaf_parent"][:nl]
    tree.leaf_value[:nl] = h["leaf_value"][:nl]
    tree.leaf_count[:nl] = h["leaf_count"][:nl]
    tree.leaf_depth[:nl] = h["leaf_depth"][:nl]
    tree.second_gain[:ni] = h["second_gain"][:ni]
    for i in range(ni):
        inner_f = int(h["split_feature"][i])
        mapper = train_data.feature_bin_mapper(inner_f)
        tree.split_feature[i] = train_data.real_feature_index(inner_f)
        second = int(h["second_feature"][i])
        tree.second_feature[i] = (train_data.real_feature_index(second)
                                  if second >= 0 else -1)
        tree.threshold[i] = avoid_inf(
            mapper.bin_to_value(int(h["threshold_bin"][i])))
        dbz = int(h["default_bin_for_zero"][i])
        if dbz != mapper.default_bin:
            # AvoidInf as in Tree::Split (tree.cpp:75)
            tree.default_value[i] = avoid_inf(mapper.bin_to_value(dbz))
        else:
            tree.default_value[i] = 0.0
    return tree
