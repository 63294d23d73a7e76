"""Out-of-core streaming ingest: parallel two-pass binning in bounded RAM.

Parity target: the reference's two-round loading and pipelined reader
(src/io/dataset_loader.cpp:554-660, include/LightGBM/utils/
pipeline_reader.h:18), and the JAX package's ``io/streaming.py``, whose
chunk plans, sketch and mappers this module reproduces bit for bit:

  pass 0  plan chunks (text: a byte-range scan for newlines, no float
          parsing; .npy/ndarray/CSC: row ranges)
  pass 1  workers read ONLY the sampled rows of their chunks; the parent
          merges the per-chunk sketches in row order — identical to the
          in-memory path (same Random seed, same ascending sample
          indices, so the mappers match bit for bit) -> BinMapper, EFB
          and the data-quality profile, all on the streamed sample
  pass 2  workers re-read chunks, bin against the frozen mappers, and
          either ship compact uint8/16 blocks back (in-memory assembly)
          or write binned shards straight to disk (``out_dir``: no bin
          data crosses the pipe)

Both passes fan out over forked worker processes (``_run_pool``): the
sources are inherited copy-on-write and nothing large is pickled.  A
worker does numpy work only — no torch operation, nothing that touches
CUDA — so it may be forked from a process that already trains on the
card.  That is why this module imports numpy and the port's ``io/`` and
``utils/`` only.  Each worker takes a fixed share of the tasks and sends
its results over a pipe of its own: the workers share no lock and no
queue with the parent, so a worker forked while another thread of the
parent held a lock has none of the parent's locks to wait on, and its
SIGTERM is the default again (a Python handler the parent installed
cannot run in a child blocked in C).  The parent waits at most
``POOL_TASK_SECONDS`` for each task: a worker that gives no result in
time is named in a ``LightGBMError`` and every worker is killed.
Platforms without fork, or ``ooc_workers=1``, run the same code
serially.  Peak host RSS is O(chunk + sample), never O(N x F) floats.

Dense csv/tsv/space files stream; libsvm goes through the in-memory
parser (its streaming form is the sparse path, io/sparse.py).
"""
from __future__ import annotations

import io
import multiprocessing as mp
import os
import signal
import sys
import time
import warnings
from multiprocessing.connection import wait as _wait_conns
from typing import List, Optional

import numpy as np

from ..utils.log import LightGBMError, Log
from ..utils.random import Random
from . import binned_format
from . import parser as _parser
from .bundle import bin_rows_grouped

CHUNK_BYTES = 64 << 20          # text chunk per read
DEFAULT_CHUNK_ROWS = 1 << 18    # row chunk for array/sparse sources


def _peak_rss_bytes() -> int:
    """Process high-water RSS (ru_maxrss is KB on Linux, bytes on mac)."""
    try:
        import resource
    except ImportError:                      # pragma: no cover
        return 0
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return int(peak) * (1 if sys.platform == "darwin" else 1024)


# ---------------------------------------------------------------------------
# text helpers

def count_rows(filename: str, skip_header: bool) -> int:
    """Number of NON-BLANK data lines — must agree exactly with what
    the chunk plan yields (blank lines are skipped everywhere, matching
    the in-memory parser)."""
    _, n = plan_text_chunks(filename, skip_header)
    return n


def plan_text_chunks(filename: str, skip_header: bool,
                     chunk_bytes: Optional[int] = None):
    """Line-aligned byte ranges: [(row_start, n_rows, byte_lo, byte_hi)].

    A binary newline scan (~GB/s, no float parsing) that lets pass-1/2
    workers seek independently.  n_rows counts non-blank lines only.
    """
    chunk_bytes = chunk_bytes or CHUNK_BYTES
    chunks = []
    row = 0
    with open(filename, "rb") as f:
        if skip_header:
            f.readline()
        pend = b""
        pend_start = f.tell()
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if pend.strip():
                    n = sum(1 for l in pend.split(b"\n") if l.strip())
                    chunks.append((row, n, pend_start,
                                   pend_start + len(pend)))
                    row += n
                break
            data = pend + block
            cut = data.rfind(b"\n")
            if cut < 0:
                pend = data
                continue
            body, pend = data[:cut + 1], data[cut + 1:]
            end = pend_start + len(body)
            n = sum(1 for l in body.split(b"\n") if l.strip())
            if n:
                chunks.append((row, n, pend_start, end))
                row += n
            pend_start = end
    return chunks, row


def _parse_lines(lines: List[str], sep: Optional[str]) -> np.ndarray:
    buf = io.StringIO("\n".join(lines))
    try:
        return np.loadtxt(buf, delimiter=sep, dtype=np.float64, ndmin=2)
    except ValueError:
        rows = [[_parser._safe_float(t)
                 for t in (l.split(sep) if sep else l.split())]
                for l in lines]
        return np.asarray(rows, dtype=np.float64)


def stream_supported(filename: str, has_header: bool) -> bool:
    with open(filename, "r") as f:
        if has_header:
            f.readline()
        head = [f.readline().rstrip("\r\n") for _ in range(2)]
    return _parser.detect_format([l for l in head if l]) != "libsvm"


# ---------------------------------------------------------------------------
# chunk sources — uniform (plan / read / read_sampled) over text, dense
# arrays (.npy path or in-memory), and CSC sparse

class TextSource:
    """Dense csv/tsv/space file; workers seek line-aligned byte ranges."""

    kind = "text"

    def __init__(self, filename: str, skip_header: bool, label_idx: int,
                 keep: Optional[List[int]],
                 chunk_bytes: Optional[int] = None,
                 chunk_rows: Optional[int] = None):
        self.filename = filename
        self.label_idx = label_idx
        self.keep = keep
        with open(filename, "r") as f:
            if skip_header:
                f.readline()
            first = ""
            while True:
                line = f.readline()
                if not line:
                    break
                first = line.rstrip("\r\n")
                if first.strip():
                    break
        fmt = _parser.detect_format([first] if first else [])
        if fmt == "libsvm":
            Log.fatal("streaming ingest handles dense formats; libsvm "
                      "goes through the sparse path")
        self.sep = _parser._SEP[fmt]
        if chunk_bytes is None and chunk_rows and first:
            # honor the row-denominated chunk budget (ooc_chunk_rows)
            # via a bytes-per-row estimate from the probed first line
            chunk_bytes = max(1, int(chunk_rows) * (len(first) + 1))
        self._chunks, self.num_rows = plan_text_chunks(
            filename, skip_header, chunk_bytes)
        if self.num_rows:
            feats, _ = self.to_features(_parse_lines([first], self.sep))
            self.num_features = feats.shape[1]
        else:
            self.num_features = 0

    def to_features(self, mat: np.ndarray):
        if 0 <= self.label_idx < mat.shape[1]:
            label = mat[:, self.label_idx].copy()
            feats = np.delete(mat, self.label_idx, axis=1)
        else:
            label = np.zeros(mat.shape[0], dtype=np.float64)
            feats = mat
        if self.keep is not None:
            feats = feats[:, self.keep]
        return feats, label

    def plan(self):
        return list(self._chunks)

    def _lines(self, desc) -> List[str]:
        _, _, lo, hi = desc
        with open(self.filename, "rb") as f:
            f.seek(lo)
            data = f.read(hi - lo)
        return [l for l in data.decode("utf-8", "replace").split("\n")
                if l.strip()]

    def read(self, desc):
        start = desc[0]
        feats, label = self.to_features(
            _parse_lines(self._lines(desc), self.sep))
        return start, feats, label

    def read_sampled(self, desc, wanted: np.ndarray):
        """Floats are parsed for the PICKED lines only (string slicing
        first), so pass 1 stays cheap on mostly-unsampled files."""
        start, nrows = desc[0], desc[1]
        sel = np.flatnonzero(wanted[start:start + nrows])
        if len(sel) == 0:
            return start, np.zeros((0, self.num_features), np.float64)
        lines = self._lines(desc)
        feats, _ = self.to_features(
            _parse_lines([lines[i] for i in sel], self.sep))
        return start, feats


_NPY_CACHE: dict = {}   # per-process .npy layout / fallback-memmap cache


def _npy_layout(path: str):
    """(data_offset, shape, dtype) of a C-order .npy, or None when the
    file needs the memmap fallback (Fortran order / exotic header).

    Chunk reads then go through plain seek+read into fresh buffers
    instead of a long-lived memmap: clean mapped pages count toward RSS
    while resident, so memmap-scanning a 4x-RAM file would show a peak
    watermark the size of the FILE — the bounded-memory contract needs
    read buffers that actually die with the chunk.
    """
    lay = _NPY_CACHE.get(path)
    if lay is None:
        lay = False
        try:
            with open(path, "rb") as f:
                version = np.lib.format.read_magic(f)
                if version == (1, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_1_0(f)
                elif version == (2, 0):
                    shape, fortran, dtype = \
                        np.lib.format.read_array_header_2_0(f)
                else:
                    fortran = True
                if not fortran and not dtype.hasobject:
                    lay = (f.tell(), shape, dtype)
        except Exception:
            lay = False
        _NPY_CACHE[path] = lay
    return lay or None


class MatrixSource:
    """Dense float matrix: an in-memory ndarray (fork-shared, zero copy)
    or a .npy path (each worker opens its own read-only memmap)."""

    def __init__(self, data, label=None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        if isinstance(data, (str, os.PathLike)):
            self.kind = "npy"
            self.path: Optional[str] = str(data)
            arr = np.load(self.path, mmap_mode="r")
        else:
            self.kind = "matrix"
            self.path = None
            arr = np.asarray(data)
        if arr.ndim != 2:
            Log.fatal("streaming ingest needs a 2-D matrix, got shape %s",
                      arr.shape)
        self.num_rows, self.num_features = arr.shape
        self._arr = None if self.path is not None else arr
        self.label = (None if label is None
                      else np.asarray(label, dtype=np.float64))
        self.chunk_rows = max(int(chunk_rows), 1)

    def plan(self):
        return [(s, min(s + self.chunk_rows, self.num_rows))
                for s in range(0, self.num_rows, self.chunk_rows)]

    def _rows(self, idx_or_slice) -> np.ndarray:
        if self.path is not None:
            lay = _npy_layout(self.path)
            if lay is None:                      # Fortran-order fallback
                m = _NPY_CACHE.get(("mm", self.path))
                if m is None:
                    m = np.load(self.path, mmap_mode="r")
                    _NPY_CACHE[("mm", self.path)] = m
                return np.asarray(m[idx_or_slice], dtype=np.float64)
            offset, shape, dtype = lay
            if isinstance(idx_or_slice, slice):
                s, e = idx_or_slice.start, idx_or_slice.stop
                sel = None
            else:
                idx = np.asarray(idx_or_slice)
                s, e = int(idx.min()), int(idx.max()) + 1
                sel = idx - s
            row_items = int(shape[1])
            with open(self.path, "rb") as f:
                f.seek(offset + s * row_items * dtype.itemsize)
                buf = np.fromfile(f, dtype=dtype,
                                  count=(e - s) * row_items)
            block = buf.reshape(e - s, row_items)
            if sel is not None:
                block = block[sel]
            return np.asarray(block, dtype=np.float64)
        return np.asarray(self._arr[idx_or_slice], dtype=np.float64)

    def _label(self, s, e):
        if self.label is None:
            return np.zeros(e - s, dtype=np.float64)
        return self.label[s:e]

    def read(self, desc):
        s, e = desc
        return s, self._rows(slice(s, e)), self._label(s, e)

    def read_sampled(self, desc, wanted):
        s, e = desc
        sel = np.flatnonzero(wanted[s:e])
        if len(sel) == 0:
            return s, np.zeros((0, self.num_features), np.float64)
        return s, self._rows(s + sel)


class SparseSource:
    """CSC SparseColumns; chunks densify their row window per column via
    searchsorted (rows are sorted within a column by construction)."""

    kind = "sparse"

    def __init__(self, sp, label=None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS):
        self.sp = sp
        self.num_rows = int(sp.num_row)
        self.num_features = int(sp.num_col)
        self.label = (None if label is None
                      else np.asarray(label, dtype=np.float64))
        self.chunk_rows = max(int(chunk_rows), 1)

    def plan(self):
        return [(s, min(s + self.chunk_rows, self.num_rows))
                for s in range(0, self.num_rows, self.chunk_rows)]

    def _block(self, s, e) -> np.ndarray:
        out = np.zeros((e - s, self.num_features), dtype=np.float64)
        for j in range(self.num_features):
            rows, vals = self.sp.column(j)
            lo, hi = np.searchsorted(rows, (s, e))
            out[rows[lo:hi] - s, j] = vals[lo:hi]
        return out

    def read(self, desc):
        s, e = desc
        label = (np.zeros(e - s, np.float64) if self.label is None
                 else self.label[s:e])
        return s, self._block(s, e), label

    def read_sampled(self, desc, wanted):
        s, e = desc
        sel = np.flatnonzero(wanted[s:e])
        if len(sel) == 0:
            return s, np.zeros((0, self.num_features), np.float64)
        return s, self._block(s, e)[sel]


# ---------------------------------------------------------------------------
# pass 1: mergeable sample sketch

class SampleSketch:
    """Mergeable per-feature sketch over the binning sample.

    Each chunk contributes its sampled rows keyed by chunk start; merging
    is order-insensitive (parts re-sort on row offset), and the assembled
    matrix is byte-identical to ``data[sample_idx]`` because Random.sample
    yields ascending indices — which is what makes streamed BinMapper /
    EFB construction bit-exact vs the one-shot in-memory path.
    """

    def __init__(self, n_features: int):
        self.n_features = int(n_features)
        self.parts: List = []           # (row_start, (rows_sel, F) float64)

    def add_chunk(self, row_start: int, sampled_rows: np.ndarray):
        if sampled_rows.shape[0]:
            self.parts.append((int(row_start), sampled_rows))

    def merge(self, other: "SampleSketch"):
        self.parts.extend(other.parts)

    def sample_matrix(self) -> np.ndarray:
        if not self.parts:
            return np.zeros((0, self.n_features), dtype=np.float64)
        self.parts.sort(key=lambda p: p[0])
        return np.concatenate([p[1] for p in self.parts], axis=0)


# ---------------------------------------------------------------------------
# worker pool: fork-shared state, serial fallback

_WSTATE: dict = {}
# the longest a worker may take over one task (a chunk of at most
# CHUNK_BYTES of text or DEFAULT_CHUNK_ROWS rows) before the pool is
# killed: the wait is bounded in proportion to the tasks a worker holds
POOL_TASK_SECONDS = 300.0


def _init_worker(state: dict):
    _WSTATE.clear()
    _WSTATE.update(state)


def _fork_available() -> bool:
    return "fork" in mp.get_all_start_methods()


def resolve_workers(config, num_tasks: Optional[int] = None) -> int:
    w = int(getattr(config, "ooc_workers", 0) or 0)
    if w <= 0:
        w = os.cpu_count() or 1
    if not _fork_available():
        # spawn would re-import the whole package (torch and all) per
        # worker; serial is cheaper at these chunk sizes
        w = 1
    if num_tasks is not None:
        w = min(w, max(int(num_tasks), 1))
    return max(w, 1)


def _worker_main(conn, fn, tasks, mine, state) -> None:
    """A forked worker: tasks[i] for i in mine, in order, each result (or
    the exception that ended the worker) sent as (i, ok, value)."""
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    _init_worker(state)
    try:
        for i in mine:
            try:
                out = (i, True, fn(tasks[i]))
            except BaseException as e:      # handed to the parent
                out = (i, False, e)
            try:
                conn.send(out)
            except Exception as e:          # an unpicklable result
                conn.send((i, False, LightGBMError(
                    "streaming task %d: %s" % (i, e))))
                break
            if not out[1]:
                break
    finally:
        conn.close()


def _run_pool(workers: int, fn, tasks, state: dict) -> list:
    """[fn(t) for t in tasks] over `workers` forked processes (serially
    with one worker, one task or no fork): worker w takes tasks w, w +
    workers, ..., each result comes back over its own pipe.  A worker
    that gives no result within POOL_TASK_SECONDS of its last one, or
    exits without one, raises a LightGBMError naming the task; the
    workers are killed on every way out."""
    tasks = list(tasks)
    if workers <= 1 or len(tasks) <= 1 or not _fork_available():
        _init_worker(state)
        try:
            return [fn(t) for t in tasks]
        finally:
            _WSTATE.clear()
    ctx = mp.get_context("fork")
    n = min(workers, len(tasks))
    results: list = [None] * len(tasks)
    procs, todo, since = [], {}, {}
    try:
        with warnings.catch_warnings():
            # fork-with-threads warnings (torch's intra-op threads); the
            # workers only run numpy over inherited read-only arrays
            warnings.simplefilter("ignore")
            for w in range(n):
                recv, send = ctx.Pipe(duplex=False)
                mine = list(range(w, len(tasks), n))
                p = ctx.Process(target=_worker_main,
                                args=(send, fn, tasks, mine, state),
                                daemon=True)
                p.start()
                send.close()
                procs.append(p)
                todo[recv] = mine
                since[recv] = time.monotonic()
        while todo:
            now = time.monotonic()
            late = min(todo, key=lambda c: since[c])
            left = since[late] + POOL_TASK_SECONDS - now
            if left <= 0:
                i = todo[late][0]
                raise LightGBMError(
                    "streaming worker gave no result for task %d (%r) "
                    "within %.0f s; the workers were killed"
                    % (i, tasks[i], POOL_TASK_SECONDS))
            for conn in _wait_conns(list(todo), timeout=left):
                i = todo[conn][0]
                try:
                    j, ok, value = conn.recv()
                except EOFError:
                    raise LightGBMError(
                        "streaming worker exited without a result for "
                        "task %d (%r)" % (i, tasks[i])) from None
                if not ok:
                    raise value
                results[j] = value
                todo[conn].pop(0)
                since[conn] = time.monotonic()
                if not todo[conn]:
                    del todo[conn], since[conn]
                    conn.close()
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join()
        for conn in todo:
            conn.close()


def _sketch_task(desc):
    return _WSTATE["source"].read_sampled(desc, _WSTATE["wanted"])


def _bin_block(feats: np.ndarray):
    """Bin one dense float chunk against the frozen mappers (worker)."""
    st = _WSTATE
    used = st["used"]
    cols = np.empty((feats.shape[0], len(used)), dtype=np.int64)
    for i, r in enumerate(used):
        cols[:, i] = st["mappers"][r].value_to_bin(feats[:, r])
    if st["bundle"] is not None:
        out = bin_rows_grouped(cols, st["bundle"], st["default_bin_arr"])
        return out.astype(st["dtype"], copy=False)
    return cols.astype(st["dtype"])


def _bin_task(item):
    idx, desc = item
    st = _WSTATE
    t0 = time.time()
    start, feats, label = st["source"].read(desc)
    out = _bin_block(feats)
    del feats
    t1 = time.time()
    if st["out_dir"]:
        crc = binned_format.write_shard(
            os.path.join(st["out_dir"], binned_format.shard_name(idx)), out)
        return (idx, start, out.shape[0], crc, label,
                t1 - t0, time.time() - t1)
    return idx, start, out, label, t1 - t0, 0.0


# ---------------------------------------------------------------------------
# the two-pass driver

def stream_construct(td, source, config, categorical=(), reference=None,
                     out_dir: Optional[str] = None) -> None:
    """Fill TrainingData ``td`` from any chunk source in bounded memory.

    out_dir: also persist the result as a binned dataset directory
    (io/binned_format.py); td is then backed by its mmap reader and no
    full bin matrix is materialized on the host.
    """
    n = int(source.num_rows)
    if n == 0:
        Log.fatal("Streaming source (%s) is empty", source.kind)
    td.num_data = n
    td.num_total_features = int(source.num_features)
    td.max_bin = config.max_bin
    plan = source.plan()
    workers = resolve_workers(config, len(plan))
    rss0 = _peak_rss_bytes()
    t0 = time.time()

    # ---- pass 1: sketch the sample, freeze the mappers
    if reference is not None:
        if td.num_total_features != reference.num_total_features:
            Log.fatal("Validation data has %d features, train data has %d",
                      td.num_total_features, reference.num_total_features)
        td._copy_binning_from(reference)
        sketch_s = 0.0
    else:
        sample_cnt = min(config.bin_construct_sample_cnt, n)
        rng = Random(config.data_random_seed)
        sample_idx = np.asarray(rng.sample(n, sample_cnt))
        if len(sample_idx) == 0:
            sample_idx = np.arange(n, dtype=np.int32)
        wanted = np.zeros(n, dtype=bool)
        wanted[sample_idx] = True
        sketch = SampleSketch(td.num_total_features)
        for part in _run_pool(workers, _sketch_task, plan,
                              {"source": source, "wanted": wanted}):
            sketch.add_chunk(*part)
        sample = sketch.sample_matrix()
        td._fit_mappers_from_sample(sample, config, categorical)
        del sample, sketch, wanted, sample_idx
        sketch_s = time.time() - t0

    # ---- pass 2: re-stream, bin against the frozen mappers
    t1 = time.time()
    f_used = len(td.used_feature_idx)
    if td.bundle is not None:
        out_cols = td.bundle.num_groups
        gmax = int(td.bundle.num_group_bins.max(initial=2))
        dtype = np.uint8 if gmax <= 256 else np.uint16
    else:
        out_cols = f_used
        max_num_bin = int(td.num_bin_arr.max()) if f_used else 2
        dtype = np.uint8 if max_num_bin <= 256 else np.uint16

    writer = None
    if out_dir:
        writer = binned_format.BinnedWriter(out_dir, out_cols, dtype)
    state = {"source": source, "mappers": td.bin_mappers,
             "used": td.used_feature_idx, "bundle": td.bundle,
             "default_bin_arr": td.default_bin_arr, "dtype": dtype,
             "out_dir": str(out_dir) if out_dir else None}
    label_out = np.zeros(n, dtype=np.float64)
    binned = None if out_dir else np.zeros((n, out_cols), dtype=dtype)
    results = _run_pool(workers, _bin_task, list(enumerate(plan)), state)
    bin_cpu = write_cpu = 0.0
    for res in sorted(results, key=lambda r: r[0]):
        if out_dir:
            _, start, rows, crc, label, b_dt, w_dt = res
            writer.append_written(rows, crc)
        else:
            _, start, block, label, b_dt, w_dt = res
            rows = block.shape[0]
            binned[start:start + rows] = block
        label_out[start:start + rows] = label
        bin_cpu += b_dt
        write_cpu += w_dt
    td.metadata.set_label(label_out)
    pass2_s = time.time() - t1
    # phase attribution: split pass-2 wall time by worker-measured ratio
    # (bin vs shard write overlap inside each worker)
    frac = bin_cpu / (bin_cpu + write_cpu) if (bin_cpu + write_cpu) else 1.0
    bin_s = pass2_s * frac
    write_s = pass2_s - bin_s

    if out_dir:
        writer.finalize(
            num_total_features=td.num_total_features,
            used_feature_idx=td.used_feature_idx,
            feature_names=(td.feature_names
                           or ["Column_%d" % i
                               for i in range(td.num_total_features)]),
            max_bin=td.max_bin,
            bin_mappers=td.bin_mappers,
            bundle_groups=(td.bundle.groups if td.bundle is not None
                           else None),
            metadata=td.metadata)
        td._binned_reader = binned_format.BinnedReader(out_dir,
                                                       verify=False)
        td.binned = None
    else:
        td.binned = binned
    td._note_construct_stats("stream:" + source.kind, sketch_s, bin_s,
                             rss0, chunks=len(plan), write_s=write_s,
                             workers=workers)


def stream_load(td, filename: str, config, label_idx: int,
                categorical: set, keep: Optional[List[int]],
                reference=None, out_dir: Optional[str] = None) -> None:
    """Fill TrainingData ``td`` from a dense text file in bounded memory.

    keep: post-label FEATURE column indices retained (ignore_column
    support); None keeps all.  reference: share a train set's mappers
    (validation alignment) and skip pass 1's fitting.
    """
    source = TextSource(filename, bool(config.has_header), label_idx, keep,
                        chunk_rows=int(getattr(config, "ooc_chunk_rows", 0)
                                       or 0) or None)
    stream_construct(td, source, config, categorical=categorical,
                     reference=reference, out_dir=out_dir)
