"""Pre-binned on-disk dataset format: mmap-able column-major shards.

The out-of-core ingest (io/streaming.py) pays the sample sketch and the
binning once and persists the result here, so later runs skip host-side
construction: shards are raw uint8/uint16 bin matrices opened with
``np.memmap`` and paged to the card shard by shard (ops/learner.py
``paged_device_matrix``), so the host never holds the whole matrix.

Layout of a binned dataset directory::

    <dir>/header.json     magic, schema rev, bin mappers (BinMapper.to_dict),
                          EFB bundle groups, dtype, shard table with crc32s
    <dir>/shard-00000.bin raw column-major (order="F") bin matrix bytes
    <dir>/label.npy       float32 labels; optional weights.npy,
                          query_boundaries.npy, init_score.npy

The format is the JAX package's (``MAGIC`` and ``SCHEMA_REV`` included):
a directory either package writes opens in the other.  Reference analog:
the ``.bin`` file of io/dataset.cpp SaveBinaryFile, laid out for mmap
(fixed-stride raw shards, metadata out of band in JSON).  Corruption,
truncation and schema-rev mismatches fail loudly with BinnedFormatError.
"""
from __future__ import annotations

import json
import os
import zlib

import numpy as np

from ..utils.log import LightGBMError, Log

MAGIC = "lightgbm_tpu.binned.v1"
SCHEMA_REV = 1
HEADER_NAME = "header.json"
_CRC_BLOCK = 8 << 20

# metadata arrays stored as sidecar .npy files, name -> dtype
_META_ARRAYS = (
    ("label", np.float32),
    ("weights", np.float32),
    ("query_boundaries", np.int64),
    ("init_score", np.float64),
)


class BinnedFormatError(LightGBMError):
    """Raised when a binned dataset directory is invalid or corrupt."""


def is_binned_dir(path) -> bool:
    """True when path looks like a binned dataset directory."""
    return (isinstance(path, (str, os.PathLike))
            and os.path.isdir(path)
            and os.path.isfile(os.path.join(path, HEADER_NAME)))


def shard_name(idx: int) -> str:
    return "shard-%05d.bin" % idx


def write_shard(path: str, arr: np.ndarray) -> int:
    """Write one bin-matrix chunk as raw column-major bytes; returns crc32.

    Module-level so multiprocess pass-2 workers can write shards directly
    (no bin data ever crosses the IPC pipe).
    """
    data = np.ascontiguousarray(arr).tobytes(order="F")
    with open(path, "wb") as f:
        f.write(data)
    return zlib.crc32(data) & 0xFFFFFFFF


def _file_crc(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_CRC_BLOCK)
            if not block:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(block, crc)


class BinnedWriter:
    """Incremental writer: append row chunks, then finalize the header."""

    def __init__(self, path: str, num_columns: int, dtype,
                 schema_rev: int = SCHEMA_REV):
        self.path = str(path)
        self.num_columns = int(num_columns)
        self.dtype = np.dtype(dtype)
        self.schema_rev = int(schema_rev)
        self.shards = []            # [{"file", "rows", "crc32"}]
        os.makedirs(self.path, exist_ok=True)
        # a stale header would let a partial rewrite masquerade as valid
        stale = os.path.join(self.path, HEADER_NAME)
        if os.path.exists(stale):
            os.remove(stale)

    def append(self, arr: np.ndarray):
        arr = np.asarray(arr)
        if arr.ndim != 2 or arr.shape[1] != self.num_columns:
            raise BinnedFormatError(
                "shard shape %s does not match %d columns"
                % (arr.shape, self.num_columns))
        name = shard_name(len(self.shards))
        crc = write_shard(os.path.join(self.path, name),
                          arr.astype(self.dtype, copy=False))
        self.shards.append({"file": name, "rows": int(arr.shape[0]),
                            "crc32": int(crc)})

    def append_written(self, rows: int, crc: int):
        """Record a shard a worker already wrote (parallel pass 2)."""
        self.shards.append({"file": shard_name(len(self.shards)),
                            "rows": int(rows), "crc32": int(crc)})

    def finalize(self, *, num_total_features, used_feature_idx,
                 feature_names, max_bin, bin_mappers, bundle_groups,
                 metadata=None, extra=None) -> dict:
        header = {
            "magic": MAGIC,
            "schema_rev": self.schema_rev,
            "num_data": int(sum(s["rows"] for s in self.shards)),
            "num_columns": self.num_columns,
            "dtype": self.dtype.name,
            "order": "F",
            "num_total_features": int(num_total_features),
            "used_feature_idx": [int(i) for i in used_feature_idx],
            "feature_names": list(feature_names),
            "max_bin": int(max_bin),
            "bin_mappers": [m.to_dict() if m is not None else None
                            for m in bin_mappers],
            "bundle_groups": ([[int(f) for f in g] for g in bundle_groups]
                              if bundle_groups is not None else None),
            "shards": self.shards,
        }
        if extra:
            header.update(extra)
        if metadata is not None:
            header.update(write_metadata_arrays(self.path, metadata))
        _write_header(self.path, header)
        return header


def _write_header(path: str, header: dict):
    tmp = os.path.join(path, HEADER_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(header, f, indent=1)
    os.replace(tmp, os.path.join(path, HEADER_NAME))


def write_metadata_arrays(path: str, metadata) -> dict:
    """Persist label/weights/queries/init_score sidecars; returns the
    header fields mapping each present array to its file name."""
    fields = {}
    for name, dtype in _META_ARRAYS:
        arr = getattr(metadata, name, None)
        if arr is None:
            fields[name] = None
            continue
        fname = name + ".npy"
        np.save(os.path.join(path, fname),
                np.asarray(arr, dtype=dtype))
        fields[name] = fname
    return fields


def update_metadata(path: str, metadata):
    """Re-write metadata sidecars after the fact (side files such as
    train.weight load after streaming finishes)."""
    header = _read_header(path)
    header.update(write_metadata_arrays(path, metadata))
    _write_header(path, header)


def _read_header(path: str) -> dict:
    hpath = os.path.join(path, HEADER_NAME)
    if not os.path.isfile(hpath):
        raise BinnedFormatError(
            "'%s' is not a binned dataset directory (missing %s)"
            % (path, HEADER_NAME))
    try:
        with open(hpath) as f:
            header = json.load(f)
    except (OSError, ValueError) as exc:
        raise BinnedFormatError(
            "cannot parse %s: %s" % (hpath, exc)) from exc
    if header.get("magic") != MAGIC:
        raise BinnedFormatError(
            "'%s' has magic %r, expected %r — not a lightgbm_tpu binned "
            "dataset" % (path, header.get("magic"), MAGIC))
    rev = header.get("schema_rev")
    if not isinstance(rev, int) or rev > SCHEMA_REV or rev < 1:
        raise BinnedFormatError(
            "binned dataset '%s' has schema rev %r; this build supports "
            "revs 1..%d — re-create it with save_binned()"
            % (path, rev, SCHEMA_REV))
    return header


class BinnedReader:
    """Validated view over a binned dataset directory.

    ``shard(i)`` returns an np.memmap (zero host copy until pages are
    touched); ``iter_shards`` drives the paged device upload.

    ``verify`` grades the integrity check: ``True`` streams every shard's
    CRC at open (the original full-scan flag, kept for `verify=True`
    callers), ``"lazy"`` (the default) defers each shard's CRC to its
    first map — so a reader scoped to 1/64th of the rows never reads
    the other 63/64ths — and ``False`` skips CRCs entirely.  Size checks
    stay at open time but cover only the shards this reader can reach.

    ``row_range=(start, stop)`` scopes the reader to a row interval of
    the shard table (io/dataset.py ``from_binned(row_range=...)``):
    validation, ``rows()`` and the mapped-shard accounting all restrict
    to overlapping shards.
    ``mapped_shards`` records every shard index actually memmapped, so a
    caller can check that no shard outside its range was read.
    """

    def __init__(self, path: str, verify="lazy", row_range=None):
        self.path = str(path)
        self.header = _read_header(self.path)
        self.dtype = np.dtype(self.header["dtype"])
        self.num_columns = int(self.header["num_columns"])
        self.num_data = int(self.header["num_data"])
        self.shards = self.header["shards"]
        starts = [0]
        for s in self.shards:
            starts.append(starts[-1] + int(s["rows"]))
        self._starts = starts               # len num_shards + 1
        if starts[-1] != self.num_data:
            raise BinnedFormatError(
                "binned dataset '%s' shard table sums to %d rows but the "
                "header says num_data=%d" % (self.path, starts[-1],
                                             self.num_data))
        if row_range is None:
            self.row_range = (0, self.num_data)
        else:
            lo, hi = int(row_range[0]), int(row_range[1])
            if not (0 <= lo <= hi <= self.num_data):
                raise BinnedFormatError(
                    "row_range [%d, %d) out of bounds for %d rows in '%s'"
                    % (lo, hi, self.num_data, self.path))
            self.row_range = (lo, hi)
        self.mapped_shards = set()
        self._crc_ok = set()
        self._verify = verify
        self._check_sizes()
        if verify is True:
            self.verify_checksums()

    def shards_for_range(self, start, stop):
        """Indices of shards overlapping rows [start, stop)."""
        return [i for i in range(len(self.shards))
                if self._starts[i] < stop and self._starts[i + 1] > start
                and int(self.shards[i]["rows"]) > 0]

    @property
    def active_shards(self):
        """Shard indices reachable under this reader's row_range."""
        return self.shards_for_range(*self.row_range)

    def _check_sizes(self):
        itemsize = self.dtype.itemsize
        for i in self.active_shards:
            s = self.shards[i]
            fpath = os.path.join(self.path, s["file"])
            if not os.path.isfile(fpath):
                raise BinnedFormatError(
                    "binned dataset '%s' is missing shard %s"
                    % (self.path, s["file"]))
            want = int(s["rows"]) * self.num_columns * itemsize
            got = os.path.getsize(fpath)
            if got != want:
                raise BinnedFormatError(
                    "shard %s is %d bytes, expected %d (%d rows x %d cols"
                    " %s) — truncated or corrupt"
                    % (s["file"], got, want, s["rows"], self.num_columns,
                       self.dtype.name))

    def _check_crc(self, i: int):
        if i in self._crc_ok:
            return
        s = self.shards[i]
        crc = _file_crc(os.path.join(self.path, s["file"]))
        if crc != int(s["crc32"]):
            raise BinnedFormatError(
                "shard %s checksum mismatch (got %08x, header says "
                "%08x) — the binned dataset at '%s' is corrupt"
                % (s["file"], crc, int(s["crc32"]), self.path))
        self._crc_ok.add(i)

    def verify_checksums(self):
        for i in range(len(self.shards)):
            self._check_crc(i)

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    def shard(self, i: int) -> np.ndarray:
        s = self.shards[i]
        if int(s["rows"]) == 0 or self.num_columns == 0:
            return np.zeros((int(s["rows"]), self.num_columns), self.dtype)
        if self._verify == "lazy":
            self._check_crc(i)
        self.mapped_shards.add(i)
        return np.memmap(os.path.join(self.path, s["file"]),
                         dtype=self.dtype, mode="r", order="F",
                         shape=(int(s["rows"]), self.num_columns))

    def rows(self, start, stop) -> np.ndarray:
        """Bin-matrix rows [start, stop), mapping ONLY the overlapping
        shards.  A range inside one shard stays a zero-copy memmap
        slice."""
        start, stop = int(start), int(stop)
        if not (0 <= start <= stop <= self.num_data):
            raise BinnedFormatError(
                "rows [%d, %d) out of bounds for %d rows"
                % (start, stop, self.num_data))
        idx = self.shards_for_range(start, stop)
        if not idx:
            return np.zeros((stop - start, self.num_columns), self.dtype)
        parts = []
        for i in idx:
            view = self.shard(i)
            lo = max(start - self._starts[i], 0)
            hi = min(stop - self._starts[i], view.shape[0])
            parts.append(view[lo:hi])
        if len(parts) == 1:
            return parts[0]
        return np.concatenate([np.asarray(p) for p in parts], axis=0)

    def iter_shards(self):
        start = 0
        for i in range(len(self.shards)):
            view = self.shard(i)
            yield start, view
            start += view.shape[0]

    def iter_rows(self, start=None, stop=None):
        """Yield ``(offset_within_range, view_slice)`` paging ONLY the
        shards overlapping ``[start, stop)`` (defaults: this reader's
        ``row_range``) — the sharded-ingest analog of ``iter_shards``."""
        lo = self.row_range[0] if start is None else int(start)
        hi = self.row_range[1] if stop is None else int(stop)
        for i in self.shards_for_range(lo, hi):
            view = self.shard(i)
            a = max(lo - self._starts[i], 0)
            b = min(hi - self._starts[i], view.shape[0])
            yield self._starts[i] + a - lo, view[a:b]

    def matrix(self) -> np.ndarray:
        """Full bin matrix.  Single-shard datasets stay a zero-copy memmap;
        multi-shard materializes (callers that can page should iter_shards
        instead)."""
        if len(self.shards) == 1:
            return self.shard(0)
        if not self.shards:
            return np.zeros((0, self.num_columns), self.dtype)
        return np.concatenate([self.shard(i)
                               for i in range(len(self.shards))], axis=0)

    def load_metadata_array(self, name: str, mmap: bool = False):
        """Sidecar array, or None.  ``mmap=True`` opens it as a read-only
        memmap so a row-range caller can copy out just its row slice
        instead of paging every label."""
        fname = self.header.get(name)
        if not fname:
            return None
        fpath = os.path.join(self.path, fname)
        if not os.path.isfile(fpath):
            raise BinnedFormatError(
                "binned dataset '%s' header references %s but the file is "
                "missing" % (self.path, fname))
        return np.load(fpath, allow_pickle=False,
                       mmap_mode="r" if mmap else None)


def save_training_data(td, path: str, shard_rows: int = 1 << 20) -> dict:
    """Persist an already-constructed TrainingData as a binned directory."""
    reader = getattr(td, "_binned_reader", None)
    num_cols = len(td.used_feature_idx) if td.bundle is None \
        else td.bundle.num_groups
    if reader is not None and os.path.abspath(reader.path) == \
            os.path.abspath(str(path)):
        Log.warning("save_binned: '%s' already backs this dataset; "
                    "skipping rewrite", path)
        return reader.header
    dtype = np.uint8
    if td.bundle is not None:
        if int(np.max(td.bundle.num_group_bins, initial=0)) > 256:
            dtype = np.uint16
    elif len(td.num_bin_arr) and int(td.num_bin_arr.max()) > 256:
        dtype = np.uint16
    writer = BinnedWriter(path, num_cols, dtype)
    if reader is not None:
        for _, view in reader.iter_shards():
            writer.append(view)
    else:
        binned = td.binned
        for s in range(0, max(td.num_data, 1), shard_rows):
            chunk = binned[s:s + shard_rows]
            if chunk.shape[0]:
                writer.append(chunk)
    fp = getattr(td, "_drift_fingerprint", None)
    return writer.finalize(
        num_total_features=td.num_total_features,
        used_feature_idx=td.used_feature_idx,
        feature_names=td.feature_names,
        max_bin=td.max_bin,
        bin_mappers=td.bin_mappers,
        bundle_groups=td.bundle.groups if td.bundle is not None else None,
        metadata=td.metadata,
        # the drift reference rides in the header, so a later from_binned
        # (and a model trained on it) carries the training fingerprint
        extra={"drift_fingerprint": fp} if fp is not None else None)
