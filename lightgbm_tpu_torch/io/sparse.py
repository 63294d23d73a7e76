"""Sparse input without densification: CSR/CSC ingestion (host, numpy).

Ported from the JAX package's ``io/sparse.py`` (reference analog: SparseBin
and the sparse branches of DatasetLoader, src/io/sparse_bin.hpp:68,
src/io/dataset_loader.cpp:840-930).  The host ingest path never builds the
N x F float64 matrix: bin mappers come from each column's nonzero sample
(zeros are implicit in find_bin's total count) and binned columns are
written as default-bin fills plus nonzero scatters.

No scipy dependency: scipy objects are unpacked by duck typing, and the
CSR -> CSC conversion is a stable sort over column ids.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SparseColumns(NamedTuple):
    """Column-compressed (CSC) view of a sparse matrix."""
    colptr: np.ndarray      # (F+1,) int64
    indices: np.ndarray     # (nnz,) int64 row ids, sorted within a column
    values: np.ndarray      # (nnz,) float64
    num_row: int
    num_col: int

    def column(self, j: int):
        s, e = int(self.colptr[j]), int(self.colptr[j + 1])
        return self.indices[s:e], self.values[s:e]

    def take_rows(self, used_indices) -> "SparseColumns":
        """Row subset with renumbered indices.  used_indices must be
        strictly increasing, so rows stay sorted within each column."""
        used = np.asarray(used_indices, dtype=np.int64)
        if len(used) > 1 and (np.diff(used) <= 0).any():
            raise ValueError("take_rows requires strictly increasing "
                             "row indices")
        pos = np.full(self.num_row, -1, dtype=np.int64)
        pos[used] = np.arange(len(used))
        new_rows = pos[self.indices]
        keep = new_rows >= 0
        counts = np.zeros(self.num_col, dtype=np.int64)
        col_of = np.repeat(np.arange(self.num_col, dtype=np.int64),
                           np.diff(self.colptr))[keep]
        np.add.at(counts, col_of, 1)
        colptr = np.zeros(self.num_col + 1, dtype=np.int64)
        np.cumsum(counts, out=colptr[1:])
        return SparseColumns(colptr, new_rows[keep], self.values[keep],
                             len(used), self.num_col)


def csr_to_csc(indptr, indices, data, num_col: int) -> SparseColumns:
    """CSR -> CSC by a stable sort on column ids (no N x F matrix)."""
    indptr = np.asarray(indptr, dtype=np.int64)
    col_ids = np.asarray(indices, dtype=np.int64)
    vals = np.asarray(data, dtype=np.float64)
    n = len(indptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    order = np.argsort(col_ids, kind="stable")   # stable: rows stay sorted
    counts = np.bincount(col_ids, minlength=num_col)
    colptr = np.zeros(num_col + 1, dtype=np.int64)
    np.cumsum(counts, out=colptr[1:])
    return SparseColumns(colptr, rows[order], vals[order], n, num_col)


def csc_arrays(colptr, indices, data, num_row: int) -> SparseColumns:
    colptr = np.asarray(colptr, dtype=np.int64)
    return SparseColumns(colptr, np.asarray(indices, dtype=np.int64),
                         np.asarray(data, dtype=np.float64),
                         int(num_row), len(colptr) - 1)


def is_scipy_sparse(obj) -> bool:
    return hasattr(obj, "tocsc") and hasattr(obj, "shape")


def from_scipy(obj) -> SparseColumns:
    """Unpack any scipy.sparse matrix through its CSC form (no densify)."""
    csc = obj.tocsc()
    csc.sort_indices()
    return SparseColumns(np.asarray(csc.indptr, dtype=np.int64),
                         np.asarray(csc.indices, dtype=np.int64),
                         np.asarray(csc.data, dtype=np.float64),
                         int(csc.shape[0]), int(csc.shape[1]))


def iter_dense_row_chunks(sp: SparseColumns, chunk: int = 8192):
    """Yield (start, dense_block) row chunks for row-major consumers
    (prediction), O(chunk * F) memory at a time."""
    col_of_nnz = np.repeat(np.arange(sp.num_col, dtype=np.int64),
                           np.diff(sp.colptr))
    order = np.argsort(sp.indices, kind="stable")
    r_sorted = sp.indices[order]
    c_sorted = col_of_nnz[order]
    v_sorted = sp.values[order]
    starts = np.searchsorted(r_sorted, np.arange(0, sp.num_row + 1, 1))
    for s in range(0, sp.num_row, chunk):
        e = min(s + chunk, sp.num_row)
        lo, hi = starts[s], starts[e]
        block = np.zeros((e - s, sp.num_col), dtype=np.float64)
        block[r_sorted[lo:hi] - s, c_sorted[lo:hi]] = v_sorted[lo:hi]
        yield s, block
