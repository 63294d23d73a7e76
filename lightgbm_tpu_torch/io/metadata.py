"""Metadata: labels, weights, query boundaries, init scores + side files.

Parity target: include/LightGBM/dataset.h:36-248 and src/io/metadata.cpp,
as the JAX package's ``io/metadata.py``.  Side files ``<data>.weight``,
``<data>.query``, ``<data>.init`` are read when present, exactly like
``Metadata::Init(data_filename, ...)``; query id lists are converted to
boundary arrays; query weights are auto-derived from data weights (sum
per query) as in metadata.cpp.  Lambdarank and the NDCG and MAP metrics
read the query boundaries and weights.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..utils.log import Log


class Metadata:
    def __init__(self, num_data: int = 0):
        self.num_data = num_data
        self.label: Optional[np.ndarray] = None
        self.weights: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.query_weights: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    # ------------------------------------------------------------ side files
    def init_from_file(self, data_filename: str) -> None:
        """Load .weight/.query/.init side files if they exist
        (metadata.cpp LoadWeights/LoadQueryBoundaries/LoadInitialScore)."""
        wf = data_filename + ".weight"
        qf = data_filename + ".query"
        sf = data_filename + ".init"
        if os.path.exists(wf):
            self.set_weights(np.loadtxt(wf, dtype=np.float64, ndmin=1))
            Log.info("Loading weights...")
        if os.path.exists(qf):
            counts = np.loadtxt(qf, dtype=np.int64, ndmin=1)
            self.set_query_counts(counts)
            Log.info("Loading query boundaries...")
        if os.path.exists(sf):
            init = np.loadtxt(sf, dtype=np.float64, ndmin=1)
            self.init_score = init.reshape(-1)
            Log.info("Loading initial scores...")

    # --------------------------------------------------------------- setters
    def set_label(self, label) -> None:
        label = np.asarray(label, dtype=np.float32).reshape(-1)
        if self.num_data and len(label) != self.num_data:
            Log.fatal("Length of label is not same with #data")
        self.label = label
        if not self.num_data:
            self.num_data = len(label)

    def set_weights(self, weights) -> None:
        if weights is None:
            self.weights = None
            self.query_weights = None
            return
        weights = np.asarray(weights, dtype=np.float32).reshape(-1)
        if self.num_data and len(weights) != self.num_data:
            Log.fatal("Length of weights is not same with #data")
        self.weights = weights
        self._update_query_weights()

    def set_query_counts(self, counts) -> None:
        """Per-query data counts -> boundary array (metadata.cpp semantics)."""
        counts = np.asarray(counts, dtype=np.int64).reshape(-1)
        boundaries = np.zeros(len(counts) + 1, dtype=np.int64)
        np.cumsum(counts, out=boundaries[1:])
        if self.num_data and boundaries[-1] != self.num_data:
            Log.fatal("Sum of query counts is not same with #data")
        self.query_boundaries = boundaries
        self._update_query_weights()

    def set_query_id(self, qid) -> None:
        """Raw per-row query ids -> boundaries (requires grouped rows)."""
        qid = np.asarray(qid).reshape(-1)
        change = np.nonzero(np.diff(qid))[0] + 1
        boundaries = np.concatenate([[0], change, [len(qid)]])
        self.query_boundaries = boundaries.astype(np.int64)
        self._update_query_weights()

    def set_init_score(self, init_score) -> None:
        if init_score is None:
            self.init_score = None
            return
        self.init_score = np.asarray(init_score, dtype=np.float64).reshape(-1)

    def set_field(self, name: str, data) -> None:
        if name == "label":
            self.set_label(data)
        elif name == "weight":
            self.set_weights(data)
        elif name == "group" or name == "query":
            self.set_query_counts(data)
        elif name == "init_score":
            self.set_init_score(data)
        else:
            Log.fatal("Unknown field name: %s", name)

    def get_field(self, name: str):
        if name == "label":
            return self.label
        if name == "weight":
            return self.weights
        if name == "group" or name == "query":
            return self.query_boundaries
        if name == "init_score":
            return self.init_score
        Log.fatal("Unknown field name: %s", name)

    def _update_query_weights(self) -> None:
        """Sum data weights per query (metadata.cpp query_weights_ calc)."""
        if self.weights is None or self.query_boundaries is None:
            self.query_weights = None
            return
        nq = len(self.query_boundaries) - 1
        qw = np.add.reduceat(self.weights, self.query_boundaries[:-1])
        counts = np.diff(self.query_boundaries)
        qw = np.where(counts > 0, qw / np.maximum(counts, 1), 0.0)
        self.query_weights = qw.astype(np.float32)
        assert len(self.query_weights) == nq

    def num_queries(self) -> int:
        return 0 if self.query_boundaries is None else len(self.query_boundaries) - 1

    def subset(self, indices: np.ndarray) -> "Metadata":
        """Row subset copy used by bagging (metadata.cpp Init(fullset, used_indices))."""
        out = Metadata(len(indices))
        if self.label is not None:
            out.label = self.label[indices]
        if self.weights is not None:
            out.weights = self.weights[indices]
        if self.init_score is not None:
            ns = len(self.init_score) // max(self.num_data, 1)
            parts = [self.init_score[k * self.num_data:(k + 1) * self.num_data][indices]
                     for k in range(ns)]
            out.init_score = np.concatenate(parts) if parts else None
        # queries are not subsettable row-wise; ranking doesn't bag rows
        return out
