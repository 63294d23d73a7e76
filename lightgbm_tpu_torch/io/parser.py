"""Text parsers: CSV / TSV / LibSVM with format auto-detection.

Parity target: src/io/parser.hpp:15-77 and src/io/parser.cpp:10-101 — format
is detected by counting separator occurrences and colons in the first two
non-empty lines; LibSVM when ':' pairs dominate, else tab vs comma vs space.
Vectorized with numpy for the dense formats.  The same parser as the JAX
package's ``io/parser.py``, in Python; the host library's
``native.parse_file`` parses the same formats into the same values.
"""
from __future__ import annotations

import io
from typing import List, Optional, Tuple

import numpy as np

from ..utils.log import Log


def _count_stats(line: str) -> Tuple[int, int, int]:
    """(num_commas, num_tabs, num_colon_pairs) in one line."""
    return line.count(","), line.count("\t"), line.count(":")


def detect_format(sample_lines: List[str]) -> str:
    """Return 'csv' | 'tsv' | 'libsvm' (parser.cpp:10-70 semantics)."""
    lines = [l for l in sample_lines if l.strip()][:2]
    if not lines:
        return "csv"
    stats = [_count_stats(l) for l in lines]
    comma = min(s[0] for s in stats)
    tab = min(s[1] for s in stats)
    colon = min(s[2] for s in stats)
    if colon > 0 and colon >= max(comma, tab):
        return "libsvm"
    if tab > 0 and tab >= comma:
        return "tsv"
    if comma > 0:
        return "csv"
    # space-separated falls into the TSV code path with ' ' separator
    return "space"


_SEP = {"csv": ",", "tsv": "\t", "space": None}


class ParsedData:
    """Dense row-major matrix + label column, the parser output."""

    def __init__(self, features: np.ndarray, label: np.ndarray,
                 fmt: str, label_idx: int):
        self.features = features
        self.label = label
        self.format = fmt
        self.label_idx = label_idx

    @property
    def num_data(self) -> int:
        return self.features.shape[0]

    @property
    def num_features(self) -> int:
        return self.features.shape[1]


def parse_file(filename: str, has_header: bool = False, label_idx: int = 0,
               max_lines: Optional[int] = None) -> ParsedData:
    with open(filename, "r") as f:
        text = f.read()
    return parse_text(text, has_header=has_header, label_idx=label_idx,
                      max_lines=max_lines)


def read_header(filename: str) -> List[str]:
    with open(filename, "r") as f:
        first = f.readline().rstrip("\r\n")
    fmt = detect_format([first])
    sep = _SEP.get(fmt)
    return first.split(sep) if sep else first.split()


def parse_text(text: str, has_header: bool = False, label_idx: int = 0,
               max_lines: Optional[int] = None) -> ParsedData:
    lines = text.splitlines()
    if has_header and lines:
        lines = lines[1:]
    lines = [l for l in lines if l.strip()]
    if max_lines is not None:
        lines = lines[:max_lines]
    if not lines:
        Log.fatal("Data file is empty")
    fmt = detect_format(lines)
    if fmt == "libsvm":
        return _parse_libsvm(lines, label_idx)
    sep = _SEP[fmt]
    return _parse_dense(lines, sep, fmt, label_idx)


def _parse_dense(lines: List[str], sep: Optional[str], fmt: str,
                 label_idx: int) -> ParsedData:
    buf = io.StringIO("\n".join(lines))
    try:
        mat = np.loadtxt(buf, delimiter=sep, dtype=np.float64, ndmin=2)
    except ValueError:
        # tolerate 'na'/'nan'/'inf' mixes by per-token conversion fallback
        rows = []
        for l in lines:
            toks = l.split(sep) if sep else l.split()
            rows.append([_safe_float(t) for t in toks])
        mat = np.asarray(rows, dtype=np.float64)
    if label_idx >= 0 and label_idx < mat.shape[1]:
        label = mat[:, label_idx].copy()
        feats = np.delete(mat, label_idx, axis=1)
    else:
        label = np.zeros(mat.shape[0], dtype=np.float64)
        feats = mat
    return ParsedData(np.ascontiguousarray(feats), label, fmt, label_idx)


def _safe_float(tok: str) -> float:
    tok = tok.strip()
    if not tok or tok.lower() in ("na", "nan", "null", "none"):
        return np.nan
    try:
        return float(tok)
    except ValueError:
        return np.nan


def _parse_libsvm(lines: List[str], label_idx: int) -> ParsedData:
    labels = np.empty(len(lines), dtype=np.float64)
    pairs: List[List[Tuple[int, float]]] = []
    max_feat = -1
    for i, l in enumerate(lines):
        toks = l.split()
        if toks and ":" not in toks[0]:
            labels[i] = float(toks[0])
            toks = toks[1:]
        else:
            labels[i] = 0.0
        row = []
        for t in toks:
            if ":" not in t:
                continue
            k, _, v = t.partition(":")
            fi = int(k)
            row.append((fi, float(v)))
            if fi > max_feat:
                max_feat = fi
        pairs.append(row)
    feats = np.zeros((len(lines), max_feat + 1), dtype=np.float64)
    for i, row in enumerate(pairs):
        for fi, v in row:
            feats[i, fi] = v
    return ParsedData(feats, labels, "libsvm", label_idx)
