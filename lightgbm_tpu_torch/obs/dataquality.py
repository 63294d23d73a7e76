"""Data-quality profiling at Dataset construction time.

The port's copy of the JAX package's ``obs/dataquality.py`` (which
imports no jax), over the port's BinMappers (io/binning.py).

Profiles the binning sample against the fitted BinMappers (io/binning.py)
— the exact data the split search will see — and emits one
``data_profile`` event per training dataset on the obs timeline:

* per-feature missing rate (NaN fraction in the sample) and normalized
  bin-occupancy entropy (H / log(num_bin): 1.0 = uniform over bins,
  -> 0 = mass piled in one bin);
* degeneracy flags: ``constant`` (binned into a single bucket, the
  learner will never split it), ``near_constant`` (top bin holds almost
  every row), ``high_cardinality`` (categorical with almost as many
  categories as sampled rows — an ID-like column that invites
  overfitting);
* label balance (distinct values / class fractions for few-class labels).

Findings route through the health channel (health.py semantics): under
``obs_health=warn`` every finding is a ``health`` event + log warning;
under ``obs_health=fatal`` the *error*-severity findings (constant
feature, all-missing feature, single-class label) abort the run before
any iteration burns device time on a dataset that cannot train.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np

from ..utils.log import Log
from .metrics import REGISTRY

# near-constant: top bin occupancy at or above this fraction of the sample
NEAR_CONSTANT_TOP_FRAC = 0.999
# high-cardinality categorical: distinct categories >= this fraction of
# the (non-missing) sampled rows
HIGH_CARDINALITY_FRAC = 0.5
# label imbalance warning: minority class below this fraction
LABEL_IMBALANCE_FRAC = 0.01
# per-feature arrays are included in the event only up to this width
# (beyond it the flags + aggregates still tell the story at 1/100 the bytes)
MAX_PROFILE_ARRAYS = 512


def profile_columns(bin_mappers, get_col: Callable[[int], np.ndarray],
                    n_features: int, sample_size: int,
                    categorical: Optional[set] = None) -> dict:
    """Per-feature quality profile from the binning sample.

    ``get_col(f)`` returns feature f's sampled values (NaN = missing,
    zeros materialized) — a closure over the dense sample matrix or the
    sparse per-column sample cache.  ``bin_mappers[f]`` may be None or
    trivial; those features are profiled from raw values only.
    """
    from ..io.binning import CATEGORICAL

    categorical = categorical or set()
    missing_rate: List[float] = []
    entropy: List[Optional[float]] = []
    constant: List[int] = []
    filtered: List[int] = []
    near_constant: List[int] = []
    high_cardinality: List[int] = []
    s = max(int(sample_size), 1)
    for f in range(n_features):
        col = np.asarray(get_col(f), dtype=np.float64)
        nan_mask = np.isnan(col)
        miss = float(nan_mask.sum()) / s
        missing_rate.append(round(miss, 6))
        m = bin_mappers[f] if f < len(bin_mappers) else None
        is_cat = (f in categorical or
                  (m is not None and m.bin_type == CATEGORICAL))
        if miss >= 1.0 or m is None or m.num_bin <= 1:
            # single bucket (or nothing to bin): the learner cannot split it
            constant.append(f)
            entropy.append(None)
            continue
        finite = col[~nan_mask]
        if is_cat:
            # categorical value_to_bin is a scalar dict loop — count raw
            # category occupancy directly instead
            _, counts = np.unique(finite, return_counts=True)
        else:
            bins = m.value_to_bin(finite)
            counts = np.bincount(bins.astype(np.int64),
                                 minlength=m.num_bin)
            counts = counts[counts > 0]
        if len(counts) <= 1:
            # one occupied bucket in the sample: constant in the data —
            # even when the mapper allotted two bins (a constant nonzero
            # value gets a value bin plus the zero bin)
            constant.append(f)
            entropy.append(None)
            continue
        if m.is_trivial:
            # multiple occupied buckets but dropped by the min-split-data
            # filter (need_filter, io/binning.py) — unusable, not constant
            filtered.append(f)
            entropy.append(None)
            continue
        p = counts / counts.sum()
        h = float(-(p * np.log(p)).sum()) / math.log(max(m.num_bin, 2))
        entropy.append(round(h, 4))
        if float(counts.max()) / max(len(finite), 1) >= \
                NEAR_CONSTANT_TOP_FRAC:
            near_constant.append(f)
        if is_cat and len(counts) >= HIGH_CARDINALITY_FRAC * \
                max(len(finite), 1) and len(counts) > 8:
            high_cardinality.append(f)

    profile = {
        "n_features": int(n_features),
        "sample_size": int(sample_size),
        "constant": constant,
        "filtered": filtered,
        "near_constant": near_constant,
        "high_cardinality": high_cardinality,
        "mean_missing_rate": round(float(np.mean(missing_rate)), 6)
        if missing_rate else 0.0,
    }
    ent = [e for e in entropy if e is not None]
    if ent:
        profile["mean_entropy"] = round(float(np.mean(ent)), 4)
    if n_features <= MAX_PROFILE_ARRAYS:
        profile["missing_rate"] = missing_rate
        profile["entropy"] = entropy
    return profile


def label_profile(label: Optional[np.ndarray], max_classes: int = 32) -> dict:
    """Label balance: class fractions when the label has few distinct
    values (classification-shaped), distinct count otherwise."""
    if label is None or len(label) == 0:
        return {"n": 0}
    label = np.asarray(label, dtype=np.float64)
    out: Dict = {"n": int(len(label))}
    values, counts = np.unique(label[~np.isnan(label)], return_counts=True)
    out["n_distinct"] = int(len(values))
    if 0 < len(values) <= max_classes:
        total = counts.sum()
        out["classes"] = {repr(float(v)): int(c)
                          for v, c in zip(values, counts)}
        out["min_class_frac"] = round(float(counts.min()) / max(total, 1), 6)
    return out


def build_findings(profile: dict, label: dict,
                   feature_names: Optional[List[str]] = None) -> List[dict]:
    """Profile -> findings list.  severity 'error' = training cannot work
    (fatal-eligible under obs_health=fatal); 'warning' = suspicious."""
    def name(f):
        if feature_names and 0 <= f < len(feature_names):
            return feature_names[f]
        return "Column_%d" % f

    findings: List[dict] = []
    rates = profile.get("missing_rate") or []
    for f in profile.get("constant", []):
        all_missing = f < len(rates) and rates[f] >= 1.0
        findings.append({
            "severity": "error", "feature": int(f),
            "flag": "all_missing" if all_missing else "constant",
            "message": "feature %d (%s) is %s — it bins into a single "
                       "bucket and can never be split" %
                       (f, name(f),
                        "entirely missing" if all_missing else "constant")})
    for f in profile.get("filtered", []):
        findings.append({
            "severity": "warning", "feature": int(f),
            "flag": "filtered",
            "message": "feature %d (%s) was dropped by the min-split-data "
                       "filter (no bin boundary can satisfy "
                       "min_data_in_leaf)" % (f, name(f))})
    for f in profile.get("near_constant", []):
        findings.append({
            "severity": "warning", "feature": int(f),
            "flag": "near_constant",
            "message": "feature %d (%s) is near-constant (top bin holds "
                       ">=%.1f%% of sampled rows)" %
                       (f, name(f), NEAR_CONSTANT_TOP_FRAC * 100)})
    for f in profile.get("high_cardinality", []):
        findings.append({
            "severity": "warning", "feature": int(f),
            "flag": "high_cardinality",
            "message": "categorical feature %d (%s) has ID-like "
                       "cardinality (categories >= %.0f%% of sampled "
                       "rows) — likely to overfit" %
                       (f, name(f), HIGH_CARDINALITY_FRAC * 100)})
    nd = label.get("n_distinct")
    if nd == 1:
        findings.append({
            "severity": "error", "flag": "single_class_label",
            "message": "label has a single distinct value — every tree "
                       "will be a stub"})
    elif (label.get("min_class_frac") is not None
          and label["min_class_frac"] < LABEL_IMBALANCE_FRAC):
        findings.append({
            "severity": "warning", "flag": "label_imbalance",
            "message": "label is heavily imbalanced (minority class "
                       "fraction %.4g < %g)" %
                       (label["min_class_frac"], LABEL_IMBALANCE_FRAC)})
    return findings


def emit_data_profile(obs, profile: dict, label: dict,
                      findings: List[dict], health_mode: str = "off",
                      dataset: str = "train") -> None:
    """Write the ``data_profile`` event and route findings through the
    health channel (mirrors health.HealthMonitors._resolve): every
    finding logs + emits a ``health`` event; under ``fatal`` the
    error-severity ones abort before training starts."""
    REGISTRY.counter(
        "dataset_quality_findings_total",
        "data-quality findings raised at dataset construction",
    ).inc(len(findings))
    obs.event("data_profile", dataset=dataset, label=label,
              findings=findings, **profile)
    if health_mode not in ("warn", "fatal") or not findings:
        return
    fatal = []
    for fd in findings:
        status = ("fatal" if (health_mode == "fatal"
                              and fd["severity"] == "error") else "warn")
        obs.event("health", check="data_profile", status=status, it=-1,
                  detail=fd)
        Log.warning("data_profile[%s] %s", status, fd["message"])
        if status == "fatal":
            fatal.append(fd["message"])
    if fatal:
        obs.flush()               # the timeline must survive the raise
        Log.fatal("obs_health=fatal: degenerate dataset — %s"
                  % "; ".join(fatal))
