"""Drift & online model-quality monitoring: serving traffic vs the
training-time data world.

The port's copy of the JAX package's ``obs/drift.py`` (numpy and the
port's BinMapper, io/binning.py): the same fingerprint, the same PSI
and KS statistics and the same events, so a fingerprint written into a
model text by either package drives the other's monitor.

Training observability ends the moment the model ships; what a serving
process sees — and how well the frozen trees score it — is exactly the
signal the continuous-training loop needs before "retrain now" can be
anything but a guess.  The benchmarking literature (arxiv 1809.04559)
ties GBDT quality tightly to the input distribution the trees were
grown on, so a feature or score distribution shift is the earliest
actionable warning that train-time AUC parity no longer holds.

Three pieces:

* **Fingerprint** (training side) — ``feature_fingerprint`` captures
  per-feature binned histograms straight from the BinMapper sample (the
  same pass obs/dataquality.py profiles, with the bin counts kept
  instead of discarded), each with its frozen mapper so a serving
  process can re-bin without the dataset; ``attach_scores`` adds the
  raw-score distribution on the training set (quantile-edged histogram,
  plus the converted-output distribution when the objective has one)
  and the final eval snapshot.  The fingerprint persists as one JSON
  ``drift_fingerprint=`` header line in the model text format
  (models/gbdt.py) and as a header field of the pre-binned dataset dir
  (io/binned_format.py), so any serving process loads its reference
  for free.

* **DriftMonitor** (serving side) — hooked into ``ServingPredictor``
  / ``Booster.predict``: bins incoming feature values with the frozen
  mappers (host-side searchsorted + bincount over arrays already in
  hand — zero device work, zero fences) and sketches prediction scores
  into rolling windows.  Every ``obs_drift_every`` rows it computes
  PSI and KS divergence per feature and for the score distribution,
  emits a schema-14 ``drift`` event, updates the
  ``lgbm_drift_psi{feature=...}`` gauges, and drives an alert state
  machine routed through the ``obs_health`` channel (warn-only, like
  slo_burn_rate: drift is a retrain signal — killing the server that
  detected it only makes the outage total).  A delayed-label channel
  (``ServingPredictor.record_outcome``) joins ground truth when it
  arrives for rolling online AUC/logloss vs the training-time
  reference (``online_quality`` events, ``lgbm_online_auc``).  The
  monitor also guards serving-input quality: non-finite or
  out-of-bin-range values — which otherwise vanish into the generic
  missing-bin path — count per feature into
  ``lgbm_serve_input_anomalies_total`` with a first-occurrence health
  warning reusing the dataquality finding shape.

* **render_drift_report** (reader side) — ``python -m lightgbm_tpu_torch obs
  drift <timeline> [--check]``: features ranked by divergence with a
  train-vs-serve histogram diff table; ``--check`` exits 1 on a fired
  drift alert or a timeline with no drift events at all.
"""
from __future__ import annotations

import sys
import threading
import time

import numpy as np

from .metrics import REGISTRY
from ..utils.log import Log

FINGERPRINT_VERSION = 1
# fingerprint covers at most this many features (the dataquality
# MAX_PROFILE_ARRAYS discipline: beyond it the bytes outweigh the story)
MAX_FINGERPRINT_FEATURES = 512
# score histograms use this many quantile bins of the training scores
SCORE_BINS = 20
# Laplace smoothing mass per bin for PSI (keeps ln finite on empty bins)
_SMOOTH = 0.5
# PSI buckets per feature at evaluation time: the raw mapper bins (up
# to max_bin=255) coalesce into this many equal-reference-mass groups.
# PSI's small-sample bias is ~(B-1)*(1/N_ref + 1/N_cur) — over 255 bins
# a 512-row window sits at ~0.5 PSI of pure noise, over 16 groups at
# ~0.03, comfortably under the 0.1 'stable' line (the convention of
# 10-20 PSI buckets exists for exactly this reason)
DRIFT_GROUPS = 16
# PSI interpretation convention: < 0.1 stable, 0.1-0.25 moderate,
# >= 0.25 major shift; the default alert threshold sits between
DEFAULT_PSI_THRESHOLD = 0.2
# an evaluation needs at least this many window rows to be meaningful
MIN_EVAL_ROWS = 64


# ======================================================================
# fingerprint (training side)
# ======================================================================

def feature_fingerprint(bin_mappers, get_col, n_features, sample_size,
                        feature_names=None,
                        max_features=MAX_FINGERPRINT_FEATURES):
    """Per-feature reference histograms from the binning sample.

    Same access pattern as dataquality.profile_columns — ``get_col(f)``
    returns feature f's sampled values — but the bin-aligned counts are
    the product here, not a discarded intermediate: PSI needs mass per
    bin INDEX, aligned with what the frozen mapper will produce at
    serving time.  Features whose mapper cannot discriminate (missing,
    trivial, single-bin) are skipped; a shifted stream cannot drift on
    a feature the model never splits."""
    feats = []
    for f in range(int(n_features)):
        if len(feats) >= max_features:
            Log.warning("drift fingerprint capped at %d features "
                        "(of %d)", max_features, n_features)
            break
        m = bin_mappers[f] if f < len(bin_mappers) else None
        if m is None or m.num_bin <= 1 or m.is_trivial:
            continue
        col = np.asarray(get_col(f), dtype=np.float64)
        bins = np.asarray(m.value_to_bin(col), dtype=np.int64)
        counts = np.bincount(bins, minlength=m.num_bin)
        name = (feature_names[f]
                if feature_names and f < len(feature_names)
                else "Column_%d" % f)
        feats.append({"index": int(f), "name": str(name),
                      "counts": [int(c) for c in counts],
                      "mapper": m.to_dict()})
    return {"version": FINGERPRINT_VERSION,
            "sample_size": int(sample_size),
            "features": feats}


def score_histogram(values, bins=SCORE_BINS):
    """Quantile-edged histogram of a score sample: interior edges at the
    i/bins quantiles (deduplicated), counts per edge interval.  Quantile
    edges make the reference roughly uniform, the shape PSI is most
    sensitive on."""
    v = np.asarray(values, dtype=np.float64).reshape(-1)
    v = v[np.isfinite(v)]
    if v.size == 0:
        return None
    qs = np.linspace(0.0, 1.0, int(bins) + 1)[1:-1]
    edges = np.unique(np.quantile(v, qs))
    counts = np.bincount(np.searchsorted(edges, v, side="left"),
                         minlength=len(edges) + 1)
    return {"edges": [float(e) for e in edges],
            "counts": [int(c) for c in counts]}


def attach_scores(fingerprint, train_score=None, objective=None,
                  eval_results=None):
    """Complete a feature fingerprint with the training-time score
    distribution(s) and the final eval snapshot.  ``train_score`` is
    the (k, num_data) raw-score matrix; the converted-output histogram
    is added when the objective transforms scores (the space a default
    ``predict()`` serves in)."""
    fp = dict(fingerprint or
              {"version": FINGERPRINT_VERSION, "sample_size": 0,
               "features": []})
    scores = {}
    if train_score is not None:
        raw = np.asarray(train_score, dtype=np.float64).reshape(-1)
        h = score_histogram(raw)
        if h is not None:
            scores["raw"] = h
        if objective is not None:
            try:
                conv = np.asarray(objective.convert_output(
                    np.asarray(train_score, dtype=np.float64)))
                if not np.allclose(conv.reshape(-1), raw,
                                   equal_nan=True):
                    h = score_histogram(conv)
                    if h is not None:
                        scores["output"] = h
            except Exception as e:   # fingerprinting must never break train
                Log.warning("drift fingerprint: convert_output failed "
                            "(%s); raw-score reference only", e)
    if scores:
        fp["scores"] = scores
    if eval_results:
        fp["eval"] = [{"dataset": str(r.get("dataset")),
                       "metric": str(r.get("metric")),
                       "value": float(r.get("value"))}
                      for r in eval_results]
    return fp


# ======================================================================
# divergence
# ======================================================================

def psi(ref_counts, cur_counts):
    """Population stability index between two aligned count vectors,
    with Laplace smoothing so empty bins stay finite.  Symmetric-ish,
    >= 0, ~0 for same distribution."""
    p = np.asarray(ref_counts, dtype=np.float64) + _SMOOTH
    q = np.asarray(cur_counts, dtype=np.float64) + _SMOOTH
    p /= p.sum()
    q /= q.sum()
    return float(np.sum((q - p) * np.log(q / p)))


def ks_stat(ref_counts, cur_counts):
    """Kolmogorov-Smirnov statistic over binned data: max |CDF diff|."""
    p = np.asarray(ref_counts, dtype=np.float64)
    q = np.asarray(cur_counts, dtype=np.float64)
    if p.sum() <= 0 or q.sum() <= 0:
        return 0.0
    return float(np.max(np.abs(np.cumsum(p / p.sum())
                               - np.cumsum(q / q.sum()))))


def _bin_diff_table(ref_counts, cur_counts, top=3):
    """The most-shifted bins of one feature: [(bin, ref_frac,
    cur_frac)] ranked by |ref - cur| mass — the per-feature evidence
    row of the report's histogram diff table."""
    p = np.asarray(ref_counts, dtype=np.float64)
    q = np.asarray(cur_counts, dtype=np.float64)
    p = p / p.sum() if p.sum() > 0 else p
    q = q / q.sum() if q.sum() > 0 else q
    order = np.argsort(-np.abs(p - q), kind="stable")[:top]
    return [{"bin": int(b), "ref": round(float(p[b]), 4),
             "cur": round(float(q[b]), 4)} for b in order]


def _auc(scores, labels):
    """Rank-based AUC (average ranks on ties); None when degenerate."""
    y = np.asarray(labels, dtype=np.float64)
    s = np.asarray(scores, dtype=np.float64)
    pos = y > 0
    npos = int(pos.sum())
    nneg = int(y.size - npos)
    if npos == 0 or nneg == 0:
        return None
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(y.size, dtype=np.float64)
    ranks[order] = np.arange(1, y.size + 1, dtype=np.float64)
    # average ranks over tied scores
    sorted_s = s[order]
    i = 0
    while i < y.size:
        j = i
        while j + 1 < y.size and sorted_s[j + 1] == sorted_s[i]:
            j += 1
        if j > i:
            ranks[order[i:j + 1]] = 0.5 * (i + j) + 1.0
        i = j + 1
    return float((ranks[pos].sum() - npos * (npos + 1) / 2.0)
                 / (npos * nneg))


def _logloss(probs, labels):
    p = np.clip(np.asarray(probs, dtype=np.float64), 1e-15, 1 - 1e-15)
    y = np.asarray(labels, dtype=np.float64)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


# ======================================================================
# DriftMonitor (serving side)
# ======================================================================

def _group_map(ref_counts, max_groups=DRIFT_GROUPS):
    """Greedy equal-reference-mass packing of bin index -> group index;
    returns (map array, group count).  Deterministic from the reference
    counts, so every serving process derives the same grouping."""
    ref = np.asarray(ref_counts, dtype=np.float64)
    total = ref.sum()
    if total <= 0 or len(ref) <= max_groups:
        n = max(len(ref), 1)
        return np.arange(n, dtype=np.int64), n
    target = total / max_groups
    gmap = np.empty(len(ref), dtype=np.int64)
    g = 0
    acc = 0.0
    for i, c in enumerate(ref):
        gmap[i] = g
        acc += c
        if acc >= target and g < max_groups - 1:
            g += 1
            acc = 0.0
    return gmap, g + 1


def _anomaly_counter(feature, kind):
    """Per-(feature, kind) series of the serving-input anomaly counter
    (get-or-create; the registry keys one instrument per label set)."""
    return REGISTRY.counter(
        "lgbm_serve_input_anomalies_total",
        "serving-input anomalies (non-finite or out-of-bin-range "
        "feature values) by feature and kind",
        labels={"feature": feature, "kind": kind})


class _FeatureState:
    __slots__ = ("index", "name", "mapper", "gmap", "ref", "counts",
                 "non_finite", "out_of_range", "warned")

    def __init__(self, index, name, mapper, ref):
        self.index = index
        self.name = name
        self.mapper = mapper
        # PSI works over DRIFT_GROUPS equal-reference-mass groups of
        # the raw mapper bins (see the bias note at DRIFT_GROUPS)
        self.gmap, n_groups = _group_map(ref)
        self.ref = np.bincount(
            self.gmap, weights=np.asarray(ref, dtype=np.float64),
            minlength=n_groups).astype(np.int64)
        self.counts = np.zeros(n_groups, dtype=np.int64)
        self.non_finite = 0
        self.out_of_range = 0
        self.warned = False


class DriftMonitor:
    """Rolling-window drift + online-quality monitor for a serving
    process.  Thread-safe; fed host-side numpy from the submit path —
    binning is searchsorted/bincount on arrays the caller already
    materialized, so monitoring adds no device work and no fences.

    ``clock`` is injectable for tests, mirroring obs/serve.SloEngine.
    """

    def __init__(self, fingerprint, observer=None, mode="warn",
                 every_rows=2048, window_rows=8192,
                 psi_threshold=DEFAULT_PSI_THRESHOLD, topk=10,
                 min_labels=100, clock=time.monotonic):
        from .events import NULL_OBSERVER
        from .health import MODES
        from ..io.binning import BinMapper
        self.observer = observer if observer is not None else NULL_OBSERVER
        mode = str(mode or "warn").strip().lower()
        if mode not in MODES:
            raise ValueError("drift mode %r (expected off/warn/fatal)"
                             % (mode,))
        self.mode = mode
        self.every_rows = max(1, int(every_rows))
        self.window_rows = max(self.every_rows, int(window_rows))
        self.psi_threshold = float(psi_threshold)
        self.topk = max(1, int(topk))
        self.min_labels = max(1, int(min_labels))
        self.clock = clock
        fp = fingerprint or {}
        self._feats = []
        for entry in fp.get("features") or ():
            try:
                m = BinMapper.from_dict(entry["mapper"])
                self._feats.append(_FeatureState(
                    int(entry["index"]), str(entry["name"]),
                    m, entry["counts"]))
            except (KeyError, TypeError, ValueError) as e:
                Log.warning("drift: skipping malformed fingerprint "
                            "feature (%s)", e)
        # score references per space ("raw" / "output"); serving output
        # lands in whichever space the route produced
        self._score_ref = {}
        self._score_counts = {}
        for space, h in (fp.get("scores") or {}).items():
            edges = np.asarray(h.get("edges") or (), dtype=np.float64)
            self._score_ref[space] = (edges,
                                      np.asarray(h.get("counts"),
                                                 dtype=np.int64))
            self._score_counts[space] = np.zeros(len(edges) + 1,
                                                 dtype=np.int64)
        self._ref_eval = list(fp.get("eval") or ())
        self._lock = threading.Lock()
        self._rows = 0             # lifetime rows observed
        self._win_rows = 0         # rows in the current rolling window
        self._since_eval = 0
        # delayed-label join: id -> (prob-space score); bounded so a
        # caller that never records outcomes cannot leak memory
        self._pending = {}
        self._pending_cap = 65536
        self._outcomes = []        # rolling (prob, label) pairs
        self._outcome_cap = max(self.window_rows, 4096)
        self.alerting = False
        self.alerts_fired = 0
        self.alerts_cleared = 0
        self._last_psi = {}        # host-side snapshot for /statusz
        self._last_eval_out = None
        self._last_quality = None
        self._m_psi_max = REGISTRY.gauge(
            "lgbm_drift_psi_max",
            "largest per-feature PSI vs the training fingerprint at "
            "the last drift evaluation")
        self._m_alerts = REGISTRY.counter(
            "lgbm_drift_alerts_total",
            "drift alerts fired against the training fingerprint")

    @property
    def enabled(self):
        return bool(self._feats or self._score_ref)

    # ------------------------------------------------------------ writing
    def observe_features(self, X):
        """One block of submitted feature rows (host float64).  Bins
        every fingerprinted feature with its frozen mapper and counts
        input anomalies; triggers an evaluation when ``every_rows``
        rows have accumulated since the last one."""
        X = np.asarray(X, dtype=np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        n = X.shape[0]
        if n == 0 or not self._feats:
            return
        warn_feats = []
        with self._lock:
            for fs in self._feats:
                if fs.index >= X.shape[1]:
                    continue
                col = X[:, fs.index]
                finite = np.isfinite(col)
                n_bad = int(col.size - finite.sum())
                n_oor = 0
                m = fs.mapper
                from ..io.binning import NUMERICAL
                if m.bin_type == NUMERICAL and np.isfinite(m.min_val) \
                        and np.isfinite(m.max_val):
                    fv = col[finite]
                    n_oor = int(((fv < m.min_val)
                                 | (fv > m.max_val)).sum())
                if n_bad:
                    fs.non_finite += n_bad
                    _anomaly_counter(fs.name, "non_finite").inc(n_bad)
                if n_oor:
                    fs.out_of_range += n_oor
                    _anomaly_counter(fs.name, "out_of_range").inc(n_oor)
                if (n_bad or n_oor) and not fs.warned:
                    fs.warned = True
                    warn_feats.append((fs, n_bad, n_oor))
                bins = np.asarray(m.value_to_bin(col), dtype=np.int64)
                np.clip(bins, 0, len(fs.gmap) - 1, out=bins)
                fs.counts += np.bincount(fs.gmap[bins],
                                         minlength=len(fs.counts))
            self._rows += n
            self._win_rows += n
            self._since_eval += n
            due = self._since_eval >= self.every_rows
            if due:
                self._since_eval = 0
        for fs, n_bad, n_oor in warn_feats:
            self._warn_anomaly(fs, n_bad, n_oor)
        if due:
            self.evaluate()

    def _warn_anomaly(self, fs, n_bad, n_oor):
        """First-occurrence serving-input quality warning, reusing the
        dataquality finding shape (severity/feature/flag/message) so
        every data-quality consumer reads one dialect.  These values
        previously vanished into the generic missing-bin path."""
        flag = "non_finite" if n_bad else "out_of_range"
        finding = {
            "severity": "warning", "feature": int(fs.index),
            "flag": flag,
            "message": "serving input anomaly on feature %d (%s): %d "
                       "non-finite, %d out-of-bin-range value(s) — "
                       "binned into the missing bin; see "
                       "lgbm_serve_input_anomalies_total"
                       % (fs.index, fs.name, n_bad, n_oor)}
        Log.warning("serve input[warn] %s", finding["message"])
        if self.mode == "off":
            return
        obs = self.observer
        if obs.enabled:
            obs.event("health", check="serve_input", status="warn",
                      it=-1, detail=finding)

    def observe_scores(self, scores, raw=False):
        """One block of prediction outputs.  ``raw`` selects which
        training-time reference distribution these scores compare
        against; multiclass blocks flatten (the reference did too)."""
        space = "raw" if raw else "output"
        ref = self._score_ref.get(space)
        if ref is None and not raw:
            # an objective with no output transform serves raw scores
            space, ref = "raw", self._score_ref.get("raw")
        if ref is None:
            return
        edges, _ = ref
        v = np.asarray(scores, dtype=np.float64).reshape(-1)
        v = v[np.isfinite(v)]
        if v.size == 0:
            return
        idx = np.searchsorted(edges, v, side="left")
        due = False
        with self._lock:
            self._score_counts[space] += np.bincount(
                idx, minlength=len(edges) + 1)
            if not self._feats:
                # score-only fingerprint: the cadence counters have no
                # feature stream to ride, so rows count here instead
                self._rows += v.size
                self._win_rows += v.size
                self._since_eval += v.size
                due = self._since_eval >= self.every_rows
                if due:
                    self._since_eval = 0
        if due:
            self.evaluate()

    def note_predictions(self, ids, scores, raw=False):
        """Remember per-request prediction scores (probability space)
        keyed by caller ids, awaiting ``record_outcome``.  Bounded:
        oldest entries fall out once the cap is hit."""
        s = np.asarray(scores, dtype=np.float64).reshape(-1)
        if raw:   # store probabilities so online logloss is well-defined
            s = 1.0 / (1.0 + np.exp(-s))
        with self._lock:
            for i, sid in enumerate(ids):
                if i >= s.size:
                    break
                if len(self._pending) >= self._pending_cap:
                    self._pending.pop(next(iter(self._pending)))
                self._pending[sid] = float(s[i])

    def record_outcome(self, ids, labels):
        """The delayed-label channel: join ground-truth labels with the
        predictions recorded for those ids.  Returns how many joined.
        Online AUC/logloss emit on the next evaluation once
        ``min_labels`` outcomes accumulated."""
        labels = np.asarray(labels, dtype=np.float64).reshape(-1)
        joined = 0
        with self._lock:
            for i, sid in enumerate(ids):
                if i >= labels.size:
                    break
                p = self._pending.pop(sid, None)
                if p is None:
                    continue
                self._outcomes.append((p, float(labels[i])))
                joined += 1
            if len(self._outcomes) > self._outcome_cap:
                del self._outcomes[:len(self._outcomes)
                                   - self._outcome_cap]
        return joined

    # --------------------------------------------------------- evaluation
    def evaluate(self, force=False):
        """Compute per-feature + score divergence over the current
        window, emit ``drift`` (and ``online_quality``) events, update
        gauges and the alert state machine.  Rolling windows: once the
        window reaches ``window_rows`` the counts reset so stale
        traffic cannot mask fresh drift."""
        with self._lock:
            empty = self._win_rows < (1 if force else
                                      min(MIN_EVAL_ROWS,
                                          self.every_rows))
            if empty:
                if not force:
                    return None
                # the window just reset (or nothing was ever observed):
                # no divergence to score, but joined outcomes must
                # still leave their online_quality verdict at close
                outcomes = list(self._outcomes)
                pending = len(self._pending)
        if empty:
            self._emit_quality(outcomes, pending)
            return None
        with self._lock:
            feats = []
            for fs in self._feats:
                if fs.counts.sum() <= 0:
                    continue
                feats.append({
                    "feature": fs.name, "index": fs.index,
                    "psi": round(psi(fs.ref, fs.counts), 4),
                    "ks": round(ks_stat(fs.ref, fs.counts), 4),
                    "bins": _bin_diff_table(fs.ref, fs.counts)})
            score = {}
            for space, (edges, ref_counts) in self._score_ref.items():
                cur = self._score_counts[space]
                if cur.sum() <= 0:
                    continue
                score[space] = {
                    "psi": round(psi(ref_counts, cur), 4),
                    "ks": round(ks_stat(ref_counts, cur), 4),
                    "n": int(cur.sum())}
            anomalies = {fs.name: {"non_finite": fs.non_finite,
                                   "out_of_range": fs.out_of_range}
                         for fs in self._feats
                         if fs.non_finite or fs.out_of_range}
            rows, win_rows = self._rows, self._win_rows
            outcomes = list(self._outcomes)
            pending = len(self._pending)
            if self._win_rows >= self.window_rows:
                for fs in self._feats:
                    fs.counts[:] = 0
                for c in self._score_counts.values():
                    c[:] = 0
                self._win_rows = 0
        feats.sort(key=lambda f: -f["psi"])
        psi_max = feats[0]["psi"] if feats else 0.0
        score_psi = max((s["psi"] for s in score.values()), default=0.0)
        self._m_psi_max.set(psi_max)
        for f in feats[:self.topk]:
            REGISTRY.gauge(
                "lgbm_drift_psi",
                "per-feature PSI vs the training fingerprint at the "
                "last drift evaluation (top-k features only)",
                labels={"feature": f["feature"]}).set(f["psi"])
        for space, s in score.items():
            REGISTRY.gauge(
                "lgbm_drift_score_psi",
                "prediction-score PSI vs the training distribution",
                labels={"space": space}).set(s["psi"])
        transition = self._update_alert(psi_max, score_psi, feats)
        out = {"rows": rows, "window_rows": win_rows,
               "psi_max": psi_max, "score_psi": round(score_psi, 4),
               "alert": "firing" if self.alerting else "clear"}
        self._last_psi = {f["feature"]: f["psi"]
                          for f in feats[:self.topk]}
        self._last_eval_out = out
        obs = self.observer
        if obs.enabled:
            obs.event("drift", rows=rows, window_rows=win_rows,
                      psi_max=psi_max, score_psi=round(score_psi, 4),
                      features=feats[:self.topk], score=score,
                      anomalies=anomalies,
                      threshold=self.psi_threshold,
                      alert=out["alert"])
        if transition is not None:
            self._emit_alert(transition, psi_max, score_psi, feats)
        self._emit_quality(outcomes, pending)
        return out

    def _update_alert(self, psi_max, score_psi, feats):
        # Feature PSI drives the alert.  The score reference is the
        # *in-sample* training-score distribution: an overfit model
        # concentrates train scores near the extremes, so out-of-sample
        # serving scores legitimately diverge from it even on i.i.d.
        # traffic — alerting on that would page on every well-fit
        # model.  Score PSI is still reported (events, gauges, the
        # ``obs drift`` table) and takes over as the alert signal only
        # when the fingerprint carries no feature references.
        worst = psi_max if self._feats else score_psi
        if not self.alerting and worst >= self.psi_threshold:
            self.alerting = True
            self.alerts_fired += 1
            self._m_alerts.inc()
            return "firing"
        # hysteresis: clear at half-threshold so a distribution
        # hovering at the line doesn't flap the pager
        if self.alerting and worst < 0.5 * self.psi_threshold:
            self.alerting = False
            self.alerts_cleared += 1
            return "cleared"
        return None

    def _emit_alert(self, transition, psi_max, score_psi, feats):
        top = feats[0] if feats else None
        signal = psi_max if feats else score_psi
        detail = {"psi_max": psi_max,
                  "score_psi": round(score_psi, 4),
                  "threshold": self.psi_threshold,
                  "top_feature": top["feature"] if top else None,
                  "cleared": transition == "cleared"}
        if transition == "firing":
            Log.warning(
                "drift: alert FIRING — PSI %.3f >= %.3f vs the "
                "training fingerprint (top feature %s); the model is "
                "scoring traffic it was not trained on — retrain-now "
                "signal", signal, self.psi_threshold,
                top["feature"] if top else "score distribution")
        else:
            Log.warning("drift: alert cleared (PSI %.3f)", signal)
        if self.mode == "off":
            return
        obs = self.observer
        if not obs.enabled:
            return
        from .health import _WARN_ONLY
        status = ("warn" if (self.mode == "warn"
                             or "drift" in _WARN_ONLY) else "fatal")
        if transition == "cleared":
            status = "ok"
        obs.event("health", check="drift", status=status, it=-1,
                  detail=detail)
        obs.flush()

    def _emit_quality(self, outcomes, pending):
        """Rolling online quality from the joined (prediction, label)
        pairs, compared against the training-time eval reference."""
        if len(outcomes) < self.min_labels:
            return
        probs = np.asarray([p for p, _ in outcomes])
        labels = np.asarray([y for _, y in outcomes])
        auc = _auc(probs, labels)
        ll = _logloss(probs, labels)
        ref_auc = ref_ll = None
        for r in self._ref_eval:
            name = str(r.get("metric", "")).lower()
            if ref_auc is None and "auc" in name:
                ref_auc = float(r["value"])
            if ref_ll is None and "logloss" in name:
                ref_ll = float(r["value"])
        rec = {"n": len(outcomes), "logloss": round(ll, 6),
               "pending": pending}
        if auc is not None:
            rec["auc"] = round(auc, 6)
            REGISTRY.gauge(
                "lgbm_online_auc",
                "rolling online AUC from delayed-label outcomes").set(
                    round(auc, 6))
        REGISTRY.gauge(
            "lgbm_online_logloss",
            "rolling online logloss from delayed-label outcomes").set(
                round(ll, 6))
        if ref_auc is not None:
            rec["ref_auc"] = ref_auc
        if ref_ll is not None:
            rec["ref_logloss"] = ref_ll
        self._last_quality = rec
        obs = self.observer
        if obs.enabled:
            obs.event("online_quality", **rec)

    # ------------------------------------------------------------ reading
    def summary(self):
        return {"rows": self._rows, "alerting": self.alerting,
                "alerts_fired": self.alerts_fired,
                "alerts_cleared": self.alerts_cleared,
                "features": len(self._feats),
                "threshold": self.psi_threshold}

    def headline(self):
        """Live one-dict drift digest for /statusz (registered as a
        flight provider by ServingPredictor)."""
        out = self.summary()
        if self._last_eval_out is not None:
            out["last"] = dict(self._last_eval_out)
        if self._last_psi:
            out["psi"] = dict(self._last_psi)
        if self._last_quality is not None:
            out["online"] = dict(self._last_quality)
        return out

    def close(self):
        """Final forced evaluation so a short-lived server still leaves
        its drift verdict on the timeline."""
        try:
            self.evaluate(force=True)
        except Exception as e:     # forensics must never break close
            Log.warning("drift: final evaluation failed: %s", e)


# ======================================================================
# reader side: timeline -> drift report (obs drift)
# ======================================================================

def drift_metrics(events):
    """Fold a timeline's drift / online_quality events into one dict."""
    drifts = [e for e in events if e.get("ev") == "drift"]
    quality = [e for e in events if e.get("ev") == "online_quality"]
    alerts = [e for e in events if e.get("ev") == "health"
              and e.get("check") == "drift"]
    out = {"present": bool(drifts or quality)}
    if not out["present"]:
        return out
    if drifts:
        out["last"] = drifts[-1]
        out["evals"] = len(drifts)
        out["psi_max"] = max(float(e.get("psi_max", 0.0))
                             for e in drifts)
    if quality:
        out["quality"] = quality[-1]
    fired = [a for a in alerts if a.get("status") != "ok"]
    out["alerts"] = {"fired": len(fired),
                     "cleared": len(alerts) - len(fired),
                     "active": bool(alerts)
                     and alerts[-1].get("status") != "ok"}
    return out


def drift_headline(events):
    """One-line drift digest for ``obs summary``."""
    m = drift_metrics(events)
    if not m.get("present"):
        return None
    head = {"evals": m.get("evals", 0),
            "psi_max": m.get("psi_max"),
            "alerts_fired": m["alerts"]["fired"]}
    q = m.get("quality")
    if q:
        head["online_auc"] = q.get("auc")
    return head


def render_drift_report(events, out=None, check=False):
    """Print the drift report; returns the list of problems (empty =
    no drift).  ``--check`` semantics: a timeline with no drift events
    is a problem too — a gate that silently skipped monitoring must
    not pass as 'no drift'."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    m = drift_metrics(events)
    problems = []
    w("== drift report ==")
    if not m.get("present"):
        w("no drift events in this timeline (enable obs_drift_every "
          "on a fingerprinted model)")
        problems.append("no drift events in timeline")
        return problems
    last = m.get("last") or {}
    w("evaluations %d   rows %s   window %s   psi_max %.4f   alert %s"
      % (m.get("evals", 0), last.get("rows", "-"),
         last.get("window_rows", "-"),
         float(m.get("psi_max", 0.0)), last.get("alert", "-")))
    feats = last.get("features") or []
    if feats:
        w("")
        w("features by divergence (last evaluation, PSI threshold %g):"
          % last.get("threshold", DEFAULT_PSI_THRESHOLD))
        w("  %-24s %8s %8s  %s" % ("feature", "psi", "ks",
                                   "train-vs-serve bins (ref%->cur%)"))
        for f in feats:
            bins = "  ".join(
                "b%d %.1f->%.1f" % (b["bin"], 100 * b["ref"],
                                    100 * b["cur"])
                for b in (f.get("bins") or ()))
            w("  %-24s %8.4f %8.4f  %s"
              % (str(f.get("feature"))[:24], float(f.get("psi", 0.0)),
                 float(f.get("ks", 0.0)), bins))
    score = last.get("score") or {}
    for space in sorted(score):
        s = score[space]
        w("  score[%s]: psi %.4f  ks %.4f  n %d"
          % (space, float(s.get("psi", 0.0)), float(s.get("ks", 0.0)),
             int(s.get("n", 0))))
    anomalies = last.get("anomalies") or {}
    if anomalies:
        w("")
        w("input anomalies (lgbm_serve_input_anomalies_total):")
        for name in sorted(anomalies):
            a = anomalies[name]
            w("  %-24s non_finite %d  out_of_range %d"
              % (name[:24], int(a.get("non_finite", 0)),
                 int(a.get("out_of_range", 0))))
    q = m.get("quality")
    w("")
    if q:
        ref = "".join(filter(None, [
            ("  (train auc %.4f)" % q["ref_auc"])
            if q.get("ref_auc") is not None else "",
            ("  (train logloss %.4f)" % q["ref_logloss"])
            if q.get("ref_logloss") is not None else ""]))
        w("online quality: n %d  auc %s  logloss %s%s"
          % (int(q.get("n", 0)),
             "-" if q.get("auc") is None else "%.4f" % q["auc"],
             "-" if q.get("logloss") is None else "%.4f" % q["logloss"],
             ref))
    else:
        w("online quality: no outcomes recorded "
          "(ServingPredictor.record_outcome)")
    a = m["alerts"]
    w("drift alerts: %d fired, %d cleared%s"
      % (a["fired"], a["cleared"], "  [ACTIVE]" if a["active"] else ""))
    if a["fired"]:
        problems.append("%d drift alert(s) fired" % a["fired"])
    w("")
    if problems:
        w("verdict: %s — %s" % ("FAIL" if check else "DRIFTING",
                                "; ".join(problems)))
    else:
        w("verdict: %s" % ("PASS" if check else "stable"))
    return problems
