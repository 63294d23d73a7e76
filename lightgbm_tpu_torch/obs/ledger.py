"""Cross-run performance ledger: persistent run history + noise-aware
rolling baselines + regression attribution.

The port's copy of the JAX package's ``obs/ledger.py`` (pure stdlib):
the same record format and directory layout, so a ledger written by
either package reads in the other.  A record's device kind is the run
header's card name with spaces as ``_`` (the key obs/roofline.py
``device_kind`` gives the card).

Every tool so far was per-run: ``tools/bench_compare.py`` gates one
candidate against one hand-picked parent, and the flagship trajectory
lived as hand-curated ``BENCH_r0*.json`` files.  The ledger makes the
history durable and statistically usable — the discipline 1809.04559
frames as the hard part of GBDT perf work applied *across* runs:

* **Ingest** — a finished timeline (or its in-memory event list) is
  reduced to one run record: the ``run_header`` context + provenance
  (git rev / dirty / host / argv, schema 10), the headline metrics
  ``bench_compare`` gates (iters/sec, compile_s, recompiles, serve
  QPS/p99/shed, autotune overhead, construct_s, final eval), and the
  run outcome.  Records are keyed by (suite, shape bucket, device
  kind) — the comparability cell — plus schema + git rev for
  attribution.
* **Store** — a ledger directory holds an append-only ``index.jsonl``
  (one line per run; a crash mid-append costs at most the trailing
  partial line, which readers skip) and a full per-run record under
  ``runs/`` written with the same tmp + ``os.replace`` idiom as
  ``autotune_cache.json``.  Readers rebuild index-lost runs from
  ``runs/`` — a corrupted index line never loses history.
* **Rolling baselines** — per (cell, metric): median/MAD over the last
  N clean comparable runs with a noise floor, exposed to
  ``tools/bench_compare.py --baseline rolling`` as z-score gates that
  replace the single-parent tolerance.
* **Trends & attribution** — ``python -m lightgbm_tpu_torch obs history`` /
  ``obs trend [--check]`` render per-metric trend tables with
  sparklines and flag change-points: the first run where a metric
  shifted beyond the noise band, blamed on that run's recorded git
  rev.  ``--check`` exits nonzero when the CURRENT regime of a gated
  metric began with a bad-direction shift — the CI gate.

Ingestion is idempotent (dedup on run id + header timestamp): bench
retries and re-runs of a backfill are no-ops.  Every writer is
best-effort — the ledger must never take a finished run down.
"""
from __future__ import annotations

import json
import os
import time

from ..utils.log import Log

LEDGER_REV = 1
INDEX_NAME = "index.jsonl"
RUNS_DIR = "runs"

# metric -> +1 higher-is-better / -1 lower-is-better.  Matches
# tools/bench_compare.py METRICS (the gated set) plus the backfill-only
# series (vs_baseline, multichip_ok).  Metrics absent here are rendered
# in trends but never fail `obs trend --check` — a direction the tool
# would have to guess is not a gate.
METRIC_DIRECTIONS = {
    "iters_per_sec": +1,
    "compile_s": -1,
    "peak_mem_bytes": -1,
    "recompile_count": -1,
    "barrier_skew_max_s": -1,
    "final_eval_metric": +1,
    "serve_qps": +1,
    "serve_p99_s": -1,
    "serve_shed_rate": -1,
    "autotune_overhead_s": -1,
    "host_orchestration_s": -1,
    "construct_s": -1,
    "vs_baseline": +1,
    "multichip_ok": +1,
    # schema 12 scaling events (bench.py --mp): per-chip throughput and
    # weak-scaling efficiency — gated per (suite, shape, device,
    # world_size) cell so an N-rank run never regresses against a
    # single-host baseline
    "rows_per_sec_per_chip": +1,
    "weak_scaling_eff": +1,
    # schema 13 utilization rollups (obs/roofline.py): exec-weighted
    # achieved/peak fractions — a drop means a kernel moved AWAY from
    # its roof, the regression class the roofline layer exists to catch
    "flop_util": +1,
    "hbm_util": +1,
    # schema 14 drift monitoring (obs/drift.py): the worst per-feature
    # PSI vs the training fingerprint and the rolling online quality —
    # `obs trend` attributes drift onset to the window whose cell
    # first shifted
    "drift_psi_max": -1,
    "online_auc": +1,
    "online_logloss": -1,
    # schema 15 incident engine (obs/incident.py): a commit that starts
    # tripping incidents — or whose incidents correlate MORE signals —
    # is a change-point the existing attribution machinery blames on
    # the git rev that introduced it
    "incidents_opened": -1,
    "incident_max_signals": -1,
    # schema 16 host profiler (obs/prof.py): the sampler's self-measured
    # cost as a fraction of profiled wall time — a commit that makes
    # sampling more expensive (deeper stacks, more threads) drifts this
    # cell up, and `obs trend --check` catches it before the 1% budget
    # gate in bench.py --dry ever trips
    "prof_overhead_frac": -1,
}

# noise floors under the MAD estimate: a flat history has MAD 0, and a
# z-score against sigma 0 would flag float jitter as a regression.  The
# 1% relative floor says "identical history still tolerates 1% noise
# per sigma" — a 3-sigma gate on flat history fires at a 3% shift.
MAD_SIGMA = 1.4826          # MAD -> sigma for a normal distribution
REL_NOISE_FLOOR = 0.01
ABS_NOISE_FLOOR = 1e-9


def default_ledger_dir():
    """Ledger location: ``LGBM_TPU_LEDGER`` env (the JAX package's
    variable: one ledger serves both), else ``lgbm_tpu_ledger`` in the
    temporary directory."""
    import tempfile
    return os.environ.get("LGBM_TPU_LEDGER", os.path.join(
        tempfile.gettempdir(), "lgbm_tpu_ledger"))


# ---------------------------------------------------------------- ingest

def metrics_from_events(events):
    """{metric: value} of ONE run's events — the same headline set
    ``tools/bench_compare.py`` gates, derived the same way."""
    out = {}
    iters = [e for e in events if e.get("ev") == "iter"]
    total = sum(float(e.get("time_s", 0.0)) for e in iters)
    if iters and total > 0:
        out["iters_per_sec"] = len(iters) / total
    # schema 11: host glue between device program submissions (mean per
    # iteration) — the series that attributes a fused-iteration win
    orch = [float(e["host_orchestration_s"]) for e in iters
            if "host_orchestration_s" in e]
    if orch:
        out["host_orchestration_s"] = sum(orch) / len(orch)
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)
    entries = (run_end or {}).get("entries") or {}
    if entries:
        out["compile_s"] = sum(st.get("first_s", 0.0)
                               for st in entries.values())
    else:
        compiles = [e for e in events if e.get("ev") == "compile"]
        if compiles:
            out["compile_s"] = sum(float(e.get("first_call_s", 0.0))
                                   for e in compiles)
    peak = 0
    for e in events:
        if e.get("ev") != "memory":
            continue
        for d in e.get("devices", ()):
            peak = max(peak, d.get("peak_bytes_in_use",
                                   d.get("bytes_in_use", 0)))
    if peak:
        out["peak_mem_bytes"] = peak
    attr = [e for e in events if e.get("ev") == "compile_attr"]
    if attr:
        worst = {}
        for e in attr:
            worst[e.get("entry")] = max(worst.get(e.get("entry"), 0),
                                        int(e.get("n_compiles", 1)))
        out["recompile_count"] = sum(n - 1 for n in worst.values())
    skews = [float(e["skew_s"]) for e in events
             if e.get("ev") == "host_collective" and "skew_s" in e]
    if skews:
        out["barrier_skew_max_s"] = max(skews)
    evals = [e for e in events if e.get("ev") == "eval"
             and e.get("results")]
    if evals:
        out["final_eval_metric"] = float(evals[-1]["results"][-1]["value"])
    serve = [e for e in events if e.get("ev") == "serve_bench"]
    if serve:
        out["serve_qps"] = float(serve[-1]["qps"])
        out["serve_p99_s"] = float(serve[-1]["p99_s"])
        if serve[-1].get("shed_rate") is not None:
            out["serve_shed_rate"] = float(serve[-1]["shed_rate"])
    decs = [e for e in events if e.get("ev") == "autotune_decision"]
    if decs:
        out["autotune_overhead_s"] = sum(
            float(e.get("overhead_s", 0.0)) for e in decs)
    cons = [e for e in events if e.get("ev") == "dataset_construct"]
    if cons:
        out["construct_s"] = sum(
            float(e.get("construct_s",
                        e.get("sketch_s", 0.0) + e.get("bin_s", 0.0)
                        + e.get("write_s", 0.0)))
            for e in cons)
    sc = [e for e in events if e.get("ev") == "scaling"]
    if sc:
        out["rows_per_sec_per_chip"] = float(sc[-1]["rows_per_sec_per_chip"])
        out["weak_scaling_eff"] = float(sc[-1]["efficiency"])
    # schema 13: the LAST utilization rollup is the steady-state one
    # (early iterations still amortize compile-time in their means)
    utils = [e for e in events if e.get("ev") == "utilization"]
    if utils and utils[-1].get("flop_util") is not None:
        out["flop_util"] = float(utils[-1]["flop_util"])
        out["hbm_util"] = float(utils[-1].get("hbm_util", 0.0))
    # schema 14: the run's WORST drift evaluation (not the last — a
    # window that drifted and then reset must still mark the run) and
    # the last online-quality rollup
    drifts = [e for e in events if e.get("ev") == "drift"]
    if drifts:
        out["drift_psi_max"] = max(float(e.get("psi_max", 0.0))
                                   for e in drifts)
    quality = [e for e in events if e.get("ev") == "online_quality"]
    if quality:
        if quality[-1].get("auc") is not None:
            out["online_auc"] = float(quality[-1]["auc"])
        if quality[-1].get("logloss") is not None:
            out["online_logloss"] = float(quality[-1]["logloss"])
    # schema 15: prefer the run_end digest — it is present (zeros
    # included) whenever the engine ran, giving incident-free runs a
    # real zero history to change-point against; fall back to counting
    # the events for timelines that aborted before run_end
    inc = (run_end or {}).get("incidents")
    if inc is not None:
        out["incidents_opened"] = int(inc.get("opened", 0) or 0)
        out["incident_max_signals"] = int(inc.get("max_signals", 0) or 0)
    else:
        opens = [e for e in events if e.get("ev") == "incident_open"]
        if opens:
            out["incidents_opened"] = len(opens)
            closes = [e for e in events if e.get("ev") == "incident_close"]
            if closes:
                out["incident_max_signals"] = max(
                    len(e.get("signals") or ()) for e in closes)
    # schema 16: exec-weighted sampling overhead across every profiler
    # window — sum(cost)/sum(duration), not a mean of per-window
    # fractions, so a long cheap window cannot mask a short hot one
    profs = [e for e in events if e.get("ev") == "prof_profile"]
    dur = sum(float(e.get("dur_s", 0.0) or 0.0) for e in profs)
    if dur > 0:
        out["prof_overhead_frac"] = (
            sum(float(e.get("cost_s", 0.0) or 0.0) for e in profs) / dur)
    return out


def _device_kind(header):
    """The run header's device kind, spaces as ``_``: the port's card
    ``NVIDIA_H100_80GB_HBM3`` (obs/roofline.py device_kind)."""
    for d in header.get("devices") or ():
        if isinstance(d, dict) and d.get("kind"):
            return str(d["kind"]).strip().replace(" ", "_")
    return str(header.get("backend", "") or "")


def _shape_bucket(events, header):
    """Shape key of a run when the caller didn't name one: rows x
    features from the construction/profile events, else the request
    count of a serving run, else '-'."""
    cons = next((e for e in events if e.get("ev") == "dataset_construct"),
                None)
    prof = next((e for e in events if e.get("ev") == "data_profile"), None)
    if cons and prof:
        return "%dx%d" % (int(cons.get("rows", 0)),
                          int(prof.get("n_features", 0)))
    if cons:
        return "r%d" % int(cons.get("rows", 0))
    sb = next((e for e in events if e.get("ev") == "serve_bench"), None)
    if sb is not None:
        return "req%d" % int(sb.get("requests", 0))
    return "-"


def record_from_events(events, suite="", shape="", source="",
                       extra_metrics=None):
    """Reduce one run's events to a ledger record, or None when there is
    nothing worth keeping (no metrics at all)."""
    if not events:
        return None
    header = next((e for e in events if e.get("ev") == "run_header"), {})
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)
    prov = header.get("provenance") or {}
    metrics = metrics_from_events(events)
    metrics.update(extra_metrics or {})
    if not metrics:
        return None
    ctx = header.get("context") or {}
    rec = {
        "rev": LEDGER_REV,
        "run": str(events[-1].get("run", "")),
        "t": float(header.get("t", events[0].get("t", 0.0)) or 0.0),
        "suite": str(suite or ctx.get("tool") or ctx.get("suite")
                     or "train"),
        "shape": str(shape or _shape_bucket(events, header)),
        "device_kind": _device_kind(header),
        "backend": str(header.get("backend", "") or ""),
        "schema": header.get("schema"),
        "world_size": int(header.get("world_size", 1) or 1),
        "git_rev": str(prov.get("git_rev", "") or ""),
        "git_dirty": bool(prov.get("git_dirty", False)),
        "host": str(prov.get("hostname", "") or ""),
        "argv": list(prov.get("argv", []))[:8],
        "status": str((run_end or {}).get("status", "unknown")),
        "metrics": metrics,
    }
    if source:
        rec["source"] = str(source)
    return rec


def _dedup_key(rec):
    # run ids are 4 random bytes; the header timestamp breaks the
    # (astronomically unlikely, but free to avoid) cross-run collision
    return "%s-%d" % (rec.get("run", "?"), int(rec.get("t", 0.0)))


class Ledger:
    """One ledger directory: append-only JSONL index + per-run records.

    Writers: ``ingest_events`` / ``ingest_timeline`` / ``ingest_record``
    (all idempotent).  Readers: ``entries()`` — corrupt index lines are
    skipped with a warning and runs missing from the index are recovered
    from ``runs/``."""

    def __init__(self, path):
        self.dir = str(path)
        self.index_path = os.path.join(self.dir, INDEX_NAME)
        self.runs_dir = os.path.join(self.dir, RUNS_DIR)

    # ------------------------------------------------------------- read
    def _index_entries(self):
        entries, bad = [], 0
        try:
            with open(self.index_path) as f:
                lines = f.read().splitlines()
        except OSError:
            return [], 0
        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict) or "metrics" not in rec:
                    raise ValueError("not a ledger record")
            except ValueError:
                bad += 1
                continue
            entries.append(rec)
        return entries, bad

    def entries(self):
        """All run records, oldest first (header time, then ingest
        order).  Survives a torn index: unparseable lines are skipped
        and any run present only under ``runs/`` is recovered."""
        entries, bad = self._index_entries()
        if bad:
            Log.warning("obs ledger: skipped %d corrupt index line(s) in "
                        "%s; recovering from %s/", bad, self.index_path,
                        RUNS_DIR)
        seen = {_dedup_key(r) for r in entries}
        recovered = 0
        if bad or not entries:
            try:
                names = sorted(os.listdir(self.runs_dir))
            except OSError:
                names = []
            for name in names:
                if not name.endswith(".json"):
                    continue
                try:
                    with open(os.path.join(self.runs_dir, name)) as f:
                        rec = json.load(f)
                except (OSError, ValueError):
                    continue
                if isinstance(rec, dict) and "metrics" in rec \
                        and _dedup_key(rec) not in seen:
                    entries.append(rec)
                    seen.add(_dedup_key(rec))
                    recovered += 1
        if recovered:
            Log.warning("obs ledger: recovered %d run(s) from %s/",
                        recovered, RUNS_DIR)
        entries.sort(key=lambda r: (float(r.get("t", 0.0)),
                                    float(r.get("ingested_t", 0.0))))
        return entries

    # ------------------------------------------------------------ write
    def ingest_record(self, rec):
        """Append one record; returns True when it landed, False when an
        identical run is already present (idempotent re-ingest)."""
        if not isinstance(rec, dict) or not rec.get("metrics"):
            return False
        key = _dedup_key(rec)
        existing, _ = self._index_entries()
        if any(_dedup_key(r) == key for r in existing):
            return False
        if os.path.exists(os.path.join(self.runs_dir, key + ".json")):
            return False
        rec = dict(rec, ingested_t=time.time())
        os.makedirs(self.runs_dir, exist_ok=True)
        # full record first (atomic tmp+replace, the autotune-cache
        # idiom), THEN the index line — a crash between the two leaves a
        # recoverable runs/ file, never a dangling index entry
        run_path = os.path.join(self.runs_dir, key + ".json")
        tmp = run_path + ".tmp.%d" % os.getpid()
        with open(tmp, "w") as f:
            json.dump(rec, f, sort_keys=True, default=str)
        os.replace(tmp, run_path)
        with open(self.index_path, "a") as f:
            f.write(json.dumps(rec, sort_keys=True, default=str) + "\n")
            f.flush()
        return True

    def ingest_events(self, events, suite="", shape="", source="",
                      extra_metrics=None):
        """Ingest one run's in-memory event list; returns 1/0."""
        rec = record_from_events(events, suite=suite, shape=shape,
                                 source=source,
                                 extra_metrics=extra_metrics)
        if rec is None:
            return 0
        return int(self.ingest_record(rec))

    def ingest_timeline(self, path, suite="", shape="", source="",
                        extra_metrics=None):
        """Ingest every finished run of a JSONL timeline file; returns
        the number of runs that landed (0 on full re-ingest)."""
        from .events import read_events
        events = read_events(path, validate=False)
        by_run, order = {}, []
        for e in events:
            r = e.get("run")
            if r not in by_run:
                order.append(r)
            by_run.setdefault(r, []).append(e)
        n = 0
        for r in order:
            run_events = by_run[r]
            if not any(e.get("ev") == "run_end" for e in run_events):
                continue        # unfinished run: not history yet
            n += self.ingest_events(run_events, suite=suite, shape=shape,
                                    source=source or path,
                                    extra_metrics=extra_metrics)
        return n


# ----------------------------------------------------- rolling statistics

def _median(vals):
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def rolling_stats(values, window):
    """median / MAD / noise-floored sigma over the last ``window``
    values, or None when empty."""
    vals = [float(v) for v in values][-max(1, int(window)):]
    if not vals:
        return None
    med = _median(vals)
    mad = _median([abs(v - med) for v in vals])
    sigma = max(MAD_SIGMA * mad, REL_NOISE_FLOOR * abs(med),
                ABS_NOISE_FLOOR)
    return {"n": len(vals), "median": med, "mad": mad, "sigma": sigma}


def comparable_entries(entries, suite=None, shape=None, device_kind=None,
                       metric=None, status="ok", exclude_runs=(),
                       world_size=None):
    """The entries a candidate may be compared against: same suite /
    shape / device kind / world size (when given), clean outcome, metric
    present.  world_size is part of a run's shape identity: an N-rank
    run's per-chip throughput must never gate against single-host
    baselines (weak scaling is expected to be < 1.0)."""
    out = []
    for r in entries:
        if status and r.get("status") != status:
            continue
        if suite and r.get("suite") != suite:
            continue
        if shape and r.get("shape") != shape:
            continue
        if device_kind and r.get("device_kind") != device_kind:
            continue
        if world_size is not None and \
                int(r.get("world_size", 1) or 1) != int(world_size):
            continue
        if metric and metric not in (r.get("metrics") or {}):
            continue
        if r.get("run") in exclude_runs:
            continue
        out.append(r)
    return out


def rolling_baseline(entries, metric, window=8):
    """Rolling stats of one metric over already-filtered entries."""
    vals = [r["metrics"][metric] for r in entries
            if metric in (r.get("metrics") or {})]
    if not vals:
        return None
    return rolling_stats(vals, window)


def change_points(entries, metric, window=8, z_threshold=3.0,
                  min_history=3):
    """Change-points of one metric series: each is the FIRST run whose
    value left the noise band of the regime before it (|z| >= threshold
    against the rolling median/MAD of the current regime), attributed to
    that run's recorded git rev.  Detection restarts after each shift,
    so a step is flagged once, not once per following run."""
    series = [(r, float(r["metrics"][metric])) for r in entries
              if metric in (r.get("metrics") or {})]
    cps = []
    regime_start = 0
    for i in range(len(series)):
        hist = [v for _, v in series[regime_start:i]]
        if len(hist) < max(1, int(min_history)):
            continue
        st = rolling_stats(hist, window)
        rec, val = series[i]
        z = (val - st["median"]) / st["sigma"]
        if abs(z) < float(z_threshold):
            continue
        direction = METRIC_DIRECTIONS.get(metric, 0)
        cps.append({
            "metric": metric, "index": i, "run": rec.get("run", "?"),
            "t": rec.get("t", 0.0), "git_rev": rec.get("git_rev", ""),
            "git_dirty": rec.get("git_dirty", False),
            "suite": rec.get("suite", ""), "shape": rec.get("shape", ""),
            "device_kind": rec.get("device_kind", ""),
            "baseline": st["median"], "value": val, "z": z,
            "regression": bool(direction) and (direction * z < 0),
        })
        regime_start = i
    return cps


# ------------------------------------------------------------- rendering

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values, width=16):
    """Unicode sparkline of the last ``width`` values."""
    vals = [float(v) for v in values][-max(1, int(width)):]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo <= 0:
        return _SPARK[3] * len(vals)
    scale = (len(_SPARK) - 1) / (hi - lo)
    return "".join(_SPARK[int(round((v - lo) * scale))] for v in vals)


def _fmt_t(t):
    t = float(t or 0.0)
    if t < 1e9:                 # backfilled rounds carry synthetic times
        return "      r%03d" % int(t) if 0 < t < 1000 else "         -"
    return time.strftime("%m-%d %H:%M", time.localtime(t))


def _fmt_rev(rec):
    rev = str(rec.get("git_rev", "") or "")[:12]
    if not rev:
        return "-"
    return rev + ("+" if rec.get("git_dirty") else "")


def _cells(entries):
    """{(suite, shape, device_kind, world_size): [entries]} in
    first-seen order.  world_size joined the cell key with schema 12: a
    2-rank run and a 1-rank run of the same shape are different
    performance regimes, and `obs trend --check` must never gate one
    against the other's history."""
    out = {}
    for r in entries:
        key = (r.get("suite", ""), r.get("shape", ""),
               r.get("device_kind", ""),
               int(r.get("world_size", 1) or 1))
        out.setdefault(key, []).append(r)
    return out


def render_history(entries, out=None, limit=20, suite=None, metric=None):
    """`obs history`: one line per run, newest last."""
    import sys
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    if suite:
        entries = [r for r in entries if r.get("suite") == suite]
    if metric:
        entries = [r for r in entries
                   if metric in (r.get("metrics") or {})]
    if not entries:
        w("ledger is empty (no matching runs)")
        return
    total = len(entries)
    entries = entries[-max(1, int(limit)):]
    w("%-11s %-12s %-14s %-10s %-13s %-7s %s"
      % ("when", "suite", "shape", "device", "git rev", "status",
         "metrics"))
    for r in entries:
        m = r.get("metrics") or {}
        shown = [metric] if metric else sorted(
            m, key=lambda k: (k not in METRIC_DIRECTIONS, k))[:3]
        mtxt = "  ".join("%s=%.6g" % (k, float(m[k])) for k in shown
                         if k in m)
        w("%-11s %-12s %-14s %-10s %-13s %-7s %s"
          % (_fmt_t(r.get("t")), str(r.get("suite", ""))[:12],
             str(r.get("shape", ""))[:14],
             str(r.get("device_kind", ""))[:10], _fmt_rev(r),
             str(r.get("status", "?"))[:7], mtxt))
    if total > len(entries):
        w("(%d older run(s) not shown; -n %d to widen)"
          % (total - len(entries), total))


def render_trend(entries, out=None, suite=None, metric=None, window=8,
                 z_threshold=3.0, min_history=3):
    """`obs trend`: per-cell per-metric trend table with sparklines and
    change-point attribution.  Returns the list of ACTIVE regressions —
    gated metrics whose current regime began with a bad-direction shift
    (the `--check` failure set)."""
    import sys
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    if suite:
        entries = [r for r in entries if r.get("suite") == suite]
    active = []
    wrote = False
    for (csuite, cshape, ckind, cworld), cell in _cells(entries).items():
        metrics = sorted({k for r in cell
                          for k in (r.get("metrics") or {})},
                        key=lambda k: (k not in METRIC_DIRECTIONS, k))
        if metric:
            metrics = [m for m in metrics if m == metric]
        clean = [r for r in cell if r.get("status") == "ok"]
        header_done = False
        for m in metrics:
            vals = [r["metrics"][m] for r in clean
                    if m in (r.get("metrics") or {})]
            if not vals:
                continue
            if not header_done:
                w("%s%s / %s / %s%s  (%d run(s), %d clean)"
                  % ("" if not wrote else "\n", csuite, cshape,
                     ckind or "-",
                     " / %d-rank" % cworld if cworld > 1 else "",
                     len(cell), len(clean)))
                w("  %-20s %4s %12s %12s %-16s  %s"
                  % ("metric", "n", "median", "last", "trend",
                     "change-points"))
                header_done = True
                wrote = True
            st = rolling_stats(vals, max(window, len(vals)))
            cps = change_points(clean, m, window=window,
                                z_threshold=z_threshold,
                                min_history=min_history)
            notes = []
            for cp in cps:
                notes.append("%s%+.1f%% at %s (%s)"
                             % ("REGRESSED " if cp["regression"] else "",
                                100.0 * (cp["value"] - cp["baseline"])
                                / (abs(cp["baseline"]) or 1.0),
                                _fmt_t(cp["t"]).strip(),
                                (cp["git_rev"] or cp["run"] or "?")))
            if cps and cps[-1]["regression"]:
                active.append(cps[-1])
            w("  %-20s %4d %12.6g %12.6g %-16s  %s"
              % (m, len(vals), st["median"], vals[-1], sparkline(vals),
                 "; ".join(notes) or "-"))
    if not wrote:
        w("ledger is empty (no matching runs)")
    if active:
        w()
        for cp in active:
            w("REGRESSION: %s %+.1f%% (z=%+.1f) in %s/%s since %s, "
              "introduced by rev %s (run %s)"
              % (cp["metric"],
                 100.0 * (cp["value"] - cp["baseline"])
                 / (abs(cp["baseline"]) or 1.0), cp["z"],
                 cp["suite"], cp["shape"], _fmt_t(cp["t"]).strip(),
                 cp["git_rev"] or "unknown", cp["run"]))
    return active
