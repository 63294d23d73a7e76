"""Timeline queries and ``python -m lightgbm_tpu_torch obs``.

The port's copy of the JAX package's ``obs/query.py`` (which imports no
jax), cut to its training reports: one reader loads and validates a
JSONL timeline, groups it into runs, reduces a run to its headline
metrics and renders the subcommands:

* ``summary RUN.jsonl``   -- headline table of the last run (iterations,
  phases, entry timers, memory, health, the autotuner's decision);
* ``explain RUN.jsonl``   -- the model, data and tuning report: data-
  quality findings, top-feature evolution, split-audit gain margins,
  convergence, and every autotune decision with its probed cells, their
  seconds and roofline positions; ``--check`` exits 1 on an
  error-severity data finding;
* ``diff A.jsonl B.jsonl`` -- two timelines' headline metrics side by
  side;
* ``trace RUN.jsonl -o t.json`` -- a Chrome/Perfetto trace rebuilt from
  the phase laps.

* ``recompiles RUN.jsonl [--check]`` -- every compile_attr event (a
  graph capture or the kernels' first build) with what changed; --check
  exits 1 when an entry compiled a signature it had already compiled;
* ``roofline RUN.jsonl [--check]`` -- achieved against peak per timed
  entry, ranked by headroom (obs/roofline.py);
* ``serve RUN.jsonl [--check]`` -- the serving report (obs/serve.py);
  ``summary`` carries its headline;
* ``drift RUN.jsonl [--check]`` -- drift and online quality
  (obs/drift.py);
* ``incident DIR|RUN.jsonl [--check]`` -- incident triage
  (obs/incident.py);
* ``watch FILE|URL`` -- live-follow a timeline or a live plane
  (obs/live.py);
* ``prof RUN.jsonl|DIR [--check]`` -- the host sampling profile
  (obs/prof.py);
* ``history`` / ``trend [--check]`` -- the cross-run ledger
  (obs/ledger.py).

* ``stragglers RUN.jsonl`` -- the per-rank arrival skew samples
  (obs/straggler.py);
* ``merge RUN.jsonl [-o M.jsonl]`` -- the per-rank shards of a
  distributed run lined up on iterations and host-collective ``seq``
  (obs/merge.py): barrier skew a collective, per-rank phase totals, the
  slowest-rank attribution, and the merged critical-path timeline.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from .events import read_events

def load_timeline(path, validate=True):
    """Parse and (non-strictly) validate a JSONL timeline."""
    return read_events(path, validate=validate)


def runs(events):
    """{run_id: [events]} in first-appearance order (cv folds share one
    file)."""
    out = {}
    for e in events:
        out.setdefault(e.get("run"), []).append(e)
    return out


def last_run(events):
    """Events of the run the file's final record belongs to."""
    if not events:
        return []
    run = events[-1].get("run")
    return [e for e in events if e.get("run") == run]


def recompile_count(events):
    """Compiles beyond the first, per entry, summed (compile_attr events
    of a JAX package timeline)."""
    worst = {}
    for e in events:
        if e.get("ev") == "compile_attr":
            worst[e.get("entry")] = max(worst.get(e.get("entry"), 0),
                                        int(e.get("n_compiles", 1)))
    return sum(n - 1 for n in worst.values())


def recompile_rows(events):
    """Flat view of the ``compile_attr`` events of one run."""
    rows = []
    for e in events:
        if e.get("ev") != "compile_attr":
            continue
        rows.append({"entry": e.get("entry"),
                     "n_compiles": int(e.get("n_compiles", 1)),
                     "sig_compiles": int(e.get("sig_compiles", 1)),
                     "sig": e.get("sig", {}),
                     "diff": e.get("diff", []),
                     "cost": e.get("cost", {}),
                     "memory": e.get("memory", {}),
                     "t": e.get("t")})
    return rows


def straggler_rows(events):
    return [e for e in events if e.get("ev") == "straggler"]


def timeline_metrics(events):
    """Headline metrics of ONE run's events (use last_run() first)."""
    out = {}
    if not events:
        return out
    out["run"] = events[-1].get("run")
    header = next((e for e in events if e.get("ev") == "run_header"), None)
    if header:
        out["backend"] = header.get("backend")
        out["schema"] = header.get("schema")
        out["devices"] = len(header.get("devices", []))
        out["timing"] = header.get("timing")
        if "world_size" in header:
            out["rank"] = header.get("rank")
            out["world_size"] = header.get("world_size")
        if header.get("merged"):
            out["merged"] = True
    iters = [e for e in events if e.get("ev") == "iter"]
    total = sum(e["time_s"] for e in iters)
    out["iters"] = len(iters)
    out["total_s"] = total
    if iters and total > 0:
        out["iters_per_sec"] = len(iters) / total
    phase_totals = {}
    for e in iters:
        for k, v in e.get("phases", {}).items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v
    out["phase_totals"] = phase_totals
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)
    entries = (run_end or {}).get("entries") or {}
    if entries:
        out["compile_s"] = sum(st.get("first_s", 0.0)
                               for st in entries.values())
    else:
        compiles = [e for e in events if e.get("ev") == "compile"]
        if compiles:
            out["compile_s"] = sum(e["first_call_s"] for e in compiles)
    out["entries"] = entries
    if any(e.get("ev") == "compile_attr" for e in events):
        out["recompile_count"] = recompile_count(events)
    peak = 0
    for e in events:
        if e.get("ev") != "memory":
            continue
        for d in e.get("devices", ()):
            peak = max(peak, d.get("peak_bytes_in_use",
                                   d.get("bytes_in_use", 0)))
    if peak:
        out["peak_mem_bytes"] = peak
    health = [e for e in events if e.get("ev") == "health"]
    if health:
        counts = {}
        for e in health:
            counts[e.get("status")] = counts.get(e.get("status"), 0) + 1
        out["health"] = counts
    stragglers = straggler_rows(events)
    if stragglers:
        out["straggler_samples"] = len(stragglers)
        out["straggler_max_skew"] = max(e.get("skew", 0.0)
                                        for e in stragglers)
    colls = [e for e in events if e.get("ev") == "host_collective"]
    if colls:
        out["host_collectives"] = len(colls)
        skews = [e["skew_s"] for e in colls if "skew_s" in e]
        if skews:
            out["barrier_skew_max_s"] = max(skews)
    if run_end:
        out["status"] = run_end.get("status", "ok")
        if "stragglers" in run_end:
            out["stragglers"] = run_end["stragglers"]
        if "rank_report" in run_end:
            out["rank_report"] = run_end["rank_report"]
    else:
        # no run_end yet: a live run being tailed, not (necessarily) a
        # crash -- report in-progress with the last event's age instead
        # of implying the run died (obs/live.py watch reads the same
        # growing file)
        out["status"] = "in_progress"
        out["in_progress"] = True
        last_t = max((float(e.get("t", 0.0)) for e in events),
                     default=0.0)
        if last_t:
            out["last_event_age_s"] = max(0.0, time.time() - last_t)
    # serving timelines (bench_serve.py / ServingPredictor): fold the
    # serve_* events into a headline so `obs summary` has a serving
    # section instead of a zero-iteration shrug
    if any(str(e.get("ev", "")).startswith("serve_") for e in events):
        from .serve import serve_headline
        head = serve_headline(events)
        if head:
            out["serve"] = head
    return out


# ------------------------------------------------------------- rendering

def render_summary(events, out=None):
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    m = timeline_metrics(events)
    if not m:
        w("empty timeline")
        return
    w("run %s  schema %s  backend %s  devices %s  timing %s  status %s"
      % (m.get("run"), m.get("schema", "?"), m.get("backend", "?"),
         m.get("devices", "?"), m.get("timing", "?"),
         m.get("status", "?")))
    if m.get("in_progress"):
        age = m.get("last_event_age_s")
        w("run in progress (last event %ss ago) -- no run_end yet; "
          "follow it live with `obs watch`"
          % ("%.1f" % age if age is not None else "?"))
    if m.get("merged"):
        w("merged view of a %s-rank run" % m.get("world_size", "?"))
    elif m.get("world_size", 1) and int(m.get("world_size", 1) or 1) > 1:
        w("rank %s of %s  (coordinator-sharded timeline)"
          % (m.get("rank", "?"), m.get("world_size")))
        w("WARNING: this is ONE shard of a multi-rank run -- totals and "
          "skew below are rank-local; run `python -m lightgbm_tpu_torch "
          "obs merge <shard>` for the cross-rank view")
    ips = (" (%.3f iters/sec)" % m["iters_per_sec"]
           if "iters_per_sec" in m else "")
    if m["iters"] or "serve" not in m:
        w("iters %d  total %.3f s%s" % (m["iters"], m["total_s"], ips))
    sv = m.get("serve")
    if sv:
        eff = ("  efficiency %.1f%%" % (100.0 * sv["batch_efficiency"])
               if sv.get("batch_efficiency") is not None else "")
        approx = " (sampled, lower bound)" if sv.get("sampled") else ""
        w("serving: %d batches  %d rows%s%s"
          % (sv["batches"], sv["rows"], eff, approx))
        bits = []
        if sv.get("qps") is not None:
            bits.append("qps %s" % sv["qps"])
        if sv.get("p99_s") is not None:
            bits.append("p99 %.2f ms" % (1e3 * sv["p99_s"]))
        bits.append("shed %d" % sv["shed_total"])
        bits.append("burn alerts %d" % sv["alerts_fired"])
        w("serving: " + "  ".join(bits)
          + "  (obs serve for the full report)")
    totals = m.get("phase_totals") or {}
    tot = sum(totals.values())
    if totals and tot > 0:
        w("phases: " + "  ".join(
            "%s %.1f%%" % (k, 100.0 * v / tot)
            for k, v in sorted(totals.items(), key=lambda kv: -kv[1])))
    for name, st in sorted((m.get("entries") or {}).items()):
        w("entry %s: first %.3f s, exec %.4f s x %d"
          % (name, st.get("first_s", 0.0), st.get("exec_mean_s", 0.0),
             st.get("exec_n", 0)))
    if "recompile_count" in m:
        w("recompiles: %d beyond first compile (obs recompiles for the "
          "per-event diffs)" % m["recompile_count"])
    if "straggler_samples" in m:
        w("stragglers: %d samples, max skew %.1f%%"
          % (m["straggler_samples"], 100.0 * m["straggler_max_skew"]))
    if "host_collectives" in m:
        skew = ("  max barrier skew %.6f s" % m["barrier_skew_max_s"]
                if "barrier_skew_max_s" in m else "")
        w("host collectives: %d%s" % (m["host_collectives"], skew))
    if "peak_mem_bytes" in m:
        w("peak device memory: %.1f MiB" % (m["peak_mem_bytes"] / 2**20))
    if "health" in m:
        w("health: " + "  ".join("%s=%d" % kv
                                 for kv in sorted(m["health"].items())))
    decs = [e for e in events if e.get("ev") == "autotune_decision"]
    if decs:
        e = decs[-1]
        c = e.get("cell") or {}
        w("autotune: %s/%s  cell %s W=%s %s%s  (obs explain for probe "
          "timings)"
          % (e.get("mode", "?"), e.get("source", "?"),
             c.get("hist_mode", "?"), c.get("wave_width", "?"),
             "hilo" if c.get("hist_hilo", True) else "bf16",
             " compact" if c.get("compact") else ""))


def render_stragglers(events, out=None):
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    rows = straggler_rows(events)
    if not rows:
        w("no straggler events (run a distributed learner with "
          "obs_straggler_every=N)")
        return
    w("%6s %7s %8s  %s" % ("iter", "skew", "slowest", "per-rank wait_s"))
    for e in rows:
        waits = "  ".join("%s:%.4f" % (d["id"], d["wait_s"])
                          for d in e.get("devices", []))
        w("%6d %6.1f%% %8s  %s" % (e["it"], 100.0 * e.get("skew", 0.0),
                                   e.get("slowest", "?"), waits))
    run_end = next((e for e in events if e.get("ev") == "run_end"), None)
    summ = (run_end or {}).get("stragglers")
    if summ:
        w("summary: %d samples, max skew %.1f%% at iter %s, slowest "
          "counts %s" % (summ.get("samples", 0),
                         100.0 * summ.get("max_skew", 0.0),
                         summ.get("max_skew_it", "?"),
                         summ.get("slowest_counts", {})))


def render_recompiles(events, out=None):
    """Every compile_attr event; True iff any same-signature recompile
    (graph re-capture thrash) is present — the --check failure condition."""
    from .compile import format_diff
    from .roofline import fmt_bytes, fmt_quantity
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    rows = recompile_rows(events)
    if not rows:
        w("no compile_attr events (run with obs_compile=true)")
        return False
    w("%-14s %4s %5s  %s" % ("entry", "n", "sig#", "what changed"))
    thrash = False
    for r in rows:
        why = "; ".join(format_diff(d) for d in r["diff"]) \
            or "first compile"
        cost = r["cost"] or {}
        tags = []
        if cost.get("flops") is not None:
            tags.append(fmt_quantity(cost["flops"], "FLOP"))
        if cost.get("bytes_accessed") is not None:
            tags.append(fmt_bytes(cost["bytes_accessed"]))
        if tags:
            why += "  [%s]" % ", ".join(tags)
        w("%-14s %4d %5d  %s" % (r["entry"], r["n_compiles"],
                                 r["sig_compiles"], why))
        if r["sig_compiles"] > 1:
            thrash = True
    n = recompile_count(events)
    w("total: %d compile(s) beyond first per entry" % n)
    if thrash:
        w("THRASH: an entry recompiled a signature it had already "
          "compiled")
    return thrash


def render_explain(events, out=None, topk=10):
    """Model & data-quality report of one run (the ``obs explain``
    subcommand).  Returns True iff the data profile carries an
    error-severity finding -- the --check failure condition."""
    from .model import audit_margin_stats, importance_history
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    has_error = False
    wrote = False

    # ------------------------------------------------------- data quality
    for e in (ev for ev in events if ev.get("ev") == "data_profile"):
        wrote = True
        w("data profile (%s): %d features, sample %d"
          % (e.get("dataset", "train"), e.get("n_features", 0),
             e.get("sample_size", 0)))
        parts = []
        if e.get("mean_missing_rate") is not None:
            parts.append("mean missing rate %.4g" % e["mean_missing_rate"])
        if e.get("mean_entropy") is not None:
            parts.append("mean bin entropy %.3f" % e["mean_entropy"])
        for key in ("constant", "filtered", "near_constant",
                    "high_cardinality"):
            n = len(e.get(key) or ())
            if n:
                parts.append("%s %d" % (key, n))
        if parts:
            w("  " + "  ".join(parts))
        label = e.get("label") or {}
        if label.get("n_distinct") is not None:
            line = "  label: %d distinct value(s)" % label["n_distinct"]
            if label.get("min_class_frac") is not None:
                line += ", minority class fraction %.4g" \
                    % label["min_class_frac"]
            w(line)
        findings = e.get("findings") or []
        for fd in findings:
            w("  [%s] %s" % (fd.get("severity", "?"),
                             fd.get("message", "")))
            if fd.get("severity") == "error":
                has_error = True
        if not findings:
            w("  no data-quality findings")

    # ----------------------------------------------- importance evolution
    hist = importance_history(events, "gain")
    if hist:
        wrote = True
        final = hist[-1]["importance"]
        top = sorted(final, key=lambda f: -final[f])[:topk]
        idxs = list(range(len(hist)))
        if len(idxs) > 6:       # cap the table at 6 snapshot columns
            step = (len(idxs) - 1) / 5.0
            idxs = sorted({int(round(i * step)) for i in range(6)})
        cols = [hist[i] for i in idxs]
        w()
        w("top %d features by final gain (%d importance snapshots):"
          % (len(top), len(hist)))
        w("  %-10s" % "feature"
          + "".join("%12s" % ("it=%d" % h["it"]) for h in cols))
        for f in top:
            w("  %-10d" % f
              + "".join("%12.4g" % h["importance"].get(f, 0.0)
                        for h in cols))

    # ------------------------------------------------------- gain margins
    stats = audit_margin_stats(events)
    if stats:
        wrote = True
        w()
        w("split-audit gain margins (margin_rel = (gain - runner_up_gain)"
          " / gain):")
        w("  %8s %7s %11s %10s %11s  %s"
          % ("feature", "splits", "total_gain", "contested", "med_margin",
             "top runner-up"))
        rows = sorted(stats.items(), key=lambda kv: -kv[1]["total_gain"])
        for f, st in rows[:15]:
            ru = (max(st["runner_ups"].items(), key=lambda kv: kv[1])
                  if st["runner_ups"] else None)
            med = st["median_margin_rel"]
            w("  %8d %7d %11.4g %9d%% %11s  %s"
              % (f, st["splits"], st["total_gain"],
                 int(round(100.0 * st["contested"]
                           / max(st["splits"], 1))),
                 "%.3f" % med if med is not None else "-",
                 ("f%d x%d" % ru) if ru else "-"))
        close = sorted(f for f, st in stats.items()
                       if st["median_margin_rel"] is not None
                       and st["median_margin_rel"] < 0.1)
        if close:
            w("  NOTE: near-coin-flip features (median margin_rel < 0.1):"
              " %s -- correlated/interchangeable candidates"
              % ",".join(map(str, close)))

    # -------------------------------------------------------- convergence
    series = {}
    for e in (ev for ev in events if ev.get("ev") == "eval"):
        for r in e.get("results") or ():
            series.setdefault((str(r.get("dataset")), str(r.get("metric"))),
                              []).append((int(e.get("it", -1)),
                                          float(r.get("value", 0.0))))
    if series:
        wrote = True
        w()
        w("convergence (eval events):")
        for (ds, metric), pts in sorted(series.items()):
            pts.sort()
            vals = [v for _, v in pts]
            best = max(vals) if vals[-1] >= vals[0] else min(vals)
            w("  %s %s: first %.6g  best %.6g  last %.6g  (%d points)"
              % (ds, metric, vals[0], best, vals[-1], len(pts)))
        for (ds, metric), pts in sorted(series.items()):
            if ds != "training":
                continue
            # first validation series of the same metric (the engine path
            # names them valid_0..., the CLI path valid_1...)
            vds = next((d for (d, m) in sorted(series)
                        if d != "training" and m == metric), None)
            if vds is not None:
                vpts = series[(vds, metric)]
                gap = sorted(vpts)[-1][1] - sorted(pts)[-1][1]
                w("  generalization gap (%s): training %.6g vs %s "
                  "%.6g (gap %+.6g)"
                  % (metric, sorted(pts)[-1][1], vds,
                     sorted(vpts)[-1][1], gap))

    # -------------------------------------------------- autotune decisions
    def _cell(c):
        return "%s W=%s %s%s%s" % (
            c.get("hist_mode", "?"), c.get("wave_width", "?"),
            "hilo" if c.get("hist_hilo", True) else "bf16",
            " compact" if c.get("compact") else "",
            " fused" if c.get("fused") else " staged")

    decisions = [e for e in events if e.get("ev") == "autotune_decision"]
    if decisions:
        wrote = True
        w()
        w("autotune decisions (ops/autotune.py):")
        for e in decisions:
            chosen, prior = e.get("cell") or {}, e.get("prior") or {}
            line = ("  [%s/%s] %s bucket %s: %s"
                    % (e.get("mode", "?"), e.get("source", "?"),
                       e.get("device_kind", "?"), e.get("bucket", "?"),
                       _cell(chosen)))
            if chosen != prior and prior:
                line += "  (prior: %s)" % _cell(prior)
            if e.get("cache_hit"):
                line += "  [cache hit, zero probe waves]"
            w(line)
            cells = e.get("cells") or ()
            if cells:
                from .roofline import describe_roofline_position
                best = min((c.get("s_per_wave") for c in cells
                            if c.get("s_per_wave") is not None),
                           default=None)
                for c in cells:
                    s = c.get("s_per_wave")
                    tag = " <- winner" if (s is not None and s == best) \
                        else ""
                    # the probe's roofline stamp says why: e.g.
                    # "pallas_ct at 71% HBM vs pallas_t at 34%"
                    pos = describe_roofline_position(c.get("roofline"))
                    if pos:
                        tag = "  [at %s]%s" % (pos, tag)
                    w("    %-34s %10.6f s/tree%s"
                      % (_cell(c.get("cell") or {}),
                         s if s is not None else float("nan"), tag))
                if e.get("margin"):
                    w("    winner margin: %.1f%% faster than runner-up"
                      % (100.0 * float(e["margin"])))
                if e.get("overhead_s"):
                    w("    probe overhead: %.4f s (kept in %s)"
                      % (float(e["overhead_s"]),
                         e.get("cache_path", "?")))

    if not wrote:
        w("no model/data events -- train with obs_split_audit=true, "
          "obs_importance_every=N and/or obs_data_profile=true (plus any "
          "obs_* output) to populate them")
    return has_error


_DIFF_KEYS = ("iters", "iters_per_sec", "total_s", "compile_s",
              "recompile_count", "peak_mem_bytes", "straggler_max_skew",
              "barrier_skew_max_s")


def render_diff(a_events, b_events, out=None):
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    ma, mb = timeline_metrics(a_events), timeline_metrics(b_events)
    w("%-18s %14s %14s %10s" % ("metric", "A", "B", "delta"))
    for key in _DIFF_KEYS:
        if key not in ma and key not in mb:
            continue
        va, vb = ma.get(key), mb.get(key)
        if va is None or vb is None:
            w("%-18s %14s %14s %10s"
              % (key, "-" if va is None else "%.6g" % va,
                 "-" if vb is None else "%.6g" % vb, "n/a"))
            continue
        if va:
            delta = "%+.1f%%" % (100.0 * (vb - va) / va)
        else:
            delta = "+0%" if vb == va else "new"
        w("%-18s %14.6g %14.6g %10s" % (key, va, vb, delta))
    for side, m in (("A", ma), ("B", mb)):
        if m.get("health"):
            w("health %s: %s" % (side, "  ".join(
                "%s=%d" % kv for kv in sorted(m["health"].items()))))


def export_chrome_trace(events, out_path):
    """Reconstruct a Chrome trace.json from phase-timer laps.

    Each ``iter`` record carries its end wall-clock ``t`` and fenced
    duration ``time_s``; the per-phase laps are re-laid end to end from
    the iteration start (the order the phases ran -- dicts preserve the
    emission order).  Point events (compiles, health, stragglers) land
    as instants on their own track."""
    by_run = runs(events)
    trace = []
    for pid, (run, evs) in enumerate(by_run.items()):
        t0 = min(e["t"] for e in evs)
        trace.append({"ph": "M", "pid": pid, "name": "process_name",
                      "args": {"name": "run %s" % run}})
        for tid, tname in ((0, "iterations"), (1, "phases"),
                           (2, "events")):
            trace.append({"ph": "M", "pid": pid, "tid": tid,
                          "name": "thread_name",
                          "args": {"name": tname}})
        for e in evs:
            ev = e.get("ev")
            if ev == "iter":
                start = e["t"] - e["time_s"]
                trace.append({"ph": "X", "pid": pid, "tid": 0,
                              "name": "iter %d" % e["it"],
                              "ts": (start - t0) * 1e6,
                              "dur": e["time_s"] * 1e6,
                              "args": {"fenced": e.get("fenced")}})
                cur = start
                for phase, dur in e.get("phases", {}).items():
                    trace.append({"ph": "X", "pid": pid, "tid": 1,
                                  "name": phase,
                                  "ts": (cur - t0) * 1e6,
                                  "dur": dur * 1e6,
                                  "args": {"it": e["it"]}})
                    cur += dur
            elif ev in ("compile", "compile_attr", "health", "straggler",
                        "trace_window", "host_collective"):
                name = {"compile": "compile:%s",
                        "compile_attr": "recompile:%s"}.get(ev)
                if ev == "host_collective":
                    label = "collective:%s seq=%s" % (e.get("op"),
                                                      e.get("seq"))
                else:
                    label = (name % e.get("entry") if name
                             else (("health:%s" % e.get("check")) if
                                   ev == "health" else ev))
                args = {k: v for k, v in e.items()
                        if k not in ("t", "run") and
                        isinstance(v, (int, float, str, bool))}
                trace.append({"ph": "i", "s": "p", "pid": pid, "tid": 2,
                              "name": label, "ts": (e["t"] - t0) * 1e6,
                              "args": args})
    with open(out_path, "w") as f:
        json.dump({"traceEvents": trace, "displayTimeUnit": "ms"}, f)
    return len(trace)


# ------------------------------------------------------------------ CLI

def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch obs",
        description="query obs JSONL timelines")
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name, hlp in (("summary", "headline metrics of the last run"),
                      ("recompiles", "compile_attr events + diffs"),
                      ("stragglers", "per-rank arrival skew samples"),
                      ("explain", "model & data-quality report: top "
                                  "features, gain margins, findings")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("timeline")
        if name == "recompiles":
            p.add_argument("--check", action="store_true",
                           help="exit 1 on same-signature compiles "
                                "(graph re-capture thrash): the CI gate")
        elif name == "explain":
            p.add_argument("--check", action="store_true",
                           help="exit 1 on error-severity data-quality "
                                "findings — the CI model-quality gate")
    p = sub.add_parser("serve", help="serving-tier report: per-route "
                                     "latency, SLO verdicts, shed/"
                                     "overload summary, batch efficiency")
    p.add_argument("timeline")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on shed requests, fired burn-rate "
                        "alerts or failing SLO verdicts — the CI gate "
                        "for non-overload load")
    p = sub.add_parser("drift", help="drift & online-quality report: "
                                     "features ranked by divergence vs "
                                     "the training fingerprint, score "
                                     "PSI/KS, online AUC/logloss")
    p.add_argument("timeline")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on a fired drift alert or a timeline "
                        "with no drift events — the CI drift-drill "
                        "gate")
    p = sub.add_parser("roofline",
                       help="achieved-vs-peak utilization per timed "
                            "entry, ranked by recoverable headroom "
                            "seconds (obs/roofline.py)")
    p.add_argument("timeline")
    p.add_argument("--peaks", default="",
                   help="JSON device-peak overrides "
                        "(obs_roofline_peaks format)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when the timeline cannot be attributed "
                        "(no finished run, or no cost estimates: run "
                        "with obs_compile=true on the card): the CI "
                        "gate")
    p = sub.add_parser("incident",
                       help="incident triage report: grouped signals, "
                            "cross-subsystem correlation, evidence "
                            "inventory, root-cause ranking "
                            "(obs/incident.py)")
    p.add_argument("target",
                   help="evidence-bundle directory (one incident or a "
                        "parent of several) or a timeline JSONL with "
                        "incident_* events")
    p.add_argument("--check", action="store_true",
                   help="exit 1 when any incident opened — the CI "
                        "incident-drill gate (clean control runs "
                        "exit 0)")
    p = sub.add_parser("watch",
                       help="live-follow a growing timeline, per-rank "
                            "shard set, or a running plane's /events "
                            "URL (obs_http_port)")
    p.add_argument("target",
                   help="timeline file, shard base path, or "
                        "http://host:port of a live run")
    p.add_argument("--once", action="store_true",
                   help="render everything currently visible and exit "
                        "(the CI-friendly snapshot mode)")
    p.add_argument("--ranks", action="store_true",
                   help="tail every .rN shard of a multi-rank run, "
                        "iterations aligned across the ranks")
    p.add_argument("--interval", type=float, default=0.5,
                   help="poll interval in seconds (default 0.5)")
    p.add_argument("--max-wall", type=float, default=0.0,
                   help="follow-mode wall-clock limit in seconds for "
                        "scripted callers (0 = no limit)")
    p = sub.add_parser("prof",
                       help="host profile report: merged top-table of "
                            "folded stacks, HTML flamegraph, overhead "
                            "gate (obs/prof.py)")
    p.add_argument("target",
                   help="timeline JSONL with prof_profile windows, or "
                        "a directory (newest *.jsonl inside)")
    p.add_argument("--check", action="store_true",
                   help="exit 1 on blown overhead budget (>1%%), a "
                        "zero-sample window while iterations advanced, "
                        "or a sampler error window — the CI "
                        "profiler-liveness gate")
    p.add_argument("--flame", default="",
                   help="write a self-contained HTML flamegraph here")
    p.add_argument("--top", type=int, default=20,
                   help="rows in the terminal top-table (default 20)")
    p = sub.add_parser("merge", help="cross-rank merge + skew analysis "
                                     "of per-rank shards")
    p.add_argument("shards", nargs="+",
                   help="shard files, or one base/shard path to "
                        "auto-discover .r* siblings")
    p.add_argument("-o", "--out", default="",
                   help="write the merged critical-path timeline here")
    p = sub.add_parser("diff", help="two timelines side by side")
    p.add_argument("baseline")
    p.add_argument("candidate")
    p = sub.add_parser("trace", help="export Chrome trace.json from "
                                     "phase laps")
    p.add_argument("timeline")
    p.add_argument("-o", "--out", default="trace.json")
    for name, hlp in (("history", "cross-run ledger: one line per "
                                  "recorded bench run"),
                      ("trend", "per-metric trend tables, sparklines + "
                                "change-point attribution")):
        p = sub.add_parser(name, help=hlp)
        p.add_argument("ledger", nargs="?", default="",
                       help="ledger directory (default: LGBM_TPU_LEDGER "
                            "or /tmp/lgbm_tpu_ledger)")
        p.add_argument("--suite", default="",
                       help="restrict to one ledger suite")
        p.add_argument("--metric", default="",
                       help="restrict to one metric")
        if name == "history":
            p.add_argument("-n", "--limit", type=int, default=20,
                           help="show the last N runs")
        else:
            p.add_argument("--window", type=int, default=8,
                           help="rolling-baseline window")
            p.add_argument("--min-history", type=int, default=3,
                           help="runs required before change-point "
                                "detection engages")
            p.add_argument("--z", type=float, default=3.0,
                           help="change-point z-score threshold")
            p.add_argument("--check", action="store_true",
                           help="exit 1 when a gated metric's current "
                                "regime began with a bad-direction "
                                "shift — the cross-run CI gate")
    args = ap.parse_args(argv)

    # watch targets may be URLs or shard-base globs, and the tailed
    # file may end mid-line — it never goes through load_timeline
    if args.cmd == "watch":
        from .live import watch
        return watch(args.target, once=args.once, ranks=args.ranks,
                     interval_s=args.interval, max_wall_s=args.max_wall)

    # incident targets may be bundle DIRECTORIES, not just timelines —
    # they never go through load_timeline
    if args.cmd == "incident":
        from .incident import render_incident_report
        try:
            n = render_incident_report(args.target)
        except (OSError, ValueError) as e:
            print("error: %s" % e, file=sys.stderr)
            return 2
        return 1 if (args.check and n) else 0

    # prof targets may be directories too (newest *.jsonl inside) —
    # resolved in obs/prof.py, not through load_timeline here
    if args.cmd == "prof":
        from .prof import render_prof_report
        try:
            problems = render_prof_report(args.target, top=args.top,
                                          flame=args.flame,
                                          check=args.check)
        except (OSError, ValueError) as e:
            print("error: %s" % e, file=sys.stderr)
            return 2
        return 1 if (args.check and problems) else 0

    if args.cmd in ("history", "trend"):
        from .ledger import Ledger, default_ledger_dir
        from .ledger import render_history, render_trend
        path = args.ledger or default_ledger_dir()
        entries = Ledger(path).entries()
        if args.cmd == "history":
            render_history(entries, limit=args.limit,
                           suite=args.suite or None,
                           metric=args.metric or None)
            return 0
        active = render_trend(entries, suite=args.suite or None,
                              metric=args.metric or None,
                              window=args.window, z_threshold=args.z,
                              min_history=args.min_history)
        return 1 if (args.check and active) else 0

    try:
        if args.cmd == "merge":
            from .merge import (discover_shards, load_shards,
                                merge_shards, render_report,
                                write_merged)
            paths = (list(args.shards) if len(args.shards) > 1
                     else discover_shards(args.shards[0]))
            merged, report = merge_shards(load_shards(paths))
            render_report(report)
            if args.out:
                n = write_merged(merged, args.out)
                print("\nwrote %d merged events -> %s" % (n, args.out))
            return 0
        if args.cmd == "diff":
            a = last_run(load_timeline(args.baseline))
            b = last_run(load_timeline(args.candidate))
        else:
            events = last_run(load_timeline(args.timeline))
    except (OSError, ValueError) as e:
        print("error: %s" % e, file=sys.stderr)
        return 2

    if args.cmd == "summary":
        render_summary(events)
    elif args.cmd == "recompiles":
        thrash = render_recompiles(events)
        if args.check and thrash:
            return 1
    elif args.cmd == "stragglers":
        render_stragglers(events)
    elif args.cmd == "explain":
        bad = render_explain(events)
        if args.check and bad:
            return 1
    elif args.cmd == "serve":
        from .serve import render_serve_report
        problems = render_serve_report(events, check=args.check)
        if args.check and problems:
            return 1
    elif args.cmd == "drift":
        from .drift import render_drift_report
        problems = render_drift_report(events, check=args.check)
        if args.check and problems:
            return 1
    elif args.cmd == "roofline":
        from .roofline import render_roofline
        problems = render_roofline(events, check=args.check,
                                   peaks_path=args.peaks)
        if args.check and problems:
            return 1
    elif args.cmd == "diff":
        render_diff(a, b)
    elif args.cmd == "trace":
        n = export_chrome_trace(events, args.out)
        print("wrote %d trace events -> %s (load in ui.perfetto.dev)"
              % (n, args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
