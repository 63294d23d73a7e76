"""Cross-rank merge + skew analysis of per-rank timeline shards.

Ported from the JAX package's ``obs/merge.py`` (pure Python over the
timeline events, the same analysis and merged timeline).

A distributed run writes one JSONL shard per rank
(``obs_events_path`` + ``.r{rank}``, events.py schema 4).  Each shard
is internally consistent but blind: rank 3 knows it waited 1.8 s inside
``allgather_obj`` seq 7, not that rank 1 arrived 1.8 s late and caused
it.  This module lines the shards up on the identifiers that are
globally meaningful by construction — the iteration index of ``iter``
events and the monotonic per-rank ``seq`` of ``host_collective``
events (every rank executes the same collective sequence, exactly like
the reference's rank-symmetric Network calls) — and derives the
cross-rank facts:

* **barrier skew per collective** — first-arrival vs last-arrival wall
  time at each (op, seq), and which rank was last (the rank everyone
  else waited for);
* **per-iteration skew** — per-rank fenced iteration times side by
  side, slowest rank per iteration;
* **per-rank phase comparison** — where each rank spends its time, the
  per-rank cost imbalance arxiv 1806.11248 documents as the dominant
  distributed-GBDT effect;
* **slowest-rank attribution** — how often each rank was the straggler,
  over collectives and iterations, mirroring the rank-level
  attribution of obs/straggler.py.

``merge_shards`` also synthesizes a **merged timeline**: a single
schema-4 run whose ``iter`` events carry the critical-path time (max
across ranks — the wall time the world actually experienced, since every
collective fences the lagging rank in) so ``obs summary`` and
``obs diff`` read the merged view with no special cases.

Wall-clock caveat: cross-rank arrival deltas compare host clocks.  On
one machine (run_ranks threads, localhost processes) that is one
clock; across hosts keep NTP sane or read skews as approximate.
"""
from __future__ import annotations

import glob
import json
import os

from .events import SCHEMA_VERSION, collect_provenance

__all__ = ["discover_shards", "load_shards", "merge_shards",
           "render_report", "write_merged"]


def discover_shards(path):
    """Shard paths for a run, given the base ``obs_events_path`` (or any
    one shard of it).  ``base`` -> [``base.r0``, ``base.r1``, ...];
    ``base.r2`` -> all its siblings; a plain single-rank file -> itself.
    """
    path = str(path)
    base = path
    head, tail = os.path.split(path)
    if ".r" in tail and tail.rsplit(".r", 1)[1].isdigit():
        base = os.path.join(head, tail.rsplit(".r", 1)[0])
    shards = sorted(glob.glob(glob.escape(base) + ".r[0-9]*"),
                    key=_shard_rank_of)
    shards = [p for p in shards
              if p.rsplit(".r", 1)[1].isdigit()]
    if shards:
        return shards
    if os.path.exists(path):
        return [path]
    raise OSError("no timeline shards found for %s (looked for %s.r*)"
                  % (path, base))


def _shard_rank_of(path):
    tail = path.rsplit(".r", 1)
    return int(tail[1]) if len(tail) == 2 and tail[1].isdigit() else 0


def load_shards(paths):
    """{rank: last-run events} from per-rank shard files.  The rank
    comes from the shard's run header (schema 4), falling back to the
    ``.rN`` filename suffix for headerless/older shards."""
    from . import query
    out = {}
    for p in paths:
        events = query.last_run(query.load_timeline(p))
        if not events:
            continue
        header = next((e for e in events if e.get("ev") == "run_header"),
                      None)
        rank = (header or {}).get("rank")
        if rank is None:
            rank = _shard_rank_of(p)
        out[int(rank)] = events
    if not out:
        raise ValueError("no events in any shard of %s" % (list(paths),))
    return out


# ---------------------------------------------------------------- analysis

def _collective_rows(shards):
    """Align host_collective events across ranks on (op, seq)."""
    by_key = {}
    for rank, events in sorted(shards.items()):
        for e in events:
            if e.get("ev") != "host_collective":
                continue
            key = (str(e.get("op")), int(e.get("seq", -1)))
            by_key.setdefault(key, {})[rank] = e
    rows = []
    for (op, seq), per_rank in sorted(by_key.items(),
                                      key=lambda kv: kv[0][1]):
        arrivals = {r: float(e.get("t_start", e.get("t", 0.0)))
                    for r, e in per_rank.items()}
        first_rank = min(arrivals, key=arrivals.get)
        last_rank = max(arrivals, key=arrivals.get)
        rows.append({
            "op": op, "seq": seq,
            "ranks": sorted(per_rank),
            "arrivals": {str(r): round(t, 6)
                         for r, t in sorted(arrivals.items())},
            "skew_s": round(arrivals[last_rank] - arrivals[first_rank], 6),
            "first_rank": first_rank, "last_rank": last_rank,
            "dur_max_s": round(max(float(e.get("dur_s", 0.0))
                                   for e in per_rank.values()), 6),
            "missing_ranks": sorted(set(shards) - set(per_rank)),
        })
    return rows


def _iter_rows(shards):
    """Align iter events across ranks on the iteration index."""
    by_it = {}
    for rank, events in sorted(shards.items()):
        for e in events:
            if e.get("ev") == "iter":
                by_it.setdefault(int(e["it"]), {})[rank] = e
    rows = []
    for it, per_rank in sorted(by_it.items()):
        times = {r: float(e["time_s"]) for r, e in per_rank.items()}
        slowest = max(times, key=times.get)
        fastest = min(times, key=times.get)
        rows.append({"it": it, "times": times, "slowest": slowest,
                     "skew_s": round(times[slowest] - times[fastest], 6),
                     "events": per_rank})
    return rows


def _phase_totals(events):
    totals = {}
    for e in events:
        if e.get("ev") != "iter":
            continue
        for k, v in (e.get("phases") or {}).items():
            totals[k] = totals.get(k, 0.0) + float(v)
    return totals


def merge_shards(shards):
    """(merged_events, report) from {rank: events}.

    ``merged_events`` is a valid schema-4 timeline of ONE synthetic run:
    critical-path ``iter`` events (max time across ranks, per-phase max,
    per-rank times attached), one ``host_collective`` per (op, seq) with
    the cross-rank skew attached, pass-through point events tagged with
    their rank, and a ``run_end`` carrying the full rank report.
    """
    ranks = sorted(shards)
    world = len(ranks)
    headers = {r: next((e for e in shards[r]
                        if e.get("ev") == "run_header"), None)
               for r in ranks}
    coll_rows = _collective_rows(shards)
    iter_rows = _iter_rows(shards)
    per_rank_phases = {r: _phase_totals(shards[r]) for r in ranks}
    per_rank_total = {r: sum(float(e["time_s"]) for e in shards[r]
                             if e.get("ev") == "iter") for r in ranks}

    # slowest-rank attribution: who was last at the barrier / slowest
    # per iteration, how often — the rank-level straggler table
    last_counts = {}
    for row in coll_rows:
        if len(row["ranks"]) > 1:
            last_counts[row["last_rank"]] = \
                last_counts.get(row["last_rank"], 0) + 1
    slow_iter_counts = {}
    for row in iter_rows:
        if len(row["times"]) > 1:
            slow_iter_counts[row["slowest"]] = \
                slow_iter_counts.get(row["slowest"], 0) + 1

    multi_coll = [r for r in coll_rows if len(r["ranks"]) > 1]
    max_coll = max(multi_coll, key=lambda r: r["skew_s"],
                   default=None)
    report = {
        "world_size": world,
        "ranks": ranks,
        "collectives": coll_rows,
        "iterations": len(iter_rows),
        "iter_skew_max_s": round(max((r["skew_s"] for r in iter_rows),
                                     default=0.0), 6),
        "collective_skew_max_s": (max_coll or {}).get("skew_s", 0.0),
        "collective_skew_max_seq": (max_coll or {}).get("seq"),
        "per_rank_phase_totals": {str(r): {k: round(v, 6) for k, v in
                                           sorted(t.items())}
                                  for r, t in per_rank_phases.items()},
        "per_rank_iter_total_s": {str(r): round(t, 6)
                                  for r, t in per_rank_total.items()},
        "slowest_rank_collectives": {str(r): n for r, n in
                                     sorted(last_counts.items())},
        "slowest_rank_iters": {str(r): n for r, n in
                               sorted(slow_iter_counts.items())},
        "statuses": {},
    }

    # ------------------------------------------------------ merged view
    run_id = "merged-" + "-".join(
        str((headers[r] or {}).get("run", r))[:8] for r in ranks[:2])
    merged = []

    def emit(ev, t, **fields):
        rec = {"ev": ev, "t": t, "run": run_id}
        rec.update(fields)
        merged.append(rec)
        return rec

    h0 = headers[ranks[0]] or {}
    emit("run_header", h0.get("t", 0.0), schema=SCHEMA_VERSION,
         backend=h0.get("backend", "?"),
         devices=h0.get("devices", []), params=h0.get("params", {}),
         context=h0.get("context", {}), timing=h0.get("timing", "?"),
         rank=-1, world_size=world, coordinator=h0.get("coordinator", ""),
         provenance=h0.get("provenance") or collect_provenance(),
         merged=True, merged_ranks=ranks)

    for row in coll_rows:
        arrive_last = max(float(v) for v in row["arrivals"].values())
        emit("host_collective", arrive_last + row["dur_max_s"],
             op=row["op"], seq=row["seq"], dur_s=row["dur_max_s"],
             skew_s=row["skew_s"], first_rank=row["first_rank"],
             last_rank=row["last_rank"], arrivals=row["arrivals"],
             missing_ranks=row["missing_ranks"])

    for row in iter_rows:
        # critical path: the world moves at the pace of its slowest rank
        slow_ev = row["events"][row["slowest"]]
        phases = {}
        for e in row["events"].values():
            for k, v in (e.get("phases") or {}).items():
                phases[k] = max(phases.get(k, 0.0), float(v))
        emit("iter", max(e["t"] for e in row["events"].values()),
             it=row["it"], seq=slow_ev.get("seq", row["it"]),
             time_s=row["times"][row["slowest"]], phases=phases,
             fenced=all(e.get("fenced") for e in row["events"].values()),
             rank_times={str(r): round(t, 6)
                         for r, t in sorted(row["times"].items())},
             skew_s=row["skew_s"], slowest_rank=row["slowest"])

    passthrough = ("compile", "compile_attr", "memory", "straggler",
                   "health", "collectives", "trace_window", "metrics")
    for r in ranks:
        for e in shards[r]:
            if e.get("ev") in passthrough:
                rec = dict(e)
                rec["run"] = run_id
                rec.setdefault("rank", r)
                merged.append(rec)

    run_ends = {r: next((e for e in shards[r]
                         if e.get("ev") == "run_end"), None)
                for r in ranks}
    report["statuses"] = {str(r): (run_ends[r] or {}).get("status",
                                                          "missing")
                          for r in ranks}
    status = "ok"
    if any(v != "ok" for v in report["statuses"].values()):
        status = "aborted"
    ref_end = run_ends[ranks[0]] or {}
    emit("run_end", max((e.get("t", 0.0) for e in run_ends.values()
                         if e), default=0.0),
         iters=len(iter_rows), phase_totals=_phase_totals(merged),
         entries=ref_end.get("entries", {}), status=status,
         rank_report=report)

    merged.sort(key=lambda e: (0 if e["ev"] == "run_header" else
                               2 if e["ev"] == "run_end" else 1,
                               e.get("t", 0.0)))
    return merged, report


def write_merged(merged_events, out_path):
    with open(out_path, "w") as f:
        for rec in merged_events:
            f.write(json.dumps(rec, default=str) + "\n")
    return len(merged_events)


# --------------------------------------------------------------- rendering

def render_report(report, out=None):
    import sys
    out = out or sys.stdout
    w = lambda s="": out.write(s + "\n")
    ranks = report["ranks"]
    w("merged %d rank shard(s): ranks %s" % (report["world_size"], ranks))
    w("statuses: " + "  ".join("r%s=%s" % kv for kv in
                               sorted(report["statuses"].items())))

    colls = report["collectives"]
    if colls:
        w("\n== barrier skew per host collective (first vs last "
          "arrival) ==")
        w("%5s %-14s %10s %6s %6s  %s" % ("seq", "op", "skew_s", "first",
                                          "last", "arrivals"))
        for row in colls:
            miss = (" MISSING ranks %s" % row["missing_ranks"]
                    if row["missing_ranks"] else "")
            w("%5d %-14s %10.6f %6s %6s  %d rank(s)%s"
              % (row["seq"], row["op"], row["skew_s"],
                 "r%d" % row["first_rank"], "r%d" % row["last_rank"],
                 len(row["ranks"]), miss))
        w("max barrier skew: %.6f s at seq %s"
          % (report["collective_skew_max_s"],
             report["collective_skew_max_seq"]))

    phases = report["per_rank_phase_totals"]
    keys = sorted({k for t in phases.values() for k in t})
    if keys:
        w("\n== per-rank phase totals (s) ==")
        w("%-12s " % "phase" + " ".join("%10s" % ("r%s" % r)
                                        for r in ranks))
        for k in keys:
            w("%-12s " % k + " ".join(
                "%10.4f" % phases[str(r)].get(k, 0.0) for r in ranks))
        w("%-12s " % "iter total" + " ".join(
            "%10.4f" % report["per_rank_iter_total_s"].get(str(r), 0.0)
            for r in ranks))

    attr_c = report["slowest_rank_collectives"]
    attr_i = report["slowest_rank_iters"]
    if attr_c or attr_i:
        w("\n== slowest-rank attribution ==")
        w("%6s %18s %14s" % ("rank", "last at barrier", "slowest iter"))
        for r in ranks:
            w("%6s %18d %14d" % ("r%d" % r, attr_c.get(str(r), 0),
                                 attr_i.get(str(r), 0)))
        worst = max(ranks, key=lambda r: attr_c.get(str(r), 0)
                    + attr_i.get(str(r), 0))
        total = sum(attr_c.values()) + sum(attr_i.values())
        if total:
            w("straggler: rank %d (last/slowest %d of %d samples)"
              % (worst, attr_c.get(str(worst), 0)
                 + attr_i.get(str(worst), 0), total))
