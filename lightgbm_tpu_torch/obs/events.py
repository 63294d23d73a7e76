"""Structured JSONL event timeline for training runs.

The port's copy of the JAX package's ``obs/events.py``: the same schema
(``SCHEMA_VERSION``, the ``_REQUIRED`` and ``_OPTIONAL`` tables), so a
timeline written by either package validates and reads in the other.
One line per event, append-only.  Every record carries ``ev`` (type),
``t`` (unix time) and ``run`` (random id); several runs may share one
file (cv folds) and readers group by ``run``.  The event types and
their keys are the tables below; docs/Observability.md describes them.

``RunObserver`` is the facade the training loop drives: the phase clock,
the entry timers, memory snapshots, the trace window (obs/profile.py),
health (obs/health.py) and metrics snapshots of the process registry
(obs/metrics.py).  ``NULL_OBSERVER`` is the shared disabled instance:
every method is a no-op, so the hot path pays one attribute check and an
empty call, with no fencing and no event objects.  The JAX package's
compile attribution, straggler sampling, hang watchdog, live scrape
server, incident engine, sampling profiler and cross-run ledger are not
in the port yet (ROADMAP A12); their hooks keep the NullObserver's
no-ops, and their ``obs_*`` keys raise (obs/__init__.py).

Crash safety: the writer flushes every ``flush_every`` events (and on
``run_end``), train and cv close the observer with ``status="aborted"``
when the loop raises, and the observer registers an ``atexit``
finalizer: a run killed mid-iteration still ends with a parseable
timeline whose last record is ``run_end`` whenever the interpreter gets
to unwind.
"""
from __future__ import annotations

import atexit
import collections
import json
import os
import socket
import subprocess
import sys
import threading
import time

from ..utils.log import Log
from .memory import MemorySampler
from .profile import TraceWindow
from .timers import EntryTimers, PhaseClock, fence

SCHEMA_VERSION = 16
# schema 1 (no health/metrics), 2 (no compile_attr/straggler),
# 3 (rank-less, no host_collective), 4 (no model/data events),
# 5 (no serving events), 6 (no request traces / SLO snapshots),
# 7 (no autotune/band-escape events), 8 (no dataset_construct),
# 9 (no run_header provenance), 10 (no host_orchestration_s iter
# field -- schema 11 adds the host-glue seconds between device program
# submissions, models/gbdt.py OrchestrationClock), 11 (no pod
# scale-out events -- schema 12 adds scaling / mesh_shrink / checkpoint
# and the sharded-ingest dataset_construct fields), 12 (no roofline
# attribution -- schema 13 adds the per-iteration ``utilization``
# rollup and the ``autotune_probe.roofline`` cell stamp, obs/
# roofline.py), 13 (no drift monitoring -- schema 14 adds the
# ``drift`` / ``online_quality`` serving-side distribution-shift
# events and the serve_summary ``drift`` digest, obs/drift.py) and
# 14 (no incident engine -- schema 15 adds the ``incident_open`` /
# ``incident_evidence`` / ``incident_close`` anomaly-correlation
# events and the run_end ``incidents`` digest, obs/incident.py) and
# 15 (no host profiler -- schema 16 adds the continuous sampling
# profiler's ``prof_profile`` window rollup, obs/prof.py) timelines
# still parse.  wave_band_escape stays accepted for old timelines
# even though nothing emits it anymore (the band prior is gone).
_ACCEPTED_SCHEMAS = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                     16)

# ev -> keys that must be present (beyond the common ev/t/run)
_REQUIRED = {
    "run_header": ("schema", "backend", "devices", "params", "context",
                   "timing"),
    "iter": ("it", "time_s", "phases", "fenced"),
    "compile": ("entry", "first_call_s", "fenced"),
    "compile_attr": ("entry", "n_compiles", "sig"),
    "straggler": ("it", "devices", "skew"),
    "memory": ("it", "devices"),
    "trace_window": ("action", "dir", "it"),
    "collectives": ("learner",),
    # schema 4 (parallel/comm.py): one host-level collective with its
    # monotonic per-rank sequence number -- obs/merge.py aligns shards
    # on (op, seq) to measure barrier skew
    "host_collective": ("op", "seq", "dur_s"),
    "health": ("check", "status", "it"),
    "metrics": ("it", "scrape"),
    # schema 5 (obs/model.py + obs/dataquality.py): model & data
    # observability -- split audit trail, importance evolution, dataset
    # profile, per-iteration eval values
    "split_audit": ("it", "tree", "splits"),
    "importance": ("it", "features"),
    "data_profile": ("n_features",),
    "eval": ("it", "results"),
    # schema 6 (lightgbm_tpu/serve/): the serving tier -- one coalesced
    # microbatch per serve_batch (sampled via serve_batch_event_every),
    # one serve_bench summary per bench_serve.py measurement window.
    # Schema 7 declares the full serve_batch field set (the scheduler
    # always emitted pad/requests/queue_s/exec_s -- the schema just
    # under-promised), so strict validation and downstream tooling see
    # every field; schema-6 timelines still validate.
    "serve_batch": ("route", "rows", "bucket", "pad", "requests",
                    "queue_s", "exec_s"),
    "serve_bench": ("qps", "p50_s", "p99_s"),
    # schema 7 (obs/serve.py + serve/scheduler.py): serving-tier
    # observability -- sampled per-request trace spans, periodic
    # rolling-window SLO snapshots, and the close-time lifetime summary
    "serve_request": ("route", "rows", "bucket", "spans"),
    "serve_slo": ("window_s", "routes"),
    "serve_summary": ("batches", "rows", "shed_total"),
    # schema 8 (ops/autotune.py + ops/learner.py): measured kernel
    # selection -- per-cell probe timings, the per-learner decision
    # (with prior, margin and cache provenance), and the previously
    # silent pathology-band width escape
    "autotune_probe": ("cell", "s_per_wave"),
    "autotune_decision": ("mode", "source", "cell"),
    "wave_band_escape": ("width_from", "width_to"),
    # schema 9 (io/dataset.py + io/streaming.py): out-of-core ingest —
    # one event per dataset construction with the two-pass phase split
    # (quantile sketch / binning / shard write), chunk count, worker-pool
    # width and the host RSS watermark; bench_compare gates construct_s
    "dataset_construct": ("rows", "chunks", "sketch_s", "bin_s",
                          "write_s", "peak_rss_bytes", "workers"),
    # schema 12 (parallel/ + bench.py --mp + engine.py): pod scale-out —
    # one scaling summary per measured world size (the weak-scaling
    # ledger cells, obs/ledger.py), one mesh_shrink per elastic
    # shrink-and-resume, one checkpoint per compact booster save
    "scaling": ("world_size", "rows_per_sec_per_chip", "efficiency"),
    "mesh_shrink": ("world_size_from", "world_size_to", "it"),
    "checkpoint": ("it",),
    # schema 13 (obs/roofline.py): per-iteration roofline rollup —
    # exec-weighted achieved/peak utilization across the timed entries,
    # joined from CompileTracker cost estimates and the device-peak
    # registry (obs_utilization_every)
    "utilization": ("it", "entries"),
    # schema 14 (obs/drift.py): serving-side drift monitoring -- one
    # ``drift`` rollup per obs_drift_every rows (per-feature + score
    # PSI/KS vs the training fingerprint), one ``online_quality`` per
    # evaluation once enough delayed labels joined via
    # ServingPredictor.record_outcome
    "drift": ("rows", "window_rows", "psi_max"),
    "online_quality": ("n", "logloss"),
    # schema 15 (obs/incident.py): anomaly correlation -- one
    # incident_open when the first qualifying detector signal arrives
    # (with the evidence bundle captured at that moment), one
    # incident_evidence per captured artifact, one incident_close after
    # a quiet window with the grouped per-kind signal rollup
    "incident_open": ("id", "trigger", "signals"),
    "incident_evidence": ("id", "artifact"),
    "incident_close": ("id", "duration_s", "signals"),
    # schema 16 (obs/prof.py): the continuous host sampling profiler —
    # one aggregated window per obs_prof_window_s with the folded-stack
    # counts and the sampler's self-measured cost (the overhead budget
    # bench.py --dry and `obs prof --check` gate on)
    "prof_profile": ("samples", "dur_s", "hz", "cost_s"),
    "run_end": ("iters", "phase_totals", "entries"),
}

# ev -> keys a writer MAY attach beyond _REQUIRED.  Every field any
# in-tree emit site produces must be declared in one of the two tables:
# the event-schema lint pass (analysis/events_schema.py) rejects an
# emit-site keyword found in neither, so a new field is a deliberate
# schema decision here rather than silent drift (the schema-6->7
# ``serve_batch`` under-promise).  Readers must
# still treat these as optional -- old timelines predate them.
_OPTIONAL = {
    "run_header": ("rank", "world_size", "coordinator", "provenance",
                   # obs/merge.py synthetic pod-merged header
                   "merged", "merged_ranks"),
    "iter": ("seq", "stopped", "host_orchestration_s",
             # obs/merge.py critical-path merge
             "rank_times", "skew_s", "slowest_rank"),
    "compile": (),
    # attribution extras (obs/compile.py / serve/executable.py):
    # per-signature counts, field-level diff, jit cache size, AOT
    # cost/memory analysis when the backend exposes them
    "compile_attr": ("sig_compiles", "diff", "cache_size", "cost",
                     "memory"),
    "straggler": ("axis", "slowest", "total_s"),
    "memory": (),
    "trace_window": (),
    # parallel/mesh.py collective_info(): static topology + per-collective
    # byte estimates; exact keys vary by learner
    "collectives": ("axis", "n_devices", "n_processes", "global_rows",
                    "estimates", "psum", "allgather",
                    "num_voting_machines"),
    "host_collective": ("t_start", "nbytes",
                        # obs/merge.py aligned-collective merge
                        "skew_s", "first_rank", "last_rank", "arrivals",
                        "missing_ranks"),
    "health": ("detail",),
    "metrics": (),
    "split_audit": ("num_leaves", "shrinkage", "truncated"),
    "importance": ("n_features", "n_used", "split", "gain"),
    # the profile payload (io/dataset.py _profile_quality) rides in via
    # **profile; its stat keys are the profiler's contract, not ours
    "data_profile": ("dataset", "label", "findings", "n_rows", "stats"),
    "eval": (),
    "serve_batch": ("kind",),
    # bench_serve.py load-generator summary extras
    "serve_bench": ("requests", "rows", "rows_per_s", "threads",
                    "wall_s", "batches", "pad_rows", "buckets",
                    "offered", "shed", "shed_rate", "deadline_ms",
                    "steady_state_compiles"),
    "serve_request": ("kind", "batch", "requests", "total_s",
                      "deadline_s"),
    "serve_slo": ("short_s", "overall", "alert", "burn_short",
                  "burn_long", "targets", "verdicts"),
    "serve_summary": ("pad_rows", "max_queue_depth", "requests", "shed",
                      "executables", "slo", "drift"),
    # schema 13: every probed cell carries its analytic roofline stamp
    # (flop/hbm utilization at the measured s/wave, dominant bound) so
    # `obs explain` can say why the winner won -- obs/roofline.py
    "autotune_probe": ("bucket", "waves", "roofline"),
    "autotune_decision": ("bucket", "device_kind", "prior", "cells",
                          "margin", "overhead_s", "cache_hit",
                          "cache_path"),
    # dead writer (the band prior is gone) -- field set preserved for
    # the old-timeline renderer in obs/query.py
    "wave_band_escape": ("band_lo_mb", "band_hi_mb", "block_mb", "ncols",
                         "bin_pad"),
    # load_s / rss_growth_bytes ride in from the pre-binned open path;
    # row_range / world_size from a rank-sharded open (schema 12)
    "dataset_construct": ("source", "construct_s", "load_s",
                          "rss_growth_bytes", "row_range", "world_size"),
    "scaling": ("chips", "rows", "iters", "psum_bytes", "mode",
                "baseline_rows_per_sec", "rows_per_sec"),
    "mesh_shrink": ("reason", "checkpoint", "lost_ranks"),
    "checkpoint": ("path", "bytes", "world_size"),
    "utilization": ("flop_util", "hbm_util", "bound", "headroom_s",
                    "device_kind", "roof_source"),
    # schema 14: the drift rollup carries its top-k feature evidence
    # (per-feature psi/ks + most-shifted bins), the score-space
    # divergence, the input-anomaly counters and the alert state
    "drift": ("score_psi", "features", "score", "anomalies",
              "threshold", "alert"),
    "online_quality": ("auc", "pending", "ref_auc", "ref_logloss"),
    # schema 15: the open event carries the trigger's detail and the
    # ring seq it anchors to; the close carries the full correlation
    # rollup (per-kind counts + first/last occurrence) and the bundle
    # inventory
    "incident_open": ("it", "seq", "dir", "detail"),
    "incident_evidence": ("path", "bytes", "error", "it"),
    "incident_close": ("counts", "artifacts", "signal_detail", "dir",
                       "it", "window_s"),
    # schema 16: the window's top-K folded stacks (+ how many samples
    # the truncation dropped), per-thread-role / loop-stage / phase
    # sample totals, the iteration span covered, the self-measured
    # overhead fraction, and -- on a wedged sampler -- the error that
    # stopped it (``obs prof --check`` fails loud on it)
    "prof_profile": ("stacks", "truncated", "topk", "roles", "stages",
                     "phases", "iter_lo", "iter_hi", "overhead_frac",
                     "error", "source"),
    "run_end": ("status", "health", "compile_attr", "stragglers",
                # obs/merge.py merged-timeline summary
                "rank_report",
                # schema 15: incident digest ({opened, max_signals}) —
                # present whenever the engine ran, zeros included, so
                # the ledger records a real zero history
                "incidents"),
}

# -- run provenance ------------------------------------------------------
# Stamped into every run_header: the git rev (and whether the tree was
# dirty), the host, and the argv that launched the run.  Cached per
# process: two git subprocesses once, never on the hot path.
_PROVENANCE = None
_PROVENANCE_LOCK = threading.Lock()


def _git(args):
    out = subprocess.run(["git"] + args, capture_output=True, text=True,
                         timeout=10)
    if out.returncode != 0:
        raise RuntimeError(out.stderr.strip() or "git rc=%d"
                           % out.returncode)
    return out.stdout


def collect_provenance(refresh=False):
    """{git_rev, git_dirty, hostname, argv} of this process, cached.
    Best-effort: outside a git work tree (or with git missing) git_rev is
    "" and git_dirty False; an observer never fails over where it was
    launched from."""
    global _PROVENANCE
    with _PROVENANCE_LOCK:
        if _PROVENANCE is not None and not refresh:
            return dict(_PROVENANCE)
        rev, dirty = "", False
        try:
            rev = _git(["rev-parse", "--short=12", "HEAD"]).strip()
            dirty = bool(_git(["status", "--porcelain",
                               "--untracked-files=no"]).strip())
        except Exception:
            rev, dirty = rev or "", bool(dirty)
        try:
            host = socket.gethostname()
        except Exception:
            host = ""
        # bounded: argv can carry long inline configs
        argv = [str(a)[:200] for a in sys.argv[:16]]
        _PROVENANCE = {"git_rev": rev, "git_dirty": dirty,
                       "hostname": host, "argv": argv}
        return dict(_PROVENANCE)


class RingBuffer:
    """Fixed-capacity ring of the most recent events (``obs_flight_events``
    of them): what the run was doing last (``RunObserver.ring_snapshot``)."""

    def __init__(self, capacity=256):
        self.capacity = max(1, int(capacity))
        self._buf = collections.deque(maxlen=self.capacity)

    def append(self, rec):
        self._buf.append(rec)

    def snapshot(self):
        """List copy of the records, oldest first."""
        return list(self._buf)


def validate_event(rec, strict=False):
    """Raise ValueError unless ``rec`` is a schema-valid event dict.

    Unknown event types pass by default (a reader of an older schema must
    not choke on a newer timeline); ``strict=True`` rejects them, for
    writers validating their own output."""
    if not isinstance(rec, dict):
        raise ValueError("event is not a dict: %r" % (rec,))
    ev = rec.get("ev")
    if ev not in _REQUIRED:
        if strict:
            raise ValueError("unknown event type %r" % (ev,))
        return rec
    for key in ("t", "run"):
        if key not in rec:
            raise ValueError("event %r missing %r" % (ev, key))
    missing = [k for k in _REQUIRED[ev] if k not in rec]
    if missing:
        raise ValueError("event %r missing keys %s" % (ev, missing))
    if ev == "run_header":
        if rec["schema"] not in _ACCEPTED_SCHEMAS:
            raise ValueError("unsupported schema version %r"
                             % (rec["schema"],))
        # schema 10 declares run provenance; older headers predate it
        if isinstance(rec["schema"], int) and rec["schema"] >= 10 \
                and "provenance" not in rec:
            raise ValueError("run_header schema %r missing provenance"
                             % (rec["schema"],))
    return rec


def read_events(path, validate=True):
    """Parse a JSONL event file into a list of dicts."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            if validate:
                validate_event(rec)
            out.append(rec)
    return out


class EventWriter:
    """Append-mode JSONL writer, flushed every ``flush_every`` events,
    every ``flush_interval_s`` (checked when an event arrives) and on
    close, so a killed run still leaves a readable timeline.  ``run_end``
    is flushed the moment it is written; ``fsync=True`` (``obs_fsync``)
    also fsyncs there and on close.  Writes are serialized by a lock."""

    def __init__(self, path, flush_every=16, fsync=False,
                 flush_interval_s=1.0):
        self.path = str(path)
        self.flush_every = max(1, int(flush_every))
        self.flush_interval_s = max(0.0, float(flush_interval_s or 0.0))
        self.fsync = bool(fsync)
        self._f = None
        self._pending = 0
        self._last_flush = time.monotonic()
        self._lock = threading.Lock()

    def emit(self, rec):
        with self._lock:
            if self._f is None:
                d = os.path.dirname(self.path)
                if d:
                    os.makedirs(d, exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write(json.dumps(rec, default=str) + "\n")
            self._pending += 1
            if self._pending >= self.flush_every \
                    or rec.get("ev") == "run_end" \
                    or (self.flush_interval_s > 0.0
                        and time.monotonic() - self._last_flush
                        >= self.flush_interval_s):
                self._flush_locked(sync=(self.fsync and
                                         rec.get("ev") == "run_end"))

    def _flush_locked(self, sync=False):
        self._f.flush()
        self._pending = 0
        self._last_flush = time.monotonic()
        if sync:
            try:
                os.fsync(self._f.fileno())
            except OSError:
                pass

    def flush(self):
        with self._lock:
            if self._f is not None:
                self._flush_locked(sync=self.fsync)

    def close(self):
        with self._lock:
            if self._f is not None:
                self._flush_locked(sync=self.fsync)
                self._f.close()
                self._f = None


class NullObserver:
    """The disabled observer: every hook is a no-op.  One shared instance
    (NULL_OBSERVER) sits on the booster, the learner and the serving tier
    by default, so the enabled check is one attribute load."""

    enabled = False
    timeline = ()
    health = None
    rank = 0
    world_size = 1

    def event(self, ev, **fields):
        pass

    def iter_begin(self, it):
        pass

    def lap(self, name, value=None):
        pass

    def iter_end(self, it, value=None, **fields):
        pass

    def entry_start(self):
        return 0.0

    def entry_end(self, name, t0, value=None):
        pass

    def flush(self):
        pass

    def close(self, status="ok"):
        pass

    # hooks of the JAX package's watchdog, flight recorder and incident
    # engine, which the serving tier calls; not in the port yet
    def add_flight_provider(self, fn):
        pass

    def remove_flight_provider(self, fn):
        pass

    def watchdog_arm(self, label):
        pass

    def watchdog_disarm(self):
        pass

    def incident_signal(self, kind, detail=None):
        return None


NULL_OBSERVER = NullObserver()


class RunObserver(NullObserver):
    """Live observer: drives the phase clock, entry timers, memory
    sampler, trace window and health monitors, and appends every event to
    the in-memory ``timeline`` (Booster.telemetry()), the ring and the
    JSONL writer."""

    enabled = True

    def __init__(self, events_path="", timing="phase", memory_every=0,
                 trace_iters="", trace_dir="", flush_every=16,
                 health=None, metrics_every=0, metrics_path="",
                 fsync=False, flight_events=256):
        from . import metrics as metrics_mod
        self.run_id = os.urandom(4).hex()
        self.timing = timing
        self.timeline = []
        self.events_path = str(events_path or "")
        self._writer = (EventWriter(self.events_path, flush_every,
                                    fsync=fsync)
                        if self.events_path else None)
        self._ring = RingBuffer(flight_events)
        self._seq = 0
        self._clock = PhaseClock(fence_laps=(timing == "phase"))
        self._entries = EntryTimers()
        self._memory = MemorySampler(memory_every)
        self._trace = TraceWindow(trace_iters, trace_dir)
        self._iters = 0
        self._closed = False
        self.health = health                 # HealthMonitors or None
        self._metrics_every = max(0, int(metrics_every))
        self._metrics_path = str(metrics_path or "")
        self._registry = metrics_mod.REGISTRY
        self._m_iter_s = self._registry.histogram(
            "lgbm_train_iter_seconds",
            "per-iteration wall time as timed by the run observer "
            "(fencing per obs_timing)")
        self._m_iters = self._registry.counter(
            "lgbm_train_iterations_total", "boosting iterations completed")
        # a killed run must still end in a flushed, parseable timeline
        atexit.register(self._finalize_at_exit)

    # -- raw emission --------------------------------------------------
    def event(self, ev, **fields):
        rec = {"ev": ev, "t": time.time(), "run": self.run_id}
        rec.update(fields)
        self.timeline.append(rec)
        self._ring.append(rec)
        if self._writer is not None:
            self._writer.emit(rec)
        return rec

    def ring_snapshot(self):
        return self._ring.snapshot()

    def run_header(self, backend, devices, params, context):
        self.event("run_header", schema=SCHEMA_VERSION, backend=backend,
                   devices=devices, params=params, context=context,
                   timing=self.timing, rank=self.rank,
                   world_size=self.world_size, coordinator="",
                   provenance=collect_provenance())

    # -- per-iteration hooks ------------------------------------------
    def iter_begin(self, it):
        self._trace.maybe_start(it, self)
        self._clock.begin()

    def lap(self, name, value=None):
        self._clock.lap(name, value)

    def iter_end(self, it, value=None, **fields):
        if self.timing in ("phase", "iter"):
            fence(value)
        total, phases = self._clock.end()
        seq = self._seq
        self._seq += 1
        self._iters += 1
        self._m_iter_s.observe(total)
        self._m_iters.inc()
        self.event("iter", it=it, seq=seq, time_s=total, phases=phases,
                   fenced=(self.timing in ("phase", "iter")), **fields)
        devices = self._memory.maybe(it)
        if devices is not None:
            self.event("memory", it=it, devices=devices)
            for d in devices:
                if "bytes_in_use" in d:
                    self._registry.gauge(
                        "lgbm_device_bytes_in_use",
                        "device allocator bytes in use at the last snapshot",
                        labels={"device": str(d["id"])}).set(
                            d["bytes_in_use"])
        if self.health is not None and self.health.due(it):
            # may raise under obs_health=fatal: the iter event above and
            # the writer flush in the monitor keep the timeline parseable
            self.health.check_memory(self, it, devices)
        if self._metrics_every and it % self._metrics_every == 0:
            self.event("metrics", it=it, scrape=self._registry.snapshot())
        self._trace.maybe_stop(it, self)

    # -- entry points (tree_grow, fused_iter) --------------------------
    def entry_start(self):
        return time.perf_counter()

    def entry_end(self, name, t0, value=None):
        fenced = self.timing == "phase"
        if fenced:
            fence(value)
        dt = time.perf_counter() - t0
        if self._entries.record(name, dt):
            self.event("compile", entry=name, first_call_s=dt, fenced=fenced)

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self, status="ok"):
        if self._closed:
            return
        self._closed = True
        try:
            atexit.unregister(self._finalize_at_exit)
        except Exception:
            pass
        self._trace.force_stop(self)
        if self._metrics_every or self._metrics_path:
            self.event("metrics", it=self._iters,
                       scrape=self._registry.snapshot())
        end = {"iters": self._iters, "phase_totals": self._clock.totals(),
               "entries": self._entries.summary(), "status": status}
        if self.health is not None:
            end["health"] = self.health.summary()
        self.event("run_end", **end)
        if self._metrics_path:
            try:
                self._registry.write(self._metrics_path)
                Log.debug("obs: metrics export -> %s", self._metrics_path)
            except OSError as e:
                Log.warning("obs: metrics export to %s failed: %s",
                            self._metrics_path, e)
        if self._writer is not None:
            self._writer.close()
            Log.debug("obs: wrote %d events to %s", len(self.timeline),
                      self._writer.path)

    def _finalize_at_exit(self):
        """atexit hook: a run that never reached close (crash, sys.exit)
        ends aborted but parseable."""
        try:
            self.close(status="aborted")
        except Exception:
            pass
