"""Structured JSONL event timeline for training runs.

The port's copy of the JAX package's ``obs/events.py``: the same schema
(``SCHEMA_VERSION``, the ``_REQUIRED`` and ``_OPTIONAL`` tables), so a
timeline written by either package validates and reads in the other.
One line per event, append-only.  Every record carries ``ev`` (type),
``t`` (unix time) and ``run`` (random id); several runs may share one
file (cv folds) and readers group by ``run``.  The event types and
their keys are the tables below; docs/Observability.md describes them.

``RunObserver`` is the facade the training loop and the serving tier
drive: the phase clock, the entry timers, memory snapshots, the trace
window (obs/profile.py), health (obs/health.py), metrics snapshots of
the process registry (obs/metrics.py), compile attribution
(obs/compile.py: in the port a compile is a CUDA graph capture or the
kernels' first build), the roofline rollup (obs/roofline.py), the hang
watchdog and flight recorder (obs/watchdog.py), the live scrape server
(obs/live.py), the incident engine (obs/incident.py), the sampling
profiler (obs/prof.py) and the cross-run ledger (obs/ledger.py).
``NULL_OBSERVER`` is the shared disabled instance: every method is a
no-op, so the hot path pays one attribute check and an empty call, with
no fencing and no event objects.  ``straggler_sample`` runs the
distributed learners' per-rank skew sampler (obs/straggler.py) on its
cadence.

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
from .memory import MemorySampler, device_memory_stats
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

# fields event()/emit() stamp on every record regardless of type
_COMMON_FIELDS = ("ev", "t", "run", "rank")


def declared_fields(ev):
    """Frozenset of every field the schema knows for ``ev`` (required +
    optional + common), or None for an unknown event type.  The static
    analyzer keys its unknown-field rule on this."""
    if ev not in _REQUIRED:
        return None
    return frozenset(_REQUIRED[ev]) | frozenset(_OPTIONAL.get(ev, ())) \
        | frozenset(_COMMON_FIELDS)


# -- run provenance ------------------------------------------------------
# Stamped into every schema-10 run_header: the git rev (and whether the
# tree was dirty), the host, and the CLI argv that launched the run.
# This is the attribution key of the cross-run ledger (obs/ledger.py) —
# a change-point in a metric trend is blamed on the first git rev that
# shifted it — and on its own turns any flight record into "what code,
# where, launched how".  Cached per process: two git subprocesses once,
# never on the hot path.
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

    Best-effort by design: outside a git work tree (or with git missing)
    ``git_rev`` is ``""`` and ``git_dirty`` False — a run observer must
    never fail because of where it was launched from."""
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
        # bounded: argv can carry huge inline configs; the ledger and
        # flight records only need "what command was this"
        argv = [str(a)[:200] for a in sys.argv[:16]]
        _PROVENANCE = {"git_rev": rev, "git_dirty": dirty,
                       "hostname": host, "argv": argv}
        return dict(_PROVENANCE)


def resolve_rank_path(path, rank, world_size):
    """Per-rank shard path from the ``obs_events_path`` template.

    An explicit ``{rank}`` placeholder is always substituted; otherwise
    multi-rank runs (world_size > 1) auto-suffix ``.r{rank}`` so N ranks
    never interleave writes into one file, and single-process runs keep
    the configured path byte-for-byte."""
    path = str(path or "")
    if not path:
        return path
    if "{rank}" in path:
        return path.replace("{rank}", str(int(rank)))
    if int(world_size or 1) > 1:
        return "%s.r%d" % (path, int(rank))
    return path


class RingBuffer:
    """Fixed-capacity ring of the most recent events — the flight
    recorder's view of "what was the run doing right before it died".
    Appends are lock-free (GIL-atomic deque ops) because the watchdog
    thread snapshots while rank threads append.

    Every append is stamped with a process-lifetime monotonic sequence
    number so the live /events endpoint (obs/live.py) can hand scrapers
    a resumable cursor (``tail(after)``) instead of re-sending the
    whole ring each poll.  The counter is best-effort under concurrent
    appends — a duplicated seq costs a tailer one duplicate or skipped
    event, never a corrupt record."""

    def __init__(self, capacity=256):
        self.capacity = max(1, int(capacity))
        self._buf = collections.deque(maxlen=self.capacity)
        self.dropped = 0
        self._seq = 0

    def append(self, rec):
        if len(self._buf) == self._buf.maxlen:
            self.dropped += 1
        self._seq += 1
        self._buf.append((self._seq, rec))

    def snapshot(self):
        """List copy of the records, oldest first."""
        return [rec for _, rec in list(self._buf)]

    @property
    def last_seq(self):
        return self._seq

    def tail(self, after=0):
        """(last_seq, records with seq > ``after``, oldest first) — the
        cursor contract of the /events?after=N endpoint."""
        items = list(self._buf)
        return self._seq, [rec for s, rec in items if s > int(after)]

    def __len__(self):
        return len(self._buf)


# -- live-observer registry ----------------------------------------------
# Each RunObserver registers itself per creating thread, plus a
# process-global list for main-thread lookups and SIGTERM flight dumps
# (obs/watchdog.py).
_TLS = threading.local()
_LIVE = []
_LIVE_LOCK = threading.Lock()


def _register_observer(obs):
    _TLS.observer = obs
    with _LIVE_LOCK:
        _LIVE.append(obs)


def _unregister_observer(obs):
    if getattr(_TLS, "observer", None) is obs:
        _TLS.observer = None
    with _LIVE_LOCK:
        try:
            _LIVE.remove(obs)
        except ValueError:
            pass


def current_observer():
    """The live observer of the calling thread (its simulated rank), or —
    only from the main thread, where cross-wiring is impossible — the
    most recent live observer."""
    obs = getattr(_TLS, "observer", None)
    if obs is not None and not obs._closed:
        return obs
    if threading.current_thread() is threading.main_thread():
        with _LIVE_LOCK:
            for cand in reversed(_LIVE):
                if not cand._closed:
                    return cand
    return None


def live_observers():
    """All live observers (flight-dump fan-out on SIGTERM)."""
    with _LIVE_LOCK:
        return [o for o in _LIVE if not o._closed]


def _default_rank_info():
    """Process rank for an observer that was not told one: the comm rank
    context of this thread (a run_ranks rank) or process (a
    TorchDistComm; parallel/comm.py), else rank 0 of 1."""
    from ..parallel.comm import rank_context
    info = rank_context()
    if info is not None:
        return info
    return {"rank": 0, "world_size": 1, "coordinator": ""}


def validate_event(rec, strict=False):
    """Raise ValueError unless ``rec`` is a schema-valid event dict.

    Unknown event types pass untouched by default — a v3 reader must not
    choke on a v4 timeline (forward compatibility is why the schema is
    versioned at all).  ``strict=True`` additionally rejects unknown
    ``ev`` values, for writers validating their own output.
    """
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
    """Append-mode JSONL writer, flushed every ``flush_every`` events
    (and on close) so a killed run still leaves a readable timeline.

    A monotonic-clock interval (``flush_interval_s``, ~1 s) flushes
    alongside the count trigger: a live tailer (``obs watch``, the
    /events endpoint's file-based cousins) sees events promptly during
    slow iterations instead of up to ``flush_every`` events late.  The
    clock is only consulted when an emit arrives — an idle writer costs
    nothing.

    ``run_end`` is flushed UNCONDITIONALLY the moment it is emitted,
    whatever ``flush_every`` says — a crash right after finalize must
    not lose the one record every reader keys on.  ``fsync=True``
    (``obs_fsync``) additionally fsyncs on those barriers, surviving
    OS-level death (OOM-kill, node power loss), not just interpreter
    death.  Emits are lock-serialized: the hang watchdog writes its
    final events from its own thread."""

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

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class NullObserver:
    """The disabled observer: every hook is a no-op.  A single shared
    instance (NULL_OBSERVER) sits on GBDT/learner objects by default so
    the enabled check is one attribute load."""

    enabled = False
    timeline = ()
    health = None
    rank = 0
    world_size = 1
    _closed = False
    live_url = ""

    def event(self, ev, **fields):
        pass

    def ensure_live_server(self, port, addr="127.0.0.1"):
        return ""

    def ring_tail(self, after=0):
        return 0, []

    def watchdog_arm(self, label):
        pass

    def watchdog_disarm(self):
        pass

    def flight(self, reason, extra=None):
        pass

    def add_flight_provider(self, fn):
        pass

    def remove_flight_provider(self, fn):
        pass

    def incident_signal(self, kind, detail=None):
        return None

    def incidents(self):
        return {"enabled": False, "open": [], "closed": []}

    def stamp_context(self, **fields):
        pass

    def prof_arm(self):
        return None

    def prof_disarm(self):
        pass

    def iter_begin(self, it):
        pass

    def lap(self, name, value=None):
        pass

    def iter_end(self, it, value=None, **fields):
        pass

    def entry_start(self):
        return 0.0

    def entry_args(self, name, fn, args, names=None, donate=()):
        pass

    def capture(self, name, args, names=None, seconds=0.0, cost=None):
        pass

    def entry_end(self, name, t0, value=None):
        pass

    def straggler_sample(self, it, value):
        pass

    def memory_snapshot(self, it):
        pass

    def flush(self):
        pass

    def close(self, status="ok"):
        pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(status="aborted" if exc_type is not None else "ok")
        return False


NULL_OBSERVER = NullObserver()


class RunObserver(NullObserver):
    """Live observer: drives the phase clock, entry timers, memory
    sampler and trace window, and appends every event to both the
    in-memory ``timeline`` (exposed via Booster.telemetry() and the
    record_telemetry callback) and the JSONL writer."""

    enabled = True

    def __init__(self, events_path="", timing="phase", memory_every=0,
                 trace_iters="", trace_dir="", flush_every=16,
                 health=None, metrics_every=0, metrics_path="",
                 compile_attr=False, rank=None, world_size=None,
                 coordinator="", fsync=False, watchdog_secs=0.0,
                 flight_events=256, ledger_dir="", ledger_suite="",
                 utilization_every=0, roofline_peaks="",
                 http_port=None, http_addr="127.0.0.1",
                 incident=False, incident_window_s=5.0,
                 incident_dir="", incident_trace=False,
                 prof_hz=0, prof_window_s=5.0, prof_topk=20,
                 straggler_every=0, straggler_warn_skew=0.5, comm=None):
        from . import metrics as metrics_mod
        if rank is None or world_size is None:
            info = _default_rank_info()
            rank = info["rank"] if rank is None else rank
            world_size = (info["world_size"] if world_size is None
                          else world_size)
            coordinator = coordinator or info.get("coordinator", "")
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.coordinator = str(coordinator or "")
        self.run_id = os.urandom(4).hex()
        self.timing = timing
        self.timeline = []
        self.events_path = resolve_rank_path(events_path, self.rank,
                                             self.world_size)
        self._writer = (EventWriter(self.events_path, flush_every,
                                    fsync=fsync)
                        if self.events_path else None)
        self._ring = RingBuffer(flight_events)
        self._flight_dumped = False
        self._flight_providers = []
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
        self._compile = None
        self._captured = set()           # entries captured at least once
        if compile_attr:
            from .compile import CompileTracker
            self._compile = CompileTracker(self._registry)
        # roofline rollup cadence (obs_utilization_every): needs the
        # compile tracker's cost estimates, so it implies obs_compile
        self._utilization_every = max(0, int(utilization_every or 0))
        self._roofline_peaks_path = str(roofline_peaks or "")
        self._roofline_peaks = None          # resolved lazily, once
        if self._utilization_every and self._compile is None:
            from .compile import CompileTracker
            self._compile = CompileTracker(self._registry)
        self._m_iter_s = self._registry.histogram(
            "lgbm_train_iter_seconds",
            "per-iteration wall time as timed by the run observer "
            "(fencing per obs_timing)")
        self._m_iters = self._registry.counter(
            "lgbm_train_iterations_total", "boosting iterations completed")
        self._ledger_dir = str(ledger_dir or "")
        self._ledger_suite = str(ledger_suite or "")
        self._watchdog = None
        if float(watchdog_secs or 0.0) > 0.0:
            from .watchdog import Watchdog
            self._watchdog = Watchdog(self, float(watchdog_secs))
            self._watchdog.start()
        # host-side live state the scrape plane (obs/live.py) reads: the
        # server thread must never touch device values or fence
        self._header = None
        self._lifecycle = "startup"
        self._last_it = None
        self._ewma_iter_s = None
        self._last_utilization = None
        self._health_fatal = False
        # host-side run context stamped by the training loop
        # (stamp_context): what the run was doing, for /statusz and the
        # incident evidence bundle
        self._run_context = {}
        self._incident = None
        # the per-rank arrival-skew sampler (obs_straggler_every; a
        # collective over comm, obs/straggler.py)
        self._straggler = None
        if int(straggler_every or 0) > 0:
            from .straggler import StragglerProfiler
            self._straggler = StragglerProfiler(
                every=straggler_every, warn_skew=straggler_warn_skew,
                registry=self._registry, comm=comm)
        if incident:
            from .incident import IncidentEngine
            self._incident = IncidentEngine(
                self, window_s=float(incident_window_s or 5.0),
                bundle_dir=str(incident_dir or ""),
                trace=bool(incident_trace))
        # continuous host sampling profiler (obs/prof.py, schema 16):
        # constructed lazily by prof_arm() — the training loop arms it
        # at run start (models/gbdt.py) and close() disarms, flushing
        # the final window before run_end
        self._prof = None
        self._prof_hz = max(0, int(prof_hz or 0))
        self._prof_window_s = float(prof_window_s or 5.0)
        self._prof_topk = max(1, int(prof_topk or 20))
        self._live = None
        if http_port is not None and int(http_port) >= 0:
            self.ensure_live_server(int(http_port), http_addr)
        # a killed run must still end in a flushed, parseable timeline
        atexit.register(self._finalize_at_exit)
        _register_observer(self)

    # -- live telemetry plane (obs/live.py) -----------------------------
    @property
    def live_url(self):
        """URL of the in-run scrape server, or "" when the plane is off."""
        return self._live.url if self._live is not None else ""

    def ensure_live_server(self, port, addr="127.0.0.1"):
        """Start the live scrape server if it is not already up
        (``Booster.serve()`` calls this so a serving process exposes the
        same plane a training run does).  Returns the URL ("" when the
        observer is closed or the bind failed)."""
        if self._closed:
            return ""
        if self._live is not None:
            return self._live.url
        from .live import LiveServer
        self._live = LiveServer(self, port, addr)
        return self._live.start()

    def ring_tail(self, after=0):
        """(last_seq, records newer than ``after``) from the event ring
        — the /events endpoint's cursor read."""
        return self._ring.tail(after)

    # -- raw emission --------------------------------------------------
    def event(self, ev, **fields):
        rec = {"ev": ev, "t": time.time(), "run": self.run_id}
        if self.world_size > 1:
            rec["rank"] = self.rank
        rec.update(fields)
        # live-state captures for the scrape plane: two string compares
        # per event, host-only
        if ev == "utilization":
            self._last_utilization = rec
        elif ev == "health" and fields.get("status") == "fatal":
            self._health_fatal = True
        self.timeline.append(rec)
        self._ring.append(rec)
        if self._writer is not None:
            self._writer.emit(rec)
        # incident tap LAST, after the record landed: a signal that
        # opens an incident emits its own events re-entrantly and they
        # must sort after their trigger in the timeline
        if self._incident is not None:
            self._incident.observe(rec)
        return rec

    def run_header(self, backend, devices, params, context):
        self._header = self.event(
            "run_header", schema=SCHEMA_VERSION, backend=backend,
            devices=devices, params=params, context=context,
            timing=self.timing, rank=self.rank,
            world_size=self.world_size, coordinator=self.coordinator,
            provenance=collect_provenance())

    # -- per-iteration hooks ------------------------------------------
    def iter_begin(self, it):
        if self._straggler is not None:
            self._straggler.mark()
        self._lifecycle = "train"
        if self._watchdog is not None:
            self._watchdog.arm("iter %d" % it)
        self._trace.maybe_start(it, self)
        if self._incident is not None:
            self._incident.maybe_trace_start(it, self)
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
        self._last_it = int(it)
        self._ewma_iter_s = (total if self._ewma_iter_s is None
                             else 0.7 * self._ewma_iter_s + 0.3 * total)
        self._m_iter_s.observe(total)
        self._m_iters.inc()
        self.event("iter", it=it, seq=seq, time_s=total, phases=phases,
                   fenced=(self.timing in ("phase", "iter")), **fields)
        if self._watchdog is not None:
            self._watchdog.pet("iter %d done" % it)
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
            # may raise under obs_health=fatal — the iter event above and
            # the writer flush in the monitor keep the timeline parseable
            self.health.check_memory(self, it, devices)
        if self._metrics_every and it % self._metrics_every == 0:
            self.event("metrics", it=it, scrape=self._registry.snapshot())
        if self._utilization_every and it % self._utilization_every == 0:
            self._emit_utilization(it)
        self._trace.maybe_stop(it, self)
        if self._incident is not None:
            self._incident.maybe_trace_stop(it, self)

    def _emit_utilization(self, it):
        """The schema-13 roofline rollup (obs/roofline.py): exec-weighted
        achieved/peak utilization of every timed entry with a cost
        estimate.  No fence, no device work — it joins numbers the
        observer already holds, so the cadence costs host time only."""
        from . import roofline
        if self._roofline_peaks is None:
            overrides = roofline.load_peak_overrides(
                self._roofline_peaks_path)
            self._roofline_peaks = roofline.peaks_for(
                roofline.device_kind(), overrides)
        rollup = roofline.utilization_rollup(
            self._entries.summary(),
            self._compile.costs() if self._compile is not None else {},
            self._roofline_peaks, world_size=self.world_size)
        if rollup is not None:
            self.event("utilization", it=it, **rollup)
            self._registry.gauge(
                "lgbm_flop_utilization",
                "exec-weighted achieved/peak FLOP fraction at the last "
                "utilization rollup").set(rollup["flop_util"])
            self._registry.gauge(
                "lgbm_hbm_utilization",
                "exec-weighted achieved/peak HBM-bandwidth fraction at "
                "the last utilization rollup").set(rollup["hbm_util"])

    # -- jitted entry points ------------------------------------------
    def entry_start(self):
        return time.perf_counter()

    def entry_args(self, name, fn, args, names=None, donate=()):
        """Pre-call hook (obs_compile): snapshot the entry's argument
        signature and the kernels' build count, so entry_end can
        attribute a first kernel build to the entry and name what
        changed since its last compile."""
        if self._compile is not None:
            self._compile.before_call(name, args, names=names)

    def capture(self, name, args, names=None, seconds=0.0, cost=None):
        """A CUDA graph capture of entry ``name`` over the tensors
        ``args`` (labels ``names``) took ``seconds``, its kernel launches
        costing ``cost`` ({flops, bytes_accessed}; obs/roofline.py
        ``launches_cost``): the port's compile.  A ``compile`` event
        for the entry's first capture and, under obs_compile, a
        ``compile_attr`` event for each."""
        if name not in self._captured:
            self._captured.add(name)
            self.event("compile", entry=name, first_call_s=seconds,
                       fenced=True)
        if self._compile is not None:
            self._compile.record_capture(name, args, self, names=names,
                                         cost=cost)

    def entry_end(self, name, t0, value=None):
        fenced = self.timing == "phase"
        if fenced:
            fence(value)
        dt = time.perf_counter() - t0
        if self._entries.record(name, dt):
            self.event("compile", entry=name, first_call_s=dt, fenced=fenced)
        if self._compile is not None:
            self._compile.after_call(name, self)

    # -- hang forensics (obs/watchdog.py) ------------------------------
    def watchdog_arm(self, label):
        """Arm the hang watchdog around a blocking region (a host
        collective): no progress for obs_watchdog_secs from now dumps a
        flight record naming ``label``."""
        if self._watchdog is not None:
            self._watchdog.arm(label)

    def watchdog_disarm(self):
        """The blocking region completed; fall back to the per-iteration
        progress deadline."""
        if self._watchdog is not None:
            self._watchdog.pet("idle")

    def flight(self, reason, extra=None):
        """Dump a flight record now (watchdog expiry, SIGTERM,
        obs_health=fatal).  Works with the watchdog off — the ring
        buffer is always live.  Returns the path written, or None when
        there is no events path to anchor the dump next to."""
        from .watchdog import dump_flight_record
        return dump_flight_record(self, reason, extra=extra)

    def add_flight_provider(self, fn):
        """Register a zero-arg callable returning a dict of live context
        to merge into every flight record (serve/scheduler.py registers
        its queue state here: depth, queued rows, pending routes).
        Providers must be best-effort — a provider that raises is
        skipped, never propagated into the dump."""
        self._flight_providers.append(fn)

    def remove_flight_provider(self, fn):
        try:
            self._flight_providers.remove(fn)
        except ValueError:
            pass

    def flight_context(self):
        """Merged provider dicts; forensics-grade best-effort."""
        out = {}
        for fn in list(self._flight_providers):
            try:
                out.update(fn() or {})
            except Exception as e:
                out.setdefault("provider_errors", []).append(repr(e))
        return out

    @property
    def flight_path(self):
        if self._writer is None:
            return ""
        return self._writer.path + ".flight.json"

    def ring_snapshot(self):
        return self._ring.snapshot()

    # -- incident engine (obs/incident.py) -----------------------------
    def incident_signal(self, kind, detail=None):
        """Feed one anomaly signal into the incident engine from a
        channel that does not emit timeline events itself (the serve
        scheduler's shed storm, the watchdog's near-expiry warning, the
        POST /trigger/incident operator endpoint).  Returns the open
        incident id, or None when the engine is off."""
        if self._incident is None:
            return None
        return self._incident.signal(str(kind), detail=detail)

    def incidents(self):
        """Open/closed incident listing for the /incidents endpoint."""
        if self._incident is None:
            return {"enabled": False, "open": [], "closed": []}
        return self._incident.listing()

    def stamp_context(self, **fields):
        """Update the host-side run-context dict (iteration, tree count,
        loop stage) that /statusz, incident evidence bundles and the
        sampling profiler's stage tags read — a plain dict update,
        never a fence."""
        self._run_context.update(fields)

    # -- continuous host profiler (obs/prof.py, schema 16) --------------
    def prof_arm(self):
        """Start the sampling profiler when ``obs_prof_hz > 0``
        (idempotent — the daemon thread is constructed once and
        restarted if a previous disarm stopped it).  Returns the
        profiler, or None when sampling is off or the observer closed."""
        if self._prof_hz <= 0 or self._closed:
            return None
        if self._prof is None:
            from .prof import HostProfiler
            self._prof = HostProfiler(
                emit=self.event, hz=self._prof_hz,
                window_s=self._prof_window_s, topk=self._prof_topk,
                context=self._run_context,
                phase_of=lambda: self._clock.current,
                iter_of=lambda: self._last_it)
        self._prof.start()
        return self._prof

    def prof_disarm(self):
        """Stop the sampler and flush its final partial window as a
        ``prof_profile`` event (idempotent; ``close()`` calls this
        before ``run_end`` so the last window sorts inside the run)."""
        if self._prof is not None:
            self._prof.stop()

    # -- misc ----------------------------------------------------------
    def straggler_sample(self, it, value):
        """Sampled per-rank arrival timing (obs_straggler_every): a fence
        and a host collective on the cadence, on every rank."""
        if self._straggler is not None and self._straggler.due(it):
            self._straggler.sample(self, it, value)

    def memory_snapshot(self, it):
        self.event("memory", it=it, devices=device_memory_stats())

    def flush(self):
        if self._writer is not None:
            self._writer.flush()

    def close(self, status="ok"):
        if self._closed:
            return
        self._lifecycle = "closed" if status == "ok" else "aborted"
        if status == "aborted" and not self._flight_dumped:
            # the flight record is the black box: write it BEFORE the
            # run_end path below can fail.  A record the watchdog (or
            # obs_health=fatal) already dumped names the actual hang —
            # don't overwrite it with this generic one.
            try:
                self.flight("run aborted")
            except Exception:
                pass
        self._closed = True
        if self._watchdog is not None:
            self._watchdog.stop()
        _unregister_observer(self)
        try:
            atexit.unregister(self._finalize_at_exit)
        except Exception:
            pass
        self._trace.force_stop(self)
        # stop the sampling profiler and flush its final window BEFORE
        # run_end so the last prof_profile sorts inside the run (and the
        # ledger's prof_overhead_frac cell sees every window)
        try:
            self.prof_disarm()
        except Exception:
            pass
        # close any open incident BEFORE run_end so incident_close sorts
        # inside the run; the digest rides on run_end (zeros included)
        incidents_digest = None
        if self._incident is not None:
            try:
                incidents_digest = self._incident.finalize()
            except Exception:
                incidents_digest = None
        metrics_on = self._metrics_every or self._metrics_path
        if metrics_on:
            self.event("metrics", it=self._iters,
                       scrape=self._registry.snapshot())
        end = {"iters": self._iters, "phase_totals": self._clock.totals(),
               "entries": self._entries.summary(), "status": status}
        if incidents_digest is not None:
            end["incidents"] = incidents_digest
        if self.health is not None:
            end["health"] = self.health.summary()
        if self._compile is not None:
            end["compile_attr"] = self._compile.summary()
        if self._straggler is not None:
            end["stragglers"] = self._straggler.summary()
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
        # cross-run ledger (obs_ledger_dir): only CLEAN runs become
        # baseline history — an aborted run's partial metrics would
        # poison the rolling statistics.  Best-effort: the ledger must
        # never take a finished run down.
        if self._ledger_dir and status == "ok":
            try:
                from .ledger import Ledger
                if Ledger(self._ledger_dir).ingest_events(
                        list(self.timeline), suite=self._ledger_suite):
                    Log.debug("obs: run %s ingested into ledger %s",
                              self.run_id, self._ledger_dir)
            except Exception as e:
                Log.warning("obs: ledger ingest into %s failed: %s",
                            self._ledger_dir, e)
        # live plane teardown LAST: /healthz and /statusz stay
        # scrapeable through finalize, then the ephemeral port frees
        if self._live is not None:
            self._live.stop()
            self._live = None

    def _finalize_at_exit(self):
        """atexit hook: a run that never reached finalize (crash, sys.exit,
        uncaught signal that still unwinds) ends aborted but parseable."""
        try:
            self.close(status="aborted")
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(status="aborted" if exc_type is not None else "ok")
        return False
