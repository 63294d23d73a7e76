"""Run telemetry of the port: the event timeline, the metrics registry,
the health monitors and the serving SLO engine.

The port's copy of the JAX package's ``obs`` core:

* ``events``  -- the versioned JSONL timeline (run header, per-iteration
  phase records, memory snapshots, health verdicts, metrics snapshots,
  the autotuner's probes and decision) and the ``RunObserver`` facade the
  training loop drives, with the shared ``NULL_OBSERVER`` by default;
* ``timers``  -- phase clocks and per-entry timers that wait for the card
  (``fence``, counted in ``fence_count``) where the timing mode asks;
* ``memory``  -- per-device ``torch.cuda.memory_stats`` snapshots;
* ``profile`` -- ``torch.profiler`` windows over chosen iterations
  (``obs_trace_iters=a:b`` + ``obs_trace_dir``);
* ``health``  -- non-finite guards, EMA divergence/plateau, the memory
  watermark (``obs_health=off/warn/fatal``);
* ``model``   -- ``split_audit`` and top-k ``importance`` events
  (``obs_split_audit``, ``obs_importance_every``), read back by
  ``Booster.importance_history``;
* ``dataquality`` -- the ``data_profile`` event of a constructed Dataset;
* ``roofline`` -- the device-peak registry and the autotuner's probe
  stamps;
* ``metrics`` -- process counters, gauges and histograms;
* ``serve``   -- the serving tier's SLO engine;
* ``compile`` -- compile attribution: graph captures and the kernels'
  first build as ``compile_attr`` events with signatures, diffs and the
  captured launches' cost (``obs_compile``);
* ``watchdog`` -- the hang watchdog and flight recorder
  (``obs_watchdog_secs``, SIGTERM, ``obs_health=fatal``);
* ``ledger``  -- the cross-run ledger (``obs_ledger_dir``,
  ``obs_ledger_suite``, ``obs_ledger_window``);
* ``live``    -- the in-run scrape server (``obs_http_port``,
  ``obs_http_addr``: ``/metrics``, ``/healthz``, ``/statusz``,
  ``/events``) and ``obs watch``;
* ``drift``   -- the training-time fingerprint and the serving-time
  ``DriftMonitor`` (``obs_drift_*``);
* ``incident`` -- the incident engine (``obs_incident*``);
* ``prof``    -- the continuous host sampling profiler (``obs_prof_*``);
* ``query``   -- ``python -m lightgbm_tpu_torch obs summary|explain|
  diff|trace|recompiles|roofline|serve|drift|incident|watch|prof|
  history|trend``.

* ``straggler`` -- the per-rank arrival skew of the distributed
  learners (``obs_straggler_every``, ``obs_straggler_warn_skew``);
* ``merge``   -- the cross-rank merge of per-rank timeline shards and
  its skew report (``obs merge|stragglers``).

Distributed runs are rank-native (schema 4): each rank writes its own
timeline shard (``obs_events_path`` + ``.r{rank}``), every event carries
the rank, and the run header records rank, world_size and coordinator.
Every ``obs_*`` key acts as in the JAX package.
"""
from __future__ import annotations

import os

from ..utils.log import Log
from .events import (NULL_OBSERVER, SCHEMA_VERSION, EventWriter,
                     NullObserver, RingBuffer, RunObserver,
                     collect_provenance, read_events, validate_event)
from .health import HealthMonitors
from .metrics import REGISTRY, MetricsRegistry

__all__ = ["NULL_OBSERVER", "NullObserver", "RunObserver", "EventWriter",
           "RingBuffer", "SCHEMA_VERSION", "read_events", "validate_event",
           "collect_provenance", "observer_from_config",
           "HealthMonitors", "MetricsRegistry", "REGISTRY"]

_TIMING_MODES = ("auto", "phase", "iter", "off")
_HEALTH_MODES = ("off", "warn", "fatal")

def observer_from_config(config, comm=None):
    """RunObserver from the ``obs_*`` params, or NULL_OBSERVER when
    nothing is enabled (the disabled path costs one attribute check).

    ``comm``: the ranks' HostComm (parallel/comm.py) of a distributed
    learner: the observer shards its timeline for that rank
    (``obs_events_path`` takes ``.r{rank}``), stamps every event with it
    and samples the ranks' skew over it (``obs_straggler_every``).
    Without one the rank comes from the thread's or the process's comm
    context, else rank 0 of 1.

    ``obs_timing``: 'phase' waits for the card at every phase boundary
    (device-accurate phase times, at the price of the launch queue's
    overlap); 'iter' waits once an iteration (accurate iteration totals,
    phases are launch times); 'off' records wall times without waiting;
    'auto' = 'phase'.

    Any of ``obs_events_path`` / ``obs_trace_iters`` /
    ``obs_memory_every`` / ``obs_health`` (not off) / ``obs_metrics_path``
    / ``obs_metrics_every`` / ``obs_compile`` / ``obs_split_audit`` /
    ``obs_importance_every`` / ``obs_ledger_dir`` /
    ``obs_utilization_every`` / ``obs_http_port`` (>= 0) /
    ``obs_drift_every`` / ``obs_incident`` enables the observer, as in
    the JAX package; health, metrics, compile and model tracking work
    without an events path (the in-memory timeline of
    Booster.telemetry()).  ``obs_watchdog_secs`` and the profiler's
    ``obs_prof_hz`` (default 29) ride on an otherwise enabled observer;
    a non-empty ``obs_ledger_dir`` ingests the finished run into the
    cross-run ledger on a clean close."""
    events_path = str(config.obs_events_path or "")
    trace_iters = str(config.obs_trace_iters or "")
    memory_every = int(config.obs_memory_every or 0)
    health_mode = str(config.obs_health or "off").strip().lower()
    if health_mode not in _HEALTH_MODES:
        Log.fatal("Unknown obs_health %s (expected off/warn/fatal)",
                  health_mode)
    metrics_path = str(config.obs_metrics_path or "")
    metrics_every = int(config.obs_metrics_every or 0)
    compile_attr = bool(config.obs_compile)
    ledger_dir = str(config.obs_ledger_dir or "")
    utilization_every = int(config.obs_utilization_every or 0)
    drift_every = int(config.obs_drift_every or 0)
    incident = bool(config.obs_incident)
    straggler_every = int(config.obs_straggler_every or 0)
    # -1 = off; 0 is a real value (an ephemeral port)
    http_port = -1 if config.obs_http_port is None \
        else int(config.obs_http_port)
    if (not events_path and not trace_iters and memory_every <= 0
            and health_mode == "off" and not metrics_path
            and metrics_every <= 0 and not compile_attr
            and not bool(config.obs_split_audit)
            and int(config.obs_importance_every or 0) <= 0
            and not ledger_dir and utilization_every <= 0
            and http_port < 0 and drift_every <= 0 and not incident
            and straggler_every <= 0):
        return NULL_OBSERVER
    timing = str(config.obs_timing).strip().lower()
    if timing not in _TIMING_MODES:
        Log.fatal("Unknown obs_timing %s (expected auto/phase/iter/off)",
                  timing)
    if timing == "auto":
        timing = "phase"
    if events_path and os.path.isdir(events_path):
        Log.fatal("obs_events_path %s is a directory (the timeline is a "
                  "JSONL file)", events_path)
    trace_dir = str(config.obs_trace_dir or "")
    if trace_iters and not trace_dir:
        Log.fatal("obs_trace_iters requires obs_trace_dir (where the "
                  "torch.profiler trace is written)")
    health = None
    if health_mode != "off":
        health = HealthMonitors(
            mode=health_mode, every=int(config.obs_health_every or 1),
            divergence=float(config.obs_health_divergence or 0.0),
            plateau=int(config.obs_health_plateau or 0),
            mem_frac=float(config.obs_health_mem_frac or 0.0))
    return RunObserver(
        events_path=events_path, timing=timing, memory_every=memory_every,
        trace_iters=trace_iters, trace_dir=trace_dir,
        flush_every=int(config.obs_flush_every or 16), health=health,
        metrics_every=metrics_every, metrics_path=metrics_path,
        compile_attr=compile_attr, fsync=bool(config.obs_fsync),
        watchdog_secs=float(config.obs_watchdog_secs or 0.0),
        flight_events=int(config.obs_flight_events or 256),
        ledger_dir=ledger_dir,
        ledger_suite=str(config.obs_ledger_suite or ""),
        utilization_every=utilization_every,
        roofline_peaks=str(config.obs_roofline_peaks or ""),
        http_port=(http_port if http_port >= 0 else None),
        http_addr=str(config.obs_http_addr or "127.0.0.1"),
        incident=incident,
        incident_window_s=float(config.obs_incident_window_s or 5.0),
        incident_dir=str(config.obs_incident_dir or ""),
        incident_trace=bool(config.obs_incident_trace),
        prof_hz=int(config.obs_prof_hz or 0),
        prof_window_s=float(config.obs_prof_window_s or 5.0),
        prof_topk=int(config.obs_prof_topk or 20),
        straggler_every=straggler_every,
        straggler_warn_skew=float(config.obs_straggler_warn_skew or 0.5),
        comm=comm,
        **({} if comm is None else {
            "rank": int(comm.rank), "world_size": int(comm.size),
            "coordinator": str(comm.coordinator or "")}))
