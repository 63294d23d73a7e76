"""Incident engine: anomaly-triggered evidence capture and triage.

The port's copy of the JAX package's ``obs/incident.py`` (pure stdlib).
Its trace evidence is a ``torch.profiler`` window (obs/profile.py) in
place of the JAX package's ``jax.profiler`` one; the straggler signal
is the distributed learners' ``straggler_skew`` health event
(obs/straggler.py).

The stack has ~a dozen independent detectors — health monitors
(obs/health.py), SLO burn-rate alerts (obs/serve.py), the straggler
profiler, the hang watchdog, recompile attribution, drift PSI
(obs/drift.py), serve-queue shedding — and each fires isolated warn
events.  Nobody watches the warn stream in production, and by the time
a human reads it the evidence (ring buffer, metrics, run context) has
rolled over.  The ``IncidentEngine`` closes that gap in-process:

* **Subscribe** — the engine taps ``RunObserver.event()`` and
  classifies every record (health warn/fatal transitions, drift alert
  firing, steady-state recompiles); channels with no timeline event of
  their own (shed storms in serve/scheduler.py, watchdog near-expiry,
  the operator's ``POST /trigger/incident``) feed it directly via
  ``RunObserver.incident_signal(kind, detail)``.

* **Debounce & group** — the first qualifying signal opens an incident
  (schema 15 ``incident_open``); further signals within
  ``obs_incident_window_s`` of the last one join the SAME incident
  (per-kind counts, first/last occurrence).  After a quiet window — or
  at observer close — the incident closes (``incident_close`` with the
  grouped rollup, the correlation table's source of truth).

* **Capture** — on open the engine writes a time-boxed evidence bundle
  into ``<obs_incident_dir>/<incident id>/``: the RingBuffer slice
  around the trigger seq, a metrics-registry snapshot, the merged
  flight-provider context, the latest utilization/roofline rollup, a
  /statusz-equivalent run snapshot and the watchdog's thread stacks —
  one ``incident_evidence`` event per artifact.  With
  ``obs_incident_trace=true`` and training mid-run it additionally
  arms a one-iteration ``torch.profiler`` trace window at the next
  ``iter_begin`` (PR-1 plumbing via obs/profile.py; never armed on the
  serve hot path — serving has no iteration to scope a window to).

Everything here is host-side: dict copies, JSON writes, zero fences —
the bench drills assert ``fence_count()`` is flat across an injected
incident.  Capture is forensics-grade best-effort (the
dump_flight_record contract): an artifact that fails to write becomes
an ``incident_evidence`` record with an ``error`` field, never an
exception into the run.

The reader half (``python -m lightgbm_tpu_torch obs incident <dir|timeline>
[--check]``) renders the triage report: grouped signals ordered by
first occurrence, a cross-subsystem correlation table, the evidence
inventory, and a root-cause ranking from a small deterministic
heuristic table.  ``--check`` is the CI gate: exit 1 when any incident
opened.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

from .metrics import REGISTRY
from ..utils.log import Log

# signal kind -> subsystem, for the cross-subsystem correlation table.
# Unknown kinds (a future detector) render as "other" — the table must
# not reject what the engine accepted.
_SUBSYSTEM = {
    "nonfinite_gradients": "train",
    "nonfinite_leaf_values": "train",
    "loss_divergence": "train",
    "plateau": "train",
    "memory_watermark": "device",
    "watchdog": "runtime",
    "watchdog_near_expiry": "runtime",
    "straggler_skew": "dist",
    "recompile": "compile",
    "slo_burn_rate": "serve",
    "shed_storm": "serve",
    "serve_input": "serve",
    "drift": "serve",
    "online_quality": "serve",
    "operator": "operator",
}

# Ordered root-cause heuristics: (required signal kinds, diagnosis).
# A rule matches when every kind in its set occurred; ranking prefers
# more-specific (larger) matches, then more observed signal events,
# then table order.  Deterministic by construction — same incident,
# same ranking, every time.
_ROOT_CAUSES = (
    (frozenset(("straggler_skew", "slo_burn_rate")),
     "straggler-induced latency: shard skew rose before the SLO burn — "
     "check the slowest device/rank in the straggler report"),
    (frozenset(("recompile", "slo_burn_rate")),
     "jit-cache thrash on the serving path: steady-state recompiles "
     "line up with the SLO burn — check bucket churn / axis diffs"),
    (frozenset(("shed_storm", "slo_burn_rate")),
     "sustained overload: offered load exceeds capacity and the "
     "shed storm coincides with the SLO burn — scale out or raise "
     "queue_limit/deadline"),
    (frozenset(("nonfinite_gradients",)),
     "numeric instability: non-finite gradients — check learning rate, "
     "objective inputs and feature ranges"),
    (frozenset(("nonfinite_leaf_values",)),
     "numeric instability: non-finite leaf values — check hessian "
     "floors and regularization (lambda_l2)"),
    (frozenset(("loss_divergence",)),
     "training divergence: loss rising across the guard window — "
     "check learning rate and label encoding"),
    (frozenset(("watchdog",)),
     "hang/stall: the progress watchdog expired — read the flight "
     "record's thread stacks for the blocked collective"),
    (frozenset(("watchdog_near_expiry",)),
     "near-stall: an iteration or collective approached the watchdog "
     "deadline — a straggler or host-side pause is eating the budget"),
    (frozenset(("shed_storm",)),
     "overload: the serve queue shed a burst of requests — offered "
     "load exceeds capacity for the configured queue_limit/deadline"),
    (frozenset(("recompile",)),
     "recompile in steady state: an entry's jit signature changed "
     "mid-run — check the compile_attr axis diff"),
    (frozenset(("drift", )),
     "input distribution shift: serving traffic diverged from the "
     "training fingerprint (PSI/KS) — retrain or fix upstream features"),
    (frozenset(("serve_input",)),
     "serving input anomalies: non-finite or out-of-range rows on the "
     "predict path — validate the caller's feature pipeline"),
    (frozenset(("online_quality",)),
     "online model-quality regression: joined-label metrics degraded "
     "vs the training baseline — likely concept drift or label skew"),
    (frozenset(("memory_watermark",)),
     "memory pressure: device allocator watermark crossed — reduce "
     "batch/bin widths or enable out-of-core ingest"),
    (frozenset(("slo_burn_rate",)),
     "SLO burn without a correlated cause in this incident — inspect "
     "the serve_slo windows and batch traces around the open seq"),
    (frozenset(("plateau",)),
     "convergence plateau: eval metric flat across the guard window — "
     "consider early stopping or a learning-rate change"),
)

_FALLBACK_CAUSE = ("uncorrelated anomaly: no heuristic matched this "
                   "signal set — read the evidence bundle")

# evidence-bundle ring-slice bounds: enough context to see the lead-up
# without turning every bundle into a full ring dump
_RING_BEFORE = 160
_RING_AFTER = 64

# bounded closed-incident history held for /incidents and /statusz
_MAX_CLOSED = 32


def classify_signal(rec):
    """Map one timeline record to an incident signal kind, or None.

    health warn/fatal carry their check name as the kind (watchdog,
    slo_burn_rate, drift, straggler_skew, nonfinite_* ... — every
    detector that routes through the health channel comes in here);
    compile_attr with a per-signature recompile is "recompile"; a drift
    rollup whose alert state machine is firing is "drift".  Everything
    else — the 99.9% hot path — returns None on two dict reads.
    """
    ev = rec.get("ev")
    if ev == "health":
        if rec.get("status") not in ("warn", "fatal"):
            return None
        check = str(rec.get("check") or "")
        if check in ("", "stats"):
            return None
        return check
    if ev == "compile_attr":
        try:
            if int(rec.get("sig_compiles") or 1) > 1:
                return "recompile"
        except (TypeError, ValueError):
            return None
        return None
    if ev == "drift" and rec.get("alert") == "firing":
        return "drift"
    return None


def evidence_ring_slice(ring, around_seq, before=_RING_BEFORE,
                        after=_RING_AFTER):
    """Records within ``(around_seq - before, around_seq + after]`` of
    the flight RingBuffer, oldest first, each wrapped as
    ``{"seq": n, **rec}``.

    Works on whatever the ring still holds: a wrapped-around buffer
    yields only the surviving window, a cold-start empty ring yields
    ``[]``, and a writer appending concurrently costs at most one
    duplicated/skipped seq (the RingBuffer contract) — never a corrupt
    slice.  The bundle stays valid in all three cases.
    """
    around_seq = int(around_seq)
    lo = around_seq - max(0, int(before))
    hi = around_seq + max(0, int(after))
    out = []
    for seq, rec in list(ring._buf):
        if lo < seq <= hi:
            row = {"seq": seq}
            row.update(rec)
            out.append(row)
    return out


def _atomic_write(path, text):
    """The dump_flight_record write discipline: tmp + rename so a
    crash mid-write never leaves a torn artifact, fsync so the bundle
    survives the process."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
        f.flush()
        try:
            os.fsync(f.fileno())
        except OSError:
            pass
    os.replace(tmp, path)
    return os.path.getsize(path)


class _Incident:
    """Mutable state of one open incident (engine-lock protected)."""

    def __init__(self, iid, kind, detail, it, now, seq, path):
        self.id = iid
        self.trigger = kind
        self.open_t = now
        self.last_t = now
        self.open_seq = int(seq)
        self.dir = path
        self.artifacts = []            # [{artifact, path, bytes|error}]
        # kind -> {count, first_t, last_t, first_it}; insertion order IS
        # first-occurrence order (the correlation table's ordering)
        self.signals = {}
        self.add(kind, detail, it, now)

    def add(self, kind, detail, it, now):
        self.last_t = now
        sig = self.signals.get(kind)
        if sig is None:
            self.signals[kind] = sig = {
                "kind": kind, "count": 0, "first_t": now, "last_t": now,
                "first_it": (int(it) if it is not None else None),
                "detail": detail if isinstance(detail, dict) else None}
        sig["count"] += 1
        sig["last_t"] = now

    def meta(self, status, close_t=None, window_s=None):
        out = {"id": self.id, "status": status, "trigger": self.trigger,
               "open_t": self.open_t, "open_seq": self.open_seq,
               "signals": list(self.signals.keys()),
               "counts": {k: s["count"] for k, s in self.signals.items()},
               "signal_detail": [dict(s) for s in self.signals.values()],
               "artifacts": [dict(a) for a in self.artifacts],
               "dir": self.dir}
        if window_s is not None:
            out["window_s"] = window_s
        if close_t is not None:
            out["close_t"] = close_t
            out["duration_s"] = round(close_t - self.open_t, 6)
        return out


class IncidentEngine:
    """Debounce, group and evidence-capture anomaly signals (see module
    docstring).  One engine per RunObserver; at most one incident open
    at a time — co-occurring anomalies are one operational event, which
    is the entire point."""

    def __init__(self, obs, window_s=5.0, bundle_dir="", trace=False):
        self._obs = obs
        self.window_s = max(0.1, float(window_s or 5.0))
        self.bundle_dir = str(bundle_dir or "") or (
            obs.events_path + ".incidents" if obs.events_path else "")
        self.trace_enabled = bool(trace)
        self._lock = threading.RLock()
        self._emitting = False         # re-entrancy guard for the tap
        self._open = None              # _Incident or None
        self._closed_hist = []         # bounded closed-incident metas
        self._counter = 0
        self._max_signals = 0
        # armed trace window: {"id", "dir"} when pending, plus
        # "active" once torch.profiler actually started
        self._trace_state = None
        self._m_opened = REGISTRY.counter(
            "lgbm_incidents_total",
            "incidents opened by the anomaly-correlation engine")
        self._g_open = REGISTRY.gauge(
            "lgbm_incident_open",
            "1 while an incident is open, else 0")
        obs.add_flight_provider(self._flight_state)

    # -- signal intake -------------------------------------------------
    def observe(self, rec):
        """The RunObserver.event() tap: classify one record, feed the
        grouper, and tick the quiet-window close.  Host-only, and on
        the non-anomalous path two dict reads + one None check."""
        with self._lock:
            if self._emitting:
                return
            kind = classify_signal(rec)
            if kind is not None:
                self._signal_locked(kind, self._signal_detail(rec, kind),
                                    rec.get("it"))
            elif (self._open is not None
                    and time.time() - self._open.last_t > self.window_s):
                self._close_locked(time.time())

    @staticmethod
    def _signal_detail(rec, kind):
        d = rec.get("detail")
        if isinstance(d, dict):
            return d
        if rec.get("ev") == "compile_attr":
            return {"entry": rec.get("entry"),
                    "sig_compiles": rec.get("sig_compiles")}
        if rec.get("ev") == "drift":
            return {"psi_max": rec.get("psi_max"),
                    "score_psi": rec.get("score_psi")}
        return None

    def signal(self, kind, detail=None, it=None):
        """External intake (RunObserver.incident_signal): channels with
        no timeline event of their own.  Returns the open incident id."""
        with self._lock:
            return self._signal_locked(str(kind), detail, it)

    def _signal_locked(self, kind, detail, it):
        now = time.time()
        if (self._open is not None
                and now - self._open.last_t > self.window_s):
            self._close_locked(now)
        if self._open is None:
            self._open_incident(kind, detail, it, now)
        else:
            self._open.add(kind, detail, it, now)
            self._max_signals = max(self._max_signals,
                                    len(self._open.signals))
        return self._open.id

    # -- open / close --------------------------------------------------
    def _open_incident(self, kind, detail, it, now):
        self._counter += 1
        iid = "%s-%03d" % (self._obs.run_id, self._counter)
        path = (os.path.join(self.bundle_dir, iid)
                if self.bundle_dir else "")
        inc = self._open = _Incident(iid, kind, detail, it, now,
                                     self._obs._ring.last_seq, path)
        self._max_signals = max(self._max_signals, 1)
        self._m_opened.inc()
        self._g_open.set(1)
        self._emit("incident_open", id=iid, trigger=kind,
                   signals=[kind], seq=inc.open_seq,
                   it=(int(it) if it is not None else -1),
                   dir=path, detail=detail)
        Log.warning("obs: incident %s opened (trigger: %s)%s", iid, kind,
                    " -> %s" % path if path else "")
        self._capture_open_evidence(inc)
        if self.trace_enabled and self._trace_state is None \
                and self._obs._lifecycle == "train" and path:
            # armed, not started: the profiler opens at the NEXT
            # iter_begin so the window scopes exactly one iteration —
            # and never on the serve path, which has no iterations
            self._trace_state = {"id": iid,
                                 "dir": os.path.join(path, "trace")}

    def _close_locked(self, now):
        inc, self._open = self._open, None
        self._g_open.set(0)
        self._capture_close_evidence(inc)
        meta = inc.meta("closed", close_t=now, window_s=self.window_s)
        self._write_meta(inc, meta)
        self._closed_hist.append(meta)
        del self._closed_hist[:-_MAX_CLOSED]
        self._emit("incident_close", id=inc.id,
                   duration_s=meta["duration_s"],
                   signals=meta["signals"], counts=meta["counts"],
                   signal_detail=meta["signal_detail"],
                   artifacts=[a["artifact"] for a in inc.artifacts],
                   dir=inc.dir, window_s=self.window_s)
        Log.warning("obs: incident %s closed after %.2fs (%d signal "
                    "kind(s): %s)", inc.id, meta["duration_s"],
                    len(meta["signals"]), ", ".join(meta["signals"]))
        # a trace armed for this incident but never started (no training
        # iteration arrived) is disarmed; an ACTIVE one is left for
        # maybe_trace_stop so the window still closes cleanly
        if (self._trace_state is not None
                and self._trace_state["id"] == inc.id
                and not self._trace_state.get("active")):
            self._trace_state = None

    def finalize(self):
        """Observer close: close any open incident, stop an active
        armed trace, detach the flight provider, and return the run_end
        digest — zeros included, so the ledger's ``incidents_opened``
        cell has a real zero history to change-point against."""
        with self._lock:
            if self._trace_state is not None \
                    and self._trace_state.get("active"):
                self._trace_stop_locked(-1)
            if self._open is not None:
                self._close_locked(time.time())
            self._obs.remove_flight_provider(self._flight_state)
            return {"opened": self._counter,
                    "max_signals": self._max_signals}

    # -- evidence capture ----------------------------------------------
    def _emit(self, ev, **fields):
        """Emit through the observer with the tap re-entrancy guard up:
        the engine's own events must not be classified as signals."""
        self._emitting = True
        try:
            self._obs.event(ev, **fields)
        finally:
            self._emitting = False

    def _artifact(self, inc, name, filename, payload):
        """Write one bundle artifact (JSON for dicts, JSONL for lists),
        record it in the incident, emit incident_evidence.  Best-effort:
        failure becomes an ``error`` field, never a raise."""
        entry = {"artifact": name}
        try:
            path = os.path.join(inc.dir, filename)
            if isinstance(payload, list):
                text = "".join(json.dumps(r, default=str) + "\n"
                               for r in payload)
            else:
                text = json.dumps(payload, indent=2, default=str) + "\n"
            entry["path"] = path
            entry["bytes"] = _atomic_write(path, text)
        except Exception as e:
            entry["error"] = repr(e)
        inc.artifacts.append(entry)
        self._emit("incident_evidence", id=inc.id, **entry)

    def _capture_open_evidence(self, inc):
        """The time-boxed bundle, captured at the moment of anomaly.
        Host-side only — dict copies and file writes, zero fences."""
        obs = self._obs
        if not inc.dir:
            return
        try:
            os.makedirs(inc.dir, exist_ok=True)
        except OSError as e:
            inc.artifacts.append({"artifact": "bundle_dir",
                                  "error": repr(e)})
            self._emit("incident_evidence", id=inc.id,
                       artifact="bundle_dir", error=repr(e))
            return
        self._artifact(inc, "ring", "ring.jsonl",
                       evidence_ring_slice(obs._ring, inc.open_seq))
        self._artifact(inc, "metrics", "metrics.json",
                       obs._registry.snapshot())
        self._artifact(inc, "flight_context", "flight_context.json",
                       obs.flight_context())
        if obs._last_utilization is not None:
            self._artifact(inc, "utilization", "utilization.json",
                           dict(obs._last_utilization))
        try:
            from .live import status_snapshot
            snap = status_snapshot(obs)
        except Exception as e:
            snap = {"error": repr(e)}
        self._artifact(inc, "statusz", "statusz.json", snap)
        try:
            from .watchdog import _thread_stacks
            stacks = _thread_stacks()
        except Exception as e:
            stacks = [{"error": repr(e)}]
        self._artifact(inc, "threads", "threads.json", stacks)
        # sampled profile window (obs/prof.py): WHERE the host was
        # spending time across the anomaly, not just the one-shot
        # stacks above.  Prefers the live profiler's current window
        # (free — samples already collected); falls back to a short
        # synchronous burst when the sampler is off.
        try:
            from .prof import evidence_profile
            profile = evidence_profile(obs)
        except Exception as e:
            profile = {"error": repr(e)}
        self._artifact(inc, "profile", "profile.json", profile)
        self._write_meta(inc, inc.meta("open", window_s=self.window_s))

    def _capture_close_evidence(self, inc):
        """What happened AFTER the trigger: the post-open ring tail."""
        if not inc.dir or not os.path.isdir(inc.dir):
            return
        _, post = self._obs._ring.tail(inc.open_seq)
        self._artifact(inc, "ring_post", "ring_post.jsonl",
                       post[:_RING_AFTER])

    def _write_meta(self, inc, meta):
        if not inc.dir or not os.path.isdir(inc.dir):
            return
        try:
            _atomic_write(os.path.join(inc.dir, "incident.json"),
                          json.dumps(meta, indent=2, default=str) + "\n")
        except Exception as e:
            Log.warning("obs: incident %s meta write failed: %s",
                        inc.id, e)

    # -- armed trace window (obs_incident_trace) -----------------------
    def maybe_trace_start(self, it, obs):
        """iter_begin hook: open the armed profiler window.  One
        None-check on the common path."""
        with self._lock:
            st = self._trace_state
            if st is None or st.get("active") or st.get("done"):
                return
            from . import profile
            try:
                profile.start_trace(st["dir"])
            except Exception as exc:
                Log.warning("obs: incident trace start failed: %s", exc)
                self._trace_state = None
                return
            st["active"] = True
            st["it"] = int(it)
            self._emit("trace_window", action="start", dir=st["dir"],
                       it=it)

    def maybe_trace_stop(self, it, obs):
        """iter_end hook: close the one-iteration window."""
        with self._lock:
            st = self._trace_state
            if st is None or not st.get("active"):
                return
            self._trace_stop_locked(it)

    def _trace_stop_locked(self, it):
        st, self._trace_state = self._trace_state, None
        from . import profile
        try:
            profile.stop_trace()
        except Exception as exc:
            Log.warning("obs: incident trace stop failed: %s", exc)
            return
        self._emit("trace_window", action="stop", dir=st["dir"], it=it)
        entry = {"artifact": "trace", "path": st["dir"]}
        target = self._open if (self._open is not None
                                and self._open.id == st["id"]) else None
        if target is not None:
            target.artifacts.append(entry)
        self._emit("incident_evidence", id=st["id"], artifact="trace",
                   path=st["dir"], it=it)

    # -- live plane ----------------------------------------------------
    def listing(self):
        """The /incidents endpoint payload."""
        with self._lock:
            return {"enabled": True,
                    "opened": self._counter,
                    "open": ([self._open.meta("open",
                                              window_s=self.window_s)]
                             if self._open is not None else []),
                    "closed": [dict(m) for m in self._closed_hist]}

    def _flight_state(self):
        """Flight-provider hook: rides into every flight record and the
        /statusz ``flight.incidents`` section (the satellite contract)."""
        with self._lock:
            out = {"opened": self._counter, "open": 0}
            if self._open is not None:
                out["open"] = 1
                out["last"] = {"id": self._open.id,
                               "trigger": self._open.trigger,
                               "signals": list(self._open.signals),
                               "age_s": round(time.time()
                                              - self._open.open_t, 3)}
            elif self._closed_hist:
                last = self._closed_hist[-1]
                out["last"] = {"id": last["id"],
                               "trigger": last["trigger"],
                               "signals": list(last["signals"])}
            return {"incidents": out}


# -- reader: `python -m lightgbm_tpu_torch obs incident <dir|timeline>` --------

def _normalize_from_events(events):
    """Reconstruct incident dicts (the incident.json meta shape) from a
    timeline's incident_open/incident_evidence/incident_close events."""
    incidents = {}
    order = []
    for rec in events:
        ev, iid = rec.get("ev"), rec.get("id")
        if ev == "incident_open":
            incidents[iid] = {
                "id": iid, "status": "open",
                "trigger": rec.get("trigger"),
                "open_t": rec.get("t"), "open_seq": rec.get("seq"),
                "signals": list(rec.get("signals") or ()),
                "counts": {}, "signal_detail": [], "artifacts": [],
                "dir": rec.get("dir") or ""}
            order.append(iid)
        elif ev == "incident_evidence" and iid in incidents:
            art = {k: rec[k] for k in ("artifact", "path", "bytes",
                                       "error") if k in rec}
            incidents[iid]["artifacts"].append(art)
        elif ev == "incident_close" and iid in incidents:
            inc = incidents[iid]
            inc["status"] = "closed"
            inc["close_t"] = rec.get("t")
            inc["duration_s"] = rec.get("duration_s")
            inc["signals"] = list(rec.get("signals") or inc["signals"])
            inc["counts"] = dict(rec.get("counts") or {})
            inc["signal_detail"] = list(rec.get("signal_detail") or ())
            inc["window_s"] = rec.get("window_s")
    return [incidents[i] for i in order]


def load_incidents(target):
    """Incident metas from a bundle dir (single or parent) or a JSONL
    timeline.  Raises OSError/ValueError on an unreadable target."""
    if os.path.isdir(target):
        meta = os.path.join(target, "incident.json")
        if os.path.isfile(meta):
            with open(meta) as f:
                return [json.load(f)]
        out = []
        for name in sorted(os.listdir(target)):
            sub = os.path.join(target, name, "incident.json")
            if os.path.isfile(sub):
                with open(sub) as f:
                    out.append(json.load(f))
        return out
    from .events import read_events
    return _normalize_from_events(read_events(target))


def rank_root_causes(signals, counts):
    """Deterministic heuristic ranking: (diagnosis, matched kinds),
    best first.  See _ROOT_CAUSES for the scoring contract."""
    present = set(signals)
    scored = []
    for idx, (needs, diagnosis) in enumerate(_ROOT_CAUSES):
        if needs <= present:
            weight = sum(int(counts.get(k, 1) or 1) for k in needs)
            scored.append((-len(needs), -weight, idx, diagnosis,
                           sorted(needs)))
    scored.sort()
    ranked = [(diag, kinds) for _, _, _, diag, kinds in scored]
    if not ranked:
        ranked = [(_FALLBACK_CAUSE, sorted(present))]
    return ranked


def _fmt_ts(t):
    try:
        return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime(float(t)))
    except (TypeError, ValueError):
        return "?"


def _render_one(inc, out):
    def w(s=""):
        print(s, file=out)
    signals = list(inc.get("signals") or ())
    counts = dict(inc.get("counts") or {})
    n_events = sum(int(v or 0) for v in counts.values()) or len(signals)
    head = "incident %s  opened %s" % (inc.get("id"),
                                       _fmt_ts(inc.get("open_t")))
    if inc.get("status") == "closed":
        head += "  closed after %.2fs" % float(inc.get("duration_s") or 0)
    else:
        head += "  [STILL OPEN]"
    w(head)
    w("  trigger: %s   %d signal kind(s), %d signal event(s)"
      % (inc.get("trigger"), len(signals), n_events))
    detail = list(inc.get("signal_detail") or ())
    if detail:
        w()
        w("  signal correlation (first-occurrence order):")
        w("    %-9s %-24s %-10s %6s  %s"
          % ("offset", "kind", "subsystem", "count", "first it"))
        t0 = float(inc.get("open_t") or (detail[0].get("first_t") or 0))
        for sig in detail:
            it = sig.get("first_it")
            w("    %-9s %-24s %-10s %6d  %s"
              % ("+%.3fs" % (float(sig.get("first_t") or t0) - t0),
                 sig.get("kind"),
                 _SUBSYSTEM.get(sig.get("kind"), "other"),
                 int(sig.get("count") or 0),
                 it if it is not None else "-"))
    elif signals:
        w("  signals: %s" % ", ".join(str(s) for s in signals))
    arts = list(inc.get("artifacts") or ())
    w()
    if arts:
        w("  evidence (%s):" % (inc.get("dir") or "bundle"))
        for a in arts:
            if a.get("error"):
                w("    %-16s FAILED: %s" % (a.get("artifact"),
                                            a.get("error")))
            else:
                w("    %-16s %s  (%s bytes)"
                  % (a.get("artifact"),
                     os.path.basename(str(a.get("path") or "")),
                     a.get("bytes", "?")))
    else:
        w("  evidence: none captured (no bundle dir configured)")
    w()
    w("  root-cause ranking:")
    for i, (diag, kinds) in enumerate(
            rank_root_causes(signals, counts), 1):
        w("    %d. %s" % (i, diag))
        w("       matched: %s" % ", ".join(kinds))
    w()


def render_incident_report(target, out=None):
    """Render the triage report for every incident found at ``target``
    (bundle dir or timeline).  Returns the incident count — the
    ``--check`` gate exits 1 when it is non-zero."""
    out = out if out is not None else sys.stdout
    incidents = load_incidents(target)
    if not incidents:
        print("no incidents in %s" % target, file=out)
        return 0
    print("%d incident(s) in %s" % (len(incidents), target), file=out)
    print(file=out)
    for inc in incidents:
        _render_one(inc, out)
    return len(incidents)
