"""Async microbatch scheduler: coalesce concurrent predict requests.

A serving process sees many small concurrent requests; the device wants
few large batches.  ``MicrobatchScheduler`` sits between them: callers
``submit()`` feature blocks and get a ``concurrent.futures.Future``; a
single worker thread coalesces the queue head into one batch until it
reaches ``max_batch`` rows or the OLDEST queued request has waited
``max_delay_ms`` — the deadline that bounds p99 latency when traffic is
too thin to fill a bucket.  The batch then runs ONCE through the bucket
program (serve/executable.py) and the result is split back per
request.

Ported from the JAX package's ``serve/scheduler.py``.  Correctness
leans on row independence: every row of the batched program computes
exactly what it would compute alone (element-wise Kahan lanes, no
cross-row reductions), so a caller cannot tell — bit for bit — whether
its rows shared a bucket with strangers.  tests/test_torch_serve.py
pins concurrent-vs-solo equality.

Requests with different semantics (raw vs converted, early-stop,
pred_contrib) carry a route key; only same-route neighbors coalesce.
Early-stop and contrib requests batch through the host predictor paths
(row-independent f64, identical to ``Booster.predict``), so the one
queue fronts every prediction flavor.

Overload protection: an unbounded queue turns overload into unbounded
latency — every admitted request waits behind the whole backlog, so by
the time it runs its caller has long timed out and the server does the
work anyway ("the goodput collapse").  The scheduler therefore sheds AT
ADMISSION: ``queue_limit`` bounds the queue outright, and a request
carrying a deadline is rejected immediately when the queue's projected
wait (coalescing delay + backlog batches x EWMA batch execute time)
already exceeds it.  Shed requests fail fast with
``ServeOverloadError`` on their future; shedding is never silent — it
counts into ``lgbm_serve_shed_total`` (by route kind and reason), the
SLO engine's shed rate and ``stats()``, and the queue-age gauge shows
the backlog building first.

Observability: every completed request feeds the rolling SLO engine
(obs/serve.py).  The observer hooks (sampled ``serve_batch`` and
``serve_request`` events, the hang watchdog around every runner call, a
flight-context provider with the live queue state) are kept for callers
that hand one in; ``ServingPredictor`` takes only the null observer
until the port has a run observer.
"""
from __future__ import annotations

import collections
import math
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..obs.events import NULL_OBSERVER
from ..obs.metrics import (REGISTRY, observe_serve_batch,
                           observe_serve_queue_age, observe_serve_request,
                           observe_serve_shed)
from ..obs.serve import SloEngine, route_kind
from ..utils.log import LightGBMError, Log

# EWMA weight for the per-batch execute-time estimate behind the
# deadline admission check
_EWMA_ALPHA = 0.3

# every Nth shed signals the observer's incident hook: a lone shed is a
# blip the one-time warning already covers, a run of them is a storm
SHED_STORM_AFTER = 8


class ServeOverloadError(RuntimeError):
    """A request shed at admission by overload protection.  Carries the
    machine-readable ``reason``: ``queue_full`` (bounded queue at
    ``serve_queue_limit``) or ``deadline`` (projected wait exceeds the
    request's deadline)."""

    def __init__(self, message, reason):
        super().__init__(message)
        self.reason = reason


class _Request:
    __slots__ = ("features", "n", "future", "t", "deadline_s")

    def __init__(self, features, n, future, t, deadline_s=None):
        self.features = features
        self.n = n
        self.future = future
        self.t = t
        self.deadline_s = deadline_s


class MicrobatchScheduler:
    """The generic coalescing core: a FIFO of (route, features) requests
    drained by one worker thread into per-route batches.

    ``runner(route, features)`` scores one concatenated (n, F) block and
    returns an array whose leading axis is rows; the scheduler slices it
    back per request.  Head-of-line batching preserves submission order:
    only the leading run of same-route requests coalesces, so a stream
    of mixed routes drains fairly.
    """

    def __init__(self, runner, max_batch: int = 8192,
                 max_delay_ms: float = 2.0, observer=None,
                 batch_event_every: int = 0, name: str = "serve",
                 bucket_for=None, queue_limit: int = 0,
                 default_deadline_s: float = 0.0, slo=None,
                 request_event_every: int = 0, fault_hook=None):
        self._runner = runner
        # route-aware bucket sizing for the pad/bucket accounting on
        # serve_batch events (rows == bucket when absent — host routes)
        self._bucket_for = bucket_for or (lambda route, rows: rows)
        self.max_batch = max(1, int(max_batch))
        self.max_delay_s = max(0.0, float(max_delay_ms)) / 1e3
        self.observer = observer if observer is not None else NULL_OBSERVER
        self.batch_event_every = max(0, int(batch_event_every))
        self.request_event_every = max(0, int(request_event_every))
        self.queue_limit = max(0, int(queue_limit))      # 0 = unbounded
        self.default_deadline_s = max(0.0, float(default_deadline_s))
        self.slo = slo                       # obs.serve.SloEngine or None
        # fault-injection hook for tests/bench: called as
        # fault_hook(route, batch) on the worker just before the runner
        # — a sleeping/blocking hook simulates a slow or wedged runner
        self._fault_hook = fault_hook
        self.name = name
        self._queue = collections.deque()   # (route, _Request)
        self._cv = threading.Condition()
        self._closing = False
        self._batches = 0
        self._rows = 0
        self._pad_rows = 0
        self._max_depth = 0
        self._queued_rows = 0
        self._requests_done = 0
        self._shed = {}                     # reason -> count
        self._ewma_exec_s = 0.0
        self._spans = {}                    # runner-reported trace spans
        self._inflight = REGISTRY.gauge(
            "lgbm_serve_queue_depth",
            "requests waiting in the microbatch queue")
        # a wedged runner's flight record must show what was stuck
        # behind it: queue depth, queued rows, pending route kinds
        self.observer.add_flight_provider(self._flight_state)
        # lgbm- prefix: flight records and external tools attribute
        # thread samples by this name
        self._worker = threading.Thread(
            target=self._loop, name="lgbm-%s-microbatch" % name,
            daemon=True)
        self._worker.start()

    # ------------------------------------------------------------- submit
    def _projected_wait_locked(self, n_rows: int) -> float:
        """Admission-time wait estimate for a request of ``n_rows``:
        the coalescing delay plus the batches ahead of it (backlog +
        itself) at the EWMA per-batch execute time.  Zero until the
        first batch completes — a cold scheduler never deadline-sheds
        on a guess."""
        if self._ewma_exec_s <= 0.0:
            return 0.0
        batches = math.ceil((self._queued_rows + n_rows)
                            / float(self.max_batch))
        return self.max_delay_s + batches * self._ewma_exec_s

    def submit(self, route, features, n_rows: int,
               deadline_s=None) -> Future:
        """Enqueue one request; resolves to the route runner's output
        rows for this request (exceptions propagate to the future).

        ``deadline_s`` is the caller's end-to-end latency budget
        (default ``default_deadline_s``; 0/None = no deadline).  A
        request whose projected wait already exceeds its deadline — or
        that arrives with the queue at ``queue_limit`` — is shed: its
        future fails immediately with ``ServeOverloadError`` instead of
        queueing work whose answer nobody will be around to read."""
        fut = Future()
        now = time.perf_counter()
        if deadline_s is None:
            deadline_s = self.default_deadline_s or None
        reason = None
        with self._cv:
            if self._closing:
                raise RuntimeError("%s: scheduler is closed" % self.name)
            if self.queue_limit and len(self._queue) >= self.queue_limit:
                reason = "queue_full"
                detail = ("queue at limit (%d requests)"
                          % len(self._queue))
            elif deadline_s:
                projected = self._projected_wait_locked(int(n_rows))
                if projected > deadline_s:
                    reason = "deadline"
                    detail = ("projected wait %.1fms > deadline %.1fms"
                              % (projected * 1e3, deadline_s * 1e3))
            if reason is None:
                req = _Request(features, int(n_rows), fut, now,
                               deadline_s)
                self._queue.append((route, req))
                depth = len(self._queue)
                self._max_depth = max(self._max_depth, depth)
                self._queued_rows += req.n
                self._inflight.set(depth)
                observe_serve_queue_age(now - self._queue[0][1].t)
                self._cv.notify()
            else:
                first = reason not in self._shed
                self._shed[reason] = self._shed.get(reason, 0) + 1
                shed_total = sum(self._shed.values())
        if reason is not None:
            observe_serve_shed(route, reason)
            if self.slo is not None:
                self.slo.record_shed(route, reason)
            if first:        # never silent, never per-request log spam
                Log.warning("%s: shedding route %s (%s) — overload "
                            "protection engaged; see lgbm_serve_shed_"
                            "total for the running count", self.name,
                            route_kind(route), detail)
            if shed_total % SHED_STORM_AFTER == 0:
                # a storm, not a blip: every SHED_STORM_AFTER-th shed
                # signals the observer; host-side dict work off the
                # worker thread
                try:
                    self.observer.incident_signal(
                        "shed_storm",
                        {"shed_total": shed_total, "reason": reason,
                         "route": route_kind(route),
                         "queue_limit": self.queue_limit})
                except Exception:
                    pass
            fut.set_exception(ServeOverloadError(
                "%s: request shed (%s)" % (self.name, detail), reason))
        return fut

    def record_span(self, name: str, seconds: float):
        """Route runners report per-stage timings (encode/pad/execute,
        serve/executable.py) for the CURRENT batch here; the scheduler
        folds them into sampled ``serve_request`` trace events.  Worker
        thread only — cleared before every runner call."""
        self._spans[name] = self._spans.get(name, 0.0) + float(seconds)

    # ------------------------------------------------------------- worker
    def _head_rows(self, route) -> int:
        rows = 0
        for r, req in self._queue:
            if r != route:
                break
            rows += req.n
        return rows

    def _pop_batch(self, route):
        """The leading same-route run, capped at max_batch rows (a
        single oversized request still pops alone — the runner chunks)."""
        batch = []
        rows = 0
        while self._queue and self._queue[0][0] == route:
            req = self._queue[0][1]
            if batch and rows + req.n > self.max_batch:
                break
            self._queue.popleft()
            batch.append(req)
            rows += req.n
        self._queued_rows = max(0, self._queued_rows - rows)
        self._inflight.set(len(self._queue))
        observe_serve_queue_age(
            time.perf_counter() - self._queue[0][1].t
            if self._queue else 0.0)
        return batch

    def _loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._closing:
                    self._cv.wait()
                if not self._queue:
                    return                        # closing, drained
                route, head = self._queue[0]
                deadline = head.t + self.max_delay_s
                while not self._closing:
                    if self._head_rows(route) >= self.max_batch:
                        break
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cv.wait(remaining)
                batch = self._pop_batch(route)
            try:
                self._run_batch(route, batch)
            except Exception as e:        # the worker must never die
                Log.warning("%s: microbatch worker error: %s",
                            self.name, e)
                for r in batch:
                    if not r.future.done():
                        try:
                            r.future.set_exception(e)
                        except Exception:
                            pass

    def _run_batch(self, route, batch):
        # claim every future first: a request cancelled while queued
        # drops out here, and a claimed future can no longer be
        # cancelled, so set_result/set_exception below cannot raise
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        t0 = time.perf_counter()
        queue_s = t0 - batch[0].t
        rows_in = sum(r.n for r in batch)
        obs = self.observer
        self._spans = {}
        # arm the hang watchdog around the runner: a wedged device call
        # or deadlocked host predictor dumps a flight record naming
        # this batch (plus the queue state via the flight provider)
        obs.watchdog_arm("serve batch route=%s rows=%d"
                         % (route_kind(route), rows_in))
        try:
            if self._fault_hook is not None:
                self._fault_hook(route, batch)
            if len(batch) == 1:
                feats = batch[0].features
            else:
                feats = np.concatenate([r.features for r in batch])
            out = self._runner(route, feats)
        except Exception as e:                    # surface per caller
            now = time.perf_counter()
            for r in batch:
                r.future.set_exception(e)
                if self.slo is not None:
                    self.slo.record(route, now - r.t, error=True)
            return
        finally:
            obs.watchdog_disarm()
        now = time.perf_counter()
        lo = 0
        for r in batch:
            # copy, not a view: callers own their result array and must
            # not be able to corrupt batch neighbors through it
            r.future.set_result(out[lo:lo + r.n].copy())
            lo += r.n
            self._requests_done += 1
            observe_serve_request(now - r.t)
            if self.slo is not None:
                self.slo.record(route, now - r.t)
        respond_s = time.perf_counter() - now
        rows = lo
        self._batches += 1
        self._rows += rows
        exec_s = now - t0
        self._ewma_exec_s = (exec_s if self._ewma_exec_s <= 0.0 else
                             (1.0 - _EWMA_ALPHA) * self._ewma_exec_s
                             + _EWMA_ALPHA * exec_s)
        bucket = self._bucket_for(route, rows)
        pad = max(bucket - rows, 0)
        self._pad_rows += pad
        observe_serve_batch(route, rows, pad, bucket, queue_s, exec_s)
        if (obs.enabled and self.batch_event_every
                and self._batches % self.batch_event_every == 0):
            obs.event("serve_batch", route=str(route),
                      kind=route_kind(route), rows=rows,
                      bucket=bucket, pad=pad, requests=len(batch),
                      queue_s=round(queue_s, 6), exec_s=round(exec_s, 6))
        if obs.enabled and self.request_event_every:
            self._trace_requests(obs, route, batch, bucket, t0, exec_s,
                                 respond_s)

    def _trace_requests(self, obs, route, batch, bucket, t0, exec_s,
                        respond_s):
        """Every ``request_event_every``-th completed request leaves a
        ``serve_request`` trace: its latency decomposed into the queue
        wait it personally paid, the batch's encode/pad/execute spans
        (record_span, serve/executable.py) and the respond (slice+copy)
        time, tagged with the batch id and bucket it rode in."""
        base = dict(self._spans)
        first = self._requests_done - len(batch)
        for i, r in enumerate(batch):
            if (first + i + 1) % self.request_event_every:
                continue
            spans = {"queue_s": round(t0 - r.t, 6),
                     "exec_s": round(exec_s, 6),
                     "respond_s": round(respond_s, 6)}
            for name, v in base.items():
                spans[name] = round(v, 6)
            rec = {"route": str(route), "kind": route_kind(route),
                   "rows": r.n, "bucket": bucket, "batch": self._batches,
                   "requests": len(batch), "spans": spans,
                   "total_s": round(time.perf_counter() - r.t, 6)}
            if r.deadline_s:
                rec["deadline_s"] = round(r.deadline_s, 6)
            obs.event("serve_request", **rec)

    # --------------------------------------------------------- forensics
    def _flight_state(self):
        """Flight-record context for the observer: best-effort snapshot
        of the live queue — called from the watchdog/signal thread,
        possibly while the queue is mutating, so it must never block or
        raise."""
        try:
            pending = list(self._queue)
        except RuntimeError:           # deque mutated mid-iteration
            pending = []
        kinds = {}
        oldest = None
        for rt, req in pending:
            kinds[route_kind(rt)] = kinds.get(route_kind(rt), 0) + 1
            if oldest is None or req.t < oldest:
                oldest = req.t
        state = {"name": self.name, "queue_depth": len(pending),
                 "queued_rows": sum(req.n for _, req in pending),
                 "pending_routes": kinds, "batches": self._batches,
                 "shed": dict(self._shed),
                 "ewma_exec_s": round(self._ewma_exec_s, 6)}
        if oldest is not None:
            state["oldest_wait_s"] = round(
                time.perf_counter() - oldest, 6)
        return {"serve": state}

    # -------------------------------------------------------------- admin
    def stats(self) -> dict:
        return {"batches": self._batches, "rows": self._rows,
                "pad_rows": self._pad_rows,
                "max_queue_depth": self._max_depth,
                "requests": self._requests_done,
                "shed": dict(self._shed),
                "shed_total": sum(self._shed.values())}

    def close(self):
        """Flush the queue and stop the worker; idempotent."""
        with self._cv:
            if self._closing and not self._worker.is_alive():
                return
            self._closing = True
            self._cv.notify_all()
        self._worker.join()
        self.observer.remove_flight_provider(self._flight_state)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


class ServingPredictor:
    """The production predict front end: one object per model snapshot,
    shared by any number of submitting threads.

    * plain / raw predictions route through the bucket programs (the
      device route ``dev``: a CUDA graph replay a batch on the card,
      zero steady-state captures);
    * ``pred_early_stop`` / ``pred_contrib`` route through the host
      predictor paths (``es``, ``contrib``) — batched through the same
      queue, bit-identical to ``Booster.predict``;
    * a model whose features the device path cannot encode (mixed
      categorical/numerical use) falls back to the host predictor
      (``host``) for every route, with a warning.

    Output shapes match ``Booster.predict``: 1-D for single-output
    models, (n, k) for multiclass, (n, num_features + 1) for contrib.
    ``stats()["routes"]`` counts the requests each route admitted.
    With a run observer the programs' captures, the sampled batches and
    requests, the SLO snapshots and the close-time ``serve_summary``
    land on its timeline; with ``drift_every`` > 0 and a model that
    carries a training-time fingerprint a ``DriftMonitor``
    (obs/drift.py) bins the submitted rows and the scores.
    """

    def __init__(self, gbdt, num_iteration: int = -1, num_features=None,
                 max_batch: int = 8192, max_delay_ms: float = 2.0,
                 bucket_min: int = 64, donate: str = "auto",
                 devices=None, observer=None, batch_event_every: int = 0,
                 queue_limit: int = 0, request_deadline_ms: float = 0.0,
                 request_event_every: int = 0, slo_p99_ms: float = 0.0,
                 slo_qps: float = 0.0, slo_window_s: float = 60.0,
                 slo_every_s: float = 10.0, slo_mode: str = "warn",
                 fault_hook=None, drift_every: int = 0,
                 drift_window: int = 8192, drift_psi: float = 0.2,
                 drift_topk: int = 10, drift_min_labels: int = 100,
                 drift_fingerprint=None, drift_mode: str = None):
        from .executable import PredictExecutableCache
        self.gbdt = gbdt
        self.num_iteration = int(num_iteration)
        self.observer = observer if observer is not None else NULL_OBSERVER
        self._summary_done = False
        self.cache = None
        try:
            self.cache = PredictExecutableCache(
                gbdt, num_iteration=num_iteration,
                num_features=num_features, devices=devices, donate=donate,
                bucket_min=bucket_min, max_batch=max_batch,
                observer=self.observer)
        except ValueError as e:
            Log.warning("serve: device programs unavailable (%s); "
                        "serving from the host predictor", e)
        self._host_predictors = {}
        self._host_lock = threading.Lock()
        self._route_counts = {}
        # SLO engine only when it has something to do: targets to
        # verdict or page on, or an observer to snapshot into; the
        # default predictor keeps its hot path unchanged
        self.slo = None
        if (float(slo_p99_ms or 0) > 0 or float(slo_qps or 0) > 0
                or (self.observer.enabled and float(slo_every_s or 0) > 0)):
            self.slo = SloEngine(
                observer=self.observer, mode=slo_mode, p99_ms=slo_p99_ms,
                qps=slo_qps, window_s=slo_window_s, every_s=slo_every_s)
        # drift monitor only when asked for and the model carries a
        # training-time fingerprint to compare against (obs/drift.py);
        # absent, the hot path is unchanged
        self.drift = None
        if int(drift_every or 0) > 0:
            fp = (drift_fingerprint if drift_fingerprint is not None
                  else gbdt.drift_fingerprint())
            if fp is None:
                Log.warning("serve: obs_drift_every=%d but the model "
                            "has no drift fingerprint (trained before "
                            "schema 14, or obs_drift_fingerprint=false)"
                            "; drift monitoring disabled",
                            int(drift_every))
            else:
                from ..obs.drift import DriftMonitor
                mon = DriftMonitor(
                    fp, observer=self.observer,
                    mode=(drift_mode if drift_mode is not None
                          else slo_mode),
                    every_rows=drift_every, window_rows=drift_window,
                    psi_threshold=drift_psi, topk=drift_topk,
                    min_labels=drift_min_labels)
                if mon.enabled:
                    self.drift = mon
        self.scheduler = MicrobatchScheduler(
            self._run_route, max_batch=max_batch,
            max_delay_ms=max_delay_ms, observer=self.observer,
            batch_event_every=batch_event_every,
            bucket_for=self._bucket_of, queue_limit=queue_limit,
            default_deadline_s=max(0.0, float(request_deadline_ms)) / 1e3,
            slo=self.slo, request_event_every=request_event_every,
            fault_hook=fault_hook)
        # the SLO and drift headlines ride into flight records and the
        # live /statusz plane (obs/live.py) through the provider
        # registry the scheduler's queue state uses
        self._slo_flight = None
        if self.slo is not None:
            self._slo_flight = lambda: {"slo": self.slo.headline()}
            self.observer.add_flight_provider(self._slo_flight)
        self._drift_flight = None
        if self.drift is not None:
            self._drift_flight = lambda: {"drift": self.drift.headline()}
            self.observer.add_flight_provider(self._drift_flight)

    # -------------------------------------------------------------- routes
    def _bucket_of(self, route, rows):
        if self.cache is not None and route[0] == "dev" \
                and rows <= self.cache.max_batch:
            return self.cache.bucket_for(rows)
        return rows

    def _host_predictor(self, key):
        """Memoized host Predictor per (raw, early_stop, freq, margin)."""
        with self._host_lock:
            p = self._host_predictors.get(key)
            if p is None:
                from ..predictor import Predictor
                raw, early, freq, margin = key
                p = Predictor(self.gbdt, num_iteration=self.num_iteration,
                              raw_score=raw, early_stop=early,
                              early_stop_freq=freq,
                              early_stop_margin=margin)
                self._host_predictors[key] = p
            return p

    def _run_route(self, route, feats):
        kind = route[0]
        if kind == "dev":
            convert = route[1]
            out = self.cache.predict_batch(feats, convert=convert)
            # forward the program's stage decomposition (encode / pad /
            # execute / convert) into this batch's trace spans
            for name, v in self.cache.last_spans.items():
                self.scheduler.record_span(name, v)
            return out[:, 0] if self.cache.k == 1 else out
        if kind == "contrib":
            return self.gbdt.pred_contrib(
                feats, num_iteration=self.num_iteration)
        # host routes: ("host", raw, width) and
        # ("es", raw, freq, margin, width) — width is part of the key
        # so only same-width requests coalesce (np.concatenate)
        if kind == "es":
            raw, freq, margin = route[1:4]
            return self._host_predictor((raw, True, freq, margin)
                                        ).predict(feats)
        return self._host_predictor((route[1], False, 10, 10.0)
                                    ).predict(feats)

    def _route_for(self, raw_score, pred_contrib, pred_early_stop,
                   freq, margin, width):
        if pred_contrib:
            return ("contrib", width)
        if pred_early_stop:
            return ("es", bool(raw_score), int(freq), float(margin),
                    width)
        if self.cache is not None:
            return ("dev", not raw_score)
        return ("host", bool(raw_score), width)

    # -------------------------------------------------------------- public
    def submit(self, features, raw_score: bool = False,
               pred_contrib: bool = False, pred_early_stop: bool = False,
               pred_early_stop_freq: int = 10,
               pred_early_stop_margin: float = 10.0,
               deadline_ms=None, ids=None) -> Future:
        """Enqueue one request; the future resolves to the same array
        ``Booster.predict`` would return for these rows.

        ``deadline_ms`` overrides the predictor-wide
        ``serve_request_deadline_ms`` for this request; when the queue's
        projected wait already exceeds it the future fails fast with
        ``ServeOverloadError`` instead of queueing doomed work.

        ``ids``: optional per-row request ids; with drift monitoring on
        they key this request's predictions for the delayed-label
        channel (``record_outcome``)."""
        X = np.asarray(features, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        X = np.ascontiguousarray(X)
        # the drift monitor reads the host array already held: binned
        # with the frozen training mappers, no device work, no fences
        if self.drift is not None:
            self.drift.observe_features(X)
        route = self._route_for(raw_score, pred_contrib, pred_early_stop,
                                pred_early_stop_freq,
                                pred_early_stop_margin, X.shape[1])
        if route[0] == "dev":
            # one canonical width per dev route, so any two valid
            # requests can share a batch (too-narrow ones raise HERE,
            # in the caller, not inside a stranger's microbatch)
            X = self.cache.normalize(X)
        deadline_s = (None if deadline_ms is None
                      else max(0.0, float(deadline_ms)) / 1e3 or None)
        fut = self.scheduler.submit(route, X, X.shape[0],
                                    deadline_s=deadline_s)
        if not (fut.done()
                and isinstance(fut.exception(), ServeOverloadError)):
            with self._host_lock:
                self._route_counts[route[0]] = \
                    self._route_counts.get(route[0], 0) + 1
        if self.drift is not None and not pred_contrib:
            raw = bool(raw_score)

            def _capture(f, raw=raw, ids=ids):
                if f.cancelled() or f.exception() is not None:
                    return
                try:
                    out = f.result()
                    self.drift.observe_scores(out, raw=raw)
                    if ids is not None:
                        self.drift.note_predictions(ids, out, raw=raw)
                except Exception as e:   # monitoring never fails a request
                    Log.warning("drift: score capture failed: %s", e)
            fut.add_done_callback(_capture)
        return fut

    def record_outcome(self, ids, labels) -> int:
        """The delayed-label channel: join ground-truth labels with the
        predictions earlier ``submit(..., ids=...)`` calls recorded, so
        the drift monitor tracks rolling online AUC/logloss against the
        training-time reference.  Returns how many ids joined; 0 with
        drift monitoring off."""
        if self.drift is None:
            return 0
        return self.drift.record_outcome(ids, labels)

    def predict(self, features, **kw) -> np.ndarray:
        """Synchronous convenience: submit + wait."""
        return self.submit(features, **kw).result()

    def warmup(self, sizes=(), raw_score: bool = False):
        """Build the bucket programs covering ``sizes`` row counts, then
        mark the cache warm so any later build counts as a steady-state
        violation.  Returns the built bucket list."""
        buckets = []
        if self.cache is not None and sizes:
            buckets = self.cache.warmup(sizes, convert=not raw_score)
            self.cache.mark_warm()
        return buckets

    def stats(self) -> dict:
        out = dict(self.scheduler.stats())
        with self._host_lock:
            out["routes"] = dict(self._route_counts)
        if self.cache is not None:
            out["executables"] = self.cache.stats()
        if self.slo is not None:
            out["slo"] = self.slo.summary()
        if self.drift is not None:
            out["drift"] = self.drift.summary()
        return out

    def close(self):
        """Stop the worker after the queue drains, then leave the
        lifetime record: a ``serve_summary`` event (the run_end of a
        serving session), a final SLO snapshot and the close-time
        watermark in the metrics registry.  Idempotent."""
        self.scheduler.close()
        if self._slo_flight is not None:
            self.observer.remove_flight_provider(self._slo_flight)
            self._slo_flight = None
        if self._drift_flight is not None:
            self.observer.remove_flight_provider(self._drift_flight)
            self._drift_flight = None
        if self._summary_done:
            return
        self._summary_done = True
        if self.drift is not None:
            self.drift.close()
        st = self.stats()
        REGISTRY.gauge(
            "lgbm_serve_max_queue_depth",
            "peak microbatch queue depth over the predictor's life").max(
                st["max_queue_depth"])
        if self.slo is not None:
            self.slo.close()
        obs = self.observer
        if obs.enabled:
            rec = {"batches": st["batches"], "rows": st["rows"],
                   "pad_rows": st["pad_rows"],
                   "max_queue_depth": st["max_queue_depth"],
                   "requests": st["requests"],
                   "shed": st["shed"], "shed_total": st["shed_total"]}
            for key in ("executables", "slo", "drift"):
                if key in st:
                    rec[key] = st[key]
            obs.event("serve_summary", **rec)
            obs.flush()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False
