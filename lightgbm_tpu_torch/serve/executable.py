"""Bucket programs for the serving tier: one CUDA graph a power-of-two
bucket.

Ported from the JAX package's ``serve/executable.py``, whose
``PredictExecutableCache`` compiles each predict program ahead of time,
one per (batch bucket, convert).  Here each (bucket, convert) pair is a
program over static buffers:

* request rows round up to a power-of-two bucket between ``bucket_min``
  and ``max_batch``, so a route has at most
  ``log2(max_batch / bucket_min) + 1`` programs;
* a program owns its inputs, V (bucket, F) int32 and D (bucket, F) bool
  (the rank encoding of ops/predict.py), and a (bucket, K) output; on
  the card the ranked traversal, the Kahan sum and the sigmoid or
  softmax (when ``_fused_conversion`` gives one) are ONE CUDA graph
  captured over them, so a request copies its encoded rows in,
  zero-pads the rest, replays the graph and reads back ``[:n]``;
* on the CPU the same function runs eagerly on the same buffers, and a
  program's first use still counts as a build;
* over several devices (``devices=``, the JAX package's mesh of local
  devices) each entry holds a replica of the trees and its own program
  of bucket / devices rows, the bucket rounded up to a multiple of the
  entries; a request's rows split in order over the entries, every
  entry launches, and the outputs join in row order.  Entries may
  repeat a card: each still gets its buffers and graph.

``compiles`` and ``steady_state_compiles`` keep the JAX package's names
so callers written for it read them: they count graph captures on the
card and program builds on the CPU.  ``donate`` is accepted for the
signature and has no effect: a program's input buffers are static and
reused by every request (``stats()`` says so).

Leaf routing is bit-equal to the host f64 predictor (rank encoding);
values accumulate in f32 with Kahan compensation, and every row's
arithmetic is elementwise and its own, so a row scores bit-identically
whatever bucket it lands in and whoever shares it.  That invariant is
what lets the microbatcher coalesce freely (tests/test_torch_serve.py
pins it).

A graph's static buffers are shared state, where a JAX executable is
reentrant: a lock covers building, copy-in, replay and copy-out.  On
the card every cache captures and replays on one high-priority stream
of the card, under one lock of that stream (``_serving_stream``):
torch hands out its pooled streams in turn, so two streams asked for
apart may be one, and work that lands on a stream another thread is
capturing joins that capture.  No training stream comes from the
high-priority pool.  Graphs are captured after a warm-up run, with
``capture_error_mode="thread_local"`` and under the process's capture
lock with the garbage collector paused (``device.capture_guard``, which
the fused iteration's captures take too), so another thread's CUDA work (a training run, a bulk
predict) neither breaks a capture nor is broken by it; a cache's graphs
share one memory pool.  A capture or a replay that fails raises: it
never falls back to the host.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..device import capture_guard, resolve_device
from ..obs.events import NULL_OBSERVER
from ..obs.metrics import REGISTRY
from ..ops import predict as dev_predict
from ..utils.config import _TRUE_SET
from ..utils.log import Log


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (n >= 1)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def _fused_conversion(objective):
    """('sigmoid', scale) | ('softmax', None) | None (identity) — or the
    string 'host' when the objective's convert_output has no fusable
    closed form and must run on the host after the raw program."""
    from ..objectives import (BinaryLogloss, MulticlassOVA,
                              MulticlassSoftmax, ObjectiveFunction)
    if objective is None:
        return None
    if isinstance(objective, (BinaryLogloss, MulticlassOVA)):
        return ("sigmoid", float(objective.sigmoid))
    if isinstance(objective, MulticlassSoftmax):
        return ("softmax", None)
    if type(objective).convert_output is ObjectiveFunction.convert_output:
        return None                      # identity: converted == raw
    return "host"




_SERVING_STREAMS = {}                 # card index -> (stream, lock)
_SERVING_STREAMS_LOCK = threading.Lock()


def _serving_stream(device):
    """(stream, lock): the high-priority stream on which the serving
    programs of the card capture and replay, and the lock that covers
    each build and each request on it.  One a card for the process,
    made on first use."""
    with _SERVING_STREAMS_LOCK:
        entry = _SERVING_STREAMS.get(device.index)
        if entry is None:
            entry = (torch.cuda.Stream(device, priority=-1),
                     threading.Lock())
            _SERVING_STREAMS[device.index] = entry
        return entry


def bucket_scores(trees, V, D, conv):
    """(bucket, K) f32 scores of a program: the ranked traversal, then
    the fused conversion, if any."""
    score = dev_predict.ranked_predict(trees, V, D)
    if conv is None:
        return score
    kind, scale = conv
    if kind == "sigmoid":
        return 1.0 / (1.0 + torch.exp(-scale * score))
    return torch.softmax(score, dim=-1)


class _BucketProgram:
    """One (bucket, convert) program over static buffers on one device:
    host staging (pinned on the card), the device inputs V and D, and the
    output.  On the card ``bucket_scores`` is a CUDA graph captured over
    them; on the CPU it runs eagerly on the staging buffers themselves."""

    def __init__(self, trees, bucket, num_features, k, conv, device,
                 pool, stream):
        cuda = device.type == "cuda"
        self.bucket = bucket
        shape = (bucket, num_features)
        self.V_host = torch.zeros(shape, dtype=torch.int32, pin_memory=cuda)
        self.D_host = torch.zeros(shape, dtype=torch.bool, pin_memory=cuda)
        self.out_host = torch.zeros((bucket, k), dtype=torch.float32,
                                    pin_memory=cuda)
        self._V_np, self._D_np = self.V_host.numpy(), self.D_host.numpy()
        self._stream = stream
        self._trees, self._conv = trees, conv
        self.graph = None
        if not cuda:
            self.V, self.D = self.V_host, self.D_host
            return
        self.V = torch.zeros(shape, dtype=torch.int32, device=device)
        self.D = torch.zeros(shape, dtype=torch.bool, device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            bucket_scores(trees, self.V, self.D, conv)       # warm-up run
            # a capture starts from an idle stream (a build, not a
            # request)
            stream.synchronize()  # lint: ignore[sync-synchronize] build
            graph = torch.cuda.CUDAGraph()
            with capture_guard():
                graph.capture_begin(pool=pool,
                                    capture_error_mode="thread_local")
                try:
                    self.out = bucket_scores(trees, self.V, self.D, conv)
                finally:
                    graph.capture_end()
        stream.synchronize()  # lint: ignore[sync-synchronize] build
        self.graph = graph

    def stage(self, V, D, n: int) -> None:
        """Copy n encoded rows into the staging buffers, zeros after."""
        self._V_np[:n] = V
        self._V_np[n:] = 0
        self._D_np[:n] = D
        self._D_np[n:] = False

    def launch(self, n: int) -> None:
        """Score the staged rows: on the card the copies in, the replay
        and the copy of the first n outputs out, queued on the serving
        stream (``wait`` waits for them); on the CPU at once."""
        if self.graph is None:
            self.out_host.copy_(bucket_scores(self._trees, self.V, self.D,
                                              self._conv))
            return
        with torch.cuda.stream(self._stream):
            self.V.copy_(self.V_host, non_blocking=True)
            self.D.copy_(self.D_host, non_blocking=True)
            self.graph.replay()
            self.out_host[:n].copy_(self.out[:n], non_blocking=True)

    def wait(self) -> None:
        if self.graph is not None:
            # a request's answer: its rows' scores in pinned memory
            self._stream.synchronize()  # lint: ignore[sync-synchronize] reply


def _run_shards(progs, V, D, n: int, spans: dict) -> np.ndarray:
    """Score n encoded rows through a bucket's programs, one a device
    entry, each taking its contiguous share of the rows (zeros past n):
    stage every share, launch every device, then wait for each and join
    the outputs in row order; the caller holds the cache's lock.
    Returns (n, K) float64."""
    t0 = time.perf_counter()
    per = progs[0].bucket
    counts = [max(min(n - i * per, per), 0) for i in range(len(progs))]
    for i, (prog, m) in enumerate(zip(progs, counts)):
        prog.stage(V[i * per:i * per + m], D[i * per:i * per + m], m)
    t1 = time.perf_counter()
    for prog, m in zip(progs, counts):
        prog.launch(m)
    for prog in progs:
        prog.wait()
    out = np.concatenate([prog.out_host.numpy()[:m]
                          for prog, m in zip(progs, counts)]
                         ).astype(np.float64)
    t2 = time.perf_counter()
    spans["pad_s"] = spans.get("pad_s", 0.0) + (t1 - t0)
    spans["execute_s"] = spans.get("execute_s", 0.0) + (t2 - t1)
    return out


class _Locks:
    """The serving locks of several cards, taken in one order."""

    def __init__(self, locks):
        self.locks = locks

    def __enter__(self):
        for lock in self.locks:
            lock.acquire()
        return self

    def __exit__(self, *exc):
        for lock in reversed(self.locks):
            lock.release()


class PredictExecutableCache:
    """Bucket programs over a frozen model snapshot.

    Construction packs the GBDT's first ``num_used`` trees into the
    stacked ranked representation on the booster's device (raises
    ValueError exactly when the host fallback must serve instead: mixed
    categorical/numerical feature use); programs are built lazily per
    bucket (or eagerly via ``warmup``) and counted, so a serving loop
    can assert the steady state builds nothing
    (``steady_state_compiles``).
    """

    def __init__(self, gbdt, num_iteration: int = -1, num_features=None,
                 devices=None, donate: str = "auto", bucket_min: int = 64,
                 max_batch: int = 8192, observer=None):
        gbdt._materialize()
        self.observer = observer if observer is not None else NULL_OBSERVER
        # the entries the rows of a bucket split over (JAX: the local
        # devices); an entry may repeat a card
        self.devices = ([resolve_device(d) for d in devices] if devices
                        else [gbdt.device])
        self.device = self.devices[0]
        self.k = int(gbdt.num_tree_per_iteration)
        self.num_used = int(gbdt._used_trees(num_iteration))
        self.objective = gbdt.objective
        self._conv = _fused_conversion(gbdt.objective)
        if num_features is None:
            mf = 0
            for t in gbdt.models[:self.num_used]:
                ni = t.num_leaves - 1
                if ni > 0:
                    mf = max(mf, int(t.split_feature[:ni].max()) + 1)
            num_features = max(mf, 1)
        self.num_features = int(num_features)
        self.rp = dev_predict.build_ranked_predictor(
            gbdt.models[:self.num_used], self.k, self.num_features,
            self.device)
        if self.num_features < self.rp.max_feature + 1:
            raise ValueError(
                "num_features=%d but the model splits on feature %d"
                % (self.num_features, self.rp.max_feature))
        self.donate = (str(donate).strip().lower() in _TRUE_SET
                       or (str(donate).strip().lower() == "auto"
                           and self.device.type != "cpu"))
        self.bucket_min = max(1, int(bucket_min))
        self.max_batch = max(self.bucket_min, int(max_batch))
        # (bucket, convert) -> its programs, one a device entry
        self._exe = {}
        # one replica of the trees an entry (the first entry's is rp's)
        self._trees = ([self.rp.dev] if len(self.devices) == 1
                       else self.rp.replicas(self.devices))
        # each card's serving stream and lock, and a graph pool a card
        self._pools, self._streams, locks = {}, {}, {}
        for dev in self.devices:
            if dev.type == "cuda" and dev not in self._streams:
                self._pools[dev] = torch.cuda.graph_pool_handle()
                self._streams[dev], locks[dev.index] = _serving_stream(dev)
        self._lock = (_Locks([locks[i] for i in sorted(locks)]) if locks
                      else threading.Lock())
        # stage decomposition of the LAST predict_batch call (encode /
        # pad / execute / convert seconds), read by the serve worker
        # right after the call to label request spans: worker-thread
        # state, like the batch itself
        self.last_spans = {}
        self.compiles = 0
        self._warm_compiles = None       # set by mark_warm()

    # ------------------------------------------------------------ buckets
    def bucket_for(self, n: int) -> int:
        """Power-of-two bucket in [bucket_min, max_batch], rounded up to
        a multiple of the devices so the rows split evenly."""
        b = min(max(next_pow2(max(n, 1)), self.bucket_min), self.max_batch)
        return b + (-b) % len(self.devices)

    def mark_warm(self):
        """Declare warmup over: builds from here on are steady-state
        violations (``steady_state_compiles`` counts them)."""
        self._warm_compiles = self.compiles

    @property
    def steady_state_compiles(self) -> int:
        if self._warm_compiles is None:
            return 0
        return self.compiles - self._warm_compiles

    # ------------------------------------------------------------- build
    def _build(self, bucket: int, convert: bool) -> list:
        conv = self._conv if convert else None
        if conv == "host":               # fuse nothing; convert after
            conv = None
        t0 = time.perf_counter()
        per = bucket // len(self.devices)
        progs = [_BucketProgram(trees, per, self.num_features, self.k,
                                conv, dev, self._pools.get(dev),
                                self._streams.get(dev))
                 for trees, dev in zip(self._trees, self.devices)]
        dt = time.perf_counter() - t0
        # a capture (a build on the CPU) on every device
        self.compiles += len(progs)
        entry = "serve_predict_b%d%s" % (bucket, "_conv" if convert else "")
        REGISTRY.counter(
            "lgbm_serve_compiles_total",
            "bucket programs built (graphs captured) by the serving "
            "tier").inc()
        REGISTRY.histogram(
            "lgbm_serve_compile_seconds",
            "build (graph capture) time per serving program").observe(dt)
        # a capture is the port's compile (obs/compile.py); the traversal
        # is plain torch, so it records no kernel launch and no cost
        self.observer.capture(entry, (self.rp.dev, progs[0].V, progs[0].D),
                              names=("trees", "V", "D"), seconds=dt)
        Log.debug("serve: built %s in %.3fs on %s", entry, dt, self.device)
        if self._warm_compiles is not None:
            Log.warning("serve: steady-state build of %s — warm the "
                        "bucket ladder before taking traffic", entry)
        return progs

    def _get_locked(self, bucket: int, convert: bool) -> list:
        key = (int(bucket), bool(convert))
        progs = self._exe.get(key)
        if progs is None:
            progs = self._exe[key] = self._build(*key)
        return progs

    def get(self, bucket: int, convert: bool = True) -> list:
        """The programs of one bucket, one a device entry (built on first
        use)."""
        with self._lock:
            return self._get_locked(bucket, convert)

    def warmup(self, sizes=(), convert: bool = True):
        """Build the programs of the buckets covering ``sizes`` (row
        counts or bucket values); returns the sorted bucket list."""
        buckets = sorted({self.bucket_for(int(s)) for s in sizes})
        for b in buckets:
            self.get(b, convert)
        return buckets

    # ------------------------------------------------------------ execute
    def normalize(self, features) -> np.ndarray:
        """(n, num_features) f64 view of a request: 1-D rows promote to
        one row; wider matrices slice down; narrower ones that still
        cover every used feature zero-pad (unread columns)."""
        X = np.asarray(features, np.float64)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] < self.rp.max_feature + 1:
            raise ValueError(
                "request has %d features; the model uses feature index %d"
                % (X.shape[1], self.rp.max_feature))
        if X.shape[1] > self.num_features:
            X = X[:, :self.num_features]
        elif X.shape[1] < self.num_features:
            X = np.concatenate(
                [X, np.zeros((X.shape[0],
                              self.num_features - X.shape[1]))], axis=1)
        return np.ascontiguousarray(X)

    def encode(self, features):
        """Host-side rank encoding of a normalized request block."""
        return dev_predict.rank_encode(self.rp, features)

    def run_encoded(self, V, D, n: int, convert: bool = True,
                    spans=None) -> np.ndarray:
        """Score ``n`` encoded rows through the bucket program: copy in
        and pad, replay, read back.  Returns (n, k) f64.  ``spans`` (a
        dict) accumulates the stage decomposition — ``pad_s`` (copy into
        the staging buffers with the zero padding), ``execute_s``
        (transfers, replay and read back), ``convert_s`` (host-side
        objective conversion)."""
        spans = {} if spans is None else spans
        bucket = self.bucket_for(n)
        with self._lock:
            out = _run_shards(self._get_locked(bucket, convert), V, D, n,
                              spans)
        if convert and self._conv == "host":
            t0 = time.perf_counter()
            out = np.asarray(self.objective.convert_output(
                out if self.k > 1 else out[:, 0]), np.float64)
            out = out.reshape(n, self.k) if self.k == 1 else out
            spans["convert_s"] = spans.get("convert_s", 0.0) \
                + (time.perf_counter() - t0)
        return out

    def predict_batch(self, features, convert: bool = True) -> np.ndarray:
        """Normalize + encode + execute, chunking requests larger than
        ``max_batch`` through the top bucket.  Returns (n, k) f64.
        Refreshes ``last_spans`` with this call's stage decomposition."""
        spans = {}
        X = self.normalize(features)
        n = X.shape[0]
        out = np.empty((n, self.k), np.float64)
        for lo in range(0, max(n, 1), self.max_batch):
            part = X[lo:lo + self.max_batch]
            if part.shape[0] == 0:
                break
            te = time.perf_counter()
            V, D = self.encode(part)
            spans["encode_s"] = spans.get("encode_s", 0.0) \
                + (time.perf_counter() - te)
            out[lo:lo + part.shape[0]] = self.run_encoded(
                V, D, part.shape[0], convert, spans=spans)
        self.last_spans = spans
        return out

    def stats(self) -> dict:
        return {
            "compiles": self.compiles,
            "steady_state_compiles": self.steady_state_compiles,
            "buckets": sorted({b for b, _ in self._exe}),
            "graphs": sum(p.graph is not None
                          for progs in self._exe.values() for p in progs),
            "devices": len(self.devices),
            "device": str(self.device),
            "donate": self.donate,
            "donate_effect": "none: each bucket's inputs are static "
                             "buffers, reused by every request",
            "num_used": self.num_used,
            "k": self.k,
        }

    def describe(self) -> dict:
        """What serves: ``stats()`` with each entry of ``devices`` named
        (a card may appear more than once, each with its own graphs)."""
        return dict(self.stats(),
                    device_list=[str(d) for d in self.devices])
