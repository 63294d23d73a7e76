"""Host and tensor collectives for distributed training.

Ported from the JAX package's ``parallel/comm.py``.  The reference's
Network layer (network.cpp, linkers_socket.cpp) moves two kinds of
traffic: small host objects (bin mappers, metric values, stop votes,
config values) and the learners' histograms.  The JAX package sends the
first through ``allgather_obj`` and the second through XLA's ``psum``
inside one SPMD program; in the port each rank is one process with one
device, as is PyTorch's idiom, and both go through ``torch.distributed``:

* ``allgather_obj`` gathers one JSON-serializable object from every rank
  in rank order (a CPU byte tensor on a gloo group);
* ``all_reduce_(t, op)`` (``sum`` or ``max``), ``all_gather(t)`` and
  ``broadcast_(t, src)`` move tensors, on the device they live on.

``TorchDistComm`` is the real one (``distributed_init`` builds it);
``run_ranks`` simulates ranks on threads over shared slots and a barrier,
so the tests run many ranks in one process; ``SingleProcessComm`` is the
one-rank identity.  Every collective has a timeout (``time_out``, in
minutes as in the reference, or the ``barrier_timeout`` a test passes),
so a hang fails instead of waiting forever.

Backend: NCCL where the ranks hold distinct CUDA devices, gloo on the CPU
and wherever two ranks share one card (NCCL refuses two ranks on one
device).  ``pick_backend`` decides before ``init_process_group`` and the
choice is logged; it is never made by catching an NCCL failure.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, List

import numpy as np

from ..utils.log import LightGBMError, Log

# -- rank context ---------------------------------------------------------
# Who am I, for observability: every HostComm registers its
# (rank, world_size, coordinator) here so the run observer
# (obs/events.py) shards its timeline per rank without every caller
# handing the comm through.  Thread-local because run_ranks simulates one
# rank a thread; the process-global slot serves the real multi-process
# case (one TorchDistComm a process, main thread).
_RANK_TLS = threading.local()
_RANK_GLOBAL = None


def set_rank_context(rank, world_size, coordinator=""):
    global _RANK_GLOBAL
    info = {"rank": int(rank), "world_size": int(world_size),
            "coordinator": str(coordinator or "")}
    _RANK_TLS.info = info
    if threading.current_thread() is threading.main_thread():
        _RANK_GLOBAL = info
    return info


def clear_rank_context():
    global _RANK_GLOBAL
    _RANK_TLS.info = None
    if threading.current_thread() is threading.main_thread():
        _RANK_GLOBAL = None


def rank_context():
    """{rank, world_size, coordinator} of the calling thread's comm, the
    process's comm, or None when no HostComm has registered."""
    info = getattr(_RANK_TLS, "info", None)
    if info is not None:
        return info
    return _RANK_GLOBAL


def _observe_collective(op, dt, nbytes=0, seq=None):
    """Record one collective: a metrics-registry histogram (obs/metrics.py)
    plus, for a host collective (``seq`` given) with a run observer live
    on this thread, a schema-4 ``host_collective`` timeline event carrying
    the monotonic ``seq`` obs/merge.py aligns shards on.  The gather is a
    barrier: its wall time is set by the slowest rank, so ``t_start``
    (when THIS rank arrived) is the per-rank arrival the cross-rank skew
    analysis compares.  Instrumentation never fails a collective."""
    try:
        from ..obs.metrics import REGISTRY
        host = seq is not None
        REGISTRY.histogram(
            "lgbm_host_collective_seconds" if host
            else "lgbm_tensor_collective_seconds",
            "wall time of host-level collectives (distributed loading, "
            "metrics, votes and config sync); barrier time = slowest rank"
            if host else "wall time of the learners' tensor collectives",
            labels={"op": str(op)}).observe(dt)
        if nbytes:
            REGISTRY.counter(
                "lgbm_host_collective_bytes_total" if host
                else "lgbm_tensor_collective_bytes_total",
                "payload bytes moved by collectives",
                labels={"op": str(op)}).inc(nbytes)
    except Exception:
        pass
    if seq is None:
        return
    try:
        from ..obs.events import current_observer
        obs = current_observer()
        if obs is not None and obs.enabled:
            obs.event("host_collective", op=str(op), seq=int(seq),
                      dur_s=round(dt, 6), t_start=time.time() - dt,
                      nbytes=int(nbytes))
    except Exception:
        pass


class _CollectiveGuard:
    """Arm the hang watchdog (obs/watchdog.py) around a blocking host
    collective so a barrier that never returns dumps a flight record
    naming the op and its seq.  No-op without a live observer."""

    def __init__(self, op, seq):
        self._obs = None
        try:
            from ..obs.events import current_observer
            self._obs = current_observer()
        except Exception:
            pass
        self.op, self.seq = op, seq

    def __enter__(self):
        if self._obs is not None:
            self._obs.watchdog_arm("collective %s seq=%d"
                                   % (self.op, self.seq))
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._obs is not None:
            self._obs.watchdog_disarm()
        return False


class BarrierTimeoutError(threading.BrokenBarrierError):
    """A simulated-rank collective timed out: names which ranks had
    arrived at the barrier and which were missing, instead of the bare
    threading.BrokenBarrierError that says nothing about who hung."""

    def __init__(self, op, seq, timeout_s, arrived, size):
        arrived = sorted(arrived)
        missing = sorted(set(range(size)) - set(arrived))
        self.op, self.seq = op, seq
        self.arrived, self.missing = arrived, missing
        super().__init__(
            "collective %s (seq %d) timed out after %.1fs: ranks %s "
            "arrived at the barrier, ranks %s never did -- a missing "
            "rank hung, crashed, or skipped the collective"
            % (op, seq, timeout_s, arrived, missing))


_OPS = ("sum", "max")


def _check_op(op):
    if op not in _OPS:
        raise LightGBMError("all_reduce_: op must be 'sum' or 'max', got %r"
                            % (op,))


class HostComm:
    """Collective interface (Network: linkers.h:33-152).  ``stats``
    counts the tensor collectives (calls, bytes, host seconds) a learner
    made, for the chip runs' per-wave reports, and the host seconds of
    the host collectives (``host_seconds``): together the time this rank
    spent in collectives, which the straggler profiler subtracts."""

    closed = False

    def __init__(self):
        # host_seconds: the host collectives' (allgather_obj)
        self.stats = {"calls": 0, "bytes": 0, "seconds": 0.0,
                      "host_seconds": 0.0}

    @property
    def rank(self) -> int:
        raise NotImplementedError

    @property
    def size(self) -> int:
        raise NotImplementedError

    @property
    def coordinator(self) -> str:
        """Coordinator address, for the run header ("" when local)."""
        return ""

    def allgather_obj(self, obj: Any) -> List[Any]:
        """Gather one JSON-serializable object from every rank, in rank
        order (Network::Allgather, network.h:120-142)."""
        raise NotImplementedError

    # tensor collectives: each subclass provides the _raw forms
    def all_reduce_(self, t, op: str = "sum"):
        """Reduce t over the ranks in place (``sum`` or ``max``); t."""
        _check_op(op)
        return self._timed("all_reduce", t, self._all_reduce, t, op)

    def all_gather(self, t):
        """(size, *t.shape): every rank's t, in rank order."""
        return self._timed("all_gather", t, self._all_gather, t)

    def broadcast_(self, t, src: int):
        """t := rank src's t, in place; t."""
        return self._timed("broadcast", t, self._broadcast, t, int(src))

    def _timed(self, op, t, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        nbytes = int(t.numel() * t.element_size())
        self.stats["calls"] += 1
        self.stats["bytes"] += nbytes
        self.stats["seconds"] += dt
        _observe_collective(op, dt, nbytes)
        return out


class SingleProcessComm(HostComm):
    """num_machines=1: collectives are identities, exactly like Network's
    small-world fast path (network.cpp:43-46)."""

    @property
    def rank(self) -> int:
        return 0

    @property
    def size(self) -> int:
        return 1

    def allgather_obj(self, obj: Any) -> List[Any]:
        return [obj]

    def _all_reduce(self, t, op):
        return t

    def _all_gather(self, t):
        return t[None].clone()

    def _broadcast(self, t, src):
        return t


DEFAULT_BARRIER_TIMEOUT = 120.0     # seconds; generous for CI boxes


def run_ranks(size: int, fn, fault=None, barrier_timeout=None):
    """Drive ``fn(comm)`` for ``size`` simulated ranks on threads with a
    barrier at every collective.  Returns the per-rank results in rank
    order; re-raises the first rank failure.

    ``fault``: optional ``fault(rank, seq)`` hook invoked on every rank
    right before it arrives at collective ``seq`` (host and tensor
    collectives share one sequence) -- the deterministic fault-injection
    point the tests use to force a slow rank (sleep) or a hang (sleep
    past ``barrier_timeout``, which then raises BarrierTimeoutError
    naming the arrived and the missing ranks).

    The tensor collectives deposit a copy of each rank's tensor in a
    shared slot; every rank reduces the slots in rank order, so the
    ranks get the same bits."""
    timeout_s = float(barrier_timeout if barrier_timeout is not None
                      else DEFAULT_BARRIER_TIMEOUT)
    deposits = {}
    arrivals = {}                      # seq -> set of ranks at the barrier
    results: List[Any] = [None] * size
    errors: List[Any] = [None] * size
    aborted_by_error = threading.Event()
    barrier = threading.Barrier(size)

    class _ThreadComm(HostComm):
        # flipped once the rank pool exits: a TrainingData can outlive
        # its run_ranks call, and a collective against departed peers
        # would only time out -- consumers (models/gbdt._dist_comm) treat
        # a closed comm as single-process
        closed = False

        def __init__(self, rank):
            super().__init__()
            self._rank = rank
            self._round = 0
            self.timeout_s = timeout_s
            # this thread IS rank `rank` from here on: observers created
            # on it shard their timeline accordingly
            set_rank_context(rank, size, coordinator="run_ranks")

        @property
        def rank(self):
            return self._rank

        @property
        def size(self):
            return size

        @property
        def coordinator(self):
            return "run_ranks"

        def _exchange(self, op, value):
            """Deposit value, wait for every rank, return all deposits in
            rank order, and wait again so rounds stay separate."""
            i = self._round
            self._round += 1
            if fault is not None:
                fault(self._rank, i)
            deposits.setdefault(i, [None] * size)[self._rank] = value
            arrivals.setdefault(i, set()).add(self._rank)
            # a timeout breaks the barrier in every waiter, so a rank that
            # skips a collective (or crashes) fails loudly instead of
            # deadlocking join() forever
            try:
                with _CollectiveGuard(op, i):
                    barrier.wait(timeout=timeout_s)
                    out = list(deposits[i])
                    barrier.wait(timeout=timeout_s)
            except threading.BrokenBarrierError:
                if aborted_by_error.is_set():
                    raise          # a peer failed; its error wins below
                raise BarrierTimeoutError(op, i, timeout_s,
                                          arrivals.get(i, set()),
                                          size) from None
            return i, out

        def allgather_obj(self, obj):
            t0 = time.perf_counter()
            i, out = self._exchange("allgather_obj", obj)
            dt = time.perf_counter() - t0
            self.stats["host_seconds"] += dt
            _observe_collective("allgather_obj", dt, seq=i)
            return out

        def _all_reduce(self, t, op):
            import torch
            _, parts = self._exchange("all_reduce", t.detach().clone())
            acc = parts[0].clone()
            for p in parts[1:]:
                if op == "sum":
                    acc += p
                else:
                    torch.maximum(acc, p, out=acc)
            t.copy_(acc)
            return t

        def _all_gather(self, t):
            import torch
            _, parts = self._exchange("all_gather", t.detach().clone())
            return torch.stack(parts)

        def _broadcast(self, t, src):
            _, parts = self._exchange("broadcast", t.detach().clone())
            t.copy_(parts[src])
            return t

    comms: List[Any] = [None] * size

    def runner(r):
        try:
            comms[r] = _ThreadComm(r)
            results[r] = fn(comms[r])
        except threading.BrokenBarrierError as e:   # timeout/abort
            errors[r] = e
        except Exception as e:           # surface after join
            errors[r] = e
            aborted_by_error.set()
            barrier.abort()
        finally:
            clear_rank_context()

    threads = [threading.Thread(target=runner, args=(r,),
                                name="run_ranks-r%d" % r)
               for r in range(size)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in comms:
        if c is not None:
            c.closed = True
    real = [e for e in errors
            if e is not None
            and not isinstance(e, threading.BrokenBarrierError)]
    if real:
        raise real[0]        # the rank that failed, not its stalled peers
    # every survivor saw the same broken barrier; prefer the diagnosable
    # timeout (who arrived / who was missing) over a bare abort echo
    for e in errors:
        if isinstance(e, BarrierTimeoutError):
            raise e
    for e in errors:
        if e is not None:
            raise e
    return results


# -- torch.distributed ------------------------------------------------------

def pick_backend(device_type: str, world_size: int,
                 local_world_size: int = 0) -> str:
    """'nccl' where every rank of this host holds a CUDA device of its
    own, else 'gloo' (the CPU, or ranks that share a card: NCCL refuses
    two ranks on one device).  ``local_world_size``: the ranks on this
    host (torchrun's LOCAL_WORLD_SIZE; the world size when 0)."""
    if device_type != "cuda":
        return "gloo"
    import torch
    if not torch.cuda.is_available():
        return "gloo"
    local = int(local_world_size or world_size)
    return "nccl" if local <= torch.cuda.device_count() else "gloo"


class TorchDistComm(HostComm):
    """The process's rank of an initialized ``torch.distributed`` world.
    Host objects travel as JSON bytes on a gloo group (the default group
    when it is gloo, a gloo group of its own under NCCL); tensors on the
    default group, on their own device."""

    def __init__(self, backend: str = "", coordinator: str = "",
                 timeout_s: float = 0.0):
        super().__init__()
        import torch.distributed as dist
        self._dist = dist
        self._rank = int(dist.get_rank())
        self._size = int(dist.get_world_size())
        self.backend = backend or str(dist.get_backend())
        self._coordinator = str(coordinator or "")
        self.timeout_s = float(timeout_s)
        self._host = _HOST_GROUP
        self._seq = 0
        set_rank_context(self._rank, self._size,
                         coordinator=self._coordinator)

    @property
    def rank(self) -> int:
        return self._rank

    @property
    def size(self) -> int:
        return self._size

    @property
    def coordinator(self) -> str:
        return self._coordinator

    def allgather_obj(self, obj: Any) -> List[Any]:
        import torch
        dist = self._dist
        t0 = time.perf_counter()
        seq = self._seq
        self._seq += 1
        payload = np.frombuffer(json.dumps(obj).encode(), np.uint8)
        with _CollectiveGuard("allgather_obj", seq):
            n = torch.tensor([len(payload)], dtype=torch.int64)
            sizes = [torch.zeros(1, dtype=torch.int64)
                     for _ in range(self._size)]
            dist.all_gather(sizes, n, group=self._host)
            cap = int(max(int(s) for s in sizes))
            buf = torch.zeros(cap, dtype=torch.uint8)
            buf[:len(payload)] = torch.from_numpy(payload.copy())
            parts = [torch.zeros(cap, dtype=torch.uint8)
                     for _ in range(self._size)]
            dist.all_gather(parts, buf, group=self._host)
        out = [json.loads(bytes(p[:int(s)].numpy()).decode())
               for p, s in zip(parts, sizes)]
        dt = time.perf_counter() - t0
        self.stats["host_seconds"] += dt
        _observe_collective("allgather_obj", dt,
                            nbytes=int(sum(int(s) for s in sizes)),
                            seq=seq)
        return out

    def _all_reduce(self, t, op):
        dist = self._dist
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX)
        return t

    def _all_gather(self, t):
        import torch
        parts = [torch.empty_like(t) for _ in range(self._size)]
        self._dist.all_gather(parts, t.contiguous())
        return torch.stack(parts)

    def _broadcast(self, t, src):
        self._dist.broadcast(t, src)
        return t


# the gloo group of host objects (None: the default group is gloo)
_HOST_GROUP = None
_DIST_BACKEND = ""


def _pick(arg, config, cfg_key, env_val, cast, unset):
    """Explicit argument > config key (``unset`` means autodetect) >
    environment; None when nothing names a value."""
    if arg is not None:
        return cast(arg)
    if config is not None:
        v = getattr(config, cfg_key, unset)
        if v is not None and cast(v) != unset:
            return cast(v)
    if env_val is not None and env_val != "" and cast(env_val) != unset:
        return cast(env_val)
    return None


def _env_coordinator():
    addr = os.environ.get("MASTER_ADDR", "")
    port = os.environ.get("MASTER_PORT", "")
    return "%s:%s" % (addr, port) if addr and port else None


def distributed_init(config=None, coordinator=None, num_processes=None,
                     process_id=None, device_type=None, timeout_s=None):
    """Bootstrap this process into the world and return its HostComm.

    Resolution order a field: explicit argument > config key
    (``dist_coordinator`` "host:port", ``dist_num_processes``,
    ``dist_process_id``, whose defaults ""/0/-1 mean autodetect) >
    environment (torchrun's ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``; parallel/launch.py exports the same), so a
    worker started by ``torchrun`` and one started by the port's launcher
    start up the same way.  When nothing names a world of more than one
    process, the process is single: no backend touch,
    ``SingleProcessComm`` back -- engine code can call this
    unconditionally.

    ``device_type`` ('cuda' or 'cpu', default: 'cuda' when a card is
    present) picks the backend (``pick_backend``, with torchrun's
    ``LOCAL_WORLD_SIZE``); ``timeout_s`` bounds every collective
    (default: the config's ``time_out`` minutes, else 120 minutes).
    Idempotent: a second call in one process returns a comm on the live
    world."""
    global _HOST_GROUP, _DIST_BACKEND
    import torch
    import torch.distributed as dist
    coord = _pick(coordinator, config, "dist_coordinator",
                  _env_coordinator(), str, "")
    nproc = _pick(num_processes, config, "dist_num_processes",
                  os.environ.get("WORLD_SIZE"), int, 0)
    pid = _pick(process_id, config, "dist_process_id",
                os.environ.get("RANK"), int, -1)
    if timeout_s is None:
        minutes = int(getattr(config, "time_out", 120) or 120)
        timeout_s = 60.0 * minutes
    if dist.is_available() and dist.is_initialized():
        return TorchDistComm(_DIST_BACKEND, coord or "", timeout_s)
    if nproc is None or nproc <= 1:
        return SingleProcessComm()
    if coord is None or pid is None:
        raise LightGBMError(
            "distributed_init: a world of %d processes needs a coordinator "
            "(dist_coordinator or MASTER_ADDR/MASTER_PORT) and this "
            "process's rank (dist_process_id or RANK)" % nproc)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    backend = pick_backend(device_type, nproc,
                           int(os.environ.get("LOCAL_WORLD_SIZE", "0")
                               or 0))
    from datetime import timedelta
    Log.info("torch.distributed: rank %d of %d over %s at %s", pid, nproc,
             backend, coord)
    dist.init_process_group(backend, init_method="tcp://" + coord,
                            world_size=nproc, rank=pid,
                            timeout=timedelta(seconds=float(timeout_s)))
    _DIST_BACKEND = backend
    _HOST_GROUP = (dist.new_group(backend="gloo") if backend != "gloo"
                   else None)
    return TorchDistComm(backend, coord, timeout_s)


def distributed_shutdown() -> None:
    """Leave the torch.distributed world (the launcher's workers call
    this before they exit)."""
    global _HOST_GROUP, _DIST_BACKEND
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _HOST_GROUP, _DIST_BACKEND = None, ""
    clear_rank_context()


def rank_device(device: str = "cuda"):
    """This rank's torch device: ``cuda:(LOCAL_RANK % device_count)`` (so
    ranks beyond the host's cards share them, round robin), or the CPU
    when asked."""
    import torch
    if str(device).startswith("cpu"):
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise LightGBMError("rank_device: no CUDA device (ask for "
                            "device='cpu')")
    local = int(os.environ.get("LOCAL_RANK", "0") or 0)
    return torch.device("cuda", local % torch.cuda.device_count())


def reduce_metrics(comm: HostComm, values, weight=None):
    """Row-weighted mean of per-rank eval-metric values, one collective
    round (Network::Allreduce over metric sums, the reference's
    provide-training-metric path).  ``values`` maps metric name to this
    rank's local mean; ``weight`` is this rank's row count (1.0 when
    omitted: an unweighted mean).  Identity when single-rank."""
    if comm is None or comm.size <= 1:
        return dict(values)
    mine = {"w": float(1.0 if weight is None else weight),
            "v": {str(k): float(v) for k, v in values.items()}}
    gathered = comm.allgather_obj(mine)
    total_w = sum(g["w"] for g in gathered) or 1.0
    return {k: sum(g["w"] * g["v"][k] for g in gathered) / total_w
            for k in mine["v"]}


def vote_stop(comm: HostComm, stop) -> bool:
    """Unanimous early-stop vote: training halts only when EVERY rank
    votes stop.  With bit-identical trees the votes always agree and the
    collective is a barrier; under divergence (a bug, or asymmetric eval
    sets) unanimity keeps every rank training the same number of
    iterations instead of deadlocking a collective with departed peers."""
    if comm is None or comm.size <= 1:
        return bool(stop)
    return all(bool(v) for v in comm.allgather_obj(bool(stop)))


def sync_up_by_min(comm: HostComm, value):
    """GlobalSyncUpByMin (application.cpp:275-302): every rank adopts the
    minimum -- a deterministic agreement rule for config values that MUST
    match across machines."""
    return min(comm.allgather_obj(value))


def sum_across_ranks(comm: HostComm, values):
    """Element-wise sum of a list of floats over the ranks, summed in rank
    order (GlobalSyncUpBySum: the label sum and count of
    boost_from_average)."""
    if comm is None or comm.size <= 1:
        return [float(v) for v in values]
    gathered = comm.allgather_obj([float(v) for v in values])
    out = [0.0] * len(values)
    for part in gathered:
        out = [a + float(b) for a, b in zip(out, part)]
    return out


# config keys the reference min-syncs before distributed training
# (application.cpp:118-122 data partition seed, :192-199 feature
# sampling + DART drop seed)
_SYNCED_KEYS = ("data_random_seed", "feature_fraction_seed",
                "feature_fraction", "drop_seed")


def sync_config_across_ranks(comm: HostComm, config) -> None:
    """Make the RNG-bearing parameters identical on every rank so feature
    sampling, bagging partitions and DART drops agree (divergent values
    would silently grow different trees per machine).  In place, like the
    reference mutating its config structs; called by the distributed
    dataset construction (io/dataset.py), before any sampling happens.

    ONE collective round: all four keys gather together.  Both the live
    attribute and config.raw are updated so copies keep the synced
    values."""
    if comm is None or comm.size <= 1:
        return
    mine = [getattr(config, k) for k in _SYNCED_KEYS]
    gathered = comm.allgather_obj(mine)
    for key, vals in zip(_SYNCED_KEYS, zip(*gathered)):
        v = min(vals)
        setattr(config, key, v)
        config.raw[key] = v
