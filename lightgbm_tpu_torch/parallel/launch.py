"""Multi-process ranks: real ``torch.distributed`` workers on one host.

Ported from the JAX package's ``parallel/launch.py``.  ``run_ranks``
(comm.py) simulates ranks on threads; ``run_ranks_subprocess`` starts
``size`` real processes, each of which bootstraps through
``distributed_init()`` from the variables torchrun exports
(``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so a rank started here starts up
as one started by ``torchrun`` does.  The child imports ``spec``
("package.module:function"; a callable cannot cross a process boundary),
calls ``fn(comm, payload)`` and prints its JSON-serializable return as a
final ``MPRESULT {...}`` line; the ``LGBM_MP_*`` fault hooks
(parallel/worker.py) ride through the inherited environment.

``device='cuda'`` (the default; ``'cpu'`` when asked) gives rank r
``cuda:(r % device_count)``
(``comm.rank_device``) and the backend ``pick_backend`` chooses: NCCL
where every rank has a card of its own, gloo where ranks share one.  The
kernels are built once here before the ranks start, so they do not all
run ``nvcc`` at once.

Run by hand: ``python -m lightgbm_tpu_torch.parallel.launch --ranks 2
[--device cuda|cpu] pkg.mod:fn payload.json`` prints each rank's result.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(HERE))

DEFAULT_WORKER_TIMEOUT = 540.0


class RankFailure(RuntimeError):
    """One or more rank processes died or returned nothing: which ranks
    failed, every rank's exit code and the failed ranks' output tails."""

    def __init__(self, failed, returncodes, tails, results=None):
        self.failed = sorted(failed)
        self.returncodes = dict(returncodes)
        self.tails = dict(tails)
        self.results = dict(results or {})
        super().__init__(
            "worker rank(s) %s died (exit %s); %d/%d ranks returned\n%s"
            % (self.failed,
               {r: self.returncodes.get(r) for r in self.failed},
               len(self.results), len(returncodes),
               "\n".join("--- rank %d ---\n%s" % (r, self.tails[r])
                         for r in self.failed)))


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _worker_env(port, size, rank, device, extra_env):
    env = dict(os.environ)
    env.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(int(port)),
                "WORLD_SIZE": str(int(size)), "RANK": str(int(rank)),
                "LOCAL_RANK": str(int(rank)),
                "LOCAL_WORLD_SIZE": str(int(size)),
                "LGBM_RANK_DEVICE": str(device)})
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update({str(k): str(v) for k, v in extra_env.items()})
    return env


def _tail(path, nbytes=8192):
    """The last nbytes of a rank's log (all of it for None)."""
    try:
        with open(path, "rb") as f:
            if nbytes is not None:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() - nbytes))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def _parse_result(out):
    """The last MPRESULT line of a rank's log, or None."""
    for line in reversed(out.splitlines()):
        if line.startswith("MPRESULT "):
            return json.loads(line[len("MPRESULT "):])["result"]
    return None


def run_ranks_subprocess(size: int, spec: str, payload: Any = None, *,
                         timeout: float = DEFAULT_WORKER_TIMEOUT,
                         device: str = "cuda",
                         extra_env: Optional[dict] = None,
                         fail_grace: float = 8.0,
                         log_dir: Optional[str] = None) -> List[Any]:
    """Drive ``fn(comm, payload)`` in ``size`` real processes over a
    localhost rendezvous; the per-rank results in rank order.

    ``payload`` must be JSON-serializable and reaches every rank as it
    is.  A rank that dies raises :class:`RankFailure` after the others
    have had ``fail_grace`` seconds to notice (their collectives time out
    and flight records land); past ``timeout`` every rank is killed and
    the call raises.  Every process this starts is gone when it returns.
    ``log_dir``: keep the ranks' logs there (else a temporary directory).
    """
    if device == "cuda":
        from .. import _build
        _build.build()
    port = free_port()
    procs, logs = [], []
    with tempfile.TemporaryDirectory(prefix="lgbt_mp_") as td:
        logd = log_dir or td
        os.makedirs(logd, exist_ok=True)
        payload_path = os.path.join(td, "payload.json")
        with open(payload_path, "w") as f:
            json.dump(payload, f)
        try:
            for rank in range(size):
                log_path = os.path.join(logd, "rank%d.log" % rank)
                logs.append(log_path)
                lf = open(log_path, "wb")
                procs.append((subprocess.Popen(
                    [sys.executable, "-m",
                     "lightgbm_tpu_torch.parallel.launch", "--child", spec,
                     payload_path],
                    stdout=lf, stderr=subprocess.STDOUT, cwd=REPO_ROOT,
                    env=_worker_env(port, size, rank, device, extra_env)),
                    lf))
            deadline = time.time() + float(timeout)
            first_death = None
            while True:
                codes = [p.poll() for p, _ in procs]
                if all(c is not None for c in codes):
                    break
                if first_death is None and any(
                        c is not None and c != 0 for c in codes):
                    first_death = time.time()
                if (first_death is not None
                        and time.time() - first_death > float(fail_grace)):
                    break
                if time.time() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p, lf in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                lf.close()
        outs = [_tail(path, 65536) for path in logs]
        codes = {r: p.poll() for r, (p, _) in enumerate(procs)}
        # the result line may be longer than a tail (model texts)
        results = {r: _parse_result(_tail(path, None))
                   for r, path in enumerate(logs)}
        failed = [r for r, c in codes.items()
                  if c != 0 or results[r] is None]
        if failed:
            raise RankFailure(
                failed, codes, {r: outs[r][-2048:] for r in failed},
                {r: v for r, v in results.items() if v is not None})
        return [results[r] for r in range(size)]


def _child(argv):
    """A rank's entry: bootstrap the world, run the spec, leave."""
    spec, payload_path = argv
    from .comm import distributed_init, distributed_shutdown
    comm = distributed_init(
        device_type=os.environ.get("LGBM_RANK_DEVICE", "cuda"))
    with open(payload_path) as f:
        payload = json.load(f)
    import importlib
    mod_name, fn_name = spec.split(":")
    fn = getattr(importlib.import_module(mod_name), fn_name)
    try:
        result = fn(comm, payload)
    finally:
        distributed_shutdown()
    sys.stdout.write("MPRESULT " + json.dumps(
        {"rank": comm.rank, "result": result}) + "\n")
    sys.stdout.flush()
    return 0


def main(argv=None):
    import argparse
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv[:1] == ["--child"]:
        return _child(argv[1:])
    ap = argparse.ArgumentParser(
        prog="python -m lightgbm_tpu_torch.parallel.launch")
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    ap.add_argument("--timeout", type=float, default=DEFAULT_WORKER_TIMEOUT)
    ap.add_argument("spec")
    ap.add_argument("payload", nargs="?", default="")
    args = ap.parse_args(argv)
    payload = {}
    if args.payload:
        with open(args.payload) as f:
            payload = json.load(f)
    for r, res in enumerate(run_ranks_subprocess(
            args.ranks, args.spec, payload, timeout=args.timeout,
            device=args.device)):
        print("rank %d: %s" % (r, json.dumps(res)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
