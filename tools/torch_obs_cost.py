"""The run observer's cost on the port's main path and in serving, on
the card: the flagship recipe at 2M rows (chip_smoke.py's data) trained
fused for 8 iterations with each group of observers on, twice in one
call, and bench_serve.py's model served under its closed loop (8
threads, 2,000 requests) with no observer, an observer, an observer
without SLO snapshots and an observer with drift monitoring.

    python tools/torch_obs_cost.py      # on a machine with a CUDA card
"""
import os, sys, time, tempfile, threading
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, torch
import chip_smoke as cs
import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs import observer_from_config
from lightgbm_tpu_torch.utils.config import Config
card = cs.card_line(); print("card:", card, flush=True)
work = tempfile.mkdtemp()
X, y = cs.make_data(2_000_000 + cs.VALID_ROWS)
Xt, yt, Xv, yv = X[:2_000_000], y[:2_000_000], X[2_000_000:], y[2_000_000:]
ds = lgb.Dataset(Xt, label=yt, params=cs.flagship_params()).construct()
dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
def run(label, extra, iters=8):
    stamps = []
    def stamp(env):
        torch.cuda.synchronize(); stamps.append(time.perf_counter())
    lgb.train(dict(cs.flagship_params(), **extra), ds, iters, valid_sets=[dv], callbacks=[stamp])
    r = (len(stamps) - 2) / (stamps[-1] - stamps[1])
    print("%-28s steady %.4f it/s (iterations 3-%d)" % (label, r, iters), flush=True)
ev = lambda n: os.path.join(work, n + ".jsonl")
for rep in range(2):
    run("off", {})
    run("events, timing=phase", {"obs_events_path": ev("a"), "obs_prof_hz": 0})
    run("events, timing=iter", {"obs_events_path": ev("b"), "obs_timing": "iter", "obs_prof_hz": 0})
    run("events, timing=off", {"obs_events_path": ev("c"), "obs_timing": "off", "obs_prof_hz": 0})
    run("timing=off + prof 29 Hz", {"obs_events_path": ev("d"), "obs_timing": "off"})
    run("timing=off + compile/util", {"obs_events_path": ev("e"), "obs_timing": "off", "obs_prof_hz": 0, "obs_compile": True, "obs_utilization_every": 1})
    run("timing=off + watchdog/incident/http/ledger", {"obs_events_path": ev("f"), "obs_timing": "off", "obs_prof_hz": 0, "obs_watchdog_secs": 120, "obs_incident": True, "obs_http_port": 0, "obs_ledger_dir": os.path.join(work, "led")})
    run("all (14c)", {"obs_events_path": ev("g"), "obs_compile": True, "obs_utilization_every": 1, "obs_watchdog_secs": 120, "obs_incident": True, "obs_http_port": 0, "obs_ledger_dir": os.path.join(work, "led")})
del ds, dv
# serving
Xs, ys, Xf, yf = cs.make_serve_data(cs.SERVE_ROWS, cs.SERVE_ROWS)
b = lgb.train({"objective": "binary", "num_leaves": cs.SERVE_LEAVES, "verbose": -1}, lgb.Dataset(Xs, label=ys), cs.SERVE_ROUNDS)
ladder = [1 << k for k in range(6, 13)]
for label, cfg, over in (("no observer", None, {}),
                         ("observer", {"obs_events_path": ev("s1")}, {}),
                         ("observer, no SLO", {"obs_events_path": ev("s2"), "serve_slo_every_s": 0}, {}),
                         ("observer + drift", {"obs_events_path": ev("s3")}, {"drift_every": 16384, "drift_window": 65536}),
                         ("no observer", None, {})):
    obs = observer_from_config(Config(cfg)) if cfg else None
    kw = dict(over)
    if obs is not None:
        kw["observer"] = obs
        if "serve_slo_every_s" in cfg:
            kw["slo_every_s"] = 0
    sp = b.serve(max_batch=4096, max_delay_ms=2.0, **kw)
    sp.warmup(ladder)
    lat, wall, rows, _ = cs.run_load(sp, Xf, 2000, 8, cs.SERVE_SIZES)
    sp.close()
    if obs is not None:
        obs.close()
    print("serve %-20s p50 %.6f s p99 %.6f s %.1f req/s" % (label, np.percentile(lat, 50), np.percentile(lat, 99), len(lat) / wall), flush=True)
