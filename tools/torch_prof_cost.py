"""Which part of the sampling profiler slows the port's fused main
path, on the card: the flagship recipe at 2M rows trained fused for 10
iterations with no observer, with the profiler at 1, 5, 29 and 97 Hz,
and beside threads that wake at 29 Hz and do nothing, walk
sys._current_frames, or also enumerate the threads; twice in one call.

    python tools/torch_prof_cost.py     # on a machine with a CUDA card
"""
import os, sys, tempfile, time, threading
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, torch
import chip_smoke as cs
import lightgbm_tpu_torch as lgb
card = cs.card_line(); print("card:", card, flush=True)
X, y = cs.make_data(2_000_000 + cs.VALID_ROWS)
Xt, yt, Xv, yv = X[:2_000_000], y[:2_000_000], X[2_000_000:], y[2_000_000:]
ds = lgb.Dataset(Xt, label=yt, params=cs.flagship_params()).construct()
dv = lgb.Dataset(Xv, label=yv, reference=ds).construct()
def run(label, extra, iters=10):
    stamps = []
    def stamp(env):
        torch.cuda.synchronize(); stamps.append(time.perf_counter())
    lgb.train(dict(cs.flagship_params(), **extra), ds, iters, valid_sets=[dv], callbacks=[stamp])
    r = (len(stamps) - 2) / (stamps[-1] - stamps[1])
    print("%-34s steady %.4f it/s (iterations 3-%d)" % (label, r, iters), flush=True)
def with_thread(label, body, hz=29):
    stop = threading.Event()
    def loop():
        while not stop.wait(1.0 / hz):
            body()
    t = threading.Thread(target=loop, daemon=True); t.start()
    run(label, {})
    stop.set(); t.join()
print("switch interval", sys.getswitchinterval())
for rep in range(2):
    run("off", {})
    for hz in (1, 5, 29, 97):
        run("events + prof %d Hz" % hz, {"obs_events_path": os.path.join(tempfile.mkdtemp(), "pc.jsonl"), "obs_timing": "off", "obs_prof_hz": hz})
    with_thread("bare thread wake 29 Hz", lambda: None)
    with_thread("thread _current_frames 29 Hz", lambda: sys._current_frames())
    with_thread("thread enumerate+frames 29 Hz", lambda: (threading.enumerate(), sys._current_frames()))
