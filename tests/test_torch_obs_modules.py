"""The port's single-process observer modules against the JAX package's
on the same records: compile attribution, the roofline join, the live
plane, the watchdog, the ledger, drift, the incident engine and the
sampling profiler.  Each module gets a few of the JAX package's own test
cases at small size, and the readers are held to the JAX package's on
the same events: ``classify_signal``, ``psi``/``ks_stat``,
``rolling_stats``/``change_points``, a ledger written by one package
read by the other, and a port timeline with every observer on
validating under the JAX package's ``validate_event(strict=True)``.

No test asserts a wall-clock overhead (a machine under load makes any
such bound flaky); every HTTP read and watchdog wait has its own
timeout.
"""
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from lightgbm_tpu.obs import drift as jdrift
from lightgbm_tpu.obs import incident as jincident
from lightgbm_tpu.obs import ledger as jledger
from lightgbm_tpu.obs import roofline as jroofline
from lightgbm_tpu.obs.events import validate_event as jvalidate
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.parallel.comm import run_ranks
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.obs import compile as tcompile
from lightgbm_tpu_torch.obs import drift as tdrift
from lightgbm_tpu_torch.obs import incident as tincident
from lightgbm_tpu_torch.obs import ledger as tledger
from lightgbm_tpu_torch.obs import prof as tprof
from lightgbm_tpu_torch.obs import roofline as troofline
from lightgbm_tpu_torch.obs.events import RunObserver, read_events
import torch
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

PROV = {"git_rev": "feedc0ffee12", "git_dirty": False,
        "hostname": "testhost", "argv": ["bench.py"]}
BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 31,
        "min_data_in_leaf": 5, "verbose": -1}


def _data(n=600, f=5, seed=0, loc=0.0):
    rng = np.random.default_rng(seed)
    X = rng.normal(loc=loc, size=(n, f))
    y = (X @ np.linspace(1.0, -1.0, f) + 0.2 * rng.normal(size=n)
         > 0).astype(float)
    return X, y


def _get(url, timeout=10):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _wait(cond, timeout=20.0):
    """Poll cond() until true or the timeout; returns its last value."""
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.05)
    return cond()


# ---------------------------------------------------------------- compile
def test_signature_names_shape_dtype_and_device():
    import torch
    a = tcompile.arg_signature((torch.zeros(4, 3), 0.5),
                               names=("score", "scale"))
    b = tcompile.arg_signature((torch.zeros(6, 3, dtype=torch.float64),
                                0.5), names=("score", "scale"))
    assert tcompile.render_signature(a) == {
        "score": "float32[4,3]@cpu", "scale": "static:0.5"}
    diff = tcompile.diff_signatures(a, b)
    assert {"arg": "score", "field": "shape", "axis": 0, "before": 4,
            "after": 6} in diff
    assert {"arg": "score", "field": "dtype", "before": "float32",
            "after": "float64"} in diff


def test_forced_recapture_counts_sig_compiles_and_fails_the_gate(
        tmp_path, capsys):
    """The same graph captured twice for one signature is thrash:
    sig_compiles 2, and `obs recompiles --check` exits 1."""
    import torch
    path = str(tmp_path / "c.jsonl")
    obs = RunObserver(events_path=path, compile_attr=True, prof_hz=0)
    args = (torch.zeros(8), 0.1)
    cost = troofline.launches_cost({"score_update": 1}, n=8, ncols=1,
                                   bins=2, slots=1, leaves=3)
    for _ in range(2):
        obs.capture("fused_iter.score", args, names=("score", "scale"),
                    seconds=0.01, cost=cost)
    obs.close()
    events = read_events(path)
    attrs = [e for e in events if e["ev"] == "compile_attr"]
    assert [a["sig_compiles"] for a in attrs] == [1, 2]
    assert attrs[0]["cost"] == {"flops": 8.0, "bytes_accessed": 108.0}
    assert [e["entry"] for e in events if e["ev"] == "compile"] == [
        "fused_iter.score"]
    for e in events:
        jvalidate(e, strict=True)
    assert tcli.main(["obs", "recompiles", path]) == 0
    assert tcli.main(["obs", "recompiles", path, "--check"]) == 1
    assert "THRASH" in capsys.readouterr().out


def test_first_kernel_build_is_a_compile_and_a_failed_capture_is_none(
        monkeypatch):
    """entry_args/entry_end attribute the kernels' first build to the
    call that triggered it; a capture that raises reports nothing."""
    import torch
    from lightgbm_tpu_torch import _build
    from lightgbm_tpu_torch.ops import fused_iter
    obs = RunObserver(compile_attr=True, prof_hz=0)
    obs.entry_args("tree_grow", None, (torch.zeros(3),), names=("X",))
    monkeypatch.setattr(_build, "loads", _build.loads + 1)
    obs.entry_end("tree_grow", obs.entry_start())
    (attr,) = [e for e in obs.timeline if e["ev"] == "compile_attr"]
    assert attr["entry"] == "tree_grow" and attr["n_compiles"] == 1
    assert "kernel library" in attr["diff"][0]["note"]

    def boom(fn):
        raise RuntimeError("capture failed")
    monkeypatch.setattr(fused_iter, "_Graph", boom)
    fi = fused_iter.FusedIteration.__new__(fused_iter.FusedIteration)
    fi.observer = obs
    with pytest.raises(RuntimeError):
        fi._graph("tree", lambda: None, torch.zeros(3))
    assert sum(e["ev"] == "compile_attr" for e in obs.timeline) == 1
    obs.close()


# --------------------------------------------------------------- roofline
def _roofline_events():
    return [
        {"ev": "run_header", "t": 0, "run": "r", "schema": 16,
         "backend": "cuda", "params": {}, "context": {}, "timing": "phase",
         "provenance": PROV,
         "devices": [{"id": 0, "kind": "NVIDIA H100 80GB HBM3"}]},
        {"ev": "compile_attr", "t": 1, "run": "r",
         "entry": "fused_iter.tree", "n_compiles": 1, "sig": {},
         "cost": {"flops": 1e9, "bytes_accessed": 3.35e9}},
        {"ev": "compile_attr", "t": 1, "run": "r",
         "entry": "fused_iter.tail", "n_compiles": 1, "sig": {},
         "cost": {"flops": 5e8, "bytes_accessed": 1e9}},
        {"ev": "compile_attr", "t": 1, "run": "r",
         "entry": "fused_iter.score", "n_compiles": 1, "sig": {},
         "cost": {"flops": 1e6, "bytes_accessed": 2.4e7}},
        {"ev": "run_end", "t": 2, "run": "r", "iters": 4,
         "phase_totals": {}, "entries": {
            "fused_iter": {"exec_mean_s": 0.01, "exec_n": 4,
                           "exec_total_s": 0.04}}},
    ]


def test_timeline_roofline_sums_the_iteration_graphs():
    """fused_iter's cost is its tree and score graphs' (the tail runs
    only for trees the tree graph did not finish)."""
    res = troofline.timeline_roofline(_roofline_events())
    assert res["problems"] == [] and res["peaks"]["source"] == "table"
    (row,) = res["rows"]
    assert row["entry"] == "fused_iter" and row["has_cost"]
    assert row["bytes_accessed"] == 3.35e9 + 2.4e7
    # 3.374e9 bytes over 3.35 TB/s is ~1 ms of a 10 ms call
    assert row["bound"] == "memory"
    assert row["hbm_util"] == pytest.approx(0.10072, rel=1e-3)


def test_utilization_rollup_matches_the_jax_package():
    peaks = troofline.peaks_for("NVIDIA H100 80GB HBM3")
    summary = {"a": {"exec_mean_s": 0.002, "exec_n": 3,
                     "exec_total_s": 0.006},
               "b": {"exec_mean_s": 0.02, "exec_n": 1,
                     "exec_total_s": 0.02}}
    costs = {"a": {"flops": 1e9, "bytes_accessed": 1e9},
             "b": {"flops": 1e11, "bytes_accessed": 1e8}}
    got = troofline.utilization_rollup(summary, costs, peaks)
    want = jroofline.utilization_rollup(summary, costs, peaks)
    for k in ("flop_util", "hbm_util", "headroom_s", "bound", "entries"):
        assert got[k] == want[k], k
    assert troofline.utilization_rollup(summary, {}, peaks) is None


def test_launches_cost_counts_each_kernel_as_the_bound_column():
    shape = dict(n=1000, ncols=4, bins=16, slots=8, leaves=31)
    f1, b1 = troofline.launch_traffic("wave_partition_hist", **shape)
    f3, b3 = troofline.launch_traffic("wave_histogram", **shape)
    assert f1 == f3 == 3 * 1000 * 4
    assert b1 > b3
    got = troofline.launches_cost({"wave_partition_hist": 2,
                                   "score_update": 1}, **shape)
    assert got == {"flops": 2 * f1 + 1000, "bytes_accessed":
                   2 * b1 + 1000 * 12 + 31 * 4}
    assert troofline.launches_cost({"score_update": 0}, **shape) is None


def test_roofline_cli(tmp_path, capsys):
    path = str(tmp_path / "r.jsonl")
    with open(path, "w") as f:
        for e in _roofline_events():
            f.write(json.dumps(e) + "\n")
    assert tcli.main(["obs", "roofline", path, "--check"]) == 0
    assert "fused_iter" in capsys.readouterr().out
    bare = [e for e in _roofline_events() if e["ev"] != "compile_attr"]
    with open(path, "w") as f:
        for e in bare:
            f.write(json.dumps(e) + "\n")
    assert tcli.main(["obs", "roofline", path, "--check"]) == 1


# ------------------------------------------------------------------- live
def test_live_plane_endpoints_and_teardown(tmp_path):
    obs = RunObserver(events_path=str(tmp_path / "ev.jsonl"), http_port=0,
                      prof_hz=0)
    url = obs.live_url
    assert int(url.rsplit(":", 1)[1]) > 0
    try:
        for it in range(3):
            obs.iter_begin(it)
            obs.iter_end(it)
        code, headers, body = _get(url + "/metrics")
        assert code == 200 and headers["Content-Type"].startswith(
            "text/plain")
        assert "lgbm_train_iterations_total" in body
        code, _, body = _get(url + "/statusz")
        s = json.loads(body)
        assert code == 200 and s["iters"] == 3 and s["last_it"] == 2
        code, _, body = _get(url + "/events?after=0")
        assert code == 200 and '"ev": "iter"' in body.replace('":"', '": "')
        assert _get(url + "/healthz")[0] == 200
        obs.event("health", check="nonfinite_gradients", status="fatal",
                  it=3)
        assert _get(url + "/healthz")[0] == 503
    finally:
        obs.close()
    assert obs.live_url == ""
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(url + "/healthz", timeout=2.0)


def test_watch_once_renders_a_timeline(tmp_path, capsys):
    path = str(tmp_path / "ev.jsonl")
    X, y = _data()
    lgbt.train(dict(BASE, obs_events_path=path, obs_prof_hz=0),
               lgbt.Dataset(X, label=y), 3, device="cpu")
    assert tcli.main(["obs", "watch", path, "--once"]) == 0
    assert "iter" in capsys.readouterr().out
    # --ranks tails every .rN shard of a distributed run (two thread
    # ranks of the data-parallel learner) and aligns their iterations
    base = str(tmp_path / "dist.jsonl")

    def rank(comm):
        from lightgbm_tpu_torch.io.dataset import TrainingData
        from lightgbm_tpu_torch.utils.config import Config
        p = dict(BASE, obs_events_path=base, obs_prof_hz=0,
                 tree_learner="data")
        lo, hi = comm.rank * len(X) // 2, (comm.rank + 1) * len(X) // 2
        ds = lgbt.Dataset(X[lo:hi], label=y[lo:hi])
        ds._handle = TrainingData.from_matrix(
            X[lo:hi], label=y[lo:hi], config=Config(dict(p)), comm=comm)
        lgbt.train(p, ds, 3, device="cpu")

    run_ranks(2, rank, barrier_timeout=60)
    assert tcli.main(["obs", "watch", base, "--once", "--ranks"]) == 0
    out = capsys.readouterr().out
    assert "watching 2 shard(s)" in out and base + ".r1" in out


# --------------------------------------------------------------- watchdog
def test_watchdog_writes_a_flight_record_on_a_stall(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    obs = RunObserver(events_path=path, watchdog_secs=0.3, prof_hz=0)
    try:
        obs.iter_begin(0)
        flight = path + ".flight.json"
        assert _wait(lambda: os.path.exists(flight))
        rec = json.load(open(flight))
        assert "iter 0" in rec["label"]
        assert rec["threads"] and rec["devices"]
    finally:
        obs.close()


# ----------------------------------------------------------------- ledger


def _events(run, t, ips, git_rev=None):
    prov = dict(PROV, git_rev=git_rev or PROV["git_rev"])
    return [
        {"ev": "run_header", "run": run, "t": t, "schema": 16,
         "backend": "gpu", "devices": [{"id": 0, "kind":
                                        "NVIDIA H100 80GB HBM3"}],
         "provenance": prov, "context": {}},
        {"ev": "iter", "run": run, "t": t + 1, "it": 0,
         "time_s": 1.0 / ips},
        {"ev": "iter", "run": run, "t": t + 2, "it": 1,
         "time_s": 1.0 / ips},
        {"ev": "run_end", "run": run, "t": t + 3, "status": "ok",
         "entries": {"boost": {"first_s": 1.5}}},
    ]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_ledger_written_by_one_package_reads_in_the_other(tmp_path,
                                                          writer):
    path = str(tmp_path / "led")
    w = tledger if writer == "torch" else jledger
    r = jledger if writer == "torch" else tledger
    led = w.Ledger(path)
    for i in range(5):
        assert led.ingest_events(_events("r%d" % i, 1e9 + 100 * i, 5.0),
                                 suite="bench") == 1
    assert led.ingest_events(_events("bad", 1e9 + 900, 2.5,
                                     "badbadbad123"), suite="bench") == 1
    got = r.Ledger(path).entries()
    assert got == w.Ledger(path).entries() and len(got) == 6
    for mod in (tledger, jledger):
        (cp,) = mod.change_points(got, "iters_per_sec")
        assert cp["run"] == "bad" and cp["regression"]
    assert tledger.change_points(got, "iters_per_sec") == \
        jledger.change_points(got, "iters_per_sec")
    vals = [r_["metrics"]["iters_per_sec"] for r_ in got]
    assert tledger.rolling_stats(vals, 4) == jledger.rolling_stats(vals, 4)
    assert tcli.main(["obs", "trend", path, "--check"]) == 1
    assert tcli.main(["obs", "history", path]) == 0


def test_training_run_lands_in_the_ledger(tmp_path):
    X, y = _data()
    led = str(tmp_path / "led")
    lgbt.train(dict(BASE, obs_ledger_dir=led, obs_ledger_suite="unit",
                    obs_prof_hz=0), lgbt.Dataset(X, label=y), 3,
               device="cpu")
    (rec,) = jledger.Ledger(led).entries()
    assert rec["suite"] == "unit" and rec["device_kind"] == "cpu"
    assert rec["metrics"]["iters_per_sec"] > 0


# ------------------------------------------------------------------ drift
def test_psi_and_ks_match_the_jax_package():
    rng = np.random.default_rng(3)
    for _ in range(5):
        a = rng.integers(0, 50, size=12)
        b = rng.integers(0, 50, size=12)
        assert tdrift.psi(a, b) == jdrift.psi(a, b)
        assert tdrift.ks_stat(a, b) == jdrift.ks_stat(a, b)


@pytest.fixture(scope="module")
def drift_booster():
    X, y = _data(1500, 6)
    ds = lgbt.Dataset(X, label=y)
    return lgbt.train(dict(BASE, metric="auc"), ds, 6, valid_sets=[ds],
                      valid_names=["train"], device="cpu")


def test_fingerprint_is_the_jax_packages_and_reads_from_its_text(
        drift_booster):
    """The dataset's fingerprint is the JAX package's on the same rows;
    the model text the JAX package writes (with its drift_fingerprint=
    line) loads into the port with that fingerprint, which drives the
    port's monitor."""
    import lightgbm_tpu as lgbj
    X, y = _data(1500, 6)
    ds = lgbj.Dataset(X, label=y)
    bj = lgbj.train(dict(BASE, metric="auc"), ds, 6, valid_sets=[ds],
                    valid_names=["train"], verbose_eval=False)
    ft = drift_booster._gbdt.train_data._drift_fingerprint
    fj = bj._gbdt.train_data._drift_fingerprint
    assert json.dumps(ft, sort_keys=True) == json.dumps(fj, sort_keys=True)
    fp = drift_booster._gbdt.drift_fingerprint()
    assert fp["eval"] and fp["scores"]
    loaded = lgbt.Booster(model_str=bj.model_to_string(), device="cpu")
    want = bj._gbdt.drift_fingerprint()
    assert json.dumps(loaded._gbdt.drift_fingerprint(), sort_keys=True) \
        == json.dumps(want, sort_keys=True)
    mon = tdrift.DriftMonitor(loaded._gbdt.drift_fingerprint())
    assert mon.enabled


def test_shifted_stream_fires_iid_stays_clean(drift_booster, tmp_path):
    fp = drift_booster._gbdt.drift_fingerprint()
    path = str(tmp_path / "drill.jsonl")
    obs = RunObserver(events_path=path, prof_hz=0)
    rng = np.random.default_rng(5)
    mon = tdrift.DriftMonitor(fp, observer=obs, every_rows=256,
                              window_rows=1024, psi_threshold=0.2)
    for _ in range(20):
        Xh = rng.normal(size=(256, 6))
        mon.observe_features(Xh)
        mon.observe_scores(drift_booster.predict(Xh), raw=False)
    assert mon.alerts_fired == 0, mon.headline()
    for _ in range(4):
        mon.observe_features(rng.normal(loc=2.5, size=(256, 6)))
    assert mon.alerting and mon.alerts_fired == 1
    mon.close()
    obs.close()
    events = read_events(path)
    drifts = [e for e in events if e["ev"] == "drift"]
    assert drifts and drifts[-1]["alert"] == "firing"
    for e in events:
        jvalidate(e, strict=True)
    assert tcli.main(["obs", "drift", path, "--check"]) == 1


# --------------------------------------------------------------- incident
SIGNAL_RECORDS = [
    {"ev": "health", "status": "warn", "check": "nonfinite_gradients"},
    {"ev": "health", "status": "fatal", "check": "loss_divergence"},
    {"ev": "health", "status": "ok", "check": "nonfinite_gradients"},
    {"ev": "health", "status": "warn", "check": "stats"},
    {"ev": "compile_attr", "sig_compiles": 2},
    {"ev": "compile_attr", "sig_compiles": 1},
    {"ev": "drift", "alert": "firing"}, {"ev": "drift", "alert": "armed"},
    {"ev": "iter", "it": 3},
    {"ev": "health", "status": "warn", "check": "slo_burn_rate"},
]


def test_classify_signal_matches_the_jax_package():
    got = [tincident.classify_signal(r) for r in SIGNAL_RECORDS]
    assert got == [jincident.classify_signal(r) for r in SIGNAL_RECORDS]
    assert got[:3] == ["nonfinite_gradients", "loss_divergence", None]


def test_nan_gradients_open_one_incident_with_evidence(tmp_path):
    """A custom objective whose gradients hold a NaN trips the health
    guard, which opens one incident with its evidence bundle."""
    X, y = _data()
    path = str(tmp_path / "ev.jsonl")

    def fobj(preds, data):
        g = preds - data.get_label()
        g[0] = np.nan
        return g, np.ones_like(g)

    lgbt.train(dict(BASE, obs_events_path=path, obs_health="warn",
                    obs_incident=True, obs_prof_hz=0, objective="none"),
               lgbt.Dataset(X, label=y), 2, fobj=fobj, device="cpu")
    events = read_events(path)
    opens = [e for e in events if e["ev"] == "incident_open"]
    assert len(opens) == 1
    assert opens[0]["trigger"] == "nonfinite_gradients"
    assert any(e["ev"] == "incident_evidence" for e in events)
    for e in events:
        jvalidate(e, strict=True)
    assert events[-1]["incidents"]["opened"] == 1
    assert tcli.main(["obs", "incident", path, "--check"]) == 1


# ------------------------------------------------------------------- prof
def test_package_frames_keep_their_suffix():
    path = os.path.join(os.sep, "x", "lightgbm_tpu_torch", "ops",
                        "wave.py")
    assert tprof._short_path(path) == "lightgbm_tpu_torch/ops/wave.py"


def test_frame_labels_are_memoized_per_code_object():
    """The fold's labels: 'shortpath:function' per frame, root first, one
    memo entry per code object (keyed by its id, checked by identity)."""
    import sys

    def inner():
        return tprof.fold_frames(sys._getframe())

    def outer():
        return inner()

    labels = outer()
    assert labels[-2:] == [
        "%s:outer" % tprof._short_path(__file__),
        "%s:inner" % tprof._short_path(__file__)]
    entry = tprof._LABEL_MEMO[id(inner.__code__)]
    assert entry[0] is inner.__code__ and entry[1] == labels[-1]
    assert outer() == labels


def test_profiled_run_validates_under_the_jax_schema(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    X, y = _data()
    lgbt.train(dict(BASE, obs_events_path=path, obs_prof_hz=97,
                    obs_prof_window_s=0.2), lgbt.Dataset(X, label=y), 5,
               device="cpu")
    events = read_events(path)
    profs = [e for e in events if e["ev"] == "prof_profile"]
    assert profs and all(p["hz"] == 97 for p in profs)
    for e in events:
        jvalidate(e, strict=True)
    assert not [p for p in profs if p.get("error")]


# ------------------------------------------------- every observer on
def test_a_timeline_with_every_observer_validates_under_the_jax_schema(
        tmp_path):
    X, y = _data()
    path = str(tmp_path / "ev.jsonl")
    params = dict(BASE, obs_events_path=path, obs_compile=True,
                  obs_utilization_every=1, obs_watchdog_secs=60.0,
                  obs_incident=True, obs_http_port=0,
                  obs_ledger_dir=str(tmp_path / "led"), obs_drift_every=200,
                  obs_health="warn", obs_metrics_every=1, metric="auc")
    ds = lgbt.Dataset(X, label=y)
    b = lgbt.train(params, ds, 3, valid_sets=[ds], device="cpu")
    events = read_events(path)
    for e in events:
        jvalidate(e, strict=True)
    names = {e["ev"] for e in events}
    assert {"run_header", "iter", "run_end", "prof_profile"} <= names
    assert "incidents" in events[-1] and "compile_attr" in events[-1]
    assert len(tledger.Ledger(str(tmp_path / "led")).entries()) == 1
    assert tcli.main(["obs", "summary", path]) == 0
    # the profile report (its --check overhead budget is a wall-clock
    # bound, held on the card's longer runs only)
    assert tcli.main(["obs", "prof", path]) == 0
    assert b.predict(X).shape == (X.shape[0],)


def test_capture_guard_pauses_the_collector_and_holds_the_lock():
    """A graph capture runs with Python's cyclic collector paused (a
    collection on the sampling profiler's thread, or any other, could
    free an earlier booster's graphs mid-capture) and the capture lock
    held; both are restored after, on an error too."""
    import gc
    from lightgbm_tpu_torch.device import CAPTURE_LOCK, capture_guard
    assert gc.isenabled()
    with capture_guard():
        assert not gc.isenabled() and CAPTURE_LOCK.locked()
    assert gc.isenabled() and not CAPTURE_LOCK.locked()
    with pytest.raises(RuntimeError):
        with capture_guard():
            raise RuntimeError("capture failed")
    assert gc.isenabled() and not CAPTURE_LOCK.locked()
