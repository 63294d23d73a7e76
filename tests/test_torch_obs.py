"""The port's run observer (lightgbm_tpu_torch/obs/) against the JAX
package's (lightgbm_tpu/obs/), on the CPU.

* a small run's timeline validates under the JAX package's
  ``validate_event(strict=True)``, gives the JAX run's sequence of event
  names for the same params and data (the JAX-only ``prof_profile``
  windows left out), and the JAX package's ``render_summary`` and
  ``render_explain`` read it;
* ``split_audit``, ``importance``, ``importance_history`` and
  ``data_profile`` equal what the JAX package's obs/model.py and
  obs/dataquality.py make of the same trees and the same bins;
* health under ``obs_health=fatal`` raises on a non-finite custom
  objective, and the timeline ends ``aborted``;
* the fence audit: a run with the NULL observer moves ``fence_count`` by
  0, one under ``obs_timing=iter`` by one an iteration;
* ``obs summary|explain|diff|trace`` exit 0 through the CLI, and the
  subcommands of modules the port lacks raise naming ROADMAP A12;
* every ``obs_*`` key either acts (each is checked for its effect) or
  raises naming its ROADMAP item, in ``train``, ``Booster``, ``cv`` and
  the CLI: none is accepted and then ignored.
"""
import glob
import json
import os
import shutil

import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
from lightgbm_tpu.obs import dataquality as jdq
from lightgbm_tpu.obs import model as jmodel
from lightgbm_tpu.obs import query as jquery
from lightgbm_tpu.obs.events import validate_event
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch import cli as tcli
from lightgbm_tpu_torch.obs import memory, timers
from lightgbm_tpu_torch.obs.ledger import Ledger
from lightgbm_tpu_torch.ops import autotune as tat
from lightgbm_tpu_torch.utils.config import Config
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))

# the parity oracle's wave params (both packages grow the same trees)
BASE = {"objective": "binary", "num_leaves": 15, "verbose": -1,
        "min_data_in_leaf": 5, "tpu_growth": "wave", "tpu_wave_width": 4,
        "tpu_histogram_mode": "pallas_ct", "tpu_hist_precision": "hilo"}
OBS = {"obs_split_audit": True, "obs_importance_every": 1,
       "obs_health": "warn", "obs_memory_every": 2, "obs_metrics_every": 2,
       "obs_timing": "iter"}


def _data(n=1200, f=6, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.standard_normal(n)
         > 0).astype(float)
    return X, y


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The same small run through both packages, with its timelines."""
    d = tmp_path_factory.mktemp("obs")
    X, y = _data()
    out = {}
    for name, lgb, kw, extra in (
            ("jax", lgbj, {}, {"tpu_pallas_interpret": True}),
            ("torch", lgbt, {"device": "cpu"}, {})):
        p = dict(BASE, **OBS, **extra,
                 obs_events_path=str(d / ("%s.jsonl" % name)))
        ds = lgb.Dataset(X[:1000], label=y[:1000], params=p)
        dv = lgb.Dataset(X[1000:], label=y[1000:], reference=ds)
        b = lgb.train(p, ds, 3, valid_sets=[dv], **kw)
        out[name] = (b, _events(p["obs_events_path"]), ds)
    return out


def test_timeline_validates_in_the_jax_package(runs):
    _, events, _ = runs["torch"]
    assert events[0]["ev"] == "run_header" and events[-1]["ev"] == "run_end"
    for e in events:
        validate_event(e, strict=True)
    header = events[0]
    assert header["backend"] == "cpu" and header["devices"][0]["kind"] == "cpu"
    assert header["context"]["torch"] and header["timing"] == "iter"
    assert events[-1]["status"] == "ok" and events[-1]["iters"] == 3


def test_event_sequence_matches_the_jax_package(runs):
    names = {k: [e["ev"] for e in ev if e["ev"] != "prof_profile"]
             for k, (_, ev, _) in runs.items()}
    assert names["torch"] == names["jax"]


def test_the_jax_renderers_read_the_port_timeline(runs, capsys):
    _, events, _ = runs["torch"]
    events = jquery.last_run(events)
    jquery.render_summary(events)
    assert not jquery.render_explain(events)
    out = capsys.readouterr().out
    assert "iters 3" in out and "autotune: off/off" in out
    assert "split-audit gain margins" in out and "convergence" in out


def test_model_and_data_events_equal_the_jax_package(runs):
    b, events, ds = runs["torch"]
    gbdt = b._gbdt
    audits = [e for e in events if e["ev"] == "split_audit"]
    assert len(audits) == 3
    for e in audits:
        splits, truncated = jmodel.tree_split_records(gbdt.models[e["tree"]])
        assert e["splits"] == json.loads(json.dumps(splits))
        assert e["truncated"] == truncated
        assert any("second_feature" in s for s in e["splits"])

    class Sink:
        def event(self, ev, **fields):
            self.got = dict(fields, ev=ev)
    sink = Sink()
    jmodel.emit_importance(sink, 2, b.feature_importance("split"),
                           b.feature_importance("gain"), 20)
    last = [e for e in events if e["ev"] == "importance"][-1]
    assert {k: last[k] for k in sink.got} == json.loads(
        json.dumps(sink.got))
    for kind in ("split", "gain"):
        assert b.importance_history(kind) == \
            jmodel.importance_history(events, kind)
    assert len(b.importance_history()) == 3
    # the data profile: the JAX package's profile of the same bins
    jds = lgbj.Dataset(ds.data, label=ds.label,
                       params=dict(BASE)).construct()._handle
    prof = ds._handle.data_profile
    assert prof == jds._data_profile
    label = jdq.label_profile(jds.metadata.label)
    findings = jdq.build_findings(prof, label, jds.feature_names)
    (ev,) = [e for e in events if e["ev"] == "data_profile"]
    want = dict(prof, dataset="train", label=label, findings=findings)
    assert {k: ev[k] for k in want} == json.loads(json.dumps(want))


def test_health_fatal_raises_on_a_nonfinite_custom_objective(tmp_path):
    X, y = _data(400)

    def nan_grad(preds, data):
        g = np.full(len(preds), np.nan)
        return g, np.ones(len(preds))

    p = dict(BASE, obs_health="fatal",
             obs_events_path=str(tmp_path / "ev.jsonl"))
    with pytest.raises(lgbt.LightGBMError, match="obs_health=fatal"):
        lgbt.train(p, lgbt.Dataset(X, label=y), 3, fobj=nan_grad,
                   device="cpu")
    events = _events(tmp_path / "ev.jsonl")
    fatal = [e["check"] for e in events if e["ev"] == "health"
             and e["status"] == "fatal"]
    assert fatal == ["stats", "nonfinite_gradients"]
    assert events[-1]["ev"] == "run_end"
    assert events[-1]["status"] == "aborted"


def test_the_fence_audit(tmp_path):
    X, y = _data(500)
    c0 = timers.fence_count()
    lgbt.train(BASE, lgbt.Dataset(X, label=y), 3, device="cpu")
    assert timers.fence_count() == c0
    p = dict(BASE, obs_timing="iter",
             obs_events_path=str(tmp_path / "ev.jsonl"))
    lgbt.train(p, lgbt.Dataset(X, label=y), 3, device="cpu")
    assert timers.fence_count() - c0 == 3


def test_memory_snapshot_on_the_cpu():
    assert memory.device_memory_stats() == [{"id": 0, "platform": "cpu"}]


def test_obs_subcommands_through_the_cli(runs, tmp_path, capsys):
    _, events, _ = runs["torch"]
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")
    assert tcli.main(["obs", "summary", path]) == 0
    assert tcli.main(["obs", "explain", path, "--check"]) == 0
    assert tcli.main(["obs", "diff", path, path]) == 0
    out = str(tmp_path / "trace.json")
    assert tcli.main(["obs", "trace", path, "-o", out]) == 0
    trace = json.load(open(out))["traceEvents"]
    assert any(t.get("name") == "iter 2" for t in trace)
    text = capsys.readouterr().out
    assert "iters 3" in text and "autotune decisions" in text
    assert tcli.main(["obs", "summary", str(tmp_path / "none.jsonl")]) == 2
    assert tcli.main(["obs", "recompiles", path]) == 0
    assert tcli.main(["obs", "roofline", path]) == 0
    # the distributed learners' reports read a one-rank timeline too
    assert tcli.main(["obs", "stragglers", path]) == 0
    assert "no straggler events" in capsys.readouterr().out
    merged = str(tmp_path / "merged.jsonl")
    assert tcli.main(["obs", "merge", path, "-o", merged]) == 0
    assert "merged 1 rank shard(s)" in capsys.readouterr().out
    head = json.loads(open(merged).readline())
    assert head["ev"] == "run_header" and head["merged"] is True


# ------------------------------------------------ every obs_* key: act
def _train(tmp_path, params, rounds=3, **kw):
    X, y = _data(400)
    return lgbt.train(dict(BASE, **params), lgbt.Dataset(X, label=y),
                      rounds, device="cpu", **kw)


def _ev(tmp_path):
    return {"obs_events_path": str(tmp_path / "ev.jsonl")}


def _names(b):
    return [e["ev"] for e in b.telemetry()]


def _check_trace(tmp_path, b):
    assert [e["action"] for e in b.telemetry()
            if e["ev"] == "trace_window"] == ["start", "stop"]
    (path,) = glob.glob(str(tmp_path / "tr" / "trace.*.json"))
    assert json.load(open(path))["traceEvents"]


def _bench(cell, bucket):
    return 1.0 / cell.wave_width


ACTS = {
    "obs_events_path": (lambda t: _ev(t), lambda t, b: [
        validate_event(e, strict=True)
        for e in _events(t / "ev.jsonl")]),
    "obs_timing": (lambda t: dict(_ev(t), obs_timing="off"),
                   lambda t, b: b.telemetry()[0]["timing"] == "off"),
    "obs_memory_every": (lambda t: {"obs_memory_every": 1},
                         lambda t, b: _names(b).count("memory") == 3),
    "obs_trace_iters": (lambda t: {"obs_trace_iters": "1:2",
                                   "obs_trace_dir": str(t / "tr")},
                        _check_trace),
    "obs_trace_dir": (lambda t: {"obs_trace_iters": "0:1",
                                 "obs_trace_dir": str(t / "tr")},
                      _check_trace),
    "obs_flush_every": (lambda t: dict(_ev(t), obs_flush_every=1),
                        lambda t, b: b._gbdt._obs._writer.flush_every == 1),
    "obs_fsync": (lambda t: dict(_ev(t), obs_fsync=True),
                  lambda t, b: b._gbdt._obs._writer.fsync),
    "obs_flight_events": (lambda t: dict(_ev(t), obs_flight_events=4),
                          lambda t, b: len(b._gbdt._obs.ring_snapshot()) == 4
                          and b._gbdt._obs.ring_snapshot()[-1]["ev"]
                          == "run_end"),
    "obs_health": (lambda t: {"obs_health": "warn"},
                   lambda t, b: _names(b).count("health") == 3),
    "obs_health_every": (lambda t: {"obs_health": "warn",
                                    "obs_health_every": 2},
                         lambda t, b: _names(b).count("health") == 2),
    "obs_health_divergence": (
        lambda t: {"obs_health": "warn", "obs_health_divergence": 1.5},
        lambda t, b: b._gbdt._obs.health.divergence == 1.5),
    "obs_health_plateau": (
        lambda t: {"obs_health": "warn", "obs_health_plateau": 2},
        lambda t, b: b._gbdt._obs.health.plateau == 2),
    "obs_health_mem_frac": (
        lambda t: {"obs_health": "warn", "obs_health_mem_frac": 0.5},
        lambda t, b: b._gbdt._obs.health.mem_frac == 0.5),
    "obs_metrics_path": (
        lambda t: {"obs_metrics_path": str(t / "m.prom")},
        lambda t, b: "lgbm_train_iterations_total"
        in open(t / "m.prom").read()),
    "obs_metrics_every": (lambda t: {"obs_metrics_every": 1},
                          lambda t, b: _names(b).count("metrics") == 4),
    "obs_split_audit": (lambda t: {"obs_split_audit": True},
                        lambda t, b: _names(b).count("split_audit") == 3),
    "obs_importance_every": (
        lambda t: {"obs_importance_every": 2},
        lambda t, b: [h["it"] for h in b.importance_history()] == [0, 2]),
    "obs_importance_topk": (
        lambda t: {"obs_importance_every": 1, "obs_importance_topk": 1},
        lambda t, b: all(len(h["importance"]) == 1
                         for h in b.importance_history())),
    "obs_data_profile": (
        lambda t: dict(_ev(t), obs_data_profile=False),
        lambda t, b: "data_profile" not in _names(b)
        and "dataset_construct" in _names(b)),
    # compile attribution: no graph is captured on the CPU, so the entry
    # calls are counted and none compiles
    "obs_compile": (lambda t: {"obs_compile": True},
                    lambda t, b: _end(b)["compile_attr"]["tree_grow"]
                    == {"calls": 3, "compiles": 0, "signatures": 0,
                        "max_sig_compiles": 0}),
    "obs_utilization_every": (
        lambda t: {"obs_utilization_every": 1},
        lambda t, b: b._gbdt._obs._utilization_every == 1
        and "compile_attr" in _end(b)),
    "obs_watchdog_secs": (
        lambda t: dict(_ev(t), obs_watchdog_secs=30.0),
        lambda t, b: b._gbdt._obs._watchdog.timeout_s == 30.0
        and not os.path.exists(str(t / "ev.jsonl.flight.json"))),
    "obs_ledger_dir": (
        lambda t: {"obs_ledger_dir": str(t / "led")},
        lambda t, b: len(Ledger(str(t / "led")).entries()) == 1),
    "obs_ledger_suite": (
        lambda t: {"obs_ledger_dir": str(t / "led"),
                   "obs_ledger_suite": "s"},
        lambda t, b: [r["suite"] for r in Ledger(str(t / "led")).entries()]
        == ["s"]),
    # read by the bench harnesses' rolling baselines, as in the JAX
    # package; training takes it
    "obs_ledger_window": (
        lambda t: {"obs_ledger_dir": str(t / "led"),
                   "obs_ledger_window": 3},
        lambda t, b: b._gbdt.config.obs_ledger_window == 3),
    "obs_drift_every": (
        lambda t: {"obs_drift_every": 100},
        lambda t, b: _predict(b) and "drift" in _names(b)),
    "obs_drift_window": (
        lambda t: {"obs_drift_every": 100, "obs_drift_window": 200},
        lambda t, b: b._predict_drift().window_rows == 200),
    "obs_drift_psi": (
        lambda t: {"obs_drift_every": 100, "obs_drift_psi": 0.5},
        lambda t, b: b._predict_drift().psi_threshold == 0.5),
    "obs_drift_fingerprint": (
        lambda t: dict(_ev(t), obs_drift_fingerprint=False),
        lambda t, b: b._gbdt.drift_fingerprint() is None
        and b._gbdt.train_data._drift_fingerprint is None),
    "obs_drift_topk": (
        lambda t: {"obs_drift_every": 100, "obs_drift_topk": 3},
        lambda t, b: b._predict_drift().topk == 3),
    "obs_drift_min_labels": (
        lambda t: {"obs_drift_every": 100, "obs_drift_min_labels": 7},
        lambda t, b: b._predict_drift().min_labels == 7),
    "obs_incident": (
        lambda t: {"obs_incident": True},
        lambda t, b: _end(b)["incidents"]["opened"] == 0),
    "obs_incident_window_s": (
        lambda t: {"obs_incident": True, "obs_incident_window_s": 1.0},
        lambda t, b: b._gbdt._obs._incident.window_s == 1.0),
    "obs_incident_dir": (
        lambda t: {"obs_incident": True,
                   "obs_incident_dir": str(t / "inc")},
        lambda t, b: b._gbdt._obs._incident.bundle_dir == str(t / "inc")),
    "obs_incident_trace": (
        lambda t: {"obs_incident": True, "obs_incident_trace": True},
        lambda t, b: b._gbdt._obs._incident.trace_enabled),
    "obs_prof_hz": (
        lambda t: dict(_ev(t), obs_prof_hz=50),
        lambda t, b: [e["hz"] for e in b.telemetry()
                      if e["ev"] == "prof_profile"][-1] == 50),
    "obs_prof_window_s": (
        lambda t: dict(_ev(t), obs_prof_window_s=1.0),
        lambda t, b: b._gbdt._obs._prof_window_s == 1.0),
    "obs_prof_topk": (
        lambda t: dict(_ev(t), obs_prof_topk=5),
        lambda t, b: b._gbdt._obs._prof_topk == 5),
    # one rank: the sampler counts each due iteration as skipped (the
    # ranks' skew: tests/test_torch_parallel_obs.py)
    "obs_straggler_every": (
        lambda t: dict(_ev(t), obs_straggler_every=1),
        lambda t, b: _run_end(b)["stragglers"]["skipped_single_device"]
        == 3),
    "obs_straggler_warn_skew": (
        lambda t: dict(_ev(t), obs_straggler_every=2,
                       obs_straggler_warn_skew=0.25),
        lambda t, b: _run_end(b)["stragglers"]["warn_skew"] == 0.25),
}


def _run_end(b):
    return next(e for e in b.telemetry() if e["ev"] == "run_end")


def _end(b):
    return b.telemetry()[-1]


def _predict(b):
    X, _ = _data(400)
    b.predict(X)
    return True


def _check_live(tmp_path, addr="127.0.0.1"):
    """obs_http_port=0 (an ephemeral port, read back from the socket)
    and obs_http_addr: the live plane answers /healthz and /metrics
    while the run trains, and is gone after it."""
    from urllib.request import urlopen
    seen = []

    def scrape(env):
        url = env.model._gbdt._obs.live_url
        if not seen:
            with urlopen(url + "/healthz", timeout=10) as r:
                seen.append((url, r.status))
            with urlopen(url + "/metrics", timeout=10) as r:
                seen.append((url, r.read().decode()))
    b = _train(tmp_path, {"obs_http_port": 0, "obs_http_addr": addr},
               callbacks=[scrape])
    (url, status), (_, metrics) = seen
    assert url.startswith("http://%s:" % addr) and not url.endswith(":0")
    assert status == 200
    assert "lgbm_train_iterations_total" in metrics
    assert b._gbdt._obs.live_url == ""


SPECIAL = {"obs_roofline_peaks": lambda t: _check_roofline_peaks(t),
           "obs_http_port": lambda t: _check_live(t),
           "obs_http_addr": lambda t: _check_live(t, "localhost")}


def _check_roofline_peaks(tmp_path):
    """obs_roofline_peaks: the autotuner's probe stamps divide by the
    overridden peaks."""
    peaks = tmp_path / "peaks.json"
    peaks.write_text(json.dumps({"cpu": {"hbm_bytes_per_s": 1.0}}))
    tat.install_probe_hooks(bench=_bench)
    try:
        b = _train(tmp_path, dict(
            _ev(tmp_path), obs_roofline_peaks=str(peaks),
            tpu_histogram_mode="pallas_t", tpu_autotune="force",
            tpu_autotune_cache=str(tmp_path / "c.json")), rounds=1)
    finally:
        tat.clear_probe_hooks()
    probes = [e for e in b.telemetry() if e["ev"] == "autotune_probe"]
    assert probes and all(p["roofline"]["roof_source"] == "override"
                          and p["roofline"]["hbm_util"] == 1.0
                          for p in probes)


OBS_KEYS = sorted(k for k in Config._FIELDS if k.startswith("obs_"))


def test_the_key_tables_cover_every_obs_key():
    # every obs_* key acts (the straggler keys since the distributed
    # learners came); none is refused any more
    assert set(ACTS) | set(SPECIAL) == set(OBS_KEYS)
    assert {"obs_straggler_every", "obs_straggler_warn_skew"} <= set(ACTS)
    assert not set(ACTS) & set(SPECIAL)


@pytest.mark.parametrize("key", OBS_KEYS)
def test_every_obs_key_acts_or_raises(key, tmp_path, monkeypatch):
    if key in SPECIAL:
        SPECIAL[key](tmp_path)
        return
    params, check = ACTS[key]
    b = _train(tmp_path, params(tmp_path))
    assert check(tmp_path, b) is not False, key


def test_the_cli_writes_the_timeline_and_the_profile(tmp_path,
                                                    monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    shutil.copy(os.path.join(HERE, "data", "golden", "binary.train"),
                "binary.train")
    tcli.main(["task=train", "data=binary.train", "device_type=cpu",
               "num_trees=2", "num_leaves=3", "obs_events_path=ev.jsonl",
               "is_training_metric=true", "tpu_profile_dir=prof",
               "output_model=m.txt"])
    err = capsys.readouterr().err
    assert "Telemetry timeline -> ev.jsonl" in err
    assert "torch.profiler trace -> prof" in err
    events = _events("ev.jsonl")
    for e in events:
        validate_event(e, strict=True)
    assert events[-1]["ev"] == "run_end" and events[-1]["status"] == "ok"
    assert sum(e["ev"] == "eval" for e in events) == 2
    assert glob.glob("prof/trace.*.json")
    assert tcli.main(["obs", "summary", "ev.jsonl"]) == 0
