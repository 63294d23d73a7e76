"""The port's serving tier (lightgbm_tpu_torch/serve and obs/serve.py):
bucket programs and the async microbatch scheduler, as the JAX package's
tests/test_serve.py and tests/test_obs_serve.py hold them (the cases
that need no run observer).

The load-bearing invariant: a row scores bit-identically whatever
bucket it lands in and whoever it shares the bucket with — elementwise
Kahan lanes, no cross-row operations — so concurrent submissions through
the coalescing queue must equal solo submissions exactly, and the steady
state must build nothing.  On the CPU a bucket program runs eagerly on
its static buffers (its first use counts as a build); on the card it is
a CUDA graph (tests/test_torch_cuda.py)."""
import threading
import time
from concurrent.futures import CancelledError

import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
from lightgbm_tpu.serve import ServingPredictor as JServingPredictor

import lightgbm_tpu_torch as lgb
from lightgbm_tpu_torch.obs.metrics import REGISTRY, observe_serve_batch
from lightgbm_tpu_torch.obs.serve import SloEngine, route_kind
from lightgbm_tpu_torch.serve import (MicrobatchScheduler,
                                      PredictExecutableCache,
                                      ServeOverloadError, ServingPredictor,
                                      next_pow2)
from lightgbm_tpu_torch.serve import executable as exe_mod
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


def _data(rows=600, features=8, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(rows, features))
    w = rng.normal(size=features)
    y = (X @ w + 0.2 * rng.normal(size=rows) > 0).astype(np.float64)
    return X, y


def _params(more=None):
    return dict({"objective": "binary", "verbose": -1, "num_leaves": 15,
                 "min_data_in_leaf": 5}, **(more or {}))


def _train(params=None, rounds=12, rows=600, features=8, seed=3):
    X, y = _data(rows, features, seed)
    p = _params(params)
    return lgb.train(p, lgb.Dataset(X, label=y, params=p),
                     num_boost_round=rounds, device="cpu"), X


@pytest.fixture(scope="module")
def trained():
    return _train()


def test_next_pow2():
    assert [next_pow2(n) for n in (1, 2, 3, 4, 5, 63, 64, 65)] == \
        [1, 2, 4, 4, 8, 64, 64, 128]


# ---------------------------------------------------------------- programs
def test_executable_cache_matches_predict_and_buckets(trained):
    bst, X = trained
    cache = PredictExecutableCache(bst._gbdt, bucket_min=16, max_batch=256)
    assert cache.bucket_for(1) == 16
    assert cache.bucket_for(17) == 32
    assert cache.bucket_for(5000) == 256        # capped at max_batch
    want = bst.predict(X)
    got = cache.predict_batch(X)[:, 0]          # chunks over max_batch
    assert np.allclose(got, want, rtol=2e-6, atol=1e-7)
    raw = cache.predict_batch(X[:40], convert=False)[:, 0]
    assert np.allclose(raw, bst.predict(X[:40], raw_score=True),
                       rtol=2e-6, atol=1e-7)
    assert set(cache.last_spans) >= {"encode_s", "pad_s", "execute_s"}


def test_executable_bucket_reuse_no_steady_state_compiles(trained):
    bst, X = trained
    cache = PredictExecutableCache(bst._gbdt, bucket_min=16, max_batch=128)
    assert cache.warmup(sizes=[1, 20, 50, 128]) == [16, 32, 64, 128]
    warm = cache.compiles
    assert warm == 4
    cache.mark_warm()
    full = cache.predict_batch(X[:128])
    for n in (1, 2, 9, 16, 17, 40, 100, 128):   # all land on warm rungs
        got = cache.predict_batch(X[:n])
        # bit-identical to the full-bucket run: padding and bucket
        # choice must not leak into any row's arithmetic
        assert np.array_equal(got, full[:n]), n
    assert cache.compiles == warm
    assert cache.steady_state_compiles == 0
    cache.predict_batch(X[:5], convert=False)   # an unwarmed program
    assert cache.steady_state_compiles == 1
    st = cache.stats()
    assert st["buckets"] == [16, 32, 64, 128] and st["graphs"] == 0
    assert "static" in st["donate_effect"]


def test_executable_normalize_widths(trained):
    bst, X = trained
    cache = PredictExecutableCache(bst._gbdt, bucket_min=16)
    want = cache.predict_batch(X[:10])
    # wider input: extra columns sliced off
    wide = np.concatenate([X[:10], np.ones((10, 3))], axis=1)
    assert np.array_equal(cache.predict_batch(wide), want)
    # 1-D input promotes to one row
    one = cache.predict_batch(X[0])
    assert one.shape[0] == 1 and np.array_equal(one[0], want[0])
    # too narrow to cover the model's features: refused
    with pytest.raises(ValueError):
        cache.predict_batch(X[:4, :1])


def test_executable_cache_serves_one_device(trained):
    """One entry serves on that device; two entries (one card twice)
    split each bucket's rows and serve the one device's bits."""
    bst, X = trained
    cache = PredictExecutableCache(bst._gbdt, devices=["cpu"])
    assert cache.device.type == "cpu" and cache.stats()["devices"] == 1
    two = PredictExecutableCache(bst._gbdt, devices=["cpu", "cpu"])
    assert two.stats()["devices"] == 2
    np.testing.assert_array_equal(two.predict_batch(X[:37]),
                                  cache.predict_batch(X[:37]))


# --------------------------------------------------------------- scheduler
def test_scheduler_coalesces_and_splits():
    seen = []

    def runner(route, feats):
        seen.append(feats.shape[0])
        return feats[:, :1] * 2.0

    with MicrobatchScheduler(runner, max_batch=64,
                             max_delay_ms=40.0) as sched:
        blocks = [np.full((n, 3), float(n)) for n in (2, 3, 4)]
        futs = [sched.submit("r", b, len(b)) for b in blocks]
        outs = [f.result(timeout=10) for f in futs]
    for b, o in zip(blocks, outs):
        assert np.array_equal(o, b[:, :1] * 2.0)
    assert sum(seen) == 9 and max(seen) <= 64


def test_scheduler_deadline_flushes_lone_request():
    def runner(route, feats):
        return np.zeros((feats.shape[0], 1))

    with MicrobatchScheduler(runner, max_batch=4096,
                             max_delay_ms=5.0) as sched:
        t0 = time.perf_counter()
        sched.submit("r", np.zeros((3, 2)), 3).result(timeout=10)
        dt = time.perf_counter() - t0
    # a lone sub-bucket request must not wait for a full batch: the
    # deadline flushes it
    assert dt < 5.0
    assert sched.stats()["batches"] == 1


def test_scheduler_routes_do_not_mix():
    batches = []

    def runner(route, feats):
        batches.append((route, feats.shape[0]))
        return np.zeros((feats.shape[0], 1))

    with MicrobatchScheduler(runner, max_batch=64,
                             max_delay_ms=5.0) as sched:
        futs = [sched.submit(route, np.zeros((2, 2)), 2)
                for route in ("a", "a", "b", "a")]
        for f in futs:
            f.result(timeout=10)
    assert sum(n for _, n in batches) == 8
    assert all(route in ("a", "b") for route, _ in batches)


def test_scheduler_survives_cancelled_future():
    gate = threading.Event()

    def runner(route, feats):
        gate.wait(5)
        return feats[:, :1]

    with MicrobatchScheduler(runner, max_delay_ms=1.0) as sched:
        first = sched.submit("r", np.zeros((1, 2)), 1)
        time.sleep(0.05)                  # worker is blocked in runner
        doomed = sched.submit("r", np.zeros((2, 2)), 2)
        assert doomed.cancel()            # still queued: cancellable
        gate.set()
        first.result(timeout=10)
        with pytest.raises(CancelledError):
            doomed.result(timeout=10)
        out = sched.submit("r", np.ones((3, 2)), 3).result(timeout=10)
    assert out.shape == (3, 1)


def test_scheduler_results_are_copies_not_views():
    gate = threading.Event()
    sizes = []

    def runner(route, feats):
        gate.wait(5)
        sizes.append(feats.shape[0])
        return feats * 2.0

    with MicrobatchScheduler(runner, max_delay_ms=1.0) as sched:
        sched.submit("r", np.zeros((1, 2)), 1)
        time.sleep(0.05)                  # block worker: next two coalesce
        fa = sched.submit("r", np.ones((2, 2)), 2)
        fb = sched.submit("r", np.full((3, 2), 3.0), 3)
        gate.set()
        a, b = fa.result(timeout=10), fb.result(timeout=10)
    assert sizes[-1] == 5                 # they shared one batch
    a[:] = -1.0                           # caller scribbles on its result
    assert np.array_equal(b, np.full((3, 2), 6.0))


def test_scheduler_runner_error_propagates_and_close_rejects():
    def runner(route, feats):
        raise RuntimeError("boom")

    sched = MicrobatchScheduler(runner, max_delay_ms=1.0)
    fut = sched.submit("r", np.zeros((1, 2)), 1)
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=10)
    sched.close()
    with pytest.raises(RuntimeError, match="closed"):
        sched.submit("r", np.zeros((1, 2)), 1)


# ------------------------------------------------------- serving predictor
def test_concurrent_submissions_bit_identical_to_solo(trained):
    bst, X = trained
    blocks = ((0, 7), (50, 31), (200, 64), (300, 3))
    with ServingPredictor(bst._gbdt, max_delay_ms=5.0,
                          bucket_min=16) as sp:
        solo = [sp.predict(X[lo:lo + n]) for lo, n in blocks]
        barrier = threading.Barrier(len(blocks))
        futs = [None] * len(blocks)

        def fire(i, lo, n):
            barrier.wait()
            futs[i] = sp.submit(X[lo:lo + n])

        ts = [threading.Thread(target=fire, args=(i, lo, n))
              for i, (lo, n) in enumerate(blocks)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in ts)
        together = [f.result(timeout=30) for f in futs]
    for s, t in zip(solo, together):
        assert np.array_equal(s, t)     # bit-identical, not allclose


def test_concurrent_stress_with_a_short_switch_interval(trained):
    """More submitting threads than cores, the interpreter switching
    threads every 10 us: every response equals its solo result and the
    route counts add up (a lost update would break either)."""
    import sys
    bst, X = trained
    threads, per = 12, 6
    with ServingPredictor(bst._gbdt, max_delay_ms=2.0,
                          bucket_min=16) as sp:
        solo = {lo: sp.predict(X[lo:lo + 1 + lo % 40])
                for lo in range(0, threads * per)}
        got = {}
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            def worker(i):
                for j in range(per):
                    lo = i * per + j
                    got[lo] = sp.submit(X[lo:lo + 1 + lo % 40]).result(
                        timeout=30)
            ts = [threading.Thread(target=worker, args=(i,))
                  for i in range(threads)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in ts)
        st = sp.stats()
    assert sorted(got) == sorted(solo)
    for lo in solo:
        assert np.array_equal(got[lo], solo[lo]), lo
    assert st["routes"] == {"dev": 2 * threads * per}
    assert st["requests"] == 2 * threads * per


def test_serve_matches_booster_predict_shapes_and_values(trained):
    bst, X = trained
    with ServingPredictor(bst._gbdt, max_delay_ms=1.0) as sp:
        conv = sp.predict(X[:50])
        raw = sp.predict(X[:50], raw_score=True)
        st = sp.stats()
    assert conv.shape == (50,)                  # 1-D like Booster.predict
    assert np.allclose(conv, bst.predict(X[:50]), rtol=2e-6, atol=1e-7)
    assert np.allclose(raw, bst.predict(X[:50], raw_score=True),
                       rtol=2e-6, atol=1e-7)
    assert st["routes"] == {"dev": 2}
    assert st["executables"]["device"] == "cpu"


def test_serve_multiclass_softmax_fused():
    rng = np.random.default_rng(9)
    X = rng.normal(size=(400, 6))
    y = rng.integers(0, 3, size=400).astype(np.float64)
    p = {"objective": "multiclass", "num_class": 3, "verbose": -1,
         "num_leaves": 7, "min_data_in_leaf": 5}
    bst = lgb.train(p, lgb.Dataset(X, label=y, params=p),
                    num_boost_round=9, device="cpu")
    with ServingPredictor(bst._gbdt, max_delay_ms=1.0) as sp:
        assert exe_mod._fused_conversion(bst._gbdt.objective) == \
            ("softmax", None)
        got = sp.predict(X[:30])
        raw = sp.predict(X[:30], raw_score=True)
    want = bst.predict(X[:30])
    assert got.shape == want.shape == (30, 3)
    assert np.allclose(got, want, rtol=2e-6, atol=1e-7)
    assert np.allclose(raw, bst.predict(X[:30], raw_score=True),
                       rtol=2e-6, atol=2e-6)


def test_serve_early_stop_and_contrib_round_trip():
    bst, X = _train(rounds=30)
    with ServingPredictor(bst._gbdt, max_delay_ms=5.0) as sp:
        es = sp.predict(X[:80], pred_early_stop=True,
                        pred_early_stop_freq=2, pred_early_stop_margin=1.0)
        contrib = sp.predict(X[:80], pred_contrib=True)
        st = sp.stats()
    # both host routes are bit-equal to the Booster entry points
    want_es = bst.predict(X[:80], pred_early_stop=True,
                          pred_early_stop_freq=2,
                          pred_early_stop_margin=1.0)
    assert np.array_equal(es, want_es)
    assert not np.array_equal(es, bst.predict(X[:80]))   # it engaged
    assert np.array_equal(contrib, bst.predict(X[:80], pred_contrib=True))
    assert contrib.shape == (80, X.shape[1] + 1)
    assert st["routes"] == {"es": 1, "contrib": 1}


def test_serve_mixed_width_requests_coalesce_safely(trained):
    bst, X = trained
    wide = np.concatenate([X[:6], np.ones((6, 3))], axis=1)
    with ServingPredictor(bst._gbdt, max_delay_ms=5.0,
                          bucket_min=16) as sp:
        # same dev route, different submitted widths: submit-time
        # normalization gives them one canonical width, so sharing a
        # microbatch cannot blow up np.concatenate
        f1, f2 = sp.submit(X[:4]), sp.submit(wide)
        g1, g2 = f1.result(timeout=30), f2.result(timeout=30)
        assert np.allclose(g1, bst.predict(X[:4]), rtol=2e-6, atol=1e-7)
        assert np.allclose(g2, bst.predict(X[:6]), rtol=2e-6, atol=1e-7)
        # host routes carry the width in the route key instead: the two
        # early-stop requests never share a batch, and both succeed
        e1 = sp.submit(X[:4], pred_early_stop=True)
        e2 = sp.submit(wide, pred_early_stop=True)
        h1, h2 = e1.result(timeout=30), e2.result(timeout=30)
    assert np.array_equal(h1, bst.predict(X[:4], pred_early_stop=True))
    assert np.array_equal(h2, bst.predict(X[:6], pred_early_stop=True))


def test_serve_zero_steady_state_compiles_under_mixed_load(trained):
    bst, X = trained
    with ServingPredictor(bst._gbdt, max_delay_ms=2.0, bucket_min=16,
                          max_batch=256) as sp:
        assert sp.warmup([16, 32, 64, 128, 256]) == [16, 32, 64, 128, 256]
        futs = [sp.submit(X[lo:lo + n]) for lo, n in
                ((0, 1), (9, 30), (80, 120), (300, 256), (10, 5))]
        for f in futs:
            f.result(timeout=30)
        assert sp.cache.steady_state_compiles == 0
        assert sp.stats()["batches"] >= 1


def test_booster_serve_reads_config_params():
    bst, X = _train(params={"serve_max_batch": 128,
                            "serve_max_delay_ms": 4.5,
                            "serve_bucket_min": 32})
    with bst.serve() as sp:
        assert sp.scheduler.max_batch == 128
        assert sp.scheduler.max_delay_s == pytest.approx(0.0045)
        assert sp.cache.bucket_min == 32
        assert np.allclose(sp.predict(X[:20]), bst.predict(X[:20]),
                           rtol=2e-6, atol=1e-7)
    with bst.serve(max_batch=64) as sp:      # kwargs override config
        assert sp.scheduler.max_batch == 64


@pytest.mark.parametrize("params", [
    {"obs_drift_every": 100}, {"obs_http_port": 0}, {"obs_compile": True}])
def test_booster_serve_takes_drift_the_live_plane_and_an_observer(
        trained, params):
    """A model serves with the run observer that obs_* params build:
    drift monitoring from its training data's fingerprint, the live
    plane on an ephemeral port (read back, not assumed), and the serving
    summary on the timeline."""
    from lightgbm_tpu_torch.obs import observer_from_config
    from lightgbm_tpu_torch.utils.config import Config
    bst, X = trained
    assert bst._gbdt.drift_fingerprint() is not None
    obs = observer_from_config(Config(params))
    assert obs.enabled
    over = {"drift_every": params.get("obs_drift_every", 0)}
    if "obs_http_port" in params:
        obs.ensure_live_server(0)
    with bst.serve(observer=obs, **over) as sp:
        got = sp.predict(X[:300])
        if "obs_drift_every" in params:
            assert sp.drift is not None and sp.drift.enabled
        if "obs_http_port" in params:
            url = obs.live_url
            assert url.startswith("http://127.0.0.1:")
            assert not url.endswith(":0")
    np.testing.assert_allclose(got, bst.predict(X[:300]), rtol=2e-6,
                               atol=1e-7)
    names = [e["ev"] for e in obs.timeline]
    assert "serve_summary" in names
    if "obs_drift_every" in params:
        assert "drift" in names
    obs.close()


def test_serve_host_fallback_on_unencodable_model(trained, monkeypatch,
                                                  capsys):
    bst, X = trained

    def boom(*a, **k):
        raise ValueError("mixed categorical/numerical use (test)")

    monkeypatch.setattr(exe_mod.dev_predict, "build_ranked_predictor",
                        boom)
    with ServingPredictor(bst._gbdt, max_delay_ms=1.0) as sp:
        assert sp.cache is None
        got = sp.predict(X[:25])            # host route, still serves
        assert sp.stats()["routes"] == {"host": 1}
    assert "serving from the host predictor" in capsys.readouterr().err
    assert np.array_equal(got, bst.predict(X[:25]))


def test_port_and_jax_package_serve_the_same_scores(trained):
    """The same model text served through the JAX package's
    ServingPredictor and the port's, raw and converted, within 2e-6."""
    bst, X = trained
    text = bst.model_to_string()
    bj = lgbj.Booster(model_str=text)
    with ServingPredictor(bst._gbdt, max_delay_ms=1.0) as sp, \
            JServingPredictor(bj._gbdt, max_delay_ms=1.0) as jp:
        for raw in (False, True):
            got = sp.predict(X[:100], raw_score=raw)
            want = jp.predict(X[:100], raw_score=raw)
            assert got.shape == want.shape == (100,)
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=2e-6)


# ------------------------------------------------------------ observability
def test_observe_predict_counts_input_rows(trained):
    from lightgbm_tpu_torch.predictor import Predictor
    bst, X = trained

    def rows_total():
        snap = REGISTRY.snapshot().get("lgbm_predict_rows_total")
        return snap["value"] if snap else 0

    base = rows_total()
    bst.predict(X[:17])                     # converted output is 1-D
    assert rows_total() == base + 17
    bst.predict(X[0])                       # one 1-D request = one row
    assert rows_total() == base + 18
    Predictor(bst._gbdt).predict(X[:5])
    assert rows_total() == base + 23


def test_serve_batch_counter_labels_route_kind_only():
    for margin in (12.5, 99.0):           # client-supplied, unbounded
        observe_serve_batch(("es", False, 10, margin, 8), 4, 0, 4,
                            0.0, 0.0)
    series = [k for k in REGISTRY.snapshot()
              if k.startswith("lgbm_serve_batches_total")]
    assert 'lgbm_serve_batches_total{route="es"}' in series
    assert all("(" not in s for s in series)


def test_route_kind_collapses_tuples():
    assert route_kind(("dev", True)) == "dev"
    assert route_kind(("contrib", 28)) == "contrib"
    assert route_kind("host") == "host"


class _Capture:
    """Observer stub for SloEngine: records event() calls."""
    enabled = True

    def __init__(self):
        self.events = []

    def event(self, ev, **kw):
        self.events.append(dict(kw, ev=ev))

    def flush(self):
        pass


def test_burn_rate_alert_fires_and_clears():
    obs = _Capture()
    t = [0.0]
    eng = SloEngine(observer=obs, mode="warn", p99_ms=10.0,
                    window_s=6.0, every_s=1.0, clock=lambda: t[0])
    for sec in range(3):
        t[0] = float(sec)
        for _ in range(20):
            eng.record(("dev", True), 0.5)
    t[0] = 3.0
    eng.evaluate(t[0])
    assert eng.alerting and eng.alerts_fired == 1
    fired = [e for e in obs.events if e["ev"] == "health"]
    assert fired and fired[0]["check"] == "slo_burn_rate"
    assert fired[0]["status"] == "warn"        # warn-only, never fatal
    assert fired[0]["detail"]["burn_long"] >= 2.0
    for sec in range(4, 12):
        t[0] = float(sec)
        for _ in range(20):
            eng.record(("dev", True), 0.001)
    t[0] = 12.0
    eng.evaluate(t[0])
    assert not eng.alerting and eng.alerts_cleared == 1
    cleared = [e for e in obs.events if e["ev"] == "health"][-1]
    assert cleared["status"] == "ok" and cleared["detail"]["cleared"]
    assert eng.alerts_fired == 1
    snaps = [e for e in obs.events if e["ev"] == "serve_slo"]
    assert snaps and snaps[-1]["alert"] == "clear"


def test_slo_engine_verdicts_without_an_observer():
    t = [0.0]
    eng = SloEngine(p99_ms=100.0, qps=1.0, window_s=12.0, every_s=1.0,
                    clock=lambda: t[0])
    for sec in range(3):
        t[0] = float(sec)
        for _ in range(20):
            eng.record(("dev", True), 0.002)
    overall = eng.evaluate()
    assert overall["n"] == 60 and overall["p99_s"] <= 0.1
    assert eng.headline()["verdicts"] == {"p99": "ok", "qps": "ok"}
    eng.close()


def test_queue_limit_sheds_with_overload_error():
    gate = threading.Event()

    def runner(route, feats):
        gate.wait(5.0)
        return feats[:, :1]

    sched = MicrobatchScheduler(runner, max_batch=8, max_delay_ms=1.0,
                                queue_limit=2)
    try:
        first = sched.submit("r", np.zeros((1, 2)), 1)
        time.sleep(0.1)
        ok = [sched.submit("r", np.zeros((1, 2)), 1) for _ in range(2)]
        shed = sched.submit("r", np.zeros((1, 2)), 1)
        with pytest.raises(ServeOverloadError) as ei:
            shed.result(timeout=1)
        assert ei.value.reason == "queue_full"
        gate.set()
        first.result(timeout=5)
        for f in ok:
            f.result(timeout=5)
    finally:
        gate.set()
        sched.close()
    st = sched.stats()
    assert st["shed"] == {"queue_full": 1} and st["shed_total"] == 1


def test_deadline_shed_on_projected_wait():
    def runner(route, feats):
        return feats[:, :1] * 2.0

    with MicrobatchScheduler(runner, max_batch=4,
                             max_delay_ms=1.0) as sched:
        # a cold scheduler (no completed batch, EWMA unknown) never
        # deadline-sheds on a guess, however tight the budget
        sched.submit("r", np.zeros((1, 2)), 1,
                     deadline_s=1e-6).result(timeout=5)
        sched._ewma_exec_s = 1.0
        doomed = sched.submit("r", np.zeros((1, 2)), 1, deadline_s=0.5)
        with pytest.raises(ServeOverloadError) as ei:
            doomed.result(timeout=1)
        assert ei.value.reason == "deadline"
        sched.submit("r", np.zeros((1, 2)), 1,
                     deadline_s=30.0).result(timeout=5)
    st = sched.stats()
    assert st["shed"] == {"deadline": 1}
    assert st["requests"] == 2


def test_shed_feeds_slo_engine():
    eng = SloEngine(p99_ms=50.0, window_s=6.0, every_s=0.0)
    gate = threading.Event()

    def runner(route, feats):
        gate.wait(5.0)
        return feats[:, :1]

    sched = MicrobatchScheduler(runner, max_batch=8, max_delay_ms=1.0,
                                queue_limit=1, slo=eng)
    try:
        sched.submit("r", np.zeros((1, 2)), 1)
        time.sleep(0.1)
        sched.submit("r", np.zeros((1, 2)), 1)
        with pytest.raises(ServeOverloadError):
            sched.submit("r", np.zeros((1, 2)), 1).result(timeout=1)
    finally:
        gate.set()
        sched.close()
    assert eng.evaluate()["shed"] == 1


def test_serving_predictor_sheds_at_its_queue_limit(trained):
    """serve_queue_limit through ServingPredictor: with the worker held
    in a fault hook, the request past the limit fails fast."""
    bst, X = trained
    gate = threading.Event()
    sp = ServingPredictor(bst._gbdt, max_delay_ms=1.0, queue_limit=1,
                          fault_hook=lambda route, batch: gate.wait(5.0),
                          slo_p99_ms=1000.0)
    try:
        first = sp.submit(X[:2])
        time.sleep(0.1)
        queued = sp.submit(X[2:4])
        with pytest.raises(ServeOverloadError):
            sp.submit(X[4:6]).result(timeout=1)
        gate.set()
        assert first.result(timeout=10).shape == (2,)
        assert queued.result(timeout=10).shape == (2,)
    finally:
        gate.set()
        sp.close()
    st = sp.stats()
    assert st["shed_total"] == 1 and st["slo"]["alerts_fired"] == 0
    assert st["routes"] == {"dev": 2}         # the shed one was not admitted
