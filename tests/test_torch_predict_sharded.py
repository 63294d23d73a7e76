"""Row-sharded bulk prediction and serving over several devices, against
one device and the JAX package.

* ``ranked_predict_sharded`` over three entries (one CPU three times) on
  a row count that needs padding is the one-device ``ranked_predict`` to
  the bit, and holds to the JAX package's ``ranked_predict_sharded`` on
  the 8-device CPU mesh within the single-device tests' rtol/atol 2e-6.
* ``Booster.set_predict_devices`` routes device bulk prediction through
  it: the same bits.
* A ``PredictExecutableCache`` over two entries serves the one-device
  bits, rounds its buckets as the JAX package's does for as many
  devices, and counts a build on every device.
"""
import numpy as np
import pytest
import torch

import jax

import lightgbm_tpu as lgbj
from lightgbm_tpu.ops import predict as jpredict
from lightgbm_tpu.serve.executable import (
    PredictExecutableCache as JCache)
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.ops import predict as tpredict
from lightgbm_tpu_torch.serve.executable import PredictExecutableCache
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

CPU3 = ["cpu", "cpu", "cpu"]


def _model(objective, num_class=1):
    rng = np.random.default_rng(11)
    X = rng.normal(size=(1500, 6))
    X[rng.random(X.shape) < 0.2] = 0.0
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    if num_class > 1:
        y = (np.digitize(X[:, 0] + X[:, 2], [-0.5, 0.5])).astype(float)
    p = {"objective": objective, "verbose": -1, "num_leaves": 15,
         "min_data_in_leaf": 5}
    if num_class > 1:
        p["num_class"] = num_class
    bj = lgbj.train(p, lgbj.Dataset(X, label=y, params=p),
                    num_boost_round=6)
    bt = lgbt.Booster(model_str=bj.model_to_string(), device="cpu")
    Xq = rng.normal(size=(1001, 6))             # 1001 = 3 * 333 + 2
    Xq[rng.random(Xq.shape) < 0.05] = np.nan
    return bj, bt, Xq


@pytest.fixture(scope="module", params=[("binary", 1),
                                        ("multiclass", 3)])
def model(request):
    return _model(*request.param)


def test_sharded_is_one_device_to_the_bit(model):
    _, bt, Xq = model
    g = bt._gbdt
    k = g.num_tree_per_iteration
    rp = tpredict.build_ranked_predictor(g.models, k, Xq.shape[1], "cpu")
    V, D = tpredict.rank_encode(rp, Xq)
    one = tpredict.ranked_predict(rp.dev, torch.as_tensor(V),
                                  torch.as_tensor(D))
    got, n = tpredict.ranked_predict_sharded(rp, V, D, k, devices=CPU3)
    assert n == len(Xq) and got.shape == (1002, k)
    assert torch.equal(got[:n], one)
    # one device, or none, is ranked_predict
    for devs in (None, ["cpu"]):
        s, n1 = tpredict.ranked_predict_sharded(rp, V, D, k, devices=devs)
        assert n1 == n and torch.equal(s, one)
    # each entry holds its own copy of the trees
    reps = rp.replicas(CPU3)
    assert len(reps) == 3 and reps[0].nodes is not reps[1].nodes
    assert rp.replicas(CPU3) is reps


def test_sharded_matches_the_jax_sharded_traversal(model):
    bj, bt, Xq = model
    g = bt._gbdt
    k = g.num_tree_per_iteration
    rp = tpredict.build_ranked_predictor(g.models, k, Xq.shape[1], "cpu")
    V, D = tpredict.rank_encode(rp, Xq)
    got, n = tpredict.ranked_predict_sharded(rp, V, D, k, devices=CPU3)
    jg = bj._gbdt
    jg._materialize()
    jrp = jpredict.build_ranked_predictor(jg.models, k, Xq.shape[1])
    jV, jD = jpredict.rank_encode(jrp, Xq)
    np.testing.assert_array_equal(V, np.asarray(jV))
    want, jn = jpredict.ranked_predict_sharded(jrp, jV, jD, k,
                                               devices=jax.devices())
    assert jn == n
    np.testing.assert_allclose(got[:n].numpy(), np.asarray(want)[:n],
                               rtol=2e-6, atol=2e-6)


def test_booster_predict_shards_over_its_devices(model):
    _, bt, Xq = model
    bt._gbdt.config.tpu_predict = "true"
    try:
        one = bt.predict(Xq, raw_score=True)
        bt.set_predict_devices(["cpu", "cpu"])
        two = bt.predict(Xq, raw_score=True)
    finally:
        bt.set_predict_devices(None)
        bt._gbdt.config.tpu_predict = "auto"
    np.testing.assert_array_equal(two, one)


def test_booster_chunks_hold_one_budget_a_distinct_device(model,
                                                        monkeypatch):
    """Entries that repeat one device share that device's chunk budget:
    a CPU booster with tpu_predict=true over three CPU entries predicts
    in one device's chunks, with the one-device bits."""
    from lightgbm_tpu_torch.models import gbdt as gbdt_mod
    _, bt, Xq = model
    monkeypatch.setattr(gbdt_mod.GBDT, "_predict_chunk_rows",
                        staticmethod(lambda nf, tb: 300))
    real, rows = tpredict.ranked_predict_sharded, []

    def spy(rp, V, D, k, devices=None, tree_block=None):
        rows.append(len(V))
        return real(rp, V, D, k, devices=devices, tree_block=tree_block)
    monkeypatch.setattr(tpredict, "ranked_predict_sharded", spy)
    bt._gbdt.config.tpu_predict = "true"
    try:
        one = bt.predict(Xq, raw_score=True)
        bt.set_predict_devices(CPU3)
        three = bt.predict(Xq, raw_score=True)
    finally:
        bt.set_predict_devices(None)
        bt._gbdt.config.tpu_predict = "auto"
    assert rows == [300, 300, 300, 101] * 2
    np.testing.assert_array_equal(three, one)


def test_multi_device_serving_is_one_device_to_the_bit(model):
    _, bt, Xq = model
    one = PredictExecutableCache(bt._gbdt, max_batch=256)
    two = PredictExecutableCache(bt._gbdt, devices=["cpu", "cpu"],
                                 max_batch=256)
    for n in (1, 5, 64, 100, 300):
        for convert in (True, False):
            np.testing.assert_array_equal(
                two.predict_batch(Xq[:n], convert=convert),
                one.predict_batch(Xq[:n], convert=convert))
    desc = two.describe()
    assert desc["devices"] == 2 and desc["device_list"] == ["cpu", "cpu"]


def test_buckets_round_as_the_jax_cache_and_builds_count_per_device():
    bj, bt, Xq = _model("binary")
    jdevs = jax.devices()[:3]
    jc = JCache(bj._gbdt, devices=jdevs, bucket_min=16, max_batch=256)
    tc = PredictExecutableCache(bt._gbdt, devices=CPU3, bucket_min=16,
                                max_batch=256)
    for n in (1, 15, 16, 17, 100, 256, 300):
        assert tc.bucket_for(n) == jc.bucket_for(n)
    buckets = tc.warmup([1, 100])
    assert buckets == [18, 129]
    assert tc.compiles == 2 * 3
    tc.mark_warm()
    tc.predict_batch(Xq[:50])
    assert tc.steady_state_compiles == 3       # a new bucket, 3 devices
    assert tc.stats()["graphs"] == 0           # eager on the CPU
