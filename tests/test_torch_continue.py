"""Continued training and checkpoint resume against the JAX package.

* init scores: ``train(init_model=)`` with a model file written by the
  JAX package, or with a Booster, seeds the scores with the model's raw
  scores on the f64 host trees; they equal the JAX package's
  ``_InnerPredictor.predict_raw_for_init`` to 1e-12;
* the continued trees are the JAX package's: structure exactly against
  its oracle run (``tpu_histogram_mode=pallas_ct``, interpret mode),
  leaf values to rtol 1e-5 against its f32 ``onehot`` run (atol 1e-5 x
  the largest leaf, ROADMAP's standing notes);
* checkpoints: the JAX package's file format and fingerprint guard, and
  a resumed run trains only the rounds left.
"""
import os

import numpy as np
import pytest

import jax

import lightgbm_tpu as lgbj
import lightgbm_tpu.cli as jcli
import lightgbm_tpu_torch as lgbt
import lightgbm_tpu_torch.cli as tcli
from lightgbm_tpu.basic import _InnerPredictor as JInnerPredictor
from lightgbm_tpu.models import checkpoint as jck
from lightgbm_tpu_torch.models import checkpoint as ck
from lightgbm_tpu_torch.models.gbdt import GBDT
from lightgbm_tpu_torch.utils.log import LightGBMError
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")

BASE = {"objective": "binary", "num_leaves": 7, "min_data_in_leaf": 20,
        "max_bin": 63, "verbose": -1, "tpu_growth": "wave",
        "tpu_wave_width": 8}
ORACLE = {"tpu_histogram_mode": "pallas_ct", "tpu_pallas_interpret": True,
          "tpu_hist_precision": "hilo"}
STRUCTURE = ("split_feature", "left_child", "right_child", "leaf_count",
             "decision_type")


def _data(seed=7, n=1500):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[::13, 3] = 0.0
    s = X[:, 0] + 0.7 * X[:, 1] * X[:, 2] + 0.3 * rng.normal(size=n)
    return X, (s > 0).astype(float)


def _trees(text):
    """Each tree's block of a model text."""
    body = text.split("\nfeature importances")[0]
    return ["Tree=" + part.strip() for part in body.split("Tree=")[1:]]


def _structure(text):
    return [ln for ln in text.splitlines() if ln.startswith(STRUCTURE)]


def _leaf_values(text):
    return np.concatenate([np.array(ln.split("=")[1].split(), float)
                           for ln in text.splitlines()
                           if ln.startswith("leaf_value")])


def _logloss(p, y):
    p = np.clip(p, 1e-12, 1 - 1e-12)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


@pytest.fixture(scope="module")
def jax_model(tmp_path_factory):
    """A 3-round model written by the JAX package, and its data."""
    X, y = _data()
    path = str(tmp_path_factory.mktemp("base") / "base.txt")
    lgbj.train(dict(BASE, **ORACLE), lgbj.Dataset(X, label=y), 3,
               verbose_eval=False).save_model(path)
    return path, X, y


@pytest.mark.parametrize("as_booster", [False, True])
def test_init_scores_equal_jax_predict_raw_for_init(jax_model, as_booster):
    path, X, y = jax_model
    init = (lgbt.Booster(model_file=path, device="cpu") if as_booster
            else path)
    ds = lgbt.Dataset(X, label=y)
    bst = lgbt.train(BASE, ds, 1, init_model=init, device="cpu")
    want = JInnerPredictor(model_file=path).predict_raw_for_init(X)
    got = ds._handle.metadata.init_score
    np.testing.assert_allclose(got, want.T.reshape(-1), rtol=0, atol=1e-12)
    assert bst.num_trees() == 4


def test_continued_trees_match_jax(jax_model):
    path, X, y = jax_model
    Xv, yv = _data(8, 500)
    got = lgbt.train(dict(BASE, **ORACLE), lgbt.Dataset(X, label=y), 3,
                     valid_sets=[lgbt.Dataset(Xv, label=yv)],
                     init_model=path, device="cpu").model_to_string()
    oracle = lgbj.train(dict(BASE, **ORACLE), lgbj.Dataset(X, label=y), 3,
                        init_model=path, verbose_eval=False).model_to_string()
    f32 = lgbj.train(dict(BASE, tpu_histogram_mode="onehot"),
                     lgbj.Dataset(X, label=y), 3, init_model=path,
                     verbose_eval=False).model_to_string()
    assert got.count("Tree=") == oracle.count("Tree=") == 6
    # the loaded trees first, unchanged
    assert _trees(got)[:3] == _trees(open(path).read())
    assert _structure(got) == _structure(oracle) == _structure(f32)
    want = _leaf_values(f32)
    np.testing.assert_allclose(_leaf_values(got), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_continued_training_does_not_raise_the_loss():
    """JAX tests/test_engine.py:94-110 on the port."""
    X, y = _data(9)
    p = {"objective": "binary", "verbose": -1, "num_leaves": 15}
    bst1 = lgbt.train(p, lgbt.Dataset(X, label=y), 5, device="cpu")
    bst2 = lgbt.train(p, lgbt.Dataset(X, label=y), 5, init_model=bst1,
                      device="cpu")
    assert bst2.num_trees() == bst1.num_trees() + 5
    assert bst2.current_iteration() == 10
    assert _logloss(bst2.predict(X), y) <= _logloss(bst1.predict(X), y) + 1e-9
    # the first booster keeps its trees (the new one holds copies)
    assert bst1.num_trees() == 5


def test_continue_from_the_reference_model():
    """init_model continuation from the reference-written golden model."""
    data = np.loadtxt(os.path.join(GOLDEN, "binary.train"), delimiter="\t")
    X, y = data[:, 1:], data[:, 0]
    model_file = os.path.join(GOLDEN, "binary.model")
    base = lgbt.Booster(model_file=model_file, device="cpu")
    bst = lgbt.train({"objective": "binary", "verbose": -1,
                      "num_leaves": 15}, lgbt.Dataset(X, label=y), 5,
                     init_model=model_file, device="cpu")
    assert bst.num_trees() == base.num_trees() + 5
    pred = bst.predict(X)
    assert np.isfinite(pred).all()
    assert _logloss(pred, y) <= _logloss(base.predict(X), y) + 1e-9


def test_checkpoint_roundtrip_and_fingerprint_guard(tmp_path):
    X, y = _data()
    params = dict(BASE, bagging_seed=3)
    bst = lgbt.train(params, lgbt.Dataset(X, label=y), 3, device="cpu")
    d = str(tmp_path / "ck")
    path = ck.save_checkpoint(d, bst._gbdt, 3, params)
    assert os.path.basename(path) == "checkpoint.json"
    loaded = ck.load_checkpoint(d)
    assert loaded["iteration"] == 3 and loaded["world_size"] == 1
    assert loaded["seeds"]["bagging_seed"] == 3
    rt = lgbt.Booster(model_str=loaded["model"], device="cpu")
    assert rt.model_to_string() == bst.model_to_string()
    # operational keys may change; training keys refuse
    ck.check_resumable(loaded, dict(params, obs_events_path="/tmp/x",
                                    checkpoint_every=7, verbose=2,
                                    num_iterations=50))
    with pytest.raises(LightGBMError):
        ck.check_resumable(loaded, dict(params, learning_rate=0.5))
    assert ck.load_checkpoint(str(tmp_path / "missing")) is None
    # the JAX package's file format and fingerprint
    assert ck.config_fingerprint(params) == jck.config_fingerprint(params)
    jd = str(tmp_path / "jck")
    jbst = lgbj.train(dict(params, **ORACLE), lgbj.Dataset(X, label=y), 2,
                      verbose_eval=False)
    jck.save_checkpoint(jd, jbst._gbdt, 2, params)
    ck.check_resumable(ck.load_checkpoint(jd), params)


class _Count:
    """A train() callback counting the rounds that ran."""

    def __init__(self):
        self.n = 0

    def __call__(self, env):
        self.n += 1


@pytest.mark.parametrize("first,every,second", [(4, 2, 6), (3, 2, 5)])
def test_resume_trains_only_the_remaining_rounds(tmp_path, first, every,
                                                 second):
    """JAX tests/test_multihost.py:66-110 on the port; a run also writes
    its last round's checkpoint, so 3 rounds then 5 trains 2 more."""
    X, y = _data()
    d = str(tmp_path / "ck")
    params = dict(BASE, checkpoint_dir=d, checkpoint_every=every)
    c1 = _Count()
    b1 = lgbt.train(params, lgbt.Dataset(X, label=y), first,
                    callbacks=[c1], device="cpu")
    assert c1.n == first and b1.num_trees() == first
    assert ck.load_checkpoint(d)["iteration"] == first
    c2 = _Count()
    b2 = lgbt.train(params, lgbt.Dataset(X, label=y), second,
                    callbacks=[c2], device="cpu")
    assert c2.n == second - first
    assert b2.num_trees() == second
    assert _trees(b2.model_to_string())[:first] == \
        _trees(b1.model_to_string())
    if first % every == 0:
        # where the JAX package also checkpoints the first run's end, it
        # resumes to the same tree count
        jd = str(tmp_path / "jck")
        jp = dict(BASE, **ORACLE, checkpoint_dir=jd, checkpoint_every=every)
        lgbj.train(jp, lgbj.Dataset(X, label=y), first, verbose_eval=False)
        j2 = lgbj.train(jp, lgbj.Dataset(X, label=y), second,
                        verbose_eval=False)
        assert j2.num_trees() == b2.num_trees()


def _write_tsv(path, X, y):
    with open(path, "w") as f:
        for yy, row in zip(y, X):
            f.write("\t".join("%.17g" % v for v in (yy, *row)) + "\n")


def test_cli_continued_training_starts_from_f64_scores(tmp_path, monkeypatch):
    """input_model= plus more rounds through the CLI: the loaded trees
    first, the scores starting from the f32 rounding of their f64 host
    sums (predict_raw(allow_device=False)), the valid scores too; the
    trees are the JAX CLI's."""
    monkeypatch.chdir(tmp_path)
    X, y = _data()
    Xv, yv = _data(8, 500)
    _write_tsv("t.tsv", X, y)
    _write_tsv("v.tsv", Xv, yv)
    args = ["task=train", "data=t.tsv", "device_type=cpu", "verbose=-1",
            "objective=binary", "num_leaves=7", "max_bin=63",
            "tpu_growth=wave", "tpu_wave_width=8",
            "tpu_histogram_mode=pallas_ct", "tpu_pallas_interpret=true"]
    tcli.main(args + ["num_iterations=3", "output_model=base.txt"])
    seen = {}
    real = GBDT.reset_training_data

    def spy(self, *a, **k):
        real(self, *a, **k)
        if self.models:
            seen["train"] = self.train_score.copy()

    monkeypatch.setattr(GBDT, "reset_training_data", spy)
    real_valid = GBDT.add_valid_dataset

    def spy_valid(self, *a, **k):
        real_valid(self, *a, **k)
        seen["valid"] = self.valid_score_host(0).copy()

    monkeypatch.setattr(GBDT, "add_valid_dataset", spy_valid)
    tcli.main(args + ["num_iterations=2", "input_model=base.txt",
                      "valid_data=v.tsv", "output_model=more.txt"])
    base = lgbt.Booster(model_file="base.txt", device="cpu")._gbdt
    for key, rows in (("train", X), ("valid", Xv)):
        want = base.predict_raw(rows, allow_device=False).T
        np.testing.assert_array_equal(seen[key],
                                      want.astype(np.float32))
    more = open("more.txt").read()
    assert more.count("Tree=") == 5
    assert _structure("".join(_trees(more)[:3])) == _structure(
        open("base.txt").read())
    jcli.main(args + ["num_iterations=2", "input_model=base.txt",
                      "output_model=jmore.txt"])
    jmore = open("jmore.txt").read()
    assert _structure(more) == _structure(jmore)
    np.testing.assert_allclose(_leaf_values(more), _leaf_values(jmore),
                               rtol=0, atol=1e-3 * np.abs(
                                   _leaf_values(jmore)).max())


def test_cli_checkpoint_resume(tmp_path, monkeypatch):
    """checkpoint_dir and checkpoint_every through the CLI: 3 rounds
    writing checkpoints every 2 (and at the end), then 5: the second run
    trains 2 rounds, ends with 5 trees, its first 3 the first run's."""
    monkeypatch.chdir(tmp_path)
    X, y = _data()
    _write_tsv("t.tsv", X, y)
    args = ["task=train", "data=t.tsv", "device_type=cpu", "verbose=-1",
            "objective=binary", "num_leaves=7", "checkpoint_dir=ck",
            "checkpoint_every=2"]
    tcli.main(args + ["num_iterations=3", "output_model=a.txt"])
    assert ck.load_checkpoint("ck")["iteration"] == 3
    calls = []
    real = GBDT.train_one_iter

    def count(self, *a, **k):
        calls.append(1)
        return real(self, *a, **k)

    monkeypatch.setattr(GBDT, "train_one_iter", count)
    tcli.main(args + ["num_iterations=5", "output_model=b.txt"])
    assert len(calls) == 2
    a, b = open("a.txt").read(), open("b.txt").read()
    assert b.count("Tree=") == 5
    assert _trees(b)[:3] == _trees(a)
    assert ck.load_checkpoint("ck")["iteration"] == 5
    # a training parameter changed: the resume refuses
    with pytest.raises(LightGBMError, match="fingerprint"):
        tcli.main(args + ["num_iterations=6", "num_leaves=9",
                          "output_model=c.txt"])
