"""The port's measured autotuner (lightgbm_tpu_torch/ops/autotune.py)
against the JAX package's (lightgbm_tpu/ops/autotune.py), on the CPU.

* ``enumerate_cells`` gives the JAX package's cells over a grid of
  buckets, priors and pins where the JAX package's VMEM gate does not
  bind; where it binds (a 968-column, 256-bin block at W = 64) the port
  keeps the wide cell the TPU could not compile (its kernels tile any
  block into shared memory);
* ``decide`` under the same ``install_probe_hooks(bench=..., timer=...)``
  gives the same winner, margin, overhead, decision fields and cache
  file in both packages (the roofline stamps differ by design: each
  package counts its own kernels' work);
* each package reads the other's cache file; a stale rev is dropped
  whole, and a corrupt file is an empty cache;
* ``measure`` on the CPU without hooks is the prior, with no probes;
* a small ``train`` under ``measure`` with a bench hook takes the winning
  cell, its model text equals a run with that cell pinned, and the JAX
  package picks the same cell for the same data;
* with probing forced on the CPU, every candidate is built and run for
  real (the staged chain and the fused schedule), each run waits once
  through obs/timers.fence, and no launch counter moves.
"""
import json

import numpy as np
import pytest

import jax

from lightgbm_tpu.ops import autotune as jat
from lightgbm_tpu.utils.config import Config as JConfig
import lightgbm_tpu as lgbj
import lightgbm_tpu_torch as lgbt
from lightgbm_tpu_torch.obs import roofline
from lightgbm_tpu_torch.obs import timers
from lightgbm_tpu_torch.ops import autotune as tat
from lightgbm_tpu_torch.ops import fused_iter, learner as tlearner
from lightgbm_tpu_torch.utils.config import Config as TConfig
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _clean_hooks():
    for mod in (jat, tat):
        mod.clear_probe_hooks()
    yield
    for mod in (jat, tat):
        mod.clear_probe_hooks()


def _cfgs(**kw):
    kw.setdefault("verbose", -1)
    return JConfig(dict(kw)), TConfig(dict(kw))


def _bench(cell, bucket):
    """A deterministic synthetic cost: wider is faster, bf16 beats hilo,
    ct pays a tax, compaction a small win, fused a smaller one."""
    s = 1.0 / max(1, cell.wave_width)
    if cell.hist_hilo:
        s += 0.1
    if cell.hist_mode == "pallas_ct":
        s += 0.5
    if cell.compact:
        s -= 0.01
    if cell.fused:
        s -= 0.005
    return s


# ------------------------------------------------------------ enumeration
# accumulator blocks under the JAX package's VMEM gate at every width up
# to 64 (ncols * bin_pad * 3 * 64 * 4 bytes <= 64 MB)
BUCKETS = [(28, 64, 255, 1 << 21), (8, 64, 15, 2048), (136, 256, 255, 1 << 20),
           (40, 64, 31, 4096), (300, 256, 63, 1 << 16)]
PRIORS = [("pallas_ct", 32, True, False, False),
          ("pallas_t", 8, True, False, False),
          ("pallas_t", 1, False, True, True),
          ("pallas_ct", 64, True, False, False),
          ("onehot", 1, True, False, False)]
PINS = [(), ("kernel",), ("width", "precision"), ("compact", "fused"),
        ("kernel", "width", "precision", "compact", "fused")]


@pytest.mark.parametrize("bucket", BUCKETS, ids=lambda b: "c%d_b%d" % b[:2])
@pytest.mark.parametrize("prior", PRIORS, ids=lambda p: "%s_W%d" % p[:2])
def test_enumerate_cells_matches_jax(bucket, prior):
    for pinned in PINS:
        for ct_allowed in (True, False):
            pins = {k: True for k in pinned}
            got = tat.enumerate_cells(tat.Cell(*prior),
                                      tat.ShapeBucket(*bucket),
                                      tat.Pins(**pins), ct_allowed)
            want = jat.enumerate_cells(jat.Cell(*prior),
                                       jat.ShapeBucket(*bucket),
                                       jat.Pins(**pins), ct_allowed)
            assert [c.as_dict() for c in got] == \
                [c.as_dict() for c in want], (pinned, ct_allowed)


def test_enumerate_cells_where_the_vmem_gate_binds():
    """Bosch's width at 256 padded bins: the JAX package keeps only the
    prior (exempt) and the cells whose accumulator block fits its 64 MB
    VMEM gate (W = 16; W = 32 is 95 MB, W = 64 190 MB); the port's
    kernels tile the block, so it keeps every neighbour up to
    MAX_CELLS, and the JAX package's cells are exactly the port's that
    fit the gate."""
    bucket = (968, 256, 255, 1 << 20)
    prior = ("pallas_t", 32, True, False, False)
    got = [c.as_dict() for c in tat.enumerate_cells(
        tat.Cell(*prior), tat.ShapeBucket(*bucket), tat.Pins())]
    want = [c.as_dict() for c in jat.enumerate_cells(
        jat.Cell(*prior), jat.ShapeBucket(*bucket), jat.Pins())]

    def fits(c):
        return c == got[0] or jat.hist_block_bytes(
            968, 256, c["wave_width"]) <= jat.WAVE_VMEM_GATE
    assert len(got) == tat.MAX_CELLS and len(want) == 2
    assert want == [c for c in got if fits(c)]
    assert dict(got[0], wave_width=64) in got


def test_resolvers_move_to_autotune_and_the_learner_reexports_them():
    assert tlearner.resolve_wave_width is tat.resolve_wave_width
    assert tlearner.resolve_wave_order is tat.resolve_wave_order
    assert tat.CACHE_SCHEMA_REV == jat.CACHE_SCHEMA_REV
    assert tat.CT_PROMOTION_BOUND == jat.CT_PROMOTION_BOUND
    assert tat.MAX_CELLS == jat.MAX_CELLS
    for n in (1, 2, 3, 1000, 2 ** 21, 2 ** 21 + 1):
        assert tat.row_bucket(n) == jat.row_bucket(n)
    for leaves in (7, 31, 63, 255):
        for params in ({}, {"tpu_wave_width": 5},
                       {"objective": "lambdarank"},
                       {"boosting": "goss", "tpu_wave_order": "batched"}):
            jc, tc = _cfgs(num_leaves=leaves, **params)
            order = tat.resolve_wave_order(tc)
            assert order == jat.resolve_wave_order(jc)
            assert (tat.resolve_wave_width(tc, leaves, order)
                    == jat.resolve_wave_width(jc, leaves, order))


# ---------------------------------------------------------------- decide
DECIDE_CASES = [
    ("free", ("pallas_t", 8, True, False, False), {}, (8, 64, 15, 2048)),
    ("ct_prior", ("pallas_ct", 32, True, False, False), {},
     (28, 64, 255, 1 << 21)),
    ("width_pinned", ("pallas_t", 16, True, False, False),
     {"width": True}, (136, 256, 255, 1 << 20)),
    ("all_pinned", ("pallas_t", 8, True, False, False),
     {"kernel": True, "width": True, "precision": True, "compact": True,
      "fused": True}, (8, 64, 15, 2048)),
]


def _strip_rooflines(events):
    """Decision/probe events without the roofline stamps (each package
    counts its own kernels' work) and the cache path."""
    out = []
    for ev, fields in events:
        f = {k: v for k, v in fields.items()
             if k not in ("roofline", "cache_path")}
        if "cells" in f:
            f["cells"] = [{k: v for k, v in c.items() if k != "roofline"}
                          for c in f["cells"]]
        out.append((ev, f))
    return out


@pytest.mark.parametrize("mode", ["measure", "force", "prior", "off"])
@pytest.mark.parametrize("name,prior,pins,bucket", DECIDE_CASES,
                         ids=[c[0] for c in DECIDE_CASES])
def test_decide_matches_jax(tmp_path, mode, name, prior, pins, bucket):
    ticks = [0.0]

    def timer():
        ticks[0] += 0.5
        return ticks[0]

    results = []
    for pkg, mod in (("jax", jat), ("torch", tat)):
        mod.install_probe_hooks(bench=_bench, timer=timer)
        cache = tmp_path / ("%s.json" % pkg)
        kw = dict(tpu_autotune=mode, tpu_autotune_cache=str(cache),
                  num_leaves=bucket[2])
        cfg = (JConfig if pkg == "jax" else TConfig)(dict(kw, verbose=-1))
        d = mod.decide(cfg, mod.ShapeBucket(*bucket), mod.Cell(*prior),
                       mod.Pins(**pins), eligible=True)
        blob = json.loads(cache.read_text()) if cache.exists() else None
        results.append((d, blob))
    (jd, jblob), (td, tblob) = results
    assert td.cell.as_dict() == jd.cell.as_dict()
    assert (td.mode, td.source, td.bucket, td.cache_hit) == \
        (jd.mode, jd.source, jd.bucket, jd.cache_hit)
    assert td.margin == jd.margin and td.overhead_s == jd.overhead_s
    assert [(c.as_dict(), s) for c, s in td.probes] == \
        [(c.as_dict(), s) for c, s in jd.probes]
    assert _strip_rooflines(td.events) == _strip_rooflines(jd.events)
    assert tblob == jblob
    if mode in ("measure", "force"):
        assert td.source == "measured" and tblob is not None
        probes = [f for ev, f in td.events if ev == "autotune_probe"]
        assert all(f["roofline"]["device_kind"] == "cpu" for f in probes)


def test_each_package_reads_the_others_cache(tmp_path):
    bucket, prior = (8, 64, 15, 2048), ("pallas_t", 8, True, False, False)
    for writer, reader in ((jat, tat), (tat, jat)):
        cache = tmp_path / ("%s.json" % writer.__name__)
        writer.install_probe_hooks(bench=_bench)
        w = writer.decide(
            (JConfig if writer is jat else TConfig)(
                {"tpu_autotune": "measure", "tpu_autotune_cache": str(cache),
                 "verbose": -1}),
            writer.ShapeBucket(*bucket), writer.Cell(*prior), writer.Pins(),
            eligible=True)
        writer.clear_probe_hooks()
        assert w.source == "measured"
        r = reader.decide(
            (JConfig if reader is jat else TConfig)(
                {"tpu_autotune": "prior", "tpu_autotune_cache": str(cache),
                 "verbose": -1}),
            reader.ShapeBucket(*bucket), reader.Cell(*prior), reader.Pins(),
            eligible=True)
        assert r.source == "cache" and r.cache_hit and not r.probes
        assert r.cell.as_dict() == w.cell.as_dict()


def test_stale_rev_and_corrupt_cache(tmp_path):
    tat.install_probe_hooks(bench=_bench)
    bucket = tat.ShapeBucket(8, 64, 15, 2048)
    prior = tat.Cell("pallas_t", 8, True, False)
    key = tat.cache_key("cpu", bucket)
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 1, "entries": {
        key.replace("|v2|", "|v1|"): {"cell": prior._replace(
            wave_width=64).as_dict(), "s_per_wave": 1e-9, "waves": 3}}}))
    corrupt = tmp_path / "corrupt.json"
    corrupt.write_text("{not json")
    for path in (stale, corrupt):
        assert tat.load_cache(str(path)) == {} == jat.load_cache(str(path))
        cfg = TConfig({"tpu_autotune": "measure", "verbose": -1,
                       "tpu_autotune_cache": str(path)})
        d = tat.decide(cfg, bucket, prior, tat.Pins(), eligible=True)
        assert d.source == "measured" and not d.cache_hit
        blob = json.loads(path.read_text())
        assert blob["version"] == tat.CACHE_SCHEMA_REV
        assert list(blob["entries"]) == [key]
        d2 = tat.decide(cfg, bucket, prior, tat.Pins(), eligible=True)
        assert d2.source == "cache" and d2.cell == d.cell


def test_cache_path_defaults(monkeypatch, tmp_path):
    cfg = TConfig({"verbose": -1})
    monkeypatch.setenv("LGBM_TPU_COMPILE_CACHE", str(tmp_path))
    jcfg = JConfig({"verbose": -1})
    assert tat.resolve_cache_path(cfg) == jat.resolve_cache_path(jcfg) \
        == str(tmp_path / "autotune_cache.json")
    monkeypatch.delenv("LGBM_TPU_COMPILE_CACHE")
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", None)
    assert tat.resolve_cache_path(cfg) == str(
        tmp_path / "lgbm_tpu_xla_cache" / "autotune_cache.json")
    assert tat.resolve_cache_path(TConfig({
        "tpu_autotune_cache": "x.json", "verbose": -1})) == "x.json"


def test_measure_on_the_cpu_without_hooks_is_the_prior(tmp_path):
    cache = tmp_path / "c.json"
    cfg = TConfig({"tpu_autotune": "measure", "verbose": -1,
                   "tpu_autotune_cache": str(cache)})
    prior = tat.Cell("pallas_t", 8, True, False)
    d = tat.decide(cfg, tat.ShapeBucket(8, 64, 15, 2048), prior, tat.Pins(),
                   eligible=True, probe=lambda cell: (lambda: None),
                   device="cpu")
    assert d.cell == prior and d.source == "prior" and not d.probes
    assert not cache.exists()
    X, y = _data(800, 6, 3)
    ev = tmp_path / "ev.jsonl"
    lgbt.train(dict(_train_params(cache), obs_events_path=str(ev)),
               lgbt.Dataset(X, label=y), 2, device="cpu")
    names = [json.loads(line)["ev"] for line in ev.read_text().splitlines()]
    assert names.count("autotune_decision") == 1
    assert "autotune_probe" not in names and not cache.exists()


def test_ineligible_and_off_record_one_decision(tmp_path):
    X, y = _data(500, 5, 4)
    for extra, source in (({}, "off"),
                          ({"tpu_autotune": "measure",
                            "tpu_growth": "exact",
                            "tpu_histogram_mode": "pallas"}, "ineligible")):
        tat.install_probe_hooks(bench=_bench)
        b = lgbt.train(dict({"objective": "binary", "num_leaves": 7,
                             "verbose": -1, "min_data_in_leaf": 5,
                             "obs_events_path": str(tmp_path / "e.jsonl")},
                            **extra), lgbt.Dataset(X, label=y), 1,
                       device="cpu")
        decs = [e for e in b.telemetry() if e["ev"] == "autotune_decision"]
        assert len(decs) == 1 and decs[0]["source"] == source
        assert not [e for e in b.telemetry() if e["ev"] == "autotune_probe"]


# ----------------------------------------------------- through train()
def _data(n, f, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32)
    return X, y


def _train_params(cache):
    return {"objective": "binary", "num_leaves": 15, "verbose": -1,
            "min_data_in_leaf": 5, "tpu_growth": "wave",
            "tpu_histogram_mode": "pallas_t", "tpu_autotune": "measure",
            "tpu_autotune_cache": str(cache)}


def test_train_under_measure_takes_the_winner(tmp_path):
    """The port and the JAX package decide the same cell for the same
    data under the same bench; the port's measured run trains the text
    of a run with that cell pinned; a second run is a cache hit."""
    X, y = _data(800, 6, 3)
    cells = {}
    for pkg, lgb, mod in (("jax", lgbj, jat), ("torch", lgbt, tat)):
        mod.install_probe_hooks(bench=_bench)
        p = _train_params(tmp_path / ("%s.json" % pkg))
        kw = {"device": "cpu"} if pkg == "torch" else {}
        b = lgb.train(p, lgb.Dataset(X, label=y, params=p), 2, **kw)
        cells[pkg] = b._gbdt.learner
    jl, tl = cells["jax"], cells["torch"]
    assert tl.autotune_source == jl.autotune_source == "measured"
    win = tl.autotune.cell
    assert (win.hist_mode, win.wave_width, win.hist_hilo,
            win.compact) == (jl.hist_mode, jl.wave_width, jl.hist_hilo,
                             jl.wave_compact)
    assert win.fused == jl.fused_autotune
    # the JAX package's winner from its own decision event
    assert win != tat.Cell("pallas_t", 8, True, False)
    measured = lgbt.train(_train_params(tmp_path / "torch.json"),
                          lgbt.Dataset(X, label=y), 4, device="cpu")
    assert measured._gbdt.learner.autotune_source == "cache"
    pinned = lgbt.train(
        {"objective": "binary", "num_leaves": 15, "verbose": -1,
         "min_data_in_leaf": 5, "tpu_growth": "wave",
         "tpu_histogram_mode": win.hist_mode,
         "tpu_wave_width": win.wave_width,
         "tpu_hist_precision": "hilo" if win.hist_hilo else "bf16",
         "tpu_wave_compact": win.compact,
         "tpu_fused_iter": "on" if win.fused else "off"},
        lgbt.Dataset(X, label=y), 4, device="cpu")
    assert measured.model_to_string() == pinned.model_to_string()
    assert measured._gbdt.learner.autotune_source == "cache"


def test_forced_probes_run_every_cell_on_the_cpu(tmp_path):
    """Probing forced on the CPU builds and runs every candidate (the
    staged chain and the fused schedule, at widths 4, 8 and 16, both
    kernels and both precisions): each probe run waits once through
    fence, the probes' launches are counted apart and every launch
    counter is as before."""
    ticks = [0.0]

    def timer():
        ticks[0] += 1.0
        return ticks[0]

    tat.install_probe_hooks(timer=timer, force=True)
    X, y = _data(600, 6, 5)
    p = dict(_train_params(tmp_path / "c.json"), tpu_autotune="force",
             tpu_histogram_mode="auto", tpu_autotune_waves=2,
             num_leaves=7, obs_events_path=str(tmp_path / "ev.jsonl"))
    counts = fused_iter._counts()
    f0 = timers.fence_count()
    ds = lgbt.Dataset(X, label=y, params=p).construct()
    b = lgbt.Booster(p, ds, device="cpu")
    lrn = b._gbdt.learner
    pad = tat.bin_pad(lrn.num_bins)
    cells = tat.enumerate_cells(
        tat.Cell(tat.prior_hist_mode(6, pad), 8, True, False),
        tat.ShapeBucket(6, pad, 7, 1024), tat.Pins())
    assert [c for c, _ in lrn.autotune.probes] == cells
    assert len(cells) == tat.MAX_CELLS
    assert {c.fused for c in cells} == {True, False}
    # the fake clock ticks once before and once after the two timed runs
    assert all(s == 0.5 for _, s in lrn.autotune.probes)
    assert timers.fence_count() - f0 == len(cells) * 3
    assert fused_iter._counts() == counts and lrn.autotune_launches == {}
    b.finalize_telemetry()
    names = [e["ev"] for e in b.telemetry()]
    assert names.count("autotune_probe") == len(cells)
    dec = [e for e in b.telemetry() if e["ev"] == "autotune_decision"][0]
    assert dec["source"] == "measured" and dec["device_kind"] == "cpu"
    assert all(c["roofline"]["roof_source"] == "table"
               for c in dec["cells"])


# ------------------------------------------------------------- roofline
def test_roofline_registry_and_the_one_yardstick():
    peaks = roofline.peaks_for("NVIDIA H100 80GB HBM3")
    assert peaks["source"] == "table"
    assert peaks["kind"] == "nvidia_h100_80gb_hbm3"
    assert (peaks["hbm_bytes_per_s"], peaks["flops_f32"],
            peaks["flops_bf16"], peaks["ici_bytes_per_s"],
            peaks["smem_bytes_per_sm"]) == (3.35e12, 67e12, 989e12, 900e9,
                                            228 * 1024)
    assert roofline.h100_peaks() == (3.35e12, 67e12)
    assert roofline.peaks_for("mystery chip")["source"] == "fallback"
    assert roofline.device_kind("cpu") == "cpu"
    from lightgbm_tpu.obs import roofline as jroof
    for raw in ("NVIDIA H100 80GB HBM3", "TPU v5 lite", "cpu", " Cpu-Device"):
        assert roofline.normalize_kind(raw) == jroof.normalize_kind(raw)
    for v in (0, 12.5, 3e3, 4.2e6, 7e9, 1.5e13):
        assert roofline.fmt_quantity(v, "B") == jroof.fmt_quantity(v, "B")
        assert roofline.fmt_quantity(v) == jroof.fmt_quantity(v)
        assert roofline.fmt_bytes(v) == jroof.fmt_bytes(v)
    stamp = {"bound": "memory", "hbm_util": 0.714, "flop_util": 0.1}
    assert roofline.describe_roofline_position(stamp) == "71% HBM" == \
        jroof.describe_roofline_position(stamp)
    # chip_smoke.py's bound column divides by the same row
    src = open(__file__.replace("tests/test_torch_autotune.py",
                                "chip_smoke.py")).read()
    assert "h100_peaks()" in src


def test_cell_traffic_counts_the_port_kernels():
    """One probe run's bytes and adds: B3 at the root, B1 or B3 a wave
    (chip_smoke.py's bound count at equal leaves), B2 once."""
    bucket = tat.ShapeBucket(28, 64, 4, 1000)
    flops, nbytes = roofline.cell_traffic(
        bucket, tat.Cell("pallas_t", 2, True, False))
    n, F, B = 1000, 28, 64
    root = n * 4 + n * (F + 12) + 4 + F * B * 12
    w1 = n * 4 + n * (F + 12) + 1 * 4 + 1 * F * B * 12     # 1 -> 2 leaves
    w2 = n * 4 + n * (F + 12) + 2 * 4 + 2 * F * B * 12     # 2 -> 4 leaves
    assert nbytes == root + w1 + w2 + n * 12 + 4 * 4
    assert flops == 3 * n * F * 3 + n
    f_ct, b_ct = roofline.cell_traffic(bucket,
                                       tat.Cell("pallas_ct", 2, True, False))
    assert f_ct == flops and b_ct > nbytes
    stamp = roofline.cell_roofline(bucket, tat.Cell("pallas_t", 2, True,
                                                    False),
                                   1e-3, kind="NVIDIA_H100_80GB_HBM3")
    assert stamp["device_kind"] == "nvidia_h100_80gb_hbm3"
    assert stamp["hbm_util"] == round(nbytes / 3.35e12 / 1e-3, 4)
