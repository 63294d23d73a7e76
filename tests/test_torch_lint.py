"""The port's static analyzer (lightgbm_tpu_torch/analysis/) against the
JAX package's (tests/test_lint.py, case for case where a counterpart
exists).

* Each pass has a true-positive and a true-negative fixture.  The
  events and config passes, and core's suppressions and baselines, take
  the same fixture text (the package's name swapped) through both
  analyzers and must give the same findings.
* hostsync reads torch values; recompile flags CUDA graph captures and
  kernel builds in loops (the JAX pass's two static-argument rules have
  no counterpart: rule_catalog says why); smem sweeps the kernels'
  launch planners and catches a lowered budget, as the JAX vmem pass's
  regression tests do.
* The CLI's exit codes: 0 clean, 1 findings, 2 internal error; the
  repo's tree is clean.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lightgbm_tpu.analysis import config_coherence as jconfig
from lightgbm_tpu.analysis import core as jcore
from lightgbm_tpu.analysis import events_schema as jevents
from lightgbm_tpu_torch.analysis import core
from lightgbm_tpu_torch.analysis import (config_coherence, events_schema,
                                         hostsync, recompile, smem)
from lightgbm_tpu_torch.analysis.cli import main as lint_main

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "lightgbm_tpu_torch"


def mod_from(src, path=PKG + "/ops/fixture.py", core_mod=core):
    """A SourceModule built as load_modules builds one, from a string."""
    tree = ast.parse(src, filename=path)
    return core_mod.SourceModule(path, src, tree, src.splitlines())


def run_pass(p, src, path=PKG + "/ops/fixture.py"):
    return p.run([mod_from(src, path)], REPO_ROOT)


def rules_of(findings):
    return sorted(f.rule for f in findings)


def both(jpass, tpass, src, sub="obs/fixture.py"):
    """(rule, line) findings of the same fixture through the JAX
    package's pass and the port's."""
    jf = jpass.run([mod_from(src, "lightgbm_tpu/" + sub, jcore)],
                   REPO_ROOT)
    tf = tpass.run([mod_from(src, PKG + "/" + sub)], REPO_ROOT)
    return (sorted((f.rule, f.line) for f in jf),
            sorted((f.rule, f.line) for f in tf))


# ---------------------------------------------------------------- hostsync

def test_hostsync_true_positives():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def f(g, dev):\n"
        "    x = torch.cumsum(g, 0)\n"
        "    a = float(x)\n"                    # sync-scalar-cast
        "    b = x.item()\n"                    # sync-item
        "    c = np.asarray(x)\n"               # sync-asarray
        "    d = x.tolist()\n"                  # sync-tolist
        "    e = x.sum().cpu()\n"               # sync-cpu
        "    y = torch.zeros(3, device=dev)\n"
        "    h = y.numpy()\n"                   # sync-numpy
        "    torch.cuda.synchronize()\n"        # sync-synchronize
        "    ev = torch.cuda.Event()\n"
        "    ev.synchronize()\n"                # sync-synchronize
        "    return a, b, c, d, e, h\n")
    assert rules_of(run_pass(hostsync, src)) == [
        "sync-asarray", "sync-cpu", "sync-item", "sync-numpy",
        "sync-scalar-cast", "sync-synchronize", "sync-synchronize",
        "sync-tolist"]


def test_hostsync_true_negatives():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "from ..obs.timers import fence, fenced_get\n"
        "def f(g, host_rows):\n"
        "    x = torch.cumsum(g, 0)\n"
        "    n = int(x.shape[0])\n"             # metadata: no wait
        "    m = x.numel() + x.size(0)\n"
        "    h = fenced_get(x)\n"               # the counted read
        "    fence(x)\n"                        # the counted wait
        "    y = np.asarray(host_rows)\n"       # unprovable: silent
        "    z = float(n)\n"                    # a host int
        "    stage = torch.empty(8, pin_memory=True)\n"
        "    s = stage.numpy()\n"               # a host tensor
        "    w = g.item()\n"                    # a parameter: unproven
        "    return h, y, z, s, m, w\n")
    assert run_pass(hostsync, src) == []


def test_hostsync_flow_sensitive():
    # a name that only later becomes a device value is a host value at
    # its earlier reads
    src = (
        "import numpy as np\n"
        "import torch\n"
        "def f(V, dev):\n"
        "    V = np.concatenate([np.asarray(V), np.zeros(4)])\n"
        "    W = np.asarray(V)\n"
        "    V = torch.as_tensor(V, device=dev)\n"
        "    return V, W\n")
    assert run_pass(hostsync, src) == []


def test_hostsync_out_of_scope_module_silent():
    src = "import torch\ntorch.cuda.synchronize()\n"
    assert run_pass(hostsync, src, path=PKG + "/io/fixture.py") == []


def test_hostsync_reads_of_the_hot_path_carry_their_reason():
    """The port's deliberate waits (the tree's and a wave's one read,
    the bulk drain, the paged upload's stage, the serving reply) are
    suppressed inline, each with its reason after the marker, and the
    raw pass finds exactly those."""
    mods = core.load_modules(REPO_ROOT)
    raw = hostsync.run(mods, REPO_ROOT)
    assert raw and core.apply_suppressions(raw, mods) == []
    sup = {m.path: core.collect_suppressions(m) for m in mods}
    for f in raw:
        assert f.rule in sup[f.file][f.line]
        line = next(m for m in mods if m.path == f.file).lines[f.line - 1]
        reason = line.split("lint: ignore[", 1)[1].split("]", 1)[1]
        assert reason.strip(), (f.file, f.line)


# --------------------------------------------------------------- recompile

def test_recompile_true_positives():
    src = (
        "import torch\n"
        "from .. import _build\n"
        "def loop(xs, pool):\n"
        "    out = []\n"
        "    for x in xs:\n"
        "        g = torch.cuda.CUDAGraph()\n"
        "        with torch.cuda.graph(g):\n"          # capture-in-loop
        "            out.append(x + 1)\n"
        "        g.capture_begin(pool=pool)\n"         # capture-in-loop
        "        g.capture_end()\n"
        "    while not out:\n"
        "        _build.build()\n"                     # build-in-loop
        "    return out\n")
    assert rules_of(run_pass(recompile, src)) == [
        "build-in-loop", "capture-in-loop", "capture-in-loop"]


def test_recompile_true_negatives():
    src = (
        "import torch\n"
        "from .. import _build\n"
        "def capture(fn):\n"
        "    g = torch.cuda.CUDAGraph()\n"
        "    with torch.cuda.graph(g):\n"              # not in a loop
        "        fn()\n"
        "    return g\n"
        "def loop(fns, cache):\n"
        "    for i, fn in enumerate(fns):\n"
        "        lib = _build.library()\n"             # the cached load
        "        if i not in cache:\n"
        "            cache[i] = capture(fn)\n"         # the factory's
        "    return lib\n")
    assert run_pass(recompile, src) == []


# ------------------------------------------------------------ event schema

def test_events_true_positives():
    src = (
        "def emit_stuff(obs, t):\n"
        "    obs.event('no_such_event_xyz', t=t)\n"        # unknown type
        "    obs.event('iter', t=t, bogus_field=1)\n"      # unknown field
        "    obs.event('straggler', t=t)\n"                # missing req'd
        "    obs.event('run_header', schema=3)\n")         # old schema
    jf, tf = both(jevents, events_schema, src)
    assert tf == jf
    assert {r for r, _ in tf} == {
        "event-unknown-type", "event-unknown-field",
        "event-missing-field", "event-schema-version"}


def test_events_true_negatives():
    from lightgbm_tpu_torch.obs import events as ev
    req = sorted(ev._REQUIRED["iter"])
    kw = ", ".join("%s=1" % k for k in req)
    src = (
        "def emit_stuff(obs, t, extra):\n"
        "    obs.event('iter', %s)\n"                      # exact schema
        "    obs.event('iter', **extra)\n"                 # splat: trusted
        "    obs.event('mesh_shrink', world_size_from=2, world_size_to=1,"
        " it=3, reason='resume', checkpoint='c')\n"
        "    q = []\n"
        "    q.append(('not_an_event_name', {'free': 1}))\n" % kw)
    assert both(jevents, events_schema, src) == ([], [])


def test_events_schema_tables_cover_repo():
    # the port's emit sites all agree with its obs/events.py
    mods = core.load_modules(REPO_ROOT)
    assert events_schema.run(mods, REPO_ROOT) == []


# ----------------------------------------------------------------- config

def test_config_true_positives():
    src = (
        "def f(config):\n"
        "    a = config.definitely_not_a_param_xyz\n"      # unknown read
        "    b = config.raw.get('definitely_not_a_key_xyz')\n"
        "    return a, b\n")
    jf, tf = both(jconfig, config_coherence, src, "ops/fixture.py")
    # the registry and doc rules run on the whole repo in both: the
    # fixture's findings are the same
    assert tf == jf
    assert sorted(r for r, _ in tf) == ["config-unknown-key",
                                        "config-unknown-read"]


def test_config_true_negatives():
    src = (
        "import torch\n"
        "import jax\n"
        "def f(config):\n"
        "    jax.config.update('jax_enable_x64', True)\n"  # foreign config
        "    torch.backends.cuda.matmul.allow_tf32 = False\n"
        "    a = config.num_leaves\n"
        "    b = config.raw.get('max_bin', 255)\n"
        "    c = config.raw.get('two_round', 'false')\n"   # alias is fine
        "    return a, b, c\n")
    assert both(jconfig, config_coherence, src, "ops/fixture.py") == \
        ([], [])


def test_config_registry_and_doc_fresh():
    # the port's registry is consistent and renders docs/Parameters.md
    # to the byte with the port's copy of the generator
    assert config_coherence.run([], REPO_ROOT) == []
    from lightgbm_tpu_torch.analysis import params_doc
    with open(os.path.join(REPO_ROOT, "docs", "Parameters.md")) as f:
        assert params_doc.render() == f.read()


def test_config_doc_rule_catches_a_registry_departure(monkeypatch):
    from lightgbm_tpu_torch.utils import config as C
    monkeypatch.setitem(C.Config._FIELDS, "num_leaves", ("int", 30))
    assert rules_of(config_coherence.run([], REPO_ROOT)) == [
        "params-doc-stale"]


# ------------------------------------------------------------------- smem

def test_smem_clean_on_repo_planners():
    # every plan of B1, B3, B4, B5 (dense, every form) and B6 over the
    # grid fits its budget and the H100's opt-in, keeps a block resident
    # and tiles the bins once
    assert smem.run(core.load_modules(REPO_ROOT), REPO_ROOT) == []


def test_smem_catches_a_lowered_budget(monkeypatch):
    # the plans are made for 220 KB a block; a card that gave a block
    # 64 KB would not launch them
    monkeypatch.setattr(smem, "H100_SMEM_PER_BLOCK", 64 * 1024)
    found = smem.run([], REPO_ROOT)
    assert set(rules_of(found)) == {"smem-budget"}
    assert {f.file for f in found} == {
        PKG + "/ops/wave_kernels.py", PKG + "/ops/sparse_mxu.py",
        PKG + "/ops/leaf_hist.py"}


def test_smem_catches_a_planner_regression(monkeypatch):
    # a planner that forgot its bin tiles: one block over every bin of a
    # wide feature, too big to be resident, its tiles short of B
    from lightgbm_tpu_torch.ops import wave_kernels as wk
    real = wk.hist_plan.__wrapped__

    def bad_plan(F, N, B, K, num_sms, packed=False, wide=False):
        plan = list(real(F, N, B, K, num_sms, packed, wide))
        if B > 9000:
            plan[6] = B * 3 * 8              # one untiled row of bins
        return tuple(plan)
    monkeypatch.setattr(wk, "hist_plan", bad_plan)
    monkeypatch.setattr(wk, "bin_tiles",
                        lambda F, B, groups, FS, packed=False:
                        [(0, min(B, 9000))])
    rules = set(rules_of(smem.run([], REPO_ROOT)))
    assert rules == {"smem-budget", "smem-resident", "smem-bin-tiles"}


def test_b5_and_wide_bins_plan_within_the_budget_at_every_width():
    # the counterpart of the JAX pallas_hist tile test: B5 (the dense
    # histogram pass at K = 1) plans within the budget at every bin
    # width the binner makes, with tiles that cover the bins once
    from lightgbm_tpu_torch.ops import wave_kernels as wk
    # (where one block cannot hold its cells), and its one-scan plan
    # holds them in one block within an H100 block's opt-in
    from lightgbm_tpu_torch.ops import leaf_hist as lh
    for B in (16, 63, 64, 255, 256, 1023, 9387, 16383, 65536):
        for wide in (False, True):
            _, groups, _, ks, fs, copies, sm, _ = wk.hist_plan(
                28, 100_000, B, 1, 132, False, wide)
            assert sm <= wk._SMEM_BUDGET <= smem.H100_SMEM_PER_BLOCK
            assert smem._covers_once(wk.bin_tiles(28, B, groups, fs), B)
            plan = lh.leaf_plan(28, B, wide)
            assert plan.fused == (28 * B * (48 if wide else 24)
                                  <= lh.LEAF_SMEM_BUDGET)
            assert (plan.smem + lh.LEAF_STATIC_SMEM
                    <= smem.H100_SMEM_PER_BLOCK)


def test_b6_refuses_a_width_it_cannot_plan():
    # the counterpart of the JAX fallback test: B6 tiles the bin axis
    # where one (slot, B, 3) row exceeds a block's shared memory, so it
    # plans every width the binner makes, and refuses loudly past them
    # instead of planning an oversized block
    from lightgbm_tpu_torch.ops import sparse_mxu as sm
    from lightgbm_tpu_torch.utils.log import LightGBMError
    ks, _, smem_bytes, tiles = sm.launch_plan(9000, 32)
    assert ks >= 1 and tiles == 1
    assert smem_bytes <= smem.H100_SMEM_PER_BLOCK
    ks, _, smem_bytes, tiles = sm.launch_plan(16383, 1)
    assert tiles == 2 and smem_bytes <= smem.H100_SMEM_PER_BLOCK
    with pytest.raises(LightGBMError, match="bins"):
        sm.launch_plan(65537, 1)


# ------------------------------------------- suppressions and baselines

EVENT_SRC = ("def f(obs):\n"
             "    obs.event('no_such_event_xyz')%s\n")


@pytest.mark.parametrize("marker,kept", [
    ("  # lint: ignore[event-unknown-type] fixture", []),
    ("  # lint: ignore[*]", []),
    ("  # lint: ignore[sync-item]", ["event-unknown-type"])])
def test_inline_suppression_honored(marker, kept):
    src = EVENT_SRC % marker
    for c, p, pkg in ((jcore, jevents, "lightgbm_tpu"),
                      (core, events_schema, PKG)):
        mods = [mod_from(src, pkg + "/obs/fixture.py", c)]
        raw = p.run(mods, REPO_ROOT)
        assert rules_of(raw) == ["event-unknown-type"]
        assert rules_of(c.apply_suppressions(raw, mods)) == kept


def test_suppression_inside_string_is_inert():
    src = ('MSG = "# lint: ignore[event-unknown-type]"\n'
           + EVENT_SRC % "")
    for c, p, pkg in ((jcore, jevents, "lightgbm_tpu"),
                      (core, events_schema, PKG)):
        mods = [mod_from(src, pkg + "/obs/fixture.py", c)]
        assert rules_of(c.apply_suppressions(p.run(mods, REPO_ROOT),
                                             mods)) == ["event-unknown-type"]


def test_baseline_round_trip(tmp_path):
    for c, pkg in ((jcore, "lightgbm_tpu"), (core, PKG)):
        f1 = c.Finding("sync-item", "hostsync", pkg + "/ops/x.py", 12, "m")
        f2 = c.Finding("sync-item", "hostsync", pkg + "/ops/x.py", 40, "m")
        path = str(tmp_path / ("bl_%s.json" % pkg))
        c.write_baseline(path, [f1])
        assert c.apply_baseline([f1, f2], c.load_baseline(path)) == [f2]
        assert c.load_baseline(str(tmp_path / "nope.json")) == []
    # the two packages write the same file
    with open(str(tmp_path / "bl_lightgbm_tpu.json")) as a, \
            open(str(tmp_path / ("bl_%s.json" % PKG))) as b:
        ja, tb = json.load(a), json.load(b)
    assert [e["line"] for e in ja["findings"]] == \
        [e["line"] for e in tb["findings"]]


def test_corrupt_baseline_fails_closed(tmp_path):
    path = str(tmp_path / "bad.json")
    with open(path, "w") as f:
        f.write("{not json")
    with pytest.raises(core.LintInternalError):
        core.load_baseline(path)
    assert lint_main(["--baseline", path]) == 2     # exit 2


def test_a_crashing_pass_fails_closed(monkeypatch):
    def boom(modules, repo_root):
        raise ValueError("boom")
    monkeypatch.setattr(smem, "run", boom)
    with pytest.raises(core.LintInternalError, match="smem"):
        core.run_lint(REPO_ROOT)
    assert lint_main(["--check"]) == 2


# ------------------------------------------------------------------- CLI

def test_cli_repo_is_clean(capsys):
    assert lint_main(["--check"]) == 0
    assert "lint: clean" in capsys.readouterr().out


def test_cli_exit_one_on_findings(tmp_path, monkeypatch, capsys):
    fake = tmp_path / "repo" / PKG / "ops"
    fake.mkdir(parents=True)
    (fake / "bad.py").write_text(
        "import torch\n"
        "def f(x):\n"
        "    torch.cuda.synchronize()\n")
    (fake.parent / "__init__.py").write_text("")
    (fake / "__init__.py").write_text("")
    from lightgbm_tpu_torch.analysis import cli as lint_cli
    monkeypatch.setattr(lint_cli, "_repo_root",
                        lambda: str(tmp_path / "repo"))
    assert lint_cli.main(["--check"]) == 1
    out = capsys.readouterr().out
    assert "sync-synchronize" in out and "FAIL" in out
    assert lint_cli.main(["--json"]) == 1
    data = json.loads(capsys.readouterr().out)
    assert data["findings"][0]["rule"] == "sync-synchronize"
    assert data["findings"][0]["file"] == PKG + "/ops/bad.py"
    bl = str(tmp_path / "bl.json")
    assert lint_cli.main(["--write-baseline", bl]) == 0
    assert lint_cli.main(["--check", "--baseline", bl]) == 0
    # a path narrows the AST passes to it
    assert lint_cli.main([str(fake / "__init__.py"), "--check"]) == 0


def test_cli_rules_catalog(capsys):
    cat = core.rule_catalog()
    assert {p for (p, _) in cat.values()} == {
        "hostsync", "recompile", "events", "config", "smem"}
    # the JAX pass's static-argument rules have no counterpart, and the
    # recompile pass says why
    assert "jit-static-drift" not in cat
    assert "jit-static-drift" in cat["capture-in-loop"][1]
    assert "static_argnames" in recompile.__doc__
    assert lint_main(["--rules"]) == 0
    assert "capture-in-loop" in capsys.readouterr().out


def test_cli_module_entry():
    # `python -m lightgbm_tpu_torch lint --check`: the gate's spelling,
    # through the port's CLI dispatch
    env = dict(os.environ, PYTHONPATH=REPO_ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", PKG, "lint", "--check"],
        cwd=REPO_ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "lint: clean" in r.stdout
    assert "jax" not in r.stderr


# ------------------------------------------------------- the sanctioned waits

def test_fenced_get_counts_and_returns():
    from lightgbm_tpu_torch.obs import timers
    x = torch.arange(4)
    c0 = timers.fence_count()
    out = timers.fenced_get(x)
    assert timers.fence_count() == c0 + 1
    np.testing.assert_array_equal(out, np.arange(4))
    assert timers.fenced_get({"a": 3})["a"] == 3
    timers.fence(x)
    assert timers.fence_count() == c0 + 3
