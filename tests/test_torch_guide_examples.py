"""The python-guide examples run on the port, on the CPU.

Each of examples/python-guide/{simple,advanced,plot,sklearn}_example.py
is read, its one line ``import lightgbm_tpu as lgb`` replaced by
``import torch_cpu_lgb as lgb`` (tests/torch_cpu_lgb.py: the port with
``device="cpu"`` bound into train, cv, Booster and the estimators; the
package itself has no CPU switch) and its ``/tmp/`` paths (the model
files and figures it writes and reads back) by the run's own temporary
directory, so no other run of the examples shares its files; then it is
written to that directory under a name that shadows no module, and run
in a subprocess with one torch thread.  The four start together and each must exit 0 with
output.  chip_smoke.py phase 9 runs them the same way on the card, with
``import lightgbm_tpu_torch as lgb``.
"""
import os
import subprocess
import sys

import pytest
from torch_cases import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GUIDE = os.path.join(REPO, "examples", "python-guide")
NAMES = ["simple_example", "advanced_example", "plot_example",
         "sklearn_example"]
IMPORT = "import lightgbm_tpu as lgb"
TMP = "/tmp/"
# the examples that write files under TMP (and read them back)
WRITES_TMP = ("simple_example", "advanced_example", "plot_example")
TIMEOUT = 600


def port_source(name: str, replacement: str, work: str) -> str:
    """The example's source with its one import line replaced and its
    TMP prefix made the directory ``work``; raises unless the import
    line is there exactly once, or if an example of WRITES_TMP holds no
    TMP path."""
    with open(os.path.join(GUIDE, name + ".py")) as f:
        lines = f.read().split("\n")
    at = [i for i, ln in enumerate(lines) if ln == IMPORT]
    if len(at) != 1:
        raise AssertionError("%s: %r found %d times" % (name, IMPORT,
                                                        len(at)))
    lines[at[0]] = replacement
    src = "\n".join(lines)
    if name in WRITES_TMP and TMP not in src:
        raise AssertionError("%s: %r not found" % (name, TMP))
    return src.replace(TMP, os.path.join(work, ""))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("guide")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([REPO, HERE]),
               OMP_NUM_THREADS="1", MPLBACKEND="Agg")
    procs = {}
    for name in NAMES:
        path = work / ("port_" + name + ".py")
        path.write_text(port_source(name, "import torch_cpu_lgb as lgb",
                                    str(work)))
        procs[name] = subprocess.Popen(
            [sys.executable, str(path)], cwd=str(work), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.mark.parametrize("name", NAMES)
def test_python_guide_example_runs_on_the_port(runs, name):
    out, err = runs[name].communicate(timeout=TIMEOUT)
    assert runs[name].returncode == 0, "%s failed:\n%s" % (name, err[-3000:])
    assert out.strip(), "%s produced no output" % name


def test_the_import_line_is_replaced_once(tmp_path, monkeypatch):
    src = port_source("simple_example", "import torch_cpu_lgb as lgb",
                      str(tmp_path))
    assert "import torch_cpu_lgb as lgb" in src and IMPORT not in src
    (tmp_path / "none.py").write_text("import numpy\n")
    (tmp_path / "two.py").write_text(IMPORT + "\n" + IMPORT + "\n")
    monkeypatch.setattr(sys.modules[__name__], "GUIDE", str(tmp_path))
    for name, times in (("none", 0), ("two", 2)):
        with pytest.raises(AssertionError, match="found %d times" % times):
            port_source(name, "x", str(tmp_path))


@pytest.mark.parametrize("name", WRITES_TMP)
def test_the_tmp_paths_become_the_runs_own(tmp_path, monkeypatch, name):
    work = str(tmp_path / "run")
    src = port_source(name, "x", work)
    assert (work + "/") in src and TMP not in src.replace(work + "/", "")
    (tmp_path / (name + ".py")).write_text(IMPORT + "\n")
    monkeypatch.setattr(sys.modules[__name__], "GUIDE", str(tmp_path))
    with pytest.raises(AssertionError, match="not found"):
        port_source(name, "x", work)
