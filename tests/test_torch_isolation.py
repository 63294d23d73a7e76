"""The port stands alone: lightgbm_tpu_torch, its scripts
(chip_smoke.py, sparse_model_diff.py, dp_collectives_ab.py,
wide_hist_ab.py) and the examples' CPU shim
(tests/torch_cpu_lgb.py) import neither jax nor the JAX package, load no library of the JAX package's (lightgbm_tpu/lib,
cpp/build), and its CUDA entry points never fall back to the CPU."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "lightgbm_tpu_torch"


def test_import_leaves_no_jax_modules():
    code = ("import json, sys\n"
            "import lightgbm_tpu_torch, lightgbm_tpu_torch.convert\n"
            "import lightgbm_tpu_torch.ops.wave_kernels\n"
            "import lightgbm_tpu_torch.ops.predict\n"
            "import lightgbm_tpu_torch.ops.histogram\n"
            "import lightgbm_tpu_torch.ops.leaf_hist\n"
            "import lightgbm_tpu_torch.serve, lightgbm_tpu_torch.predictor\n"
            "import lightgbm_tpu_torch.obs.serve\n"
            "import lightgbm_tpu_torch.obs.query, lightgbm_tpu_torch.obs.model\n"
            "import lightgbm_tpu_torch.obs.dataquality\n"
            "import lightgbm_tpu_torch.obs.roofline\n"
            "import lightgbm_tpu_torch.obs.health\n"
            "import lightgbm_tpu_torch.obs.profile\n"
            "import lightgbm_tpu_torch.obs.memory\n"
            "import lightgbm_tpu_torch.obs.timers\n"
            "import lightgbm_tpu_torch.ops.autotune\n"
            "import lightgbm_tpu_torch.cli, lightgbm_tpu_torch.native\n"
            "import lightgbm_tpu_torch.pmml, lightgbm_tpu_torch.convert_model\n"
            "import lightgbm_tpu_torch.models.checkpoint\n"
            "import lightgbm_tpu_torch.io.parser\n"
            "import lightgbm_tpu_torch.sklearn, lightgbm_tpu_torch.plotting\n"
            "import lightgbm_tpu_torch.compat\n"
            "import lightgbm_tpu_torch.c_api, lightgbm_tpu_torch.capi_lib\n"
            "import lightgbm_tpu_torch.io.streaming\n"
            "import lightgbm_tpu_torch.io.binned_format\n"
            "from lightgbm_tpu_torch.engine import cv, CVBooster\n"
            "from lightgbm_tpu_torch.objectives import LambdarankNDCG\n"
            "from lightgbm_tpu_torch.metrics import NDCGMetric, MapMetric\n"
            "import torch_cpu_lgb\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m == 'jax' or m.startswith(('jax.', 'jaxlib')) or "
            "m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO), str(REPO / "tests")]))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_analyzer_and_the_elastic_loop_import_no_jax():
    """lightgbm_tpu_torch.analysis (every pass, the parameter doc
    rendered with the port's own generator) and parallel/elastic.py leave
    neither jax nor the JAX package in sys.modules."""
    code = ("import json, sys\n"
            "from lightgbm_tpu_torch.analysis import core, cli, params_doc\n"
            "import lightgbm_tpu_torch.parallel.elastic\n"
            "core.all_passes()\n"
            "params_doc.render()\n"
            "print(json.dumps(sorted(m for m in sys.modules if "
            "m == 'jax' or m.startswith(('jax.', 'jaxlib')) or "
            "m == 'lightgbm_tpu' or m.startswith('lightgbm_tpu.'))))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _sources():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                          REPO / "sparse_model_diff.py",
                                          REPO / "dp_collectives_ab.py",
                                          REPO / "wide_hist_ab.py",
                                          REPO / "tests" / "torch_cpu_lgb.py"]
    assert len(files) > 10
    return files


def test_sources_cover_the_autotuner_and_the_observer():
    """The scans below reach the autotuner and every module of the run
    observer, each of which is the port's own copy (no module of the JAX
    package's obs/ or ops/autotune.py is imported, even those that import
    no jax)."""
    names = {p.relative_to(PORT).as_posix() for p in _sources()
             if PORT in p.parents}
    assert {"ops/autotune.py", "obs/events.py", "obs/timers.py",
            "obs/memory.py", "obs/profile.py", "obs/health.py",
            "obs/model.py", "obs/dataquality.py", "obs/roofline.py",
            "obs/query.py", "obs/__init__.py"} <= names


def _host_sources():
    """The port's host C++ sources, which it builds itself (native.py,
    capi_lib.py)."""
    return sorted((PORT / "csrc" / "host").glob("*.cpp"))


def test_sources_cover_out_of_core_and_the_c_api():
    """The scans below reach the out-of-core modules and the C API, each
    the port's own copy, and the C ABI bridge's source (a C++ file the
    port builds itself) imports the port's c_api, not the JAX
    package's."""
    import re
    names = {p.relative_to(PORT).as_posix()
             for p in _sources() + _host_sources() if PORT in p.parents}
    assert {"io/streaming.py", "io/binned_format.py", "c_api.py",
            "capi_lib.py", "csrc/host/capi_bridge.cpp"} <= names
    bridge = (PORT / "csrc" / "host" / "capi_bridge.cpp").read_text()
    assert re.findall(r'PyImport_ImportModule\("([^"]+)"\)', bridge) == [
        "lightgbm_tpu_torch.c_api"]


def test_sources_cover_every_subpackage():
    """The parametrised scan below reaches every subpackage of the port,
    the serving tier and its observability among them."""
    dirs = {p.parent.relative_to(PORT).as_posix() for p in _sources()
            if PORT in p.parents}
    assert {".", "io", "models", "obs", "ops", "serve", "utils"} <= dirs
    subpackages = {p.parent.relative_to(PORT).as_posix()
                   for p in PORT.rglob("__init__.py")}
    assert subpackages <= dirs


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib"), (path, mod)
        assert top != "lightgbm_tpu", (path, mod)
    # no dynamic import of either
    text = path.read_text()
    assert "import_module(\"jax" not in text
    assert "__import__(\"jax" not in text


@pytest.mark.parametrize("path", _sources() + _host_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_names_no_jax_package_library(path):
    text = path.read_text()
    for name in ("lightgbm_tpu/lib", "cpp/build", "cpp/src",
                 "liblgbm_tpu_native", "liblgbm_tpu_capi"):
        assert name not in text, (path, name)


def test_port_loads_only_its_own_libraries():
    """Binning, host prediction and parsing through the port's host
    library: every shared library of the repository the process maps is
    the port's own build under lightgbm_tpu_torch/_build."""
    code = ("import json, numpy as np\n"
            "import lightgbm_tpu_torch as lgb\n"
            "from lightgbm_tpu_torch import native\n"
            "X = np.random.default_rng(0).normal(size=(300, 4))\n"
            "y = (X[:, 0] > 0).astype(float)\n"
            "b = lgb.train({'objective': 'binary', 'verbose': -1, "
            "'num_leaves': 4}, lgb.Dataset(X, label=y), 2, device='cpu')\n"
            "b._gbdt.predict_raw(X, allow_device=False)\n"
            "assert native.available()\n"
            "maps = open('/proc/self/maps').read().split('\\n')\n"
            "libs = sorted({ln.split()[-1] for ln in maps "
            "if ln.strip().endswith('.so') or '.so.' in ln})\n"
            "print(json.dumps([str(native.lib_path), libs]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    lib, libs = json.loads(out.stdout.strip().splitlines()[-1])
    build = str(PORT / "_build")
    assert lib.startswith(build + os.sep) and lib in libs
    ours = [p for p in libs if p.startswith(str(REPO) + os.sep)]
    assert ours and all(p.startswith(build + os.sep) for p in ours), ours
    assert not any("lightgbm_tpu/lib" in p or "cpp/build" in p
                   for p in libs)


def test_cuda_entry_point_raises_without_cuda():
    import torch

    import lightgbm_tpu_torch as lgb
    from lightgbm_tpu_torch.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the error path cannot run")
    X = np.random.default_rng(0).normal(size=(64, 3))
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(lgb.LightGBMError, match="needs CUDA"):
        lgb.train({"objective": "binary", "verbose": -1},
                  lgb.Dataset(X, label=y), 1)
    with pytest.raises(lgb.LightGBMError, match="needs CUDA"):
        lgb.Booster({"objective": "binary", "verbose": -1},
                    lgb.Dataset(X, label=y))
    with pytest.raises(lgb.LightGBMError, match="needs CUDA"):
        resolve_device("cuda:0")
    text = lgb.train({"objective": "binary", "verbose": -1},
                     lgb.Dataset(X, label=y), 1,
                     device="cpu").model_to_string()
    with pytest.raises(lgb.LightGBMError, match="needs CUDA"):
        lgb.Booster(model_str=text)
    assert resolve_device("cpu").type == "cpu"


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors; a tensor on
    another device goes to the kernel or raises (never a CPU fallback)."""
    import torch

    from lightgbm_tpu_torch.ops.predict import score_update
    from lightgbm_tpu_torch.ops.wave_kernels import wave_histogram

    meta = torch.zeros(4, device="meta")
    with pytest.raises(Exception):
        score_update(meta, torch.zeros(4, dtype=torch.int32, device="meta"),
                     torch.zeros(2, device="meta"))
    xt = torch.zeros((2, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(Exception):
        wave_histogram(xt, torch.zeros(4, dtype=torch.int32, device="meta"),
                       torch.zeros((4, 3), device="meta"),
                       torch.zeros(1, dtype=torch.int32, device="meta"), 4)

    from lightgbm_tpu_torch.ops.sparse_mxu import (ChunkedSparseStore,
                                                   sparse_wave_histogram)

    def i32(*shape):
        return torch.zeros(shape, dtype=torch.int32, device="meta")

    store = ChunkedSparseStore(ent_row=i32(8, 4), ent_bin=i32(8, 4),
                               chunk_col=i32(8, 1), col_cptr=i32(3),
                               fill=i32(2), cap_chunks=1)
    with pytest.raises(Exception, match="unsupported device"):
        sparse_wave_histogram(store, i32(4), torch.zeros((4, 3),
                                                          device="meta"),
                              i32(2), 4, 2)

    from lightgbm_tpu_torch.ops.leaf_hist import leaf_histogram
    from lightgbm_tpu_torch.ops.wave_kernels import wave_histogram_rowmajor

    x = torch.zeros((4, 2), dtype=torch.uint8, device="meta")
    f32 = torch.zeros(4, device="meta")
    with pytest.raises(Exception, match="unsupported device"):
        leaf_histogram(x, f32, f32, i32(4), 0, None, 4)
    with pytest.raises(Exception, match="unsupported device"):
        wave_histogram_rowmajor(x, i32(4), torch.zeros((4, 3), device="meta"),
                                i32(1), 4)
