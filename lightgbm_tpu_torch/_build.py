"""Build and load the package's CUDA kernels.

The sources in ``csrc/`` have a plain C interface.  On first use each
``.cu`` file is compiled for ``sm_90a`` by its own ``nvcc`` process (all
started together), the objects are linked into one shared library under
``_build/`` (named by a digest of the sources and of the ``.cuh``
headers beside them, so an edited source or header rebuilds), and the
library is loaded with ``ctypes``.  Nothing here runs at import time: a
machine without ``nvcc`` or a GPU imports the package and runs the plain
torch versions of the kernels on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from .utils.log import LightGBMError

_PKG = Path(__file__).resolve().parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0
# compiler output of the last build (ptxas's register, shared-memory and
# spill report for each kernel)
build_log = ""
# times this process loaded the kernel library (1 after the first kernel
# call): the run observer's compile tracker counts the first build and
# load as a compile of the entry that triggered it (obs/compile.py)
loads = 0


def _sources():
    """The sources nvcc compiles, one object each."""
    return sorted(SOURCE_DIR.glob("*.cu"))


def _inputs():
    """Every file a build reads: the sources and the headers they may
    include, so that an edited header also rebuilds."""
    return sorted(list(SOURCE_DIR.glob("*.cu"))
                  + list(SOURCE_DIR.glob("*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise LightGBMError("nvcc not found: the CUDA kernels of "
                        "lightgbm_tpu_torch are built with nvcc on first use")


def _digest(sources) -> str:
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if their library is missing; return its path."""
    global build_seconds, build_log
    sources = _sources()
    if not sources:
        raise LightGBMError("no CUDA sources under %s" % SOURCE_DIR)
    so = BUILD_DIR / ("liblgbt_kernels_%s.so" % _digest(_inputs()))
    if so.exists():
        build_seconds = 0.0
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    tag = "%d" % os.getpid()
    objs, procs = [], []
    for src in sources:
        obj = BUILD_DIR / ("%s.%s.o" % (src.stem, tag))
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for src, p in procs:
        out, _ = p.communicate()
        logs.append("== %s\n%s" % (src.name, out))
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise LightGBMError("nvcc failed on %s:\n%s"
                            % (", ".join(failed), "\n".join(logs)))
    tmp = so.with_name(so.name + "." + tag)
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise LightGBMError("nvcc link failed:\n%s" % link.stdout)
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    build_log = "\n".join(logs)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, loads
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        loads += 1
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        cf = ctypes.c_float
        lib.lgbt_wave_hist.argtypes = [vp] * 8 + [ci] * 17 + [vp]
        lib.lgbt_wave_hist.restype = ci
        lib.lgbt_wave_fused.argtypes = [vp] * 11 + [ci] * 18 + [vp]
        lib.lgbt_wave_fused.restype = ci
        lib.lgbt_wave_finish.argtypes = [vp] * 4 + [ci] * 4 + [vp]
        lib.lgbt_wave_finish.restype = ci
        lib.lgbt_wave_list.argtypes = [vp] * 9 + [ci] * 9 + [vp]
        lib.lgbt_wave_list.restype = ci
        lib.lgbt_wave_hist_smem.argtypes = [ci] * 4
        lib.lgbt_wave_hist_smem.restype = cll
        lib.lgbt_wave_hist_smem_form.argtypes = [ci] * 5
        lib.lgbt_wave_hist_smem_form.restype = cll
        lib.lgbt_wave_bin_tile.argtypes = [ci] * 5
        lib.lgbt_wave_bin_tile.restype = ci
        lib.lgbt_wave_hist_blocks_per_sm.argtypes = [ci] * 6
        lib.lgbt_wave_hist_blocks_per_sm.restype = ci
        lib.lgbt_wave_hist_blocks_per_sm_form.argtypes = [ci] * 8
        lib.lgbt_wave_hist_blocks_per_sm_form.restype = ci
        lib.lgbt_wave_hist_ordered_blocks_per_sm.argtypes = [ci] * 5
        lib.lgbt_wave_hist_ordered_blocks_per_sm.restype = ci
        lib.lgbt_score_update.argtypes = [vp, vp, vp, vp, cll, ci, cf, cf,
                                          vp]
        lib.lgbt_score_update.restype = ci
        lib.lgbt_sparse_hist.argtypes = [vp] * 8 + [ci] * 9 + [vp]
        lib.lgbt_sparse_hist.restype = ci
        lib.lgbt_sparse_hist_smem.argtypes = [ci] * 2
        lib.lgbt_sparse_hist_smem.restype = cll
        lib.lgbt_leaf_hist.argtypes = [vp] * 7 + [ci] * 6 + [vp]
        lib.lgbt_leaf_hist.restype = ci
        lib.lgbt_leaf_smem.argtypes = [ci] * 3
        lib.lgbt_leaf_smem.restype = cll
        lib.lgbt_leaf_static_smem.argtypes = []
        lib.lgbt_leaf_static_smem.restype = cll
        _lib = lib
        return lib


def stream(dev) -> int:
    """The raw handle of torch's current CUDA stream on dev (what
    torch.cuda.current_stream(dev).cuda_stream returns, without building
    a Stream object: a few microseconds less host work a launch)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if dev.index is None else dev.index)


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise LightGBMError("CUDA error %d in %s" % (err, what))
