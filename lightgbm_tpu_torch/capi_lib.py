"""Build and load the port's LGBM_* C ABI library
(``csrc/host/capi_bridge.cpp``, ``liblgbm_tpu_torch_capi_<digest>.so``).

The library embeds CPython and forwards every exported ``LGBM_*`` symbol
to ``c_api.py`` (the reference's ``lib_lightgbm.so`` analog, as the JAX
package's CMake target ``lgbm_tpu_capi`` builds it).  It is built on
first use with the host C++ compiler into ``_build/``, named by a digest
of its source, the flags and the Python it was built for, against the
include directory ``sysconfig`` names and, where ``sysconfig`` names a
shared libpython, linked to it.  Nothing is built at import time, and a
failed build raises with the command and the compiler's output.

Load it into a Python process with ``ctypes.CDLL`` (``load()``), not
``PyDLL``: ctypes then releases the GIL around each call and the bridge's
``PyGILState_Ensure`` takes it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sysconfig
import threading
from pathlib import Path
from typing import List, Optional

from .native import BUILD_DIR, SOURCE_DIR, _compiler
from .utils.log import LightGBMError

SOURCE = SOURCE_DIR / "capi_bridge.cpp"
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _python_flags() -> List[str]:
    """-I the Python headers; -L/-l/-rpath a shared libpython where this
    interpreter has one (a static one resolves from the host process)."""
    include = sysconfig.get_paths()["include"]
    flags = ["-I" + include]
    if sysconfig.get_config_var("Py_ENABLE_SHARED"):
        libdir = sysconfig.get_config_var("LIBDIR") or ""
        ver = (sysconfig.get_config_var("LDVERSION")
               or sysconfig.get_config_var("VERSION"))
        flags += ["-L" + libdir, "-lpython" + str(ver),
                  "-Wl,-rpath," + libdir]
    return flags


def lib_path() -> Path:
    h = hashlib.sha256()
    h.update(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + _python_flags()).encode())
    return BUILD_DIR / ("liblgbm_tpu_torch_capi_%s.so" % h.hexdigest()[:16])


def build() -> Path:
    """The library's path, compiling it if it is missing."""
    global build_seconds
    import time
    so = lib_path()
    if so.exists():
        build_seconds = 0.0
        return so
    cxx = _compiler()
    if cxx is None:
        raise LightGBMError("the C ABI library needs a C++ compiler (CXX, "
                            "c++ or g++); none was found")
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        raise LightGBMError("the C ABI library needs the Python headers; "
                            "%s/Python.h is missing" % include)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name("%s.%d" % (so.name, os.getpid()))
    # the Python flags go last: -l must follow the object that needs it
    cmd = [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *_python_flags()]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise LightGBMError("building the C ABI library failed:\n$ %s\n%s"
                            % (" ".join(cmd), out.stdout))
    os.replace(tmp, so)
    build_seconds = time.perf_counter() - t0
    return so


def load() -> ctypes.CDLL:
    """The library, built on first call, loaded with ctypes.CDLL; its
    LGBM_GetLastError returns a char*."""
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            lib.LGBM_GetLastError.restype = ctypes.c_char_p
            _LIB = lib
    return _LIB
