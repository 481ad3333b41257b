"""Build and load the port's CUDA kernels.

``load_library()`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, under ``_build/`` next to this
file (git-ignored), and loads it with ctypes.  The library's name carries a
hash of the sources and flags, so an unchanged tree reuses its build and
an edited one rebuilds.  Nothing here runs at import time: CPU-only
installs never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "csrc"
_OUT = _HERE / "_build"
# -fmad=false: no multiply-add contraction, so each pair term rounds as the
# plain PyTorch version's separate elementwise ops round it
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
build_log = ""  # nvcc's output (with -Xptxas -v: registers, shared memory, spills)
build_seconds = 0.0  # 0 when the library was reused


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _declare(lib):
    vp, i, fp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    lib.cell_force_newton_launch.argtypes = [vp] * 6 + [i] * 7 + [fp] * 3 + [i, vp]
    lib.cell_force_newton_launch.restype = i
    lib.overflow_force_launch.argtypes = [vp] * 6 + [i] * 3 + [fp] * 3 + [i, vp]
    lib.overflow_force_launch.restype = i
    for name in ("edm_max_k", "edm_max_g", "edm_max_o"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.edm_error_string.argtypes = [i]
    lib.edm_error_string.restype = ctypes.c_char_p
    return lib


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    global _lib, build_log, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(_SRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for p in sorted(_SRC.glob("*.cu*")):
        h.update(p.name.encode() + p.read_bytes())
    so = _OUT / f"libedm_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _OUT.mkdir(exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, sources)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
        os.replace(tmp, so)
    _lib = _declare(ctypes.CDLL(str(so)))
    return _lib
