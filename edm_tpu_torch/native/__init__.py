"""Host-side text formatters in C++, bound with ctypes.

  gridio.cpp   — Plumed-1 grid rows (``utils/gridio.write_grid`` and the
                 data rows of ``read_grid_file``)
  hillslog.cpp — the HILLS event stream of one hill round
                 (``utils/hills_log.HillsLog``)

These are not device kernels: they format text on the host, where a
1e6-point grid or a round of thousands of hills is slow in Python.  The
Python paths define the formats and the tests hold the two byte for byte.
Each library is built at first use with ``g++ -O2 -shared -fPIC`` into
``_build/`` beside the package (git-ignored), under a name keyed on a hash
of its source, so a stale build is never loaded.  ``load`` and
``load_hillslog`` return None when the toolchain is missing or the build
fails (``errors`` then says why), and the callers take the Python path.
Nothing builds at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

_HERE = pathlib.Path(__file__).resolve().parent
_BUILD = _HERE.parent / "_build"
_FLAGS = ["-O2", "-shared", "-fPIC"]
_LOCK = threading.Lock()
_LIBS: dict = {}  # stem -> loaded library or None, once tried
errors: dict = {}  # stem -> why the library is not loaded


def _build(stem: str) -> pathlib.Path:
    src = _HERE / f"{stem}.cpp"
    digest = hashlib.sha256(src.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    so = _BUILD / f"_{stem}-{digest}.so"
    if so.exists():
        return so
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(src)], check=True,
                   capture_output=True, text=True, timeout=120)
    os.replace(tmp, so)  # atomic: two processes building at once both succeed
    return so


def _load(stem: str, declare):
    with _LOCK:
        if stem in _LIBS:
            return _LIBS[stem]
        try:
            lib = ctypes.CDLL(str(_build(stem)))
            declare(lib)
        except (OSError, subprocess.SubprocessError) as e:
            errors[stem] = f"{type(e).__name__}: {getattr(e, 'stderr', None) or e}"
            lib = None
        _LIBS[stem] = lib
        return lib


def _declare_gridio(lib):
    c_long, c_int, c_double = ctypes.c_long, ctypes.c_int, ctypes.c_double
    lp, ip, dp = (ctypes.POINTER(t) for t in (c_long, c_int, c_double))
    lib.edm_write_grid.restype = c_int
    lib.edm_write_grid.argtypes = [ctypes.c_char_p, c_int, lp, dp, dp, ip, dp, dp, c_long,
                                   lp, dp, dp, c_int]
    lib.edm_read_grid_data.restype = c_long
    lib.edm_read_grid_data.argtypes = [ctypes.c_char_p, c_int, c_long, c_int, dp, dp]


def _declare_hillslog(lib):
    dp = ctypes.POINTER(ctypes.c_double)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.edm_format_round.restype = ctypes.c_long
    lib.edm_format_round.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.c_long, ctypes.c_int, ctypes.c_double,
        ctypes.c_long, dp, dp, dp, dp, u8, u8,
        ctypes.c_long, dp, dp, dp, dp, u8, u8, u8,
    ]


def load():
    """The grid-file library, or None (see ``errors["gridio"]``)."""
    return _load("gridio", _declare_gridio)


def load_hillslog():
    """The HILLS formatter library, or None (see ``errors["hillslog"]``)."""
    return _load("hillslog", _declare_hillslog)
