"""Build and load the port's CUDA kernels.

``load_library()`` compiles ``csrc/*.cu`` (the cell-force kernels, the
deposition kernels, the Threefry draws and the counter hash with the hill
collections' pass 1) with ``nvcc`` for ``sm_90a``, one process per source
run at once, and links them into one shared library with a plain C
interface, under ``_build/`` next to this file (git-ignored); it loads
the library with ctypes.  The library's name carries a
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
    "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lib = None
# the compiled limits, read once at load: the Hermite table's rows (max_g,
# the JAX kernels' own limit), K2's tile of partners and tail rows
# (k2_tile) and the deposition tile per route (tile_dense, tile_windowed)
limits = {}
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


_LIMITS = ("edm_max_g", "edm_k2_tile")


def _declare(lib):
    vp, i, fp = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_float)
    # both force launches end in: look, t1, t2, rows, degp, geom, box, lj, energy, stream
    table = [i, vp, vp, i, i] + [fp] * 3 + [i, vp]
    # the row pass's plan: small, piece words, row tile, table in shared memory
    plan = [i] * 4
    # xs, mc, mcand, f, eb, cred, C, Cg, cap, k, nx, ny, nz, credits, row box
    # (ox, oy, oz, rx, ry, rz), n_rows, ts (or None), tpair, plan, table up to
    # energy, the cull's counts (or None), stream
    lib.cell_force_newton_launch.argtypes = ([vp] * 6 + [i] * 15 + [vp, fp] + plan + table[:-1]
                                             + [vp, vp])
    lib.cell_force_newton_launch.restype = i
    # xs, mc, f, eb, cred, C, Cg, cap, nx, ny, nz, plan, look, t1, t2, rows,
    # degp, geom, box, lj, the cull's counts (or None), stream
    lib.cell_force_full_launch.argtypes = ([vp] * 5 + [i] * 6 + plan + [i, vp, vp, i, i]
                                           + [fp] * 3 + [vp, vp])
    lib.cell_force_full_launch.restype = i
    # xo, xp, fo, fp, part, fpart, O, N, table in shared memory, table
    lib.overflow_force_launch.argtypes = [vp] * 6 + [i] * 3 + table
    lib.overflow_force_launch.restype = i
    # values, derivs, centers, heights, new values, new derivs, bias_added,
    # scratch, H, G, geom, reach, T, windowed, stream
    lib.deposit_1d_launch.argtypes = [vp] * 8 + [i, i, fp, i, i, i, vp]
    lib.deposit_1d_launch.restype = i
    u32, f64, i64 = ctypes.c_uint32, ctypes.c_double, ctypes.c_longlong
    # k0, k1, n, kind, f64, lo, span, sqrt(2), blocks, vec, out, stream
    lib.threefry_bits_launch.argtypes = [u32, u32, i64, i, i, f64, f64, f64, i64, i, vp, vp]
    lib.threefry_bits_launch.restype = i
    # k0, k1, rows, ids64, R, n, f64, gx, gy, tx, tr, out, stream
    lib.threefry_rows_launch.argtypes = [u32, u32, vp, i, i64, i, i, u32, u32, i, i, vp, vp]
    lib.threefry_rows_launch.restype = i
    # s0, s1, rows, R, n, normal, f64, out, stream
    lib.hash_rows_launch.argtypes = [u32, u32, vp, i64, i, i, i, vp, vp]
    lib.hash_rows_launch.restype = i
    # xs, mc, cells, nbr, box, bmax2, thresh, s0, s1, B, cap, f64,
    # row_counts, ncalls, stream
    lib.p1_count_half_launch.argtypes = [vp] * 5 + [f64, vp, u32, u32, i, i, i, vp, vp, vp]
    lib.p1_count_half_launch.restype = i
    # xs, aid, ts, nbr, box, bmax2, thresh, t0, t1, n_atoms, s0, s1, C, cap,
    # f64, row_counts, ncalls, stream
    lib.p1_count_typed_launch.argtypes = [vp] * 5 + [f64, vp, f64, f64, i64, u32, u32, i, i, i,
                                                      vp, vp, vp]
    lib.p1_count_typed_launch.restype = i
    for name in _LIMITS:
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i
    lib.edm_deposit_tile.argtypes = [i]
    lib.edm_deposit_tile.restype = i
    lib.edm_deposit_scratch.argtypes = [i, i, i, i]
    lib.edm_deposit_scratch.restype = ctypes.c_longlong
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
        tag = f"{os.getpid()}.tmp"
        nvcc = _nvcc()
        t0 = time.perf_counter()
        # one nvcc per source, all at once, then one link
        objs = [_OUT / f"{src.stem}.{tag}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *_FLAGS, "-c", "-o", str(o), str(src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, o in zip(sources, objs)]
        logs = [pr.communicate()[0] for pr in procs]
        build_log = "".join(logs)
        failed = [src.name for src, pr in zip(sources, procs) if pr.returncode != 0]
        if not failed:
            tmp = so.with_suffix(f".{tag}")
            res = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                                 capture_output=True, text=True)
            build_log += res.stdout + res.stderr
            if res.returncode != 0:
                failed = ["link"]
        for o in objs:
            o.unlink(missing_ok=True)
        build_seconds = time.perf_counter() - t0
        if failed:
            raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{build_log}")
        os.replace(tmp, so)
    lib = _declare(ctypes.CDLL(str(so)))
    limits.update({n[4:]: getattr(lib, n)() for n in _LIMITS},
                  tile_dense=lib.edm_deposit_tile(0), tile_windowed=lib.edm_deposit_tile(1))
    _lib = lib
    return _lib
