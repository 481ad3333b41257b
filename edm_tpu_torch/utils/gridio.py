"""Plumed-1 grid files and the LAMMPS tabular-potential writer.

Counterpart of ``edm_tpu/utils/gridio.py``; the formats are the reference's
(lib/grid.h:448-503 writer, lib/grid.h:712-835 reader; the LAMMPS table at
lib/grid.h:583-592,650-667):

* header ``#! FORCE/NVAR/TYPE/BIN/MIN/MAX/PBC`` with non-periodic dims
  *deflated* (BIN = n-1, MAX = max-dx), re-inflated on read;
* data rows dim-0 fastest, fixed 8 decimals, the derivative's sign flipped
  on write AND on read (grid.h:494,828);
* a blank line each time the fastest index resets (grid.h:498-499).

A grid's tensors come to the host in one copy per write; the text is
formatted there, by the C++ formatter of ``native/`` when it loads, else by
the Python code below, which defines the bytes both must write.
"""

from __future__ import annotations

import ctypes
import io
from typing import Tuple

import numpy as np
import torch

from .. import native
from ..grid import Grid, GridSpec
from .errors import edm_error

GRID_TYPE = 32


def _fmt_g(v: float) -> str:
    """C++ default ostream double formatting (~ %.6g)."""
    return f"{v:.6g}"


def _file_bins(spec: GridSpec):
    return [spec.nbins[d] if spec.periodic[d] else spec.nbins[d] - 1 for d in range(spec.dim)]


def _file_max(spec: GridSpec):
    return [spec.max[d] if spec.periodic[d] else spec.max[d] - spec.dx[d]
            for d in range(spec.dim)]


def _header_lines(spec: GridSpec, has_derivs: bool) -> str:
    D = spec.dim
    out = io.StringIO()
    out.write(f"#! FORCE {1 if has_derivs else 0}\n")
    out.write(f"#! NVAR {D}\n")
    out.write("#! TYPE " + "".join(f"{GRID_TYPE} " for _ in range(D)) + "\n")
    out.write("#! BIN " + "".join(f"{n} " for n in _file_bins(spec)))
    out.write("\n#! MIN " + "".join(_fmt_g(v) + " " for v in spec.min))
    out.write("\n#! MAX " + "".join(_fmt_g(v) + " " for v in _file_max(spec)))
    out.write("\n#! PBC " + "".join(f"{1 if p else 0} " for p in spec.periodic))
    out.write("\n")
    return out.getvalue()


def _host_rows(grid: Grid) -> np.ndarray:
    """(points, 1 [+ D]) float64 rows, dim 0 fastest: the values and, if the
    grid carries them, the derivatives, in one device-to-host copy."""
    D = grid.spec.dim
    planes = grid.values[..., None]
    if grid.has_derivatives:
        planes = torch.cat([planes, grid.derivs.to(grid.dtype)], -1)
    a = planes.detach().cpu().numpy().astype(np.float64)
    return np.ascontiguousarray(a.transpose(list(range(D - 1, -1, -1)) + [D])
                                .reshape(-1, a.shape[-1]))


def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def write_grid(grid: Grid, filename: str) -> None:
    """Write ``grid`` in Plumed-1 format (reference grid.h:448-503)."""
    spec = grid.spec
    D = spec.dim
    rows = _host_rows(grid)
    lib = native.load()
    if lib is not None:
        vals = np.ascontiguousarray(rows[:, 0])
        ders = (np.ascontiguousarray(rows[:, 1:]).reshape(-1) if grid.has_derivatives
                else np.zeros(1))
        rc = lib.edm_write_grid(
            filename.encode(), D,
            _p(np.asarray(_file_bins(spec), np.int64), ctypes.c_long),
            _p(np.asarray(spec.min, np.float64), ctypes.c_double),
            _p(np.asarray(_file_max(spec), np.float64), ctypes.c_double),
            _p(np.asarray([1 if p else 0 for p in spec.periodic], np.int32), ctypes.c_int),
            _p(np.asarray(spec.dx, np.float64), ctypes.c_double),
            _p(np.asarray(spec.min, np.float64), ctypes.c_double),
            rows.shape[0], _p(np.asarray(spec.nbins, np.int64), ctypes.c_long),
            _p(vals, ctypes.c_double), _p(ders, ctypes.c_double),
            1 if grid.has_derivatives else 0,
        )
        if rc != 0:
            edm_error(f"Could not write grid file {filename}", "gridio:write_grid")
        return

    idx = np.unravel_index(np.arange(rows.shape[0]), spec.nbins, order="F")
    coords = [spec.min[d] + spec.dx[d] * idx[d] for d in range(D)]
    n0 = spec.nbins[0]
    buf = io.StringIO()
    buf.write(_header_lines(spec, grid.has_derivatives))
    for i in range(rows.shape[0]):
        for d in range(D):
            buf.write(f"{coords[d][i]:.8f} ")
        buf.write(f"{rows[i, 0]:.8f} ")
        if grid.has_derivatives:
            for d in range(D):
                buf.write(f"{-rows[i, 1 + d]:.8f} ")
        buf.write("\n")
        if idx[0][i] == n0 - 1:
            buf.write("\n")
    with open(filename, "w") as f:
        f.write(buf.getvalue())


def read_grid_file(filename: str, dim: int = None, interpolate: bool = False,
                   dtype=torch.float32, device="cuda") -> Grid:
    """Read a Plumed-1 grid file (reference grid.h:712-835) into a grid on
    ``device``.  ``dim``: an optional check of the file's NVAR (the
    reference errors on a mismatch)."""
    with open(filename) as f:
        tokens = f.read().split()
    it = iter(tokens)

    def expect(tag: str):
        _, t2 = next(it), next(it)
        if t2 != tag:
            edm_error(f"Mangled grid file {filename}: no {tag} found", "gridio:read")

    expect("FORCE")
    has_derivs = int(next(it)) != 0
    expect("NVAR")
    D = int(next(it))
    if dim is not None and D != dim:
        edm_error("Dimension of this grid does not match the one found in the file",
                  "gridio:read")
    expect("TYPE")
    for _ in range(D):
        next(it)
    expect("BIN")
    nbins = [int(next(it)) for _ in range(D)]
    expect("MIN")
    mins = [float(next(it)) for _ in range(D)]
    expect("MAX")
    maxs = [float(next(it)) for _ in range(D)]
    expect("PBC")
    pbc = [int(next(it)) != 0 for _ in range(D)]

    spec = GridSpec.from_deflated(mins, maxs, nbins, pbc)
    size = spec.grid_size
    flat = np.zeros(size, dtype=np.float64)
    dflat = np.zeros((size, D), dtype=np.float64)
    lib = native.load()
    if lib is not None:
        dbuf = dflat.reshape(-1) if has_derivs else np.zeros(1)
        got = lib.edm_read_grid_data(filename.encode(), D, size, 1 if has_derivs else 0,
                                     _p(flat, ctypes.c_double), _p(dbuf, ctypes.c_double))
        if got != size:
            edm_error(f"Grid file {filename} holds {got} of its {size} points",
                      "gridio:read")
    else:
        for i in range(size):
            for _ in range(D):
                next(it)  # the coordinates
            flat[i] = float(next(it))
            if has_derivs:
                for d in range(D):
                    dflat[i, d] = -float(next(it))  # sign flip on read (grid.h:828)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    return Grid(
        values=dev(flat.reshape(spec.nbins, order="F")),
        derivs=dev(dflat.reshape(spec.nbins + (D,), order="F")) if has_derivs else None,
        spec=spec,
        interpolate=interpolate,
    )


def write_lammps_table(grid: Grid, filename: str, box_min: Tuple[float, ...],
                       box_max: Tuple[float, ...]) -> None:
    """Write a 1-D grid as a LAMMPS tabular potential (reference
    grid.h:516-517,537-538,583-592,650-667): the header, zero rows from
    r = 0 up to the grid's start (``range(1, extra_n)``: the reference
    writes no row 0), then ``index r energy force`` rows."""
    spec = grid.spec
    if spec.dim != 1:
        edm_error("Lammps format only valid for 1D grids", "gridio:write_lammps_table")
    dx = spec.dx[0]
    extra_n = int(box_min[0] / dx)
    n = int(np.ceil((box_max[0] - box_min[0]) / dx))
    n = n if spec.periodic[0] else n + 1

    xs = box_min[0] + dx * np.arange(n)
    pts = torch.as_tensor(xs[:, None], dtype=grid.dtype).to(grid.device)
    val, der = grid.get_value_deriv(pts)
    host = torch.cat([val[:, None], der], 1).cpu().numpy().astype(np.float64)
    val, der = host[:, 0], host[:, 1]

    buf = io.StringIO()
    buf.write("#Auto generated by electronic-dance-music\n\n")
    buf.write("EDM\n")
    buf.write(f"N {extra_n + n} R {_fmt_g(dx)} {_fmt_g(box_max[0])}\n\n")
    for i in range(1, extra_n):
        buf.write(f"{i} {_fmt_g(i * dx)} 0.0 0.0\n")
    for i in range(n):
        # the in_grid owner test (grid.h:865-875, applied at grid.h:616): on a
        # non-periodic dim a point at x >= max - dx (the un-inflated max) is
        # outside the grid, so the last row (x == box_max) is not written
        if not spec.periodic[0] and (xs[i] < spec.min[0] or xs[i] >= spec.max[0] - dx):
            continue
        buf.write(f"{i + extra_n} {xs[i]:.8f} {val[i]:.8f} {-der[i]:.8f} \n")
    with open(filename, "w") as f:
        f.write(buf.getvalue())
