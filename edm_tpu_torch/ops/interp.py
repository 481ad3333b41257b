"""Cubic-Hermite grid lookup (reference lib/grid.h:52-139) in PyTorch.

Counterpart of ``edm_tpu/ops/interp.py``.  Each lookup reads the 2^D
grid points around x and sums per-dimension cubic polynomials whose
endpoint slope comes from the stored gradient (``qq = -der/value``, with
the 1e-7 zero-table guard of grid.h:113-114); a periodic neighbour wraps.

D = 1 (``_value_deriv_1d``): both JAX 1-D forms, the corner gather and
``_interp1d_matvec`` (a one-hot matmul that only exists to put the table
read on the TPU's matrix unit), evaluate the same polynomial with the same
operation order; here the two corners are read with plain indexing.

D >= 2: the JAX N-D corner loop, with the same arithmetic order (the
product of the per-dim polynomials, and for each dim's derivative the
leave-one-out product of the others).  The corners come either from one
scalar gather per corner and field, or from one row of the packed corner
table (``packed_corner_table``: per grid point the value and gradient of
all 2^D corners, (1 + D) 2^D floats), which a host that looks up many
points against a grid that changes only on hill rounds builds once per
round; the two forms give the same numbers.
"""

from __future__ import annotations

import itertools

import torch

from ..grid import device_const


def _shift_corner(arr: torch.Tensor, corner, periodic) -> torch.Tensor:
    """``arr`` shifted so element [i...] holds the value at [i + corner]:
    a periodic wrap, or the last point repeated (the reference's clamped
    +1 neighbour)."""
    for d, c in enumerate(corner):
        if not c:
            continue
        if periodic[d]:
            arr = torch.roll(arr, -1, dims=d)
        else:
            n = arr.shape[d]
            arr = torch.cat([arr.narrow(d, 1, n - 1), arr.narrow(d, n - 1, 1)], dim=d)
    return arr


def packed_corner_table(grid) -> torch.Tensor:
    """(G..., (1 + D) 2^D) table: per grid point the value and gradient of
    each of its 2^D interpolation corners, corners in
    ``itertools.product((0, 1), repeat=D)`` order (``_packed_corner_table``)."""
    per = grid.spec.periodic
    parts = []
    for corner in itertools.product((0, 1), repeat=grid.spec.dim):
        parts.append(_shift_corner(grid.values, corner, per)[..., None])
        parts.append(_shift_corner(grid.derivs, corner, per))
    return torch.cat(parts, dim=-1)


def grid_value_deriv(grid, x: torch.Tensor, packed=None):
    """Batched value+gradient lookup, x (..., D) -> (value (...), deriv
    (..., D)); zeros outside a non-periodic grid (grid.h:398-409).
    ``packed``: the grid's ``packed_corner_table``, if the caller keeps
    one (D >= 2; built here when the JAX rule would build it)."""
    if grid.spec.dim == 1:
        return _value_deriv_1d(grid, x)
    return _value_deriv_nd(grid, x, packed)


def _value_deriv_nd(grid, x: torch.Tensor, packed):
    spec = grid.spec
    D = spec.dim
    dtype = grid.dtype
    x = x.to(dtype)
    dev = x.device
    lo = device_const(spec.min, dev, dtype)
    dx = device_const(spec.dx, dev, dtype)
    nbins = device_const(spec.nbins, dev, torch.int64)
    per = device_const(spec.periodic, dev, torch.bool)

    ok = grid.in_grid(x)
    xw = grid.wrap(x)
    idx = torch.minimum(torch.clamp(torch.floor((xw - lo) / dx).to(torch.int64), min=0),
                        nbins - 1)
    zero = torch.zeros((), dtype=dtype, device=dev)

    if not grid.interpolate:
        gather = tuple(idx.unbind(-1))
        value, deriv = grid.values[gather], grid.derivs[gather]
        return torch.where(ok, value, zero), torch.where(ok[..., None], deriv, zero)

    # the JAX package's rule for building the packed table per call
    F = (1 + D) * 2 ** D
    use_packed = packed is not None or (
        grid.derivs is not None and x.numel() // D >= 4096
        and grid.values.numel() * F <= 64_000_000)
    if use_packed:
        if packed is None:
            packed = packed_corner_table(grid)
        fetched = packed[tuple(idx.unbind(-1))]  # (..., F)

    where = xw - lo - idx.to(dtype) * dx  # position above the floor point, in [0, dx)
    value = torch.zeros(x.shape[:-1], dtype=dtype, device=dev)
    deriv = torch.zeros(x.shape, dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    for ci, corner in enumerate(itertools.product((0, 1), repeat=D)):
        if use_packed:
            base = ci * (1 + D)
            tabf = fetched[..., base]
            tabder = fetched[..., base + 1: base + 1 + D]
        else:
            c = device_const(corner, dev, torch.int64)
            nidx = idx + c
            nidx = torch.where(per, torch.remainder(nidx, nbins),
                               torch.minimum(torch.clamp(nidx, min=0), nbins - 1))
            gather = tuple(nidx.unbind(-1))
            tabf = grid.values[gather]
            tabder = grid.derivs[gather]
        safe = (torch.abs(tabf) >= 1e-7)[..., None]
        qq = torch.where(safe, -tabder / torch.where(safe, tabf[..., None], one), zero)
        X = torch.abs(where / dx - device_const(corner, dev, dtype))
        X2 = X * X
        X3 = X2 * X
        sign = device_const([-1.0 if c else 1.0 for c in corner], dev, dtype)
        C = (1 - 3 * X2 + 2 * X3) - sign * qq * (X - 2 * X2 + X3) * dx
        Dp = (-6 * X + 6 * X2) - sign * qq * (1 - 4 * X + 3 * X2) * dx
        Dp = Dp * sign / dx
        value = value + tabf * torch.prod(C, dim=-1)
        # the leave-one-out product of the other dims' polynomials (for
        # D = 2 the other dim's polynomial itself)
        if D == 2:
            loo = C.flip(-1)
        else:
            loo = torch.stack([torch.prod(torch.cat([C[..., :d], C[..., d + 1:]], dim=-1), dim=-1)
                               for d in range(D)], dim=-1)
        deriv = deriv + tabf[..., None] * Dp * loo
    return torch.where(ok, value, zero), torch.where(ok[..., None], deriv, zero)


def _value_deriv_1d(grid, x: torch.Tensor):
    spec = grid.spec
    dtype = grid.dtype
    x = x.to(dtype)
    G = int(spec.nbins[0])
    lo = device_const(spec.min[0], x.device, dtype)
    dx = device_const(spec.dx[0], x.device, dtype)

    ok = grid.in_grid(x)
    xw = grid.wrap(x)[..., 0]
    idx = torch.clamp(torch.floor((xw - lo) / dx).to(torch.int64), 0, G - 1)
    zero = torch.zeros((), dtype=dtype, device=x.device)
    v = grid.values
    d = grid.derivs[..., 0]

    if not grid.interpolate:
        value, deriv = v[idx], d[idx]
        return torch.where(ok, value, zero), torch.where(ok, deriv, zero)[..., None]

    t = (xw - lo - idx.to(dtype) * dx) / dx
    value = torch.zeros_like(t)
    deriv1 = torch.zeros_like(t)
    for corner, sign in ((0, 1.0), (1, -1.0)):
        if corner:
            nidx = (idx + 1) % G if spec.periodic[0] else torch.clamp(idx + 1, max=G - 1)
        else:
            nidx = idx
        tabf = v[nidx]
        tabder = d[nidx]
        safe = torch.abs(tabf) >= 1e-7
        qq = torch.where(safe, -tabder / torch.where(safe, tabf, 1.0), zero)
        X = torch.abs(t - corner)
        X2 = X * X
        X3 = X2 * X
        C = (1 - 3 * X2 + 2 * X3) - sign * qq * (X - 2 * X2 + X3) * dx
        Dp = ((-6 * X + 6 * X2) - sign * qq * (1 - 4 * X + 3 * X2) * dx) * sign / dx
        value = value + tabf * C
        deriv1 = deriv1 + tabf * Dp
    return torch.where(ok, value, zero), torch.where(ok, deriv1, zero)[..., None]
