"""1-D cubic-Hermite grid lookup (reference lib/grid.h:52-139) in PyTorch.

Counterpart of ``edm_tpu/ops/interp.py`` for D = 1.  Both JAX 1-D forms,
the corner gather and ``_interp1d_matvec`` (a one-hot matmul that only
exists to put the table read on the TPU's matrix unit), evaluate the same
polynomial with the same operation order; here the two corners are read
with plain indexing.  The endpoint slope comes from the stored gradient
(``qq = -der/value``, with the 1e-7 zero-table guard of grid.h:113-114).
N-D interpolation is not ported yet (ROADMAP Queue 1, item 9).
"""

from __future__ import annotations

import torch

from ..grid import device_const


def grid_value_deriv(grid, x: torch.Tensor):
    """Batched value+gradient lookup, x (..., 1) -> (value (...),
    deriv (..., 1)); zeros outside a non-periodic grid (grid.h:398-409)."""
    spec = grid.spec
    if spec.dim != 1:
        raise NotImplementedError(
            "N-D grid interpolation is not ported yet (ROADMAP Queue 1, item 9)"
        )
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
