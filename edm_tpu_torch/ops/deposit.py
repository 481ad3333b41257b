"""Gaussian hill deposition (reference ``DimmedGaussGrid::add_value``,
lib/gaussian_grid.h:176-372) in PyTorch.

Counterpart of ``edm_tpu/ops/deposit.py``.  Deposition is linear in hill
height, so unit-height contributions are evaluated once per batch and
committed with a product over hills or a scatter.  The McGovern–De Pablo
boundary correction (gaussian_grid.h:299-355) is replicated exactly, with
the boundary-table index computed host-side in float64 numpy
(``_bc_point_index_np``), bit-for-bit the reference's truncation.

Ported:
  - ``dense_tables_1d`` + ``deposit_from_tables`` (small 1-D grids) and
    ``deposit_dense_1d``;
  - ``hill_windows`` + ``deposit_precomputed``: each hill on its static
    support window, any D, with the McGovern–De Pablo terms, committed by
    a scatter-add.  On the card ``index_put_(accumulate=True)`` adds in no
    fixed order, so its sums are pinned to a tolerance, not bitwise
    (integer-valued sums, such as histogram counts, stay exact);
  - ``dense_tables_sep`` + ``deposit_from_tables_sep``: fully periodic
    2-D/3-D grids as per-dim tables and one product over hills per field,
    in full float32 on the card (TF32 is refused, as the JAX package runs
    the einsum at ``Precision.HIGHEST``);
  - the ``deposit`` dispatcher, with its routes to the large-grid 1-D
    kernels of ``ops/deposit_kernels`` (K4, K5) and the windowed scatter
    for everything else;
  - ``duplicate_boundary`` (static boundary, any D).
Not ported yet: the McGovern–De Pablo separable tables
(``dense_tables_mcgdp``, ``deposit_from_mcgdp``; ROADMAP Queue 1, item 3)
and the sharded ``boundary_offset`` forms (item 7).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from ..gauss import (
    BC_MAR,
    BC_TABLE_SIZE,
    GAUSS_SUPPORT,
    GaussGrid,
    ref_round,
    sigmoid,
    sigmoid_dx,
)
from ..grid import device_const
from . import deposit_kernels


class HillWindows(NamedTuple):
    idx: torch.Tensor  # (H, W, D) int64 wrapped/clipped grid indices
    value_w: torch.Tensor  # (H, W) unit-height value contribution
    deriv_w: torch.Tensor  # (H, W, D) unit-height gradient contribution
    valid: torch.Tensor  # (H, W) bool


def _div(a: torch.Tensor, v: float) -> torch.Tensor:
    """``a / v`` as a true division on any device (a Python divisor makes
    the card multiply by its reciprocal)."""
    return a / device_const(v, a.device, a.dtype)


def _bc_point_index_np(spec, d: int) -> np.ndarray:
    """Per-grid-point McGDP table index along dim d, host-side float64
    numpy: the reference's xx = min + dx*i (gaussian_grid.h:269) and
    bc_index = (int)((BC_TABLE_SIZE-1)*(xx-bmin)/span) (:308), bit-for-bit,
    including its double rounding at lattice-aligned quotients."""
    g = spec.grid
    G = int(g.nbins[d])
    xx = np.float64(g.min[d]) + np.float64(g.dx[d]) * np.arange(G, dtype=np.float64)
    bmin = np.float64(spec.boundary_min[d])
    span = np.float64(spec.boundary_max[d]) - bmin
    t = (BC_TABLE_SIZE - 1) * (xx - bmin) / span
    return np.clip(t.astype(np.int32), 0, BC_TABLE_SIZE - 1)


@functools.lru_cache(maxsize=16)
def _bc_point_index(spec, d: int, device) -> torch.Tensor:
    """``_bc_point_index_np`` on ``device``, copied once per grid."""
    return torch.as_tensor(_bc_point_index_np(spec, d).astype(np.int64), device=device)


def _pointwise_contrib(gg: GaussGrid, xx, x, dp, dp2, valid, grid_idx):
    """Unit-height (value, gradient) contribution of a hill centred at x to
    grid point xx: the Gaussian + McGovern–De Pablo block of
    gaussian_grid.h:299-355, sequential over dims with the running
    ``bc_denom``.  All arguments broadcast: xx/x/dp (..., D), dp2/valid
    (...); ``grid_idx`` (..., D) integer lattice indices behind xx."""
    spec = gg.spec
    D = spec.dim
    bmin = spec.boundary_min
    bmax = spec.boundary_max
    sigma = spec.sigma

    expo = torch.exp(-dp2)
    bc_denom = torch.ones_like(expo)
    bc_correction = torch.zeros_like(expo)
    bc_force = [None] * D
    for d in range(D):
        if not spec.boundary_periodic[d]:
            xxd = xx[..., d]
            xcd = x[..., d]
            sig = sigma[d]
            bc_idx = _bc_point_index(spec, d, xx.device)[grid_idx[..., d]]
            temp1 = torch.exp(-((xcd - bmin[d]) ** 2) / sig**2)
            temp2 = sigmoid((xxd - bmin[d]) / (sig * BC_MAR))
            temp3 = torch.exp(-((xcd - bmax[d]) ** 2) / sig**2)
            temp4 = sigmoid((bmax[d] - xxd) / (sig * BC_MAR))
            bc_correction = (temp1 - expo) * temp2 + (temp3 - expo) * temp4
            bc_denom = bc_denom * gg.bc_denom[d][bc_idx]

            temp5 = -2 * dp[..., d] / sig
            temp6 = sigmoid_dx((xxd - bmin[d]) / (sig * BC_MAR)) / (BC_MAR * sig)
            temp7 = -sigmoid_dx((bmax[d] - xxd) / (sig * BC_MAR)) / (BC_MAR * sig)
            f = temp5 * expo
            f = f + (temp1 - expo) * temp6 - temp5 * expo * temp2 + (temp3 - expo) * temp7 - temp5 * expo * temp4
            f = f * bc_denom - gg.bc_denom_deriv[d][bc_idx] * (expo + bc_correction)
            f = f / (bc_denom * bc_denom)
            bc_correction = bc_correction / bc_denom
            bc_force[d] = f
        else:
            bc_denom = bc_denom * (math.sqrt(math.pi) * sigma[d])

    expo_f = expo / bc_denom
    zero = torch.zeros((), dtype=expo.dtype, device=expo.device)
    value_w = torch.where(valid, expo_f + bc_correction, zero)
    deriv_dims = []
    for d in range(D):
        if spec.boundary_periodic[d]:
            dd = -(2 * dp[..., d] / sigma[d] * expo_f)
        else:
            dd = bc_force[d]
        deriv_dims.append(torch.where(valid, dd, zero))
    return value_w, torch.stack(deriv_dims, dim=-1)


def hill_windows(gg: GaussGrid, centers: torch.Tensor) -> HillWindows:
    """Unit-height contributions of hills at ``centers`` (H, D) on their
    static support windows (gaussian_grid.h:213-295): the window of
    ``2 minisize + 1`` points per dim around the centre's point, wrapped on
    periodic dims and clipped (and masked) on the others, the per-point
    boundary mask, and the support cutoff dp^2 < GAUSS_SUPPORT."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype
    x = gg.remap(centers.to(dtype))  # (H, D)
    dev = x.device
    gmin = device_const(g.min, dev, dtype)
    gdx = device_const(g.dx, dev, dtype)
    bmin, bmax = spec.boundary_min, spec.boundary_max

    # whole-hill rejection outside a non-periodic boundary (gaussian_grid.h:213-216)
    hill_ok = torch.ones(x.shape[:1], dtype=torch.bool, device=dev)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            hill_ok = hill_ok & (x[:, d] >= bmin[d]) & (x[:, d] <= bmax[d])

    # centre index, possibly negative (gaussian_grid.h:222-224), and the window
    x_index = torch.floor((x - gmin) / gdx).to(torch.int64)
    offs = np.stack(np.meshgrid(*[np.arange(-m, m + 1) for m in spec.minisize], indexing="ij"),
                    axis=-1).reshape(-1, D)
    idx_raw = x_index[:, None, :] + torch.as_tensor(offs, device=dev)[None]  # (H, W, D)
    valid = hill_ok[:, None].expand(idx_raw.shape[:2])
    idx_dims = []
    for d in range(D):
        r = idx_raw[..., d]
        n = g.nbins[d]
        if g.periodic[d]:
            r = torch.remainder(r, n)  # periodic wrap (gaussian_grid.h:251-266)
        else:
            valid = valid & (r >= 0) & (r < n)
            r = torch.clamp(r, 0, n - 1)
        idx_dims.append(r)
    idx = torch.stack(idx_dims, dim=-1)
    xx = gmin + gdx * idx.to(dtype)  # (H, W, D)

    # per-point boundary mask (gaussian_grid.h:272-276)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            valid = valid & (xx[..., d] >= bmin[d]) & (xx[..., d] <= bmax[d])

    # sigma-scaled distances with the periodic minimum image (gaussian_grid.h:285-295)
    dp_dims = []
    for d in range(D):
        dpd = xx[..., d] - x[:, None, d]
        if g.periodic[d]:
            L = g.max[d] - g.min[d]
            dpd = dpd - ref_round(_div(dpd, L)) * L
        dp_dims.append(_div(dpd, spec.sigma[d]))
    dp = torch.stack(dp_dims, dim=-1)
    dp2 = torch.sum(dp * dp, dim=-1)
    # inclusive epsilon on the support cutoff, as the JAX package
    valid = valid & (dp2 < GAUSS_SUPPORT + 1e-12)
    value_w, deriv_w = _pointwise_contrib(gg, xx, x[:, None, :], dp, dp2, valid, idx)
    return HillWindows(idx=idx, value_w=value_w, deriv_w=deriv_w, valid=valid)


def deposit_precomputed(gg: GaussGrid, hw: HillWindows, heights):
    """Scatter-add precomputed unit windows scaled by the heights; returns
    (new grid, per-hill bias_added (H,)).  CPU sums run in window order;
    the card's ``index_put_`` adds in no fixed order."""
    dtype = gg.dtype
    heights = heights.to(dtype)
    vol = float(np.prod(gg.spec.grid.dx))
    contrib = heights[:, None] * hw.value_w  # (H, W)
    bias_added = torch.sum(contrib, dim=-1) * vol
    D = gg.spec.dim
    gather = tuple(i.reshape(-1) for i in hw.idx.unbind(-1))
    values = gg.grid.values.index_put(gather, contrib.reshape(-1), accumulate=True)
    dcontrib = heights[:, None, None] * hw.deriv_w
    derivs = gg.grid.derivs.index_put(gather, dcontrib.reshape(-1, D), accumulate=True)
    out = dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs))
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out)
    return out, bias_added


def dense_tables_sep(gg: GaussGrid, centers: torch.Tensor):
    """Separable per-dim unit tables of a fully periodic N-D grid: a hill is
    ``prod_d u_d(x_d)``.  Returns ([(u_d (H, G_d), du_d (H, G_d)) per dim],
    s (H,)).  The support cutoff is per dim (|dp_d|^2 < GAUSS_SUPPORT, the
    JAX package's documented divergence from the reference's spherical
    cutoff), and s is the matching separable integral, so a deposit of
    heights h adds exactly h s to the grid's integral."""
    spec = gg.spec
    g = spec.grid
    if not (all(g.periodic) and all(spec.boundary_periodic)):
        raise ValueError("dense_tables_sep takes fully periodic grids and boundaries")
    dtype = gg.dtype
    x = gg.remap(centers.to(dtype))  # (H, D)
    tabs = []
    for d in range(spec.dim):
        gxs = g.min[d] + g.dx[d] * torch.arange(g.nbins[d], dtype=dtype, device=x.device)
        dpd = gxs[None, :] - x[:, d: d + 1]  # (H, G_d)
        L = g.max[d] - g.min[d]
        dpd = dpd - ref_round(_div(dpd, L)) * L
        dp = _div(dpd, spec.sigma[d])
        dp2 = dp * dp
        ok = dp2 < GAUSS_SUPPORT + 1e-12
        # per-dim normalization 1 / (sqrt(pi) sigma')
        norm = 1.0 / (math.sqrt(math.pi) * spec.sigma[d])
        u = torch.where(ok, torch.exp(-dp2) * norm, torch.zeros((), dtype=dtype, device=x.device))
        du = u * _div(-2.0 * dp, spec.sigma[d])
        tabs.append((u, du))
    s = torch.full((), float(np.prod(g.dx)), dtype=dtype, device=x.device)
    for u, _ in tabs:
        s = s * torch.sum(u, dim=1)
    return tabs, s


def deposit_from_tables_sep(gg: GaussGrid, tabs, heights) -> GaussGrid:
    """Commit a separable N-D deposit: per field one product over hills,
    ``sum_h (h u_0)[h, i] u_1[h, j] ...`` (the derivative along d takes
    du_d in place of u_d)."""
    D = gg.spec.dim
    dev = gg.grid.values.device
    if (dev.type == "cuda" and gg.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the separable deposit needs full float32 products (the JAX "
                           "package's Precision.HIGHEST); TF32 matmuls are enabled")
    heights = heights.to(gg.dtype)
    axes = "xyz"[:D]
    eq = ",".join(f"h{a}" for a in axes) + "->" + axes

    def contract(which):
        ops = []
        for k, (u, du) in enumerate(tabs):
            t = du if k == which else u
            ops.append(heights[:, None] * t if k == 0 else t)
        return torch.einsum(eq, *ops)

    values = gg.grid.values + contract(-1)
    derivs = gg.grid.derivs + torch.stack([contract(d) for d in range(D)], dim=-1)
    return dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs))


def _hill_ok_1d(gg: GaussGrid, x):
    """Whole-hill rejection outside a non-periodic boundary
    (gaussian_grid.h:213-216); x (H, 1) remapped centres."""
    spec = gg.spec
    ok = torch.ones(x.shape[:1], dtype=torch.bool, device=x.device)
    if not spec.boundary_periodic[0]:
        ok = ok & (x[:, 0] >= spec.boundary_min[0]) & (x[:, 0] <= spec.boundary_max[0])
    return ok


def _dense_contrib_1d(gg: GaussGrid, x, hill_ok, i0: int, n: int):
    """(value_w (n, H), deriv_w (n, H)) at grid points i0..i0+n-1."""
    spec = gg.spec
    g = spec.grid
    dtype = gg.dtype
    gi = torch.arange(i0, i0 + n, device=x.device)
    gxs = g.min[0] + g.dx[0] * gi.to(dtype)
    point_ok = torch.ones_like(gi, dtype=torch.bool)
    if not spec.boundary_periodic[0]:
        point_ok = point_ok & (gxs >= spec.boundary_min[0]) & (gxs <= spec.boundary_max[0])
    dpd = gxs[:, None] - x[None, :, 0]
    if g.periodic[0]:
        L = g.max[0] - g.min[0]
        dpd = dpd - ref_round(dpd / L) * L
    dp = (dpd / spec.sigma[0])[..., None]
    dp2 = dp[..., 0] * dp[..., 0]
    valid = point_ok[:, None] & hill_ok[None, :] & (dp2 < GAUSS_SUPPORT + 1e-12)
    gidx = gi[:, None, None]
    value_w, deriv_w = _pointwise_contrib(
        gg, gxs[:, None, None], x[None, :, :], dp, dp2, valid, gidx
    )
    return value_w, deriv_w[..., 0]


def dense_tables_1d(gg: GaussGrid, centers: torch.Tensor):
    """Unit-height dense tables for a 1-D grid: (Mval (G, H), Mder (G, H),
    s (H,)) such that depositing heights h is ``values += Mval @ h``,
    ``derivs[:, 0] += Mder @ h`` and ``bias_added = h * s``."""
    spec = gg.spec
    assert spec.dim == 1
    x = gg.remap(centers.to(gg.dtype))
    G = spec.grid.nbins[0]
    Mval, Mder = _dense_contrib_1d(gg, x, _hill_ok_1d(gg, x), 0, G)
    s = torch.sum(Mval, dim=0) * spec.grid.dx[0]
    return Mval, Mder, s


def deposit_from_tables(gg: GaussGrid, Mval, Mder, heights) -> GaussGrid:
    """Commit a dense-table deposit (a product over hills; no scatter)."""
    heights = heights.to(gg.dtype)
    values = gg.grid.values + Mval @ heights
    derivs = gg.grid.derivs + (Mder @ heights)[:, None]
    out = dataclasses.replace(
        gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs)
    )
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out)
    return out


def _duplication_assignments(spec):
    """Static (outer, bound) single-point copies for zero-force boundary
    rows (reference duplicate_boundary, gaussian_grid.h:571-630)."""
    g = spec.grid
    D = spec.dim
    min_i, max_i = [], []
    for d in range(D):
        for which, b in (("lo", spec.boundary_min[d]), ("hi", spec.boundary_max[d])):
            xi = b
            if g.periodic[d]:
                L = g.max[d] - g.min[d]
                xi -= L * math.floor((xi - g.min[d]) / L)
            i = int(math.floor((xi - g.min[d]) / g.dx[d]))
            if which == "lo":
                lo = i
            else:
                hi = i
        while lo * g.dx[d] + g.min[d] < spec.boundary_min[d]:
            lo += 1
        while hi * g.dx[d] + g.min[d] > spec.boundary_max[d] or hi == g.nbins[d]:
            hi -= 1
        min_i.append(lo)
        max_i.append(hi)

    assignments = []
    for combo in range(4**D):
        temp = combo
        outer, bound = [], []
        skip = False
        for d in range(D):
            off = temp % 4
            temp //= 4
            if off == 0:
                if spec.boundary_periodic[d] or min_i[d] == 0:
                    skip = True
                outer.append(min_i[d] - 1)
                bound.append(min_i[d])
            elif off == 1:
                outer.append(min_i[d])
                bound.append(min_i[d])
            elif off == 2:
                outer.append(max_i[d])
                bound.append(max_i[d])
            else:
                if spec.boundary_periodic[d] or max_i[d] == g.nbins[d] - 1:
                    skip = True
                outer.append(max_i[d] + 1)
                bound.append(max_i[d])
        if not skip:
            assignments.append((tuple(outer), tuple(bound)))
    return assignments


def duplicate_boundary(gg: GaussGrid) -> GaussGrid:
    """Copy boundary values outward so the bias outside the boundary stays
    flat (zero force).  Values only; gradients there stay 0."""
    values = gg.grid.values.clone()
    for outer, bound in _duplication_assignments(gg.spec):
        values[outer] = values[bound]
    return dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values))


def deposit_dense_1d(gg: GaussGrid, centers, heights, grid_chunk: int = 131072):
    """Scatter-free 1-D deposition: every hill at every grid point, reduced
    over hills with a product, in chunks of ``grid_chunk`` points.
    Returns (new grid, per-hill bias_added (H,))."""
    spec = gg.spec
    g = spec.grid
    assert spec.dim == 1
    dtype = gg.dtype
    heights = heights.to(dtype)
    x = gg.remap(centers.to(dtype))
    hill_ok = _hill_ok_1d(gg, x)
    G = g.nbins[0]
    dvs, dds = [], []
    s = torch.zeros(x.shape[:1], dtype=dtype, device=x.device)
    for i0 in range(0, G, grid_chunk):
        value_w, deriv_w = _dense_contrib_1d(gg, x, hill_ok, i0, min(grid_chunk, G - i0))
        dvs.append(value_w @ heights)
        dds.append(deriv_w @ heights)
        s = s + torch.sum(value_w, dim=0)
    s = s * g.dx[0]
    out = dataclasses.replace(gg, grid=dataclasses.replace(
        gg.grid,
        values=gg.grid.values + torch.cat(dvs),
        derivs=gg.grid.derivs + torch.cat(dds)[:, None],
    ))
    if not spec.boundary_periodic[0]:
        out = duplicate_boundary(out)
    return out, heights * s


def deposit(gg: GaussGrid, centers, heights):
    """Deposit hills; returns (new grid, per-hill bias_added (H,)).

    Routing as in the JAX package (edm_tpu/ops/deposit.py:1141-1177): a
    1-D grid whose window fits the domain (G <= 512 W, and W < G when
    periodic) goes to K4 (``deposit_windowed_1d``, narrow windows:
    W + 256 < G // 2) or K5 (``deposit_dense_1d_kernel``) when it has
    16384+ points and ``deposit_kernels.supported`` takes it (periodic,
    float32), else to ``deposit_dense_1d``; every other grid goes to the
    windowed scatter (``hill_windows`` + ``deposit_precomputed``).  The
    JAX package takes the kernel routes on a TPU only; here the wrappers
    decide by the tensors' device (the plain versions on the CPU)."""
    spec = gg.spec
    if spec.dim == 1:
        W = spec.window_shape[0]
        G = spec.grid.nbins[0]
        if G <= 512 * W and (not spec.grid.periodic[0] or W < G):
            if G >= 16384 and deposit_kernels.supported(gg):
                if W + 256 < G // 2:
                    return deposit_kernels.deposit_windowed_1d(gg, centers, heights)
                return deposit_kernels.deposit_dense_1d_kernel(gg, centers, heights)
            return deposit_dense_1d(gg, centers, heights)
    return deposit_precomputed(gg, hill_windows(gg, centers), heights)
