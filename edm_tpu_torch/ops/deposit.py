"""Gaussian hill deposition (reference ``DimmedGaussGrid::add_value``,
lib/gaussian_grid.h:176-372) in PyTorch.

Counterpart of ``edm_tpu/ops/deposit.py``.  Deposition is linear in hill
height, so unit-height contributions are evaluated once per batch and
committed with a product over hills or a scatter.  The McGovern–De Pablo
boundary correction (gaussian_grid.h:299-355) is replicated exactly, with
the boundary-table index computed host-side in float64 numpy
(``_bc_point_index_np``), bit-for-bit the reference's truncation; with a
``boundary_offset`` (the spatial host's local grids against a global
boundary) it is computed on the device in the grid's dtype
(``_bc_index``), as the JAX package does.

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
  - ``dense_tables_mcgdp`` + ``deposit_from_mcgdp``: 2-D/3-D grids with
    McGovern–De Pablo corrected dims, as separable products for the terms
    that decay with the Gaussian and dense boundary-strip fields for the
    correction terms, with the near-wall hill compaction of the strip
    passes (one host read of the strip counts per deposit);
  - ``duplicate_boundary`` (static boundary, any D; with a
    ``boundary_offset``, ``_duplicate_boundary_dynamic``).
``hill_windows``, ``dense_tables_1d``, ``deposit_from_tables``,
``deposit_precomputed`` and ``duplicate_boundary`` take the
``boundary_offset`` (D,) of the spatial host (``parallel/spatial.py``):
every boundary-relative term is evaluated at ``x + boundary_offset``.
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
from ..utils import trace
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


def _bc_index(xxd: torch.Tensor, bmin: float, span: float) -> torch.Tensor:
    """McGDP table index of points ``xxd`` shifted by a boundary offset
    (gaussian_grid.h:308), on the device in their dtype: the JAX package's
    expression ``(BC_TABLE_SIZE - 1) * (xxd - bmin) / span``, each step one
    IEEE operation (a true division), truncated toward zero and clipped."""
    t = _div((BC_TABLE_SIZE - 1) * (xxd - bmin), span)
    return torch.clamp(t.to(torch.int32), 0, BC_TABLE_SIZE - 1).to(torch.int64)


@functools.lru_cache(maxsize=16)
def _bc_point_index(spec, d: int, device) -> torch.Tensor:
    """``_bc_point_index_np`` on ``device``, copied once per grid."""
    return torch.as_tensor(_bc_point_index_np(spec, d).astype(np.int64), device=device)


def _pointwise_contrib(gg: GaussGrid, xx, x, dp, dp2, valid, grid_idx, boundary_offset=None):
    """Unit-height (value, gradient) contribution of a hill centred at x to
    grid point xx: the Gaussian + McGovern–De Pablo block of
    gaussian_grid.h:299-355, sequential over dims with the running
    ``bc_denom``.  All arguments broadcast: xx/x/dp (..., D), dp2/valid
    (...); ``grid_idx`` (..., D) integer lattice indices behind xx.
    ``boundary_offset`` (D,): xx and x are shifted by it in every
    boundary-relative term (dp is shift-invariant), and the table index is
    ``_bc_index`` of the shifted point, even for a zero offset."""
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
            if boundary_offset is None:
                bc_idx = _bc_point_index(spec, d, xx.device)[grid_idx[..., d]]
            else:
                xxd = xxd + boundary_offset[d]
                xcd = xcd + boundary_offset[d]
                bc_idx = _bc_index(xxd, bmin[d], bmax[d] - bmin[d])
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


def _offset(boundary_offset, d):
    """Dim d of a boundary offset, or 0.0 without one."""
    return 0.0 if boundary_offset is None else boundary_offset[d]


def hill_windows(gg: GaussGrid, centers: torch.Tensor, boundary_offset=None) -> HillWindows:
    """Unit-height contributions of hills at ``centers`` (H, D) on their
    static support windows (gaussian_grid.h:213-295): the window of
    ``2 minisize + 1`` points per dim around the centre's point, wrapped on
    periodic dims and clipped (and masked) on the others, the per-point
    boundary mask, and the support cutoff dp^2 < GAUSS_SUPPORT.
    ``boundary_offset`` (D,): the whole-hill rejection, the per-point mask
    and the McGovern–De Pablo terms compare ``x + boundary_offset`` with the
    boundary."""
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
            xc = x[:, d] + _offset(boundary_offset, d)
            hill_ok = hill_ok & (xc >= bmin[d]) & (xc <= bmax[d])

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
            xg = xx[..., d] + _offset(boundary_offset, d)
            valid = valid & (xg >= bmin[d]) & (xg <= bmax[d])

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
    value_w, deriv_w = _pointwise_contrib(gg, xx, x[:, None, :], dp, dp2, valid, idx,
                                          boundary_offset)
    return HillWindows(idx=idx, value_w=value_w, deriv_w=deriv_w, valid=valid)


def hill_weights(gg: GaussGrid, centers: torch.Tensor) -> torch.Tensor:
    """Per-hill integrated bias per unit height, ``s_k = sum_w value_w *
    prod(dx)``: a hill of height h adds ``h * s_k`` to the grid's integral
    (the reference's integral tests, tests/edm_test.cpp:537-628)."""
    hw = hill_windows(gg, centers)
    return torch.sum(hw.value_w, dim=-1) * float(np.prod(gg.spec.grid.dx))


def deposit_precomputed(gg: GaussGrid, hw: HillWindows, heights, boundary_offset=None):
    """Scatter-add precomputed unit windows scaled by the heights; returns
    (new grid, per-hill bias_added (H,)).  CPU sums run in window order;
    the card's ``index_put_`` adds in no fixed order.  A window point
    outside the grid or the support adds an exact zero; it is sent to a
    point of its own (its place in the batch modulo the grid size) rather
    than to its clamped edge index, where a batch's masked rows (the spatial
    host's empty exchange slots, hills beyond a rank's grid) would pile
    millions of zeros onto one point and serialize the card's sorted
    accumulate.  ``boundary_offset``: see ``duplicate_boundary``."""
    dtype = gg.dtype
    heights = heights.to(dtype)
    vol = float(np.prod(gg.spec.grid.dx))
    contrib = heights[:, None] * hw.value_w  # (H, W)
    bias_added = torch.sum(contrib, dim=-1) * vol
    D = gg.spec.dim
    shape = gg.grid.values.shape
    lin = hw.idx[..., 0]
    for d in range(1, D):
        lin = lin * shape[d] + hw.idx[..., d]
    lin = lin.reshape(-1)
    spread = torch.remainder(torch.arange(lin.numel(), device=lin.device), gg.grid.values.numel())
    lin = torch.where(hw.valid.reshape(-1), lin, spread)
    values = gg.grid.values.reshape(-1).index_put((lin,), contrib.reshape(-1),
                                                  accumulate=True).reshape(shape)
    dcontrib = heights[:, None, None] * hw.deriv_w
    derivs = gg.grid.derivs.reshape(-1, D).index_put((lin,), dcontrib.reshape(-1, D),
                                                     accumulate=True).reshape(gg.grid.derivs.shape)
    out = dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs))
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out, boundary_offset)
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


def _require_full_f32(gg: GaussGrid):
    """Refuse TF32 products on the card: the JAX package runs the separable
    contractions at ``Precision.HIGHEST``."""
    if (gg.grid.values.device.type == "cuda" and gg.dtype == torch.float32
            and torch.backends.cuda.matmul.allow_tf32):
        raise RuntimeError("the separable deposit needs full float32 products (the JAX "
                           "package's Precision.HIGHEST); TF32 matmuls are enabled")


def deposit_from_tables_sep(gg: GaussGrid, tabs, heights) -> GaussGrid:
    """Commit a separable N-D deposit: per field one product over hills,
    ``sum_h (h u_0)[h, i] u_1[h, j] ...`` (the derivative along d takes
    du_d in place of u_d)."""
    D = gg.spec.dim
    _require_full_f32(gg)
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


def _hill_ok_1d(gg: GaussGrid, x, boundary_offset=None):
    """Whole-hill rejection outside a non-periodic boundary
    (gaussian_grid.h:213-216); x (H, 1) remapped centres."""
    spec = gg.spec
    ok = torch.ones(x.shape[:1], dtype=torch.bool, device=x.device)
    if not spec.boundary_periodic[0]:
        xc = x[:, 0] + _offset(boundary_offset, 0)
        ok = ok & (xc >= spec.boundary_min[0]) & (xc <= spec.boundary_max[0])
    return ok


def _dense_contrib_1d(gg: GaussGrid, x, hill_ok, i0: int, n: int, boundary_offset=None):
    """(value_w (n, H), deriv_w (n, H)) at grid points i0..i0+n-1."""
    spec = gg.spec
    g = spec.grid
    dtype = gg.dtype
    gi = torch.arange(i0, i0 + n, device=x.device)
    gxs = g.min[0] + g.dx[0] * gi.to(dtype)
    point_ok = torch.ones_like(gi, dtype=torch.bool)
    if not spec.boundary_periodic[0]:
        gxo = gxs + _offset(boundary_offset, 0)
        point_ok = point_ok & (gxo >= spec.boundary_min[0]) & (gxo <= spec.boundary_max[0])
    dpd = gxs[:, None] - x[None, :, 0]
    if g.periodic[0]:
        L = g.max[0] - g.min[0]
        dpd = dpd - ref_round(dpd / L) * L
    dp = (dpd / spec.sigma[0])[..., None]
    dp2 = dp[..., 0] * dp[..., 0]
    valid = point_ok[:, None] & hill_ok[None, :] & (dp2 < GAUSS_SUPPORT + 1e-12)
    gidx = gi[:, None, None]
    value_w, deriv_w = _pointwise_contrib(
        gg, gxs[:, None, None], x[None, :, :], dp, dp2, valid, gidx, boundary_offset
    )
    return value_w, deriv_w[..., 0]


def dense_tables_1d(gg: GaussGrid, centers: torch.Tensor, boundary_offset=None):
    """Unit-height dense tables for a 1-D grid: (Mval (G, H), Mder (G, H),
    s (H,)) such that depositing heights h is ``values += Mval @ h``,
    ``derivs[:, 0] += Mder @ h`` and ``bias_added = h * s``.
    ``boundary_offset``: see ``hill_windows``."""
    spec = gg.spec
    assert spec.dim == 1
    x = gg.remap(centers.to(gg.dtype))
    G = spec.grid.nbins[0]
    Mval, Mder = _dense_contrib_1d(gg, x, _hill_ok_1d(gg, x, boundary_offset), 0, G,
                                   boundary_offset)
    s = torch.sum(Mval, dim=0) * spec.grid.dx[0]
    return Mval, Mder, s


def deposit_from_tables(gg: GaussGrid, Mval, Mder, heights, boundary_offset=None) -> GaussGrid:
    """Commit a dense-table deposit (a product over hills; no scatter).
    ``boundary_offset``: see ``duplicate_boundary``."""
    heights = heights.to(gg.dtype)
    values = gg.grid.values + Mval @ heights
    derivs = gg.grid.derivs + (Mder @ heights)[:, None]
    out = dataclasses.replace(
        gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs)
    )
    if any(not p for p in gg.spec.boundary_periodic):
        out = duplicate_boundary(out, boundary_offset)
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


def _duplicate_boundary_dynamic(gg: GaussGrid, boundary_offset) -> GaussGrid:
    """The reference's 4^D boundary copies (gaussian_grid.h:571-630) against
    a boundary shifted by ``boundary_offset`` (D,): each dim's boundary rows
    found on the device (the reference's while-adjust unrolled twice), and
    a combination whose rows lie outside this grid switched off, so that a
    grid with no boundary in range (a mid-brick rank) keeps its values."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype
    values = gg.grid.values
    dev = values.device
    min_i, max_i = [], []
    for d in range(D):
        off_d = boundary_offset[d].to(dtype)
        blo = spec.boundary_min[d] - off_d  # the boundary in local coordinates
        bhi = spec.boundary_max[d] - off_d
        dx, gmin, nb = g.dx[d], g.min[d], g.nbins[d]
        lo = torch.floor(_div(blo - gmin, dx)).to(torch.int64)
        for _ in range(2):
            lo = torch.where(lo.to(dtype) * dx + gmin < blo, lo + 1, lo)
        hi = torch.floor(_div(bhi - gmin, dx)).to(torch.int64)
        for _ in range(2):
            hi = torch.where((hi.to(dtype) * dx + gmin > bhi) | (hi == nb), hi - 1, hi)
        min_i.append(lo)
        max_i.append(hi)

    values = values.clone()
    for combo in range(4**D):
        temp = combo
        outer, bound = [], []
        valid = torch.ones((), dtype=torch.bool, device=dev)
        for d in range(D):
            off = temp % 4
            temp //= 4
            nb = g.nbins[d]
            lo, hi = min_i[d], max_i[d]
            in_rng = (lo >= 0) & (hi <= nb - 1) & (lo <= hi)
            if off == 0:
                valid = valid & (lo >= 1) & in_rng & (not spec.boundary_periodic[d])
                o, b = lo - 1, lo
            elif off == 1:
                valid = valid & in_rng
                o, b = lo, lo
            elif off == 2:
                valid = valid & in_rng
                o, b = hi, hi
            else:
                valid = valid & (hi <= nb - 2) & in_rng & (not spec.boundary_periodic[d])
                o, b = hi + 1, hi
            outer.append(torch.clamp(o, 0, nb - 1).reshape(1))
            bound.append(torch.clamp(b, 0, nb - 1).reshape(1))
        outer, bound = tuple(outer), tuple(bound)
        values.index_put_(outer, torch.where(valid, values[bound], values[outer]))
    return dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values))


def duplicate_boundary(gg: GaussGrid, boundary_offset=None) -> GaussGrid:
    """Copy boundary values outward so the bias outside the boundary stays
    flat (zero force).  Values only; gradients there stay 0.  With a
    ``boundary_offset`` the boundary rows are found on the device
    (``_duplicate_boundary_dynamic``)."""
    if boundary_offset is not None:
        return _duplicate_boundary_dynamic(gg, boundary_offset)
    values = gg.grid.values.clone()
    for outer, bound in _duplication_assignments(gg.spec):
        values[outer] = values[bound]
    return dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values))


class McGDPTables(NamedTuple):
    """Linear-in-height deposit tables of a 2-D/3-D grid with McGovern–De
    Pablo corrected dims (``dense_tables_mcgdp``)."""

    sep_value: tuple  # per-dim (H, G_d) factors of expo / D_tot
    sep_grads: tuple  # per gradient dim: its terms, each a per-dim tuple
    strip_cache: dict  # the per-dim fields the strip passes start from
    s: torch.Tensor  # (H,) unit-height integral (what the bias limiter reads)


@functools.lru_cache(maxsize=16)
def _strip_rows_np(spec, d: int) -> np.ndarray:
    """The grid rows of dim d where a sigmoid factor of the correction can
    be nonzero (|u| < 1 from either wall: s2, s4, t6, t7 are exact zeros
    elsewhere), from a float64 copy of the grid points."""
    g = spec.grid
    gxs = g.min[d] + g.dx[d] * np.arange(g.nbins[d])
    bmin, bmax, sig = spec.boundary_min[d], spec.boundary_max[d], spec.sigma[d]
    u_lo = (gxs - bmin) / (sig * BC_MAR)
    u_hi = (bmax - gxs) / (sig * BC_MAR)
    return np.nonzero((u_lo < 1.0) | (u_hi < 1.0))[0]


@functools.lru_cache(maxsize=16)
def _strip_rows(spec, d: int, device) -> torch.Tensor:
    """``_strip_rows_np`` on ``device``, copied once per grid."""
    return torch.as_tensor(_strip_rows_np(spec, d), device=device)


def _mcgdp_base(gg: GaussGrid, centers: torch.Tensor):
    """The per-dim ingredients of the McGDP tables: (remapped centres,
    hill_okf (H,), [one dict per dim])."""
    spec = gg.spec
    g = spec.grid
    D = spec.dim
    dtype = gg.dtype
    x = gg.remap(centers.to(dtype))  # (H, D)
    dev = x.device
    H = x.shape[0]

    hill_ok = torch.ones(H, dtype=torch.bool, device=dev)
    for d in range(D):
        if not spec.boundary_periodic[d]:
            hill_ok = hill_ok & (x[:, d] >= spec.boundary_min[d]) & (x[:, d] <= spec.boundary_max[d])
    hill_okf = hill_ok.to(dtype)

    per = []
    for d in range(D):
        G = g.nbins[d]
        # the grid points in the grid's dtype on the device, as the mask pm
        # and the distances see them; the strip rows come from float64
        gxs = g.min[d] + g.dx[d] * torch.arange(G, dtype=dtype, device=dev)
        dpd = gxs[None, :] - x[:, d: d + 1]  # (H, G)
        if g.periodic[d]:
            L = g.max[d] - g.min[d]
            dpd = dpd - ref_round(_div(dpd, L)) * L
        dp = _div(dpd, spec.sigma[d])
        dp2 = dp * dp
        m = (dp2 < GAUSS_SUPPORT + 1e-12).to(dtype)
        e = torch.exp(-dp2)
        ent = dict(m=m, e=e, dp=dp, dp2=dp2)
        if spec.boundary_periodic[d]:
            ent["inv_fac"] = 1.0 / (math.sqrt(math.pi) * spec.sigma[d])
            ent["strip"] = None
        else:
            bmin, bmax = spec.boundary_min[d], spec.boundary_max[d]
            sig = spec.sigma[d]
            pm = ((gxs >= bmin) & (gxs <= bmax)).to(dtype)
            ent["m"] = m * pm[None, :]
            ent["pm"] = pm
            bc_idx = _bc_point_index(spec, d, dev)
            ent["dden"] = gg.bc_denom_deriv[d][bc_idx]  # (G,)
            ent["inv_fac"] = torch.div(torch.ones((), dtype=dtype, device=dev),
                                       gg.bc_denom[d][bc_idx])
            u_lo = _div(gxs - bmin, sig * BC_MAR)
            u_hi = _div(bmax - gxs, sig * BC_MAR)
            ent["s2"] = sigmoid(u_lo)
            ent["s4"] = sigmoid(u_hi)
            ent["t6"] = _div(sigmoid_dx(u_lo), BC_MAR * sig)
            ent["t7"] = _div(-sigmoid_dx(u_hi), BC_MAR * sig)
            ent["t1"] = torch.exp(_div(-((x[:, d] - bmin) ** 2), sig**2))  # (H,)
            ent["t3"] = torch.exp(_div(-((x[:, d] - bmax) ** 2), sig**2))
            ent["strip"] = _strip_rows(spec, d, dev)
        per.append(ent)
    return x, hill_okf, per


def dense_tables_mcgdp(gg: GaussGrid, centers: torch.Tensor) -> McGDPTables:
    """Deposit tables of a 2-D/3-D grid with McGovern–De Pablo corrected
    dims (reference gaussian_grid.h:299-343), split by how the terms of
    ``_pointwise_contrib`` decay, with its sequential quirks (only the LAST
    non-periodic dim's correction survives; each dim's force divides by
    the RUNNING denominator):

    * the terms that carry the full Gaussian are separable per-dim factors
      under a per-dim (square) support cutoff, which differs from the
      reference's spherical cutoff by at most e^-8 of a hill's peak in the
      corners (as ``dense_tables_sep``);
    * the correction terms carry sigmoid factors that are exact zeros
      outside a static strip of BC_MAR sigma' along each wall: they are
      evaluated densely on the strips with the spherical mask, in chunks
      of hills.

    Commit with ``deposit_from_mcgdp`` (linear in height, so the bias
    limiter reuses one build)."""
    spec = gg.spec
    D = spec.dim
    assert D in (2, 3)
    x, hill_okf, per = _mcgdp_base(gg, centers)
    nonper = [d for d in range(D) if not spec.boundary_periodic[d]]
    assert nonper, "use dense_tables_sep for fully periodic grids"
    dstar = nonper[-1]

    def sepf(d, *, t5=False, dden=False, facpow=1, upto=None):
        ent = per[d]
        f = ent["m"] * ent["e"]
        if d <= upto and facpow:
            f = f * ent["inv_fac"] ** facpow
        if t5:
            f = f * _div(-2.0 * ent["dp"], spec.sigma[d])
        if dden:
            f = f * (-ent["dden"])[None, :]
        return f

    def sep_term(*, upto, facpow=1, t5_dim=None, dden_dim=None):
        out = []
        for d in range(D):
            f = sepf(d, t5=(d == t5_dim), dden=(d == dden_dim), facpow=facpow, upto=upto)
            if d == 0:
                f = f * hill_okf[:, None]
            out.append(f)
        return tuple(out)

    sep_value = sep_term(upto=D - 1)
    sep_grads = []
    for gd in range(D):
        if spec.boundary_periodic[gd]:
            # t5 expo / D_tot (the reference drops the correction terms in a
            # periodic dim's gradient)
            terms = (sep_term(upto=D - 1, t5_dim=gd),)
        else:
            # t5 e / D_{<=g} and -den'_g e / D_{<=g}^2
            terms = (sep_term(upto=gd, t5_dim=gd), sep_term(upto=gd, facpow=2, dden_dim=gd))
        sep_grads.append(terms)

    # unit integral: the separable part plus the value correction's strip part
    s = torch.ones(x.shape[:1], dtype=gg.dtype, device=x.device)
    for f in sep_value:
        s = s * torch.sum(f, dim=1)
    sv = _mcgdp_strip_value(gg, per, dstar, hill_okf, heights=None)
    s = (s + sv) * float(np.prod(spec.grid.dx))
    return McGDPTables(sep_value=sep_value, sep_grads=tuple(sep_grads),
                       strip_cache=dict(per=per, dstar=dstar, hill_okf=hill_okf, x=x), s=s)


# hill-chunk budget of the dense strip transients (elements of one
# (chunk, G_others..., S) block; ~16 MB in float32)
_STRIP_CHUNK_ELEMS = 1 << 22


def _take(a: torch.Tensor, rows) -> torch.Tensor:
    """Rows of a leading-hill-axis array: a slice, or an index tensor."""
    return a[rows] if isinstance(rows, slice) else a.index_select(0, rows)


def _strip_chunk_fields(gg, per, d_strip, rows):
    """Dense spherical-mask ingredients on dim ``d_strip``'s boundary strip
    for the hills ``rows``: (valid, e), fields of shape (h, G_others...,
    S): hill, the other dims in ascending order, then the strip rows (the
    caller restores the grid's dim order)."""
    D = len(per)
    others = [d for d in range(D) if d != d_strip]
    es = per[d_strip]
    strip = es["strip"]
    dp2s = _take(es["dp2"], rows).index_select(1, strip)  # (h, S)
    if D == 2:
        dp2 = _take(per[others[0]]["dp2"], rows)[:, :, None] + dp2s[:, None, :]
    else:
        dp2 = (_take(per[others[0]]["dp2"], rows)[:, :, None, None]
               + _take(per[others[1]]["dp2"], rows)[:, None, :, None]
               + dp2s[:, None, None, :])
    valid = (dp2 < GAUSS_SUPPORT + 1e-12).to(gg.dtype)
    # the per-point boundary masks of EVERY non-periodic dim
    for i, o in enumerate(others):
        if "pm" in per[o]:
            shape = [1] * (D + 1)
            shape[1 + i] = -1
            valid = valid * per[o]["pm"].reshape(shape)
    valid = valid * es["pm"].index_select(0, strip).reshape((1,) * D + (-1,))
    return valid, torch.exp(-dp2)


def _running_inv_den(per, upto, others, d_strip, strip, power=1):
    """Per-axis factors of 1 / D_{<=upto}^power: a list aligned with
    ``others`` (numbers or (G_o,) tensors) and the strip axis' factor."""
    fac_o = [1.0] * len(others)
    fac_s = 1.0
    for k in range(upto + 1):
        iv = per[k]["inv_fac"]
        if k == d_strip:
            fac_s = (iv if isinstance(iv, float) else iv.index_select(0, strip)) ** power
        elif k in others:
            fac_o[others.index(k)] = iv ** power
    return fac_o, fac_s


def _strip_apply_fac(field, fac_o, fac_s, D):
    """Multiply the running-denominator factors onto a (h, G_others..., S)
    field, axis by axis."""
    for i, fo in enumerate(fac_o):
        if not isinstance(fo, float):
            shape = [1] * (D + 1)
            shape[1 + i] = -1
            field = field * fo.reshape(shape)
        elif fo != 1.0:
            field = field * fo
    if not isinstance(fac_s, float):
        field = field * fac_s.reshape((1,) * D + (-1,))
    elif fac_s != 1.0:
        field = field * fac_s
    return field


def _strip_hill_chunks(per, d_strip, H):
    """(chunk size, padded H) of the strip passes' loop over hills."""
    D = len(per)
    block = int(per[d_strip]["strip"].numel())
    for o in range(D):
        if o != d_strip:
            block *= int(per[o]["dp2"].shape[1])
    ch = max(1, min(H, _STRIP_CHUNK_ELEMS // max(1, block)))
    return ch, -(-H // ch) * ch


def _pad_h(a: torch.Tensor, Hp: int) -> torch.Tensor:
    """Zero-pad a leading-hill-axis tensor to Hp rows."""
    H = a.shape[0]
    if Hp == H:
        return a
    return torch.cat([a, torch.zeros((Hp - H,) + tuple(a.shape[1:]), dtype=a.dtype,
                                     device=a.device)])


def _hill_chunks(H, ch, Hp, device):
    """The rows of each hill chunk, as ``lax.scan`` over ``arange(Hp)``
    gathers them in the JAX package: past the last hill the index clamps
    to it (those rows meet zero heights, or are cut from the sums)."""
    for a in range(0, Hp, ch):
        if a + ch <= H:
            yield slice(a, a + ch)
        else:
            yield torch.clamp(torch.arange(a, a + ch, device=device), max=H - 1)


def _strip_fields_sum(field_of, per, d_strip, hill_okf, heights, dtype):
    """Sum a strip field over hills, in chunks: with ``heights`` the
    (G_others..., S) field ``sum_h heights_h field_h`` (one product per
    chunk, accumulated ``acc + chunk`` from zeros over the zero-padded
    heights, as the JAX scan); with None the per-hill integrals (H,)."""
    D = len(per)
    H = hill_okf.shape[0]
    dev = hill_okf.device
    ch, Hp = _strip_hill_chunks(per, d_strip, H)
    if Hp == H and Hp == ch:
        f = field_of(slice(None))
        if heights is None:
            return torch.sum(f, dim=tuple(range(1, D + 1)))
        return torch.tensordot(heights, f, dims=([0], [0]))
    if heights is None:
        sums = [torch.sum(field_of(rows), dim=tuple(range(1, D + 1)))
                for rows in _hill_chunks(H, ch, Hp, dev)]
        return torch.cat(sums)[:H]
    hts = _pad_h(heights, Hp)
    shape = tuple(int(per[o]["dp2"].shape[1]) for o in range(D) if o != d_strip) + (
        int(per[d_strip]["strip"].numel()),)
    acc = torch.zeros(shape, dtype=dtype, device=dev)
    for a, rows in zip(range(0, Hp, ch), _hill_chunks(H, ch, Hp, dev)):
        acc = acc + torch.tensordot(hts[a: a + ch], field_of(rows), dims=([0], [0]))
    return acc


def _mcgdp_strip_value(gg, per, dstar, hill_okf, heights):
    """The value correction on dim dstar's strip: with ``heights`` (H,) the
    (G_others..., S) field summed over hills, with None the per-hill unit
    integrals (H,)."""
    D = len(per)
    es = per[dstar]
    others = [d for d in range(D) if d != dstar]
    strip = es["strip"]
    ssh = (1,) * D + (-1,)
    s2 = es["s2"].index_select(0, strip).reshape(ssh)
    s4 = es["s4"].index_select(0, strip).reshape(ssh)
    fac_o, fac_s = _running_inv_den(per, dstar, others, dstar, strip, 1)
    hsh = (-1,) + (1,) * D

    def corr_of(rows):
        valid, e = _strip_chunk_fields(gg, per, dstar, rows)
        t1 = _take(es["t1"], rows).reshape(hsh)
        t3 = _take(es["t3"], rows).reshape(hsh)
        corr = ((t1 - e) * s2 + (t3 - e) * s4) * valid
        corr = corr * _take(hill_okf, rows).reshape(hsh)
        return _strip_apply_fac(corr, fac_o, fac_s, D)

    hts = None if heights is None else heights.to(gg.dtype)
    return _strip_fields_sum(corr_of, per, dstar, hill_okf, hts, gg.dtype)


def _mcgdp_strip_grad(gg, per, gdim, hill_okf, heights):
    """The gradient correction of McGDP dim ``gdim`` on its own strip,
    -t5 e (s2 + s4) / D_{<=g} + (t1 - e) t6 / D + (t3 - e) t7 / D
    - den'_g [(t1 - e) s2 + (t3 - e) s4] / D^2 under the spherical mask,
    summed over hills: (G_others..., S)."""
    D = len(per)
    es = per[gdim]
    others = [d for d in range(D) if d != gdim]
    strip = es["strip"]
    sig = gg.spec.sigma[gdim]
    ssh = (1,) * D + (-1,)
    s2, s4, t6, t7, dden = (es[k].index_select(0, strip).reshape(ssh)
                            for k in ("s2", "s4", "t6", "t7", "dden"))
    fac1 = _running_inv_den(per, gdim, others, gdim, strip, 1)
    fac2 = _running_inv_den(per, gdim, others, gdim, strip, 2)
    hsh = (-1,) + (1,) * D
    t5sh = (-1,) + (1,) * (D - 1) + (int(strip.numel()),)

    def field_of(rows):
        valid, e = _strip_chunk_fields(gg, per, gdim, rows)
        t1 = _take(es["t1"], rows).reshape(hsh)
        t3 = _take(es["t3"], rows).reshape(hsh)
        t5 = _div(-2.0 * _take(es["dp"], rows).index_select(1, strip), sig).reshape(t5sh)
        f1 = -t5 * e * (s2 + s4)
        f1 = f1 + (t1 - e) * t6 + (t3 - e) * t7
        f1 = _strip_apply_fac(f1, *fac1, D)
        f2 = -((t1 - e) * s2 + (t3 - e) * s4)
        f2 = _strip_apply_fac(f2 * dden, *fac2, D)
        return (f1 + f2) * valid * _take(hill_okf, rows).reshape(hsh)

    return _strip_fields_sum(field_of, per, gdim, hill_okf, heights.to(gg.dtype), gg.dtype)


# Hill-compaction capacity of the deposit's strip passes (at least
# max(this, H // 8)).  The dense (hills, G_others..., S) strip fields cost
# most of a McGDP deposit under heavy hill load, yet a hill reaches dim d's
# strip only within (BC_MAR + sqrt(GAUSS_SUPPORT)) sigma'_d of a wall (the
# spherical mask is an exact zero elsewhere), a few % of a batch.
# ``deposit_from_mcgdp`` compacts those hills to this capacity, rebuilding
# their per-dim fields from the compacted centres, and takes the dense pass
# over the whole batch when more hills reach the strip.
_STRIP_COMPACT_CAP = 256


def _strip_plan(gg, tabs, heights, dims):
    """The strip passes' hills for each dim in ``dims``: {d: (per, hill_okf,
    heights)}, the compacted near-wall hills where they fit the capacity,
    else the whole batch.  The JAX package decides each dim with a
    ``lax.cond`` on the device; here every dim's count comes to the host in
    one copy.  Returns (plan, host reads)."""
    per = tabs.strip_cache["per"]
    hill_okf = tabs.strip_cache["hill_okf"]
    full = (per, hill_okf, heights)
    H = heights.shape[0]
    cap_s = max(_STRIP_COMPACT_CAP, H // 8)
    if cap_s >= H:  # the drain's window: the whole batch, no read
        return {d: full for d in dims}, 0
    spec = gg.spec
    x = tabs.strip_cache["x"]
    dev = x.device
    i64 = dict(dtype=torch.int64, device=dev)
    cands = []
    for d in dims:
        sig = spec.sigma[d]
        reach = (BC_MAR + math.sqrt(GAUSS_SUPPORT)) * sig + float(spec.grid.dx[d])
        xd = x[:, d]
        near = ((torch.abs(xd - spec.boundary_min[d]) < reach)
                | (torch.abs(xd - spec.boundary_max[d]) < reach))
        near = near & (heights != 0)
        ranks = torch.cumsum(near.to(torch.int64), 0) - 1
        count = torch.sum(near.to(torch.int64))
        tgt = torch.where(near & (ranks < cap_s), ranks, torch.full((), cap_s, **i64))
        idx = torch.zeros(cap_s + 1, **i64).index_put_(
            (tgt,), torch.arange(H, **i64))[:cap_s]  # slot cap_s: dropped
        keep = torch.arange(cap_s, device=dev) < count
        hc = torch.where(keep, heights[idx], torch.zeros((), dtype=heights.dtype, device=dev))
        cands.append((count, x[idx], hc))
    counts = trace.read(None, "mcgdp_strips", torch.stack([c[0] for c in cands]))
    plan = {}
    for d, n, (_, xc, hc) in zip(dims, counts, cands):
        if n <= cap_s:
            _, okf_c, per_c = _mcgdp_base(gg, xc)
            plan[d] = (per_c, okf_c, hc)
        else:
            plan[d] = full
    return plan, 1


def _strip_field_compact(gg, plan, d_strip, kind):
    """(G_others..., S) strip field of dim ``d_strip`` (value or gradient)
    summed over the hills ``plan`` gives it (``_strip_plan``)."""
    per, hill_okf, heights = plan[d_strip]
    fn = _mcgdp_strip_value if kind == "value" else _mcgdp_strip_grad
    return fn(gg, per, d_strip, hill_okf, heights)


def _place_add(out: torch.Tensor, field: torch.Tensor, spec, d: int):
    """Add a (G_others..., S) strip field into ``out`` (in place) on dim d's
    strip rows.  The strip is one contiguous run of rows per wall, so the
    placement is static slice-adds, never a scatter."""
    rows = _strip_rows_np(spec, d)
    f = torch.movedim(field, -1, d)
    cut = np.nonzero(np.diff(rows) > 1)[0] + 1
    for seg in np.split(np.arange(len(rows)), cut):
        a, b = int(rows[seg[0]]), int(rows[seg[-1]]) + 1
        idx = tuple(slice(a, b) if k == d else slice(None) for k in range(out.dim()))
        out[idx].add_(f.narrow(d, int(seg[0]), len(seg)))


def deposit_from_mcgdp(gg: GaussGrid, tabs: McGDPTables, heights):
    """Commit a 2-D/3-D McGDP deposit: the separable terms as products over
    hills, the strip fields (near-wall hill compaction, ``_strip_plan``),
    then the boundary-row duplication.  Returns (new grid, host reads): the
    strip counts of all non-periodic dims come to the host in one read when
    the batch is larger than the compaction capacity, else none."""
    spec = gg.spec
    D = spec.dim
    _require_full_f32(gg)
    heights = heights.to(gg.dtype)
    dstar = tabs.strip_cache["dstar"]
    axes = "xyz"[:D]
    eq = ",".join(f"h{a}" for a in axes) + "->" + axes

    def contract(fs):
        return torch.einsum(eq, heights[:, None] * fs[0], *fs[1:])

    nonper = [d for d in range(D) if not spec.boundary_periodic[d]]
    plan, reads = _strip_plan(gg, tabs, heights, nonper)
    values = gg.grid.values + contract(tabs.sep_value)
    _place_add(values, _strip_field_compact(gg, plan, dstar, "value"), spec, dstar)
    dds = []
    for d in range(D):
        terms = tabs.sep_grads[d]
        dd = contract(terms[0])
        for fs in terms[1:]:
            dd = dd + contract(fs)
        if not spec.boundary_periodic[d]:
            _place_add(dd, _strip_field_compact(gg, plan, d, "grad"), spec, d)
        dds.append(dd)
    derivs = gg.grid.derivs + torch.stack(dds, dim=-1)
    out = dataclasses.replace(gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs))
    return duplicate_boundary(out), reads


# the JAX package's 2-D names
McGDP2DTables = McGDPTables
dense_tables_mcgdp_2d = dense_tables_mcgdp
deposit_from_mcgdp_2d = deposit_from_mcgdp


def dense_tables_2d(gg: GaussGrid, centers: torch.Tensor):
    """``dense_tables_sep`` of a 2-D grid as (ux, uy, dux, duy, s)."""
    tabs, s = dense_tables_sep(gg, centers)
    (ux, dux), (uy, duy) = tabs
    return ux, uy, dux, duy, s


def deposit_from_tables_2d(gg: GaussGrid, ux, uy, dux, duy, heights):
    return deposit_from_tables_sep(gg, [(ux, dux), (uy, duy)], heights)


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
