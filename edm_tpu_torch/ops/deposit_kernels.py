"""1-D periodic hill deposition on large grids: two CUDA kernels for Hopper
(``csrc/deposit.cu``), each with its plain PyTorch version beside it.

Counterpart of ``edm_tpu/ops/deposit_pallas.py``:

  - ``deposit_windowed_1d`` (K4) replaces ``deposit_windowed_1d_pallas``:
    each hill only on its support, the route for narrow windows
    (W + 256 < G/2), e.g. the 1e6-point grid of the deposition benchmark;
  - ``deposit_dense_1d_kernel`` (K5) replaces ``deposit_dense_1d_pallas``:
    every grid point against every hill, the route for wide windows.

Scope as in the JAX package (``supported``): 1-D, periodic grid and
boundary, float32, so the boundary-correction denominator is the scalar
sqrt(pi) sigma.  Both return ``deposit_pallas``'s contract: (new grid,
per-hill ``bias_added = heights * dx * sum of unit contributions``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches on the
wrapper function.  On the card K4's blocks own a tile of grid points and
write values and derivatives once; K5's own a tile and a chunk of 32
hills, and a second pass adds their partial planes in chunk order; a
hill's integrals over the tiles it reaches are summed in a fixed order (no
atomics, see ``csrc/deposit.cu``).  Both list a hill on the tiles its
reach meets (``hill_tiles``), every tile where the reach spans the grid
(``wide_reach``): any hill width.
The kernels take the raw centres and remap them themselves
(``remap_periodic_1d`` states their formula), so a launch costs no PyTorch
call beside its four allocations.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..gauss import GAUSS_SUPPORT, GaussGrid
from .kernel_args import check, f32, library, raise_on


def supported(gg: GaussGrid) -> bool:
    """1-D, periodic grid and boundary, float32 (deposit_pallas.py:226-233)."""
    spec = gg.spec
    return (
        spec.dim == 1
        and spec.grid.periodic[0]
        and spec.boundary_periodic[0]
        and gg.dtype == torch.float32
    )


def _consts(gg: GaussGrid):
    """(gmin, dx, L, sigma, 1/(sqrt(pi) sigma), -(2/sigma)) as Python floats,
    each computed in float64 like the Pallas kernels' parameters."""
    g = gg.spec.grid
    sigma = gg.spec.sigma[0]
    return (float(g.min[0]), float(g.dx[0]), float(g.max[0] - g.min[0]), float(sigma),
            float(1.0 / (math.sqrt(math.pi) * sigma)), float(-(2.0 / sigma)))


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
    """A 0-d divisor on the tensor's device: dividing by a Python float on
    the GPU multiplies by its reciprocal, which rounds differently."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


def _flat(gg: GaussGrid, centers, heights):
    """Centres (H,) and heights (H,) in the grid dtype, as given."""
    return centers.to(gg.dtype).reshape(-1), heights.to(gg.dtype).reshape(-1)


def _inputs(gg: GaussGrid, centers, heights):
    """Remapped centres (H,) and heights (H,) in the grid dtype."""
    x, h = _flat(gg, centers, heights)
    return gg.remap(x[:, None])[:, 0], h


def remap_periodic_1d(gg: GaussGrid, x):
    """``GaussGrid.remap`` on the grids ``supported`` admits, as the kernels
    compute it per hill: x inside [gmin, gmax] stays, any other is wrapped
    by whole periods, x - Lg floor((x - gmin) / Lg) with Lg = gmax - gmin,
    every operation in float32."""
    g = gg.spec.grid
    gmin, gmax = _scalar(g.min[0], x), _scalar(g.max[0], x)
    Lg = gmax - gmin
    return torch.where((x < gmin) | (x > gmax), x - Lg * torch.floor((x - gmin) / Lg), x)


def hill_reach(gg: GaussGrid) -> int:
    """The support radius sqrt(GAUSS_SUPPORT) sigma in whole grid points,
    plus 4 of slack over the float32 rounding of positions: K4 and K5 list a
    hill on the tiles that the points ic - reach .. ic + 1 + reach meet, ic the
    point at or below its centre."""
    return math.ceil(math.sqrt(GAUSS_SUPPORT) * gg.spec.sigma[0] / gg.spec.grid.dx[0]) + 4


def tiles_per_hill(gg: GaussGrid, tile: int) -> int:
    """The most tiles of ``tile`` points that a hill's reach can meet: the
    columns T of the kernels' (H, T) scratch of partial integrals.  2 reach + 2
    points in a row meet at most (2 reach + 1) // tile + 2 whole tiles, and
    one more across the wrap seam when the last tile is short; never more
    than the grid's tiles (every tile, where the reach spans the grid)."""
    n_blocks = -(-gg.spec.grid.nbins[0] // tile)
    return min(n_blocks, (2 * hill_reach(gg) + 1) // tile + 3)


def wide_reach(gg: GaussGrid, tile: int) -> bool:
    """Whether a hill's reach (2 reach + 2 points) and one tile of ``tile``
    points span the grid (the kernels' ``dep_wide``): then every hill is
    listed on every tile, and more than half the period may lie in its
    support, so the kernels take each point's minimum image by
    floor(d / L + 1/2), as the plain versions do."""
    return 2 * hill_reach(gg) + 2 + tile > gg.spec.grid.nbins[0]


def hill_tiles(gg: GaussGrid, x, tile: int):
    """(first tile, count) of each hill at the remapped centres x (H,), as
    the kernels derive them (``dep_hill_tiles``): tile b holds the hill's
    partial integral at column (b - first) mod blocks when that is below
    count.  Where the reach spans the grid (``wide_reach``) every hill
    takes every tile from tile 0."""
    g = gg.spec.grid
    G, reach = g.nbins[0], hill_reach(gg)
    n_blocks = -(-G // tile)
    if wide_reach(gg, tile):
        z = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
        return z, z + min(n_blocks, tiles_per_hill(gg, tile))
    ic = torch.floor((x - _scalar(g.min[0], x)) / _scalar(g.dx[0], x)).to(torch.int64) % G
    lo, hi = (ic - reach) % G, (ic + 1 + reach) % G
    first = lo // tile
    count = (hi // tile - first) % n_blocks + 1
    return first, torch.clamp(count, max=tiles_per_hill(gg, tile))


def _commit(gg: GaussGrid, values, derivs) -> GaussGrid:
    return dataclasses.replace(
        gg, grid=dataclasses.replace(gg.grid, values=values, derivs=derivs))


def _terms(gg: GaussGrid, xx, x):
    """Unit contributions e and the derivative factor -(2/sigma) p e of hills
    at x on points xx (broadcast), with the minimum image
    d - floor(d / L + 1/2) L and the support mask p^2 < GAUSS_SUPPORT."""
    _, _, L, sigma, inv_denom, k2 = _consts(gg)
    dpd = xx - x
    dpd = dpd - torch.floor(dpd / _scalar(L, dpd) + 0.5) * L
    dp = dpd / _scalar(sigma, dpd)
    dp2 = dp * dp
    e = torch.where(dp2 < GAUSS_SUPPORT + 1e-12, torch.exp(-dp2) * inv_denom,
                    torch.zeros((), dtype=dp.dtype, device=dp.device))
    return e, (k2 * dp) * e


# ------------------------------------------------------------ plain versions


def deposit_windowed_1d_ref(gg: GaussGrid, centers, heights):
    """Plain version of K4: per hill, the grid points within its support
    window (wrapped periodically), accumulated hill after hill.  A window
    wider than the grid would meet some points twice: there each point
    takes each hill once, at its minimum image, as K5's plain version
    computes it (and as the kernel does)."""
    spec = gg.spec
    g = spec.grid
    G = g.nbins[0]
    half = spec.minisize[0] + 2  # covers the support radius sqrt(8) sigma / dx
    if 2 * half + 1 > G:
        return deposit_dense_1d_kernel_ref(gg, centers, heights)
    gmin, dx = _consts(gg)[:2]
    x, h = _inputs(gg, centers, heights)
    dev = x.device
    ic = torch.floor((x - gmin) / _scalar(dx, x)).to(torch.int64)
    idx = torch.remainder(ic[:, None] + torch.arange(-half, half + 1, device=dev)[None, :], G)
    xx = gmin + dx * idx.to(x.dtype)
    e, de = _terms(gg, xx, x[:, None])
    flat = idx.reshape(-1)
    dv = torch.zeros(G, dtype=x.dtype, device=dev).index_add_(0, flat, (h[:, None] * e).reshape(-1))
    dd = torch.zeros(G, dtype=x.dtype, device=dev).index_add_(0, flat, (h[:, None] * de).reshape(-1))
    bias_added = h * (e.sum(1) * dx)
    return _commit(gg, gg.grid.values + dv, gg.grid.derivs + dd[:, None]), bias_added


def deposit_dense_1d_kernel_ref(gg: GaussGrid, centers, heights, grid_chunk: int = 65536):
    """Plain version of K5: every grid point against every hill, the sums
    over hills as products, in chunks of ``grid_chunk`` points."""
    g = gg.spec.grid
    G = g.nbins[0]
    gmin, dx = _consts(gg)[:2]
    x, h = _inputs(gg, centers, heights)
    dvs, dds = [], []
    s = torch.zeros_like(x)
    for i0 in range(0, G, grid_chunk):
        gi = torch.arange(i0, min(G, i0 + grid_chunk), device=x.device)
        e, de = _terms(gg, (gmin + dx * gi.to(x.dtype))[:, None], x[None, :])
        dvs.append(e @ h)
        dds.append(de @ h)
        s = s + e.sum(0)
    bias_added = h * (s * dx)
    return (_commit(gg, gg.grid.values + torch.cat(dvs), gg.grid.derivs + torch.cat(dds)[:, None]),
            bias_added)


# ------------------------------------------------------------ CUDA wrappers


def _launch(gg: GaussGrid, centers, heights, windowed: bool):
    if not supported(gg):
        raise ValueError("the deposition kernels take 1-D periodic float32 grids")
    lib, lim = library()
    g = gg.spec.grid
    G = g.nbins[0]
    dev = gg.grid.values.device
    x, h = _flat(gg, centers, heights)
    x, h = x.contiguous(), h.contiguous()
    H = x.shape[0]
    values, derivs = gg.grid.values, gg.grid.derivs
    check(values, "values", (G,), dev)
    check(derivs, "derivs", (G, 1), dev)
    check(x, "centers", (H,), dev)
    check(h, "heights", (H,), dev)
    if values.data_ptr() % 16 or derivs.data_ptr() % 16:
        raise ValueError("values and derivs must be 16-byte aligned")
    tile = lim["tile_windowed" if windowed else "tile_dense"]
    reach = hill_reach(gg)
    T = tiles_per_hill(gg, tile)
    out_v = torch.empty_like(values)
    out_d = torch.empty_like(derivs)
    bias_added = torch.empty_like(h)
    part = torch.empty(lib.edm_deposit_scratch(int(windowed), H, G, T), dtype=values.dtype,
                       device=dev)
    gmin, dx, L, sigma, inv_denom, k2 = _consts(gg)
    code = lib.deposit_1d_launch(
        values.data_ptr(), derivs.data_ptr(), x.data_ptr(), h.data_ptr(), out_v.data_ptr(),
        out_d.data_ptr(), bias_added.data_ptr(), part.data_ptr(), H, G,
        f32((gmin, g.max[0], dx, L, sigma, inv_denom, k2)), reach, T, int(windowed),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    raise_on(lib, code, "deposit_windowed_1d" if windowed else "deposit_dense_1d_kernel")
    return _commit(gg, out_v, out_d), bias_added


def deposit_windowed_1d(gg: GaussGrid, centers, heights):
    """K4 (see ``deposit_windowed_1d_ref``): (new grid, bias_added)."""
    dev = gg.grid.values.device
    if dev.type == "cpu":
        return deposit_windowed_1d_ref(gg, centers, heights)
    if dev.type != "cuda":
        raise ValueError(f"no deposition kernel for device {dev}")
    out = _launch(gg, centers, heights, windowed=True)
    deposit_windowed_1d.launches += 1
    return out


deposit_windowed_1d.launches = 0


def deposit_dense_1d_kernel(gg: GaussGrid, centers, heights):
    """K5 (see ``deposit_dense_1d_kernel_ref``): (new grid, bias_added)."""
    dev = gg.grid.values.device
    if dev.type == "cpu":
        return deposit_dense_1d_kernel_ref(gg, centers, heights)
    if dev.type != "cuda":
        raise ValueError(f"no deposition kernel for device {dev}")
    out = _launch(gg, centers, heights, windowed=False)
    deposit_dense_1d_kernel.launches += 1
    return out


deposit_dense_1d_kernel.launches = 0

