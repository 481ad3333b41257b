"""Cell-pair force pass of the pairwise-EDM cell host: LJ + the pair-distance
CV bias through the exact cubic-Hermite table.

Two kernels, each a CUDA kernel for Hopper in ``csrc/cellforce.cu`` with a
plain PyTorch version beside it:

  - ``cell_force_newton`` (K1) replaces ``edm_tpu/ops/cellforce_pallas.py``
    ``cell_forces_pallas_newton_rescredit``: the half-stencil Newton pass
    over the slot lattice, every step;
  - ``overflow_force`` (K2) replaces ``overflow_forces_pallas``: the dense
    sweep of the compacted tail atoms (slots >= kernel_cap) against every
    placed low slot, on reduced-cap steps.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches on the
wrapper function.  The layouts drop the TPU workarounds (128-lane padding,
xyz-major planar views, the row-major table): K1 reads the slot lattice
``xs (Cg, cap, 3)`` and the occupancy mask ``mc (Cg, cap)`` directly and
gathers each cell's 13 half-stencil neighbours itself.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ..models.cells import neighbor_cells

# The 13 lexicographically positive cell offsets: every unordered
# cross-cell pair (c, c + d) appears exactly once for >= 3 cells per dim.
HALF_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
)

# cells are padded to a multiple of this (the JAX kernels' program size);
# kept so that slot states convert one to one
CELLS_PER_GROUP = 8


@dataclasses.dataclass(frozen=True)
class HermiteTable:
    """Exact cubic-Hermite pair table: per grid interval the Horner
    coefficients (a, b1, c1, d1) of the interval cubic, ``tab`` (G, 4) f32,
    so that dV/dr = b1 + c1 t + d1 t^2 and
    V = a + dx (b1 t + c1 t^2 / 2 + d1 t^3 / 3), t in [0, 1).  ``geom`` =
    (G, grid_lo, dx, grid_hi_exclusive, boundary_lo, boundary_hi) as floats
    rounded to the grid dtype, so the masks reproduce the grid lookup's
    edges."""

    tab: torch.Tensor
    geom: tuple


def hermite_pair_table(gg) -> HermiteTable:
    """Build the table from a 1-D pairwise-CV GaussGrid (non-periodic grid
    and boundary, stored derivatives): the same coefficients as
    ``edm_tpu/ops/cellforce_pallas.hermite_pair_table`` without the lane
    padding."""
    g = gg.grid
    spec = gg.spec
    if spec.dim != 1:
        raise ValueError("hermite pair table is for 1-D CV grids")
    if g.spec.periodic[0] or spec.boundary_periodic[0]:
        raise ValueError("hermite pair table requires a non-periodic grid")
    if g.derivs is None or not g.interpolate:
        raise ValueError("hermite pair table needs an interpolating grid")
    G = int(g.spec.nbins[0])
    dt = np.float32 if g.dtype == torch.float32 else np.float64
    glo = float(np.asarray(g.spec.min[0], dt))
    gdx = float(np.asarray(g.spec.dx[0], dt))
    ghi_eff = float(np.asarray(g.spec.max[0], dt) - np.asarray(g.spec.dx[0], dt))
    blo = float(np.asarray(spec.boundary_min[0], dt))
    bhi = float(np.asarray(spec.boundary_max[0], dt))
    v = g.values
    d = g.derivs[:, 0]
    safe = torch.abs(v) >= 1e-7
    qq = torch.where(safe, -d / torch.where(safe, v, 1.0), torch.zeros_like(v))
    vn = torch.cat([v[1:], v[-1:]])
    qn = torch.cat([qq[1:], qq[-1:]])
    gq0 = gdx * qq
    gq1 = gdx * qn
    ccoef = v * (gq0 + gq0 - 3.0) + vn * (gq1 + 3.0)
    dcoef = v * (2.0 - gq0) - vn * (gq1 + 2.0)
    gdx_t = torch.full((), gdx, dtype=v.dtype, device=v.device)
    tab = torch.stack([v, -qq * v, (ccoef + ccoef) / gdx_t, (dcoef * 3.0) / gdx_t], dim=1)
    return HermiteTable(tab=tab.contiguous(), geom=(G, glo, gdx, ghi_eff, blo, bhi))


# ------------------------------------------------------------ plain versions


def _pair_terms(dx, dy, dz, ok, table: HermiteTable, lj, energy: bool):
    """Per-pair force factors of _kernel_newton_rc:604-654 on broadcast
    displacement tiles: returns (f_over_r, val or None), masked pairs 0."""
    G, glo, gdx, ghi, blo, bhi = table.geom
    dtype, dev = dx.dtype, dx.device
    r2 = dx * dx + dy * dy + dz * dz
    one = torch.ones((), dtype=dtype, device=dev)
    r2s = torch.where(ok, torch.clamp(r2, min=1e-12), one)
    inv_r = torch.rsqrt(r2s)
    r = r2s * inv_r
    inv_r2 = inv_r * inv_r
    sr2 = (lj.sigma * lj.sigma) * inv_r2
    sr6 = sr2 * sr2 * sr2
    fmag_r = 4.0 * lj.epsilon * (12.0 * sr6 * sr6 - 6.0 * sr6) * inv_r2
    fmag_r = torch.where(ok & (r < lj.rcut), fmag_r, torch.zeros_like(fmag_r))
    cv_on = ok & (r >= blo) & (r <= bhi) & (r >= glo) & (r < ghi)
    gdx_t = torch.full((), gdx, dtype=dtype, device=dev)
    idxf = torch.clamp(torch.floor((r - glo) / gdx_t), 0.0, float(G - 1))
    t = (r - glo - idxf * gdx) / gdx_t
    coef = table.tab[idxf.to(torch.int64)]
    a0, b0, c0, d0 = coef.unbind(-1)
    zero = torch.zeros((), dtype=dtype, device=dev)
    der = torch.where(cv_on, b0 + t * (c0 + t * d0), zero)
    val = None
    if energy:
        val = a0 + (t * gdx) * (b0 + t * (0.5 * c0 + (1.0 / 3.0) * (t * d0)))
        val = torch.where(cv_on, val, zero)
    return fmag_r - der * inv_r, val


def _mimage(d, L: float):
    return d - torch.floor(d * (1.0 / L) + 0.5) * L


@functools.lru_cache(maxsize=8)
def half_neighbors(ncells, device) -> torch.Tensor:
    """(C, 13) flat ids of each cell's HALF_OFFSETS neighbours, on
    ``device`` (copied once per lattice and device)."""
    return torch.as_tensor(neighbor_cells(ncells, HALF_OFFSETS), device=device)


def cell_force_newton_ref(xs, mc, table: HermiteTable, *, k: int, ncells, box,
                          lj, energy: bool):
    """Plain version of K1.  xs (Cg, cap, 3) slot positions, mc (Cg, cap)
    occupancy (1.0 = atom); only slots < k take part.  Returns
    f (Cg, cap, 3) — row sums plus Newton credits, zero at slots >= k and
    padded cells — and eb (Cg, k), the per-row bias energy (self block at
    weight 0.5; zeros when ``energy`` is False)."""
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    nbr = half_neighbors(tuple(ncells), xs.device)  # (C, 13)
    xl = xs[:C, :k]
    ml = mc[:C, :k] > 0.5
    xw = torch.cat([xl, xs[nbr][:, :, :k].reshape(C, 13 * k, 3)], 1)
    mw = torch.cat([ml, (mc[nbr][:, :, :k] > 0.5).reshape(C, 13 * k)], 1)
    W = 14 * k
    d = [_mimage(xl[:, :, None, c] - xw[:, None, :, c], box[c]) for c in range(3)]
    ok = ml[:, :, None] & mw[:, None, :]
    ok = ok & ~torch.eye(k, W, dtype=torch.bool, device=xs.device)[None]
    f_over_r, val = _pair_terms(*d, ok, table, lj, energy)
    g = torch.stack([f_over_r * dc for dc in d], dim=-1)  # (C, k, W, 3)
    f = torch.zeros((Cg, cap, 3), dtype=xs.dtype, device=xs.device)
    f_own = g.sum(2)
    cred = g[:, :, k:].sum(1).reshape(C, 13, k, 3)
    for o in range(13):
        # nbr[:, o] is a permutation of the cells: no index repeats
        f_own = f_own.index_add(0, nbr[:, o], -cred[:, o])
    f[:C, :k] = f_own
    eb = torch.zeros((Cg, k), dtype=xs.dtype, device=xs.device)
    if energy:
        w = torch.ones(W, dtype=xs.dtype, device=xs.device)
        w[:k] = 0.5
        eb[:C] = (val * w).sum(2)
    return f, eb


def overflow_force_ref(xo, xp, table: HermiteTable, *, box, lj, energy: bool):
    """Plain version of K2.  xo (5, O) tail rows: x, y, z, mask, own; xp
    (4, N) partners: x, y, z, mask.  Returns fo (4, O) — force components
    and bias energy on the tail atoms — and fp (3, N), the Newton credits
    to add onto the partners.  The tail-tail block takes rows with ``own``
    set, both orders, the diagonal masked and the energy halved."""

    def block(rows_ok, cols, cols_ok, diag):
        d = [_mimage(xo[c][:, None] - cols[c][None, :], box[c]) for c in range(3)]
        ok = rows_ok[:, None] & cols_ok[None, :]
        if diag:
            ok = ok & ~torch.eye(ok.shape[0], dtype=torch.bool, device=ok.device)
        f_over_r, val = _pair_terms(*d, ok, table, lj, energy)
        return [f_over_r * dc for dc in d], val

    m = xo[3] > 0.5
    g_tt, v_tt = block(xo[4] > 0.5, xo, m, True)
    g_p, v_p = block(m, xp, xp[3] > 0.5, False)
    fo = torch.zeros((4,) + xo.shape[1:], dtype=xo.dtype, device=xo.device)
    for c in range(3):
        fo[c] = g_tt[c].sum(1) + g_p[c].sum(1)
    if energy:
        fo[3] = 0.5 * v_tt.sum(1) + v_p.sum(1)
    fp = -torch.stack([g_p[c].sum(0) for c in range(3)])
    return fo, fp


# ------------------------------------------------------------ CUDA wrappers


def _library():
    from .._build import load_library

    return load_library()


def _check(t: torch.Tensor, name: str, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _f32(vals):
    return (ctypes.c_float * len(vals))(*[float(np.float32(v)) for v in vals])


def _pair_args(table: HermiteTable, box, lj):
    G, glo, gdx, ghi, blo, bhi = table.geom
    return (
        G,
        _f32([glo, gdx, ghi, blo, bhi]),
        _f32([box[0], box[1], box[2], 1.0 / box[0], 1.0 / box[1], 1.0 / box[2]]),
        _f32([4.0 * lj.epsilon, lj.sigma * lj.sigma, lj.rcut]),
    )


def _raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.edm_error_string(code).decode()}")


def cell_force_newton(xs, mc, table: HermiteTable, *, k: int, ncells, box, lj,
                      energy: bool):
    """K1 (see ``cell_force_newton_ref`` for the contract).  On the GPU the
    Newton credits are summed deterministically: a per-offset credit
    scratch (C, 13, k, 3) written by the row pass and added to each slot
    in a fixed offset order by a second pass — no atomics."""
    if xs.device.type == "cpu":
        return cell_force_newton_ref(xs, mc, table, k=k, ncells=ncells, box=box,
                                     lj=lj, energy=energy)
    if xs.device.type != "cuda":
        raise ValueError(f"no cell-force kernel for device {xs.device}")
    lib = _library()
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    G = table.geom[0]
    _check(xs, "xs", (Cg, cap, 3), xs.device)
    _check(mc, "mc", (Cg, cap), xs.device)
    _check(table.tab, "table", (G, 4), xs.device)
    if not 0 < k <= min(cap, lib.edm_max_k()):
        raise ValueError(f"k={k} outside 1..min(cap={cap}, {lib.edm_max_k()})")
    if G > lib.edm_max_g() or Cg < C or min(ncells) < 3:
        raise ValueError(f"unsupported table rows {G} or lattice {ncells} (Cg={Cg})")
    if table.tab.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    f = torch.zeros_like(xs)
    eb = torch.zeros((Cg, k), dtype=xs.dtype, device=xs.device)
    cred = torch.empty((C, 13, k, 3), dtype=xs.dtype, device=xs.device)
    G, geom, boxa, lja = _pair_args(table, box, lj)
    code = lib.cell_force_newton_launch(
        xs.data_ptr(), mc.data_ptr(), table.tab.data_ptr(), f.data_ptr(),
        eb.data_ptr(), cred.data_ptr(), C, cap, k, *ncells, G, geom, boxa, lja,
        int(energy), torch.cuda.current_stream(xs.device).cuda_stream,
    )
    _raise_on(lib, code, "cell_force_newton")
    cell_force_newton.launches += 1
    return f, eb


cell_force_newton.launches = 0


def overflow_force(xo, xp, table: HermiteTable, *, box, lj, energy: bool):
    """K2 (see ``overflow_force_ref`` for the contract).  On the GPU each
    partner's credit is owned by one thread and the per-tile tail-row
    partial sums are reduced in a fixed order by a second pass."""
    if xo.device.type == "cpu":
        return overflow_force_ref(xo, xp, table, box=box, lj=lj, energy=energy)
    if xo.device.type != "cuda":
        raise ValueError(f"no overflow-force kernel for device {xo.device}")
    lib = _library()
    O = xo.shape[1]
    N = xp.shape[1]
    G = table.geom[0]
    _check(xo, "xo", (5, O), xo.device)
    _check(xp, "xp", (4, N), xo.device)
    _check(table.tab, "table", (G, 4), xo.device)
    if not 0 < O <= lib.edm_max_o() or G > lib.edm_max_g():
        raise ValueError(f"unsupported tail rows {O} or table rows {G}")
    if table.tab.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    fo = torch.empty((4, O), dtype=xo.dtype, device=xo.device)
    fp = torch.empty((3, N), dtype=xo.dtype, device=xo.device)
    part = torch.empty(((N + 255) // 256, 4, O), dtype=xo.dtype, device=xo.device)
    G, geom, boxa, lja = _pair_args(table, box, lj)
    code = lib.overflow_force_launch(
        xo.data_ptr(), xp.data_ptr(), table.tab.data_ptr(), fo.data_ptr(),
        fp.data_ptr(), part.data_ptr(), O, N, G, geom, boxa, lja, int(energy),
        torch.cuda.current_stream(xo.device).cuda_stream,
    )
    _raise_on(lib, code, "overflow_force")
    overflow_force.launches += 1
    return fo, fp


overflow_force.launches = 0
