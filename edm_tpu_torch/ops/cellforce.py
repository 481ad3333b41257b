"""Cell-pair force pass of the pairwise-EDM cell host: LJ + the pair-distance
CV bias through the exact cubic-Hermite table or its Chebyshev form.

Four kernels, each a CUDA kernel for Hopper in ``csrc/cellforce.cu`` with
a plain PyTorch version beside it:

  - ``cell_force_newton`` (K1) replaces ``edm_tpu/ops/cellforce_pallas.py``
    ``cell_forces_pallas_newton_rescredit``: the half-stencil Newton pass
    over the slot lattice, every step of the default path; with a
    ``row_box``, its owned-row form (rows over a slab rank's owned sub-box
    of its halo window, the force planes over the window, the neighbour
    cells masked by ``mc_cand``), every step of the slab host;
  - ``overflow_force`` (K2) replaces ``overflow_forces_pallas``: the dense
    sweep of the compacted tail atoms (slots >= kernel_cap) against every
    placed low slot, on reduced-cap steps;
  - ``cell_force_newton_planar`` (K6) replaces
    ``cell_forces_pallas_newton_planar``: K1's row pass alone, returning
    the Newton credits for the caller to apply (``use_pallas="newton"``);
  - ``cell_force_full`` (K7) replaces ``cell_forces_pallas``: the legacy
    27-stencil ordered-pair pass with slot-id self masks, Chebyshev only
    (``use_pallas="full"``).  Its plain version walks the 27-stencil; its
    kernel evaluates each unordered pair once over the half-stencil.

K1, K6 and K7 share one CUDA row pass (a block per row cell, the occupied
candidates compacted, a warp per occupied row over the partners within
reach of the cutoffs), in two forms that ``row_plan`` picks between: up to
k = 64 (``SMALL_K``) ``k1_rows`` takes a cell's whole row at once; past it,
or with a Chebyshev table too large for shared memory, ``k1_rows_pieces``
takes the candidates in pieces of ballot words and the rows in tiles, so
any k and any table fit a block's shared memory, and culls each row's
distance sweep: a piece's candidates are sorted by cell and sub-cell bin
(``cull_bins``) and cut into chunks of ``CHUNK``, and a row tests r^2 only
against the chunks whose bounding box it reaches (``piece_chunks``,
``chunk_box`` and ``box_reaches`` state it plainly); with tracing on it
counts the tests (``CULL_COUNTERS``).  K1's credit pass
(``k1_credits``) runs over the force planes, K7's (``k7_credits``) adds the
value too.  K2 (``k2_plan``) tiles the tail rows by 128.  Together they
write every element of their outputs, so the wrappers allocate with
``torch.empty``.  The one shape limit left is the Hermite table's 1,024
rows, which the JAX kernels share.

K1, K2 and K6 take either bias table: a ``HermiteTable``
(``pair_lookup="interp"``) or a ``ChebTable`` (``pair_lookup="chebyshev"``),
whose per-pair Clenshaw chains replace ``cellforce_pallas._cheb_val_der``
(K3); the kernels are instantiated once per lookup.  K1 and K6 take an
optional slot type plane ``ts`` and ``type_pair`` (ti, tj): the rdf
type-pair CV of ``cellforce_pallas._cv_type_mask``, which keeps the bias
term only for unordered {ti, tj} pairs and never touches LJ.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches on the
wrapper function.  The layouts drop the TPU workarounds (128-lane padding,
xyz-major planar views, the row-major table): K1 reads the slot lattice
``xs (Cg, cap, 3)`` and the occupancy mask ``mc (Cg, cap)`` directly and
gathers each cell's 13 half-stencil neighbours itself.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.cells import neighbor_cells
from ..utils import trace
from .chebyshev import ChebTable
from .kernel_args import check, f32, library, raise_on

# The 13 lexicographically positive cell offsets: every unordered
# cross-cell pair (c, c + d) appears exactly once for >= 3 cells per dim.
HALF_OFFSETS = tuple(
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
)

# The 27 stencil offsets in CellSpec.stencil() order (the JAX host's roll
# order); the cell itself is offset 13.
STENCIL_OFFSETS = tuple(
    (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
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


def _hermite_terms(r, ok, table: HermiteTable, energy: bool):
    """(der, val or None) of ``_hermite_val_der``, 0 off the table."""
    G, glo, gdx, ghi, blo, bhi = table.geom
    dtype, dev = r.dtype, r.device
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
    return der, val


def cheb_geom(table: ChebTable, dtype) -> tuple:
    """(lo, hi, lo + hi, hi - lo, panel width) as the kernels use them: each
    computed in float64 and rounded once to ``dtype``, as the Pallas
    kernel's Python-float constants are."""
    dt = np.float32 if dtype == torch.float32 else np.float64
    lo, hi = table.lo, table.hi
    return tuple(float(dt(v)) for v in (lo, hi, lo + hi, hi - lo, (hi - lo) / table.npanels))


def _cheb_terms(r, ok, table: ChebTable, energy: bool):
    """(der, val or None) of ``_cheb_val_der`` (cellforce_pallas.py:67-105):
    the mask is lo <= r <= hi; for P > 1 the panel index is clamped to
    [0, P-1] and the local coordinate t is not clipped."""
    dtype, dev = r.dtype, r.device
    lo, hi, csum, cwid, pw = cheb_geom(table, dtype)
    P, deg = table.npanels, table.deg
    cv_on = ok & (r >= lo) & (r <= hi)
    rc = torch.clamp(r, lo, hi)
    if P == 1:
        t = (2.0 * rc - csum) / torch.full((), cwid, dtype=dtype, device=dev)

        def coef(c, k):
            return c[0, k]
    else:
        pw_t = torch.full((), pw, dtype=dtype, device=dev)
        pf = torch.clamp(torch.floor((rc - lo) / pw_t), 0.0, float(P - 1))
        t = (2.0 * (rc - lo - pf * pw) - pw) / pw_t
        pi = pf.to(torch.int64)

        def coef(c, k):
            return c[:, k][pi]
    t2 = 2.0 * t
    zero = torch.zeros_like(t)
    b1 = b2 = d1 = d2 = zero
    for k in range(deg, 0, -1):
        if energy:
            b1, b2 = coef(table.cval, k) + t2 * b1 - b2, b1
        d1, d2 = coef(table.cder, k) + t2 * d1 - d2, d1
    z = torch.zeros((), dtype=dtype, device=dev)
    der = torch.where(cv_on, coef(table.cder, 0) + t * d1 - d2, z)
    val = torch.where(cv_on, coef(table.cval, 0) + t * b1 - b2, z) if energy else None
    return der, val


def _pair_terms(dx, dy, dz, ok, table, lj, energy: bool, ok_cv=None):
    """Per-pair force factors of _kernel_newton_rc:604-654 on broadcast
    displacement tiles: returns (f_over_r, val or None), masked pairs 0.
    ``ok_cv`` (default ``ok``) masks the bias term alone: the typed CV."""
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
    ok_cv = ok if ok_cv is None else ok_cv
    if isinstance(table, ChebTable):
        der, val = _cheb_terms(r, ok_cv, table, energy)
    else:
        der, val = _hermite_terms(r, ok_cv, table, energy)
    return fmag_r - der * inv_r, val


def _mimage(d, L: float):
    return d - torch.floor(d * (1.0 / L) + 0.5) * L


@functools.lru_cache(maxsize=8)
def half_neighbors(ncells, device) -> torch.Tensor:
    """(C, 13) flat ids of each cell's HALF_OFFSETS neighbours, on
    ``device`` (copied once per lattice and device)."""
    return torch.as_tensor(neighbor_cells(ncells, HALF_OFFSETS), device=device)


@functools.lru_cache(maxsize=8)
def credit_sources(ncells, device) -> torch.Tensor:
    """(C, 13): for each cell c and offset o, the cell whose HALF_OFFSETS[o]
    neighbour is c (the JAX host's lattice roll by +offset)."""
    return torch.as_tensor(neighbor_cells(ncells, [tuple(-d for d in o) for o in HALF_OFFSETS]),
                           device=device)


@functools.lru_cache(maxsize=8)
def stencil_neighbors(ncells, device) -> torch.Tensor:
    """(C, 27) flat ids of each cell's STENCIL_OFFSETS neighbours."""
    return torch.as_tensor(neighbor_cells(ncells, STENCIL_OFFSETS), device=device)


def stencil_planes(plane, ncells):
    """(Cg, cap) per-slot plane -> (C, 27cap): each cell's candidates in
    STENCIL_OFFSETS order (the JAX host's 27 lattice rolls, as a gather)."""
    C = int(np.prod(ncells))
    return plane[stencil_neighbors(tuple(ncells), plane.device)].reshape(C, -1)


def subtract_credits(f_own, cred, ncells):
    """f_own (C, k, 3) minus the 13 incoming Newton credits, one offset after
    another in HALF_OFFSETS order: cred[c, o] (C, 13, k, 3) belongs to cell
    c + HALF_OFFSETS[o] (``newton_lattice_force``'s rolls, as a gather)."""
    src = credit_sources(tuple(ncells), f_own.device)
    inc = cred[src, torch.arange(13, device=f_own.device)]  # (C, 13, k, 3)
    for o in range(13):
        f_own = f_own - inc[:, o]
    return f_own


def type_pair_mask(t_rows, t_cols, type_pair):
    """Broadcast mask of the rdf type-pair CV (``_cv_type_mask``): the
    unordered pair {ti, tj}, types compared as floats."""
    ti, tj = (float(t) for t in type_pair)
    return ((t_rows == ti) & (t_cols == tj)) | ((t_rows == tj) & (t_cols == ti))


def _newton_rows(xs, mc, table, *, k, ncells, box, lj, energy, ts, type_pair, mc_cand=None,
                 rows=None):
    """The row pass of K1 and K6 (plain): each occupied slot < k against
    its own cell's other slots and the 13 half-stencil neighbours' slots.
    ``rows`` (R,): the window cells that are rows (default every cell, R =
    C); ``mc`` masks the rows and the self block, (R, cap) when ``rows`` is
    given, and ``mc_cand`` (default ``mc``) the neighbours' candidates.
    Returns the row sums f (R, k, 3), self block included; the credits
    cred (R, 13, k, 3), each offset's column sums (+); and eb (R, k), the
    row's bias energy with the self block at weight 0.5."""
    C = int(np.prod(ncells))
    mc_cand = mc if mc_cand is None else mc_cand
    nbr = half_neighbors(tuple(ncells), xs.device)  # (C, 13)
    if rows is None:
        rows, mc = slice(0, C), mc[:C]
    nbr = nbr[rows]
    C = nbr.shape[0]  # the row cells
    xl = xs[rows, :k]
    ml = mc[:, :k] > 0.5
    xw = torch.cat([xl, xs[nbr][:, :, :k].reshape(C, 13 * k, 3)], 1)
    mw = torch.cat([ml, (mc_cand[nbr][:, :, :k] > 0.5).reshape(C, 13 * k)], 1)
    W = 14 * k
    d = [_mimage(xl[:, :, None, c] - xw[:, None, :, c], box[c]) for c in range(3)]
    ok = ml[:, :, None] & mw[:, None, :]
    ok = ok & ~torch.eye(k, W, dtype=torch.bool, device=xs.device)[None]
    ok_cv = None
    if ts is not None:
        tl = ts[rows, :k]
        tw = torch.cat([tl, ts[nbr][:, :, :k].reshape(C, 13 * k)], 1)
        ok_cv = ok & type_pair_mask(tl[:, :, None], tw[:, None, :], type_pair)
    f_over_r, val = _pair_terms(*d, ok, table, lj, energy, ok_cv)
    g = torch.stack([f_over_r * dc for dc in d], dim=-1)  # (C, k, W, 3)
    cred = g[:, :, k:].sum(1).reshape(C, 13, k, 3)
    eb = torch.zeros((C, k), dtype=xs.dtype, device=xs.device)
    if energy:
        w = torch.ones(W, dtype=xs.dtype, device=xs.device)
        w[:k] = 0.5
        eb = (val * w).sum(2)
    return g.sum(2), cred, eb


def box_cells(ncells, row_box, device) -> torch.Tensor:
    """(R,) window cell ids of the row box ((ox, oy, oz), (rx, ry, rz)),
    x-major: the row ids of K1's owned-row pass (``_kernel_newton_rc``'s
    remap, cellforce_pallas.py:577-595, wrapped per axis of the window)."""
    (ox, oy, oz), (rx, ry, rz) = row_box
    nx, ny, nz = ncells
    ix = (ox + torch.arange(rx, device=device)) % nx
    iy = (oy + torch.arange(ry, device=device)) % ny
    iz = (oz + torch.arange(rz, device=device)) % nz
    return ((ix[:, None, None] * ny + iy[None, :, None]) * nz + iz[None, None, :]).reshape(-1)


def _row_box(xs, mc_rows, mc_cand, ncells, row_box):
    """K1's rows, checked: ``row_box`` (default the whole lattice) lies
    inside the window; the row mask has exactly R = rx * ry * rz rows (no
    program padding), or Cg for the whole lattice; an owned-row box needs
    the candidates' mask.  Returns the box as ((ox, oy, oz), (rx, ry, rz))."""
    Cg, cap, _ = xs.shape
    if row_box is None:
        if tuple(mc_rows.shape) != (Cg, cap):
            raise ValueError(f"the row mask has shape {tuple(mc_rows.shape)}: expected "
                             f"({Cg}, {cap}) without a row_box")
        return (0, 0, 0), tuple(int(n) for n in ncells)
    origin, rdims = (tuple(int(v) for v in t) for t in row_box)
    if any(o < 0 or r < 1 or o + r > n for o, r, n in zip(origin, rdims, ncells)):
        raise ValueError(f"row_box {row_box} does not lie inside the window {tuple(ncells)}")
    R = int(np.prod(rdims))
    if tuple(mc_rows.shape) != (R, cap):
        raise ValueError(f"the row mask has shape {tuple(mc_rows.shape)}, the row box "
                         f"{row_box} has {R} rows: expected ({R}, {cap})")
    if mc_cand is None:
        raise ValueError("a row_box needs mc_cand, the (Cg, cap) candidates' mask")
    return origin, rdims


def cell_force_newton_ref(xs, mc_rows, table, *, k: int, ncells, box, lj, energy: bool,
                          ts=None, type_pair=None, mc_cand=None, row_box=None):
    """Plain version of K1.  xs (Cg, cap, 3) slot positions, ``mc_rows``
    (Cg, cap) the occupancy of the rows (1.0 = atom), which also masks each
    cell's self block, ``mc_cand`` (default ``mc_rows``) that of the 13
    neighbour cells' candidates (a sharded host's halo cells are candidates,
    not rows); only slots < k take part; ``table`` a HermiteTable or a
    ChebTable; ``ts`` (Cg, cap) slot types (0 = empty) with ``type_pair``
    for the typed CV.  Returns f (Cg, cap, 3) — row sums plus Newton
    credits, zero at slots >= k and padded cells — and eb (Cg, k), the
    per-row bias energy (self block at weight 0.5; zeros when ``energy`` is
    False).

    ``row_box=((ox, oy, oz), (rx, ry, rz))``: the owned-row form — rows over
    that sub-box of the (nx, ny, nz) window only (``box_cells`` order);
    ``mc_rows`` is then (R, cap) for its R = rx * ry * rz cells, eb (R, k),
    and ``mc_cand`` is required: a cell of the box gets its row sums and
    credits, another cell only the credits of the box's rows.  Either way
    each cell's credits are subtracted offset by offset in HALF_OFFSETS
    order, so the owned-row form is bitwise the whole lattice's with the
    rows outside the box masked out."""
    Cg, cap, _ = xs.shape
    rbox = _row_box(xs, mc_rows, mc_cand, ncells, row_box)
    rows = box_cells(tuple(ncells), rbox, xs.device)
    R = rows.shape[0]
    f_own, cred, eb_r = _newton_rows(xs, mc_rows[:R], table, k=k, ncells=ncells, box=box, lj=lj,
                                     energy=energy, ts=ts, type_pair=type_pair,
                                     mc_cand=mc_rows if mc_cand is None else mc_cand, rows=rows)
    f = torch.zeros_like(xs)
    f[rows, :k] = f_own
    tgt = half_neighbors(tuple(ncells), xs.device)[rows]  # (R, 13)
    for o in range(13):  # a translation: each offset's targets are distinct
        f[tgt[:, o], :k] = f[tgt[:, o], :k] - cred[:, o]
    eb = eb_r.new_zeros((mc_rows.shape[0], k))
    eb[:R] = eb_r
    return f, eb


def cell_force_newton_planar_ref(xs, mc, table, *, ncells, box, lj, energy: bool,
                                 ts=None, type_pair=None):
    """Plain version of K6: K1's row pass at full cap, credits not applied.
    Returns f (Cg, cap, 3), the row sums with the self block; cred
    (Cg, 13, cap, 3), the column sums (+) that cell c + HALF_OFFSETS[o]
    must subtract (``subtract_credits``); eb (Cg, cap), self block at
    weight 0.5 (zeros when ``energy`` is False).  Padded cells are zeros."""
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    f_own, cred_c, eb_c = _newton_rows(xs, mc, table, k=cap, ncells=ncells, box=box, lj=lj,
                                       energy=energy, ts=ts, type_pair=type_pair)
    f = torch.zeros_like(xs)
    f[:C] = f_own
    cred = torch.zeros((Cg, 13, cap, 3), dtype=xs.dtype, device=xs.device)
    cred[:C] = cred_c
    eb = torch.zeros((Cg, cap), dtype=xs.dtype, device=xs.device)
    eb[:C] = eb_c
    return f, cred, eb


def cell_force_full_ref(xs, mc, sid, table: ChebTable, *, ncells, box, lj):
    """Plain version of K7.  xs (Cg, cap, 3), mc (Cg, cap), sid (Cg, cap)
    slot ids as floats (the slot's atom id); each occupied slot against
    every occupied slot of the 27 stencil cells (STENCIL_OFFSETS order)
    whose id differs, with the Chebyshev lookup and the energy.  Returns
    f (Cg, cap, 3), the row sums, and eb (Cg, cap), each row's bias energy
    over ordered pairs (the caller takes 0.5 * sum(eb))."""
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    xl = xs[:C]
    ml = mc[:C] > 0.5
    xw = stencil_planes(xs, ncells).reshape(C, 27 * cap, 3)
    mw = stencil_planes(mc, ncells) > 0.5  # the JAX state's mn
    nid = torch.where(mw, stencil_planes(sid, ncells), -1.0)  # and its nid
    d = [_mimage(xl[:, :, None, c] - xw[:, None, :, c], box[c]) for c in range(3)]
    ok = ml[:, :, None] & mw[:, None, :] & ((sid[:C, :, None] - nid[:, None, :]).abs() >= 0.5)
    f_over_r, val = _pair_terms(*d, ok, table, lj, True)
    f = torch.zeros_like(xs)
    f[:C] = torch.stack([(f_over_r * dc).sum(2) for dc in d], dim=-1)
    eb = torch.zeros((Cg, cap), dtype=xs.dtype, device=xs.device)
    eb[:C] = val.sum(2)
    return f, eb


def overflow_force_ref(xo, xp, table, *, box, lj, energy: bool):
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


# ------------------------------------------------------------ launch plans

# csrc/cellforce.cu's constants: the row pass's warps a block, the k its
# small form (k1_rows) takes, a block's shared memory on the H100 (227 KB),
# the largest lookup table kept in shared memory (a larger one is read from
# global memory), the pieces form's shared-memory budget (three blocks an
# SM), its most rows a tile, its most ballot words a piece, its candidates a
# cull box (chunk) and its most sub-cell bins a cell, and K2's partners and
# tail rows a tile
ROW_WARPS = 8
SMALL_K = 64
SMEM_MAX = 232448
TABLE_SMEM_MAX = 48 * 1024
PIECE_BUDGET = 72 * 1024
ROW_TILE = 256
PIECE_WORDS = 3 * ROW_WARPS
CHUNK = 8
NKEY = 8
K2_TILE = 128
HERMITE, CHEB = 0, 1  # the lookup ids
# the pieces form's counts of its cull, when tracing is on: the r^2 tests a
# sweep over every occupied candidate would run (rows x candidates), the
# tests run, and the unordered pairs found within r2_far
CULL_COUNTERS = ("k1.unculled", "k1.tested", "k1.in_reach")


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def table_bytes(look: int, rows: int, degp: int) -> int:
    """The lookup table's bytes in shared memory: Hermite rows x float4, or
    the Chebyshev value and derivative series (P x degp floats each)."""
    return 16 * (rows if look == HERMITE else _ceil(2 * rows * degp, 4))


def cell_words(k: int) -> int:
    """Ballot words (32 slots each) of a cell's k candidate slots."""
    return _ceil(k, 32)


class RowPlan(NamedTuple):
    """The row pass's launch (K1, K6, K7): the small form (``k1_rows``, the
    whole row in one piece) or the pieces form (``k1_rows_pieces``)."""

    small: bool
    piece_words: int  # ballot words (32 candidates each) a piece; 0: small
    row_tile: int  # rows a tile; 0: small
    table_smem: bool  # the table in shared memory, else read from global memory
    smem: int  # dynamic shared memory, bytes


def _small_bytes(k, nc, typed, tb) -> int:
    W = 14 * k
    pitch = 32 if k <= 32 else 64
    n4 = (W + _ceil(ROW_WARPS * nc * 13 * k, 4) + (_ceil(W, 4) if typed else 0)
          + (14 * SMALL_K // 32) // 4 + 14 * pitch // 8 + ROW_WARPS * _ceil(W, 8))
    return tb + 16 * n4


def max_chunks(pww: int) -> int:
    """The most chunks a piece of ``pww`` ballot words holds: its 32 pww
    candidates in chunks of CHUNK, and one part-filled chunk more for each
    of its cells (at most pww, at most 14)."""
    return 32 * pww // CHUNK + min(pww, 14)


def _piece_bytes(k, nc, typed, tb, pww, rt, tsm) -> int:
    PW, MC = 32 * pww, max_chunks(pww)
    n4 = (2 * rt + (_ceil(rt, 4) if typed else 0) + _ceil(cell_words(k), 4) + PW
          + (PW // 4 if typed else 0) + ROW_WARPS * nc * PW // 4 + PW // 8 + ROW_WARPS * PW // 8
          + _ceil(NKEY * pww + 2, 4) + 2 * MC + _ceil(ROW_WARPS * MC, 4) + ROW_WARPS * 3 * 8 // 16)
    return (tb if tsm else 0) + 16 * n4


@functools.lru_cache(maxsize=256)
def row_plan(k: int, nc: int, typed: bool, look: int, rows: int, degp: int) -> RowPlan:
    """The row pass's plan for k rows and candidates a cell, ``nc`` credit
    components (3; K7: 4), typed or not, and the table (``look`` HERMITE or
    CHEB, its rows or panels, degp = degree + 1): the small form when k <=
    SMALL_K and the table fits TABLE_SMEM_MAX; else the pieces form, a row
    tile of up to ROW_TILE rows and the most ballot words a piece (at most
    PIECE_WORDS) that keep its shared memory within PIECE_BUDGET, with the
    table in shared memory if it fits beside one word (a Hermite table
    always does), else read from global memory."""
    tb = table_bytes(look, rows, degp)
    tsm = tb <= TABLE_SMEM_MAX
    if k <= SMALL_K and tsm:
        return RowPlan(True, 0, 0, True, _small_bytes(k, nc, typed, tb))
    rt = min(k, ROW_TILE)
    # a Hermite table (at most 16 KB) stays in shared memory
    for t in ((True, False) if tsm and look == CHEB else (tsm,)):
        for pww in range(min(14 * cell_words(k), PIECE_WORDS), 0, -1):
            b = _piece_bytes(k, nc, typed, tb, pww, rt, t)
            if b <= PIECE_BUDGET:
                return RowPlan(False, pww, rt, t, b)
    t = look == HERMITE
    return RowPlan(False, 1, rt, t, _piece_bytes(k, nc, typed, tb, 1, rt, t))


def piece_candidates(k: int, plan: RowPlan) -> list:
    """The candidates each piece of a row-pass plan takes, as the kernel maps
    its ballot words: a list, piece by piece, of (cell offset o, slot)
    arrays (o = 0 the cell itself, then HALF_OFFSETS order; slots >= k are
    no candidates).  The small form is one piece."""
    wpc = cell_words(k)
    step = 14 * wpc if plan.small else plan.piece_words
    out = []
    for w0 in range(0, 14 * wpc, step):
        w = np.repeat(np.arange(w0, min(w0 + step, 14 * wpc)), 32)
        o, sl = w // wpc, 32 * (w % wpc) + np.tile(np.arange(32), len(w) // 32)
        out.append(np.stack([o, sl], 1)[sl < k])
    return out


def cull_bins(k: int, edge, reach: float) -> tuple:
    """The pieces form's sub-cell bins along each axis
    (``csrc/cellforce.cu:bin_split``): before a piece's candidates are cut
    into chunks, each cell's are sorted by bin, so that a chunk covers a
    part of its cell.  2 bins (the two sides of the cell's centre) along an
    axis where a cell fills more than one chunk (k > CHUNK) and its edge
    along the axis is at least half the reach (the distance of a pair that
    can contribute); else 1.  ``edge``: the lattice's box over its cells per
    axis, as the launch knows it."""
    return tuple(2 if k > CHUNK and 2.0 * e >= reach else 1 for e in edge)


def bin_keys(xs, k: int, box, ncells, r2_far: float) -> np.ndarray:
    """Each slot's sub-cell bin (0 .. NKEY - 1) as the kernel keys it
    (``bin_key``), on the slot lattice ``xs`` (C, cap, 3): on each axis that
    ``cull_bins`` splits, the side of its cell's centre, (i + 1/2) L / n,
    the position lies on by the minimum image (an atom that drifted out of
    its cell keeps the side it left by); x the high bit.  (C, cap)."""
    xs = np.asarray(xs, np.float32)
    C = int(np.prod(ncells))
    L = np.asarray(box, np.float32)
    edge = L / np.asarray(ncells, np.float32)
    bins = cull_bins(k, edge, np.sqrt(np.float32(r2_far)))
    coords = np.stack(np.unravel_index(np.arange(C), tuple(ncells)), 1)
    key = np.zeros(xs.shape[:2], np.int64)
    for d in range(3):
        centre = (coords[:, d].astype(np.float32) + np.float32(0.5)) * edge[d]
        e = xs[:C, :, d] - centre[:, None]
        e = e - np.rint(e * np.float32(1.0 / box[d])) * L[d]
        key[:C] = 2 * key[:C] + ((e > 0) & (bins[d] == 2))
    return key


def piece_chunks(k: int, plan: RowPlan, occ, keys) -> list:
    """The pieces form's counting sort and chunks (``k1_rows_pieces``),
    plainly.  For each piece of ``piece_candidates(k, plan)``: its occupied
    candidates (``occ`` (14, k) bool, cell offset o by slot) in the
    kernel's order — by cell, then by sub-cell bin (``keys`` (14, k)), then
    by slot — as indices into the piece's candidate list, and its chunks,
    each cell's part of that order cut into (start, stop) ranges of at most
    CHUNK.  A list of (order, chunks) a piece."""
    occ, keys = np.asarray(occ, bool), np.asarray(keys)
    out = []
    for cand in piece_candidates(k, plan):
        o, sl = cand[:, 0], cand[:, 1]
        live = np.flatnonzero(occ[o, sl])
        order = live[np.lexsort((sl[live], keys[o[live], sl[live]], o[live]))]
        _, first = np.unique(o[order], return_index=True)
        ends = list(first[1:]) + [len(order)]
        chunks = [(s, min(s + CHUNK, b)) for a, b in zip(first, ends) for s in range(a, b, CHUNK)]
        out.append((order, chunks))
    return out


def _mimage32(d, L: float):
    """pair_r2's minimum image of float32 ``d`` along an axis of box length
    ``L``, op for op (no contraction; the reciprocal rounded once, as the
    launch rounds it)."""
    return d - np.floor(d * np.float32(1.0 / L) + np.float32(0.5)) * np.float32(L)


def chunk_box(x, box) -> tuple:
    """A chunk's box as the kernel takes it from its members ``x`` (m, 3)
    float32: each member's minimum image from the first, their range, the
    centre and the half-widths widened by 2^-12 of the box and the centre's
    magnitude.  Returns (centre (3,), half (3,))."""
    x = np.asarray(x, np.float32)
    d = np.stack([_mimage32(x[:, c] - x[0, c], box[c]) for c in range(3)], 1)
    lo, hi = np.minimum(d.min(0), 0), np.maximum(d.max(0), 0)
    half = np.float32(0.5)
    centre = x[0] + half * (lo + hi)
    slack = (np.float32(box) + np.abs(centre)) * np.float32(1.0 / 4096.0)
    return centre.astype(np.float32), (half * (hi - lo) + slack).astype(np.float32)


def box_reaches(a, centre, half, box, r2_far: float) -> np.ndarray:
    """Whether rows ``a`` (..., 3) reach a chunk's box: the squared
    distance from each row to the box by the minimum image, against r2_far
    (the kernel's test, ``cull_dist``, in float64).  A chunk that fails
    holds no candidate within r2_far of the row."""
    a = np.asarray(a, np.float64)
    g2 = 0.0
    for c in range(3):
        d = a[..., c] - np.float64(centre[c])
        d = np.abs(d - np.rint(d / box[c]) * box[c])
        g2 = g2 + np.maximum(d - np.float64(half[c]), 0.0) ** 2
    return g2 <= np.float32(r2_far)


class K2Plan(NamedTuple):
    """K2's launch: a grid of (low_tiles + tail_tiles, tail_tiles) blocks."""

    low_tiles: int  # tiles of K2_TILE low slots (partners)
    tail_tiles: int  # tiles of K2_TILE tail rows: the grid's y, and as partners
    table_smem: bool  # a Chebyshev table in shared memory
    smem: int  # dynamic shared memory, bytes


@functools.lru_cache(maxsize=256)
def k2_plan(O: int, N: int, look: int, rows: int, degp: int) -> K2Plan:
    """K2's plan for O tail rows and N low slots: the tail rows in tiles of
    K2_TILE, both as the rows of a block and as the tail-tail blocks'
    partners; a Chebyshev table in shared memory when it fits
    TABLE_SMEM_MAX (a Hermite table is always read from global memory)."""
    tsm = look == CHEB and table_bytes(look, rows, degp) <= TABLE_SMEM_MAX
    R = min(O, K2_TILE)
    smem = (table_bytes(look, rows, degp) if tsm else 0) + 16 * (R + 4 * R)
    return K2Plan(_ceil(N, K2_TILE), _ceil(O, K2_TILE), tsm, smem)


def k2_blocks(O: int, N: int, plan: K2Plan) -> list:
    """K2's blocks as the kernel maps them: (block x, row tile y, tail-tail,
    partner range, tail-row range), each range [start, stop)."""
    out = []
    for y in range(plan.tail_tiles):
        rows = (y * K2_TILE, min(O, (y + 1) * K2_TILE))
        for x in range(plan.low_tiles + plan.tail_tiles):
            tail = x >= plan.low_tiles
            t, n = (x - plan.low_tiles, O) if tail else (x, N)
            out.append((x, y, tail, (t * K2_TILE, min(n, (t + 1) * K2_TILE)), rows))
    return out


# ------------------------------------------------------------ CUDA wrappers


def _table_args(table, device):
    """The lookup's launch arguments: (lookup id, t1, t2, rows, degp, geom)
    — Hermite: id 0, the (G, 4) table, rows G, geom (glo, gdx, ghi, blo,
    bhi); Chebyshev: id 1, cval and cder (P, deg+1), rows P, degp deg+1,
    geom ``cheb_geom``.  Any Chebyshev table; a Hermite table of at most the
    library's ``max_g`` rows (the JAX kernels' own limit)."""
    _, lim = library()
    if isinstance(table, ChebTable):
        P, degp = table.cval.shape
        check(table.cval, "cval", (P, degp), device)
        check(table.cder, "cder", (P, degp), device)
        if degp < 2:
            raise ValueError(f"Chebyshev table of degree {degp - 1}: the kernels take degree >= 1")
        return CHEB, table.cval, table.cder, P, degp, cheb_geom(table, torch.float32)
    G, glo, gdx, ghi, blo, bhi = table.geom
    check(table.tab, "table", (G, 4), device)
    if G > lim["max_g"]:
        raise ValueError(f"Hermite table of {G} rows is beyond the kernels' {lim['max_g']}")
    if table.tab.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    return HERMITE, table.tab, table.tab, G, 0, (glo, gdx, ghi, blo, bhi)


def _pair_args(look, box, lj):
    """(lookup id, t1, t2, rows, degp, geom) of ``_table_args`` as launch
    arguments, with the box and LJ constants, all f32."""
    lid, t1, t2, rows, degp, geom = look
    return (lid, t1.data_ptr(), t2.data_ptr(), rows, degp, f32(geom),
            f32([box[0], box[1], box[2], 1.0 / box[0], 1.0 / box[1], 1.0 / box[2]]),
            f32([4.0 * lj.epsilon, lj.sigma * lj.sigma, lj.rcut]))


def _plan_args(plan: RowPlan):
    return int(plan.small), plan.piece_words, plan.row_tile, int(plan.table_smem)


def _cull_counts(plan: RowPlan, device):
    """The pieces form's counts of its cull (three int64 on ``device``)
    when tracing is on, else None."""
    if plan.small or not trace.enabled():
        return None
    return torch.zeros(3, dtype=torch.int64, device=device)


def _report_cull(counts) -> None:
    """Adds the launch's counts into the device counters CULL_COUNTERS."""
    if counts is not None:
        for name, n in zip(CULL_COUNTERS, counts):
            trace.count_device(name, n)


def _newton_launch(credits: bool, xs, mc, f, eb, cred, table, *, k, ncells, box, lj, energy,
                   ts, type_pair, mc_cand=None, row_box=None):
    """Checks and launches K1 (``credits``: applied in the kernel) or K6
    on CUDA tensors."""
    lib, _ = library()
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    check(xs, "xs", (Cg, cap, 3), xs.device)
    origin, rdims = _row_box(xs, mc, mc_cand, ncells, row_box)
    check(mc, "mc", tuple(mc.shape), xs.device)
    mc_cand = mc if mc_cand is None else mc_cand
    check(mc_cand, "mc_cand", (Cg, cap), xs.device)
    if not 0 < k <= cap:
        raise ValueError(f"k={k} outside 1..cap={cap}")
    if Cg < C or min(ncells) < 3:
        raise ValueError(f"unsupported lattice {ncells} (Cg={Cg})")
    types = (None, None)
    if ts is not None:
        check(ts, "ts", (Cg, cap), xs.device)
        types = (ts.data_ptr(), f32(type_pair))
    look = _table_args(table, xs.device)
    plan = row_plan(k, 3, ts is not None, look[0], look[3], look[4])
    counts = _cull_counts(plan, xs.device)
    code = lib.cell_force_newton_launch(
        xs.data_ptr(), mc.data_ptr(), mc_cand.data_ptr(), f.data_ptr(), eb.data_ptr(),
        cred.data_ptr(), C, Cg, cap, k, *ncells, int(credits), *origin, *rdims, mc.shape[0],
        *types, *_plan_args(plan), *_pair_args(look, box, lj), int(energy),
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    raise_on(lib, code, "cell_force_newton" if credits else "cell_force_newton_planar")
    _report_cull(counts)


def _device_of(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {t.device}")
    return t.device.type


def cell_force_newton(xs, mc_rows, table, *, k: int, ncells, box, lj, energy: bool,
                      ts=None, type_pair=None, mc_cand=None, row_box=None):
    """K1 (see ``cell_force_newton_ref`` for the contract).  On the GPU the
    Newton credits are summed deterministically: the row pass (one block
    per row cell, a warp per occupied row, the occupied candidates
    compacted) writes the row sums and a per-offset credit scratch
    (rows, 13, k, 3), and a second pass over every element of ``f``
    subtracts each slot's credits from the sources in the row box, in a
    fixed offset order — no atomics.  With a ``row_box`` the row pass runs
    over the box's R cells only and the scratch is sized by R: bitwise the
    whole-lattice pass with the rows outside the box masked out.  The two
    passes write every element of ``f`` and ``eb``, so nothing is filled
    beforehand.  Any k and cap, any table the plain version takes (a
    Hermite table of at most 1,024 rows, JAX's own limit): ``row_plan``
    picks the row pass's form."""
    kw = dict(k=k, ncells=ncells, box=box, lj=lj, energy=energy, ts=ts, type_pair=type_pair,
              mc_cand=mc_cand, row_box=row_box)
    if _device_of(xs, "cell-force") == "cpu":
        return cell_force_newton_ref(xs, mc_rows, table, **kw)
    n_rows = mc_rows.shape[0]
    f = torch.empty_like(xs)
    eb = torch.empty((n_rows, k), dtype=xs.dtype, device=xs.device)
    cred = torch.empty((n_rows, 13, k, 3), dtype=xs.dtype, device=xs.device)
    _newton_launch(True, xs, mc_rows, f, eb, cred, table, **kw)
    cell_force_newton.launches += 1
    if row_box is not None:
        cell_force_newton.row_box_launches += 1
    return f, eb


# launches: every K1 launch; row_box_launches: those of the owned-row form
cell_force_newton.launches = 0
cell_force_newton.row_box_launches = 0


def cell_force_newton_planar(xs, mc, table, *, ncells, box, lj, energy: bool,
                             ts=None, type_pair=None):
    """K6 (see ``cell_force_newton_planar_ref`` for the contract): K1's row
    pass at full cap, launched alone; the credit scratch is the returned
    ``cred``.  The pass writes every element of the three outputs, zeros
    at empty slots and pad cells included; any cap (``row_plan``)."""
    kw = dict(ncells=ncells, box=box, lj=lj, energy=energy, ts=ts, type_pair=type_pair)
    if _device_of(xs, "cell-force") == "cpu":
        return cell_force_newton_planar_ref(xs, mc, table, **kw)
    Cg, cap, _ = xs.shape
    f = torch.empty_like(xs)
    eb = torch.empty((Cg, cap), dtype=xs.dtype, device=xs.device)
    cred = torch.empty((Cg, 13, cap, 3), dtype=xs.dtype, device=xs.device)
    _newton_launch(False, xs, mc, f, eb, cred, table, k=cap, **kw)
    cell_force_newton_planar.launches += 1
    return f, cred, eb


cell_force_newton_planar.launches = 0


def cell_force_full(xs, mc, sid, table: ChebTable, *, ncells, box, lj):
    """K7 (see ``cell_force_full_ref`` for the contract).  On the GPU each
    unordered pair is evaluated once: K1's row pass at full cap over the
    half-stencil (14 x cap candidates, the Chebyshev lookup with its
    value), which also credits each partner the pair's force and value
    into a scratch (Cg, 13, cap, 4); a second pass subtracts the force
    credits and adds the value credits in a fixed offset order.  With 3 or
    more cells per dimension the 27 stencil cells are distinct, so the only
    candidate carrying a row's slot id is the row itself: the kernel masks
    the self pair by position and ``sid`` is only checked.  Any cap
    (``row_plan`` at k = cap, four credit components)."""
    if not isinstance(table, ChebTable):
        raise ValueError("cell_force_full evaluates a ChebTable only (the TPU kernel's contract)")
    kw = dict(ncells=ncells, box=box, lj=lj)
    if _device_of(xs, "cell-force") == "cpu":
        return cell_force_full_ref(xs, mc, sid, table, **kw)
    lib, _ = library()
    Cg, cap, _ = xs.shape
    C = int(np.prod(ncells))
    for t, name, shape in ((xs, "xs", (Cg, cap, 3)), (mc, "mc", (Cg, cap)),
                           (sid, "sid", (Cg, cap))):
        check(t, name, shape, xs.device)
    if Cg < C or min(ncells) < 3:
        raise ValueError(f"unsupported lattice {ncells} (Cg={Cg})")
    f = torch.empty_like(xs)
    eb = torch.empty((Cg, cap), dtype=xs.dtype, device=xs.device)
    cred = torch.empty((Cg, 13, cap, 4), dtype=xs.dtype, device=xs.device)
    look = _table_args(table, xs.device)
    plan = row_plan(cap, 4, False, look[0], look[3], look[4])
    args = _pair_args(look, box, lj)
    counts = _cull_counts(plan, xs.device)
    code = lib.cell_force_full_launch(
        xs.data_ptr(), mc.data_ptr(), f.data_ptr(), eb.data_ptr(), cred.data_ptr(),
        C, Cg, cap, *ncells, *_plan_args(plan), *args,
        None if counts is None else counts.data_ptr(),
        torch.cuda.current_stream(xs.device).cuda_stream,
    )
    raise_on(lib, code, "cell_force_full")
    _report_cull(counts)
    cell_force_full.launches += 1
    return f, eb


cell_force_full.launches = 0


def overflow_force(xo, xp, table, *, box, lj, energy: bool):
    """K2 (see ``overflow_force_ref`` for the contract).  On the GPU a
    thread per partner takes the distance to each live tail row and the
    pair arithmetic only within reach of the cutoffs (beyond it the plain
    version's terms are exact zeros); each partner's credit is owned by one
    thread; the tail-tail block is one more block of the same sweep, and
    the per-block partial sums of the tail rows are reduced in a fixed order
    by a second pass.  The two passes write ``fo`` and ``fp`` whole.  Any
    number of tail rows: ``k2_plan`` tiles them by K2_TILE, as the rows of a
    block (a grid row a tile; each tile's partner credits are added in tile
    order by the second pass) and as the tail-tail blocks' partners."""
    if _device_of(xo, "overflow-force") == "cpu":
        return overflow_force_ref(xo, xp, table, box=box, lj=lj, energy=energy)
    lib, lim = library()
    O = xo.shape[1]
    N = xp.shape[1]
    check(xo, "xo", (5, O), xo.device)
    check(xp, "xp", (4, N), xo.device)
    if O < 1:
        raise ValueError(f"unsupported tail rows {O}")
    look = _table_args(table, xo.device)
    plan = k2_plan(O, N, look[0], look[3], look[4])
    if lim["k2_tile"] != K2_TILE:
        raise RuntimeError(f"the library's K2 tile {lim['k2_tile']} is not {K2_TILE}")
    fo = torch.empty((4, O), dtype=xo.dtype, device=xo.device)
    fp = torch.empty((3, N), dtype=xo.dtype, device=xo.device)
    part = torch.empty((plan.low_tiles + plan.tail_tiles, O, 4), dtype=xo.dtype,
                       device=xo.device)
    # the row tiles' credit sums, added in tile order by the finish
    fpart = torch.empty((plan.tail_tiles if plan.tail_tiles > 1 else 0, 3, N), dtype=xo.dtype,
                        device=xo.device)
    code = lib.overflow_force_launch(
        xo.data_ptr(), xp.data_ptr(), fo.data_ptr(), fp.data_ptr(), part.data_ptr(),
        fpart.data_ptr(), O, N, int(plan.table_smem), *_pair_args(look, box, lj), int(energy),
        torch.cuda.current_stream(xo.device).cuda_stream,
    )
    raise_on(lib, code, "overflow_force")
    overflow_force.launches += 1
    return fo, fp


overflow_force.launches = 0
