"""Cell lists for short-range pair interactions (stands in for LAMMPS's
neighbour lists, fix_edm_pair.cpp:166-206), in PyTorch.

Counterpart of ``edm_tpu/models/cells.py``.  Atoms are binned into cells of
edge >= the interaction range, so every interacting pair lies within the
27-cell stencil; storage is a fixed-capacity (C, cap) slot table.  Every
integer output matches the JAX package exactly: each sort is stable and
each compaction is a prefix-rank scatter whose out-of-range targets land
in one discarded overflow row (the ``mode="drop"`` scatters of JAX).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..grid import device_const


@dataclasses.dataclass(frozen=True)
class CellSpec:
    ncells: Tuple[int, int, int]
    edge: Tuple[float, float, float]
    box: Tuple[float, float, float]
    cap: int  # atom slots per cell
    n_atoms: int

    @classmethod
    def create(cls, box, cutoff: float, n_atoms: int, cap: int | None = None):
        box = tuple(float(b) for b in box)
        nc = tuple(max(1, int(math.floor(b / cutoff))) for b in box)
        edge = tuple(b / n for b, n in zip(box, nc))
        if cap is None:
            density = n_atoms / (box[0] * box[1] * box[2])
            mean = density * edge[0] * edge[1] * edge[2]
            # mean + 4 sigma Poisson headroom, rounded up to a multiple of 8
            cap = max(8, int(math.ceil(mean + 4 * math.sqrt(max(mean, 1.0)))))
            cap = ((cap + 7) // 8) * 8
        return cls(ncells=nc, edge=edge, box=box, cap=int(cap), n_atoms=int(n_atoms))

    @property
    def n_cells(self) -> int:
        return self.ncells[0] * self.ncells[1] * self.ncells[2]

    @property
    def n_slots(self) -> int:
        return self.n_cells * self.cap

    def stencil(self) -> np.ndarray:
        """(C, 27) neighbour-cell ids with periodic wrap."""
        return neighbor_cells(self.ncells, [
            (dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
        ])


def neighbor_cells(ncells, offsets) -> np.ndarray:
    """(C, len(offsets)) flat ids of cell c + offset, periodic per axis."""
    nx, ny, nz = ncells
    cid = np.arange(nx * ny * nz)
    cx, cy, cz = cid // (ny * nz), (cid // nz) % ny, cid % nz
    out = np.empty((nx * ny * nz, len(offsets)), np.int64)
    for k, (dx, dy, dz) in enumerate(offsets):
        out[:, k] = ((cx + dx) % nx) * ny * nz + ((cy + dy) % ny) * nz + ((cz + dz) % nz)
    return out


class CellTable(NamedTuple):
    aid: torch.Tensor  # (C*cap,) int64 atom id per slot; n_atoms marks empty
    overflow: torch.Tensor  # bool: a cell exceeded cap


def _scatter_drop(n_out: int, fill, tgt, vals):
    """``full(n_out, fill).at[tgt].set(vals, mode="drop")`` for targets in
    [0, n_out] (n_out = dropped)."""
    out = torch.full((n_out + 1,) + vals.shape[1:], fill, dtype=vals.dtype,
                     device=vals.device)
    return out.index_put((tgt,), vals)[:n_out]


def cell_of(spec: CellSpec, x: torch.Tensor) -> torch.Tensor:
    """Per-atom flat cell index (int64) from wrapped positions."""
    box = device_const(spec.box, x.device, x.dtype)
    edge = device_const(spec.edge, x.device, x.dtype)
    nc = device_const(spec.ncells, x.device, torch.int64)
    xw = x - box * torch.floor(x / box)
    c = torch.minimum(torch.clamp(torch.floor(xw / edge).to(torch.int64), min=0), nc - 1)
    ny, nz = spec.ncells[1], spec.ncells[2]
    return c[:, 0] * (ny * nz) + c[:, 1] * nz + c[:, 2]


def build_table(spec: CellSpec, x: torch.Tensor) -> CellTable:
    """Bin atoms into slots: stable argsort by cell + segment ranks."""
    n = spec.n_atoms
    dev = x.device
    cid = cell_of(spec, x)
    order = torch.argsort(cid, stable=True)
    cid_s = cid[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), cid_s[1:] != cid_s[:-1]])
    ar = torch.arange(n, device=dev)
    seg_start = torch.cummax(torch.where(first, ar, torch.zeros_like(ar)), 0).values
    rank = ar - seg_start
    overflow = torch.any(rank >= spec.cap)
    slot = cid_s * spec.cap + torch.clamp(rank, max=spec.cap - 1)
    aid = _scatter_drop(spec.n_slots, n, slot, order)
    return CellTable(aid=aid, overflow=overflow)


class RebinPlan(NamedTuple):
    """Mover placement for a slot-to-slot incremental rebin."""

    feasible: torch.Tensor  # bool: every mover fits a hole of its target cell
    n_movers: torch.Tensor
    m_src: torch.Tensor  # (M,) flat source slot, sorted by target cell; S = none
    m_dest: torch.Tensor  # (M,) flat destination slot; S = drop


def plan_incremental_rebin(spec: CellSpec, Cg: int, aid_g: torch.Tensor,
                           xs: torch.Tensor, mover_cap: int) -> RebinPlan:
    """Plan a slot-to-slot rebin: stayers keep their slots; atoms that
    crossed a cell boundary ("movers") are compacted into a list and
    assigned free holes of their target cells (holes include slots vacated
    this rebin).  ``feasible`` is False when movers exceed ``mover_cap`` or
    a target cell lacks holes; the caller then rebuilds fully."""
    n = spec.n_atoms
    cap = spec.cap
    C = spec.n_cells
    S = Cg * cap
    dev = xs.device
    aid2 = aid_g.reshape(Cg, cap)
    real = aid_g < n
    new_cid = cell_of(spec, xs.reshape(S, 3))
    cur_cid = torch.arange(S, device=dev) // cap
    mover = real & (new_cid != cur_cid)
    n_mov = torch.sum(mover.to(torch.int64))

    ranks = torch.cumsum(mover.to(torch.int64), 0) - 1
    tgt = torch.where(mover & (ranks < mover_cap), ranks, torch.full_like(ranks, mover_cap))
    m_src = _scatter_drop(mover_cap, S, tgt, torch.arange(S, device=dev))
    msrc_c = torch.clamp(m_src, 0, S - 1)
    m_cell = torch.where(m_src < S, new_cid[msrc_c], torch.full_like(m_src, C))
    order = torch.argsort(m_cell, stable=True)
    m_cell_s = m_cell[order]
    m_src_s = m_src[order]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       m_cell_s[1:] != m_cell_s[:-1]])
    am = torch.arange(mover_cap, device=dev)
    seg_start = torch.cummax(torch.where(first, am, torch.zeros_like(am)), 0).values
    q = am - seg_start

    # holes: empty slots plus slots vacated by movers (swaps at full
    # occupancy stay feasible); ht[c, q] = the q-th hole slot of cell c
    empty_eff = (aid2 == n) | mover.reshape(Cg, cap)
    hrank = torch.cumsum(empty_eff.to(torch.int64), 1) - 1
    holes_per_cell = hrank[:, -1] + 1
    qi = torch.arange(cap, device=dev)
    oh = empty_eff[:, :, None] & (hrank[:, :, None] == qi[None, None, :])
    ht = torch.sum(oh * qi[None, :, None], dim=1)

    valid = m_src_s < S
    c_cl = torch.clamp(m_cell_s, 0, Cg - 1)
    slot = ht[c_cl, torch.clamp(q, 0, cap - 1)]
    fits = q < holes_per_cell[c_cl]
    m_dest = torch.where(valid & fits, c_cl * cap + slot, torch.full_like(slot, S))
    feasible = (n_mov <= mover_cap) & torch.all(~valid | fits)
    return RebinPlan(feasible=feasible, n_movers=n_mov, m_src=m_src_s, m_dest=m_dest)


def apply_incremental_rebin(spec: CellSpec, plan: RebinPlan, aid_g, arrays):
    """Relocate movers per plan.  ``arrays``: flat (S, ...) slot payloads
    moved with the id table; sources are cleared before destinations are
    written.  Returns (new aid, [new arrays]); payload left in vacated
    slots is masked everywhere by the (aid < n) occupancy mask."""
    n = spec.n_atoms
    S = aid_g.shape[0]
    src_ok = plan.m_src < S
    src_c = torch.clamp(plan.m_src, 0, S - 1)

    def set_drop(a, idx, vals):
        pad = torch.cat([a, a[:1]])
        return pad.index_put((idx,), vals)[:S]

    aid_new = set_drop(aid_g, torch.where(src_ok, plan.m_src, torch.full_like(src_c, S)),
                       torch.full_like(src_c, n))
    m_aid = torch.where(src_ok, aid_g[src_c], torch.full_like(src_c, n))
    aid_new = set_drop(aid_new, plan.m_dest, m_aid)
    return aid_new, [set_drop(a, plan.m_dest, a[src_c]) for a in arrays]
