"""Cell-list pairwise EDM — the production large-N host — in PyTorch.

Counterpart of ``edm_tpu/models/pair_edm_cells.py``, single device,
untyped, light states.  The MD state lives in cell-slot order
``(Cg, cap, 3)`` between table rebuilds (Cg = cells padded to a multiple
of 8, ``aid`` of length Cg*cap, exactly the JAX layout):

  1. BAOAB pre-force stages on the slot arrays; thermostat noise from the
     counter hash keyed by global slot row (``ops/hashrng``);
  2. the force pass through K1 (``ops/cellforce.cell_force_newton``) —
     at ``kernel_cap`` rows/candidates plus K2 (``overflow_force``) over
     the compacted tail list, or at full cap when the rebuild period's tail
     list overflowed (never-drop fallback);
  3. on hill steps: two-level hill collection over half-stencil tiles
     (two acceptance draws per unordered pair) and ``bias.add_hills_round``;
  4. on rebuild steps: the incremental slot-to-slot rebin, or the full
     argsort rebuild when the plan is infeasible (or would overflow the
     tail list).

Each JAX ``lax.cond`` on a traced flag becomes a read of that flag on the
host.  Only rebuild and hill steps read: the rebin's feasibility (and,
after a full rebuild, ``tail_ovf``), and the capping loop's exit flag in
``add_hills_round``.  ``tail_ovf`` changes only at rebuilds, so the state
carries its host copy (``tail_ovf_host``) through the period; a feasible
rebin keeps the tail within ``overflow_cap`` by construction and needs no
read.  Each step counts its reads in ``step.host_syncs``.

Differences from the JAX state: the cached half-stencil mask planes
(``mnf``, ``mkf``) are gone — K1 reads the neighbours' occupancy itself
and the hill pass gathers its mask with its coordinates — and the state
records ``kernel_cap`` and ``tail_ovf_host``.  The step owns its outputs:
the force planes that K1 returns are updated in place by the tail pass.

Not ported yet: dynamic stride conds (``static_do_*`` = None), Chebyshev
lookup (ROADMAP Queue 1, item 7), id masks and the legacy kernels
(``with_ids``, ``use_pallas`` other than True; item 13), slab/brick
sharding (item 12), type-filtered CVs (item 5), hill-record collection
(item 10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import bias as B
from ..ops import prng
from ..grid import device_const
from ..ops.cellforce import (
    CELLS_PER_GROUP,
    cell_force_newton,
    half_neighbors,
    hermite_pair_table,
    overflow_force,
)
from ..ops.hashrng import normal_rows_cols, seeds_from_key, uniform_rows_cols
from .cells import (
    CellSpec,
    _scatter_drop,
    apply_incremental_rebin,
    build_table,
    plan_incremental_rebin,
)
from .langevin import LangevinParams
from .lj import LJParams
from .pair_edm import PairEDMState


@dataclasses.dataclass(frozen=True)
class CellPairState:
    core: PairEDMState  # x/v/f in atom order, refreshed at full rebuilds only
    aid: torch.Tensor  # (Cg*cap,) int64 slot -> atom id (n_atoms = empty)
    xs: torch.Tensor  # (Cg, cap, 3) slot positions (authoritative)
    vs: torch.Tensor  # (Cg, cap, 3)
    fs: torch.Tensor  # (Cg, cap, 3)
    mc: torch.Tensor  # (Cg, cap) 1.0 for real atoms
    table_overflow: torch.Tensor  # bool: a cell exceeded cap (atoms dropped)
    kernel_cap: Optional[int] = None  # reduced force cap the state serves
    ovl: Optional[torch.Tensor] = None  # (overflow_cap,) flat tail slot ids
    # (slot >= kernel_cap), sentinel Cg*cap
    tail_count: Optional[torch.Tensor] = None  # true tail population
    tail_ovf: Optional[torch.Tensor] = None  # bool: tail_count > overflow_cap
    # -> this rebuild period runs the full-cap kernel (never-drop)
    tail_fallbacks: Optional[torch.Tensor] = None  # periods run at full cap
    tail_ovf_host: Optional[bool] = None  # host copy of tail_ovf


def _padded_cells(spec: CellSpec) -> int:
    return -(-spec.n_cells // CELLS_PER_GROUP) * CELLS_PER_GROUP


def _tail_list(aid2, n: int, cap: int, kcap: int, ocap: int):
    """Compacted flat slot ids of occupied tail slots (slot >= kcap), in
    slot order, sentinel Cg*cap; and the true tail population (when it
    exceeds ``ocap`` the list is incomplete and the period falls back)."""
    Cg = aid2.shape[0]
    occ = (aid2[:, kcap:] < n).reshape(-1)
    dev = aid2.device
    sids = (torch.arange(Cg, device=dev)[:, None] * cap
            + torch.arange(kcap, cap, device=dev)[None, :]).reshape(-1)
    ranks = torch.cumsum(occ.to(torch.int64), 0) - 1
    tgt = torch.where(occ & (ranks < ocap), ranks, torch.full_like(ranks, ocap))
    ovl = _scatter_drop(ocap, Cg * cap, tgt, sids)
    return ovl, torch.sum(occ.to(torch.int64))


def _slots_from_atoms(spec: CellSpec, Cg: int, x, v, f, aid_g,
                      kernel_cap=None, overflow_cap: int = 128):
    """Gather atom arrays into slot layout; empty slots hold zeros."""
    n = spec.n_atoms
    cap = spec.cap
    aid_c = torch.clamp(aid_g, 0, n - 1)
    aid2 = aid_g.reshape(Cg, cap)
    mc = (aid2 < n).to(x.dtype)
    xs = x[aid_c].reshape(Cg, cap, 3) * mc[..., None]
    vs = v[aid_c].reshape(Cg, cap, 3) * mc[..., None]
    fs = f[aid_c].reshape(Cg, cap, 3) * mc[..., None]
    if kernel_cap is not None:
        ovl, tail_count = _tail_list(aid2, n, cap, kernel_cap, overflow_cap)
    else:
        ovl = tail_count = None
    return xs, vs, fs, mc, ovl, tail_count


def _atoms_from_slots(spec: CellSpec, aid_g, xs, vs, fs):
    """Slot arrays back to atom order (each atom in exactly one slot)."""
    n = spec.n_atoms
    idx = torch.where(aid_g < n, aid_g, torch.full_like(aid_g, n))
    return tuple(_scatter_drop(n, 0.0, idx, a.reshape(-1, 3)) for a in (xs, vs, fs))


def atom_positions(spec: CellSpec, state: CellPairState) -> torch.Tensor:
    """Up-to-date atom-order positions (core.x is only rebuild-fresh)."""
    return _atoms_from_slots(spec, state.aid, state.xs, state.xs, state.xs)[0]


def _half_concat(plane, ncells, cap: int):
    """(Cg, cap[, ...]) per-slot plane -> (C, 14cap[, ...]) candidate planes:
    the cell's own slots, then its 13 HALF_OFFSETS neighbours' slots (the
    JAX lattice rolls, as a gather)."""
    C = int(np.prod(ncells))
    nbr = half_neighbors(tuple(ncells), plane.device)
    own = plane[:C]
    nb = plane[nbr].reshape((C, 13 * cap) + plane.shape[2:])
    return torch.cat([own, nb], 1)


def init_cell_state(spec: CellSpec, core: PairEDMState, with_ids: bool = False,
                    types=None, kernel_cap=None, overflow_cap: int = 128
                    ) -> CellPairState:
    """Bin the atoms and build the slot state.  ``kernel_cap`` /
    ``overflow_cap`` build the tail list for reduced-cap force passes (pass
    the same values to ``make_cell_step``); a tail beyond ``overflow_cap``
    sets ``tail_ovf`` and the period runs at full cap.  Reads ``tail_ovf``
    once to the host."""
    if with_ids:
        raise NotImplementedError(
            "stencil id masks (with_ids) serve only the legacy kernels, not "
            "ported yet (ROADMAP Queue 1, item 13)"
        )
    if types is not None:
        raise NotImplementedError(
            "type-filtered CVs are not ported yet (ROADMAP Queue 1, item 5)"
        )
    Cg = _padded_cells(spec)
    table = build_table(spec, core.x)
    n = spec.n_atoms
    aid_g = torch.cat([table.aid, torch.full((Cg * spec.cap - spec.n_slots,), n,
                                             dtype=torch.int64, device=core.x.device)])
    xs, vs, fs, mc, ovl, tail_count = _slots_from_atoms(
        spec, Cg, core.x, core.v, core.f, aid_g, kernel_cap, overflow_cap
    )
    tail = {}
    if kernel_cap is not None:
        tail_ovf = tail_count > overflow_cap
        tail = dict(kernel_cap=kernel_cap, ovl=ovl, tail_count=tail_count,
                    tail_ovf=tail_ovf, tail_fallbacks=tail_ovf.to(torch.int64),
                    tail_ovf_host=bool(tail_ovf))
    return CellPairState(core=core, aid=aid_g, xs=xs, vs=vs, fs=fs, mc=mc,
                         table_overflow=table.overflow, **tail)


class CellStep:
    """One static stride phase of the cell host (``make_cell_step``):
    ``step(state) -> (new_state, bias_energy)``.  ``host_syncs`` counts the
    flags this step object has read back to the host."""

    def __init__(self, params: B.BiasParams, lp: LangevinParams, lj: LJParams,
                 spec: CellSpec, *, do_hills: bool, do_energy: bool,
                 do_rebuild: bool, hill_capacity: int, row_cap: int,
                 m_per_row: int, mover_cap: int, kernel_cap, overflow_cap: int):
        self.params, self.lp, self.lj, self.spec = params, lp, lj, spec
        self.do_hills, self.do_energy, self.do_rebuild = do_hills, do_energy, do_rebuild
        self.hill_capacity, self.row_cap, self.m_per_row = hill_capacity, row_cap, m_per_row
        self.mover_cap = mover_cap
        self.kernel_cap, self.overflow_cap = kernel_cap, overflow_cap
        self.Cg = _padded_cells(spec)
        c1 = float(np.exp(-lp.friction * lp.dt))
        self._c1 = c1
        self._c2 = float(np.sqrt(max(0.0, (1.0 - c1 * c1)) * lp.kT / lp.mass))
        self.host_syncs = 0

    def __call__(self, state: CellPairState, _=None):
        core = state.core
        spec, lp = self.spec, self.lp
        dtype = state.xs.dtype
        if self.kernel_cap is not None and state.kernel_cap != self.kernel_cap:
            raise ValueError(
                f"state was built with kernel_cap={state.kernel_cap} but the "
                f"step expects kernel_cap={self.kernel_cap}; pass the same "
                "value to init_cell_state and make_cell_step"
            )
        if self.kernel_cap is not None and state.ovl.shape[0] != self.overflow_cap:
            raise ValueError(
                f"state was built with overflow_cap={state.ovl.shape[0]} but "
                f"the step expects overflow_cap={self.overflow_cap}"
            )
        key, sub_noise = prng.split(core.key)
        xs, vh = self._phase1(state, seeds_from_key(sub_noise))
        e_bias, fs = self._force(state, xs)
        vs = (vh + (0.5 * lp.dt / lp.mass) * fs) * state.mc[..., None]
        if not self.do_energy:
            e_bias = core.energy

        if self.do_hills:
            key, sub = prng.split(key)
            hills, runifs, active, ncalls, truncated = self._collect_hills(
                state, xs, sub, core.last_calls, dtype
            )
            bias_state, _, reads = B.add_hills_round(
                self.params, core.bias, hills[:, None], runifs,
                core.last_calls.to(dtype), active=active,
            )
            self.host_syncs += reads
            last_calls = ncalls
        else:
            bias_state, last_calls = core.bias, core.last_calls
            truncated = torch.zeros((), dtype=torch.bool, device=xs.device)

        if self.do_rebuild:
            upd = self._rebuild(state, xs, vs, fs)
        else:
            upd = dict(xs=xs, vs=vs, fs=fs)
        x_at, v_at, f_at = upd.pop("atoms", (core.x, core.v, core.f))
        new_core = PairEDMState(
            x=x_at, v=v_at, f=f_at, key=key, bias=bias_state,
            step=core.step + 1, last_calls=last_calls, energy=e_bias,
            hills_truncated=core.hills_truncated | truncated,
        )
        return dataclasses.replace(state, core=new_core, **upd), e_bias

    # ----------------------------------------------------------- BAOAB

    def _phase1(self, state, seeds):
        """B-A-O-A stages on the slot arrays; padded slots stay pinned."""
        lp = self.lp
        Cg, cap = state.mc.shape
        rows = torch.arange(Cg * cap, device=state.xs.device)
        xi = normal_rows_cols(seeds, rows, 3, state.xs.dtype).reshape(Cg, cap, 3)
        v1 = state.vs + (0.5 * lp.dt / lp.mass) * state.fs  # B
        x1 = state.xs + (0.5 * lp.dt) * v1  # A
        v2 = self._c1 * v1 + self._c2 * xi  # O
        x2 = x1 + (0.5 * lp.dt) * v2  # A
        m = state.mc[..., None]
        return x2 * m, v2 * m

    # ----------------------------------------------------------- forces

    def _force(self, state, xs):
        """(bias energy, forces (Cg, cap, 3)) through K1, plus K2 on
        reduced-cap periods."""
        spec, lj = self.spec, self.lj
        tbl = hermite_pair_table(state.core.bias.bias)
        kw = dict(box=spec.box, lj=lj, energy=self.do_energy)
        if self.kernel_cap is None or state.tail_ovf_host:
            f, eb = cell_force_newton(xs, state.mc, tbl, k=spec.cap, ncells=spec.ncells, **kw)
            return eb.sum(), f
        kcap = self.kernel_cap
        f, eb = cell_force_newton(xs, state.mc, tbl, k=kcap, ncells=spec.ncells, **kw)
        fo, fp = overflow_force(*self._overflow_inputs(state, xs), tbl, **kw)
        # tail assembly, in place on K1's fresh output: partner credits onto
        # the low slots, tail-atom forces into their slots (the sentinel id
        # lands in a discarded extra row)
        Cg, cap = state.mc.shape
        S = Cg * cap
        f[:, :kcap] += fp.T.reshape(Cg, kcap, 3)
        f_pad = torch.cat([f.reshape(S, 3), f.new_zeros(1, 3)])
        f_pad.index_add_(0, state.ovl, fo[:3].T)
        return eb.sum() + fo[3].sum(), f_pad[:S].reshape(Cg, cap, 3)

    def _overflow_inputs(self, state, xs):
        """K2's planes: the tail rows (x, y, z, mask, own) and every low
        slot (x, y, z, mask)."""
        Cg, cap = state.mc.shape
        S = Cg * cap
        kcap = self.kernel_cap
        mo = (state.ovl < S).to(xs.dtype)
        xo3 = xs.reshape(S, 3)[torch.clamp(state.ovl, 0, S - 1)] * mo[:, None]
        xo = torch.cat([xo3.T, mo[None], mo[None]]).contiguous()
        xp = torch.cat([xs[:, :kcap].reshape(-1, 3).T,
                        state.mc[:, :kcap].reshape(1, -1)]).contiguous()
        return xo, xp

    # ----------------------------------------------------------- hills

    def _collect_hills(self, state, xs, key, last_calls, dtype):
        """Two-level hill collection over half-stencil tiles: each unordered
        pair once (self block strictly upper, 13 positive neighbours) with
        two acceptance uniforms (the reference's two ordered candidates,
        fix_edm_pair.cpp:229-237).  Pass 1 counts accepted candidates per
        slot row; pass 2 re-derives the same draws on the selected rows and
        extracts the first ``m_per_row`` per row in column order.  Returns
        (hills (H,), runifs (H,), active (H,), ncalls, truncated)."""
        spec, params = self.spec, self.params
        cap = spec.cap
        C = spec.n_cells
        W = 14 * cap
        rc, hc, m_per_row = self.row_cap, self.hill_capacity, self.m_per_row
        dev = xs.device
        seeds = seeds_from_key(key)
        hd = params.cfg.hill_density
        thresh = None if hd < 0 else B._rdiv(hd, last_calls.to(dtype))
        bmax2 = params.cfg.box_high[0] * params.cfg.box_high[0]
        box = device_const(spec.box, dev, dtype)
        cand = [_half_concat(xs[..., c], spec.ncells, cap) for c in range(3)]
        candm = _half_concat(state.mc, spec.ncells, cap) > 0.5
        ci = torch.arange(W, device=dev)

        def upper(ri):  # the self block strictly upper: each pair once
            return (ci >= cap) | (ci > ri)

        def accepted(ok, u):
            acc = ok[..., None].expand(ok.shape + (2,))
            return acc if thresh is None else acc & (u < thresh)

        # pass 1: accepted candidates per slot row, all cells at once
        r2 = 0.0
        for c in range(3):
            dd = cand[c][:, :cap, None] - cand[c][:, None, :]
            dd = dd - torch.round(dd / box[c]) * box[c]
            r2 = r2 + dd * dd
        ri = torch.arange(cap, device=dev)[None, :, None]
        ok = candm[:, :cap, None] & candm[:, None, :] & upper(ri) & (r2 < bmax2)
        rows = torch.arange(C * cap, device=dev)
        u = uniform_rows_cols(seeds, rows, 2 * W, dtype).reshape(C, cap, W, 2)
        row_counts = accepted(ok, u).sum((2, 3)).reshape(-1)
        ncalls = 2 * torch.sum(ok.to(torch.int64))

        has = row_counts > 0
        rranks = torch.cumsum(has.to(torch.int64), 0) - 1
        sent = C * cap
        rows_sel = _scatter_drop(
            rc, sent, torch.where(has & (rranks < rc), rranks, torch.full_like(rranks, rc)), rows
        )
        n_rows = torch.sum(has.to(torch.int64))

        # pass 2 on the selected slot rows
        rows_c = torch.clamp(rows_sel, 0, sent - 1)
        cells_c = rows_c // cap
        slot_c = (rows_c % cap)[:, None]
        r2 = 0.0
        for c in range(3):
            sl = cand[c][cells_c]
            dd = sl.gather(1, slot_c) - sl
            dd = dd - torch.round(dd / box[c]) * box[c]
            r2 = r2 + dd * dd
        ms = candm[cells_c]
        ok = ((rows_sel < sent)[:, None] & ms.gather(1, slot_c) & ms & upper(slot_c)
              & (r2 < bmax2))
        r = torch.sqrt(torch.where(ok, r2, torch.full_like(r2, float("inf"))))
        u = uniform_rows_cols(seeds, rows_c, 2 * W, dtype).reshape(rc, W, 2)
        acc = accepted(ok, u).reshape(rc, 2 * W)
        # the first m_per_row accepted columns of each row, row-major order
        sel = acc & (torch.cumsum(acc.to(torch.int64), 1) <= m_per_row)
        vflat = sel.reshape(-1)
        ranks = torch.cumsum(vflat.to(torch.int64), 0) - 1
        tgt = torch.where(vflat & (ranks < hc), ranks, torch.full_like(ranks, hc))
        r21 = r[:, :, None].expand(rc, W, 2).reshape(-1)  # r[w] at columns 2w, 2w+1
        hills = _scatter_drop(hc, 0.0, tgt, r21)
        runifs = _scatter_drop(hc, 1.0, tgt, u.reshape(-1))
        count = torch.sum(vflat.to(torch.int64))
        active = torch.arange(hc, device=dev) < count
        truncated = (count > hc) | (n_rows > rc) | torch.any(row_counts > m_per_row)
        return hills, runifs, active, ncalls, truncated

    # ----------------------------------------------------------- rebuilds

    def _tail_fields(self, state, tail_count):
        t_ovf = tail_count > self.overflow_cap
        return dict(tail_count=tail_count, tail_ovf=t_ovf,
                    tail_fallbacks=state.tail_fallbacks + t_ovf.to(torch.int64))

    def _rebuild(self, state, xs, vs, fs):
        """Incremental rebin when feasible (and, with ``kernel_cap``, when
        it keeps the tail within ``overflow_cap``), else the full argsort
        rebuild, which also refreshes core.x/v/f.  Returns the updated
        state fields."""
        spec = self.spec
        n, cap, Cg = spec.n_atoms, spec.cap, self.Cg
        S = Cg * cap
        kcap = self.kernel_cap
        plan = plan_incremental_rebin(spec, Cg, state.aid, xs, self.mover_cap)
        feasible = plan.feasible
        if kcap is not None:
            # a mover whose source AND destination are tail slots cancels
            leave = torch.sum((plan.m_src < S) & (plan.m_src % cap >= kcap))
            arrive = torch.sum((plan.m_dest < S) & (plan.m_dest % cap >= kcap))
            feasible = feasible & (state.tail_count - leave + arrive <= self.overflow_cap)
        self.host_syncs += 1
        if bool(feasible):
            aid_new, outs = apply_incremental_rebin(
                spec, plan, state.aid, [a.reshape(S, 3) for a in (xs, vs, fs)]
            )
            mc = (aid_new.reshape(Cg, cap) < n).to(xs.dtype)
            upd = dict(aid=aid_new, mc=mc)
            for name, a in zip(("xs", "vs", "fs"), outs):
                upd[name] = a.reshape(Cg, cap, 3) * mc[..., None]
            if kcap is not None:
                ovl, tail_count = _tail_list(aid_new.reshape(Cg, cap), n, cap, kcap,
                                             self.overflow_cap)
                # the feasibility test bounded the new tail by overflow_cap
                upd.update(ovl=ovl, tail_ovf_host=False,
                           **self._tail_fields(state, tail_count))
            return upd

        x_at, v_at, f_at = _atoms_from_slots(spec, state.aid, xs, vs, fs)
        t = build_table(spec, x_at)
        aid_g = torch.cat([t.aid, torch.full((S - spec.n_slots,), n, dtype=torch.int64,
                                             device=xs.device)])
        nxs, nvs, nfs, mc, ovl, tail_count = _slots_from_atoms(
            spec, Cg, x_at, v_at, f_at, aid_g, kcap, self.overflow_cap
        )
        upd = dict(aid=aid_g, xs=nxs, vs=nvs, fs=nfs, mc=mc,
                   table_overflow=state.table_overflow | t.overflow,
                   atoms=(x_at, v_at, f_at))
        if kcap is not None:
            upd.update(ovl=ovl, **self._tail_fields(state, tail_count))
            self.host_syncs += 1
            upd["tail_ovf_host"] = bool(upd["tail_ovf"])
        return upd


def make_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    *,
    static_do_hills: Optional[bool] = None,
    static_do_energy: Optional[bool] = None,
    static_do_rebuild: Optional[bool] = None,
    hill_capacity: int = 2048,
    row_cap: int = 2048,
    m_per_row: int = 16,
    use_pallas=True,
    energy_stride: int = 1,
    mover_cap: Optional[int] = None,
    kernel_cap: Optional[int] = None,
    overflow_cap: int = 128,
    types=None,
    type_pair=None,
    collect_records: bool = False,
    slab_axis=None,
    brick_axes=None,
) -> CellStep:
    """Build one static stride phase of the cell host.

    The caller owns the phase pattern (``driver.pattern_segment``), so the
    JAX step's ``hill_stride``/``rebuild_stride`` have no counterpart: a
    ``static_do_hills=True`` step deposits and a ``static_do_rebuild=True``
    step rebins whatever ``state.step`` is.  ``energy_stride == 1``
    evaluates the bias energy on every step; otherwise only on
    ``static_do_energy`` steps (forces are identical either way).
    ``use_pallas=True`` names the JAX package's kernel path: here the force
    pass always runs through K1/K2.  ``kernel_cap``/``overflow_cap`` as in
    the JAX host."""
    if None in (static_do_hills, static_do_energy, static_do_rebuild):
        raise NotImplementedError(
            "dynamic stride conds are not ported: build one step per phase "
            "with static_do_* and drive them with driver.pattern_segment"
        )
    if use_pallas is not True:
        raise NotImplementedError(
            f"use_pallas={use_pallas!r} (the XLA and legacy kernel paths) is "
            "not ported yet (ROADMAP Queue 1, item 13)"
        )
    if types is not None or type_pair is not None:
        raise NotImplementedError("type-filtered CVs are not ported yet (ROADMAP Queue 1, item 5)")
    if collect_records:
        raise NotImplementedError("hill-record collection is not ported yet (ROADMAP Queue 1, item 10)")
    if slab_axis is not None or brick_axes is not None:
        raise NotImplementedError("slab/brick sharding is not ported yet (ROADMAP Queue 1, item 12)")
    if min(spec.ncells) < 3:
        raise ValueError(
            "cell list needs >= 3 cells per dim (box >= 3x interaction "
            "range); use the dense/blocked host for small boxes"
        )
    if kernel_cap is not None:
        if kernel_cap % 8 or not 0 < kernel_cap < spec.cap:
            raise ValueError("kernel_cap must be a positive multiple of 8 below spec.cap")
        if overflow_cap % 8:
            raise ValueError("overflow_cap must be a multiple of 8")
        # the dense overflow pass selects pairs by distance over the whole
        # box, the stencil kernel within 27 cells: they agree iff every
        # interaction range fits one cell edge (dims of exactly 3 cells
        # are global)
        rng = max(float(lj.rcut), float(params.cfg.box_high[0]))
        for d in range(3):
            if spec.ncells[d] > 3 and spec.edge[d] + 1e-9 < rng:
                raise ValueError(
                    f"kernel_cap: cell edge {spec.edge[d]:.4f} along dim {d} "
                    f"is below the interaction range {rng:.4f}; build the "
                    "CellSpec with cutoff >= that range"
                )
    if mover_cap is None:
        mover_cap = max(256, -(-spec.n_atoms // 32))
    return CellStep(
        params, lp, lj, spec,
        do_hills=bool(static_do_hills),
        do_energy=True if energy_stride == 1 else bool(static_do_energy),
        do_rebuild=bool(static_do_rebuild),
        hill_capacity=hill_capacity, row_cap=row_cap, m_per_row=m_per_row,
        mover_cap=mover_cap, kernel_cap=kernel_cap, overflow_cap=overflow_cap,
    )
