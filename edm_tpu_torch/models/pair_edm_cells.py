"""Cell-list pairwise EDM — the production large-N host — in PyTorch.

Counterpart of ``edm_tpu/models/pair_edm_cells.py``: one device, or a rank
of the slab-sharded host.  The MD state lives in cell-slot order
``(Cg, cap, 3)`` between table rebuilds (Cg = cells padded to a multiple of
8, ``aid`` of length Cg*cap, exactly the JAX layout):

  1. BAOAB pre-force stages on the slot arrays; thermostat noise from the
     counter hash keyed by global slot row (``ops/hashrng``: the CUDA kernel
     ``hash_normals`` on the card);
  2. the force pass, by ``use_pallas``:
       - False (the JAX default): the XLA force pass in plain PyTorch — the
         27-stencil ordered-pair tiles of ``cell_chunk`` cells at a time
         (the JAX ``chunk_pairs``), LJ plus the exact Hermite or Chebyshev
         bias term, masked to the rdf type pair on typed runs, forces
         summed by row and the energy halved;
       - True: K1 (``ops/cellforce.cell_force_newton``), credits
         applied in the kernel — at ``kernel_cap`` rows/candidates plus K2
         (``overflow_force``) over the compacted tail list, or at full cap
         when the rebuild period's tail list overflowed (never-drop
         fallback), or untyped runs without ``kernel_cap``;
       - "newton": K6 (``cell_force_newton_planar``), the 13 credits
         subtracted afterwards (``newton_lattice_force``);
       - "full": K7 (``cell_force_full``), the 27-stencil ordered pairs of
         a state built with ``with_ids=True``; Chebyshev only, untyped;
     with ``types``/``type_pair`` (the XLA pass, K1 at full cap or K6) the
     CV term is kept only for the rdf type pair
     (fix_edm_pair.cpp:39-44,177-202);
  3. on hill steps: two-level hill collection (pass 1 through the CUDA
     kernels of ``ops/collect`` on the card, pass 2 a plain tile of the
     selected rows) and
     ``bias.add_hills_round``; untyped runs collect over half-stencil tiles
     (two acceptance draws per unordered pair), typed runs over the
     27-stencil (one draw per ordered candidate, {ti, tj} pairs only); with
     ``pair_lookup="chebyshev"`` the carried ``ChebTable`` is refit to the
     new grid at its degree and panels (the step's own force pass used the
     table carried in);
  4. on rebuild steps: the incremental slot-to-slot rebin (carrying the
     slot types), or the full argsort rebuild when the plan is infeasible
     (or would overflow the tail list); states with slot ids always take
     the full rebuild.

Each JAX ``lax.cond`` on a traced flag becomes a read of that flag on the
host.  A static phase step (``static_do_*`` True or False) reads only on
rebuild and hill steps: the rebin's feasibility (and, after a full
rebuild, ``tail_ovf``), and the capping loop's exit flag in
``add_hills_round``.  A dynamic step (any ``static_do_*`` None, the JAX
default) also reads the step counter once a call and picks its phase from
``step % stride`` as the JAX host's conds do; it then runs exactly what the
static phase of that step runs.  ``tail_ovf`` changes only at rebuilds, so
the state carries its host copy (``tail_ovf_host``) through the period; a
feasible rebin keeps the tail within ``overflow_cap`` by construction and
needs no read.  Each step counts its reads in ``step.host_syncs``; each
goes through ``utils/trace.read``, which with tracing on reads inside a
span ``edm.read.<site>``, as the step's parts run inside theirs
(``edm.step.<phase>``, ``edm.baoab``, ``edm.force``, ``edm.collect``,
``edm.refit``, ``edm.rebuild``).
``collect_records=True`` makes every step return ``(energy,
bias.HillRoundLog)`` for the HILLS log (``driver.run_simulation``).

Differences from the JAX state: the cached stencil planes (``mnf``,
``mkf``, ``tnf``, and the with-ids ``mn``/``nid``) are gone — the kernels
read the neighbours' occupancy, types and slot ids from the slot lattice
themselves, and the hill passes gather them with the coordinates; the
state keeps ``ts`` and ``sid`` and records ``kernel_cap`` and
``tail_ovf_host``.  The step owns its outputs: the force planes that K1
returns are updated in place by the tail pass.

``cell_diag`` reports the occupancy from one copy of the slot table to the
host.  ``make_cell_step(slab_axis=...)`` builds a rank's step of the
slab-sharded host (``parallel.make_slab_cell_step``): the force pass over
the rank's x-columns through K1's owned-row pass (``row_box``), the hill
collection and the BAOAB floor over them, psums and a gather over the mesh;
``make_cell_step(brick_axes=..., brick_ndev=...)`` a rank's step of the
brick host (``parallel.make_brick_cell_step``), the same over a 2-D or 3-D
grid of ranks, each owning a brick of cells (K1's owned-row pass over the
brick box of its halo window), the hill collection merged by global row
key.  ``axis_name`` sums each hill round's bias over a mesh axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import bias as B
from ..ops import prng
from ..grid import device_const
from ..ops.chebyshev import fit_gauss_grid
from ..ops.cellforce import (
    CELLS_PER_GROUP,
    box_cells,
    cell_force_full,
    cell_force_newton,
    cell_force_newton_planar,
    half_neighbors,
    hermite_pair_table,
    overflow_force,
    stencil_neighbors,
    subtract_credits,
    type_pair_mask,
)
from ..ops.collect import half_planes, p1_counts_half, p1_counts_typed, stencil_tile
from ..ops.hashrng import normal_rows_cols, seeds_from_key, uniform_rows_cols
from ..utils import trace
from ..utils.hills_log import to_host
from .cells import (
    CellSpec,
    _scatter_drop,
    apply_incremental_rebin,
    build_table,
    plan_incremental_rebin,
)
from .langevin import LangevinParams
from .lj import LJParams, lj_pair_terms, minimum_image
from .pair_edm import NO_KEY, PairEDMState, bias_pair_terms, extract_first
from ..parallel.collectives import all_gather, psum, psum_many
from ..parallel.mesh import mesh_of


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
    # host copy of tail_ovf (utils/checkpoint restores it from tail_ovf)
    tail_ovf_host: Optional[bool] = dataclasses.field(
        default=None, metadata={"host_copy_of": "tail_ovf"})
    ts: Optional[torch.Tensor] = None  # (Cg, cap) slot atom types (float, 0 =
    # empty): init_cell_state(types=...), for typed kernel runs
    sid: Optional[torch.Tensor] = None  # (Cg, cap) slot ids (the slot's atom
    # id as a float): init_cell_state(with_ids=True), for use_pallas="full"


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


def _types_tensor(types, n: int, device) -> torch.Tensor:
    """(N,) per-atom types on ``device``; integer types become int64."""
    t = types.to(device) if isinstance(types, torch.Tensor) else torch.as_tensor(
        np.asarray(types), device=device)
    if tuple(t.shape) != (n,):
        raise ValueError(f"types must have one entry per atom ({n}), got shape {tuple(t.shape)}")
    return t.long() if not t.is_floating_point() else t


def _slots_from_atoms(spec: CellSpec, Cg: int, x, v, f, aid_g, kernel_cap=None,
                      overflow_cap: int = 128, types=None, with_ids: bool = False) -> dict:
    """Gather atom arrays into slot layout; empty slots hold zeros.  Returns
    the state fields xs, vs, fs, mc, ts (from ``types``, 0 = empty), sid
    (the slot's atom id as a float, with ``with_ids``) and, with
    ``kernel_cap``, ovl and tail_count."""
    n = spec.n_atoms
    cap = spec.cap
    aid_c = torch.clamp(aid_g, 0, n - 1)
    aid2 = aid_g.reshape(Cg, cap)
    mc = (aid2 < n).to(x.dtype)
    out = dict(mc=mc, ts=None, sid=None)
    for name, a in (("xs", x), ("vs", v), ("fs", f)):
        out[name] = a[aid_c].reshape(Cg, cap, 3) * mc[..., None]
    if types is not None:
        t = types[aid_c].reshape(Cg, cap)
        out["ts"] = torch.where(aid2 < n, t, torch.zeros_like(t)).to(x.dtype)
    if with_ids:
        out["sid"] = aid2.to(x.dtype)
    if kernel_cap is not None:
        out["ovl"], out["tail_count"] = _tail_list(aid2, n, cap, kernel_cap, overflow_cap)
    return out


def _atoms_from_slots(spec: CellSpec, aid_g, xs, vs, fs):
    """Slot arrays back to atom order (each atom in exactly one slot)."""
    n = spec.n_atoms
    idx = torch.where(aid_g < n, aid_g, torch.full_like(aid_g, n))
    return tuple(_scatter_drop(n, 0.0, idx, a.reshape(-1, 3)) for a in (xs, vs, fs))


def atom_positions(spec: CellSpec, state: CellPairState) -> torch.Tensor:
    """Up-to-date atom-order positions (core.x is only rebuild-fresh)."""
    return _atoms_from_slots(spec, state.aid, state.xs, state.xs, state.xs)[0]


def cell_diag(spec: CellSpec, state: CellPairState, kernel_caps=(16, 24)) -> dict:
    """Host-side occupancy telemetry, the JAX ``cell_diag``'s dict: per-cell
    occupancy stats, the tail population ``sum_cells max(0, occ - K)`` for
    each K in ``kernel_caps`` (what sizes ``overflow_cap`` for a reduced
    ``kernel_cap``), and the state's carried tail and overflow flags.  The
    slot table and the flags come to the host in one copy."""
    tail = state.tail_count is not None
    leaves = (state.aid, state.table_overflow) + (
        (state.tail_count, state.tail_ovf, state.tail_fallbacks) if tail else ())
    host = to_host(leaves)
    aid2 = host[0].reshape(-1, spec.cap)
    occ = (aid2 < spec.n_atoms).sum(1)
    occ_real = occ[: spec.n_cells]
    d = {
        "n_cells": spec.n_cells,
        "cap": spec.cap,
        "occ_max": int(occ_real.max()),
        "occ_mean": float(occ_real.mean()),
        "occ_p99": float(np.percentile(occ_real, 99)),
        "occ_hist": np.bincount(occ_real, minlength=spec.cap + 1).tolist(),
        "tail_population": {int(k): int(np.maximum(0, occ_real - k).sum())
                            for k in kernel_caps},
        "cell_overflow": bool(host[1]),
    }
    if tail:
        d["state_tail_count"] = int(host[2])
        d["state_tail_ovf"] = bool(host[3])
        d["state_tail_fallbacks"] = int(host[4])
        d["overflow_cap"] = int(state.ovl.shape[0])
    return d


def _half_concat(plane, ncells, cap: int, cells=None):
    """(Cg, cap[, ...]) per-slot plane -> (B, 14cap[, ...]) candidate planes
    of the B cells ``cells`` (a slice or a tensor of cell ids; default every
    cell): the cell's own slots, then its 13 HALF_OFFSETS neighbours' slots
    (the JAX lattice rolls, as a gather)."""
    if cells is None:
        cells = slice(0, int(np.prod(ncells)))
    return half_planes(plane, half_neighbors(tuple(ncells), plane.device), cells)


def init_cell_state(spec: CellSpec, core: PairEDMState, with_ids: bool = False,
                    types=None, kernel_cap=None, overflow_cap: int = 128
                    ) -> CellPairState:
    """Bin the atoms and build the slot state.  ``with_ids`` keeps the slot
    ids that ``use_pallas="full"`` masks self pairs with; ``types`` (N,)
    keeps the slot type plane of typed runs (pass the same array to
    ``make_cell_step``).  ``kernel_cap`` / ``overflow_cap`` build the tail
    list for reduced-cap force passes (pass the same values to
    ``make_cell_step``); a tail beyond ``overflow_cap`` sets ``tail_ovf``
    and the period runs at full cap.  Reads ``tail_ovf`` once to the
    host."""
    Cg = _padded_cells(spec)
    n = spec.n_atoms
    dev = core.x.device
    if types is not None:
        types = _types_tensor(types, n, dev)
    table = build_table(spec, core.x)
    aid_g = torch.cat([table.aid, torch.full((Cg * spec.cap - spec.n_slots,), n,
                                             dtype=torch.int64, device=dev)])
    slots = _slots_from_atoms(spec, Cg, core.x, core.v, core.f, aid_g, kernel_cap,
                              overflow_cap, types, with_ids)
    if kernel_cap is not None:
        tail_ovf = slots["tail_count"] > overflow_cap
        slots.update(kernel_cap=kernel_cap, tail_ovf=tail_ovf,
                     tail_fallbacks=tail_ovf.to(torch.int64), tail_ovf_host=bool(tail_ovf))
    return CellPairState(core=core, aid=aid_g, table_overflow=table.overflow, **slots)


def shard_part(ncells, grid, coord, d: int):
    """(start, width, widest) of the share of lattice axis ``d`` that the
    rank at ``coord`` of a ``grid`` of ranks owns, in the balanced partition
    over the grid's ``p`` ranks along it (the first n % p own one more);
    (0, n, n) for an unsharded axis (``_brick_part``)."""
    n, p, i = ncells[d], grid[d], coord[d]
    if p == 1:
        return 0, n, n
    q, rem = divmod(n, p)
    return i * q + min(i, rem), q + (1 if i < rem else 0), -(-n // p)


def sub_lattice(a, ncells, idx):
    """The sub-lattice of a (Cg, cap[, 3]) slot plane at the per-axis cell
    indices ``idx`` (None: the whole axis), as a (cells, cap[, 3]) window
    lattice, x-major."""
    g = a[:int(np.prod(ncells))].reshape(tuple(ncells) + a.shape[1:])
    for d, ix in enumerate(idx):
        if ix is not None:
            g = g.index_select(d, ix)
    return g.reshape((-1,) + a.shape[1:])


def _window_mask(ncells, grid, coord, dims, lo, dtype, dev):
    """(prod(dims),) 1.0 at the window cells whose index along every
    sharded axis d lies in [lo, lo + width_d)."""
    m = torch.ones(dims, dtype=dtype, device=dev)
    for d in range(3):
        if grid[d] > 1:
            j = torch.arange(dims[d], device=dev)
            ok = ((j >= lo) & (j < lo + shard_part(ncells, grid, coord, d)[1])).to(dtype)
            m = m * ok.view([-1 if e == d else 1 for e in range(3)])
    return m.reshape(-1)


def shard_window(ncells, grid, coord, xs_c, mc_c):
    """The window of the rank at ``coord`` of a slab or brick ``grid`` of
    ranks, when the lattice is wide enough for one (the widest share plus 2
    fits every sharded axis), else None: its owned cells plus one halo cell
    a side along every sharded axis, the whole lattice along the others,
    taken from (Cg, cap_c[, 3]) planes.  Returns (window xs, window row mask
    (the halo and a ragged rank's surplus cells zeroed), window candidate
    mask, the per-axis lattice indices of the window (``sub_lattice``), its
    lattice dims, the row box ((h, h, h), (widest or n per axis)), h = 1 on
    sharded axes and 0 elsewhere)."""
    parts = [shard_part(ncells, grid, coord, d) for d in range(3)]
    halo = tuple(int(p > 1) for p in grid)
    if not any(halo) or any(h and parts[d][2] + 2 > ncells[d] for d, h in enumerate(halo)):
        return None
    dev = xs_c.device
    dims = tuple(parts[d][2] + 2 if halo[d] else ncells[d] for d in range(3))
    idx = [(parts[d][0] - 1 + torch.arange(dims[d], device=dev)) % ncells[d] if halo[d]
           else None for d in range(3)]
    sub, subm = sub_lattice(xs_c, ncells, idx), sub_lattice(mc_c, ncells, idx)
    rows = subm * _window_mask(ncells, grid, coord, dims, 1, subm.dtype, dev)[:, None]
    box = (halo, tuple(parts[d][2] if halo[d] else ncells[d] for d in range(3)))
    return sub, rows, subm, idx, dims, box


def newton_lattice_force(xs, mc_rows, ncells, box, lj, table, energy: bool = True, ts=None,
                         type_pair=None, rescredit: bool = False, mc_cand=None, row_box=None):
    """Half-stencil Newton force pass over the (nx, ny, nz) slot lattice at
    full cap: the JAX ``newton_lattice_force``.  ``mc_rows`` (Cg, cap) masks
    the slots that act as rows (enumerate pairs, receive row forces),
    ``mc_cand`` (default ``mc_rows``) those visible as neighbour-cell
    candidates: they differ on a sharded host, whose halo cells are
    candidates but not rows.  ``table`` a HermiteTable or a ChebTable;
    ``ts`` (Cg, cap) slot types with ``type_pair`` for the typed CV.
    ``rescredit=True`` runs K1 (credits applied in the kernel); False runs
    K6 and subtracts its 13 credits afterwards, offset by offset in
    HALF_OFFSETS order, as the JAX host's lattice rolls do (one mask only).
    ``row_box=((ox, oy, oz), (rx, ry, rz))`` (K1 only): rows over that
    owned sub-box of the lattice only — the row mask is compacted to the
    box's cells and K1's force planes span the whole window.  Returns
    (energy, f_rows (Cg, cap, 3)); padded cells are zeros."""
    if ts is None or type_pair is None:
        ts = type_pair = None
    kw = dict(ncells=ncells, box=box, lj=lj, energy=energy, ts=ts, type_pair=type_pair)
    if rescredit:
        if row_box is not None:
            rows = box_cells(tuple(ncells), row_box, xs.device)
            f, eb = cell_force_newton(xs, mc_rows[rows], table, k=xs.shape[1],
                                      mc_cand=mc_rows if mc_cand is None else mc_cand,
                                      row_box=row_box, **kw)
            return eb.sum(), f
        f, eb = cell_force_newton(xs, mc_rows, table, k=xs.shape[1], mc_cand=mc_cand, **kw)
        return eb.sum(), f
    if row_box is not None or (mc_cand is not None and mc_cand is not mc_rows):
        raise ValueError("row_box and a separate mc_cand need rescredit=True (K1)")
    f, cred, eb = cell_force_newton_planar(xs, mc_rows, table, **kw)
    C = int(np.prod(ncells))
    f[:C] = subtract_credits(f[:C], cred[:C], ncells)
    return eb.sum(), f


class CellStep:
    """One step of the cell host (``make_cell_step``): ``step(state) ->
    (new_state, bias_energy)``, or ``(new_state, (bias_energy,
    HillRoundLog))`` with ``collect_records``.  ``do_hills``, ``do_energy``
    and ``do_rebuild`` are True or False for a static stride phase, None to
    decide from ``state.core.step`` on each call.  ``host_syncs`` counts
    the values this step object has read back to the host."""

    def __init__(self, params: B.BiasParams, lp: LangevinParams, lj: LJParams,
                 spec: CellSpec, *, do_hills: Optional[bool], do_energy: Optional[bool],
                 do_rebuild: Optional[bool], hill_capacity: int, row_cap: int,
                 m_per_row: int, mover_cap: int, kernel_cap, overflow_cap: int,
                 use_pallas, types, type_pair, strides=(1, 1, 1),
                 collect_records: bool = False, cell_chunk: int = 32, mesh=None,
                 grid=(1, 1, 1), coord=(0, 0, 0), slab_collect: bool = True,
                 shard_floor: bool = True, row_cap_local: Optional[int] = None,
                 axis_name=None):
        self.params, self.lp, self.lj, self.spec = params, lp, lj, spec
        self.strides = strides  # the JAX host's (hill, rebuild, energy) strides
        self.do_hills, self.do_energy, self.do_rebuild = do_hills, do_energy, do_rebuild
        self.collect_records = collect_records
        self.hill_capacity, self.row_cap, self.m_per_row = hill_capacity, row_cap, m_per_row
        self.mover_cap = mover_cap
        self.kernel_cap, self.overflow_cap = kernel_cap, overflow_cap
        self.use_pallas = use_pallas
        self.cell_chunk = cell_chunk
        # the rdf type pair of the CV (both given, else untyped), as the
        # JAX host casts them; the per-atom types go to the card at first use
        self.types = None if types is None or type_pair is None else types
        self.type_pair = None if self.types is None else tuple(int(t) for t in type_pair)
        self._types_dev = None
        self._rows_dev = None  # the thermostat's slot rows (_slot_rows)
        self.Cg = _padded_cells(spec)
        c1 = float(np.exp(-lp.friction * lp.dt))
        self._c1 = c1
        self._c2 = float(np.sqrt(max(0.0, (1.0 - c1 * c1)) * lp.kT / lp.mass))
        self.host_syncs = 0
        # the sharded modes (make_cell_step(slab_axis=...) or brick_axes):
        # this rank's mesh, the ranks along each lattice axis (slab: (n, 1,
        # 1)) and this rank's place among them, the sharded hill collection
        # (untyped runs), the sharded BAOAB floor and the per-rank pass-2
        # row budget
        self.mesh = mesh
        self.grid, self.coord = tuple(grid), tuple(coord)
        self.shard_hills = mesh is not None and slab_collect and self.types is None
        self.shard_floor = mesh is not None and shard_floor
        self.row_cap_local = row_cap if row_cap_local is None else row_cap_local
        self.axis_name = axis_name  # the mesh axis the rounds' bias is summed over
        self._p1_rows = None  # pass 1's row cells and slot rows (_half_rows)
        self._span = trace.step_span(do_hills, do_energy, do_rebuild)

    def phases(self, step: int):
        """(hills, rebuild, energy): what the JAX host runs at ``step``."""
        hs, rs, es = self.strides
        return step % hs == 0, (step + 1) % rs == 0, es == 1 or step % es == 0

    def check_phase(self, pos: int, cycle: int):
        """Raise unless each static phase of this step is what the JAX
        host's dynamic step runs at step ``pos`` of a cycle of ``cycle``
        steps (``phases``), each such phase's stride dividing the cycle
        (``driver.pattern_segment``); a dynamic phase fits every place."""
        hs, rs, es = self.strides
        have = (self.do_hills, self.do_rebuild, self.do_energy)
        if any(h is not None and cycle % st for h, st in zip(have, (hs, rs, es))):
            raise ValueError(f"a {cycle}-step cycle is not a whole number of the "
                             f"strides (hill {hs}, rebuild {rs}, energy {es})")
        want = self.phases(pos)
        if any(h is not None and h != w for h, w in zip(have, want)):
            raise ValueError(
                f"step {pos} of the cycle runs (hills, rebuild, energy) = {have}, but "
                f"the strides (hill {hs}, rebuild {rs}, energy {es}) put {want} there")

    def __call__(self, state: CellPairState, _=None):
        with trace.span(self._span):
            return self._step(state)

    def _step(self, state: CellPairState):
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
        do_hills, do_energy, do_rebuild = self.do_hills, self.do_energy, self.do_rebuild
        if None in (do_hills, do_energy, do_rebuild):
            # the JAX host's lax.conds on step % stride, decided on the host
            want = self.phases(trace.read(self, "step_phase", core.step))
            do_hills, do_rebuild, do_energy = (w if h is None else h for h, w in zip(
                (do_hills, do_rebuild, do_energy), want))
        with trace.span(trace.BAOAB):
            key, sub_noise = prng.split(core.key)
            xs, vh = self._phase1(state, seeds_from_key(sub_noise))
        with trace.span(trace.FORCE):
            e_bias, fs = self._force(state, xs, do_energy)
        with trace.span(trace.BAOAB):
            vs = (vh + (0.5 * lp.dt / lp.mass) * fs) * state.mc[..., None]
        if not do_energy:  # carry the last computed bias energy
            e_bias = core.energy

        log = None
        if do_hills:
            with trace.span(trace.COLLECT):
                key, sub = prng.split(key)
                hills, runifs, active, ncalls, truncated = self._collect_hills(
                    state, xs, sub, core.last_calls, dtype
                )
            bias_state, rec, reads = B.add_hills_round(
                self.params, core.bias, hills[:, None], runifs,
                core.last_calls.to(dtype), active=active, axis_name=self.axis_name,
            )
            self.host_syncs += reads
            last_calls = ncalls
            # refit at the carried table's degree and panels
            cheb = None
            if core.cheb is not None:
                with trace.span(trace.REFIT):
                    cheb = fit_gauss_grid(bias_state.bias, core.cheb.deg, core.cheb.npanels)
            if self.collect_records:
                log = B.HillRoundLog(torch.ones((), dtype=torch.bool, device=xs.device),
                                     hills[:, None], rec)
        else:
            bias_state, last_calls, cheb = core.bias, core.last_calls, core.cheb
            truncated = torch.zeros((), dtype=torch.bool, device=xs.device)

        if do_rebuild:
            with trace.span(trace.REBUILD):
                upd = self._rebuild(state, xs, vs, fs)
        else:
            upd = dict(xs=xs, vs=vs, fs=fs)
        x_at, v_at, f_at = upd.pop("atoms", (core.x, core.v, core.f))
        new_core = PairEDMState(
            x=x_at, v=v_at, f=f_at, key=key, bias=bias_state,
            step=core.step + 1, last_calls=last_calls, energy=e_bias,
            hills_truncated=core.hills_truncated | truncated, cheb=cheb,
        )
        new_state = dataclasses.replace(state, core=new_core, **upd)
        if not self.collect_records:
            return new_state, e_bias
        if log is None:
            log = B.round_log_zeros(self.params, core.bias, self.hill_capacity)
        return new_state, (e_bias, log)

    # ----------------------------------------------------------- BAOAB

    def _phase1(self, state, seeds):
        """B-A-O-A stages on the slot arrays; padded slots stay pinned.  In
        the sharded modes with ``shard_floor`` each rank updates its owned
        cells only and one psum of (x, v) joins the disjoint windows."""
        if self.shard_floor:
            return self._phase1_shard(state, seeds)
        Cg, cap = state.mc.shape
        xi = normal_rows_cols(seeds, self._slot_rows(Cg * cap, state.xs.device), 3,
                              state.xs.dtype).reshape(Cg, cap, 3)
        x2, v2 = self._p1_update(state.xs, state.vs, state.fs, xi)
        m = state.mc[..., None]
        return x2 * m, v2 * m

    def _slot_rows(self, n: int, device) -> torch.Tensor:
        """The thermostat's row ids 0..n-1 on ``device``, made once."""
        if self._rows_dev is None or self._rows_dev.device != device or (
                self._rows_dev.shape[0] != n):
            self._rows_dev = torch.arange(n, device=device)
        return self._rows_dev

    def _p1_update(self, xs, vs, fs, xi):
        lp = self.lp
        v1 = vs + (0.5 * lp.dt / lp.mass) * fs  # B
        x1 = xs + (0.5 * lp.dt) * v1  # A
        v2 = self._c1 * v1 + self._c2 * xi  # O
        return x1 + (0.5 * lp.dt) * v2, v2  # A

    # ----------------------------------------------------------- sharded modes

    def _part(self, d: int):
        return shard_part(self.spec.ncells, self.grid, self.coord, d)

    def _sub(self, a, idx):
        return sub_lattice(a, self.spec.ncells, idx)

    def _window(self, xs_c, mc_c):
        return shard_window(self.spec.ncells, self.grid, self.coord, xs_c, mc_c)

    def _to_lattice(self, win, idx):
        """A window lattice at the per-axis indices ``idx`` (``_sub``) back
        onto the (Cg, ...) lattice; the other cells and the padded cells
        zeros (each axis' indices are distinct)."""
        ncells = tuple(self.spec.ncells)
        dev = win.device
        full = [torch.arange(n, device=dev) if ix is None else ix for n, ix in zip(ncells, idx)]
        out = win.new_zeros((self.Cg,) + win.shape[1:])
        out[:self.spec.n_cells].view(ncells + win.shape[1:])[
            full[0][:, None, None], full[1][None, :, None], full[2][None, None, :]] = win.view(
                tuple(len(ix) for ix in full) + win.shape[1:])
        return out

    def _phase1_shard(self, state, seeds):
        """``phase1_slab`` / ``phase1_brick``: the B-A-O-A stages over this
        rank's owned cells (a window of the widest share along each sharded
        axis from the rank's first cell, the surplus masked), the noise
        keyed by GLOBAL slot row, so the rank draws exactly the values of
        the replicated draw; one fused psum of the disjoint windows."""
        cap = self.spec.cap
        dev = state.xs.device
        ncells = self.spec.ncells
        parts = [self._part(d) for d in range(3)]
        idx = [None if self.grid[d] == 1 else (parts[d][0] + torch.arange(parts[d][2], device=dev))
               % ncells[d] for d in range(3)]
        cells = self._sub(torch.arange(self.spec.n_cells, device=dev), idx)
        rows = (cells[:, None] * cap + torch.arange(cap, device=dev)[None, :]).reshape(-1)
        xi = normal_rows_cols(seeds, rows, 3, state.xs.dtype).reshape(-1, cap, 3)
        x2, v2 = self._p1_update(self._sub(state.xs, idx), self._sub(state.vs, idx),
                                 self._sub(state.fs, idx), xi)
        dims = tuple(p[2] for p in parts)
        m = self._sub(state.mc, idx) * _window_mask(ncells, self.grid, self.coord, dims, 0,
                                                   state.xs.dtype, dev)[:, None]
        m = m[..., None]
        return psum_many([self._to_lattice(x2 * m, idx), self._to_lattice(v2 * m, idx)],
                         self.mesh)

    def _owns_cells(self) -> bool:
        return all(self._part(d)[1] > 0 for d in range(3))

    def _owned_box(self):
        """This rank's owned cells as a row box ((x0, y0, z0), (wx, wy, wz))
        of the lattice."""
        parts = [self._part(d) for d in range(3)]
        return tuple(p[0] for p in parts), tuple(p[1] for p in parts)

    def _owned_cells(self, dtype):
        """(Cg,) 1.0 at the cells this rank owns (disjoint over the mesh)."""
        nx, ny, nz = self.spec.ncells
        c = torch.arange(self.Cg, device=self.mesh.device)
        mine = c < self.spec.n_cells
        for d, co in enumerate((c // (ny * nz), (c // nz) % ny, c % nz)):
            if self.grid[d] > 1:
                start, width, _ = self._part(d)
                mine = mine & (co >= start) & (co < start + width)
        return mine.to(dtype)

    def _shard_rows(self, xs_c, mc_c, ts_c, tp, tbl, energy):
        """``slab_newton_force`` / ``brick_newton_force``'s local pass at
        slot cap ``xs_c.shape[1]``: (energy, f (Cg, cap_c, 3)) of this rank's
        owned rows, before the psum.  The window (``_window``), with its own
        periodic wrap along each sharded axis (a pair wrapped there is either
        the real wrap or beyond the cutoff: the cell edge is at least the
        interaction range), runs K1's owned-row pass over its row box; a
        lattice too small for a window runs K1 on the whole lattice with the
        rows masked to the owned cells.  A rank that owns no cell launches
        nothing."""
        spec, lj = self.spec, self.lj
        cap_c = xs_c.shape[1]
        if not self._owns_cells():
            return xs_c.new_zeros(()), xs_c.new_zeros((self.Cg, cap_c, 3))
        kw = dict(energy=energy, ts=ts_c, type_pair=tp, rescredit=True)
        window = self._window(xs_c, mc_c)
        if window is not None:
            sub, rows, subm, idx, ncells, row_box = window
            if ts_c is not None:
                kw["ts"] = self._sub(ts_c, idx)
            e, f_sub = newton_lattice_force(sub, rows, ncells, spec.box, lj, tbl, mc_cand=subm,
                                            row_box=row_box, **kw)
            return e, self._to_lattice(f_sub, idx)
        return newton_lattice_force(xs_c, mc_c * self._owned_cells(mc_c.dtype)[:, None],
                                    spec.ncells, spec.box, lj, tbl, mc_cand=mc_c, **kw)

    def _shard_force(self, state, xs, energy: bool):
        """The slab- or brick-sharded force pass: this rank's owned rows
        (K1; at ``kernel_cap`` plus K2 with the tail rows and partners
        masked to the owned cells, so that the sum counts each tail pair
        once; at full cap on a ``tail_ovf`` period), then one psum of the
        forces and the energy over the mesh."""
        tbl = self._table(state)
        ts, tp = self._kernel_types(state)
        kcap = self.kernel_cap
        if kcap is None or state.tail_ovf_host:
            with trace.span(trace.FORCE_K1):
                e, f = self._shard_rows(xs, state.mc, ts, tp, tbl, energy)
        else:
            with trace.span(trace.FORCE_K1):
                e, f_low = self._shard_rows(xs[:, :kcap].contiguous(),
                                            state.mc[:, :kcap].contiguous(), None, None, tbl,
                                            energy)
                f = torch.zeros_like(xs)
                f[:, :kcap] = f_low
            if self._owns_cells():
                with trace.span(trace.FORCE_TAIL):
                    fo, fp = overflow_force(*self._overflow_inputs(state, xs,
                                                                   self._owned_cells(xs.dtype)),
                                            tbl, box=self.spec.box, lj=self.lj, energy=energy)
                    f = self._assemble_tail(state, f, fo, fp)
                    e = e + fo[3].sum()
        f, e = psum_many([f, e.reshape(1)], self.mesh)
        return e[0], f

    # ----------------------------------------------------------- forces

    def _types_on(self, device) -> torch.Tensor:
        """The per-atom types (int64) on ``device``, copied once."""
        if self._types_dev is None or self._types_dev.device != device:
            self._types_dev = _types_tensor(self.types, self.spec.n_atoms, device).long()
        return self._types_dev

    def _slot_types(self, state) -> torch.Tensor:
        """(Cg, cap) slot types as floats, 0 = empty: the state's cached
        plane, else gathered from the per-atom types (the XLA pass and its
        typed hill collection need no cached plane, as in the JAX host)."""
        if state.ts is not None:
            return state.ts
        n = self.spec.n_atoms
        t = self._types_on(state.aid.device)[torch.clamp(state.aid, 0, n - 1)]
        t = torch.where(state.aid < n, t, torch.zeros_like(t))
        return t.to(state.xs.dtype).reshape(state.mc.shape)

    def _kernel_types(self, state):
        """(ts, type_pair) for the kernels: (None, None) when untyped."""
        if self.types is None:
            return None, None
        if state.ts is None:
            raise ValueError(
                "type-filtered kernel runs need the cached slot types: build "
                "the state with init_cell_state(..., types=types)"
            )
        return state.ts, self.type_pair

    def _table(self, state):
        """The kernels' lookup: the carried ChebTable, else the exact
        Hermite table of the live grid."""
        with trace.span(trace.FORCE_TABLE):
            tbl = state.core.cheb
            return hermite_pair_table(state.core.bias.bias) if tbl is None else tbl

    def _force(self, state, xs, energy: bool):
        """(bias energy, forces (Cg, cap, 3)) by ``use_pallas``: the XLA
        pass on False, K7 on "full", K6 and the credit subtraction on
        "newton", else K1 — plus K2 on reduced-cap periods.  The lookup is
        the carried ChebTable, else the exact Hermite table of the live
        grid."""
        spec, lj = self.spec, self.lj
        if self.mesh is not None:
            return self._shard_force(state, xs, energy)
        if not self.use_pallas:
            return self._xla_force(state, xs, energy)
        if self.use_pallas == "full":
            with trace.span(trace.FORCE_K1):
                return self._full_force(state, xs)
        tbl = self._table(state)
        ts, tp = self._kernel_types(state)
        if self.use_pallas == "newton":
            with trace.span(trace.FORCE_K1):
                return newton_lattice_force(xs, state.mc, spec.ncells, spec.box, lj, tbl,
                                            energy, ts=ts, type_pair=tp)
        kw = dict(box=spec.box, lj=lj, energy=energy)
        if self.kernel_cap is None or state.tail_ovf_host:
            with trace.span(trace.FORCE_K1):
                f, eb = cell_force_newton(xs, state.mc, tbl, k=spec.cap, ncells=spec.ncells,
                                          ts=ts, type_pair=tp, **kw)
                return eb.sum(), f
        kcap = self.kernel_cap
        with trace.span(trace.FORCE_K1):
            f, eb = cell_force_newton(xs, state.mc, tbl, k=kcap, ncells=spec.ncells, **kw)
            e = eb.sum()
        with trace.span(trace.FORCE_TAIL):
            fo, fp = overflow_force(*self._overflow_inputs(state, xs), tbl, **kw)
            return e + fo[3].sum(), self._assemble_tail(state, f, fo, fp)

    def _assemble_tail(self, state, f, fo, fp):
        """The tail assembly, in place on the force planes: K2's partner
        credits onto the low slots, the tail-atom forces into their slots
        (the sentinel id lands in a discarded extra row)."""
        Cg, cap = state.mc.shape
        S = Cg * cap
        kcap = self.kernel_cap
        f[:, :kcap] += fp.T.reshape(Cg, kcap, 3)
        f_pad = torch.cat([f.reshape(S, 3), f.new_zeros(1, 3)])
        f_pad.index_add_(0, state.ovl, fo[:3].T)
        return f_pad[:S].reshape(Cg, cap, 3)

    def _xla_force(self, state, xs, energy: bool):
        """``use_pallas=False``: the JAX host's XLA force pass.  Each chunk
        of ``cell_chunk`` cells evaluates its (B, cap, 27 cap) ordered-pair
        tile against the cells of its 27-stencil (``CellSpec.stencil()``
        order): minimum image, self and empty slots at r = inf, LJ, and the
        bias term of the exact Hermite lookup or the carried Chebyshev table
        (``pair_edm.bias_pair_terms``: zero at r = inf), kept only for the
        rdf type pair on typed runs; forces are the row sums, the energy
        half the sum of the pair values.  Padded cells get zero forces."""
        spec, lj, core = self.spec, self.lj, state.core
        n, cap, C = spec.n_atoms, spec.cap, spec.n_cells
        dev = xs.device
        nbr = stencil_neighbors(tuple(spec.ncells), dev)  # (C, 27)
        aid2 = state.aid.reshape(-1, cap)
        tslot = None if self.types is None else self._slot_types(state)
        f = torch.zeros_like(xs)
        e_b = []
        for c0 in range(0, C, self.cell_chunk):
            cells = torch.arange(c0, min(c0 + self.cell_chunk, C), device=dev)
            nb = nbr[cells]  # (B, 27)
            B_ = cells.shape[0]
            disp = minimum_image(xs[cells][:, :, None, :] - xs[nb].reshape(B_, 1, 27 * cap, 3),
                                 spec.box)
            r2 = torch.sum(disp * disp, dim=-1)  # (B, cap, 27 cap)
            ac = aid2[cells][:, :, None]
            an = aid2[nb].reshape(B_, 1, 27 * cap)
            valid = (ac < n) & (an < n) & (ac != an)
            inf = torch.full_like(r2, float("inf"))
            r = torch.sqrt(torch.where(valid, r2, inf))
            _, fmag = lj_pair_terms(lj, r)
            f_rows = torch.sum(fmag[..., None] * disp, dim=2)
            r_cv = r
            if tslot is not None:
                cv_ok = type_pair_mask(tslot[cells][:, :, None],
                                       tslot[nb].reshape(B_, 1, 27 * cap), self.type_pair)
                r_cv = torch.where(cv_ok, r, inf)
            e_pair, fb = bias_pair_terms(core, r_cv)
            f[cells] = f_rows + torch.sum(fb[..., None] * disp, dim=2)
            if energy:
                e_b.append(torch.sum(e_pair))
        e = 0.5 * torch.sum(torch.stack(e_b)) if energy else core.energy
        return e, f

    def _full_force(self, state, xs):
        """``use_pallas="full"``: K7 over the 27-stencil ordered pairs, the
        energy always evaluated and halved here (each pair seen twice)."""
        if state.sid is None:
            raise ValueError(
                'use_pallas="full" needs the stencil id masks: build the state '
                "with init_cell_state(..., with_ids=True)"
            )
        if state.core.cheb is None or self.types is not None:
            raise ValueError(
                'use_pallas="full" is Chebyshev-only and untyped; use the '
                "default Newton kernel"
            )
        spec = self.spec
        f, eb = cell_force_full(xs, state.mc, state.sid, state.core.cheb, ncells=spec.ncells,
                                box=spec.box, lj=self.lj)
        return 0.5 * eb.sum(), f

    def _overflow_inputs(self, state, xs, owncell=None):
        """K2's planes: the tail rows (x, y, z, mask, own) and every low
        slot (x, y, z, mask).  ``owncell`` (Cg,): a sharded rank's owned cells
        (``_overflow_pass``), to which the partners and the tail-tail rows
        are restricted."""
        Cg, cap = state.mc.shape
        S = Cg * cap
        kcap = self.kernel_cap
        mo = (state.ovl < S).to(xs.dtype)
        sid = torch.clamp(state.ovl, 0, S - 1)
        xo3 = xs.reshape(S, 3)[sid] * mo[:, None]
        own = mo if owncell is None else mo * owncell[sid // cap]
        mp = state.mc[:, :kcap] if owncell is None else state.mc[:, :kcap] * owncell[:, None]
        xo = torch.cat([xo3.T, mo[None], own[None]]).contiguous()
        xp = torch.cat([xs[:, :kcap].reshape(-1, 3).T, mp.reshape(1, -1)]).contiguous()
        return xo, xp

    # ----------------------------------------------------------- hills

    def _collect_hills(self, state, xs, key, last_calls, dtype):
        """The hill round's candidates: the 27-stencil collection on typed
        runs, else the half-stencil one.  Returns (hills (H,), runifs (H,),
        active (H,), ncalls, truncated)."""
        if self.types is not None:
            return self._collect_hills_typed(state, xs, key, last_calls, dtype)
        return self._collect_hills_half(state, xs, key, last_calls, dtype)

    def _accept_threshold(self, last_calls, dtype):
        hd = self.params.cfg.hill_density
        return None if hd < 0 else B._rdiv(hd, last_calls.to(dtype))

    def _select_rows(self, row_counts, rc=None, gids=None, sent=None):
        """Pass 1 -> pass 2: the first ``rc`` (default ``row_cap``) slot rows
        with an accepted candidate, in row order, and how many rows had one.
        ``gids``: the rows' global slot-row ids (default their positions),
        ``sent`` the sentinel (default the row count)."""
        rc = self.row_cap if rc is None else rc
        has = row_counts > 0
        rranks = torch.cumsum(has.to(torch.int64), 0) - 1
        if gids is None:
            sent = row_counts.shape[0]
            gids = torch.arange(sent, device=row_counts.device)
        tgt = torch.where(has & (rranks < rc), rranks, torch.full_like(rranks, rc))
        return _scatter_drop(rc, sent, tgt, gids), torch.sum(has.to(torch.int64))

    def _compact(self, acc, rvals, uvals, row_counts, n_rows, rc=None, row_ids=None):
        """``extract_first`` of the selected rows into ``hill_capacity``
        slots and the round's truncation flag; ``rc`` the row budget
        (default ``row_cap``).  Returns (hills, runifs, active, truncated,
        count, keys)."""
        hills, runifs, active, count, keys = extract_first(acc, rvals, uvals, self.hill_capacity,
                                                           self.m_per_row, row_ids)
        truncated = ((count > self.hill_capacity)
                     | (n_rows > (self.row_cap if rc is None else rc))
                     | torch.any(row_counts > self.m_per_row))
        return hills, runifs, active, truncated, count, keys

    def _half_rows(self, dev):
        """Pass 1's row cells, (B,) int64 global ids ascending (every cell,
        or this rank's owned box when the collection is sharded), and their
        (B cap,) global slot rows; made once per device."""
        if self._p1_rows is None or self._p1_rows[0].device != dev:
            spec = self.spec
            if not self.shard_hills:
                cells = torch.arange(spec.n_cells, device=dev)
            elif self._owns_cells():  # x-major over the owned box
                cells = box_cells(spec.ncells, self._owned_box(), dev)
            else:
                cells = torch.zeros(0, dtype=torch.int64, device=dev)
            gids = (cells[:, None] * spec.cap + torch.arange(spec.cap, device=dev)).reshape(-1)
            self._p1_rows = cells, gids
        return self._p1_rows

    def _collect_hills_half(self, state, xs, key, last_calls, dtype):
        """Two-level hill collection over half-stencil tiles: each unordered
        pair once (self block strictly upper, 13 positive neighbours) with
        two acceptance uniforms (the reference's two ordered candidates,
        fix_edm_pair.cpp:229-237).  Pass 1 counts accepted candidates per
        slot row (``ops/collect.p1_counts_half``); pass 2 re-derives
        the same draws on the selected rows and extracts the first
        ``m_per_row`` per row in column order.

        Sharded modes (``slab_collect``): both passes run over this rank's
        owned cells only, with the draws and the row selection keyed by
        GLOBAL slot row (sentinel C * cap) and pass 2 on ``row_cap_local``
        rows.  A slab rank owns a contiguous ascending range of the x-major
        cell order, so the ranks' compacted lists gathered in rank order and
        compacted again to the first ``hill_capacity`` replay the
        single-device round bitwise, truncation at capacity included.  A
        brick rank's cells are not contiguous: each hill carries its global
        key (slot row * m_per_row + its place in the row), and the gathered
        lists are merged by a stable sort of the keys, which is the
        single-device order (a hill of global rank < capacity has a rank <
        capacity on its own rank too, so it survives the rank's compaction).
        count, ncalls and the truncation flag are psums."""
        spec, params = self.spec, self.params
        cap = spec.cap
        C = spec.n_cells
        W = 14 * cap
        dev = xs.device
        seeds = seeds_from_key(key)
        thresh = self._accept_threshold(last_calls, dtype)
        bmax2 = params.cfg.box_high[0] * params.cfg.box_high[0]
        box = device_const(spec.box, dev, dtype)
        brick = self.shard_hills and self.grid[1:] != (1, 1)
        rc = self.row_cap_local if self.shard_hills else self.row_cap
        cells, gids = self._half_rows(dev)
        nbr = half_neighbors(tuple(spec.ncells), dev)

        # pass 1: accepted candidates per slot row of the (owned) cells,
        # read from the slot lattice
        with trace.span(trace.COLLECT_PASS1):
            row_counts, ncalls = p1_counts_half(xs, state.mc, cells, nbr, box, bmax2, thresh,
                                                seeds)
        with trace.span(trace.COLLECT_PASS2):
            sent = C * cap  # the global slot-row sentinel
            rows_sel, n_rows = self._select_rows(row_counts, rc, gids, sent)

            # pass 2 on the selected slot rows: their cells' candidates gathered
            # from the lattice by global id (the sentinel's clamped, masked)
            rows_c = torch.clamp(rows_sel, 0, sent - 1)
            cells_c = rows_c // cap
            slot_c = (rows_c % cap)[:, None]
            cand = torch.cat([cells_c[:, None], nbr[cells_c]], 1)  # (rc, 14) cells, column order
            ms = state.mc[cand].reshape(rc, W) > 0.5
            r2 = 0.0
            for c in range(3):
                sl = xs[..., c][cand].reshape(rc, W)
                dd = sl.gather(1, slot_c) - sl
                dd = dd - torch.round(dd / box[c]) * box[c]
                r2 = r2 + dd * dd
            ci = torch.arange(W, device=dev)
            upper = (ci >= cap) | (ci > slot_c)  # the self block strictly upper: each pair once
            ok = (rows_sel < sent)[:, None] & ms.gather(1, slot_c) & ms & upper & (r2 < bmax2)
            r = torch.sqrt(torch.where(ok, r2, torch.full_like(r2, float("inf"))))
            u = uniform_rows_cols(seeds, rows_c, 2 * W, dtype).reshape(rc, W, 2)
            acc = ok[..., None].expand(ok.shape + (2,))
            acc = (acc if thresh is None else acc & (u < thresh)).reshape(rc, 2 * W)
            r21 = r[:, :, None].expand(rc, W, 2)  # r[w] at columns 2w, 2w+1
            hills, runifs, active, truncated, count, keys = self._compact(
                acc, r21, u, row_counts, n_rows, rc, rows_sel if brick else None)
            if not self.shard_hills:
                return hills, runifs, active, ncalls, truncated
            return self._gather_round(hills, runifs, active, count, ncalls, truncated, keys)

    def _gather_round(self, hills, runifs, active, count, ncalls, truncated, keys=None):
        """The ranks' compacted lists gathered in rank order (one
        all_gather) and merged to the first ``hill_capacity``: in rank
        order, or with ``keys`` by a stable sort of the hills' global keys
        (a second all_gather); count, ncalls and the truncation flag summed
        (one psum)."""
        mesh, hc = self.mesh, self.hill_capacity
        dtype = hills.dtype
        g = all_gather(torch.stack([hills, runifs, active.to(dtype)])[None], mesh)
        hills_g, runifs_g, active_g = (g[:, i].reshape(-1) for i in range(3))
        active_g = active_g > 0.5
        total, ncalls, n_trunc = psum(torch.stack([count, ncalls, truncated.to(torch.int64)]),
                                      mesh)
        if keys is None:
            granks = torch.cumsum(active_g.to(torch.int64), 0) - 1
            gtgt = torch.where(active_g & (granks < hc), granks, torch.full_like(granks, hc))
            hills = _scatter_drop(hc, 0.0, gtgt, hills_g)
            runifs = _scatter_drop(hc, 1.0, gtgt, runifs_g)
        else:
            keys_g = torch.where(active_g, all_gather(keys, mesh),
                                 torch.full_like(active_g, NO_KEY, dtype=torch.int64))
            order = torch.sort(keys_g, stable=True).indices[:hc]
            hills, runifs = hills_g[order], runifs_g[order]
        active = torch.arange(hc, device=hills.device) < total
        return hills, runifs, active, ncalls, (n_trunc > 0) | (total > hc)

    def _collect_hills_typed(self, state, xs, key, last_calls, dtype):
        """The typed runs' 27-stencil collection (the JAX ``collect_hills``
        with ``chunk_pairs``' typed branch): every ordered candidate of a
        slot row (27 * cap, CellSpec.stencil() order) with one acceptance
        uniform, self pairs masked by atom id, candidates only within the
        CV's type pair.  Pass 1 counts per slot row
        (``ops/collect.p1_counts_typed``); pass 2 redraws on the selected
        rows and extracts as the half-stencil collection does."""
        spec, params = self.spec, self.params
        n, cap, C = spec.n_atoms, spec.cap, spec.n_cells
        W = 27 * cap
        dev = xs.device
        seeds = seeds_from_key(key)
        thresh = self._accept_threshold(last_calls, dtype)
        bmax = params.cfg.box_high[0]
        box = device_const(spec.box, dev, dtype)
        nbr = stencil_neighbors(tuple(spec.ncells), dev)  # (C, 27)
        aid2 = state.aid.reshape(-1, cap)
        tslot = self._slot_types(state)  # 0 = empty

        # pass 1: ordered candidates and accepted draws per slot row
        with trace.span(trace.COLLECT_PASS1):
            row_counts, ncalls = p1_counts_typed(xs, state.aid, tslot, nbr, box, bmax * bmax,
                                                 thresh, seeds, n, self.type_pair)
        with trace.span(trace.COLLECT_PASS2):
            rows_sel, n_rows = self._select_rows(row_counts)

            # pass 2 on the selected slot rows
            sent = C * cap
            rows_c = torch.clamp(rows_sel, 0, sent - 1)
            flat_aid, flat_t = aid2.reshape(-1), tslot.reshape(-1)
            r2, valid, cv = stencil_tile(xs, aid2, tslot, nbr, box, n, self.type_pair,
                                         xs.reshape(-1, 3)[rows_c], flat_aid[rows_c],
                                         flat_t[rows_c], rows_c // cap)
            valid = (rows_sel < sent)[:, None] & valid
            inf = torch.full_like(r2, float("inf"))
            r = torch.where(cv, torch.sqrt(torch.where(valid, r2, inf)), inf)
            u = uniform_rows_cols(seeds, rows_c, W, dtype)
            acc = torch.isfinite(r) & (r < bmax)
            acc = acc if thresh is None else acc & (u < thresh)
            hills, runifs, active, truncated, _, _ = self._compact(acc, r, u, row_counts, n_rows)
            return hills, runifs, active, ncalls, truncated

    # ----------------------------------------------------------- rebuilds

    def _tail_fields(self, state, tail_count):
        t_ovf = tail_count > self.overflow_cap
        return dict(tail_count=tail_count, tail_ovf=t_ovf,
                    tail_fallbacks=state.tail_fallbacks + t_ovf.to(torch.int64))

    def _rebuild(self, state, xs, vs, fs):
        """Incremental rebin when feasible (and, with ``kernel_cap``, when
        it keeps the tail within ``overflow_cap``), else the full argsort
        rebuild, which also refreshes core.x/v/f.  States with slot ids
        always rebuild fully (only the full rebuild makes the ids).  Returns
        the updated state fields."""
        spec = self.spec
        n, cap, Cg = spec.n_atoms, spec.cap, self.Cg
        S = Cg * cap
        kcap = self.kernel_cap
        if state.sid is None:
            with trace.span(trace.REBUILD_PLAN):
                plan = plan_incremental_rebin(spec, Cg, state.aid, xs, self.mover_cap)
                feasible = plan.feasible
                if kcap is not None:
                    # a mover whose source AND destination are tail slots cancels
                    leave = torch.sum((plan.m_src < S) & (plan.m_src % cap >= kcap))
                    arrive = torch.sum((plan.m_dest < S) & (plan.m_dest % cap >= kcap))
                    feasible = feasible & (state.tail_count - leave + arrive
                                           <= self.overflow_cap)
                feasible = trace.read(self, "rebin_feasible", feasible)
            if feasible:
                trace.count("rebuild.rebin")
                with trace.span(trace.REBUILD_REBIN):
                    return self._rebin(state, plan, xs, vs, fs)

        trace.count("rebuild.full")
        with trace.span(trace.REBUILD_FULL):
            x_at, v_at, f_at = _atoms_from_slots(spec, state.aid, xs, vs, fs)
            t = build_table(spec, x_at)
            aid_g = torch.cat([t.aid, torch.full((S - spec.n_slots,), n, dtype=torch.int64,
                                                 device=xs.device)])
            types = (self._types_on(xs.device)
                     if state.ts is not None and self.types is not None else None)
            upd = _slots_from_atoms(spec, Cg, x_at, v_at, f_at, aid_g, kcap, self.overflow_cap,
                                    types, state.sid is not None)
            upd.update(aid=aid_g, table_overflow=state.table_overflow | t.overflow,
                       atoms=(x_at, v_at, f_at))
            if kcap is not None:
                upd.update(self._tail_fields(state, upd["tail_count"]))
                upd["tail_ovf_host"] = trace.read(self, "tail_ovf", upd["tail_ovf"])
            return upd

    def _rebin(self, state, plan, xs, vs, fs):
        """The incremental rebin's state fields: the slot arrays (and the
        slot types) moved with the plan."""
        spec = self.spec
        n, cap, Cg = spec.n_atoms, spec.cap, self.Cg
        S = Cg * cap
        arrays = [a.reshape(S, 3) for a in (xs, vs, fs)]
        if state.ts is not None:
            arrays.append(state.ts.reshape(S))
        aid_new, outs = apply_incremental_rebin(spec, plan, state.aid, arrays)
        mc = (aid_new.reshape(Cg, cap) < n).to(xs.dtype)
        upd = dict(aid=aid_new, mc=mc)
        for name, a in zip(("xs", "vs", "fs"), outs):
            upd[name] = a.reshape(Cg, cap, 3) * mc[..., None]
        if state.ts is not None:
            upd["ts"] = outs[3].reshape(Cg, cap) * mc
        if self.kernel_cap is not None:
            ovl, tail_count = _tail_list(aid_new.reshape(Cg, cap), n, cap, self.kernel_cap,
                                         self.overflow_cap)
            # the feasibility test bounded the new tail by overflow_cap
            upd.update(ovl=ovl, tail_ovf_host=False, **self._tail_fields(state, tail_count))
        return upd


def make_cell_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    spec: CellSpec,
    hill_stride: int,
    rebuild_stride: int = 10,
    hill_capacity: int = 2048,
    cell_chunk: int = 32,
    row_cap: int = 2048,
    m_per_row: int = 16,
    axis_name: Optional[str] = None,
    cheb_deg: int = 64,
    types=None,
    type_pair=None,
    use_pallas=False,
    collect_records: bool = False,
    energy_stride: int = 1,
    slab_axis: Optional[str] = None,
    slab_ndev: int = 1,
    mover_cap: Optional[int] = None,
    slab_collect: bool = True,
    brick_axes=None,
    brick_ndev=(1, 1),
    shard_floor: bool = True,
    row_cap_local: Optional[int] = None,
    static_do_hills: Optional[bool] = None,
    static_do_energy: Optional[bool] = None,
    static_do_rebuild: Optional[bool] = None,
    kernel_cap: Optional[int] = None,
    overflow_cap: int = 128,
) -> CellStep:
    """Build a step of the cell host, with the JAX signature and defaults.

    ``static_do_hills`` / ``static_do_energy`` / ``static_do_rebuild``: True
    or False build a static stride phase, the fast path.  The caller drives
    the phases in their cycle (``driver.pattern_segment``), so a
    ``static_do_hills=True`` step deposits and a ``static_do_rebuild=True``
    step rebins whatever ``state.step`` is; ``pattern_segment`` checks that
    each step sits where the JAX host's ``hill_stride``, ``rebuild_stride``
    and ``energy_stride`` would run the same phase
    (``CellStep.check_phase``).  None (the default) decides that phase on
    each call from ``state.core.step``, which the step reads back once a
    call, and runs what the static phase would.  ``energy_stride == 1``
    evaluates the bias energy on every step; otherwise only on energy steps,
    the last value carried through the others (forces are identical either
    way).  ``collect_records``: each step returns ``(energy,
    bias.HillRoundLog)``, zeros on steps without a round.  ``use_pallas``: False
    (the default: the XLA force pass, ``cell_chunk`` cells at a time), True
    (K1, with K2 under ``kernel_cap``), "newton" (K6 and the credit
    subtraction) or "full" (K7; a state built with ``with_ids=True`` and a
    Chebyshev table).
    ``types`` (N,) and ``type_pair`` (ti, tj), both given, restrict the CV
    to that rdf type pair; the kernel paths need the state's slot types
    (``init_cell_state(..., types=types)``), the XLA pass gathers them from
    ``types``.  ``kernel_cap``/``overflow_cap`` as in the JAX host
    (``use_pallas=True``, untyped).  ``cell_chunk`` chunks the XLA force
    pass; the JAX host also scans its hill collection's pass 1 by it, the
    port runs pass 1 in one kernel launch on the card (``ops/collect``; the
    plain version in chunks of ``collect.P1_DRAWS``, the same values).
    ``cheb_deg`` changes nothing: a hill round refits at the carried
    table's degree.

    ``slab_axis``/``slab_ndev``: the slab-sharded host
    (``parallel.make_slab_cell_step``) — this rank's step over the mesh
    registered under ``slab_axis`` (``parallel.make_mesh``; ``slab_ndev``
    ranks), every rank running it on its replica of the state: the force
    pass over the rank's balanced share of x-columns plus a halo column a
    side through K1's owned-row pass (and K2 masked to the owned cells
    under ``kernel_cap``), one psum of the forces and the energy; with
    ``slab_collect`` (untyped runs) the hill collection over the owned
    columns, gathered in rank order, bitwise the replicated round; with
    ``shard_floor`` the BAOAB pre-force stages over the owned columns and
    one fused (x, v) psum, and pass 2 on ``row_cap_local`` rows (default
    ``row_cap`` times the widest rank's share of the columns, at least 64,
    rounded up to 8).  Needs ``use_pallas``.

    ``brick_axes``/``brick_ndev``: the brick host
    (``parallel.make_brick_cell_step``) over the (px, py[, pz]) mesh
    registered under the tuple ``brick_axes`` (``parallel.make_brick_mesh``):
    as the slab host, but each rank owns a balanced x-range by y-range (by
    z-range) of cells and its window adds one halo cell a side along every
    sharded axis (an axis of one rank, and z of a 2-D brick, stays whole and
    periodic); K1 runs its owned-row pass over the brick box ((1, 1, h_z),
    widest shares), and the hill collection merges the ranks' lists by
    global row key.  Needs ``use_pallas``.  ``axis_name``: the mesh axis
    over which each hill round's bias is summed into ``cum_bias``
    (``bias.add_hills_round``)."""
    if hill_stride < 1 or rebuild_stride < 1 or energy_stride < 1:
        raise ValueError("hill_stride, rebuild_stride and energy_stride must be >= 1")
    if use_pallas not in (False, None, True, "newton", "full"):
        raise ValueError(f'use_pallas must be False, True, "newton" or "full", got {use_pallas!r}')
    if cell_chunk < 1:
        raise ValueError("cell_chunk must be >= 1")
    if brick_axes is not None and slab_axis is not None:
        raise ValueError("brick_axes and slab_axis are mutually exclusive")
    mesh, grid, coord = None, (1, 1, 1), (0, 0, 0)
    if slab_axis is not None:
        if not use_pallas:
            raise ValueError("slab mode requires use_pallas")
        mesh = mesh_of(slab_axis)
        if mesh.size != slab_ndev:
            raise ValueError(f"slab_ndev={slab_ndev} but the mesh over {slab_axis!r} has "
                             f"{mesh.size} ranks")
        grid, coord = (slab_ndev, 1, 1), (mesh.rank, 0, 0)
    elif slab_ndev != 1:
        raise ValueError("slab_ndev needs slab_axis")
    if brick_axes is not None:
        if not use_pallas:
            raise ValueError("brick mode requires use_pallas")
        brick_axes, brick_ndev = tuple(brick_axes), tuple(int(p) for p in brick_ndev)
        if len(brick_axes) not in (2, 3) or len(brick_axes) != len(brick_ndev):
            raise ValueError("brick_axes/brick_ndev must be 2-D or 3-D")
        mesh = mesh_of(brick_axes)
        if mesh.shape != brick_ndev or mesh.axis_names != brick_axes:
            raise ValueError(f"brick_ndev={brick_ndev} over {brick_axes} but the mesh is "
                             f"{mesh.shape} over {mesh.axis_names}")
        # a 2-D brick is a 3-D brick with pz = 1 (z unsharded)
        grid = brick_ndev + (1,) * (3 - len(brick_ndev))
        coord = tuple(mesh.axis_index(a) for a in brick_axes) + (0,) * (3 - len(brick_axes))
    if mesh is not None and row_cap_local is None:
        row_cap_local = row_cap
        if mesh.size > 1 and shard_floor:  # the widest rank's share of the cells
            frac = (int(np.prod([-(-n // p) for n, p in zip(spec.ncells, grid)]))
                    / int(np.prod(spec.ncells)))
            row_cap_local = min(row_cap, max(64, (int(row_cap * frac) + 7) // 8 * 8))
    if kernel_cap is not None:
        if use_pallas is not True:
            raise ValueError("kernel_cap requires the default Newton kernel path (use_pallas=True)")
        if types is not None and type_pair is not None:
            raise ValueError("kernel_cap does not support type-filtered runs")
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
    if min(spec.ncells) < 3:
        raise ValueError(
            "cell list needs >= 3 cells per dim (box >= 3x interaction "
            "range); use the dense/blocked host for small boxes"
        )
    if mover_cap is None:
        mover_cap = max(256, -(-spec.n_atoms // 32))
    return CellStep(
        params, lp, lj, spec,
        do_hills=None if static_do_hills is None else bool(static_do_hills),
        do_energy=(True if energy_stride == 1 else
                   None if static_do_energy is None else bool(static_do_energy)),
        do_rebuild=None if static_do_rebuild is None else bool(static_do_rebuild),
        hill_capacity=hill_capacity, row_cap=row_cap, m_per_row=m_per_row,
        mover_cap=mover_cap, kernel_cap=kernel_cap, overflow_cap=overflow_cap,
        use_pallas=use_pallas, types=types, type_pair=type_pair,
        strides=(hill_stride, rebuild_stride, energy_stride),
        collect_records=collect_records, cell_chunk=cell_chunk, mesh=mesh, grid=grid,
        coord=coord, slab_collect=slab_collect, shard_floor=shard_floor,
        row_cap_local=row_cap_local, axis_name=axis_name,
    )
