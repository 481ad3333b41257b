"""Sharded cell-list pairwise EDM: the slab, brick and work-sharded hosts.

Counterpart of ``edm_tpu/parallel/cells.py``.  Each rank is a process that
runs the step on its replica of the state (``parallel.launch``); every rank
must run every step.

``make_slab_cell_step`` is the JAX package's production multi-chip force
path: the slot-resident cell host (``models/pair_edm_cells``, same state,
same physics, the same K1) with the force pass slab-decomposed over the
mesh's x-columns, one psum of the slot forces a step; by default
(``slab_collect``) the hill collection over the same columns, gathered in
rank order (bitwise the replicated round), and (``shard_floor``) the BAOAB
pre-force stages over them, one fused psum.  Deposition and rebuilds run
replicated and deterministic, so every rank's state stays bitwise rank 0's.
``make_brick_cell_step`` is the same host over a 2-D or 3-D grid of ranks
(``parallel.make_brick_mesh``): each rank owns a brick of cells plus a
one-cell halo along every sharded axis, K1 runs its owned-row pass over the
brick box, and the hill collection merges the ranks' lists by global row
key.

``make_sharded_cell_step`` is the work-sharded host: the atom-order state
(``ShardedCellPairState``) is replicated, the cell chunks are split over the
ranks, and each rank computes the pair forces of its chunks' atoms against
the replicated positions in plain PyTorch (JAX leaves this host to XLA),
the per-atom forces and the energy summed over the mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import bias as B
from ..models.cells import CellSpec, _scatter_drop, build_table
from ..models.driver import check_hill_phase
from ..models.langevin import LangevinParams, baoab_step
from ..models.lj import LJParams, lj_pair_terms, minimum_image
from ..models.pair_edm import PairEDMState, bias_pair_terms, extract_first
from ..ops import prng
from ..ops.cellforce import stencil_neighbors
from ..ops.chebyshev import fit_gauss_grid
from .collectives import all_gather, psum, psum_many
from .mesh import DATA_AXIS, Mesh


def make_slab_cell_step(params, lp, lj, spec, hill_stride: int, mesh: Mesh, **kw):
    """This rank's step of the slab-sharded cell host over ``mesh``:
    ``models.pair_edm_cells.make_cell_step(..., slab_axis=mesh's axis,
    slab_ndev=mesh.size, **kw)`` with ``use_pallas=True`` by default.  It
    drives ``init_cell_state`` state, replicated on every rank; every rank
    must run every step.  It returns ``(state, energy)``, or ``(state,
    (energy, HillRoundLog))`` with ``collect_records`` — the same log on
    every rank (the rounds are replicated): write files from rank 0.  The
    step is a ``CellStep``: ``driver.pattern_segment`` and
    ``run_simulation`` drive it as they drive the single-device step
    (``phases``, ``check_phase``, the static phases)."""
    from ..models.pair_edm_cells import make_cell_step

    kw.setdefault("use_pallas", True)
    return make_cell_step(params, lp, lj, spec, hill_stride, slab_axis=mesh.axis_names[0],
                          slab_ndev=mesh.size, **kw)


def make_brick_cell_step(params, lp, lj, spec, hill_stride: int, mesh: Mesh, **kw):
    """This rank's step of the brick-decomposed cell host over a 2-D (px,
    py) or 3-D (px, py, pz) ``mesh`` (``parallel.make_brick_mesh``):
    ``make_cell_step(..., brick_axes=mesh.axis_names, brick_ndev=
    mesh.devices.shape, **kw)`` with ``use_pallas=True`` by default.  Each
    rank owns a balanced x-range by y-range (by z-range) of cells; its
    window adds one halo cell a side along every sharded axis, where the
    slab's adds them along x only, so the halo share is ~sum_d 2 / w_d.
    Same state, outputs and contract as ``make_slab_cell_step``."""
    from ..models.pair_edm_cells import make_cell_step

    kw.setdefault("use_pallas", True)
    return make_cell_step(params, lp, lj, spec, hill_stride, brick_axes=mesh.axis_names,
                          brick_ndev=mesh.shape, **kw)


@dataclasses.dataclass(frozen=True)
class ShardedCellPairState:
    """The work-sharded host's state, replicated on every rank: the
    atom-order core and the cell table (the single-device host moved to a
    slot-resident layout; this host splits cell chunks over the ranks)."""

    core: PairEDMState
    aid: torch.Tensor  # (C*cap,) int64 slot -> atom id (n_atoms = empty)
    table_overflow: torch.Tensor  # bool: a cell exceeded cap (atoms dropped)


def init_sharded_cell_state(spec: CellSpec, core: PairEDMState) -> ShardedCellPairState:
    """Bin the atoms of ``core`` (on its device)."""
    table = build_table(spec, core.x)
    return ShardedCellPairState(core=core, aid=table.aid, table_overflow=table.overflow)


class WorkShardedCellStep:
    """This rank's step of the work-sharded cell host
    (``make_sharded_cell_step``): ``step(state) -> (new_state, energy)``,
    or ``(new_state, (energy, HillRoundLog))`` with ``collect_records``.
    ``do_hills`` / ``do_rebuild``: True or False for a static stride phase,
    None to decide from ``state.core.step`` (one host read a call).

    Rank r owns the cells [r, r + 1) * chunks * cell_chunk of the lattice
    padded to Cp = n_ranks * chunks * cell_chunk cells.  The forces of its
    rows are written into the per-atom array with an indexed write, not an
    accumulation: each atom lies in exactly one slot, so the scatter is a
    permutation (the empty slots all land in one discarded spare row) and
    needs neither atomics nor an order, which keeps a repeated run bitwise;
    the ranks' arrays are then summed in rank order (``psum``)."""

    def __init__(self, params, lp, lj, spec, hill_stride, mesh, rebuild_stride, hill_capacity,
                 cell_chunk, row_cap, m_per_row, collect_records, do_hills, do_rebuild):
        self.params, self.lp, self.lj, self.spec, self.mesh = params, lp, lj, spec, mesh
        self.hill_stride, self.rebuild_stride = hill_stride, rebuild_stride
        self.hill_capacity, self.row_cap, self.m_per_row = hill_capacity, row_cap, m_per_row
        self.cell_chunk, self.collect_records = cell_chunk, collect_records
        self.do_hills, self.do_rebuild = do_hills, do_rebuild
        self.chunks = -(-spec.n_cells // (mesh.size * cell_chunk))  # per rank
        self.Cp = self.chunks * cell_chunk * mesh.size
        self.c0 = mesh.rank * self.chunks * cell_chunk  # this rank's first cell
        self.host_syncs = 0
        self._stencil = None  # (Cp, 27) padded stencil, on the state's device

    def check_phase(self, pos: int, cycle: int):
        """Raise unless the JAX host runs this step's static phases at step
        ``pos`` of a ``cycle``-step cycle (hills at ``step % hill_stride ==
        0``, rebuilds at ``(step + 1) % rebuild_stride == 0``)."""
        check_hill_phase(self.do_hills, self.hill_stride, pos, cycle)
        rs = self.rebuild_stride
        if self.do_rebuild is not None and (cycle % rs or self.do_rebuild != ((pos + 1) % rs == 0)):
            raise ValueError(f"step {pos} of a {cycle}-step cycle: rebuild={self.do_rebuild} is "
                             f"not where rebuild_stride {rs} puts it")

    def _tables(self, state, x):
        """(Cp, cap, 3) slot positions and (Cp, cap) atom ids of the padded
        lattice (the padded stencil made at first use)."""
        spec = self.spec
        n, cap, C = spec.n_atoms, spec.cap, spec.n_cells
        dev = x.device
        if self._stencil is None or self._stencil.device != dev:
            nbr = stencil_neighbors(tuple(spec.ncells), dev)
            self._stencil = torch.cat([nbr, nbr.new_zeros((self.Cp - C, 27))])
        xs3 = torch.cat([x[torch.clamp(state.aid, 0, n - 1)].reshape(C, cap, 3),
                         x.new_zeros((self.Cp - C, cap, 3))])
        aid2 = torch.cat([state.aid.reshape(C, cap),
                          torch.full((self.Cp - C, cap), n, dtype=torch.int64, device=dev)])
        return xs3, aid2

    def _pairs(self, xs3, aid2, xi, ai, cells):
        """Displacements, distances (inf where no pair) and validity of the
        rows ``xi`` (R, 3) with atom ids ``ai`` (R,) against the 27-stencil
        candidates of their ``cells`` (R,)."""
        n, cap = self.spec.n_atoms, self.spec.cap
        nbr = self._stencil[cells]
        xn = xs3[nbr].reshape(-1, 27 * cap, 3)
        an = aid2[nbr].reshape(-1, 27 * cap)
        disp = minimum_image(xi[:, None, :] - xn, self.spec.box)
        r2 = torch.sum(disp * disp, dim=-1)
        valid = (ai[:, None] < n) & (an < n) & (ai[:, None] != an)
        r = torch.sqrt(torch.where(valid, r2, torch.full_like(r2, float("inf"))))
        return disp, r

    def _chunk_rows(self, xs3, aid2, ci):
        """The rows of this rank's chunk ``ci``: (positions, atom ids,
        cells, global slot rows)."""
        cap, k = self.spec.cap, self.cell_chunk
        c0 = self.c0 + ci * k
        rows = c0 * cap + torch.arange(k * cap, device=xs3.device)
        return xs3[c0:c0 + k].reshape(-1, 3), aid2[c0:c0 + k].reshape(-1), rows // cap, rows

    def _force_fn(self, state, core):
        n = self.spec.n_atoms

        def fn(x):
            xs3, aid2 = self._tables(state, x)
            f_rows, a_rows, e_chunks = [], [], []
            for ci in range(self.chunks):
                xi, ai, cells, _ = self._chunk_rows(xs3, aid2, ci)
                disp, r = self._pairs(xs3, aid2, xi, ai, cells)
                _, fmag = lj_pair_terms(self.lj, r)
                e_pair, fb = bias_pair_terms(core, r)
                f_rows.append(torch.sum(fmag[..., None] * disp, dim=1)
                              + torch.sum(fb[..., None] * disp, dim=1))
                a_rows.append(ai)
                e_chunks.append(torch.sum(e_pair))
            a = torch.cat(a_rows)
            f = _scatter_drop(n, 0.0, torch.where(a < n, a, torch.full_like(a, n)),
                              torch.cat(f_rows))
            f, e = psum_many([f, torch.sum(torch.stack(e_chunks)).reshape(1)], self.mesh)
            return 0.5 * e[0], f

        return fn

    def _collect(self, state, x, key, last_calls):
        """The hill round's candidates over this rank's chunks: pass 1 counts
        the accepted ordered candidates per slot row (uniforms of
        ``fold_in(fold_in(key, 7), row)``), pass 2 redraws on the first
        ``row_cap`` rows with one and extracts the first ``m_per_row`` of
        each; the ranks' compacted lists are gathered in rank order, ncalls
        and the truncation flag summed.  Returns (hills (H * n_ranks,),
        runifs, active, ncalls, truncated)."""
        spec, params, mesh = self.spec, self.params, self.mesh
        cap, W = spec.cap, 27 * spec.cap
        dtype, dev = x.dtype, x.device
        hkey = prng.fold_in(key, 7)
        hd = params.cfg.hill_density
        thresh = None if hd < 0 else B._rdiv(hd, last_calls.to(dtype))
        bmax = params.cfg.box_high[0]

        def accept(r, u):
            cand = torch.isfinite(r) & (r < bmax)
            return cand, cand if thresh is None else cand & (u < thresh)

        xs3, aid2 = self._tables(state, x)
        counts, ncalls = [], torch.zeros((), dtype=torch.int64, device=dev)
        for ci in range(self.chunks):
            xi, ai, cells, rows = self._chunk_rows(xs3, aid2, ci)
            _, r = self._pairs(xs3, aid2, xi, ai, cells)
            cand, acc = accept(r, prng.threefry_rows(hkey, rows, W, dtype))
            counts.append(acc.sum(1))
            ncalls = ncalls + cand.sum()
        row_counts = torch.cat(counts)
        # pass 2 on the first row_cap rows with an accepted candidate
        has = row_counts > 0
        rranks = torch.cumsum(has.to(torch.int64), 0) - 1
        sent = self.Cp * cap
        gids = self.c0 * cap + torch.arange(row_counts.shape[0], device=dev)
        rows_sel = _scatter_drop(self.row_cap, sent,
                                 torch.where(has & (rranks < self.row_cap), rranks,
                                             torch.full_like(rranks, self.row_cap)), gids)
        n_rows = torch.sum(has.to(torch.int64))
        rows_c = torch.clamp(rows_sel, 0, sent - 1)
        _, r = self._pairs(xs3, aid2, xs3.reshape(-1, 3)[rows_c], aid2.reshape(-1)[rows_c],
                           rows_c // cap)
        r = torch.where((rows_sel < sent)[:, None], r, torch.full_like(r, float("inf")))
        u = prng.threefry_rows(hkey, rows_c, W, dtype)
        _, acc = accept(r, u)
        hc = self.hill_capacity
        hills, runifs, active, count, _ = extract_first(acc, r, u, hc, self.m_per_row)
        truncated = (count > hc) | (n_rows > self.row_cap) | torch.any(row_counts > self.m_per_row)
        g = all_gather(torch.stack([hills, runifs, active.to(dtype)])[None], mesh)
        ncalls, n_trunc = psum(torch.stack([ncalls, truncated.to(torch.int64)]), mesh)
        return (g[:, 0].reshape(-1), g[:, 1].reshape(-1), g[:, 2].reshape(-1) > 0.5, ncalls,
                n_trunc > 0)

    def __call__(self, state: ShardedCellPairState, _=None):
        core, params = state.core, self.params
        do_hills, do_rebuild = self.do_hills, self.do_rebuild
        if do_hills is None or do_rebuild is None:  # the JAX host's conds, on the host
            step = int(core.step)
            self.host_syncs += 1
            do_hills = step % self.hill_stride == 0 if do_hills is None else do_hills
            do_rebuild = ((step + 1) % self.rebuild_stride == 0 if do_rebuild is None
                          else do_rebuild)
        x, v, f, e_bias, key = baoab_step(self.lp, core.x, core.v, core.f, core.key,
                                          self._force_fn(state, core))
        dev = x.device
        log = None
        bias_state, last_calls, cheb = core.bias, core.last_calls, core.cheb
        truncated = torch.zeros((), dtype=torch.bool, device=dev)
        if do_hills:
            hills, runifs, active, last_calls, truncated = self._collect(state, x, core.key,
                                                                         core.last_calls)
            bias_state, rec, reads = B.add_hills_round(params, core.bias, hills[:, None], runifs,
                                                       core.last_calls.to(x.dtype),
                                                       active=active)
            self.host_syncs += reads
            if cheb is not None:
                cheb = fit_gauss_grid(bias_state.bias, cheb.deg, cheb.npanels)
            if self.collect_records:
                log = B.HillRoundLog(torch.ones((), dtype=torch.bool, device=dev),
                                     hills[:, None], rec)
        new_core = PairEDMState(x=x, v=v, f=f, key=key, bias=bias_state, step=core.step + 1,
                                last_calls=last_calls, energy=e_bias,
                                hills_truncated=core.hills_truncated | truncated, cheb=cheb)
        aid, overflow = state.aid, state.table_overflow
        if do_rebuild:
            t = build_table(self.spec, x)
            aid, overflow = t.aid, overflow | t.overflow
        new_state = ShardedCellPairState(core=new_core, aid=aid, table_overflow=overflow)
        if not self.collect_records:
            return new_state, e_bias
        if log is None:
            log = B.round_log_zeros(params, core.bias, self.hill_capacity * self.mesh.size)
        return new_state, (e_bias, log)


def make_sharded_cell_step(params: B.BiasParams, lp: LangevinParams, lj: LJParams,
                           spec: CellSpec, hill_stride: int, mesh: Mesh,
                           rebuild_stride: int = 10, hill_capacity: int = 1024,
                           cell_chunk: int = 32, row_cap: int = 1024, m_per_row: int = 16,
                           cheb_deg: int = 64, collect_records: bool = False,
                           static_do_hills: Optional[bool] = None,
                           static_do_rebuild: Optional[bool] = None) -> WorkShardedCellStep:
    """This rank's step of the work-sharded cell host over ``mesh``, with
    the JAX signature and defaults; it drives ``init_sharded_cell_state``
    state, replicated on every rank.  The force pass runs this rank's cell
    chunks (``cell_chunk`` cells each) with the carried Chebyshev table
    (``pair_lookup="chebyshev"``; the exact lookup where the state carries
    none); each hill round collects over the same chunks (pass 2 on
    ``row_cap`` rows a rank, ``hill_capacity`` hills a rank), and every
    rank replays the gathered round of ``hill_capacity * n_ranks`` slots.
    With ``collect_records`` the step returns ``(state, (energy,
    HillRoundLog))``, the same log on every rank.  ``cheb_deg`` changes
    nothing (a round refits at the carried table's degree)."""
    if hill_stride < 1 or rebuild_stride < 1:
        raise ValueError("hill_stride and rebuild_stride must be >= 1")
    if cell_chunk < 1:
        raise ValueError("cell_chunk must be >= 1")
    return WorkShardedCellStep(
        params, lp, lj, spec, hill_stride, mesh, rebuild_stride, hill_capacity, cell_chunk,
        row_cap, m_per_row, collect_records,
        None if static_do_hills is None else bool(static_do_hills),
        None if static_do_rebuild is None else bool(static_do_rebuild))


__all__ = ["DATA_AXIS", "ShardedCellPairState", "WorkShardedCellStep", "init_sharded_cell_state",
           "make_brick_cell_step", "make_sharded_cell_step", "make_slab_cell_step"]
