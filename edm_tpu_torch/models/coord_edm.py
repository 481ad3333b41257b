"""Coordinate-CV EDM host — the equivalent of LAMMPS ``fix edm``
(reference lammps/fix_edm.cpp) — in PyTorch: biases the raw particle
coordinates (1-3 dims) during a Langevin MD run.

Counterpart of ``edm_tpu/models/coord_edm.py``.  One step is a BAOAB step
(``langevin.baoab_step``) whose force is the bias gradient lookup
(``bias.update_forces``, against the cached packed corner table when the
state carries one) plus an optional external force, then, on hill steps,
one ``bias.add_hills_round`` over the atoms' coordinates with the
acceptance uniforms of ``jax.random.uniform`` (standing in for RanMars,
fix_edm.cpp:145-151).  The key chain stays on the host and every draw runs
on the card (``ops/prng``), so a static plain step reads nothing back; a
hill step reads what its round reads (the capping loop's exit flags,
``ops/prefix_cap``; on a McGovern–De Pablo grid the strip counts of
``ops/deposit.deposit_from_mcgdp``; the gate of each extra pass) and
counts it in ``step.host_syncs``.

``make_step(static_do_hills=True)`` always runs the round and ``False``
never does (it still draws the uniforms, so the key chain is the JAX
host's); ``driver.strided_segment`` drives the two in their cycle and
checks each against ``hill_stride``.  These static phases are the fast
path.  ``static_do_hills=None`` (the JAX default) gives one step that
decides on each call, as the JAX host's ``lax.cond``, from the step
counter, which it reads back (one host sync per step, counted).
``hill_passes`` runs the round in passes over ``hill_passes *
hill_capacity`` compacted rows.  ``collect_records=True`` makes every step
return ``(energy, bias.HillRoundLog)`` for the HILLS log
(``driver.run_simulation``): the round's records on a hill step, zeros of
the same shapes on the others.  ``axis_name`` sums each round's bias over
the ranks of a mesh (``bias.add_hills_round``).  The sharded coordinate
host (``parallel/coord.py``) is a ``CoordStep`` over this rank's share of
the atoms.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import bias as B
from ..ops import prng
from ..ops.interp import packed_corner_table
from .driver import check_hill_phase
from .langevin import LangevinParams, baoab_step


@dataclasses.dataclass(frozen=True)
class CoordEDMState:
    x: torch.Tensor  # (N, ndim_space)
    v: torch.Tensor
    f: torch.Tensor
    key: np.ndarray  # (2,) uint32 Threefry key, on the host
    bias: B.BiasState
    step: torch.Tensor  # int64 scalar
    energy: torch.Tensor  # last bias energy
    # the bias grid's packed corner table (ops/interp.packed_corner_table),
    # rebuilt after each hill round; None: built per lookup when needed
    ptab: Optional[torch.Tensor] = None
    # True once an accepted-hill batch exceeded hill_capacity (the round
    # then dropped its tail: raise the capacity)
    hills_truncated: Optional[torch.Tensor] = None


def default_hill_capacity(params: B.BiasParams) -> int:
    """~8x the expected acceptances, in steps of 512 and at least 512; 0
    (no compaction) when every candidate is accepted."""
    density = float(params.cfg.hill_density)
    return 0 if density < 0 else max(512, int(-(-8.0 * max(density, 64.0) // 512)) * 512)


def compact_accepted(acc, pos, runiform, Hc: int):
    """The accepted rows of ``pos`` (N, D) and ``runiform`` (N,), in order,
    rank-compacted into ``Hc`` rows (zeros and ones past the count; the
    JAX ``mode="drop"`` scatter, through a spare row).  Returns (pos_c (Hc,
    D), run_c (Hc,), count of accepted rows)."""
    dev = pos.device
    ranks = torch.cumsum(acc.to(torch.int32), 0) - 1
    tgt = torch.where(acc & (ranks < Hc), ranks.to(torch.int64),
                      torch.full((), Hc, dtype=torch.int64, device=dev))
    pos_c = torch.zeros((Hc + 1, pos.shape[1]), dtype=pos.dtype, device=dev).index_put_(
        (tgt,), pos)[:Hc]
    run_c = torch.ones(Hc + 1, dtype=runiform.dtype, device=dev).index_put_(
        (tgt,), runiform)[:Hc]
    return pos_c, run_c, torch.sum(acc.to(torch.int64))


class CoordStep:
    """One step of the coordinate host (``make_step``): ``step(state) ->
    (new_state, bias_energy)``.  ``do_hills``: True or False for a static
    stride phase, None to decide from ``state.step`` on each call."""

    def __init__(self, params: B.BiasParams, lp: LangevinParams, hill_stride: int,
                 external_force, group_mask, hill_capacity: int, do_hills: Optional[bool],
                 hill_passes: int = 1, collect_records: bool = False, axis_name=None):
        self.params, self.lp, self.hill_stride = params, lp, hill_stride
        self.axis_name = axis_name  # the mesh axis the rounds' bias is summed over
        self.external_force = external_force
        self.group_mask = group_mask  # (N,) bool numpy array or None
        self._gmask = None  # its copy on the state's device, made at first use
        self.hill_capacity, self.do_hills = hill_capacity, do_hills
        self.hill_passes = hill_passes
        self.collect_records = collect_records
        self.host_syncs = 0

    def check_phase(self, pos: int, cycle: int):
        """Raise unless the JAX host runs this phase at step ``pos`` of a
        ``cycle``-step cycle (hills when ``step % hill_stride == 0``); a
        dynamic step fits every place."""
        check_hill_phase(self.do_hills, self.hill_stride, pos, cycle)

    def _mask(self, device):
        if self.group_mask is None:
            return None
        if self._gmask is None or self._gmask.device != device:
            self._gmask = torch.as_tensor(self.group_mask, device=device)
        return self._gmask

    def _total(self, e):
        """An energy term summed over the host's atoms (one device: as is)."""
        return e

    def _force_fn(self, bias_state, ptab, gmask):
        D = self.params.cfg.dim

        def fn(x):
            e, der = B.update_forces(self.params, bias_state, x, mask=gmask, packed=ptab)
            f = torch.zeros_like(x)
            f[..., :D] = f[..., :D] + (-der)
            e = self._total(e)
            if self.external_force is not None:
                e_ext, f_ext = self.external_force(x)
                f = f + f_ext
                e = e + self._total(e_ext)
            return e, f

        return fn

    def __call__(self, state: CoordEDMState, _=None):
        params = self.params
        D = params.cfg.dim
        gmask = self._mask(state.x.device)
        x, v, f, energy, key = baoab_step(self.lp, state.x, state.v, state.f, state.key,
                                          self._force_fn(state.bias, state.ptab, gmask))
        key, sub = prng.split(key)
        N = x.shape[0]
        dev, dtype = x.device, x.dtype
        runiform = prng.uniform(sub, (N,), dtype, dev)
        density = float(params.cfg.hill_density)
        compact = 0 < self.hill_capacity < N and density >= 0
        do_hills = self.do_hills
        if do_hills is None:  # the JAX host's lax.cond, decided on the host
            do_hills = int(state.step) % self.hill_stride == 0
            self.host_syncs += 1

        bias_state, ptab = state.bias, state.ptab
        trunc = torch.zeros((), dtype=torch.bool, device=dev)
        log = None
        if do_hills:
            if compact:
                # the engine's acceptance predicate, then an order-preserving
                # rank compaction into hill_passes * hill_capacity rows; the
                # engine accepts exactly these hills again (same draws, same
                # est_hill_count)
                Hc = self.hill_passes * self.hill_capacity
                acc = runiform < density / N
                if gmask is not None:
                    acc = acc & gmask
                pos_c, run_c, count = compact_accepted(acc, x[..., :D], runiform, Hc)
                active = torch.arange(Hc, device=dev) < count
                trunc = count > Hc
                bias_state, rec, reads = B.add_hills_round(params, bias_state, pos_c, run_c, N,
                                                           active=active,
                                                           axis_name=self.axis_name,
                                                           n_passes=self.hill_passes)
                log_pos = pos_c
            else:
                bias_state, rec, reads = B.add_hills_round(params, bias_state, x[..., :D],
                                                           runiform, N, active=gmask,
                                                           axis_name=self.axis_name)
                log_pos = x[..., :D]
            if self.collect_records:
                log = B.HillRoundLog(torch.ones((), dtype=torch.bool, device=dev), log_pos, rec)
            self.host_syncs += reads
            if ptab is not None:
                ptab = packed_corner_table(bias_state.bias.grid)
        new_trunc = None if state.hills_truncated is None else state.hills_truncated | trunc
        new_state = CoordEDMState(x=x, v=v, f=f, key=key, bias=bias_state, step=state.step + 1,
                                  energy=energy, ptab=ptab, hills_truncated=new_trunc)
        if not self.collect_records:
            return new_state, energy
        if log is None:
            log = B.round_log_zeros(params, state.bias,
                                    self.hill_passes * self.hill_capacity if compact else N)
        return new_state, (energy, log)


def make_step(
    params: B.BiasParams,
    lp: LangevinParams,
    hill_stride: int,
    external_force: Optional[Callable] = None,
    axis_name: Optional[str] = None,
    group_mask=None,
    collect_records: bool = False,
    hill_capacity: Optional[int] = None,
    static_do_hills: Optional[bool] = None,
    hill_passes: int = 1,
) -> CoordStep:
    """Build a step of the coordinate host, with the JAX signature.
    ``external_force(x) -> (energy, force)`` adds a physical potential
    (None: free particles, the reference's sanity setup).  ``group_mask``
    (N,) bool: only those atoms feel the bias and deposit hills (the LAMMPS
    group, fix_edm.cpp:104,140,153).  ``hill_capacity``: the rows accepted
    hills are compacted into before the round (default ~8x the expected
    acceptances, at least 512; 0 turns compaction off).  ``hill_passes``:
    the compaction takes ``hill_passes * hill_capacity`` rows and the round
    runs in that many passes (``bias.add_hills_round(n_passes=...)``), so
    an acceptance spike spills into later passes; only past those rows does
    the round drop its tail and set ``state.hills_truncated``.
    ``static_do_hills``: True or False builds one static stride phase (the
    fast path, driven by ``driver.strided_segment``), None a step that
    decides from ``state.step % hill_stride`` on each call and reads the
    counter back to do so.  ``collect_records``: each step returns
    ``(energy, bias.HillRoundLog)``.  ``axis_name``: the mesh axis
    (``parallel.make_mesh``) over which each round's bias is summed into
    ``cum_bias`` (``bias.add_hills_round``)."""
    if hill_stride < 1:
        raise ValueError("hill_stride must be >= 1")
    if hill_capacity is None:
        hill_capacity = default_hill_capacity(params)
    gmask = None if group_mask is None else np.asarray(group_mask, bool)
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return CoordStep(params, lp, hill_stride, external_force, gmask, hill_capacity, do_hills,
                     hill_passes, collect_records, axis_name)


def init_state(params: B.BiasParams, bias_state: B.BiasState, x0: torch.Tensor, key,
               lp: LangevinParams, cache_lookup_table: Optional[bool] = None) -> CoordEDMState:
    """The host's initial state on ``x0``'s device.  ``cache_lookup_table``
    (default: the JAX rule, D >= 2, N >= 4096 and at most 64e6 table
    floats) keeps the packed corner table in the state, rebuilt only after
    hill rounds.  ``key``: a host Threefry key (``ops/prng.PRNGKey``)."""
    D = params.cfg.dim
    g = bias_state.bias.grid
    if cache_lookup_table is None:
        F = (1 + D) * (2 ** D)
        cache_lookup_table = D >= 2 and x0.shape[0] >= 4096 and g.values.numel() * F <= 64_000_000
    dev = x0.device
    return CoordEDMState(
        x=x0, v=torch.zeros_like(x0), f=torch.zeros_like(x0),
        key=np.asarray(key, np.uint32), bias=bias_state,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        energy=torch.zeros((), dtype=x0.dtype, device=dev),
        ptab=packed_corner_table(g) if cache_lookup_table else None,
        hills_truncated=torch.zeros((), dtype=torch.bool, device=dev),
    )


def run_segment(step_fn, state: CoordEDMState, n_steps: int):
    """``n_steps`` steps; returns the final state and the per-step outputs
    stacked: the bias energies (n_steps,), with ``collect_records`` also
    the records (``driver.stack_outputs``)."""
    from .driver import stack_outputs

    ys = []
    for _ in range(n_steps):
        state, y = step_fn(state)
        ys.append(y)
    return state, stack_outputs(ys)
