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
on the card (``ops/prng``), so a plain step reads nothing back; a hill
step reads the capping loop's exit flags (``ops/prefix_cap``) and counts
them in ``step.host_syncs``.

The stride phase is static: ``make_step(static_do_hills=True)`` always
runs the round and ``False`` never does (it still draws the uniforms, so
the key chain is the JAX host's); ``driver.strided_segment`` drives the
two in their cycle and checks each against ``hill_stride``.  The JAX
host's dynamic cond (``static_do_hills=None``) and ``hill_passes > 1``
are not ported (ROADMAP Queue 1, item 4), nor is ``collect_records``
(item 5) or ``axis_name`` (item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .. import bias as B
from ..ops import prng
from ..ops.interp import packed_corner_table
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


class CoordStep:
    """One static stride phase of the coordinate host (``make_step``):
    ``step(state) -> (new_state, bias_energy)``."""

    def __init__(self, params: B.BiasParams, lp: LangevinParams, hill_stride: int,
                 external_force, group_mask, hill_capacity: int, do_hills: bool):
        self.params, self.lp, self.hill_stride = params, lp, hill_stride
        self.external_force = external_force
        self.group_mask = group_mask  # (N,) bool numpy array or None
        self._gmask = None  # its copy on the state's device, made at first use
        self.hill_capacity, self.do_hills = hill_capacity, do_hills
        self.host_syncs = 0

    def check_phase(self, pos: int, cycle: int):
        """Raise unless the JAX host runs this phase at step ``pos`` of a
        ``cycle``-step cycle (hills when ``step % hill_stride == 0``)."""
        if cycle % self.hill_stride:
            raise ValueError(f"a {cycle}-step cycle is not a whole number of "
                             f"hill_stride {self.hill_stride}")
        if (pos % self.hill_stride == 0) != self.do_hills:
            raise ValueError(f"step {pos} of the cycle is {'not ' * self.do_hills}a hill "
                             f"step under hill_stride {self.hill_stride}")

    def _mask(self, device):
        if self.group_mask is None:
            return None
        if self._gmask is None or self._gmask.device != device:
            self._gmask = torch.as_tensor(self.group_mask, device=device)
        return self._gmask

    def _force_fn(self, bias_state, ptab, gmask):
        D = self.params.cfg.dim

        def fn(x):
            e, der = B.update_forces(self.params, bias_state, x, mask=gmask, packed=ptab)
            f = torch.zeros_like(x)
            f[..., :D] = f[..., :D] + (-der)
            if self.external_force is not None:
                e_ext, f_ext = self.external_force(x)
                f = f + f_ext
                e = e + e_ext
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
        cap = self.hill_capacity
        compact = 0 < cap < N and density >= 0

        bias_state, ptab = state.bias, state.ptab
        trunc = torch.zeros((), dtype=torch.bool, device=dev)
        if self.do_hills:
            if compact:
                # the engine's acceptance predicate, then an order-preserving
                # rank compaction into cap rows; the engine accepts exactly
                # these hills again (same draws, same est_hill_count)
                acc = runiform < density / N
                if gmask is not None:
                    acc = acc & gmask
                ranks = torch.cumsum(acc.to(torch.int32), 0) - 1
                tgt = torch.where(acc & (ranks < cap), ranks.to(torch.int64),
                                  torch.full((), cap, dtype=torch.int64, device=dev))
                pos_c = torch.zeros((cap + 1, D), dtype=dtype, device=dev).index_put_(
                    (tgt,), x[..., :D])[:cap]
                run_c = torch.ones(cap + 1, dtype=dtype, device=dev).index_put_(
                    (tgt,), runiform)[:cap]
                count = torch.sum(acc.to(torch.int64))
                active = torch.arange(cap, device=dev) < count
                trunc = count > cap
                bias_state, _, reads = B.add_hills_round(params, bias_state, pos_c, run_c, N,
                                                         active=active)
            else:
                bias_state, _, reads = B.add_hills_round(params, bias_state, x[..., :D],
                                                         runiform, N, active=gmask)
            self.host_syncs += reads
            if ptab is not None:
                ptab = packed_corner_table(bias_state.bias.grid)
        new_trunc = None if state.hills_truncated is None else state.hills_truncated | trunc
        new_state = CoordEDMState(x=x, v=v, f=f, key=key, bias=bias_state, step=state.step + 1,
                                  energy=energy, ptab=ptab, hills_truncated=new_trunc)
        return new_state, energy


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
    """Build one static stride phase of the coordinate host, with the JAX
    signature.  ``external_force(x) -> (energy, force)`` adds a physical
    potential (None: free particles, the reference's sanity setup).
    ``group_mask`` (N,) bool: only those atoms feel the bias and deposit
    hills (the LAMMPS group, fix_edm.cpp:104,140,153).  ``hill_capacity``:
    the rows accepted hills are compacted into before the round (default
    ~8x the expected acceptances, at least 512; 0 turns compaction off); an
    overflow drops the round's tail and sets ``state.hills_truncated``."""
    if static_do_hills is None:
        raise NotImplementedError(
            "the dynamic hill cond is not ported (ROADMAP Queue 1, item 4): build a "
            "static_do_hills=True and a False step and drive them with "
            "driver.strided_segment")
    if hill_passes != 1:
        raise NotImplementedError("hill_passes > 1 is not ported yet (ROADMAP Queue 1, item 4)")
    if collect_records:
        raise NotImplementedError("hill-record collection is not ported yet (ROADMAP Queue 1, item 5)")
    if axis_name is not None:
        raise NotImplementedError("axis_name (the sharded host) is not ported yet "
                                  "(ROADMAP Queue 1, item 7)")
    if hill_stride < 1:
        raise ValueError("hill_stride must be >= 1")
    density = float(params.cfg.hill_density)
    if hill_capacity is None:  # ~8x the expected acceptances, in steps of 512
        hill_capacity = 0 if density < 0 else max(512, int(-(-8.0 * max(density, 64.0) // 512)) * 512)
    gmask = None if group_mask is None else np.asarray(group_mask, bool)
    return CoordStep(params, lp, hill_stride, external_force, gmask, hill_capacity,
                     bool(static_do_hills))


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
    """``n_steps`` steps; returns the final state and the per-step bias
    energies (n_steps,)."""
    energies = []
    for _ in range(n_steps):
        state, e = step_fn(state)
        energies.append(e)
    return state, torch.stack(energies)
