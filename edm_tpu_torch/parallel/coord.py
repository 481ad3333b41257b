"""The sharded coordinate host: multiple-walker ``fix edm`` over a mesh.

Counterpart of ``edm_tpu/parallel/coord.py``.  The coordinate CV is per
atom, so the atoms split evenly over the ranks (JAX's ``P(DATA_AXIS)``):
each rank integrates its contiguous share, looks its bias forces up
locally and sums the bias energy over the mesh (one psum a step, two with
an external force).  Only the hill rounds join the ranks: each rank draws
its candidates' uniforms from its own key (``fold_in(fold_in(key, rank),
11)``), rank-compacts its accepted candidates into ``hill_capacity`` rows
(the reference's bounded exchange buffer, edm_bias.h:151-154), the ranks'
segments are gathered in rank order and compacted again to the first
``hill_capacity`` (the full gathered batch's deposit order), and every rank
replays that round on its replica of the grid, so the replicas stay
bitwise the same.  With ``hill_capacity=0`` the whole candidate batch is
gathered.  The thermostat noise of rank r comes from ``fold_in(key, r)``;
the key advances as ``split(key)[0]``, the same on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import bias as B
from ..models.coord_edm import CoordEDMState, CoordStep, compact_accepted, default_hill_capacity
from ..models.langevin import LangevinParams, baoab_step
from ..ops import prng
from .collectives import all_gather, psum
from .mesh import Mesh


def shard_coord_state(state: CoordEDMState, mesh: Mesh) -> CoordEDMState:
    """This rank's state of the sharded host: its contiguous share of ``x``,
    ``v`` and ``f`` (the atom count must split evenly over the ranks), the
    key, bias, counters and flags as they are (replicated), on the state's
    device; the cached corner table is dropped (the sharded step looks up
    without it)."""
    n = state.x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} atoms do not split evenly over {mesh.size} ranks")
    nl = n // mesh.size
    rows = slice(mesh.rank * nl, (mesh.rank + 1) * nl)
    return dataclasses.replace(state, x=state.x[rows].contiguous(),
                               v=state.v[rows].contiguous(), f=state.f[rows].contiguous(),
                               ptab=None)


class ShardedCoordStep(CoordStep):
    """This rank's step of the sharded coordinate host
    (``make_sharded_coord_step``): ``step(state) -> (new_state,
    bias_energy)``, the energy summed over the mesh."""

    def __init__(self, params, lp, hill_stride, external_force, hill_capacity, do_hills,
                 mesh: Mesh):
        super().__init__(params, lp, hill_stride, external_force, None, hill_capacity, do_hills)
        self.mesh = mesh

    def _total(self, e):
        return psum(e, self.mesh)

    def __call__(self, state: CoordEDMState, _=None):
        params, mesh = self.params, self.mesh
        D = params.cfg.dim
        rank_key = prng.fold_in(state.key, mesh.rank)
        x, v, f, energy, _ = baoab_step(self.lp, state.x, state.v, state.f, rank_key,
                                        self._force_fn(state.bias, None, None))
        key = prng.split(state.key)[0]
        do_hills = self.do_hills
        if do_hills is None:  # the JAX host's lax.cond, decided on the host
            do_hills = int(state.step) % self.hill_stride == 0
            self.host_syncs += 1
        dev, dtype = x.device, x.dtype
        n_global = x.shape[0] * mesh.size
        Hc = self.hill_capacity
        density = float(params.cfg.hill_density)
        bias_state = state.bias
        trunc = torch.zeros((), dtype=torch.bool, device=dev)
        if do_hills:
            runif = prng.uniform(prng.fold_in(rank_key, 11), (x.shape[0],), dtype, dev)
            n_est = torch.full((), n_global, dtype=dtype, device=dev)
            if 0 < Hc < n_global and density >= 0:
                pos_c, run_c, cnt = compact_accepted(runif < density / n_global, x[:, :D],
                                                     runif, Hc)
                act_c = torch.arange(Hc, device=dev) < cnt
                g = all_gather(torch.cat([pos_c, run_c[:, None], act_c[:, None].to(dtype)], 1),
                               mesh)
                total, n_over = psum(torch.stack([torch.clamp(cnt, max=Hc), (cnt > Hc).long()]),
                                     mesh)
                hills, runifs, _ = compact_accepted(g[:, D + 1] > 0.5, g[:, :D], g[:, D], Hc)
                active = torch.arange(Hc, device=dev) < total
                trunc = (n_over > 0) | (total > Hc)
                bias_state, _, reads = B.add_hills_round(params, bias_state, hills, runifs,
                                                         n_est, active=active)
            else:
                bias_state, _, reads = B.add_hills_round(params, bias_state,
                                                         all_gather(x[:, :D], mesh),
                                                         all_gather(runif, mesh), n_est)
            self.host_syncs += reads
        new_trunc = None if state.hills_truncated is None else state.hills_truncated | trunc
        return CoordEDMState(x=x, v=v, f=f, key=key, bias=bias_state, step=state.step + 1,
                             energy=energy, ptab=None, hills_truncated=new_trunc), energy


def make_sharded_coord_step(params: B.BiasParams, lp: LangevinParams, hill_stride: int,
                            mesh: Mesh, hill_capacity: Optional[int] = None,
                            external_force: Optional[Callable] = None,
                            static_do_hills: Optional[bool] = None) -> ShardedCoordStep:
    """This rank's step of the sharded coordinate host over ``mesh``, with
    the JAX signature; every rank runs every step on its ``shard_coord_state``
    state.  ``hill_capacity``: the rows each rank compacts its accepted
    candidates into, and the round's size after the gather (default ~8x the
    expected acceptances, at least 512; 0 gathers every candidate); a rank
    or the gathered round beyond it sets ``hills_truncated``.
    ``static_do_hills``: True or False builds one static stride phase
    (``driver.strided_segment``), None a step that reads the step counter
    to decide."""
    if hill_stride < 1:
        raise ValueError("hill_stride must be >= 1")
    if hill_capacity is None:
        hill_capacity = default_hill_capacity(params)
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return ShardedCoordStep(params, lp, hill_stride, external_force, hill_capacity, do_hills,
                            mesh)


__all__ = ["ShardedCoordStep", "make_sharded_coord_step", "shard_coord_state"]
