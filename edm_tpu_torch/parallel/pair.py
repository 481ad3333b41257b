"""Sharded pairwise EDM: the dense all-pairs host with its atoms split over
the ranks of a mesh.

Counterpart of ``edm_tpu/parallel/pair.py`` (``shard_pair_state``,
``make_sharded_pair_step``), with a process per rank in place of
``shard_map``:

  - each rank holds its ``N / size`` rows of ``x``, ``v`` and ``f``; the key,
    the bias state, the Chebyshev table and the counters are replicated;
  - the positions are all-gathered (``collectives.all_gather``, rank order)
    for the pair math; a rank's rows are its local *ordered* pairs against
    every atom, the self pair of global row ``rank * n_local + i`` at r = inf;
  - the thermostat noise of rank ``d`` comes from ``fold_in(key, d)`` and
    its hill draws from ``fold_in(fold_in(key, d), 7)`` (``ops/prng``,
    bitwise ``jax.random``); the replicated key moves on by
    ``split(key)[0]``;
  - accepted hills are compacted locally by a prefix-rank scatter into
    ``hill_capacity`` rows, all-gathered in rank order, and every rank
    replays the gathered round on its replica of the grid, so the replicas
    stay bitwise equal with no grid reduction; the pair count (the next
    round's estimate), the truncation flag and the bias energy are psums.

The step returns ``(state, energy)``, or ``(state, (energy, HillRoundLog))``
with ``collect_records`` (the JAX step returns ``(state, energy, log)``);
``driver.pattern_segment`` and ``strided_segment`` drive it as they drive
``pair_edm.PairStep``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import bias as B
from ..models.langevin import LangevinParams, baoab_step
from ..models.lj import LJParams, lj_energy_forces, minimum_image
from ..models.pair_edm import PairEDMState, PairStepBase, bias_pair_terms, compact_hills
from ..ops import prng
from ..ops.chebyshev import fit_gauss_grid
from .collectives import all_gather, psum
from .mesh import Mesh


def shard_pair_state(state: PairEDMState, mesh: Mesh) -> PairEDMState:
    """This rank's share of a full state that lies on the mesh's device: its
    ``N / size`` rows of x, v and f; everything else stays replicated."""
    n = state.x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} atoms do not split evenly over {mesh.size} ranks")
    if state.x.device != mesh.device:
        raise ValueError(f"the state is on {state.x.device}, the rank's device is {mesh.device}")
    nl = n // mesh.size
    rows = slice(mesh.rank * nl, (mesh.rank + 1) * nl)
    return dataclasses.replace(state, x=state.x[rows].contiguous(),
                               v=state.v[rows].contiguous(), f=state.f[rows].contiguous())


class ShardedPairStep(PairStepBase):
    """One step of the sharded dense host (``make_sharded_pair_step``)."""

    def __init__(self, *args, mesh: Mesh):
        super().__init__(*args)
        self.mesh = mesh

    def _n_log(self, n: int) -> int:
        return self.hill_capacity * self.mesh.size

    def _local_pair_math(self, x_local, x_full):
        """Minimum-image displacements and distances of this rank's rows
        against every atom; the self pair at r = inf."""
        disp = minimum_image(x_local[:, None, :] - x_full[None, :, :], self.box)
        r2 = torch.sum(disp * disp, dim=-1)
        nl = x_local.shape[0]
        dev = x_local.device
        gidx = self.mesh.rank * nl + torch.arange(nl, device=dev)
        self_mask = gidx[:, None] == torch.arange(x_full.shape[0], device=dev)[None, :]
        r = torch.sqrt(torch.where(self_mask, torch.full_like(r2, float("inf")), r2))
        return disp, r

    def _force_fn(self, state: PairEDMState):
        def force_fn(x_local):
            disp, r = self._local_pair_math(x_local, all_gather(x_local, self.mesh))
            _, f_lj = lj_energy_forces(self.lj, disp, r)
            e_pair, fb = bias_pair_terms(state, r)
            f_b = torch.sum(fb[..., None] * disp, dim=1)
            return 0.5 * psum(torch.sum(e_pair), self.mesh), f_lj + f_b

        return force_fn

    def _collect(self, x, state):
        """This rank's ordered in-range pairs, one uniform each from its
        hill stream, compacted locally and gathered in rank order.  Returns
        (hills, runifs, active, ncalls, truncated) of the global round."""
        mesh, dtype = self.mesh, x.dtype
        _, r = self._local_pair_math(x, all_gather(x, mesh))
        rflat = r.reshape(-1)
        candidate = torch.isfinite(rflat) & (rflat < self.params.cfg.box_high[0])
        ncalls = psum(torch.sum(candidate.to(torch.int64)), mesh)
        hkey = prng.fold_in(prng.fold_in(state.key, mesh.rank), 7)
        runif = prng.uniform(hkey, (rflat.shape[0],), dtype, x.device)
        thresh = self._accept_threshold(state.last_calls, dtype)
        accept = candidate if thresh is None else candidate & (runif < thresh)
        hills, run_c, active, count = compact_hills(accept, rflat, runif, self.hill_capacity)
        truncated = psum((count > self.hill_capacity).to(torch.int64), mesh) > 0
        return (all_gather(hills, mesh), all_gather(run_c, mesh), all_gather(active, mesh),
                ncalls, truncated)

    def __call__(self, state: PairEDMState, _=None):
        params, mesh = self.params, self.mesh
        key_dev = prng.fold_in(state.key, mesh.rank)  # this rank's noise stream
        x, v, f, e_bias, _ = baoab_step(self.lp, state.x, state.v, state.f, key_dev,
                                        self._force_fn(state))
        key = prng.split(state.key)[0]
        do_hills = self.do_hills
        if do_hills is None:  # the JAX host's lax.cond, decided on the host
            do_hills = int(state.step) % self.hill_stride == 0
            self.host_syncs += 1
        n_log = self._n_log(x.shape[0])
        log = None
        if do_hills:
            hills, runifs, active, ncalls, truncated = self._collect(x, state)
            dtype = x.dtype
            bias_state, rec, reads = B.add_hills_round(
                params, state.bias, hills[:, None], runifs, state.last_calls.to(dtype),
                active=active)
            self.host_syncs += reads
            last_calls = ncalls
            cheb = (fit_gauss_grid(bias_state.bias, state.cheb.deg, state.cheb.npanels)
                    if state.cheb is not None else None)
            if self.collect_records:
                log = B.HillRoundLog(torch.ones((), dtype=torch.bool, device=x.device),
                                     hills[:, None], rec)
        else:
            bias_state, last_calls, cheb = state.bias, state.last_calls, state.cheb
            truncated = torch.zeros((), dtype=torch.bool, device=x.device)
        new_state = PairEDMState(
            x=x, v=v, f=f, key=key, bias=bias_state, step=state.step + 1,
            last_calls=last_calls, energy=e_bias,
            hills_truncated=state.hills_truncated | truncated, cheb=cheb,
        )
        if not self.collect_records:
            return new_state, e_bias
        if log is None:
            log = B.round_log_zeros(params, state.bias, n_log)
        return new_state, (e_bias, log)


def make_sharded_pair_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    box,
    hill_stride: int,
    mesh: Mesh,
    hill_capacity: int = 2048,
    cheb_deg: int = 64,
    collect_records: bool = False,
    static_do_hills: Optional[bool] = None,
) -> ShardedPairStep:
    """Build this rank's step of the sharded dense host over ``mesh``; it
    drives the state of ``shard_pair_state``.  ``hill_capacity`` is the
    per-rank accepted-hill capacity: the global round has ``size *
    hill_capacity`` rows.  ``static_do_hills`` True or False builds a static
    stride phase, None decides from ``state.step`` on each call (one host
    read).  ``cheb_deg`` changes nothing: a round refits at the carried
    table's degree.  Every rank of the mesh must run every step."""
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return ShardedPairStep(params, lp, lj, box, hill_stride, hill_capacity, do_hills,
                           collect_records, mesh=mesh)
