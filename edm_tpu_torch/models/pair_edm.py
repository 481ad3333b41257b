"""Pairwise-distance EDM host (LAMMPS ``fix edm_pair``, reference
lammps/fix_edm_pair.cpp) in PyTorch: biases the pair-distance CV of an LJ
fluid toward a target RDF-derived PMF.

Counterpart of ``edm_tpu/models/pair_edm.py``: ``PairEDMState``,
``init_state`` with either pair lookup — the exact cubic-Hermite table
(``pair_lookup="interp"``) or the panelized Chebyshev fit
(``"chebyshev"``, carried in ``cheb`` and refit after every hill round) —
and the dense all-pairs ``make_step``.  The key is a host-side Threefry key
(``ops/prng``).

One step is a BAOAB step (``langevin.baoab_step``) whose force is the dense
minimum-image LJ plus the bias-CV term of every ordered pair (each ordered
pair gives its own force row, so the equal and opposite pair forces of
fix_edm_pair.cpp:219-227 emerge from symmetry; the energy is halved).  On
hill steps every ordered pair within the CV domain is a candidate, accepted
with probability ``hill_density / last_calls`` by one ``jax.random``
uniform per pair (``prng.uniform``: the N^2 draws in one launch of the
Threefry kernel on the card); the accepted pair distances are compacted in
pair order into ``min(hill_capacity, N^2)`` rows by a prefix-rank scatter
and go through ``bias.add_hills_round``.  Nothing of this reads back to the
host except the round's own capping loop (``ops/prefix_cap``), which the
step counts in ``host_syncs``.

``static_do_hills`` True or False builds a static stride phase (the fast
path, driven by ``driver.strided_segment``); None (the JAX default) decides
on each call from ``state.step % hill_stride``, which it reads back once a
call.  ``axis_name`` sums each round's bias over the ranks of a mesh
(``bias.add_hills_round``); the sharded pair host itself is
``parallel.pair.make_sharded_pair_step``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .. import bias as B
from ..ops import prng
from ..ops.chebyshev import ChebTable, fit_gauss_grid
from .cells import _scatter_drop
from .driver import check_hill_phase
from .langevin import LangevinParams, baoab_step
from .lj import LJParams, lj_energy_forces, pair_displacements


@dataclasses.dataclass(frozen=True)
class PairEDMState:
    x: torch.Tensor  # (N, 3)
    v: torch.Tensor
    f: torch.Tensor
    key: np.ndarray  # (2,) uint32 Threefry key, on the host
    bias: B.BiasState
    step: torch.Tensor  # int64 scalar
    last_calls: torch.Tensor  # est_hill_count for the next round
    energy: torch.Tensor  # bias energy of the last energy step
    hills_truncated: torch.Tensor  # bool: accepted hills exceeded capacity
    cheb: Optional[ChebTable] = None  # pair_lookup="chebyshev": the fitted table


def init_state(bias_state: B.BiasState, x0: torch.Tensor, key,
               n_est: Optional[int] = None, pair_lookup: str = "interp",
               cheb_deg: int = 64, cheb_panels: int = 1) -> PairEDMState:
    """``n_est``: initial est_hill_count, the reference's conservative
    atom->nmax guess (fix_edm_pair.cpp:105).  ``key``: a (2,) uint32 key
    (``ops.prng.PRNGKey``).  ``pair_lookup``: "interp" (the exact Hermite
    lookup) or "chebyshev" (a (cheb_panels, cheb_deg + 1) fit of the bias
    grid, refit after every hill round)."""
    if pair_lookup not in ("interp", "chebyshev"):
        raise ValueError(f"pair_lookup must be 'interp' or 'chebyshev', got {pair_lookup!r}")
    cheb = (fit_gauss_grid(bias_state.bias, cheb_deg, cheb_panels)
            if pair_lookup == "chebyshev" else None)
    n = x0.shape[0] if n_est is None else n_est
    dev = x0.device
    return PairEDMState(
        x=x0,
        v=torch.zeros_like(x0),
        f=torch.zeros_like(x0),
        key=np.asarray(key, np.uint32),
        bias=bias_state,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        last_calls=torch.tensor(n, dtype=torch.int64, device=dev),
        energy=torch.zeros((), dtype=x0.dtype, device=dev),
        hills_truncated=torch.zeros((), dtype=torch.bool, device=dev),
        cheb=cheb,
    )


def bias_pair_terms(state: PairEDMState, r: torch.Tensor):
    """Per-pair bias energy (0 where r = inf, no pair) and the bias force
    over r along disp, ``-dV/dr / r`` (fix_edm_pair.cpp:216-222): the
    carried Chebyshev table (inf looked up at -1), else the exact Hermite
    lookup of the live grid (zero outside the CV domain)."""
    fin = torch.isfinite(r)
    if state.cheb is not None:
        val, der0 = state.cheb.value_deriv(torch.where(fin, r, -torch.ones_like(r)))
    else:
        val, der = state.bias.bias.get_value_deriv(r[..., None])
        der0 = der[..., 0]
    zero = torch.zeros_like(r)
    binr = torch.where(fin, torch.reciprocal(r), zero)
    return torch.where(fin, val, zero), -der0 * binr


def compact_hills(accept, values, runifs, n_log: int):
    """The accepted entries of ``values`` and ``runifs`` (flat, in order)
    compacted into ``n_log`` rows by a prefix-rank scatter (zeros and ones
    past the count; the JAX ``mode="drop"`` scatter, through a spare row).
    Returns (hills (n_log,), runifs (n_log,), active (n_log,), count)."""
    ranks = torch.cumsum(accept.to(torch.int64), 0) - 1
    tgt = torch.where(accept & (ranks < n_log), ranks, torch.full_like(ranks, n_log))
    hills = _scatter_drop(n_log, 0.0, tgt, values)
    run_c = _scatter_drop(n_log, 1.0, tgt, runifs)
    count = torch.sum(accept.to(torch.int64))
    active = torch.arange(n_log, device=accept.device) < count
    return hills, run_c, active, count


NO_KEY = torch.iinfo(torch.int64).max  # the sort key of an empty hill slot


def extract_first(acc, rvals, uvals, hc: int, m_per_row: int, row_ids=None):
    """The first ``m_per_row`` accepted columns of each row, in row-major
    order, compacted into ``hc`` slots (the JAX ``_extract_first_m`` and
    its compaction): ``acc``, ``rvals`` and ``uvals`` are (rows, columns).
    Returns (hills, runifs (1.0 past the count), active, count, keys):
    with ``row_ids`` (rows,) each hill's key ``row_id * m_per_row + its
    place in the row`` (``NO_KEY`` past the count), else None."""
    mpos = torch.cumsum(acc.to(torch.int64), 1)
    vflat = (acc & (mpos <= m_per_row)).reshape(-1)
    ranks = torch.cumsum(vflat.to(torch.int64), 0) - 1
    tgt = torch.where(vflat & (ranks < hc), ranks, torch.full_like(ranks, hc))
    hills = _scatter_drop(hc, 0.0, tgt, rvals.reshape(-1))
    runifs = _scatter_drop(hc, 1.0, tgt, uvals.reshape(-1))
    count = torch.sum(vflat.to(torch.int64))
    active = torch.arange(hc, device=acc.device) < count
    keys = None
    if row_ids is not None:
        keys = _scatter_drop(hc, NO_KEY, tgt, (row_ids[:, None] * m_per_row + mpos - 1).reshape(-1))
    return hills, runifs, active, count, keys


class PairStepBase:
    """What the dense and the blocked steps share: ``step(state) ->
    (new_state, bias_energy)``, or ``(new_state, (bias_energy,
    HillRoundLog))`` with ``collect_records``.  A subclass gives the force
    pass (``_force_fn``), the hill candidates (``_collect``) and the round's
    row count (``_n_log``).  ``do_hills``: True or False for a static stride
    phase, None to decide from ``state.step`` on each call.  ``host_syncs``
    counts the values this step object has read back to the host."""

    def __init__(self, params: B.BiasParams, lp: LangevinParams, lj: LJParams, box,
                 hill_stride: int, hill_capacity: int, do_hills: Optional[bool],
                 collect_records: bool, axis_name: Optional[str] = None):
        if hill_stride < 1:
            raise ValueError("hill_stride must be >= 1")
        self.params, self.lp, self.lj = params, lp, lj
        self.box = tuple(float(b) for b in np.asarray(box, np.float64).reshape(-1))
        self.hill_stride, self.hill_capacity = hill_stride, hill_capacity
        self.do_hills, self.collect_records = do_hills, collect_records
        self.axis_name = axis_name  # the mesh axis the rounds' bias is summed over
        self.host_syncs = 0

    def check_phase(self, pos: int, cycle: int):
        """Raise unless the JAX host runs this phase at step ``pos`` of a
        ``cycle``-step cycle (hills when ``step % hill_stride == 0``); a
        dynamic step fits every place."""
        check_hill_phase(self.do_hills, self.hill_stride, pos, cycle)

    def _accept_threshold(self, last_calls, dtype):
        """``hill_density / last_calls`` in ``dtype`` (None: accept every
        candidate)."""
        hd = self.params.cfg.hill_density
        return None if hd < 0 else B._rdiv(hd, last_calls.to(dtype))

    def __call__(self, state: PairEDMState, _=None):
        params = self.params
        x, v, f, e_bias, key = baoab_step(self.lp, state.x, state.v, state.f, state.key,
                                          self._force_fn(state))
        do_hills = self.do_hills
        if do_hills is None:  # the JAX host's lax.cond, decided on the host
            do_hills = int(state.step) % self.hill_stride == 0
            self.host_syncs += 1
        n_log = self._n_log(x.shape[0])
        log = None
        if do_hills:
            key, sub = prng.split(key)
            hills, runifs, active, ncalls, truncated = self._collect(x, sub, state.last_calls)
            dtype = x.dtype
            bias_state, rec, reads = B.add_hills_round(
                params, state.bias, hills[:, None], runifs, state.last_calls.to(dtype),
                active=active, axis_name=self.axis_name)
            self.host_syncs += reads
            last_calls = ncalls
            # refit at the carried table's degree and panels
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


class PairStep(PairStepBase):
    """One step of the dense all-pairs host (``make_step``)."""

    def __init__(self, *args, types=None, type_pair=None, axis_name=None):
        super().__init__(*args, axis_name=axis_name)
        # the rdf type pair of the CV (both given, else every pair)
        self.types = None if types is None or type_pair is None else np.asarray(types, np.int64)
        self.type_pair = None if self.types is None else tuple(int(t) for t in type_pair)
        self._mask = None  # the (N, N) pair mask on the state's device, made at first use

    def _pair_mask(self, device) -> Optional[torch.Tensor]:
        if self.types is None:
            return None
        if self._mask is None or self._mask.device != device:
            t = torch.as_tensor(self.types, device=device)
            ti, tj = self.type_pair
            self._mask = (((t[:, None] == ti) & (t[None, :] == tj))
                          | ((t[:, None] == tj) & (t[None, :] == ti)))
        return self._mask

    def _n_log(self, n: int) -> int:
        return min(self.hill_capacity, n * n)

    def _cv_distances(self, r):
        mask = self._pair_mask(r.device)
        return r if mask is None else torch.where(mask, r, torch.full_like(r, float("inf")))

    def _force_fn(self, state: PairEDMState):
        def force_fn(x):
            disp, r = pair_displacements(x, self.box)
            _, f_lj = lj_energy_forces(self.lj, disp, r)
            e_pair, fb = bias_pair_terms(state, self._cv_distances(r))
            f_b = torch.sum(fb[..., None] * disp, dim=1)
            return 0.5 * torch.sum(e_pair), f_lj + f_b

        return force_fn

    def _collect(self, x, key, last_calls):
        """Every ordered in-range pair a candidate (like every add_hill call
        in the reference's neighbour loop), one uniform each; the accepted
        pair distances compacted in pair order."""
        dtype = x.dtype
        _, r = pair_displacements(x, self.box)
        rflat = self._cv_distances(r).reshape(-1)
        bmax = self.params.cfg.box_high[0]
        candidate = torch.isfinite(rflat) & (rflat < bmax)
        ncalls = torch.sum(candidate.to(torch.int64))
        runif = prng.uniform(key, (rflat.shape[0],), dtype, x.device)
        thresh = self._accept_threshold(last_calls, dtype)
        accept = candidate if thresh is None else candidate & (runif < thresh)
        n_log = self._n_log(x.shape[0])
        hills, run_c, active, count = compact_hills(accept, rflat, runif, n_log)
        return hills, run_c, active, ncalls, count > n_log


def make_step(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    box,
    hill_stride: int,
    hill_capacity: int = 2048,
    axis_name: Optional[str] = None,
    cheb_deg: int = 64,
    types=None,
    type_pair: Optional[Tuple[int, int]] = None,
    collect_records: bool = False,
    static_do_hills: Optional[bool] = None,
) -> PairStep:
    """Build a step of the dense all-pairs host, with the JAX signature.

    If the state carries a ``cheb`` table (``init_state(pair_lookup=
    "chebyshev")``), the per-pair bias lookup uses it and each hill round
    refits it at its own degree and panels (``cheb_deg`` changes nothing,
    as in the JAX host); otherwise the exact cubic-Hermite grid lookup.
    ``types`` (N,) + ``type_pair`` (i, j) restrict the biased CV to i-j type
    pairs, the reference's ``rdf type pair`` arguments
    (fix_edm_pair.cpp:39-44,177-202); None biases all pairs.
    ``static_do_hills``: True or False builds one static stride phase, None
    a step that decides from ``state.step % hill_stride`` on each call and
    reads the counter back to do so.  ``collect_records``: each step returns
    ``(energy, bias.HillRoundLog)``, zeros on steps without a round.
    ``axis_name``: the mesh axis (``parallel.make_mesh``) over which each
    round's bias is summed into ``cum_bias``."""
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return PairStep(params, lp, lj, box, hill_stride, hill_capacity, do_hills, collect_records,
                    types=types, type_pair=type_pair, axis_name=axis_name)


def run_segment(step_fn, state: PairEDMState, n_steps: int):
    """``n_steps`` steps; returns the final state and the per-step outputs
    stacked (``driver.stack_outputs``)."""
    from .driver import stack_outputs

    ys = []
    for _ in range(n_steps):
        state, y = step_fn(state)
        ys.append(y)
    return state, stack_outputs(ys)
