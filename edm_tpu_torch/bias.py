"""The EDM bias engine (reference ``EDMBias``, lib/edm_bias.{h,cpp}) in
PyTorch.

Counterpart of ``edm_tpu/bias.py``: a pure state transition over an
explicit ``BiasState``.  ``add_hills_round`` is one pre/add/post hill cycle
(edm_bias.cpp:413-583):

  1. global-tempering prefactor shrink                 (:422-426)
  2. drain the deferred-hill buffer under the cap      (:432, :313-380)
  3. skip-whole-round rule if leftovers remain         (:436-439)
  4. stochastic accept + targeting + well-tempering + clamp (:543-558)
  5. sequential bias_per_step capping (ops/prefix_cap)
  6. one deposit commit + FIFO overflow append
  7. CV histogram bookkeeping and cum_bias update      (:586-612, :922-931)

The JAX package's deliberate fixes vs the reference carry over (proper
FIFO overflow buffer; out-of-bounds replicas add 0 to cum_bias).

Ported: ``subdivide`` (with an initial bias read from a file),
``update_forces`` and ``add_hills_round`` with every deposit route of the
JAX round (the dense 1-D tables, the separable tables of fully periodic
2-D/3-D grids, the McGovern–De Pablo tables of the other 2-D/3-D grids,
the windowed scatter), multi-pass rounds and replay heights, and the
per-step record a host emits for the HILLS log (``HillRoundLog``,
``round_log_zeros``), ``axis_name``: the round's bias psummed over the
ranks of a mesh (``parallel.collectives``), and ``boundary_offset``: the
local-to-global shift of the spatial host's grids (``parallel/spatial.py``),
with which every boundary-relative term is evaluated at ``x +
boundary_offset``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .gauss import GaussGrid
from .grid import Grid, GridSpec, device_const
from .ops.deposit import (
    dense_tables_1d,
    dense_tables_mcgdp,
    dense_tables_sep,
    deposit_from_mcgdp,
    deposit_from_tables,
    deposit_from_tables_sep,
    deposit_precomputed,
    hill_windows,
)
from .ops.prefix_cap import cap_scan, drain_scan
from .utils import trace
from .utils.config import EDMConfig
from .utils.errors import edm_error

BIAS_CLAMP = 1.0  # edm_bias.h:14
BIAS_BUFFER_SIZE = 2048  # edm_bias.h:15

# hill-event type codes of the HILLS log (edm_bias.h:20-25)
NEIGH_HILL = "n"
BUFF_HILL = "b"
BUFF_UNDO_HILL = "v"
ADD_HILL = "h"
ADD_UNDO_HILL = "u"
BUFF_ZERO_HILL = "z"


@dataclasses.dataclass(frozen=True)
class BiasState:
    bias: GaussGrid
    cv_hist: Grid
    cum_bias: torch.Tensor  # scalar
    buf_pos: torch.Tensor  # (CAP, D) deferred hill centres
    buf_h: torch.Tensor  # (CAP,) deferred hill heights
    buf_left: torch.Tensor  # int64 scalar
    buf_right: torch.Tensor  # int64 scalar
    overflow_error: torch.Tensor  # bool scalar: the host checks it
    steps: torch.Tensor  # int64 scalar (hill-round counter)


@dataclasses.dataclass(frozen=True)
class BiasParams:
    """Per-simulation parameters; the target grid rides along."""

    target: Optional[Grid]
    expected_target: torch.Tensor  # scalar (0 when not targeting)
    cfg: EDMConfig
    boltzmann_factor: float
    temperature: float
    total_volume: float
    b_outofbounds: bool = False
    exact_deposit: bool = False


def subdivide(
    cfg: EDMConfig,
    temperature: float,
    boltzmann_constant: float,
    sublo,
    subhi,
    boxlo,
    boxhi,
    b_periodic,
    skin,
    target: Optional[Grid] = None,
    initial_bias: Optional[Grid] = None,
    dtype=torch.float32,
    device="cuda",
    buffer_size: int = BIAS_BUFFER_SIZE,
    n_replicas: int = 1,
    exact_deposit: bool = False,
) -> Tuple[BiasParams, BiasState]:
    """Build the local bias grid for this domain (edm_bias.cpp:98-222).
    ``initial_bias``: a grid (``utils/gridio.read_grid_file``) added to the
    new bias grid at its points (edm_bias.cpp:166-167)."""
    D = cfg.dim
    if temperature < 0:
        edm_error("Must call setup before subdivide", "bias.py:subdivide")

    b_periodic_boundary = []
    for i in range(D):
        match = abs(boxlo[i] - cfg.box_low[i]) < 1e-6 and abs(boxhi[i] - cfg.box_high[i]) < 1e-6
        b_periodic_boundary.append(bool(b_periodic[i]) if match else False)

    gmin, gmax, grid_period = [], [], []
    bounds_flag = True
    for i in range(D):
        lo, hi = float(sublo[i]), float(subhi[i])
        spans = abs(lo - cfg.box_low[i]) < 1e-6 and abs(hi - cfg.box_high[i]) < 1e-6
        if spans:
            grid_period.append(bool(b_periodic[i]))
            bounds_flag = False
        else:
            grid_period.append(False)
            lo -= skin[i]
            hi += skin[i]
        gmin.append(lo)
        gmax.append(hi)
        bounds_flag &= (lo >= cfg.box_high[i]) or (hi <= cfg.box_low[i])

    bias = GaussGrid.create(gmin, gmax, cfg.bias_dx, grid_period, cfg.bias_sigma,
                            interpolate=True, dtype=dtype, device=device)
    bias = bias.set_boundary(cfg.box_low, cfg.box_high, b_periodic_boundary)
    cv_hist = Grid.zeros(GridSpec.create(gmin, gmax, cfg.bias_sigma, grid_period),
                         dtype=dtype, device=device)
    if initial_bias is not None:
        bias = dataclasses.replace(bias, grid=bias.grid.add_grid(initial_bias, 1.0, 0.0))
    expected_target = (
        target.expected_bias() if target is not None
        else torch.zeros((), dtype=dtype, device=device)
    )
    params = BiasParams(
        target=target,
        expected_target=expected_target.to(dtype),
        cfg=cfg,
        boltzmann_factor=float(boltzmann_constant * temperature),
        temperature=float(temperature),
        total_volume=float(bias.spec.volume * n_replicas),
        b_outofbounds=bool(bounds_flag),
        exact_deposit=bool(exact_deposit),
    )
    i64 = dict(dtype=torch.int64, device=device)
    state = BiasState(
        bias=bias,
        cv_hist=cv_hist,
        cum_bias=torch.zeros((), dtype=dtype, device=device),
        buf_pos=torch.zeros((buffer_size, D), dtype=dtype, device=device),
        buf_h=torch.zeros((buffer_size,), dtype=dtype, device=device),
        buf_left=torch.zeros((), **i64),
        buf_right=torch.zeros((), **i64),
        overflow_error=torch.zeros((), dtype=torch.bool, device=device),
        steps=torch.zeros((), **i64),
    )
    return params, state


def update_forces(params: BiasParams, state: BiasState, positions, mask=None, packed=None,
                  boundary_offset=None):
    """Batched bias energy and derivative lookup (edm_bias.cpp:276-311).
    ``positions`` (N, >= D): the first D components are the CV.  Returns
    (total energy, der (N, D)); the host applies ``forces[:, :D] -= der``.
    ``mask`` (N,) bool zeroes the unmasked rows; ``packed``: the bias
    grid's ``ops/interp.packed_corner_table``, if the host keeps one;
    ``boundary_offset`` (D,): the local-to-global shift of a grid in local
    coordinates against a global boundary (the spatial host)."""
    D = params.cfg.dim
    dtype = state.bias.dtype
    x = positions[..., :D]
    if params.b_outofbounds:
        return (torch.zeros((), dtype=dtype, device=x.device),
                torch.zeros(x.shape, dtype=dtype, device=x.device))
    v, der = state.bias.get_value_deriv(x, packed=packed, boundary_offset=boundary_offset)
    if mask is not None:
        zero = torch.zeros((), dtype=dtype, device=x.device)
        v = torch.where(mask, v, zero)
        der = torch.where(mask[..., None], der, zero)
    return torch.sum(v), der


class RoundRecords(NamedTuple):
    """What the hills log, the histogram and the tests need about one round
    (field for field the JAX package's ``RoundRecords``)."""

    drain_pos: torch.Tensor  # (DRAIN, D)
    drain_h: torch.Tensor  # heights attempted
    drain_dep_h: torch.Tensor  # effective deposited heights
    drain_s: torch.Tensor  # integral per unit height
    drain_processed: torch.Tensor
    drain_straddled: torch.Tensor
    hill_h: torch.Tensor  # (H,) post-tempering heights
    hill_dep_h: torch.Tensor
    hill_defer_h: torch.Tensor
    hill_s: torch.Tensor
    hill_called: torch.Tensor
    hill_deposited: torch.Tensor
    hill_straddled: torch.Tensor
    skipped: torch.Tensor  # scalar bool: whole round skipped
    round_bias: torch.Tensor  # scalar: temp_hill_cum at round end
    prefactor: torch.Tensor  # scalar: post-global-tempering prefactor


class HillRoundLog(NamedTuple):
    """What a host step returns for the HILLS log (``collect_records``):
    ``happened`` is False on a step without a hill round, whose payload is
    all zeros; ``positions`` are the (H, D) candidate centres fed to the
    round.  The driver replays these into the reference's event stream
    (``utils/hills_log``)."""

    happened: torch.Tensor  # bool scalar
    positions: torch.Tensor  # (H, D)
    rec: RoundRecords


def round_log_zeros(params: BiasParams, state: BiasState, n_hills: int) -> HillRoundLog:
    """The zero record of a step without a hill round, shaped as
    ``add_hills_round``'s records for ``n_hills`` candidates.  Made once
    per shape, dtype and device and shared, as ``grid.device_const``'s
    constants are: callers must not write into it."""
    drain = min(1024 if params.b_outofbounds else 256, state.buf_h.shape[0])
    return _zero_log(params.cfg.dim, drain, n_hills, state.bias.dtype, state.cum_bias.device)


@functools.lru_cache(maxsize=64)
def _zero_log(D, drain, n_hills, dtype, device) -> HillRoundLog:
    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    b = torch.bool
    rec = RoundRecords(
        drain_pos=z((drain, D)), drain_h=z(drain), drain_dep_h=z(drain), drain_s=z(drain),
        drain_processed=z(drain, b), drain_straddled=z(drain, b),
        hill_h=z(n_hills), hill_dep_h=z(n_hills), hill_defer_h=z(n_hills), hill_s=z(n_hills),
        hill_called=z(n_hills, b), hill_deposited=z(n_hills, b), hill_straddled=z(n_hills, b),
        skipped=z((), b), round_bias=z(()), prefactor=z(()),
    )
    return HillRoundLog(happened=z((), b), positions=z((n_hills, D)), rec=rec)


def _rdiv(a: float, t: torch.Tensor) -> torch.Tensor:
    """``a / t`` as a true division (``float / Tensor`` in PyTorch is a
    reciprocal times ``a``, which rounds differently)."""
    return torch.div(torch.full((), a, dtype=t.dtype, device=t.device), t)


def round_prefactor(params: BiasParams, state: BiasState) -> torch.Tensor:
    """Post-global-tempering hill prefactor (edm_bias.cpp:422-426)."""
    cfg = params.cfg
    pref = torch.full((), cfg.hill_prefactor, dtype=state.bias.dtype,
                      device=state.cum_bias.device)
    if cfg.global_tempering > 0:
        kT = params.boltzmann_factor
        avg = state.cum_bias / params.total_volume
        shrink = torch.exp(
            -(avg - cfg.global_tempering)
            / (cfg.global_tempering * (cfg.bias_factor - 1) * kT)
        )
        pref = torch.where(avg >= cfg.global_tempering, pref * shrink, pref)
    return pref


def _hill_heights(params, bias_grid, positions, est_hill_count, pref, target_positions=None,
                  boundary_offset=None):
    """Tempered, normalized, clamped per-hill heights (edm_bias.cpp:543-558)
    evaluated against ``bias_grid``.  ``target_positions``: where the target
    grid is evaluated when that differs from ``positions`` (the spatial
    host's local grid against its global target)."""
    cfg = params.cfg
    kT = params.boltzmann_factor
    h = torch.ones(positions.shape[:1], dtype=bias_grid.dtype,
                   device=positions.device) * pref
    if params.target is not None:
        tp = positions if target_positions is None else target_positions
        h = h * torch.exp(params.target.get_value(tp) - params.expected_target)
    if cfg.b_tempering and cfg.global_tempering < 0:
        # strict `< 0` as in edm_bias.cpp:547 (the code wins over the README)
        h = h * torch.exp(-bias_grid.get_value(positions, boundary_offset=boundary_offset)
                          / ((cfg.bias_factor - 1) * kT))
    if cfg.hill_density < 0:
        h = h / device_const(est_hill_count, h.device, h.dtype)
    else:
        h = h / cfg.hill_density
    return torch.clamp(h, max=BIAS_CLAMP * cfg.bias_per_step)


def hill_heights(params: BiasParams, state: BiasState, positions, est_hill_count,
                 target_positions=None, boundary_offset=None):
    """The heights this replica attaches to new hills, against the
    round-start grid (the spatial host's outgoing hills);
    ``target_positions`` and ``boundary_offset``: see ``_hill_heights``
    and ``update_forces``."""
    positions = positions.to(state.bias.dtype)[..., : params.cfg.dim]
    pref = round_prefactor(params, state)
    return _hill_heights(params, state.bias, positions, est_hill_count, pref,
                         target_positions=target_positions, boundary_offset=boundary_offset)


def add_hills_round(params: BiasParams, state: BiasState, positions, runiform,
                    est_hill_count, active=None, axis_name=None, override_heights=None,
                    boundary_offset=None, n_passes: int = 1):
    """One pre_add_hill / add_hill* / post_add_hill cycle.

    Returns ``(new_state, records, host_reads)``: ``host_reads`` counts the
    values the round read back to the host (the capping loop's flags,
    ``ops/prefix_cap``; the McGDP deposit's strip counts; the gate of each
    extra pass).  ``est_hill_count``: a number or a 0-d tensor.  The deposit
    route is the JAX round's: dense 1-D tables for small 1-D grids, with
    ``exact_deposit`` off separable tables for fully periodic 2-D/3-D grids
    and the McGovern–De Pablo tables for the other 2-D/3-D grids, else the
    windowed scatter; one route serves the drain and every hill pass.

    ``override_heights`` (H,): replay, as the JAX round: these heights are
    deposited for the ``active`` hills, with no acceptance draw and no
    tempering (do_add_hill with communicate=0, edm_bias.cpp:444).

    ``n_passes``: the new hills run as ``n_passes`` sequential sub-batches
    of H / n_passes (H must divide evenly), each evaluating its heights
    against the grid that holds the earlier passes' deposits, the cap
    carried across them.  A pass after the first runs only if it has a
    called hill: the JAX round gates it with a ``lax.cond`` on the device,
    this one with one host read per extra pass (counted in
    ``host_reads``); a skipped pass leaves the state as it was and records
    zeros and False, exactly as the JAX round's skip branch.

    ``axis_name``: the mesh axis (``parallel.make_mesh``) over which the
    round's bias is summed into ``cum_bias`` (update_height's Allreduce,
    edm_bias.cpp:922-931); every rank of the mesh must call the round.  The
    record keeps this rank's own ``round_bias``, as the JAX round's does.

    ``boundary_offset`` (D,): the local-to-global shift of the spatial
    host's grids: the drain and every pass evaluate the boundary terms,
    masks and boundary copies at ``x + boundary_offset``, and the McGDP
    table route is off (as in the JAX round).

    The round runs in the span ``edm.round`` (``utils/trace``) and counts
    its hills there."""
    trace.count("rounds")
    with trace.span(trace.ROUND):
        return _add_hills_round(params, state, positions, runiform, est_hill_count, active,
                                axis_name, override_heights, boundary_offset, n_passes)


def _add_hills_round(params, state, positions, runiform, est_hill_count, active, axis_name,
                     override_heights, boundary_offset, n_passes):
    cfg = params.cfg
    D = cfg.dim
    dtype = state.bias.dtype
    dev = state.cum_bias.device
    positions = positions.to(dtype)[..., :D]
    runiform = runiform.to(dtype)
    H = positions.shape[0]
    CAP = state.buf_h.shape[0]
    cap_bias = cfg.bias_per_step
    vol = float(np.prod(state.bias.spec.grid.dx))
    zero = torch.zeros((), dtype=dtype, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    if active is None:
        active = torch.ones(H, dtype=torch.bool, device=dev)

    if params.b_outofbounds:
        DRAIN0 = min(1024, CAP)
        zf = torch.zeros(H, dtype=dtype, device=dev)
        zb = torch.zeros(H, dtype=torch.bool, device=dev)
        new_state = dataclasses.replace(state, steps=state.steps + 1)
        if axis_name is not None:  # a passive replica still enters the sum, adding 0
            new_state = dataclasses.replace(
                new_state, cum_bias=state.cum_bias + _psum_axis(zero, axis_name))
        rec = RoundRecords(
            drain_pos=state.buf_pos[:DRAIN0], drain_h=state.buf_h[:DRAIN0],
            drain_dep_h=torch.zeros(DRAIN0, dtype=dtype, device=dev),
            drain_s=torch.zeros(DRAIN0, dtype=dtype, device=dev),
            drain_processed=torch.zeros(DRAIN0, dtype=torch.bool, device=dev),
            drain_straddled=torch.zeros(DRAIN0, dtype=torch.bool, device=dev),
            hill_h=zf, hill_dep_h=zf, hill_defer_h=zf, hill_s=zf,
            hill_called=zb, hill_deposited=zb, hill_straddled=zb,
            skipped=torch.ones((), dtype=torch.bool, device=dev),
            round_bias=zero,
            prefactor=torch.full((), cfg.hill_prefactor, dtype=dtype, device=dev),
        )
        return new_state, rec, 0
    if H % n_passes:
        raise ValueError("n_passes must divide the hill batch size")

    # the deposit route (edm_tpu/bias.py add_hills_round, use_dense*)
    gs = state.bias.spec
    windows_fit = all(w < n for w, n in zip(gs.window_shape, gs.grid.nbins))
    use_dense = (D == 1 and gs.grid.nbins[0] <= 1024
                 and (not gs.grid.periodic[0] or gs.window_shape[0] < gs.grid.nbins[0]))
    use_dense2 = (D in (2, 3) and not params.exact_deposit and all(gs.grid.periodic)
                  and all(gs.boundary_periodic) and windows_fit)
    use_dense2m = (D in (2, 3) and not params.exact_deposit and not all(gs.boundary_periodic)
                   and boundary_offset is None and windows_fit)

    def _tables(bias_g, pos):
        """(deposit tables, unit integrals s) from the grid's geometry."""
        if use_dense:
            Mval, Mder, s = dense_tables_1d(bias_g, pos, boundary_offset)
            return (Mval, Mder), s
        if use_dense2:
            return dense_tables_sep(bias_g, pos)
        if use_dense2m:
            tabs = dense_tables_mcgdp(bias_g, pos)
            return tabs, tabs.s
        hw = hill_windows(bias_g, pos, boundary_offset)
        return hw, torch.sum(hw.value_w, dim=-1) * vol

    def _deposit(bias_g, tabs, dep_h):
        """(new grid, host reads)."""
        if use_dense:
            return deposit_from_tables(bias_g, tabs[0], tabs[1], dep_h, boundary_offset), 0
        if use_dense2:
            return deposit_from_tables_sep(bias_g, tabs, dep_h), 0
        if use_dense2m:
            return deposit_from_mcgdp(bias_g, tabs, dep_h)
        return deposit_precomputed(bias_g, tabs, dep_h, boundary_offset)[0], 0

    # 1. global tempering (edm_bias.cpp:422-426)
    pref = round_prefactor(params, state)

    with trace.span(trace.ROUND_DRAIN):
        # 2. drain a bounded window (256 slots from buf_left) of the deferred
        # buffer; the start clamps like the JAX package's dynamic_slice
        DRAIN = min(256, CAP)
        widx = torch.clamp(state.buf_left, 0, CAP - DRAIN) + torch.arange(DRAIN, device=dev)
        win_pos = state.buf_pos[widx]
        win_h = state.buf_h[widx]
        n_buf = state.buf_right - state.buf_left
        win_active = torch.arange(DRAIN, device=dev) < n_buf
        btabs, s_buf = _tables(state.bias, win_pos)
        dr = drain_scan(win_h, s_buf, win_active, cap_bias)
        bias1, reads = _deposit(state.bias, btabs, dr.dep_heights)
        full_buf_h = state.buf_h.index_copy(0, widx, dr.new_heights)

        remaining_w = win_active & ~dr.consumed
        any_rem_w = torch.any(remaining_w)
        any_rem = any_rem_w | (n_buf > DRAIN)
        first_rem = torch.where(any_rem_w, torch.argmax(remaining_w.to(torch.int8)),
                                torch.full((), DRAIN, **i64))
        left1 = torch.where(any_rem, state.buf_left + torch.minimum(first_rem, n_buf),
                            torch.zeros((), **i64))
        right1 = torch.where(any_rem, state.buf_right, torch.zeros((), **i64))
        skip = any_rem  # b_skip_hill_add_ (edm_bias.cpp:436-439)

        # drained-buffer compaction: surviving slots left1..right1 shift to 0
        src = torch.arange(CAP, device=dev) + left1
        valid_src = src < right1
        src_c = torch.clamp(src, 0, CAP - 1)
        buf_pos2 = torch.where(valid_src[:, None], state.buf_pos[src_c], zero)
        buf_h2 = torch.where(valid_src, full_buf_h[src_c], zero)
        size2 = right1 - left1

        # histogram (output_hill bookkeeping, edm_bias.cpp:601-610): drain part
        drain_delta = dr.processed.to(dtype) - dr.straddled.to(dtype)
        hist, _ = state.cv_hist.add_value(win_pos, drain_delta)
        trace.count_device("hills.drained", dr.processed)
        trace.count_device("rounds.skipped", skip)

    # 3. acceptance (edm_bias.cpp:528-543), batch-wide
    if override_heights is not None:
        # replay: acceptance, tempering and clamping happened where the
        # heights were made; the (position, height) pairs are used as given
        accept = active
        override_h = override_heights.to(dtype)
    else:
        override_h = None
        if cfg.hill_density < 0:
            accept = active
        elif isinstance(est_hill_count, torch.Tensor):
            accept = active & (runiform < _rdiv(cfg.hill_density, est_hill_count))
        else:  # a Python number, as the JAX package divides it (in float64)
            accept = active & (runiform < cfg.hill_density / est_hill_count)
    called_all = accept & ~skip

    # 4/5. per pass: heights (against the grid holding the earlier passes),
    # sequential cap + deposit commit + FIFO overflow append
    Hc = H // n_passes
    bias_c, bufp, bufh, size_c, cum = bias1, buf_pos2, buf_h2, size2, dr.bias_added
    recs = []
    for p in range(n_passes):
        sl = slice(p * Hc, (p + 1) * Hc)
        called_p = called_all[sl]
        if p > 0:
            reads += 1
            if not trace.read(None, "pass_gate", torch.any(called_p)):  # the JAX round's skip
                zf = torch.zeros(Hc, dtype=dtype, device=dev)
                zb = torch.zeros(Hc, dtype=torch.bool, device=dev)
                recs.append((zf, zf, zf, zf, zb, zb, zb))
                continue
        pos_p = positions[sl]
        with trace.span(trace.ROUND_HEIGHTS):
            if override_h is not None:
                h_p = override_h[sl]
            else:
                h_p = _hill_heights(params, bias_c, pos_p, est_hill_count, pref,
                                    boundary_offset=boundary_offset)
            tabs_p, s_p = _tables(bias_c, pos_p)
        with trace.span(trace.ROUND_LIMITER):
            cr, n_reads = cap_scan(h_p, s_p, called_p, cap_bias, cum)
        with trace.span(trace.ROUND_DEPOSIT):
            bias_c, n_dep = _deposit(bias_c, tabs_p, cr.dep_heights)
            reads += n_reads + n_dep
            to_defer = called_p & (cr.defer_heights > 0)
            rank = torch.cumsum(to_defer.to(torch.int64), 0) - 1
            tgt = torch.where(to_defer, size_c + rank, torch.full((), CAP, **i64))
            if trace.enabled():
                trace.count_device("hills.dropped", to_defer & (tgt >= CAP))
            tgt = torch.where(tgt < CAP, tgt, torch.full((), CAP, **i64))  # CAP = dropped
            bufp = torch.cat([bufp, bufp[:1]]).index_put((tgt,), pos_p)[:CAP]
            bufh = torch.cat([bufh, bufh[:1]]).index_put((tgt,), cr.defer_heights)[:CAP]
            size_c = size_c + torch.sum(to_defer.to(torch.int64))
            hill_delta = called_p.to(dtype) - cr.straddled.to(dtype)
            hist, _ = hist.add_value(pos_p, hill_delta)
            cum = cr.cum
            trace.count_device("hills.called", called_p)
            trace.count_device("hills.deposited", cr.deposited)
            trace.count_device("hills.deferred", to_defer)
        recs.append((h_p, cr.dep_heights, cr.defer_heights, s_p, called_p, cr.deposited,
                     cr.straddled))
    rec_h = [r[0] if n_passes == 1 else torch.cat(r) for r in zip(*recs)]

    # 7. cum_bias (update_height, edm_bias.cpp:922-931)
    new_state = BiasState(
        bias=bias_c,
        cv_hist=hist,
        cum_bias=state.cum_bias + (cum if axis_name is None else _psum_axis(cum, axis_name)),
        buf_pos=bufp,
        buf_h=bufh,
        buf_left=torch.zeros((), **i64),
        buf_right=torch.clamp(size_c, max=CAP),
        overflow_error=state.overflow_error | (size_c > CAP),
        steps=state.steps + 1,
    )
    rec = RoundRecords(
        drain_pos=win_pos, drain_h=win_h, drain_dep_h=dr.dep_heights,
        drain_s=s_buf, drain_processed=dr.processed,
        drain_straddled=dr.straddled,
        hill_h=rec_h[0], hill_dep_h=rec_h[1], hill_defer_h=rec_h[2], hill_s=rec_h[3],
        hill_called=rec_h[4], hill_deposited=rec_h[5], hill_straddled=rec_h[6],
        skipped=skip, round_bias=cum, prefactor=pref,
    )
    return new_state, rec, reads


def _psum_axis(t, axis_name: str):
    from .parallel.collectives import psum

    return psum(t, axis_name)


def check_state(state: BiasState) -> None:
    """Host-side invariant check (the reference aborts inside add_hill,
    edm_bias.cpp:501-507)."""
    if bool(state.overflow_error):
        edm_error(
            "The bias overflow buffer is full. Too many hills. Either increase "
            "buffer_size, lower hill_density, or lower bias",
            "bias.py:add_hills_round",
        )
