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

Ported for the 1-D pairwise slice: one hill pass (``n_passes=1``) with the
dense 1-D deposit tables.  Not ported yet: ``update_forces`` and multi-pass
rounds (ROADMAP Queue 1, item 2), N-D and windowed deposition (items 8 and
9), replay heights and sharded offsets (item 12), initial-bias files
(item 10).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from .gauss import GaussGrid
from .grid import Grid, GridSpec
from .ops.deposit import deposit_from_tables, dense_tables_1d
from .ops.prefix_cap import cap_scan, drain_scan
from .utils.config import EDMConfig
from .utils.errors import edm_error

BIAS_CLAMP = 1.0  # edm_bias.h:14
BIAS_BUFFER_SIZE = 2048  # edm_bias.h:15


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
    device="cpu",
    buffer_size: int = BIAS_BUFFER_SIZE,
    n_replicas: int = 1,
    exact_deposit: bool = False,
) -> Tuple[BiasParams, BiasState]:
    """Build the local bias grid for this domain (edm_bias.cpp:98-222)."""
    if initial_bias is not None:
        raise NotImplementedError(
            "initial bias grids are not ported yet (ROADMAP Queue 1, item 10)"
        )
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


def _hill_heights(params, bias_grid, positions, est_hill_count, pref):
    """Tempered, normalized, clamped per-hill heights (edm_bias.cpp:543-558)
    evaluated against ``bias_grid``."""
    cfg = params.cfg
    kT = params.boltzmann_factor
    h = torch.ones(positions.shape[:1], dtype=bias_grid.dtype,
                   device=positions.device) * pref
    if params.target is not None:
        h = h * torch.exp(params.target.get_value(positions) - params.expected_target)
    if cfg.b_tempering and cfg.global_tempering < 0:
        # strict `< 0` as in edm_bias.cpp:547 (the code wins over the README)
        h = h * torch.exp(-bias_grid.get_value(positions) / ((cfg.bias_factor - 1) * kT))
    if cfg.hill_density < 0:
        h = h / est_hill_count
    else:
        h = h / cfg.hill_density
    return torch.clamp(h, max=BIAS_CLAMP * cfg.bias_per_step)


def hill_heights(params: BiasParams, state: BiasState, positions, est_hill_count):
    """The heights this replica attaches to new hills, against the
    round-start grid."""
    positions = positions.to(state.bias.dtype)[..., : params.cfg.dim]
    pref = round_prefactor(params, state)
    return _hill_heights(params, state.bias, positions, est_hill_count, pref)


def add_hills_round(params: BiasParams, state: BiasState, positions, runiform,
                    est_hill_count, active=None):
    """One pre_add_hill / add_hill* / post_add_hill cycle.

    Returns ``(new_state, records, host_reads)``: ``host_reads`` counts the
    flags the capping loop read back to the host (``ops/prefix_cap``).
    Only the single-pass dense 1-D deposit is ported."""
    cfg = params.cfg
    D = cfg.dim
    dtype = state.bias.dtype
    dev = state.cum_bias.device
    positions = positions.to(dtype)[..., :D]
    runiform = runiform.to(dtype)
    H = positions.shape[0]
    CAP = state.buf_h.shape[0]
    cap_bias = cfg.bias_per_step
    zero = torch.zeros((), dtype=dtype, device=dev)
    i64 = dict(dtype=torch.int64, device=dev)
    if active is None:
        active = torch.ones(H, dtype=torch.bool, device=dev)

    if params.b_outofbounds:
        DRAIN0 = min(1024, CAP)
        zf = torch.zeros(H, dtype=dtype, device=dev)
        zb = torch.zeros(H, dtype=torch.bool, device=dev)
        new_state = dataclasses.replace(state, steps=state.steps + 1)
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

    g1 = state.bias.spec
    if not (D == 1 and g1.grid.nbins[0] <= 1024
            and (not g1.grid.periodic[0] or g1.window_shape[0] < g1.grid.nbins[0])):
        raise NotImplementedError(
            "add_hills_round is ported for the dense 1-D deposit only "
            "(ROADMAP Queue 1, items 8 and 9)"
        )

    # 1. global tempering (edm_bias.cpp:422-426)
    pref = round_prefactor(params, state)

    # 2. drain a bounded window (256 slots from buf_left) of the deferred
    # buffer; the start clamps like the JAX package's dynamic_slice
    DRAIN = min(256, CAP)
    widx = torch.clamp(state.buf_left, 0, CAP - DRAIN) + torch.arange(DRAIN, device=dev)
    win_pos = state.buf_pos[widx]
    win_h = state.buf_h[widx]
    n_buf = state.buf_right - state.buf_left
    win_active = torch.arange(DRAIN, device=dev) < n_buf
    bMval, bMder, s_buf = dense_tables_1d(state.bias, win_pos)
    dr = drain_scan(win_h, s_buf, win_active, cap_bias)
    bias1 = deposit_from_tables(state.bias, bMval, bMder, dr.dep_heights)
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

    # 3. acceptance (edm_bias.cpp:528-543), batch-wide
    if cfg.hill_density < 0:
        accept = active
    else:
        accept = active & (runiform < _rdiv(cfg.hill_density, est_hill_count))
    called = accept & ~skip

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

    # 4/5. heights + sequential cap + deposit commit + FIFO overflow append
    h_p = _hill_heights(params, bias1, positions, est_hill_count, pref)
    Mval, Mder, s_p = dense_tables_1d(bias1, positions)
    cr, reads = cap_scan(h_p, s_p, called, cap_bias, dr.bias_added)
    bias2 = deposit_from_tables(bias1, Mval, Mder, cr.dep_heights)
    to_defer = called & (cr.defer_heights > 0)
    rank = torch.cumsum(to_defer.to(torch.int64), 0) - 1
    tgt = torch.where(to_defer, size2 + rank, torch.full((), CAP, **i64))
    tgt = torch.where(tgt < CAP, tgt, torch.full((), CAP, **i64))  # CAP = dropped
    buf_pos3 = torch.cat([buf_pos2, buf_pos2[:1]]).index_put((tgt,), positions)[:CAP]
    buf_h3 = torch.cat([buf_h2, buf_h2[:1]]).index_put((tgt,), cr.defer_heights)[:CAP]
    size_f = size2 + torch.sum(to_defer.to(torch.int64))
    hill_delta = called.to(dtype) - cr.straddled.to(dtype)
    hist, _ = hist.add_value(positions, hill_delta)

    # 7. cum_bias (update_height, edm_bias.cpp:922-931)
    new_state = BiasState(
        bias=bias2,
        cv_hist=hist,
        cum_bias=state.cum_bias + cr.cum,
        buf_pos=buf_pos3,
        buf_h=buf_h3,
        buf_left=torch.zeros((), **i64),
        buf_right=torch.clamp(size_f, max=CAP),
        overflow_error=state.overflow_error | (size_f > CAP),
        steps=state.steps + 1,
    )
    rec = RoundRecords(
        drain_pos=win_pos, drain_h=win_h, drain_dep_h=dr.dep_heights,
        drain_s=s_buf, drain_processed=dr.processed,
        drain_straddled=dr.straddled,
        hill_h=h_p, hill_dep_h=cr.dep_heights, hill_defer_h=cr.defer_heights,
        hill_s=s_p, hill_called=called, hill_deposited=cr.deposited,
        hill_straddled=cr.straddled, skipped=skip, round_bias=cr.cum,
        prefactor=pref,
    )
    return new_state, rec, reads


def check_state(state: BiasState) -> None:
    """Host-side invariant check (the reference aborts inside add_hill,
    edm_bias.cpp:501-507)."""
    if bool(state.overflow_error):
        edm_error(
            "The bias overflow buffer is full. Too many hills. Either increase "
            "buffer_size, lower hill_density, or lower bias",
            "bias.py:add_hills_round",
        )
