"""User-facing ``EDMBias`` in PyTorch — the reference's public surface: the
C++ engine API (lib/edm_bias.h:36-116), the Boost.Python binding
(python/edm/edm_python.cxx:8-18: set_box, pre_add_hill, add_hill_r,
post_add_hill, write_bias, write_lammps_table, write_histogram,
clear_histogram, get_force) and the ``edm`` package's ``add_hill``
(python/edm/edm/__init__.py:4-8).

Counterpart of ``edm_tpu/api.py``, with one more keyword, ``device``: the
bias lives on the card unless the caller asks for the CPU.  The class is
the host shell: it owns the config, the files and the HILLS log, and a
``BiasState`` that ``bias.add_hills_round`` advances; MD hosts
(``models/``) call the engine functions directly.

Binding quirks kept: ``set_box(lo, hi, periodic)`` honours its periodic
argument (the reference's ``subdivide_py`` drops it, SURVEY.md Q4);
``get_force`` returns +dU/dx as the binding does (the gradient, despite its
name; ``update_force(s)`` apply the negated gradient).

Host syncs: a round copies its rows to the device (from pageable memory,
which waits), reads what ``add_hills_round`` reads (the capping loop's
exit flags), then the state's counters and the round's bias in one copy
(``check_state``, the stall warning, the HILLS log's step and cum_bias),
and, when logging, the round's records in one more copy.  Each is counted
in ``host_syncs``.
"""

from __future__ import annotations

import dataclasses
import random as _pyrandom
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from . import bias as _bias
from .grid import Grid
from .utils.config import EDMConfig, parse_edm_file
from .utils.errors import edm_error
from .utils.gridio import read_grid_file, write_grid, write_lammps_table
from .utils.hills_log import HillsLog


def _padded(n: int) -> int:
    """The batch a round runs: ``n`` padded to a power of two, as the JAX
    package pads it to bound retraces (it sets how ``hill_passes``
    divides the batch, so it stays for parity)."""
    return max(1, 1 << (n - 1).bit_length()) if n else 1


class EDMBias:
    def __init__(
        self,
        input_filename: str,
        temperature: Optional[float] = None,
        boltzmann_constant: Optional[float] = None,
        dtype=torch.float64,
        rank: int = 0,
        log_hills: bool = True,
        exact_deposit: bool = False,
        hill_passes=1,
        device="cuda",
    ):
        # exact_deposit: the reference-exact windowed deposit even where a
        # table route exists (bias.BiasParams.exact_deposit).  hill_passes:
        # each round in this many sequential sub-batches
        # (bias.add_hills_round n_passes); "live" = one hill a pass, the
        # reference's hill-by-hill live-grid tempering (edm_bias.cpp:547-550);
        # an integer must divide the padded batch (a power of two does)
        self.cfg: EDMConfig = parse_edm_file(input_filename)
        self.dim = self.cfg.dim
        self.temperature = -1.0
        self.boltzmann_factor = -1.0
        self._kB = -1.0
        self.rank = rank
        self.dtype = dtype
        self.device = torch.device(device)
        self._log_hills = log_hills
        self._exact_deposit = bool(exact_deposit)
        if hill_passes != "live":
            hill_passes = int(hill_passes)
            if hill_passes < 1 or (hill_passes & (hill_passes - 1)):
                edm_error("hill_passes must be a power of two (to divide the "
                          "padded batch) or 'live'", "api.py")
        self._hill_passes = hill_passes

        self.target: Optional[Grid] = None
        if self.cfg.target_filename:
            # no interpolation for the target (edm_bias.cpp:1061)
            self.target = read_grid_file(self.cfg.target_filename, dim=self.dim,
                                         interpolate=False, dtype=dtype, device=self.device)
        self.initial_bias: Optional[Grid] = None
        if self.cfg.initial_bias_filename:
            self.initial_bias = read_grid_file(self.cfg.initial_bias_filename, dim=self.dim,
                                               interpolate=True, dtype=dtype,
                                               device=self.device)

        self.params = None
        self.state = None
        self.hills_log: Optional[HillsLog] = None
        self.mask = None
        self.host_syncs = 0

        self._pending_positions = []
        self._pending_runiform = []
        self._est_hill_count = 0
        self._warned_stall = False
        self._rounds = 0  # the state's hill-round counter, on the host
        self._cum_host = 0.0  # its cum_bias, on the host

        if temperature is not None and boltzmann_constant is not None:
            self.setup(temperature, boltzmann_constant)

    # ------------------------------------------------------------------ setup

    def setup(self, temperature: float, boltzmann_constant: float) -> None:
        """Learn the temperature and kT (edm_bias.cpp:264-269)."""
        self.temperature = float(temperature)
        self.boltzmann_factor = float(boltzmann_constant) * float(temperature)
        self._kB = float(boltzmann_constant)

    def subdivide(self, sublo, subhi, boxlo, boxhi, b_periodic, skin) -> None:
        if self.state is not None:
            return  # idempotent, as the reference (edm_bias.cpp:121-122)
        if self.temperature < 0:
            edm_error("Must call setup before subdivide", "api.py:subdivide")
        self.params, self.state = _bias.subdivide(
            self.cfg, self.temperature, self._kB, sublo, subhi, boxlo, boxhi, b_periodic,
            skin, target=self.target, initial_bias=self.initial_bias, dtype=self.dtype,
            device=self.device, exact_deposit=self._exact_deposit,
        )
        if self._log_hills:
            name = f"{self.cfg.hills_filename}_{self.rank}"
            self.hills_log = HillsLog(name, self.dim, self.params.total_volume)

    def set_box(self, boxlo: Sequence[float], boxhi: Sequence[float],
                periodic: Sequence[bool]) -> None:
        """The binding's convenience (edm_bias_py.cpp:29-48): the whole box
        on one replica, no skin; periodicity honoured."""
        self.subdivide(boxlo, boxhi, boxlo, boxhi, [bool(p) for p in periodic],
                       [0.0] * self.dim)

    def set_mask(self, mask) -> None:
        self.mask = np.asarray(mask)

    # ----------------------------------------------------------------- forces

    def _points(self, positions) -> torch.Tensor:
        return torch.as_tensor(np.asarray(positions, dtype=float)).to(self.device)

    def update_forces(self, positions, forces, apply_mask: Optional[int] = None) -> float:
        """Array force update (edm_bias.cpp:276-295): the bias gradient at
        each position, applied as ``forces[:, :dim] -= dU/dx`` to the numpy
        array ``forces``.  Returns the bias energy."""
        mask = None
        if apply_mask is not None and self.mask is not None:
            mask = torch.as_tensor((self.mask & apply_mask) != 0).to(self.device)
        e, der = _bias.update_forces(self.params, self.state, self._points(positions), mask)
        host = torch.cat([e.reshape(1).to(der.dtype), der.reshape(-1)]).cpu().numpy()
        forces[:, : self.dim] -= host[1:].reshape(der.shape)
        return float(host[0])

    def update_force(self, position, forces) -> float:
        """Single-CV force update (edm_bias.cpp:297-311)."""
        p = np.asarray(position, dtype=float)[None, :]
        e, der = _bias.update_forces(self.params, self.state, self._points(p))
        host = torch.cat([e.reshape(1).to(der.dtype), der[0]]).cpu().numpy()
        forces[: self.dim] -= host[1:]
        return float(host[0])

    def get_force(self, position):
        """The binding's surface (edm_bias_py.cpp:63-79): (energy, dU/dx
        list), the *gradient*, not its negation."""
        p = self._points(np.asarray(position, dtype=float)[None, :]).to(self.dtype)
        v, der = self.state.bias.get_value_deriv(p)
        host = torch.cat([v, der[0]]).cpu().numpy()
        return float(host[0]), [float(x) for x in host[1:]]

    # ------------------------------------------------------------------ hills

    def _require_state(self):
        if self.state is None:
            edm_error("Must call set_box/subdivide before using the bias", "api.py")

    def pre_add_hill(self, est_hill_count: int) -> None:
        self._require_state()
        self._pending_positions = []
        self._pending_runiform = []
        self._est_hill_count = int(est_hill_count)

    def add_hill_r(self, position, runiform: float) -> None:
        self._pending_positions.append(list(np.asarray(position, dtype=float)[: self.dim]))
        self._pending_runiform.append(float(runiform))

    def add_hill(self, position) -> None:
        """One-hill pre/add/post cycle (python/edm/edm/__init__.py:4-8)."""
        self.pre_add_hill(1)
        self.add_hill_r(position, _pyrandom.random())
        self.post_add_hill()

    def post_add_hill(self) -> None:
        n = len(self._pending_positions)
        rows = np.zeros((_padded(n), self.dim + 2))
        rows[:, self.dim] = 1.0
        if n:
            rows[:n, : self.dim] = self._pending_positions
            rows[:n, self.dim] = self._pending_runiform
            rows[:n, self.dim + 1] = 1.0
        self._run_round(rows, self._est_hill_count)
        self._pending_positions = []
        self._pending_runiform = []

    def add_hills(self, positions, runiform, apply_mask: Optional[int] = None) -> None:
        """Batch interface (edm_bias.cpp:397-411), padded to a power of two
        as ``post_add_hill``."""
        self._require_state()
        positions = np.asarray(positions, dtype=float)
        n = positions.shape[0]
        active = np.ones((n,), bool)
        if apply_mask is not None and self.mask is not None:
            active = (self.mask[:n] & apply_mask) != 0
        rows = np.zeros((_padded(n), self.dim + 2))
        rows[:, self.dim] = 1.0
        rows[:n, : self.dim] = positions[:, : self.dim]
        rows[:n, self.dim] = np.asarray(runiform, dtype=float)
        rows[:n, self.dim + 1] = active
        self._run_round(rows, n)

    def _run_round(self, rows: np.ndarray, est_hill_count) -> None:
        """One round over the padded (H, D + 2) rows: centres, acceptance
        uniforms, active flags; they go to the device in one copy."""
        D = self.dim
        H = rows.shape[0]
        dev_rows = torch.as_tensor(rows).to(self.device)
        positions = dev_rows[:, :D].to(self.dtype)
        runiform = dev_rows[:, D].to(self.dtype)
        active = dev_rows[:, D + 1] != 0
        n_passes = H if self._hill_passes == "live" else min(self._hill_passes, H)
        est = torch.full((), float(est_hill_count), dtype=self.dtype, device=self.device)
        cum_before, step = self._cum_host, self._rounds
        self.state, rec, reads = _bias.add_hills_round(
            self.params, self.state, positions, runiform, est, active, n_passes=n_passes)
        st = self.state
        # check_state, the stall test and the next round's log columns, in
        # one read
        host = torch.stack([st.cum_bias.to(torch.float64), st.steps.to(torch.float64),
                            (st.buf_right - st.buf_left).to(torch.float64),
                            st.overflow_error.to(torch.float64),
                            rec.round_bias.to(torch.float64)]).cpu().numpy()
        self.host_syncs += reads + 2  # and the rows' copy from pageable memory
        self._cum_host, self._rounds = float(host[0]), int(host[1])
        if host[3]:
            _bias.check_state(st)
        # stall: a single hill whose integral exceeds bias_per_step is
        # deposited and fully undone every round (the reference silently
        # loops forever on such configs; its own python example does this)
        if not self._warned_stall and host[2] > 0 and host[4] == 0.0:
            warnings.warn(
                "EDM hill round deposited zero bias while hills remain "
                "deferred: a single hill's integrated bias likely exceeds "
                "bias_per_step (raise bias_per_step or shrink "
                "hill_prefactor/bias_sigma). The reference implementation "
                "silently loops forever on such configs.",
                stacklevel=3,
            )
            self._warned_stall = True
        if self.hills_log is not None:
            self.hills_log.log_round(step, cum_before, rec, positions)
            self.host_syncs += 1

    # --------------------------------------------------------------- file I/O

    def write_bias(self, output: str) -> None:
        write_grid(self.state.bias.grid, output)

    def write_lammps_table(self, output: str) -> None:
        write_lammps_table(self.state.bias.grid, output, self.params.cfg.box_low,
                           self.params.cfg.box_high)

    def write_histogram(self) -> None:
        write_grid(self.state.cv_hist, self.cfg.histogram_filename)

    def clear_histogram(self) -> None:
        self.state = dataclasses.replace(self.state, cv_hist=self.state.cv_hist.clear())

    # ------------------------------------------------------------- inspection

    @property
    def cum_bias(self) -> float:
        return float(self.state.cum_bias)

    @property
    def bias_grid(self):
        return self.state.bias

    def bias_value(self, position) -> float:
        p = self._points(np.asarray(position, dtype=float)[None, :]).to(self.dtype)
        return float(self.state.bias.get_value(p)[0])
