"""Gaussian-hill grid (reference ``DimmedGaussGrid``,
lib/gaussian_grid.h:41-631) in PyTorch.

Counterpart of ``edm_tpu/gauss.py``: a ``GaussGrid`` composes a
derivative-carrying ``Grid`` with the deposition geometry — sigma stored
pre-scaled by sqrt(2) (gaussian_grid.h:74-76), a system boundary distinct
from the grid bounds (set_boundary, :378-435), the support window
(update_minigrid, :559-569) and the McGovern–De Pablo boundary-correction
tables (65,536 entries per non-periodic dim), built in float64 on the host
and cast.  Deposition lives in ``ops/deposit.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .grid import Grid, GridSpec, _const, device_const

GAUSS_SUPPORT = 8.0  # sigma^2 support cutoff (gaussian_grid.h:10)
BC_TABLE_SIZE = 65536  # boundary-correction table entries (gaussian_grid.h:11)
BC_MAR = 2.0  # sigmoid margin in sigmas (gaussian_grid.h:12)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Interval sigmoid 2x^3-3x^2+1 on [0,1], 1 below, 0 above
    (gaussian_grid.h:16-23)."""
    core = 2 * x**3 - 3 * x**2 + 1
    one = torch.ones_like(x)
    return torch.where(x < 0, one, torch.where(x > 1, torch.zeros_like(x), core))


def sigmoid_dx(x: torch.Tensor) -> torch.Tensor:
    core = 6 * x**2 - 6 * x
    return torch.where((x < 0) | (x > 1), torch.zeros_like(x), core)


def ref_round(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero (reference lib/grid.h:22-26)."""
    return torch.where(x < 0, torch.ceil(x - 0.5), torch.floor(x + 0.5))


@dataclasses.dataclass(frozen=True)
class GaussSpec:
    """Static deposition geometry layered over a GridSpec."""

    grid: GridSpec
    sigma: Tuple[float, ...]  # pre-scaled by sqrt(2)
    boundary_min: Tuple[float, ...]
    boundary_max: Tuple[float, ...]
    boundary_periodic: Tuple[bool, ...]

    @property
    def dim(self) -> int:
        return self.grid.dim

    @property
    def minisize(self) -> Tuple[int, ...]:
        """Per-dim window half-width in grid points (gaussian_grid.h:559-569)."""
        return tuple(
            int(math.floor(math.sqrt(2 * GAUSS_SUPPORT) * self.sigma[d] / self.grid.dx[d]))
            for d in range(self.dim)
        )

    @property
    def window_shape(self) -> Tuple[int, ...]:
        return tuple(2 * m + 1 for m in self.minisize)

    @property
    def volume(self) -> float:
        """Boundary volume (gaussian_grid.h:437-444)."""
        v = 1.0
        for d in range(self.dim):
            v *= self.boundary_max[d] - self.boundary_min[d]
        return v


def compute_bc_tables(spec: GaussSpec, dtype=torch.float32, device="cpu"):
    """McGovern–De Pablo denominator and derivative tables
    (gaussian_grid.h:392-433), in float64 numpy, then cast.  Periodic
    boundary dims keep 1/0 (unused)."""
    D = spec.dim
    denom = np.ones((D, BC_TABLE_SIZE), dtype=np.float64)
    ddenom = np.zeros((D, BC_TABLE_SIZE), dtype=np.float64)

    def _sig(x):
        core = 2 * x**3 - 3 * x**2 + 1
        return np.where(x < 0, 1.0, np.where(x > 1, 0.0, core))

    def _sig_dx(x):
        core = 6 * x**2 - 6 * x
        return np.where((x < 0) | (x > 1), 0.0, core)

    verf = np.vectorize(math.erf)
    for d in range(D):
        if spec.boundary_periodic[d]:
            continue
        bmin, bmax = spec.boundary_min[d], spec.boundary_max[d]
        sig = spec.sigma[d]
        s = np.arange(BC_TABLE_SIZE) * (bmax - bmin) / (BC_TABLE_SIZE - 1) + bmin
        tmp1 = math.sqrt(math.pi) * sig / 2.0 * (verf((s - bmin) / sig) + verf((bmax - s) / sig))
        tmp2 = math.sqrt(math.pi) * sig / 2.0 * math.erf((bmax - bmin) / sig)
        t = tmp1.copy()
        t += (tmp2 - tmp1) * _sig((s - bmin) / (BC_MAR * sig))
        t += (tmp2 - tmp1) * _sig((bmax - s) / (BC_MAR * sig))
        denom[d] = t

        tmp3 = np.exp(-((s - bmin) ** 2) / sig**2) - np.exp(-((bmax - s) ** 2) / sig**2)
        dt = tmp3.copy()
        dt += (tmp2 - tmp1) * _sig_dx((s - bmin) / (BC_MAR * sig)) / (BC_MAR * sig) - tmp3 * _sig(
            (s - bmin) / (BC_MAR * sig)
        )
        dt += -(tmp2 - tmp1) * _sig_dx((bmax - s) / (BC_MAR * sig)) / (BC_MAR * sig) - tmp3 * _sig(
            (bmax - s) / (BC_MAR * sig)
        )
        ddenom[d] = dt

    return (torch.tensor(denom, dtype=dtype, device=device),
            torch.tensor(ddenom, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class GaussGrid:
    """Derivative-carrying grid + boundary-correction tables + GaussSpec."""

    grid: Grid
    bc_denom: torch.Tensor  # (D, BC_TABLE_SIZE)
    bc_denom_deriv: torch.Tensor
    spec: GaussSpec

    @classmethod
    def create(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        bin_spacing: Sequence[float],
        periodic: Sequence[bool],
        sigma: Sequence[float],
        interpolate: bool = True,
        boundary_min: Optional[Sequence[float]] = None,
        boundary_max: Optional[Sequence[float]] = None,
        boundary_periodic: Optional[Sequence[bool]] = None,
        dtype=torch.float32,
        device="cpu",
    ) -> "GaussGrid":
        gspec = GridSpec.create(min, max, bin_spacing, periodic)
        spec = GaussSpec(
            grid=gspec,
            sigma=tuple(float(s) * math.sqrt(2.0) for s in sigma),
            boundary_min=tuple(float(v) for v in (boundary_min if boundary_min is not None else min)),
            boundary_max=tuple(float(v) for v in (boundary_max if boundary_max is not None else max)),
            boundary_periodic=tuple(
                bool(v) for v in (boundary_periodic if boundary_periodic is not None else periodic)
            ),
        )
        g = Grid.zeros(gspec, derivatives=True, interpolate=interpolate,
                       dtype=dtype, device=device)
        bcd, bcdd = compute_bc_tables(spec, dtype, device)
        return cls(grid=g, bc_denom=bcd, bc_denom_deriv=bcdd, spec=spec)

    def set_boundary(self, boundary_min, boundary_max, boundary_periodic) -> "GaussGrid":
        """Re-derive boundary behaviour (gaussian_grid.h:378-435); the grid
        arrays are kept."""
        spec = dataclasses.replace(
            self.spec,
            boundary_min=tuple(float(v) for v in boundary_min),
            boundary_max=tuple(float(v) for v in boundary_max),
            boundary_periodic=tuple(bool(v) for v in boundary_periodic),
        )
        bcd, bcdd = compute_bc_tables(spec, self.dtype, self.grid.device)
        return GaussGrid(grid=self.grid, bc_denom=bcd, bc_denom_deriv=bcdd, spec=spec)

    @property
    def dtype(self):
        return self.grid.dtype

    # ------------------------------------------------------------------ query

    def in_bounds(self, x: torch.Tensor) -> torch.Tensor:
        """Inside the boundary box, every dim (gaussian_grid.h:490-499)."""
        bmin = _const(self.spec.boundary_min, self.grid.values)
        bmax = _const(self.spec.boundary_max, self.grid.values)
        return torch.all((x >= bmin) & (x <= bmax), dim=-1)

    def remap(self, x: torch.Tensor) -> torch.Tensor:
        """Nearest-image remap across the system boundary toward the grid
        (gaussian_grid.h:504-541)."""
        spec = self.spec
        g = spec.grid
        ref = self.grid.values
        x = x.to(self.dtype)
        gmin = _const(g.min, ref)
        gmax = _const(g.max, ref)
        Lg = gmax - gmin
        bmin = _const(spec.boundary_min, ref)
        bmax = _const(spec.boundary_max, ref)
        Lb = bmax - bmin

        outside = (x < gmin) | (x > gmax)
        wrapped = x - Lg * torch.floor((x - gmin) / Lg)
        dp0 = ref_round((gmin - x) / Lb) * Lb
        dp1 = ref_round((gmax - x) / Lb) * Lb
        pick0 = torch.abs(gmin - x - dp0) < torch.abs(gmax - x - dp1)
        bwrapped = x + torch.where(pick0, dp0, dp1)

        gper = _const(g.periodic, ref, torch.bool)
        bper = _const(spec.boundary_periodic, ref, torch.bool)
        return torch.where(
            outside & gper, wrapped,
            torch.where(outside & ~gper & bper, bwrapped, x),
        )

    def get_value(self, x: torch.Tensor) -> torch.Tensor:
        """Boundary-aware value lookup (gaussian_grid.h:99-116)."""
        v, _ = self.get_value_deriv(x)
        return v

    def get_value_deriv(self, x: torch.Tensor):
        """Boundary-aware value+gradient lookup (gaussian_grid.h:118-138)."""
        x = x.to(self.dtype)
        xin = torch.where(self.in_bounds(x)[..., None], x, self.remap(x))
        ok = self.in_bounds(xin)
        v, d = self.grid.get_value_deriv(xin)
        zero = torch.zeros((), dtype=self.dtype, device=x.device)
        return torch.where(ok, v, zero), torch.where(ok[..., None], d, zero)

    # --------------------------------------------------------------- deposit

    def add_value(self, centers: torch.Tensor, heights):
        """Deposit a batch of hills (H, D); returns (new grid, bias_added)."""
        from .ops.deposit import deposit

        centers = centers.to(self.dtype)
        heights = device_const(heights, centers.device, self.dtype)
        return deposit(self, centers, heights.expand(centers.shape[:1]))

    def expected_bias(self):
        return self.grid.expected_bias()
