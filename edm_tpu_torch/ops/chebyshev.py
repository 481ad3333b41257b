"""Panelized Chebyshev form of the 1-D pair-bias table, in PyTorch.

Counterpart of ``edm_tpu/ops/chebyshev.py`` (``pair_lookup="chebyshev"``):
after every hill round the host refits value and derivative series to the
bias grid's node values, and the force pass evaluates them with a Clenshaw
chain per pair (in the cell-force kernels, ``ops/cellforce``) instead of
the exact Hermite table.  Coefficients are stored (P, deg+1); P == 1 is
the plain global series.

The least-squares fit matrix is built in float64 numpy once per
(grid, deg, panels), as in the JAX package, and copied to each device
once (``_fit_matrix``): the refit on a hill step is one product and two
cumulative sums on the device, with no host copy and no sync.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch


def chebyshev_nodes(deg: int, lo: float, hi: float) -> np.ndarray:
    """Chebyshev-Gauss-Lobatto nodes mapped to [lo, hi]."""
    k = np.arange(deg + 1)
    t = np.cos(np.pi * k / deg)  # [-1, 1], descending
    return 0.5 * (lo + hi) + 0.5 * (hi - lo) * t


def interpolation_matrix(deg: int) -> np.ndarray:
    """Static matrix M s.t. coeffs = M @ f(nodes) (Clenshaw-Curtis / DCT-I),
    the endpoint terms of the sum halved."""
    k = np.arange(deg + 1)
    j = k[:, None]
    M = np.cos(np.pi * j * k[None, :] / deg)
    w = np.ones(deg + 1)
    w[0] = w[-1] = 0.5
    M = M * w[None, :]
    scale = 2.0 / deg * np.ones(deg + 1)
    scale[0] = 1.0 / deg
    scale[-1] = 1.0 / deg
    return scale[:, None] * M


def derivative_coeffs(c: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Chebyshev coefficients of the derivative, chain-rule factor
    2/(hi-lo) included.  c'_k = sum of 2j c_j over j > k with j - k odd:
    two flipped cumulative sums split by parity, op for op the JAX
    package's, so that float32 rounds alike."""
    deg = c.shape[0] - 1
    j = torch.arange(1, deg + 1, dtype=c.dtype, device=c.device)
    w = (2.0 * j) * c[1:]  # w[k] belongs to j = k + 1
    cp = torch.zeros(deg + 1, dtype=c.dtype, device=c.device)
    for p in (0, 1):
        cp[p:deg:2] = torch.flip(torch.cumsum(torch.flip(w[p::2], (0,)), 0), (0,))
    # the recurrence gives the doubled-c0 convention; the series is plain
    cp[0] = cp[0] * 0.5
    return cp * (2.0 / (hi - lo))


def clenshaw(c: torch.Tensor, x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Evaluate the series c (deg+1,) at x (any shape)."""
    t = (2.0 * x - (lo + hi)) / (hi - lo)
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(c.shape[0] - 1, 0, -1):
        b1, b2 = c[k] + t2 * b1 - b2, b1
    return c[0] + t * b1 - b2


def panel_of(x, lo: float, hi: float, npanels: int):
    """Per-point panel index (float) and local coordinate t, clipped to
    [-1, 1]."""
    pw = (hi - lo) / npanels
    pf = torch.clamp(torch.floor((x - lo) / pw), 0.0, float(npanels - 1))
    t = (2.0 * (x - lo - pf * pw) - pw) / pw
    return pf, torch.clamp(t, -1.0, 1.0)


def clenshaw_panels(c: torch.Tensor, x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Evaluate a panelized series c (P, deg+1): each point uses its
    panel's coefficients."""
    P, degp = c.shape
    if P == 1:
        return clenshaw(c[0], x, lo, hi)
    pf, t = panel_of(x, lo, hi, P)
    cp = c[pf.to(torch.int64)]  # (..., deg+1): the panel's coefficients
    t2 = 2.0 * t
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    for k in range(degp - 1, 0, -1):
        b1, b2 = cp[..., k] + t2 * b1 - b2, b1
    return cp[..., 0] + t * b1 - b2


@dataclasses.dataclass(frozen=True)
class ChebTable:
    """Fitted spectral form of a 1-D bias grid: value and derivative
    series, (P, deg+1) each, over [lo, hi]."""

    cval: torch.Tensor
    cder: torch.Tensor
    lo: float
    hi: float

    @property
    def deg(self) -> int:
        return self.cval.shape[-1] - 1

    @property
    def npanels(self) -> int:
        return self.cval.shape[0]

    def value_deriv(self, r: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(value, dU/dr), 0 outside [lo, hi]."""
        ok = (r >= self.lo) & (r <= self.hi)
        rc = torch.clamp(r, self.lo, self.hi)
        v = clenshaw_panels(self.cval, rc, self.lo, self.hi)
        d = clenshaw_panels(self.cder, rc, self.lo, self.hi)
        zero = torch.zeros((), dtype=v.dtype, device=v.device)
        return torch.where(ok, v, zero), torch.where(ok, d, zero)

    def edges(self) -> list:
        """lo, the panel joints and hi: where dV/dr may jump."""
        pw = (self.hi - self.lo) / self.npanels
        return [self.lo + q * pw for q in range(self.npanels + 1)]

    def near_edge(self, r: torch.Tensor, tol: float = 1e-5) -> bool:
        """Whether a distance in ``r`` lies within ``tol`` of an edge: two
        roundings of such a distance can fall on either side of it."""
        e = torch.tensor(self.edges(), dtype=torch.float64)
        return bool((r.detach().double().cpu().reshape(-1, 1) - e).abs().min() < tol)

    def edge_jump(self) -> float:
        """The largest jump of dV/dr at an edge (float64): from 0 to the
        series at lo and at hi, and between two panels at a joint."""
        cd = self.cder.detach().double().cpu()
        sign = (-1.0) ** torch.arange(cd.shape[1], dtype=torch.float64)  # T_k(-1)
        jumps = [cd[0] @ sign, cd[-1].sum()]
        jumps += [cd[q - 1].sum() - cd[q] @ sign for q in range(1, self.npanels)]
        return float(torch.stack(jumps).abs().max())


def f32_error_bound(ref, exact, rel: float) -> float:
    """How far a float32 evaluation may sit from another one, ``ref``, of
    the same table: rel * max(1, max|ref|), or twice ``ref``'s own distance
    from its float64 evaluation ``exact``, whichever is larger.  The
    single-panel degree-64 series is ill-conditioned in float32 (its
    derivative coefficients sum to ~4e3), so two float32 orders of its sums
    part by more than the relative bound; for the bench table (4 panels of
    degree 16) the relative bound is the larger."""
    ref = torch.as_tensor(ref).detach().double()
    exact = torch.as_tensor(exact).detach().double().to(ref.device)
    return max(rel * max(1.0, float(ref.abs().max())), 2 * float((ref - exact).abs().max()))


@functools.lru_cache(maxsize=64)
def _ls_fit_matrix(grid_key, deg: int, panels: int = 1) -> np.ndarray:
    """Least-squares fit matrix M (P, deg+1, G), ``coeffs[p] = M[p] @
    values``: the Chebyshev-Vandermonde matrix at the grid points,
    pseudo-inverted in float64.  Each panel fits the grid points of its
    sub-range extended by one spacing on each side."""
    lo, hi, dx, n = grid_key
    xs = lo + dx * np.arange(n)
    out = np.zeros((panels, deg + 1, n))
    pw = (hi - lo) / panels
    for p in range(panels):
        plo, phi = lo + p * pw, lo + (p + 1) * pw
        m = (xs >= plo - 1.05 * dx) & (xs <= phi + 1.05 * dx)
        t = np.clip((2.0 * xs[m] - (plo + phi)) / (phi - plo), -1.2, 1.2)
        V = np.polynomial.chebyshev.chebvander(t, deg)
        out[p][:, m] = np.linalg.pinv(V)
    return out


@functools.lru_cache(maxsize=16)
def _fit_matrix(grid_key, deg: int, panels: int, dtype, device) -> torch.Tensor:
    """``_ls_fit_matrix`` cast to ``dtype`` on ``device``, copied once."""
    return torch.as_tensor(_ls_fit_matrix(grid_key, deg, panels), dtype=dtype, device=device)


def fit_gauss_grid(gauss_grid, deg: int = 64, panels: int = 1) -> ChebTable:
    """Fit the 1-D bias grid's node values by least squares (keep deg
    under ~0.6 x the grid points of a panel)."""
    spec = gauss_grid.spec
    if spec.dim != 1:
        raise ValueError("the spectral table is for 1-D CV grids")
    g = spec.grid
    lo, hi = g.min[0], g.min[0] + g.dx[0] * (g.nbins[0] - 1)
    values = gauss_grid.grid.values
    M = _fit_matrix((g.min[0], hi, g.dx[0], g.nbins[0]), deg, panels, values.dtype,
                    values.device)
    cval = M @ values  # (P, deg+1)
    pw = (hi - lo) / panels
    cder = torch.stack([derivative_coeffs(c, 0.0, pw) for c in cval])
    return ChebTable(cval=cval, cder=cder, lo=float(lo), hi=float(hi))
