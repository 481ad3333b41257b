"""Lennard-Jones fluid forces — the physical system under the pairwise EDM
host (stands in for LAMMPS pair_lj_cut).

Counterpart of ``edm_tpu/models/lj.py``: the parameters, and the dense
all-pairs helpers of the dense host (``models/pair_edm``), minimum image
and all.  The cell host evaluates LJ inside the pair kernels
(``ops/cellforce``) and in its chunked 27-stencil pass; the blocked host
(``models/pair_edm_blocked``) in row blocks with ``lj_pair_terms``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..grid import device_const


@dataclasses.dataclass(frozen=True)
class LJParams:
    epsilon: float = 1.0
    sigma: float = 1.0
    rcut: float = 2.5


def minimum_image(disp: torch.Tensor, box) -> torch.Tensor:
    """``disp - round(disp / box) * box``; ``round`` is half to even, as
    ``jnp.round``."""
    b = device_const(box, disp.device, disp.dtype)
    return disp - torch.round(disp / b) * b


def pair_displacements(x: torch.Tensor, box) -> Tuple[torch.Tensor, torch.Tensor]:
    """All-pairs minimum-image displacements and distances.

    Returns (disp (N, N, 3), r (N, N)); r on the diagonal is +inf so
    self-pairs drop out of every downstream cutoff mask."""
    disp = minimum_image(x[:, None, :] - x[None, :, :], box)
    r2 = torch.sum(disp * disp, dim=-1)
    eye = torch.eye(x.shape[0], dtype=torch.bool, device=x.device)
    r = torch.sqrt(torch.where(eye, torch.full_like(r2, float("inf")), r2))
    return disp, r


def lj_pair_terms(p: LJParams, r: torch.Tensor):
    """Per-pair truncated, unshifted LJ: (pair energy, |f| / r along disp);
    both 0 at r >= rcut or r = inf.  ``x ** 6`` as ``lax.integer_pow``
    multiplies it: x^2 (x^2)^2."""
    inr = torch.where(r < p.rcut, torch.reciprocal(r), torch.zeros_like(r))
    s = p.sigma * inr
    s2 = s * s
    sr6 = s2 * (s2 * s2)
    e_pair = 4 * p.epsilon * (sr6 * sr6 - sr6)
    # f(r)/r along disp: dU/dr = 4 eps (-12 sr12 + 6 sr6)/r
    fmag_over_r = 4 * p.epsilon * (12 * sr6 * sr6 - 6 * sr6) * inr * inr
    return e_pair, fmag_over_r


def lj_energy_forces(p: LJParams, disp: torch.Tensor, r: torch.Tensor):
    """Truncated (unshifted) LJ from precomputed displacements: (energy,
    forces (N, 3))."""
    e_pair, fmag_over_r = lj_pair_terms(p, r)
    forces = torch.sum(fmag_over_r[..., None] * disp, dim=1)
    energy = 0.5 * torch.sum(e_pair)
    return energy, forces
