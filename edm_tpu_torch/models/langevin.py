"""Langevin dynamics integrator (BAOAB splitting).

Counterpart of ``edm_tpu/models/langevin.py``.  The reference delegates
integration to LAMMPS (fix nve + fix langevin); ``baoab_step`` is the
coordinate host's integrator, with the force function supplied by the host.
The cell host (``models/pair_edm_cells``) applies the same stages to its
slot arrays, with its own noise stream.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np

from ..ops import prng


@dataclasses.dataclass(frozen=True)
class LangevinParams:
    dt: float
    friction: float  # gamma, 1/time
    kT: float
    mass: float = 1.0


def baoab_step(p: LangevinParams, x, v, f, key, force_fn: Callable):
    """One BAOAB step; ``force_fn(x) -> (energy, force)``.  ``key`` is the
    host-side Threefry key; the O stage draws ``jax.random.normal(sub,
    v.shape)`` from its split (``ops/prng.normal``).  Returns
    (x', v', f', energy, key')."""
    dt, m = p.dt, p.mass
    c1 = float(np.exp(-p.friction * dt))
    c2 = float(np.sqrt((1.0 - c1 * c1) * p.kT / m))
    v = v + 0.5 * dt * f / m  # B
    x = x + 0.5 * dt * v  # A
    key, sub = prng.split(key)
    xi = prng.normal(sub, tuple(v.shape), v.dtype, v.device)
    v = c1 * v + c2 * xi  # O
    x = x + 0.5 * dt * v  # A
    energy, f = force_fn(x)
    v = v + 0.5 * dt * f / m  # B
    return x, v, f, energy, key
