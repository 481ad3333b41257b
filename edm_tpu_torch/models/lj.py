"""Lennard-Jones parameters (truncated, unshifted LJ; stands in for LAMMPS
pair_lj_cut).

Counterpart of ``edm_tpu/models/lj.py``.  The cell host evaluates LJ inside
the pair kernels (``ops/cellforce``); the dense all-pairs helpers are not
ported yet (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LJParams:
    epsilon: float = 1.0
    sigma: float = 1.0
    rcut: float = 2.5
