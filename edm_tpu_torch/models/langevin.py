"""Langevin integrator parameters (BAOAB splitting).

Counterpart of ``edm_tpu/models/langevin.py``.  The reference delegates
integration to LAMMPS (fix nve + fix langevin); the cell host
(``models/pair_edm_cells``) applies the BAOAB stages directly to its slot
arrays, so only the parameters are shared here.  The dense host's
``baoab_step`` is not ported yet (ROADMAP Queue 1, item 3).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LangevinParams:
    dt: float
    friction: float  # gamma, 1/time
    kT: float
    mass: float = 1.0
