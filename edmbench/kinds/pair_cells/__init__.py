"""The pair kind: ``edm_tpu_torch``'s pair-distance cell host
(``fix edm_pair`` on a Lennard-Jones fluid) with one LJ type and the 1-D
Hermite lookup, on one card or as the slab and brick hosts over NCCL.

- ``system.py``: ``PATTERN`` (1 hill + 8 plain + 1 rebuild step),
  ``make_mesh``, ``build`` and what the harness reads of a state;
- ``check.py``: ``NUMBERS`` and ``judge``, against ``reference.py``, the
  plain float64 reference of one step;
- ``work_count.py``: a plain step's least work, from its pairs within reach."""

from .check import NUMBERS, judge
from .system import PATTERN, build, counters, geometry, make_mesh, replicated, snapshot
from .work_count import work

__all__ = ["NUMBERS", "PATTERN", "build", "counters", "geometry", "judge", "make_mesh",
           "replicated", "snapshot", "work"]
