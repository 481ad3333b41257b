"""Sharded cell-list pairwise EDM: the slab-sharded host.

Counterpart of ``edm_tpu/parallel/cells.py``.  ``make_slab_cell_step`` is
the JAX package's production multi-chip force path: the slot-resident cell
host (``models/pair_edm_cells``, same state, same physics, the same K1)
with the force pass slab-decomposed over the mesh's x-columns, one psum of
the slot forces a step; by default (``slab_collect``) the hill collection
over the same columns, gathered in rank order (bitwise the replicated
round), and (``shard_floor``) the BAOAB pre-force stages over them, one
fused psum.  Deposition and rebuilds run replicated and deterministic, so
every rank's state stays bitwise rank 0's.  Here each rank is a process
that runs the step on its replica of the state (``parallel.launch``).

Not ported yet: the work-sharded host ``make_sharded_cell_step`` and the
brick host ``make_brick_cell_step`` (ROADMAP Queue 1, item 7b).
"""

from __future__ import annotations

from .mesh import DATA_AXIS, Mesh


def make_slab_cell_step(params, lp, lj, spec, hill_stride: int, mesh: Mesh, **kw):
    """This rank's step of the slab-sharded cell host over ``mesh``:
    ``models.pair_edm_cells.make_cell_step(..., slab_axis=mesh's axis,
    slab_ndev=mesh.size, **kw)`` with ``use_pallas=True`` by default.  It
    drives ``init_cell_state`` state, replicated on every rank; every rank
    must run every step.  It returns ``(state, energy)``, or ``(state,
    (energy, HillRoundLog))`` with ``collect_records`` — the same log on
    every rank (the rounds are replicated): write files from rank 0.  The
    step is a ``CellStep``: ``driver.pattern_segment`` and
    ``run_simulation`` drive it as they drive the single-device step
    (``phases``, ``check_phase``, the static phases)."""
    from ..models.pair_edm_cells import make_cell_step

    kw.setdefault("use_pallas", True)
    return make_cell_step(params, lp, lj, spec, hill_stride, slab_axis=mesh.axis_names[0],
                          slab_ndev=mesh.size, **kw)


def make_sharded_cell_step(*args, **kw):
    """The work-sharded cell host (cell chunks split over the ranks of a
    replicated atom-order state): not ported yet."""
    raise NotImplementedError("make_sharded_cell_step (the work-sharded cell host) is not "
                              "ported yet (ROADMAP Queue 1, item 7b)")


def make_brick_cell_step(*args, **kw):
    """The brick-decomposed cell host over a 2-D or 3-D device grid: not
    ported yet."""
    raise NotImplementedError("make_brick_cell_step (the brick host) is not ported yet "
                              "(ROADMAP Queue 1, item 7b)")


__all__ = ["DATA_AXIS", "make_slab_cell_step", "make_sharded_cell_step", "make_brick_cell_step"]
