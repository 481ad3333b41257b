"""The port's multi-device layer (counterpart of ``edm_tpu/parallel``): a
1-D mesh of ranks, one process each, over ``torch.distributed``.

Ported:
  - ``mesh``: ``Mesh``, ``make_mesh``, ``launch`` (spawned ranks, a
    ``FileStore``, NCCL with a card per rank, else gloo);
  - ``collectives``: ``all_gather`` and ``psum`` in rank order, bitwise the
    same on every rank;
  - ``pair``: ``shard_pair_state``, ``make_sharded_pair_step`` (the sharded
    dense host);
  - ``cells``: ``make_slab_cell_step`` (the slab-sharded cell host, K1's
    owned-row pass).

Not ported yet (each raises ``NotImplementedError`` where it is defined):
  - ``make_brick_mesh``, ``make_brick_cell_step``, the work-sharded
    ``make_sharded_cell_step`` and the sharded coordinate host
    (``parallel/coord.py``: ``make_sharded_coord_step``,
    ``shard_coord_state``) — ROADMAP Queue 1, item 7b;
  - the spatial host (``parallel/spatial.py``, ``boundary_offset``) and the
    ``dryrun_multichip`` probes — item 7c.
"""

from .mesh import DATA_AXIS, Mesh, launch, make_brick_mesh, make_mesh, mesh_of
from .collectives import all_gather, psum, psum_many
from .pair import make_sharded_pair_step, shard_pair_state
from .cells import make_brick_cell_step, make_sharded_cell_step, make_slab_cell_step

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "launch",
    "make_mesh",
    "make_brick_mesh",
    "mesh_of",
    "all_gather",
    "psum",
    "psum_many",
    "make_sharded_pair_step",
    "shard_pair_state",
    "make_slab_cell_step",
    "make_sharded_cell_step",
    "make_brick_cell_step",
]
