"""The port's multi-device layer (counterpart of ``edm_tpu/parallel``): a
mesh of ranks, one process each, over ``torch.distributed``.

Ported:
  - ``mesh``: ``Mesh``, ``make_mesh`` (1-D), ``make_brick_mesh`` (a (px,
    py[, pz]) grid, ranks row-major), ``launch`` (spawned ranks, a
    ``FileStore``, NCCL with a card per rank, else gloo);
  - ``collectives``: ``all_gather`` and ``psum`` in rank order, bitwise the
    same on every rank;
  - ``pair``: ``shard_pair_state``, ``make_sharded_pair_step`` (the sharded
    dense host);
  - ``cells``: ``make_slab_cell_step`` and ``make_brick_cell_step`` (the
    slab- and brick-sharded cell hosts, K1's owned-row pass), and the
    work-sharded host (``ShardedCellPairState``, ``init_sharded_cell_state``,
    ``make_sharded_cell_step``);
  - ``coord``: ``shard_coord_state``, ``make_sharded_coord_step`` (the
    sharded coordinate host);
  - ``spatial``: ``spatial_subdivide``, ``init_spatial_state``,
    ``make_spatial_coord_step``, ``rebin_spatial_atoms``,
    ``gather_spatial_grid``, ``stitch_spatial_grid`` (the spatially-sharded
    coordinate host: one brick of the CV grid per rank);
  - ``dryrun``: ``dryrun_multichip``, the eight multi-device probes of
    ``__graft_entry__.py``, each against the port's single-device hosts.
"""

from .mesh import DATA_AXIS, Mesh, launch, make_brick_mesh, make_mesh, mesh_of
from .collectives import all_gather, psum, psum_many
from .pair import make_sharded_pair_step, shard_pair_state
from .cells import (
    ShardedCellPairState,
    init_sharded_cell_state,
    make_brick_cell_step,
    make_sharded_cell_step,
    make_slab_cell_step,
)
from .coord import make_sharded_coord_step, shard_coord_state
from .spatial import (
    gather_spatial_grid,
    init_spatial_state,
    make_spatial_coord_step,
    rebin_spatial_atoms,
    spatial_subdivide,
    stitch_spatial_grid,
)

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
    "ShardedCellPairState",
    "init_sharded_cell_state",
    "make_sharded_coord_step",
    "shard_coord_state",
    "spatial_subdivide",
    "init_spatial_state",
    "make_spatial_coord_step",
    "rebin_spatial_atoms",
    "gather_spatial_grid",
    "stitch_spatial_grid",
]
