"""The port's device mesh: one process per rank over ``torch.distributed``.

Counterpart of ``edm_tpu/parallel/mesh.py``.  The JAX package runs a 1-D
``jax.sharding.Mesh`` under ``shard_map`` inside one program; here each
rank is a process of its own, and a ``Mesh`` is that process's view of the
group: the process group, ``rank``, ``size``, the rank's ``device``, and
``axis_names`` / ``devices`` shaped as the JAX mesh's, so that
``mesh.devices.size``, ``mesh.devices.shape`` and ``mesh.axis_names`` read
the same.  ``axis_index(axis)`` takes the place of ``jax.lax.axis_index``.

``make_mesh`` builds a 1-D mesh over the initialised default group (or a
one-rank mesh when no group is initialised); ``make_brick_mesh`` the (px,
py[, pz]) grid of the brick host over the same group, its ranks laid on
the grid row-major (``rank = (ix * py + iy) * pz + iz``, the order of JAX's
``np.asarray(devices).reshape(shape)``), so that a gather in rank order
lists the parts in JAX's mesh order.  Each registers the mesh under its
axis names (a brick mesh also under the tuple of them), so that code given
only an axis name (``bias.add_hills_round(axis_name=...)``,
``make_cell_step(slab_axis=...)``, ``make_cell_step(brick_axes=...)``) finds
it, as a JAX function traced under ``shard_map`` finds its mesh axis.  The
JAX brick host reduces and gathers only over the whole axis tuple, which is
the world group in rank order: no collective needs a group of one axis.

``launch`` spawns the ranks: each is initialised from a ``FileStore`` in a
given file (never a fixed TCP port), keeps to one torch thread, and gives
``init_process_group`` a timeout, so that a hung collective fails instead
of hanging; a rank's exception is raised again in the parent, with its
traceback, once every rank has ended or ``timeout`` + 30 s have passed
(the ranks still running are then stopped).  The backend
is NCCL when the ranks run on CUDA and the machine has a card per rank,
otherwise gloo, with every rank on ``cuda:0`` when a card is asked for.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "dp"
BRICK_X_AXIS = "bx"
BRICK_Y_AXIS = "by"
BRICK_Z_AXIS = "bz"

# axis name -> the Mesh that make_mesh registered last in this process
_MESHES: dict = {}
# what launch() set up in this rank: {"device": torch.device, "backend": str}
_RANK: dict = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh of ``size`` ranks over the world group,
    laid on the grid ``devices.shape`` row-major.  ``group`` is None for a
    one-rank mesh that needs no process group."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = (DATA_AXIS,)
    devices: np.ndarray = None  # the ranks' device names, in the grid's shape

    @property
    def shape(self) -> tuple:
        return tuple(self.devices.shape)

    def axis_index(self, axis: Optional[str] = None) -> int:
        """This rank's coordinate along ``axis`` (``jax.lax.axis_index``);
        with no axis, the rank's index on a 1-D mesh."""
        if axis is None:
            if len(self.axis_names) != 1:
                raise ValueError(f"a mesh over {self.axis_names} needs the axis to index")
            return self.rank
        if axis not in self.axis_names:
            raise ValueError(f"no axis {axis!r} in the mesh's {self.axis_names}")
        return int(np.unravel_index(self.rank, self.shape)[self.axis_names.index(axis)])


def _rank_device(rank: int, backend: str, device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else 0)


def _grid_mesh(shape: tuple, axes: tuple, device) -> Mesh:
    """The mesh of ``shape`` over the initialised default group (a one-rank
    mesh when no group is initialised), whose world size must be
    ``prod(shape)``; registered under each axis name and, with several,
    under their tuple."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, "none"
    if int(np.prod(shape)) != size:
        raise ValueError(f"a mesh of {'x'.join(map(str, shape))} ranks asked for, the group "
                         f"has {size}")
    if device is None:
        device = _RANK.get("device", "cuda")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = _rank_device(rank, backend, device)
    names = np.asarray([str(_rank_device(r, backend, device)) for r in range(size)])
    mesh = Mesh(group=group, rank=rank, size=size, device=device, backend=backend,
                axis_names=tuple(axes), devices=names.reshape(shape))
    for axis in axes:
        _MESHES[axis] = mesh
    if len(axes) > 1:
        _MESHES[tuple(axes)] = mesh
    return mesh


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, device=None) -> Mesh:
    """The 1-D mesh over the initialised default group (all of its ranks; a
    given ``n_devices`` must equal the world size), or a one-rank mesh when
    no group is initialised.  ``device``: the rank's device, by default the
    one ``launch`` gave this rank, else ``"cuda"``.  Registers the mesh under
    ``axis``."""
    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return _grid_mesh((n_devices,), (axis,), device)


def make_brick_mesh(px: int, py: int, pz: Optional[int] = None, axes: Optional[tuple] = None,
                    device=None) -> Mesh:
    """The (px, py[, pz]) device grid of the brick host over the default
    group, whose world size must be px * py[ * pz]; the ranks lie on it
    row-major.  ``axes`` (default ("bx", "by"[, "bz"])) name its axes;
    the mesh is registered under each and under their tuple."""
    shape = (px, py) if pz is None else (px, py, pz)
    if axes is None:
        axes = (BRICK_X_AXIS, BRICK_Y_AXIS, BRICK_Z_AXIS)[: len(shape)]
    if len(axes) != len(shape):
        raise ValueError(f"{len(axes)} axis names for a {len(shape)}-D grid")
    return _grid_mesh(shape, tuple(axes), device)


def mesh_of(axis) -> Mesh:
    """The mesh registered under ``axis``, an axis name or a tuple of them
    (``make_mesh``, ``make_brick_mesh``)."""
    if axis not in _MESHES:
        raise ValueError(f"no mesh over axis {axis!r}: build one with parallel.make_mesh "
                         "or parallel.make_brick_mesh first")
    return _MESHES[axis]


def pick_backend(world_size: int, device) -> str:
    """NCCL when the ranks run on CUDA and the machine has a card per rank,
    else gloo (the ranks then share ``cuda:0`` when a card is asked for)."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def _rank_main(rank, world_size, backend, device, store_path, timeout, fn, args, out):
    torch.set_num_threads(1)
    try:
        dev = _rank_device(rank, backend, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        _RANK.update(device=dev, backend=backend)
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout))
        res = fn(*args)
    except BaseException:
        # report first and leave without tearing the group down: over NCCL
        # the teardown waits on the ranks still inside a collective, which
        # the parent stops once its grace is over
        out.put((rank, False, traceback.format_exc()))
        out.close()
        out.join_thread()
        os._exit(1)
    dist.destroy_process_group()
    out.put((rank, True, res))


def launch(fn: Callable, world_size: int, *args, backend: Optional[str] = None,
           device="cuda", init_file: Optional[str] = None, timeout: float = 300.0):
    """Run ``fn(*args)`` in ``world_size`` spawned ranks and return their
    results in rank order.  Each rank joins the default process group from
    a ``FileStore`` in ``init_file`` (a fresh file in a new temporary
    directory when None; the file must not exist), with ``timeout`` seconds
    for every collective, on ``pick_backend``'s backend unless one is given;
    inside ``fn``, ``make_mesh()`` is the group's mesh on the rank's device.
    A rank's exception is raised in the parent as ``RuntimeError`` with the
    rank's traceback, after the other ranks have ended or been stopped."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = pick_backend(world_size, device)
    if init_file is None:
        init_file = os.path.join(tempfile.mkdtemp(prefix="edm_store_"), "store")
    if os.path.exists(init_file):
        raise ValueError(f"the store file {init_file} exists already")
    ctx = mp.get_context("spawn")  # CUDA cannot be re-initialised in a forked child
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world_size, backend, str(device), init_file, timeout, fn,
                               args, out))
             for r in range(world_size)]
    for p in procs:
        p.start()
    results, errors = {}, {}
    grace = None  # after a failure, how long the others may take to end
    try:
        while len(results) + len(errors) < world_size:
            try:
                rank, ok, res = out.get(timeout=1.0)
                (results if ok else errors)[rank] = res
                continue
            except queue_mod.Empty:
                pass
            for r, p in enumerate(procs):  # a rank that died without a word
                if r not in results and r not in errors and not p.is_alive():
                    errors[r] = f"rank {r} exited with code {p.exitcode}"
            if errors and grace is None:
                grace = time.monotonic() + timeout + 30.0
            if grace is not None and time.monotonic() > grace:
                break
    finally:
        # the ranks that reported end on their own; once the grace is over
        # (or on an interrupt) the rest are stopped at once, all of them
        # within one shared wait
        done = len(results) + len(errors) == world_size
        end = time.monotonic() + (30.0 if done else 0.0)
        for p in procs:
            p.join(timeout=max(0.0, end - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
    if errors or len(results) < world_size:
        lost = [r for r in range(world_size) if r not in results and r not in errors]
        msg = "\n".join(f"--- rank {r} ---\n{errors[r]}" for r in sorted(errors))
        if lost:
            msg += f"\nranks {lost} were stopped"
        raise RuntimeError(f"{len(errors)} of {world_size} ranks failed:\n{msg}")
    return [results[r] for r in range(world_size)]
