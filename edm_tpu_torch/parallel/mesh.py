"""The port's device mesh: one process per rank over ``torch.distributed``.

Counterpart of ``edm_tpu/parallel/mesh.py``.  The JAX package runs a 1-D
``jax.sharding.Mesh`` under ``shard_map`` inside one program; here each
rank is a process of its own, and a ``Mesh`` is that process's view of the
group: the process group, ``rank``, ``size``, the rank's ``device``, and
``axis_names`` / ``devices`` shaped as the JAX mesh's, so that
``mesh.devices.size`` and ``mesh.axis_names`` read the same.
``axis_index()`` takes the place of ``jax.lax.axis_index``.

``make_mesh`` builds a mesh over the initialised default group (or a
one-rank mesh when no group is initialised) and registers it under its axis
name, so that code given only an axis name (``bias.add_hills_round(
axis_name=...)``, ``make_cell_step(slab_axis=...)``) finds it, as a JAX
function traced under ``shard_map`` finds its mesh axis.

``launch`` spawns the ranks: each is initialised from a ``FileStore`` in a
given file (never a fixed TCP port), keeps to one torch thread, and gives
``init_process_group`` a timeout, so that a hung collective fails instead
of hanging; a rank's exception is raised again in the parent.  The backend
is NCCL when the ranks run on CUDA and the machine has a card per rank,
otherwise gloo, with every rank on ``cuda:0`` when a card is asked for.

Not ported: ``make_brick_mesh`` (the brick host, ROADMAP Queue 1, item 7b).
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
    """One rank's view of a 1-D mesh.  ``group`` is None for a one-rank
    mesh that needs no process group."""

    group: object
    rank: int
    size: int
    device: torch.device
    backend: str
    axis_names: tuple = (DATA_AXIS,)
    devices: np.ndarray = None  # (size,) the ranks' device names

    def axis_index(self) -> int:
        """This rank's index along the mesh axis (``jax.lax.axis_index``)."""
        return self.rank


def _rank_device(rank: int, backend: str, device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        return device
    return torch.device("cuda", rank if backend == "nccl" else 0)


def make_mesh(n_devices: Optional[int] = None, axis: str = DATA_AXIS, device=None) -> Mesh:
    """The mesh over the initialised default group (all of its ranks; a
    given ``n_devices`` must equal the world size), or a one-rank mesh when
    no group is initialised.  ``device``: the rank's device, by default the
    one ``launch`` gave this rank, else ``"cuda"``.  Registers the mesh under
    ``axis``."""
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, "none"
    if n_devices is not None and n_devices != size:
        raise ValueError(f"a mesh of {n_devices} ranks asked for, the group has {size}")
    if device is None:
        device = _RANK.get("device", "cuda")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = _rank_device(rank, backend, device)
    names = np.asarray([str(_rank_device(r, backend, device)) for r in range(size)])
    mesh = Mesh(group=group, rank=rank, size=size, device=device, backend=backend,
                axis_names=(axis,), devices=names)
    _MESHES[axis] = mesh
    return mesh


def mesh_of(axis: str) -> Mesh:
    """The mesh registered under ``axis`` (``make_mesh``)."""
    if axis not in _MESHES:
        raise ValueError(f"no mesh over axis {axis!r}: build one with parallel.make_mesh "
                         f"(axis={axis!r}) first")
    return _MESHES[axis]


def make_brick_mesh(px: int, py: int, pz: Optional[int] = None, axes: Optional[tuple] = None):
    """The (px, py[, pz]) device grid of the brick host: not ported yet."""
    raise NotImplementedError("make_brick_mesh (the brick host) is not ported yet "
                              "(ROADMAP Queue 1, item 7b)")


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
        try:
            res = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, res))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))


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
        for p in procs:
            p.join(timeout=30.0)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors or len(results) < world_size:
        lost = [r for r in range(world_size) if r not in results and r not in errors]
        msg = "\n".join(f"--- rank {r} ---\n{errors[r]}" for r in sorted(errors))
        if lost:
            msg += f"\nranks {lost} were stopped"
        raise RuntimeError(f"{len(errors)} of {world_size} ranks failed:\n{msg}")
    return [results[r] for r in range(world_size)]
