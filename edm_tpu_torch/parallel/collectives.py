"""Deterministic collectives over a ``Mesh``: the port's counterparts of
``jax.lax.all_gather(..., tiled=True)`` and ``jax.lax.psum`` inside
``shard_map``.

``all_gather(t, mesh)`` concatenates the ranks' tensors along axis 0 in
rank order (on a brick mesh over the whole axis tuple: its ranks lie on
the grid row-major, so rank order is JAX's mesh order).  ``psum(t, mesh)`` is an all_gather followed by a sum in rank
order, one add after another, so that every rank computes the bitwise-same
result and a run repeats bitwise ("no atomics; every kernel repeats
bitwise"); a ring all_reduce promises neither.  ``psum_many`` sums several
tensors with one gather.

Every rank must enter every collective the same number of times, a rank
that owns no work included.  On a one-rank mesh each is the identity and
moves nothing.

On the gloo backend a CUDA tensor is staged through the host here,
explicitly: copied to the host (which waits for the card: a host sync),
gathered there, and copied back.  That is what a one-card run with several
ranks does on every collective; ``stats`` counts the calls, the bytes
gathered and those host syncs, and the smoke prints them.  NCCL gathers on
the cards.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.distributed as dist

from .mesh import Mesh, mesh_of

# calls: collectives entered; bytes: bytes gathered (all ranks' parts);
# host_syncs: host stagings of CUDA tensors (gloo)
stats = {"calls": 0, "bytes": 0, "host_syncs": 0}


def reset_stats():
    for k in stats:
        stats[k] = 0


def resolve(mesh: Union[Mesh, str, tuple]) -> Mesh:
    """A Mesh, or the mesh registered under an axis name or a tuple of them
    (a brick mesh's axes: its collectives run over the whole tuple, which is
    the world group in rank order)."""
    return mesh if isinstance(mesh, Mesh) else mesh_of(mesh)


def _gather_parts(t: torch.Tensor, mesh: Mesh):
    """The ranks' copies of ``t`` (same shape and dtype on every rank), in
    rank order, on ``t``'s device.  Staged through the host (gloo, CUDA),
    the parts land in one pinned buffer that goes back to the card in one
    copy that does not wait: the staging's one host sync is the copy out."""
    stage = t.is_cuda and mesh.backend == "gloo"
    wire = (t.to(torch.uint8) if t.dtype == torch.bool else t).reshape(-1)
    if stage:
        wire = wire.cpu()  # host staging: waits for the card
        stats["host_syncs"] += 1
    wire = wire.contiguous()
    out = torch.empty((mesh.size, wire.numel()), dtype=wire.dtype, device=wire.device,
                      pin_memory=stage)
    dist.all_gather(list(out.unbind(0)), wire, group=mesh.group)
    stats["calls"] += 1
    stats["bytes"] += out.numel() * out.element_size()
    if stage:
        out = out.to(t.device, non_blocking=True)
    return [p.view(t.shape).to(t.dtype) for p in out.unbind(0)]


def all_gather(t: torch.Tensor, mesh: Union[Mesh, str, tuple]) -> torch.Tensor:
    """The ranks' ``t`` concatenated along axis 0 in rank order
    (``all_gather(tiled=True)``); 0-d tensors are stacked."""
    mesh = resolve(mesh)
    if mesh.size == 1:
        return t if t.dim() else t[None]
    parts = _gather_parts(t, mesh)
    return torch.cat(parts) if t.dim() else torch.stack(parts)


def psum(t: torch.Tensor, mesh: Union[Mesh, str, tuple]) -> torch.Tensor:
    """The sum of the ranks' ``t``, added in rank order; bitwise the same on
    every rank."""
    mesh = resolve(mesh)
    if mesh.size == 1:
        return t
    parts = _gather_parts(t, mesh)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def psum_many(ts: Sequence[torch.Tensor], mesh: Union[Mesh, str, tuple]):
    """``psum`` of several tensors of one dtype with one gather (JAX's psum
    of a tuple)."""
    mesh = resolve(mesh)
    if mesh.size == 1:
        return tuple(ts)
    flat = psum(torch.cat([t.reshape(-1) for t in ts]), mesh)
    out, i = [], 0
    for t in ts:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return tuple(out)
