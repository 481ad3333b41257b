"""Exact checkpoint and resume of engine and host states.

Counterpart of ``edm_tpu/utils/checkpoint.py``.  The reference can resume
only through grid files (``initial_bias_filename``, edm_bias.cpp:1066-1072,
166-167) and loses the deferred-hill buffer, cum_bias and the tempering
state, and the step counter.  ``save_state`` writes every array leaf of a
state (``BiasState``, ``CoordEDMState``, ``PairEDMState``,
``CellPairState``: dataclasses, NamedTuples and tuples of tensors and
numpy arrays) to one ``.npz``;
``load_state`` restores them into a freshly built template of the same
configuration, on the template's devices and in its dtypes, so that a
continued run is bitwise the uninterrupted one.

What is not an array is static structure: rebuild it from the config as at
start-up and pass the fresh state as the template.  A fingerprint of the
field paths, the array shapes and dtypes and the static values (grid
specs, ``kernel_cap``) guards against loading into a mismatched build.  A
host copy of an array leaf (a dataclass field with ``host_copy_of`` in its
metadata: ``CellPairState.tail_ovf_host``, which picks the force kernel's
cap for the period) is not stored but derived from the restored leaf.

A sharded run checkpoints into one file, as JAX's does: give both calls the
``mesh`` (a ``Mesh`` or a registered axis name, as ``collectives.resolve``
takes it), and every rank of it must call them.  ``save_state`` checks that
the ranks' states have one structure, then moves every rank's leaves, as
their bytes, to every rank in one ``all_gather`` in rank order.  Rank 0
writes the ``.npz`` to a temporary name in the same directory and renames
it over ``filename`` (``os.replace``); a last gather tells every rank
whether the file was written, so no rank returns before it is complete,
and all raise if it was not.  The layout follows from the leaves: where
every rank's leaves are bitwise rank 0's (the slab, brick and work-sharded
cell hosts, whose every rank holds the whole state), each is stored once;
otherwise each carries a leading rank axis (the JAX spatial state's own
layout: row r is rank r's leaf).  ``load_state`` with the mesh reads the
file on every rank and restores the rank's own row (or the one copy) onto
its template's devices and dtypes.  The fingerprint records the rank
count, the mesh's shape and the layout, so a file loaded on another rank
count or mesh shape, or without its mesh, raises ``EDMError``.  With no
mesh, or a mesh of one rank, both calls do what they do for one device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import os

import numpy as np
import torch

from .errors import edm_error

_MAGIC = "edm_tpu_torch_checkpoint_v1"


def _walk(obj, path, leaves, static):
    """Collect (path, array) leaves and "path=value" static entries."""
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        leaves.append((path, obj))
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        static.append(f"{path}:{type(obj).__name__}")
        for f in dataclasses.fields(obj):
            if "host_copy_of" not in f.metadata:
                _walk(getattr(obj, f.name), f"{path}.{f.name}", leaves, static)
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        static.append(f"{path}:{type(obj).__name__}")
        for name in obj._fields:
            _walk(getattr(obj, name), f"{path}.{name}", leaves, static)
    elif isinstance(obj, (list, tuple)):
        static.append(f"{path}:{type(obj).__name__}[{len(obj)}]")
        for i, v in enumerate(obj):
            _walk(v, f"{path}[{i}]", leaves, static)
    else:
        static.append(f"{path}={obj!r}")


def _fingerprint(state) -> str:
    leaves, static = [], []
    _walk(state, "", leaves, static)
    shapes = ";".join(f"{p}:{tuple(a.shape)}:{str(a.dtype).removeprefix('torch.')}"
                      for p, a in leaves)
    return f"{_MAGIC}|{';'.join(static)}|{shapes}", [a for _, a in leaves]


def _rebuild(obj, arrays):
    """``obj`` with its array leaves taken in order from the iterator
    ``arrays``, each on the template leaf's device and in its dtype."""
    if isinstance(obj, torch.Tensor):
        return torch.as_tensor(next(arrays)).to(device=obj.device, dtype=obj.dtype)
    if isinstance(obj, np.ndarray):
        return np.asarray(next(arrays), dtype=obj.dtype)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        fields = dataclasses.fields(obj)
        new = {f.name: _rebuild(getattr(obj, f.name), arrays)
               for f in fields if "host_copy_of" not in f.metadata}
        for f in fields:
            src = f.metadata.get("host_copy_of")
            if src is not None:
                leaf = new[src]
                new[f.name] = getattr(obj, f.name) if leaf is None else bool(leaf)
        return dataclasses.replace(obj, **new)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_rebuild(v, arrays) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_rebuild(v, arrays) for v in obj)
    return obj


def _mesh_of(mesh):
    """The multi-rank mesh ``mesh`` names, or None for no mesh or one rank."""
    if mesh is None:
        return None
    from ..parallel.collectives import resolve

    mesh = resolve(mesh)
    return mesh if mesh.size > 1 else None


def _layout(mesh, replicated: bool) -> str:
    return (f"|mesh ranks={mesh.size} shape={'x'.join(map(str, mesh.shape))} "
            f"layout={'replicated' if replicated else 'rows'}")


def _on_host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _gather_leaves(leaves, mesh):
    """Every rank's leaves, in rank order: one ``all_gather`` of their bytes
    (the ranks' structures must agree).  Returns per leaf a numpy array of
    shape (ranks, *shape) in the leaf's dtype."""
    from ..parallel.collectives import all_gather

    hosts = [_on_host(a) for a in leaves]
    flat = np.concatenate([np.ascontiguousarray(h).reshape(-1).view(np.uint8) for h in hosts]
                          + [np.zeros(0, np.uint8)])
    g = all_gather(torch.from_numpy(flat).to(mesh.device)[None], mesh).cpu().numpy()
    out, at = [], 0
    for h in hosts:
        out.append(np.ascontiguousarray(g[:, at:at + h.nbytes]).view(h.dtype)
                   .reshape((mesh.size,) + h.shape))
        at += h.nbytes
    return out


def _agree(mesh, flag: int) -> np.ndarray:
    """Every rank's small integer ``flag``, in rank order."""
    from ..parallel.collectives import all_gather

    t = torch.tensor([flag], dtype=torch.int64).to(mesh.device)
    return all_gather(t, mesh).cpu().numpy()


def _write(payload, filename: str):
    tmp = os.path.join(os.path.dirname(os.path.abspath(filename)),
                       f".{os.path.basename(filename)}.{os.getpid()}.tmp")
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, filename)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _save_sharded(fp, leaves, filename, mesh):
    digest = np.frombuffer(hashlib.sha256(fp.encode()).digest()[:8], dtype=np.int64)[0]
    if len(set(_agree(mesh, int(digest)).tolist())) != 1:
        edm_error("the ranks' states differ in structure", "checkpoint:save_state")
    rows = _gather_leaves(leaves, mesh)
    replicated = all(q.tobytes() == r[0].tobytes() for r in rows for q in r[1:])
    if replicated:
        rows = [r[0] for r in rows]
    error = None
    if mesh.rank == 0:
        payload = {f"leaf_{i}": a for i, a in enumerate(rows)}
        payload["__fingerprint__"] = np.frombuffer(
            (fp + _layout(mesh, replicated)).encode(), dtype=np.uint8)
        try:
            _write(payload, filename)
        except Exception as e:  # every rank learns of it below
            error = e
    if _agree(mesh, int(error is not None))[0]:
        if error is not None:
            raise error
        edm_error(f"rank 0 could not write {filename}", "checkpoint:save_state")


def save_state(state, filename: str, mesh=None) -> None:
    """Write every array leaf of ``state`` to ``filename`` (.npz).  With a
    ``mesh`` of several ranks every rank calls it and rank 0 writes one
    file of all the ranks' leaves, stored once where every rank's are
    bitwise rank 0's (the module docstring)."""
    fp, leaves = _fingerprint(state)
    mesh = _mesh_of(mesh)
    if mesh is not None:
        _save_sharded(fp, leaves, filename, mesh)
        return
    payload = {f"leaf_{i}": _on_host(a) for i, a in enumerate(leaves)}
    payload["__fingerprint__"] = np.frombuffer(fp.encode(), dtype=np.uint8)
    with open(filename, "wb") as f:
        np.savez(f, **payload)


def load_state(template, filename: str, mesh=None):
    """Restore a state saved by ``save_state`` into ``template``'s structure:
    a freshly built state of the same configuration (the same .edm config,
    subdivide call and host set-up).  With a ``mesh`` of several ranks each
    rank restores its own row of a file saved on a mesh of the same rank
    count and shape.  Raises ``EDMError`` on any structural mismatch instead
    of restoring wrongly."""
    want, leaves = _fingerprint(template)
    mesh = _mesh_of(mesh)
    with open(filename, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    got = bytes(data["__fingerprint__"]).decode()
    row = None
    if mesh is not None:
        layouts = [want + _layout(mesh, rep) for rep in (False, True)]
        if got in layouts:
            want, row = got, (mesh.rank if got == layouts[0] else None)
        else:
            want = layouts[0]
    if got != want:
        saved = got.split("|mesh ")[1] if "|mesh " in got else "one rank"
        here = f"ranks={mesh.size} shape={'x'.join(map(str, mesh.shape))}" if mesh else "one rank"
        edm_error("checkpoint structure does not match this build/config "
                  f"(saved: {got.split('|')[0]}..., {saved}; loading on {here})",
                  "checkpoint:load_state")
    arrays = (data[f"leaf_{i}"] for i in range(len(leaves)))
    if row is not None:
        arrays = (a[row] for a in arrays)
    return _rebuild(template, arrays)
