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
"""

from __future__ import annotations

import dataclasses
import io

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


def save_state(state, filename: str) -> None:
    """Write every array leaf of ``state`` to ``filename`` (.npz)."""
    fp, leaves = _fingerprint(state)
    payload = {f"leaf_{i}": (a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a)
               for i, a in enumerate(leaves)}
    payload["__fingerprint__"] = np.frombuffer(fp.encode(), dtype=np.uint8)
    with open(filename, "wb") as f:
        np.savez(f, **payload)


def load_state(template, filename: str):
    """Restore a state saved by ``save_state`` into ``template``'s structure:
    a freshly built state of the same configuration (the same .edm config,
    subdivide call and host set-up).  Raises ``EDMError`` on any structural
    mismatch instead of restoring wrongly."""
    want, leaves = _fingerprint(template)
    with open(filename, "rb") as f:
        data = np.load(io.BytesIO(f.read()))
    got = bytes(data["__fingerprint__"]).decode()
    if got != want:
        edm_error("checkpoint structure does not match this build/config "
                  f"(saved: {got.split('|')[0]}...)", "checkpoint:load_state")
    return _rebuild(template, iter(data[f"leaf_{i}"] for i in range(len(leaves))))
