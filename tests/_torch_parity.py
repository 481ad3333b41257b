"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The same inputs, made from a seed with numpy, go through the JAX package
and through its counterpart in ``edm_tpu_torch``; these helpers move trees
between the two (JAX dataclass pytree -> nested dicts of numpy arrays ->
``edm_tpu_torch.convert``) and state the tolerance classes:

  - integer and bool leaves: exact;
  - float64 engine paths: 1e-12 relative (both sides run the same IEEE
    operations; XLA may reassociate a few);
  - float32 force paths: ``2e-5 * max(1, max|f|)`` absolute — the kernels
    sum pairs in another order than the Pallas kernels;
  - float32 energies: 1e-5 relative.

Tier-1 runs the suite on several xdist workers, so each process keeps to
one torch thread.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

torch.set_num_threads(1)

F64_RTOL = 1e-12
FORCE_REL = 2e-5
ENERGY_RTOL = 1e-5


def to_numpy_tree(obj):
    """Dataclasses (JAX pytrees or the port's) and NamedTuples -> nested
    dicts; jax arrays and torch tensors -> numpy; other values unchanged."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_numpy_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_numpy_tree(v) for k, v in obj._asdict().items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_numpy_tree(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if hasattr(obj, "__array__") and not isinstance(obj, (np.ndarray, np.generic)):
        return np.asarray(obj)
    return obj


def to_port(obj, device="cpu"):
    """A JAX state or BiasParams -> the port's (via numpy)."""
    from edm_tpu_torch.convert import params_from_numpy, state_from_numpy

    tree = to_numpy_tree(obj)
    if "cfg" in tree:
        return params_from_numpy(tree, device)
    return state_from_numpy(tree, device)


def np_(x):
    return to_numpy_tree(x)


def assert_exact(port, ref, what=""):
    np.testing.assert_array_equal(np.asarray(np_(port)), np.asarray(np_(ref)), err_msg=what)


def assert_f64(port, ref, what="", rtol=F64_RTOL):
    ref = np.asarray(np_(ref), np.float64)
    scale = max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(np_(port), np.float64), ref,
                               rtol=rtol, atol=rtol * scale, err_msg=what)


def assert_forces(port, ref, what=""):
    """f32 force planes: within 2e-5 * max(1, max|f|)."""
    ref = np.asarray(np_(ref), np.float64)
    atol = FORCE_REL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(np_(port), np.float64), ref, rtol=0,
                               atol=atol, err_msg=what)


def assert_energy(port, ref, what="", rtol=ENERGY_RTOL):
    p, r = float(np_(port)), float(np_(ref))
    assert abs(p - r) <= rtol * max(1.0, abs(r)), f"{what}: {p} vs {r}"
