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
  - float32 energies: 1e-5 relative;
  - Chebyshev lookups: ``near_jax`` (the single-panel degree-64 table is
    ill-conditioned in float32) and ``assert_forces_at_edges`` (a pair
    within an ulp of a table edge).

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


def tree_leaves(tree, path=""):
    """(path, numpy array) of every leaf of a ``to_numpy_tree`` result, None
    leaves left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from tree_leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from tree_leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, np.asarray(tree)


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


def assert_tree(port, ref, rtol, what=""):
    """Every leaf of two state / record trees: floats to ``rtol`` (as
    ``assert_f64``), other leaves exactly; static specs are skipped."""
    tt, jt = to_numpy_tree(port), to_numpy_tree(ref)
    if isinstance(jt, dict):
        for k in jt:
            if k in ("spec", "interpolate") or jt[k] is None:
                continue
            assert_tree(tt[k], jt[k], rtol, f"{what}.{k}")
        return
    if isinstance(jt, np.ndarray) and jt.dtype.kind == "f":
        assert_f64(tt, jt, what, rtol=rtol)
    else:
        assert_exact(tt, jt, what)


def assert_forces(port, ref, what=""):
    """f32 force planes: within 2e-5 * max(1, max|f|)."""
    ref = np.asarray(np_(ref), np.float64)
    atol = FORCE_REL * max(1.0, float(np.abs(ref).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(np_(port), np.float64), ref, rtol=0,
                               atol=atol, err_msg=what)


def assert_energy(port, ref, what="", rtol=ENERGY_RTOL):
    p, r = float(np_(port)), float(np_(ref))
    assert abs(p - r) <= rtol * max(1.0, abs(r)), f"{what}: {p} vs {r}"


def near_jax(port, ref, exact, rel):
    """|port - ref| and its bound ``chebyshev.f32_error_bound(ref, exact,
    rel)``, the JAX kernel's result ``ref`` held against its float64
    evaluation ``exact``: with the single-panel degree-64 series both
    packages sit ~0.3 off the float64 forces, whose max is ~4.4e3.
    Returns (error, bound)."""
    from edm_tpu_torch.ops.chebyshev import f32_error_bound

    port, ref, exact = (np.asarray(np_(a), np.float64) for a in (port, ref, exact))
    return float(np.abs(port - ref).max()), f32_error_bound(ref, exact, rel)


def assert_forces_at_edges(port, ref, xs, mc, box, tab, what):
    """Forces within 2e-5 * max(1, max|f|), except on atoms with a pair
    within 1e-5 of an edge of the Chebyshev table ``tab`` (lo, hi, a panel
    joint): there the two packages' pair distances, which differ by an ulp
    (their rsqrt rounds differently), can fall on two sides of the edge,
    and the force may differ by the table's jump of dV/dr at that edge."""
    port, ref = np.asarray(np_(port), np.float64), np.asarray(np_(ref), np.float64)
    tol = FORCE_REL * max(1.0, float(np.abs(ref).max()))
    err = np.abs(port - ref).max(-1).reshape(-1)
    if err.max() <= tol:
        return
    x = np.asarray(np_(xs), np.float64).reshape(-1, 3)
    occ = np.asarray(np_(mc)).reshape(-1) > 0.5
    for s in np.nonzero(err > tol)[0]:
        d = x[occ] - x[s]
        d -= np.round(d / np.asarray(box)) * np.asarray(box)
        near = tab.near_edge(torch.as_tensor(np.sqrt((d * d).sum(1))))
        assert near and err[s] <= tol + tab.edge_jump(), (
            f"{what}: slot {s} off by {err[s]} (tolerance {tol}; near an edge: {near})")


def clustered_points(n=600, seed=5):
    """The port tests' 600-atom fluid in a 6^3 box: a jittered 14^3 lattice
    sampled with a denser octant, so some cells hold far more atoms than
    the mean (float32 (n, 3); the generator continues from the same seed
    as the other tests' inline copies)."""
    rng = np.random.default_rng(seed)
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=n, replace=False, p=w / w.sum())
    return (gridpts[sel] + rng.uniform(-0.04, 0.04, (n, 3))).astype(np.float32)
