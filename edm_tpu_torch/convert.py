"""Convert JAX-package states and parameters into the port's.

The JAX package's ``BiasParams``, ``BiasState``, ``PairEDMState`` and
``CellPairState`` are dataclass pytrees.  Flattened to nested dicts of
numpy arrays and plain values (every dataclass a dict of its fields, every
array a ``numpy.ndarray``), they are the data this system carries from one
run to the next; ``state_from_numpy`` and ``params_from_numpy`` rebuild
them as the port's dataclasses on ``device``.  Flattening the JAX objects is
the caller's step, so the port never imports jax.

Float arrays keep their dtype, integer arrays become int64, the Threefry key
stays a host-side uint32 array.  The JAX cell state's cached mask planes
(``mnf``, ``mkf``) are dropped: the port derives them from ``mc``.
"""

from __future__ import annotations

import numpy as np
import torch

from .bias import BiasParams, BiasState
from .gauss import GaussGrid, GaussSpec
from .grid import Grid, GridSpec
from .models.pair_edm import PairEDMState
from .models.pair_edm_cells import CellPairState
from .utils.config import EDMConfig


def _tensor(a, device):
    a = np.array(a, dtype=np.int64 if np.asarray(a).dtype.kind in "iu" else None)
    return torch.as_tensor(a, device=device)


def _grid_spec(d) -> GridSpec:
    return GridSpec(**{k: tuple(v) for k, v in d.items()})


def _grid(d, device) -> Grid:
    return Grid(
        values=_tensor(d["values"], device),
        derivs=None if d["derivs"] is None else _tensor(d["derivs"], device),
        spec=_grid_spec(d["spec"]),
        interpolate=bool(d["interpolate"]),
    )


def _gauss_grid(d, device) -> GaussGrid:
    s = d["spec"]
    spec = GaussSpec(grid=_grid_spec(s["grid"]), sigma=tuple(s["sigma"]),
                     boundary_min=tuple(s["boundary_min"]),
                     boundary_max=tuple(s["boundary_max"]),
                     boundary_periodic=tuple(s["boundary_periodic"]))
    return GaussGrid(grid=_grid(d["grid"], device),
                     bc_denom=_tensor(d["bc_denom"], device),
                     bc_denom_deriv=_tensor(d["bc_denom_deriv"], device), spec=spec)


def _bias_state(d, device) -> BiasState:
    t = {k: _tensor(d[k], device) for k in (
        "cum_bias", "buf_pos", "buf_h", "buf_left", "buf_right",
        "overflow_error", "steps")}
    return BiasState(bias=_gauss_grid(d["bias"], device),
                     cv_hist=_grid(d["cv_hist"], device), **t)


def _pair_state(d, device) -> PairEDMState:
    if d.get("cheb") is not None:
        raise NotImplementedError(
            "Chebyshev pair tables are not ported yet (ROADMAP Queue 1, item 7)"
        )
    t = {k: _tensor(d[k], device) for k in (
        "x", "v", "f", "step", "last_calls", "energy", "hills_truncated")}
    return PairEDMState(key=np.asarray(d["key"], np.uint32),
                        bias=_bias_state(d["bias"], device), **t)


def _cell_state(d, device) -> CellPairState:
    for k in ("mn", "sid", "nid", "ts", "tnf"):
        if d.get(k) is not None:
            raise NotImplementedError(
                f"cell states with {k} (id masks or types) are not ported yet "
                "(ROADMAP Queue 1, items 5 and 13)"
            )
    t = {k: _tensor(d[k], device) for k in ("aid", "xs", "vs", "fs", "mc", "table_overflow")}
    tail = {}
    if d.get("ovl") is not None:
        tail = {k: _tensor(d[k], device) for k in (
            "ovl", "tail_count", "tail_ovf", "tail_fallbacks")}
        tail["kernel_cap"] = int(np.asarray(d["mkf"]).shape[1] // 13)
        tail["tail_ovf_host"] = bool(np.asarray(d["tail_ovf"]))
    return CellPairState(core=_pair_state(d["core"], device), **t, **tail)


def state_from_numpy(tree: dict, device="cpu"):
    """A flattened JAX ``CellPairState``, ``PairEDMState`` or ``BiasState``
    -> the port's dataclass on ``device``."""
    if "core" in tree:
        return _cell_state(tree, device)
    if "last_calls" in tree:
        return _pair_state(tree, device)
    if "cv_hist" in tree:
        return _bias_state(tree, device)
    raise ValueError(f"not a known state: keys {sorted(tree)}")


def params_from_numpy(tree: dict, device="cpu") -> BiasParams:
    """A flattened JAX ``BiasParams`` -> the port's ``BiasParams``."""
    cfg = {k: tuple(v) if isinstance(v, (list, tuple)) else v
           for k, v in tree["cfg"].items()}
    return BiasParams(
        target=None if tree["target"] is None else _grid(tree["target"], device),
        expected_target=_tensor(tree["expected_target"], device),
        cfg=EDMConfig(**cfg),
        boltzmann_factor=float(tree["boltzmann_factor"]),
        temperature=float(tree["temperature"]),
        total_volume=float(tree["total_volume"]),
        b_outofbounds=bool(tree["b_outofbounds"]),
        exact_deposit=bool(tree["exact_deposit"]),
    )
