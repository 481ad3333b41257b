"""Dense N-D grid storage for EDM (reference lib/grid.h:184-905) in PyTorch.

Counterpart of ``edm_tpu/grid.py``: a grid is a small dataclass of tensors
(``values``, optional ``derivs``) plus a static ``GridSpec``.  Operations
return new grids, as in the JAX package; the layout is
``values[i0, ..., i_{D-1}]`` with dim 0 the fastest-running index for file
I/O (Fortran-order flattening reproduces the reference's ``multi2one``).

All of it: ``GridSpec`` (with ``from_deflated`` for file headers),
``Grid`` lookups (nearest-bin and interpolating, any D), nearest-bin
accumulation (the CV histogram), ``clear``, ``add_grid`` (an initial bias
read from a file), the reductions and ``grid_points``.  File I/O is
``utils/gridio``.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .utils.errors import edm_error


def int_floor(x: torch.Tensor) -> torch.Tensor:
    """Round-toward -inf floor returning integer (reference lib/grid.h:17-20)."""
    return torch.floor(x).to(torch.int32)


def device_const(vals, device, dtype) -> torch.Tensor:
    """A host scalar or short sequence as a tensor on ``device``, filled on
    the device: a copy from pageable host memory would synchronize the
    stream.  The hot path asks for the same constants on every step, so
    each is made once per (values, device, dtype) and shared: callers must
    not write into it."""
    if isinstance(vals, torch.Tensor):
        return vals.to(device=device, dtype=dtype)
    key = vals.item() if isinstance(vals, np.generic) else (
        vals if np.ndim(vals) == 0 else tuple(v.item() if isinstance(v, np.generic) else v
                                              for v in vals))
    return _shared_const(key, torch.device(device), dtype)


@functools.lru_cache(maxsize=1024)
def _shared_const(vals, device, dtype) -> torch.Tensor:
    if not isinstance(vals, tuple):
        return torch.full((), vals, dtype=dtype, device=device)
    return torch.stack([torch.full((), v, dtype=dtype, device=device) for v in vals])


def _const(vals, like: torch.Tensor, dtype=None) -> torch.Tensor:
    return device_const(vals, like.device, dtype or like.dtype)


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static geometry of a grid (reference lib/grid.h:199-211):
    ``nbins = ceil((max-min)/spacing)``; ``dx = (max-min)/nbins``;
    non-periodic dims get one extra point and an inflated ``max``."""

    min: Tuple[float, ...]
    max: Tuple[float, ...]  # inflated for non-periodic dims
    dx: Tuple[float, ...]
    nbins: Tuple[int, ...]
    periodic: Tuple[bool, ...]

    @classmethod
    def create(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        bin_spacing: Sequence[float],
        periodic: Sequence[bool],
    ) -> "GridSpec":
        mins, maxs, dxs, ns, ps = [], [], [], [], []
        for lo, hi, sp, p in zip(min, max, bin_spacing, periodic):
            lo, hi, sp = float(lo), float(hi), float(sp)
            n = int(math.ceil((hi - lo) / sp))
            dx = (hi - lo) / n
            if not p:
                n += 1
                hi += dx
            mins.append(lo)
            maxs.append(hi)
            dxs.append(dx)
            ns.append(n)
            ps.append(bool(p))
        return cls(tuple(mins), tuple(maxs), tuple(dxs), tuple(ns), tuple(ps))

    @classmethod
    def from_deflated(
        cls,
        min: Sequence[float],
        max: Sequence[float],
        nbins: Sequence[int],
        periodic: Sequence[bool],
    ) -> "GridSpec":
        """Build from a file header's (deflated) values: non-periodic dims
        are stored with BIN = n-1 and MAX = max-dx and are re-inflated on
        read (reference lib/grid.h:800-806)."""
        mins, maxs, dxs, ns, ps = [], [], [], [], []
        for lo, hi, n, p in zip(min, max, nbins, periodic):
            lo, hi, n = float(lo), float(hi), int(n)
            dx = (hi - lo) / n
            if not p:
                hi += dx
                n += 1
            mins.append(lo)
            maxs.append(hi)
            dxs.append(dx)
            ns.append(n)
            ps.append(bool(p))
        return cls(tuple(mins), tuple(maxs), tuple(dxs), tuple(ns), tuple(ps))

    @property
    def dim(self) -> int:
        return len(self.nbins)

    @property
    def grid_size(self) -> int:
        return int(np.prod(self.nbins))

    @property
    def lengths(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.min, self.max))

    def axis_points(self, d: int) -> np.ndarray:
        return self.min[d] + self.dx[d] * np.arange(self.nbins[d])

    def multi2one(self, index: Sequence[int]) -> int:
        """Collapse an index tuple; dim 0 fastest (reference grid.h:315-325)."""
        result = index[self.dim - 1]
        for i in range(self.dim - 1, 0, -1):
            result = result * self.nbins[i - 1] + index[i - 1]
        return result

    def one2multi(self, index: int) -> Tuple[int, ...]:
        out = []
        for i in range(self.dim - 1):
            out.append(index % self.nbins[i])
            index //= self.nbins[i]
        out.append(index)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class Grid:
    """``values`` of shape ``spec.nbins``; ``derivs`` ``spec.nbins + (D,)``
    or None; ``interpolate`` selects cubic interpolation on lookup."""

    values: torch.Tensor
    derivs: Optional[torch.Tensor]
    spec: GridSpec
    interpolate: bool = False

    @classmethod
    def zeros(cls, spec: GridSpec, derivatives: bool = False,
              interpolate: bool = False, dtype=torch.float32,
              device="cuda") -> "Grid":
        values = torch.zeros(spec.nbins, dtype=dtype, device=device)
        derivs = (
            torch.zeros(spec.nbins + (spec.dim,), dtype=dtype, device=device)
            if derivatives else None
        )
        return cls(values=values, derivs=derivs, spec=spec,
                   interpolate=interpolate)

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def device(self):
        return self.values.device

    @property
    def has_derivatives(self) -> bool:
        return self.derivs is not None

    # ----------------------------------------------------------------- lookup

    def wrap(self, x: torch.Tensor) -> torch.Tensor:
        """Wrap periodic dims into [min, max) (reference grid.h:269-270)."""
        spec = self.spec
        lo = _const(spec.min, self.values)
        length = _const(spec.lengths, self.values)
        per = _const(spec.periodic, self.values, torch.bool)
        wrapped = x - length * torch.floor((x - lo) / length)
        return torch.where(per, wrapped, x)

    def in_grid(self, x: torch.Tensor) -> torch.Tensor:
        """Non-periodic dims need ``min <= x < max - dx`` (reference
        grid.h:865-874; ``max`` is the inflated max)."""
        spec = self.spec
        lo = _const(spec.min, self.values)
        hi = _const(spec.max, self.values) - _const(spec.dx, self.values)
        per = _const(spec.periodic, self.values, torch.bool)
        ok = per | ((x >= lo) & (x < hi))
        return torch.all(ok, dim=-1)

    def get_index(self, x: torch.Tensor) -> torch.Tensor:
        """Point -> per-dim bin index (reference grid.h:264-273), int64."""
        spec = self.spec
        lo = _const(spec.min, self.values)
        dx = _const(spec.dx, self.values)
        xw = self.wrap(x.to(self.dtype))
        idx = torch.floor((xw - lo) / dx).to(torch.int64)
        hi = _const(spec.nbins, self.values, torch.int64) - 1
        return torch.minimum(torch.clamp(idx, min=0), hi)

    def get_value(self, x: torch.Tensor) -> torch.Tensor:
        """Value lookup, x (..., D): interpolated when the grid carries
        derivatives and ``interpolate``, else nearest-bin."""
        if self.interpolate and self.has_derivatives:
            v, _ = self.get_value_deriv(x)
            return v
        x = x.to(self.dtype)
        idx = self.get_index(x)
        vals = self.values[tuple(idx.unbind(-1))]
        return torch.where(self.in_grid(x), vals, torch.zeros_like(vals))

    def get_value_deriv(self, x: torch.Tensor, packed=None):
        from .ops.interp import grid_value_deriv

        return grid_value_deriv(self, x.to(self.dtype), packed=packed)

    # -------------------------------------------------------------- mutation

    def add_value(self, x: torch.Tensor, value) -> Tuple["Grid", torch.Tensor]:
        """Nearest-bin accumulate (reference grid.h:370-385); only for
        non-interpolating grids.  Returns (new grid, amount added)."""
        if self.interpolate:
            edm_error("Cannot add_value when using derivatives", "grid.py:add_value")
        x = x.to(self.dtype)
        value = device_const(value, self.device, self.dtype).expand(x.shape[:-1])
        contrib = torch.where(self.in_grid(x), value, torch.zeros_like(value))
        idx = self.get_index(x)
        new_values = self.values.index_put(
            tuple(i.reshape(-1) for i in idx.unbind(-1)), contrib.reshape(-1),
            accumulate=True,
        )
        return dataclasses.replace(self, values=new_values), contrib

    def clear(self) -> "Grid":
        """The same grid with zero values (and derivatives): the histogram
        reset at every write."""
        nd = None if self.derivs is None else torch.zeros_like(self.derivs)
        return dataclasses.replace(self, values=torch.zeros_like(self.values), derivs=nd)

    def add_grid(self, other: "Grid", scale, offset) -> "Grid":
        """Accumulate ``other`` evaluated at this grid's points (reference
        grid.h:275-290); this grid must carry derivatives."""
        pts = grid_points(self.spec, self.dtype, self.device)
        val, der = other.get_value_deriv(pts)
        return dataclasses.replace(self, values=self.values + scale * val + offset,
                                   derivs=self.derivs + scale * der)

    # ------------------------------------------------------------- reductions

    def max_value(self) -> torch.Tensor:
        return torch.max(self.values)

    def min_value(self) -> torch.Tensor:
        return torch.min(self.values)

    def expected_bias(self) -> torch.Tensor:
        """E[g] under exp(-g), the grid read as an unnormalized -ln(p)
        (reference grid.h:692-710)."""
        g = self.values
        offset = torch.clamp(torch.max(g), min=0.0)
        w = torch.exp(-g - offset)
        return torch.sum(g * w) / torch.sum(w)



def grid_points(spec: GridSpec, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """All grid point coordinates, shape ``spec.nbins + (D,)``."""
    axes = [torch.as_tensor(spec.axis_points(d), dtype=dtype, device=device)
            for d in range(spec.dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)
