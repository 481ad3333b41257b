"""The starting positions of a cell, made on the device from the
configuration's lattice and the mix's size.  Both the program and the
reference start from these; nothing here depends on the seed, so every
seed runs the same amount of work."""

from __future__ import annotations

import math

import torch

FCC_BASIS = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.0), (0.5, 0.0, 0.5), (0.0, 0.5, 0.5))


def fcc(cells, rho: float, device, dtype=torch.float32):
    """LAMMPS ``lattice fcc rho`` over ``cells`` = (nx, ny, nz) unit cells:
    (positions (4 nx ny nz, 3), box)."""
    a = (4.0 / rho) ** (1.0 / 3.0)
    axes = [torch.arange(n, device=device, dtype=torch.float64) for n in cells]
    sites = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 1, 3)
    basis = torch.tensor(FCC_BASIS, dtype=torch.float64, device=device)
    pts = ((sites + basis[None]) * a).reshape(-1, 3)
    return pts.to(dtype), [n * a for n in cells]


def simple_cubic(n_atoms: int, a: float, device, dtype=torch.float32):
    """bench.py's fluid start: the first ``n_atoms`` sites of a cubic lattice
    of spacing ``a``, each at the centre of its lattice cell, in a periodic
    box of ceil(n^(1/3)) sites a side: (positions, box)."""
    side = int(math.ceil(n_atoms ** (1.0 / 3.0) - 1e-9))
    axis = torch.arange(side, device=device, dtype=torch.float64)
    sites = torch.stack(torch.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    pts = sites[:n_atoms] * a + 0.5 * a
    return pts.to(dtype), [side * a] * 3


JITTER_SEED = 7  # the same displacements for every seed of a run


def positions(cfg: dict, mix: dict, device, dtype=torch.float32):
    """The cell's starting positions and box: an fcc lattice of
    ``unit_cells`` x ``replicate`` unit cells a side (in.lj's index
    variables), or the first ``n_atoms`` sites of a simple cubic one; with
    the mix's ``jitter``, each site moved by up to that much along each
    axis (fixed displacements, whatever the seed)."""
    lat = cfg["lattice"]
    if lat["kind"] == "fcc":
        cells = [lat["unit_cells"] * r for r in mix["replicate"]]
        x, box = fcc(cells, lat["rho"], device, torch.float64)
    elif lat["kind"] == "sc":
        x, box = simple_cubic(int(mix["n_atoms"]), lat["a"], device, torch.float64)
    else:
        raise ValueError(f"unknown lattice kind {lat['kind']!r}")
    if mix.get("jitter"):
        g = torch.Generator(device=device).manual_seed(JITTER_SEED)
        u = torch.rand(x.shape, generator=g, device=device, dtype=torch.float64)
        x = x + (2.0 * u - 1.0) * float(mix["jitter"])
    return x.to(dtype), box
