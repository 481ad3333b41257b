"""Weak-scaling proxy for the sharded cell hosts on the PyTorch port
(``edm_tpu_torch``), the counterpart of
``examples/weak_scaling_cpu_mesh.py``.

Every configuration holds the work per rank constant (an 8 x 8 x 8 lattice,
512 atoms, per rank) and measures:

1. **Per-rank work balance**: the decomposition's cells-per-rank spread
   (asserted <= one column per sharded axis), which bounds the
   load-imbalance term of the scaling efficiency.
2. **Aggregate-work overhead**: T(n ranks, n x work) / (n * T(1 rank,
   1 x work)) - 1.  Where the ranks share one device (one card over gloo,
   or the CPU with ``--device cpu``) their compute serializes, so this
   ratio isolates the *extra* work the sharded program does per rank
   (halo columns, collectives, credit exchange, replicated hill rounds).

All three decompositions are measured: the 1-D slab (per-rank
x-columns), the 2-D brick (x-range x y-range bricks) and the 3-D brick
((2, 2, 2)).  Each uses the bench's Chebyshev table (4 panels of degree
16), so on the card every step runs K1 ``cell_force_newton`` over the
rank's owned cell box (``row_box``) with the Clenshaw lookup.

A configuration of n > 1 ranks runs in ranks spawned by
``parallel.launch`` (NCCL with a card per rank, else gloo with the ranks
sharing one card); the configurations of one rank count share a launch,
and one rank runs in this process.  A row is printed when its launch
returns, rank 0's times; the overhead lines follow in the JAX script's
order.

Run: python examples/torch_weak_scaling.py [--device cpu|cuda]
(``cuda``, the default, raises when no card is present.)
Prints one JSON line per configuration.
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from edm_tpu_torch import checked_device  # noqa: E402
from edm_tpu_torch import bias as B  # noqa: E402
from edm_tpu_torch.models import pair_edm  # noqa: E402
from edm_tpu_torch.models.cells import CellSpec  # noqa: E402
from edm_tpu_torch.models.langevin import LangevinParams  # noqa: E402
from edm_tpu_torch.models.lj import LJParams  # noqa: E402
from edm_tpu_torch.models.pair_edm_cells import init_cell_state  # noqa: E402
from edm_tpu_torch.ops.prng import PRNGKey  # noqa: E402
from edm_tpu_torch.parallel import launch, make_brick_mesh, make_mesh  # noqa: E402
from edm_tpu_torch.parallel.cells import make_brick_cell_step, make_slab_cell_step  # noqa: E402
from edm_tpu_torch.utils.config import parse_edm_text  # noqa: E402

SIDE_PER_DEV = 8  # 8x8x8 lattice = 512 atoms per rank at density 0.5
A = 1.26
STEPS = 10
CONFIGS = ((1, None), (2, None), (4, None), (8, None),
           (4, (2, 2)), (8, (4, 2)), (8, (2, 2, 2)))


def rank_grid(n_dev: int, grid=None):
    """(px, py, pz): the rank grid of a slab over ``n_dev`` (grid=None) or
    of a brick ``grid``."""
    if grid and len(grid) == 3:
        return tuple(grid)
    px, py = grid if grid else (n_dev, 1)
    return px, py, 1


def lattice_setup(dims, device="cuda"):
    """The lattice for a (px, py, pz) rank grid ``dims`` on ``device``:
    (BiasParams, CellSpec, initial CellPairState with the Chebyshev
    table)."""
    nx, ny, nz = (SIDE_PER_DEV * p for p in dims)
    n_atoms = nx * ny * nz
    pts = (
        np.stack(np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij"), -1).reshape(-1, 3) * A + 0.5 * A
    )
    box = [nx * A, ny * A, nz * A]
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 100\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
    )
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], device=device
    )
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n_atoms)
    core = pair_edm.init_state(
        bias_state, torch.tensor(pts, dtype=torch.float32, device=device), PRNGKey(0),
        n_est=n_atoms * 20, pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4,
    )
    return params, spec, init_cell_state(spec, core, with_ids=False)


def run(n_dev: int, grid=None, device=None, steps: int = STEPS):
    """grid=None: 1-D slab over n_dev; grid=(px, py[, pz]): 2-D/3-D brick
    (the atom lattice grows along every sharded axis so work/rank is
    constant).  Every rank of an ``n_dev``-rank group calls it (n_dev = 1:
    no group needed).  ``device``: the rank's device (default: the one
    ``launch`` gave it)."""
    px, py, pz = rank_grid(n_dev, grid)
    mesh = make_brick_mesh(*grid, device=device) if grid else make_mesh(n_dev, device=device)
    params, spec, state = lattice_setup((px, py, pz), mesh.device)
    n_atoms = spec.n_atoms
    kw = dict(hill_stride=10, rebuild_stride=10, energy_stride=10)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    cols = []
    for n_ax, p_ax in ((spec.ncells[0], px), (spec.ncells[1], py),
                       (spec.ncells[2], pz)):
        q, rem = divmod(n_ax, p_ax)
        c = [q + (d < rem) for d in range(p_ax)]
        assert max(c) - min(c) <= 1, f"imbalance: columns per device {c}"
        cols.append(c)
    if grid:
        step = make_brick_cell_step(params, lp, LJParams(), spec, mesh=mesh, **kw)
    else:
        step = make_slab_cell_step(params, lp, LJParams(), spec, mesh=mesh, **kw)

    state, _ = step(state)  # settle (the JAX script's compile step)
    best = None
    s = state
    for _ in range(3):
        t0 = time.perf_counter()
        s = state
        for _ in range(steps):
            s, e = step(s)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)  # force completion
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    # the sharded-floor per-rank row budgets must not truncate at this
    # workload (truncation would silently shrink the hill rounds measured)
    assert not bool(s.table_overflow) and not bool(s.core.hills_truncated)
    assert bool(torch.isfinite(s.xs).all()), "non-finite positions"
    return {
        "mode": (
            "x".join(str(p) for p in grid).join(("brick ", ""))
            if grid
            else "slab"
        ),
        "n_dev": n_dev,
        "atoms": n_atoms,
        "cells_per_dev_xyz": cols,
        "steps_per_sec": round(steps / best, 3),
        "sec_per_step": round(best / steps, 4),
    }


def run_group(configs, steps):
    """The body of one rank: every configuration of ``configs`` (all of
    one rank count) in turn."""
    return [run(n, grid, steps=steps) for n, grid in configs]


def main(device="cuda", configs=CONFIGS, steps: int = STEPS):
    """Run ``configs`` ((n_dev, grid) pairs); prints and returns their
    rows in ``configs``' order."""
    device = checked_device(device)
    by_n = {}
    for i, (n, grid) in enumerate(configs):
        by_n.setdefault(n, []).append((i, (n, grid)))
    rows = [None] * len(configs)
    for n, group in by_n.items():
        todo = [c for _, c in group]
        if n == 1:
            out = [run(1, grid, device=device, steps=steps) for _, grid in todo]
        else:
            out = launch(run_group, n, todo, steps, device=device)[0]
        for (i, _), r in zip(group, out):
            rows[i] = r
            print(json.dumps(r), flush=True)
    t1 = rows[0]["sec_per_step"]
    for r in rows[1:]:
        # aggregate-work overhead: extra per-rank work under sharding
        # (halo columns + collectives + replicated rounds), the scaling
        # loss term measurable where the ranks share a device
        r["agg_overhead"] = round(r["sec_per_step"] / (r["n_dev"] * t1) - 1, 3)
        print(json.dumps({"mode": r["mode"], "n_dev": r["n_dev"],
                          "agg_overhead": r["agg_overhead"]}))
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
