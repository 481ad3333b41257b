"""Spatially-sharded coordinate EDM across a mesh of ranks on the PyTorch
port (``edm_tpu_torch``), the counterpart of ``examples/spatial_sharded.py``:
the reference's MPI domain decomposition, one bias-grid brick per rank,
hills exchanged by an all_gather and cum_bias summed over the ranks.

The JAX script runs one program over an 8-device mesh; here
``parallel.launch`` spawns 8 ranks, each running ``rank_main``: NCCL with a
card per rank, else gloo with the ranks sharing one card (or the CPU with
``--device cpu``).  Every rank runs the steps and the gathers; rank 0
prints and writes ``BIAS_GLOBAL`` and the per-replica ``HILLS_<r>`` into
the working directory.  On the card every draw is the Threefry draw
kernel (``tf_bits``).

Run: python examples/torch_spatial_sharded.py [--device cpu|cuda]
(``cuda``, the default, raises when no card is present.)
"""

import argparse
import pathlib
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from edm_tpu_torch import checked_device  # noqa: E402
from edm_tpu_torch.grid import Grid, GridSpec  # noqa: E402
from edm_tpu_torch.models.langevin import LangevinParams  # noqa: E402
from edm_tpu_torch.ops.prng import PRNGKey  # noqa: E402
from edm_tpu_torch.parallel import (  # noqa: E402
    gather_spatial_grid,
    init_spatial_state,
    launch,
    make_mesh,
    make_spatial_coord_step,
    rebin_spatial_atoms,
    spatial_subdivide,
)
from edm_tpu_torch.parallel.spatial import log_spatial_round, write_spatial_grid  # noqa: E402
from edm_tpu_torch.utils.config import parse_edm_text  # noqa: E402
from edm_tpu_torch.utils.hills_log import HillsLog  # noqa: E402

N_DEV = 8
CFG = parse_edm_text(
    "tempering 0\nhill_prefactor 0.2\nbias_per_step 2.0\ndimension 1\n"
    "box_low 0\nbox_high 16\nbias_spacing 0.02\nbias_sigma 0.2\n"
)


def make_target(device="cuda"):
    """Experiment-directed target: an unnormalized -ln p(x) the sampled
    distribution should converge to (here: two preferred regions).  The
    grid is GLOBAL — every rank holds it whole, like every MPI rank
    (edm_bias.cpp:1054-1064)."""
    tspec = GridSpec.create([0.0], [16.0], [0.05], [True])
    xs = np.arange(tspec.nbins[0]) * tspec.dx[0]
    tvals = 1.2 * (1.0 - np.cos(2 * np.pi * xs / 8.0)) / 2.0
    return Grid(
        values=torch.tensor(tvals, dtype=torch.float32, device=device), derivs=None,
        spec=tspec, interpolate=False,
    )


def rank_main():
    """The body of one rank; returns its final state's numbers and the
    stitched global grid, as numpy."""
    mesh = make_mesh()
    dev = mesh.device
    setup, template = spatial_subdivide(
        CFG, 1.0, 1.0, N_DEV, skin=1.2, target=make_target(dev), device=dev
    )
    rng = np.random.default_rng(0)
    x0 = np.stack(
        [rng.uniform(0, 16, 64), np.zeros(64), np.zeros(64)], axis=-1
    )
    state = init_spatial_state(
        setup, template, x0, PRNGKey(0), capacity=32, mesh=mesh
    )
    step = make_spatial_coord_step(
        setup, LangevinParams(dt=0.002, friction=2.0, kT=1.0),
        hill_stride=5, mesh=mesh, collect_records=True,
    )
    hills = None
    if mesh.rank == 0:
        hills = [
            HillsLog(f"HILLS_{d}", 1, setup.params.total_volume) for d in range(N_DEV)
        ]
    cum, rounds, segments = 0.0, 0, []
    for seg in range(4):
        for _ in range(25):
            state, e, logs = step(state)
            added = log_spatial_round(hills, logs, rounds, cum, mesh)
            # a round runs on the same steps on every rank
            if added or bool(logs.happened):
                cum += added
                rounds += 1
        state = rebin_spatial_atoms(setup, state, mesh)  # atom migration
        segments.append((float(e), float(state.bias.cum_bias)))
        if mesh.rank == 0:
            print(f"segment {seg}: energy {segments[-1][0]:.4f} "
                  f"cum_bias {segments[-1][1]:.4f}", flush=True)
    for h in hills or ():
        h.close()
    write_spatial_grid(setup, state, "BIAS_GLOBAL", mesh)
    xg, vg = gather_spatial_grid(setup, state, mesh)
    if mesh.rank == 0:
        print(f"global grid: {xg.shape[0]} points, max bias {vg.max():.4f}; "
              "wrote BIAS_GLOBAL + per-replica HILLS_<r>", flush=True)
    return {"rank": mesh.rank, "segments": segments, "cum": cum, "rounds": rounds,
            "x": state.x.cpu().numpy(), "valid": state.valid.cpu().numpy(),
            "truncated": bool(state.hills_truncated), "xg": xg, "vg": vg}


def main(device="cuda"):
    """Run ``rank_main`` on ``N_DEV`` ranks; returns their results in rank
    order."""
    device = checked_device(device)
    return launch(rank_main, N_DEV, device=device)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
