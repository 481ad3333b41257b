"""Pairwise EDM targeting an RDF-derived PMF on the PyTorch port
(``edm_tpu_torch``), the counterpart of ``examples/pairwise_rdf.py`` — the
framework's flagship use case (reference README: matching an
experimentally derived g(r)).

A LJ fluid's pair-distance CV is biased toward a target -ln g(r): hills are
reweighted by exp(target - E[target]) (edm_bias.cpp:545-546) so deposition
concentrates where the target demands more probability.  The dense
all-pairs host (``models.pair_edm``, 216 atoms) runs under
``driver.run_simulation``, which writes the bias grid, the LAMMPS tabular
potential and the CV histogram; on the card the thermostat's normals and
the N^2 acceptance uniforms are the Threefry draw kernel (``tf_bits``).

Run: python examples/torch_pairwise_rdf.py [n_steps] [--device cpu|cuda]
(``cuda``, the default, raises when no card is present.)
"""

import argparse
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from edm_tpu_torch import checked_device  # noqa: E402
from edm_tpu_torch import Grid, GridSpec, bias as B  # noqa: E402
from edm_tpu_torch.models import pair_edm  # noqa: E402
from edm_tpu_torch.models.driver import run_simulation  # noqa: E402
from edm_tpu_torch.models.langevin import LangevinParams  # noqa: E402
from edm_tpu_torch.models.lj import LJParams  # noqa: E402
from edm_tpu_torch.ops.prng import PRNGKey  # noqa: E402
from edm_tpu_torch.utils.config import parse_edm_text  # noqa: E402
from edm_tpu_torch.utils.gridio import read_grid_file, write_grid  # noqa: E402


def main(n_steps=400, device="cuda"):
    """The run in a new temporary directory (the working directory from
    then on, as in the JAX script).  Returns E[target], the final state,
    the mean bias in the target well and outside it, and the directory."""
    device = checked_device(device)
    workdir = tempfile.mkdtemp(prefix="edm_rdf_")
    os.chdir(workdir)

    # target: -ln g(r) favoring a first shell at r ~ 1.5
    spec = GridSpec.create([0], [3.0], [0.05], [False])
    xs = spec.min[0] + spec.dx[0] * np.arange(spec.nbins[0])
    tvals = 2.0 * (1 - np.exp(-((xs - 1.5) ** 2) / 0.1))
    write_grid(Grid(values=torch.as_tensor(tvals), derivs=None, spec=spec), "target.grid")

    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.05\nbias_per_step 0.5\nhill_density 50\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n"
        "target_filename target.grid\n"
    )
    target = read_grid_file("target.grid", dim=1, interpolate=False, dtype=torch.float32,
                            device=device)
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
        target=target, dtype=torch.float32, device=device,
    )
    e_target = float(params.expected_target)
    print(f"E[target] = {e_target:.4f}")

    side, a = 6, 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
        * a + 0.5 * a
    )
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    step = pair_edm.make_step(
        params, lp, LJParams(), box, hill_stride=5, hill_capacity=2048
    )
    st = pair_edm.init_state(state, torch.tensor(pts, dtype=torch.float32, device=device),
                             PRNGKey(0))

    st, e = run_simulation(
        step, st, n_steps=n_steps, write_stride=max(100, n_steps // 4),
        bias_file="BIAS", histogram_file="HIST", lammps_table="BIAS.ltab",
        box_low=cfg.box_low, box_high=cfg.box_high,
        progress=lambda done, s, en: print(
            f"step {done}: cum_bias={float(s.bias.cum_bias):.3f} "
            f"E_bias={float(en[-1]):.3f}"
        ),
    )
    # targeting reweights hills by exp(target - E[target]): LESS bias is
    # deposited where the target wants density (the well at 1.5), so the
    # bias surface develops a dip there that pushes pair density toward it
    v = st.bias.bias.grid.values.cpu().numpy()
    rs = spec.min[0] + 0.02 * np.arange(len(v))
    sel_well = np.abs(rs - 1.5) < 0.2
    sel_out = (np.abs(rs - 2.2) < 0.2) | (np.abs(rs - 0.9) < 0.1)
    well, out = float(v[sel_well].mean()), float(v[sel_out].mean())
    print(
        f"bias at target well (r~1.5): {well:.3f}  "
        f"vs outside: {out:.3f}  (well should be lower)"
    )
    print(f"outputs (BIAS, BIAS.ltab, HIST, HILLS) in {workdir}")
    return {"expected_target": e_target, "state": st, "energies": e, "well": well,
            "outside": out, "workdir": workdir}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n_steps", nargs="?", type=int, default=400)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n_steps, args.device)
