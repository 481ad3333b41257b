"""Single-particle EDM demo on the PyTorch port (``edm_tpu_torch``), the
counterpart of ``examples/single_particle.py`` (the reference's
python-example/EDM.ipynb): construct a bias, deposit a hill, query the
force, then run a short biased Langevin trajectory and watch the CV
histogram flatten.

The MD part is the coordinate host (``models.coord_edm``) driven by
``run_segment``'s host loop with the dynamic step (which reads the step
counter back each step, as JAX's ``lax.cond`` decides); on the card the
BAOAB normals and the acceptance uniforms are the Threefry draw kernel
(``tf_bits``).  The 1,031-point periodic grid deposits through the plain
dense route.

Run: python examples/torch_single_particle.py [--device cpu|cuda]
(``cuda``, the default, raises when no card is present.)
"""

import argparse
import os
import pathlib
import sys
import tempfile
import time

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from edm_tpu_torch import checked_device  # noqa: E402
from edm_tpu_torch import EDMBias, bias as B  # noqa: E402
from edm_tpu_torch.models import coord_edm  # noqa: E402
from edm_tpu_torch.models.langevin import LangevinParams  # noqa: E402
from edm_tpu_torch.ops.prng import PRNGKey  # noqa: E402
from edm_tpu_torch.utils.config import parse_edm_text  # noqa: E402
from edm_tpu_torch.utils.gridio import write_grid  # noqa: E402

N_STEPS = 2000


def main(device="cuda", n_steps=N_STEPS):
    """The demo in a new temporary directory (the working directory from
    then on, as in the JAX script).  Returns the host path's numbers
    (``u``, ``du`` after one hill, ``u20``, ``du20`` after 20 more), the
    MD run's final state and bias energies, and the directory."""
    device = checked_device(device)
    workdir = tempfile.mkdtemp(prefix="edm_demo_")
    os.chdir(workdir)

    # The reference notebook's input.edm (python-example/input.edm) with one
    # fix: bias_per_step is raised above the per-hill integral.  With the
    # original config (sigma 0.5 on a unit box), a single hill integrates to
    # ~3.8 > bias_per_step (= prefactor = 1.0), so the limiter deposits and
    # fully undoes it every round — the bias stays 0 forever.  The compiled
    # reference binary does exactly the same; its own example is a no-op as
    # shipped.
    with open("input.edm", "w") as fh:
        fh.write("tempering 0\nhill_prefactor 1.0\nbias_per_step 20\ndimension 1\n"
                 "box_low 0.0\nbox_high 1.0\nbias_spacing 0.01\nbias_sigma 0.5\n")

    bias = EDMBias("input.edm", temperature=1.0, boltzmann_constant=1.0, device=device)
    bias.set_box([0], [1], [True])
    bias.add_hill([0.25])
    e, grad = bias.get_force([0.24])
    print(f"after one hill at 0.25: U(0.24)={e:.6f}  dU/dx={grad[0]:.6f}")

    t0 = time.time()
    for _ in range(20):
        bias.add_hill([0.25])
    print(f"20 more hills: {(time.time()-t0)/20*1000:.1f} ms/hill (host path)")
    e20, grad20 = bias.get_force([0.24])

    # --- MD: free particle + EDM flattens the sampling
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.25\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.0097\nbias_sigma 0.1\n"
    )
    params, state = B.subdivide(
        cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0], dtype=torch.float32, device=device
    )
    lp = LangevinParams(dt=0.005, friction=1.0, kT=1.0)
    step = coord_edm.make_step(params, lp, hill_stride=10)
    st = coord_edm.init_state(
        params, state, torch.tensor([[5.0]], dtype=torch.float32, device=device), PRNGKey(0),
        lp,
    )
    st, energies = coord_edm.run_segment(step, st, n_steps)
    hist = st.bias.cv_hist.values.cpu().numpy()
    print(
        f"{n_steps} biased MD steps: cum_bias={float(st.bias.cum_bias):.2f}, "
        f"CV visits recorded={hist.sum():.0f}, bias file -> BIAS"
    )
    write_grid(st.bias.bias.grid, "BIAS")
    print(f"outputs in {workdir}")
    return {"u": e, "du": grad[0], "u20": e20, "du20": grad20[0], "state": st,
            "energies": energies, "workdir": workdir}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
