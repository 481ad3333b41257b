"""Cell-occupancy / tail telemetry on the bench workload, on the PyTorch
port (``edm_tpu_torch``): the counterpart of ``examples/occupancy_diag.py``.

Measures the occupancy distribution the kernel_cap/overflow_cap knobs
must be sized from — the distribution is super-Poisson under bias load
AND starts from a commensurate-lattice transient (64 cells x 27 atoms at
10k => tail 192 at step 0).  This prints what is actually there:
``models.pair_edm_cells.cell_diag`` JSON lines at init and after each
simulation segment of the EXACT ``bench.bench_pairwise`` configuration
(same RDF-targeted well-tempered workload, same lattice, same step
pattern), at full cap (no kernel_cap).

The JAX script scans the dynamic step; here a segment is
``driver.pattern_segment`` over the host's three static phase steps (a
hill step with the energy, 8 plain steps, a rebuild step), the cycle the
dynamic step runs (``tests/test_torch_run.py`` holds the two bitwise).  On
the card every step is K1 ``cell_force_newton`` at full cap, the
thermostat's normals ``hash_normals``, and each hill step pass 1
``p1_count_half`` and pass 2's draws ``hash_uniforms``.

Usage:
    python examples/torch_occupancy_diag.py --n 10000  --segments 8
    python examples/torch_occupancy_diag.py --n 100000 --segments 8 --steps 200
(``--device cpu`` runs on the CPU; ``cuda``, the default, raises when no
card is present.)

Reference bar: the reference has no occupancy concept (its per-pair
loop is occupancy-free, fix_edm_pair.cpp:177-227); this telemetry is
what replaces guessing for the fixed-shape cell tiles.
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
from edm_tpu_torch.grid import Grid, GridSpec  # noqa: E402
from edm_tpu_torch.models import pair_edm  # noqa: E402
from edm_tpu_torch.models.cells import CellSpec  # noqa: E402
from edm_tpu_torch.models.driver import pattern_segment  # noqa: E402
from edm_tpu_torch.models.langevin import LangevinParams  # noqa: E402
from edm_tpu_torch.models.lj import LJParams  # noqa: E402
from edm_tpu_torch.models.pair_edm_cells import (  # noqa: E402
    cell_diag,
    init_cell_state,
    make_cell_step,
)
from edm_tpu_torch.ops.prng import PRNGKey  # noqa: E402
from edm_tpu_torch.utils.config import parse_edm_text  # noqa: E402


def setup(n, device="cuda"):
    """The exact bench_pairwise configuration (bench.py) at ``n`` atoms:
    (CellSpec, initial CellPairState, [hill step, plain step, rebuild
    step])."""
    device = checked_device(device)
    dtype = torch.float32
    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\n"
        "hill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
        "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
        "bias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    r_pts = np.arange(tspec.nbins[0]) * tspec.dx[0] + tspec.min[0]
    tvals = -2.0 * np.log(np.maximum(r_pts, 0.5))
    target = Grid(values=torch.tensor(tvals, dtype=dtype, device=device), derivs=None,
                  spec=tspec, interpolate=False)
    params, bias_state = B.subdivide(
        cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=dtype,
        target=target, device=device,
    )
    side = int(np.ceil(n ** (1 / 3)))
    a = 1.26
    pts = (
        np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
        .reshape(-1, 3)[:n] * a + 0.5 * a
    )
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    core = pair_edm.init_state(
        bias_state, torch.tensor(pts, dtype=dtype, device=device), PRNGKey(0),
        n_est=n * 40, pair_lookup="interp",
    )
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n)
    state = init_cell_state(spec, core, with_ids=False)
    steps = [
        make_cell_step(params, lp, lj, spec, hill_stride=10, rebuild_stride=10,
                       hill_capacity=2048, cell_chunk=81, use_pallas=True, energy_stride=10,
                       static_do_hills=h, static_do_energy=e, static_do_rebuild=r)
        for h, e, r in ((True, True, False), (False, False, False), (False, False, True))
    ]
    return spec, state, steps


def main(argv=None):
    """Prints the JSON lines; returns them as dicts, and the final state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10000)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--steps", type=int, default=300,
                    help="steps per segment (multiple of 10)")
    ap.add_argument("--kcaps", type=int, nargs="+", default=[16, 24, 28],
                    help="kernel_cap candidates to price the tail at")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    spec, state, steps = setup(args.n, args.device)
    assert args.steps % 10 == 0
    seg = pattern_segment([(steps[0], 1), (steps[1], 8), (steps[2], 1)], args.steps)
    lines = []

    def emit(tag, st):
        d = cell_diag(spec, st, kernel_caps=tuple(args.kcaps))
        d["at"] = tag
        print(json.dumps(d), flush=True)
        lines.append(d)

    emit("init (step 0, lattice)", state)
    for k in range(args.segments):
        t0 = time.perf_counter()
        state, _ = seg(state)
        emit(f"step {(k + 1) * args.steps}", state)
        print(f"# segment rate ~{args.steps / (time.perf_counter() - t0):.1f}"
              " steps/s (incl. diag fetch)", flush=True)
    assert not bool(state.table_overflow), "cell cap exhausted"
    assert not bool(state.core.hills_truncated)
    return lines, state


if __name__ == "__main__":
    main()
