"""A kind for the harness's own tests, never in ``BENCHMARK.json``: the
port's coordinate host (``coord_edm.make_step``, LAMMPS ``fix edm``) on
free particles in 1-D, with a stride cycle of 1 hill + 9 plain steps and
no rebuild, and checks of its own.  The tests put it in ``sys.modules``
as ``edmbench.kinds.<name>``, so that ``kinds.load`` finds it as it
finds a kind of the benchmark."""

from __future__ import annotations

import types

import torch

PATTERN = [("hill", 1), ("plain", 9)]
NUMBERS = ("step_mismatch", "grid_mismatch")
EDM = ("tempering 1\nbias_factor 10\nhill_prefactor 0.5\nbias_per_step 0.2\n"
       "hill_density 40\ndimension 1\nbox_low 0\nbox_high 10\nbias_spacing 0.05\n"
       "bias_sigma 0.2\n")


def make_mesh(mix: dict):
    return None


def build(cfg: dict, mix: dict, seed: int, device, mesh=None):
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.models import coord_edm
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.utils.config import parse_edm_text

    params, bias_state = B.subdivide(parse_edm_text(EDM), 1.0, 1.0, [0.0], [10.0], [0.0],
                                     [10.0], [True], [0.0], dtype=torch.float64, device=device)
    n = int(mix["n_particles"])
    x0 = torch.linspace(0.01, 9.99, n, dtype=torch.float64, device=device)[:, None]
    lp = LangevinParams(dt=0.01, friction=1.0, kT=1.0)
    state = coord_edm.init_state(params, bias_state, x0, PRNGKey(seed), lp)
    steps = {p: coord_edm.make_step(params, lp, 10, hill_capacity=64, static_do_hills=p == "hill")
             for p, _ in PATTERN}
    return types.SimpleNamespace(state=state, steps=steps, n=n)


def geometry(system) -> dict:
    return dict(n=system.n)


def snapshot(state) -> dict:
    return dict(x=state.x, step=int(state.step), grid=state.bias.bias.grid.values)


def replicated(state) -> list:
    return [state.x]


def counters(system) -> dict:
    return dict(host_syncs=sum(s.host_syncs for s in system.steps.values()))


def judge(cfg: dict, geom: dict, steps, dtype=None) -> tuple:
    """Each step advances the counter by one; a hill step changes the
    bias grid and a plain step does not."""
    values = dict.fromkeys(NUMBERS, 0.0)
    move = 0.0
    for phase, s0, s1 in steps:
        values["step_mismatch"] += float(s1["step"] != s0["step"] + 1)
        values["grid_mismatch"] += float((phase == "hill") == torch.equal(s0["grid"], s1["grid"]))
        move = max(move, float(torch.abs(s1["x"] - s0["x"]).max()))
    return values, dict(largest_move=move)


def work(cfg: dict, snap: dict, geom: dict) -> dict:
    """A plain step: the lookup and BAOAB's stages a particle, its
    position, velocity and force read and written once."""
    n = geom["n"]
    return dict(flops=float(n * (16 + 33)), bytes=float(n * 8 * 6))
