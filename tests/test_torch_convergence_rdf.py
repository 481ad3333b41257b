"""PyTorch port: the north star's convergence clause on the port alone —
the sampled pair-distance distribution converges to the target.

Mirrors ``tests/test_workflows.py::test_rdf_convergence_to_target`` with
the JAX test's step counts and assertions, on the port's dense
``pair_edm`` host: an ideal dimer in a periodic box, the target a
Gaussian well at r0 = 1.8, a hill round every step accepting every pair
(hill_density < 0), 4,000 burn-in steps while the bias builds, then 8,000
measured steps.  The accepted-hill CV histogram must match the target
distribution at L1 < 0.2, three times closer than the unbiased r^2
volume-element distribution, with its mode within one bin of r0 (the EDM
theorem: White, Dama and Voth, JCTC 2015).
"""

import dataclasses

import numpy as np
import torch

from edm_tpu_torch import bias as B
from edm_tpu_torch.grid import Grid, GridSpec
from edm_tpu_torch.models import pair_edm
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils.config import parse_edm_text

torch.set_num_threads(1)


def _run(step, state, n):
    for _ in range(n):
        state, _ = step(state)
    return state


def test_rdf_convergence_to_target():
    R0, S = 1.8, 0.35
    cfg = parse_edm_text(
        "tempering 0\nhill_prefactor 0.02\nbias_per_step 5.0\nhill_density -1\n"
        "dimension 1\nbox_low 0\nbox_high 2.7\nbias_spacing 0.03\nbias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [2.7], [0.03], [False])
    xs = tspec.min[0] + tspec.dx[0] * np.arange(tspec.nbins[0])
    w = np.minimum((xs - R0) ** 2 / (2 * S * S), 4.0)
    target = Grid(values=torch.tensor(w, dtype=torch.float64), derivs=None, spec=tspec,
                  interpolate=False)
    params, bias_state = B.subdivide(cfg, 1.0, 1.0, [0], [2.7], [0], [2.7], [False], [0],
                                     target=target, dtype=torch.float64, device="cpu")
    lp = LangevinParams(dt=0.005, friction=2.0, kT=1.0)
    lj = LJParams(epsilon=0.0, sigma=1.0, rcut=0.5)  # ideal dimer
    x0 = torch.tensor([[0.5, 0.5, 0.5], [1.5, 0.5, 0.5]], dtype=torch.float64)
    step = pair_edm.make_step(params, lp, lj, [3.0] * 3, hill_stride=1, hill_capacity=4,
                              static_do_hills=True)
    st = pair_edm.init_state(bias_state, x0, PRNGKey(2))
    st = _run(step, st, 4000)  # burn-in while the bias builds
    st = dataclasses.replace(st, bias=dataclasses.replace(st.bias, cv_hist=st.bias.cv_hist.clear()))
    st = _run(step, st, 8000)  # measurement phase

    hist = st.bias.cv_hist.values.numpy()
    hspec = st.bias.cv_hist.spec
    hx = hspec.min[0] + hspec.dx[0] * np.arange(hspec.nbins[0])
    p = hist / hist.sum()
    pstar = np.exp(-np.minimum((hx - R0) ** 2 / (2 * S * S), 4.0))
    pstar /= pstar.sum()
    base = hx**2
    base /= base.sum()

    l1_target = np.abs(p - pstar).sum()
    l1_unbiased = np.abs(p - base).sum()
    print(f"L1 to the target {l1_target:.4f}, to the unbiased baseline {l1_unbiased:.4f}")
    assert np.isfinite(st.x.numpy()).all() and not bool(st.hills_truncated)
    assert l1_target < 0.2, f"sampled CV distribution off target: L1={l1_target}"
    assert l1_unbiased > 3 * l1_target, "biasing did not move sampling off baseline"
    # mode within one sigma-bin of the target well
    assert abs(hx[p.argmax()] - R0) <= hspec.dx[0] + 1e-9
