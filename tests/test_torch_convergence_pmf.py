"""PyTorch port: the north star's PMF clause on the port alone — the
well-tempered bias converges to -(1 - 1/gamma) U(x) + C.

Mirrors ``tests/test_physics.py::test_double_well_pmf_reconstruction``
with the JAX test's 50,000 steps and assertions, on the port's
``coord_edm`` host with its ``external_force``: one particle in the
periodic double well U = A cos(2 pi x / 5) on [0, 10] (barrier 2A = 3 kT),
bias_factor 8, a hill round every 10 steps, driven by
``driver.strided_segment`` over the host's two static phases.  The bias
must correlate with -U at > 0.7, recover the well-to-barrier contrast
within 0.5-1.5x of (1 - 1/gamma) 2A, and temper (cum_bias > 50).
"""

import math

import numpy as np
import torch

from edm_tpu_torch import bias as B
from edm_tpu_torch.models import coord_edm
from edm_tpu_torch.models.driver import strided_segment
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils.config import parse_edm_text

torch.set_num_threads(1)


def test_double_well_pmf_reconstruction():
    A = 1.5
    gamma = 8.0
    k = 2 * math.pi / 5.0

    def ext(x):
        u = A * torch.cos(k * x[..., 0])
        f = torch.zeros_like(x)
        f[..., 0] = A * k * torch.sin(k * x[..., 0])
        return torch.sum(u), f

    cfg = parse_edm_text(
        f"tempering 1\nbias_factor {gamma}\nglobal_tempering -1\n"
        "hill_prefactor 0.1\nbias_per_step 0.1\ndimension 1\n"
        "box_low 0\nbox_high 10\nbias_spacing 0.05\nbias_sigma 0.4\n"
    )
    params, state = B.subdivide(cfg, 1.0, 1.0, [0], [10], [0], [10], [True], [0],
                                dtype=torch.float32, device="cpu")
    lp = LangevinParams(dt=0.01, friction=1.0, kT=1.0)
    steps = [coord_edm.make_step(params, lp, hill_stride=10, external_force=ext,
                                 static_do_hills=h) for h in (True, False)]
    st = coord_edm.init_state(params, state, torch.tensor([[2.5]], dtype=torch.float32),
                              PRNGKey(7), lp)
    run = strided_segment(steps[0], steps[1], 10, 10000)
    for _ in range(5):
        st, _ = run(st)

    xs = np.linspace(0.2, 9.8, 97)
    v = st.bias.bias.get_value(torch.tensor(xs[:, None], dtype=torch.float32)).numpy()
    u = A * np.cos(2 * np.pi * xs / 5.0)
    scale = 1 - 1 / gamma

    # shape agreement (hill-placement noise allows ~0.75+)
    corr = np.corrcoef(v, -u)[0, 1]

    # recovered free-energy contrast: the bias fills the wells, so
    # V(well) - V(barrier) -> scale * 2A = 2.625
    def mean_near(points):
        sel = np.zeros_like(xs, bool)
        for p in points:
            sel |= np.abs(xs - p) < 0.4
        return v[sel].mean()

    dv = mean_near([2.5, 7.5]) - mean_near([0.0, 5.0, 10.0])
    expect = scale * 2 * A
    print(f"correlation {corr:.3f}, contrast {dv:.3f} (expected {expect:.3f}), cum_bias "
          f"{float(st.bias.cum_bias):.3f}")
    assert int(st.step) == 50000 and not bool(st.hills_truncated)
    assert corr > 0.7, f"bias/-U correlation {corr:.2f}"
    assert 0.5 * expect < dv < 1.5 * expect, f"contrast {dv:.2f} vs {expect:.2f}"
    # tempering actually engaged: cumulative bias growth decelerates
    assert float(st.bias.cum_bias) > 50
