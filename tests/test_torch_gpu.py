"""PyTorch port on a GPU: each CUDA kernel against its plain version.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a GPU machine
without them, skipping the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs: a 600-atom LJ fluid with a crowded octant (a real tail above
kernel_cap), built with the port's own entry points from a numpy seed,
and a bias grid carrying deposited hills.  Tolerances as in the CPU parity
tests: forces within 2e-5 * max(1, max|f|), energies 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from _torch_parity import assert_energy, assert_forces
from edm_tpu_torch import bias as B
from edm_tpu_torch.models import pair_edm
from edm_tpu_torch.models.cells import CellSpec
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils.config import parse_edm_text

KCAP, OCAP = 24, 128
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)


@pytest.fixture(scope="module")
def cuda_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    dev = torch.device("cuda", 0)
    n = 600
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(
        torch.tensor(rng.uniform(0.2, 3.0, (80, 1)), dtype=torch.float32, device=dev),
        torch.tensor(rng.uniform(0.01, 0.2, 80), dtype=torch.float32, device=dev))
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=n, replace=False, p=w / w.sum())
    pts = gridpts[sel] + rng.uniform(-0.04, 0.04, (n, 3))
    core = pair_edm.init_state(bs, torch.tensor(pts, dtype=torch.float32, device=dev),
                               PRNGKey(0), n_est=n * 40)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=n, cap=56)
    st = init_cell_state(spec, core, kernel_cap=KCAP, overflow_cap=OCAP)
    return params, spec, st, CF.hermite_pair_table(gg)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [24, 32, 56])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_kernel(cuda_state, k, energy):
    _, spec, st, tbl = cuda_state
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy)
    n0 = CF.cell_force_newton.launches
    f, eb = CF.cell_force_newton(st.xs, st.mc, tbl, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tbl, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.launches == n0 + 1
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 k={k}")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 k={k} energy")
    # deterministic credits: a second launch repeats bitwise
    f2, _ = CF.cell_force_newton(st.xs, st.mc, tbl, **kw)
    assert torch.equal(f, f2)


@pytest.mark.gpu
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_kernel(cuda_state, energy):
    params, spec, st, tbl = cuda_state
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ, spec, static_do_hills=False,
                          static_do_energy=energy, static_do_rebuild=False,
                          kernel_cap=KCAP, overflow_cap=OCAP)
    xo, xp = step._overflow_inputs(st, st.xs)
    assert int((xo[3] > 0.5).sum()) > 20
    kw = dict(box=spec.box, lj=LJ, energy=energy)
    n0 = CF.overflow_force.launches
    fo, fp = CF.overflow_force(xo, xp, tbl, **kw)
    fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tbl, **kw)
    torch.cuda.synchronize()
    assert CF.overflow_force.launches == n0 + 1
    assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), "K2 fo")
    assert_forces(fp.cpu(), fp_ref.cpu(), "K2 fp")
    assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), "K2 energy")


@pytest.mark.gpu
def test_wrappers_check_inputs(cuda_state):
    _, spec, st, tbl = cuda_state
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ, energy=False)
    with pytest.raises(TypeError, match="float32"):
        CF.cell_force_newton(st.xs.double(), st.mc, tbl, k=24, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        CF.cell_force_newton(st.xs.transpose(0, 1).contiguous().transpose(0, 1), st.mc, tbl,
                             k=24, **kw)
    with pytest.raises(ValueError, match="outside"):
        CF.cell_force_newton(st.xs, st.mc, tbl, k=st.xs.shape[1] + 8, **kw)
    with pytest.raises(ValueError, match="is on"):
        CF.cell_force_newton(st.xs, st.mc.cpu(), tbl, k=24, **kw)
