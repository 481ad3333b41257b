"""PyTorch port: the two force kernels' plain versions against the Pallas
kernels they replace (interpret mode on the CPU).  The kernels themselves
are held to the plain versions on a GPU in ``test_torch_gpu.py``.

K1 ``cell_force_newton`` vs ``cell_forces_pallas_newton_rescredit`` at
k = 24 and 32, energy on and off; K2 ``overflow_force`` vs
``overflow_forces_pallas`` on a real tail.  The JAX inputs are built with
``_planar_coord_views`` and ``_half_concat`` from the same slot lattice.
Forces agree within 2e-5 * max(1, max|f|), energies within 1e-5 relative,
the Hermite table within 1e-6 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_energy, assert_forces, to_port
from edm_tpu import bias as JB
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import _half_concat, _planar_coord_views, init_cell_state
from edm_tpu.ops import cellforce_pallas as CP
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import cellforce as CF

KCAP, OCAP = 24, 128
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
TLJ_ = TLJ(epsilon=1.0, sigma=0.3, rcut=0.75)
_CTX = {}


def _ctx():
    """600 atoms on a jittered lattice with a denser octant (cells above
    kernel_cap: a real tail), and a bias grid carrying deposited hills."""
    if _CTX:
        return _CTX
    n = 600
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    _, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=jnp.float32)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(jnp.asarray(rng.uniform(0.2, 3.0, (80, 1)), jnp.float32),
                              jnp.asarray(rng.uniform(0.01, 0.2, 80), jnp.float32))
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=n, replace=False, p=w / w.sum())
    pts = (gridpts[sel] + rng.uniform(-0.04, 0.04, (n, 3))).astype(np.float32)
    core = jpe.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=n * 40)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=n, cap=56)
    st = init_cell_state(spec, core, with_ids=False, kernel_cap=KCAP, overflow_cap=OCAP)
    tgg = to_port(dataclasses.replace(bs, bias=gg)).bias
    _CTX.update(spec=spec, st=st, gg=gg, tst=to_port(st), tgg=tgg)
    return _CTX


def test_hermite_pair_table():
    c = _ctx()
    ref = CP.hermite_pair_table(c["gg"])
    out = CF.hermite_pair_table(c["tgg"])
    G = ref.geom[1]
    assert out.geom == (G,) + tuple(ref.geom[2:])
    np.testing.assert_allclose(out.tab.numpy(), np.asarray(ref.tab)[:, :G].T, rtol=1e-6,
                               atol=1e-6 * float(np.abs(np.asarray(ref.tab)).max()))


@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_plain_vs_pallas(k, energy):
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg = st.xs.shape[0]
    xs_k, mc_k = st.xs[:, :k], st.mc[:, :k]
    xc_f, xn_f = _planar_coord_views(xs_k, spec.ncells, k, Cg)
    mn_f = _half_concat(mc_k, spec.ncells, k, Cg)
    fx, fy, fz, eb = CP.cell_forces_pallas_newton_rescredit(
        xc_f, xn_f, mc_k, mn_f, CP.hermite_pair_table(c["gg"]), cap=k,
        ncells=spec.ncells, box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma,
        lj_rcut=LJ.rcut, energy=energy,
    )
    f, teb = CF.cell_force_newton(tst.xs, tst.mc, CF.hermite_pair_table(c["tgg"]), k=k,
                                  ncells=spec.ncells, box=spec.box, lj=TLJ_, energy=energy)
    assert f.shape == tuple(st.xs.shape) and teb.shape == (Cg, k)
    assert_forces(f[:, :k], np.stack([fx, fy, fz], -1), f"K1 k={k}")
    assert not bool(f[:, k:].any())
    assert_energy(teb.sum(), np.asarray(eb).sum(), f"K1 k={k} energy")
    if energy:
        assert float(np.abs(np.asarray(eb)).sum()) > 0


@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_plain_vs_pallas(energy):
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg, cap = st.mc.shape
    S = Cg * cap
    ovl = np.asarray(st.ovl)
    assert (ovl < S).sum() > 20, "the setup must carry a real tail"
    xs = np.asarray(st.xs).reshape(S, 3)
    mo = (ovl < S).astype(np.float32)
    xo3 = xs[np.clip(ovl, 0, S - 1)] * mo[:, None]
    xo = np.concatenate([xo3.T, mo[None], mo[None]]).astype(np.float32)  # x y z mask own
    xp = np.concatenate([np.asarray(st.xs)[:, :KCAP].reshape(-1, 3).T,
                         np.asarray(st.mc)[:, :KCAP].reshape(1, -1)]).astype(np.float32)
    N = xp.shape[1]
    N_pad = -(-N // 128) * 128
    fo, fp = CP.overflow_forces_pallas(
        jnp.asarray(np.concatenate([xo, np.zeros((3, OCAP), np.float32)])),
        jnp.asarray(np.pad(xp, ((0, 0), (0, N_pad - N)))), CP.hermite_pair_table(c["gg"]),
        box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut, energy=energy,
    )
    tfo, tfp = CF.overflow_force(torch.as_tensor(xo), torch.as_tensor(xp),
                                 CF.hermite_pair_table(c["tgg"]), box=spec.box, lj=TLJ_,
                                 energy=energy)
    assert_forces(tfo[:3], np.asarray(fo)[:3], "K2 fo")
    assert_forces(tfp, np.asarray(fp)[:3, :N], "K2 fp")
    assert_energy(tfo[3].sum(), np.asarray(fo)[3].sum(), "K2 energy")


def test_wrappers_reject_other_devices():
    c = _ctx()
    tst = c["tst"]
    tbl = CF.hermite_pair_table(c["tgg"])
    meta = tst.xs.to("meta")
    with pytest.raises(ValueError, match="no cell-force kernel"):
        CF.cell_force_newton(meta, tst.mc.to("meta"), tbl, k=24, ncells=c["spec"].ncells,
                             box=c["spec"].box, lj=TLJ_, energy=False)
    with pytest.raises(ValueError, match="no overflow-force kernel"):
        CF.overflow_force(torch.zeros(5, 8, device="meta"), torch.zeros(4, 16, device="meta"),
                          tbl, box=c["spec"].box, lj=TLJ_, energy=False)
