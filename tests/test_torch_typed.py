"""PyTorch port: the rdf type-pair CV (``types``/``type_pair``) against the
JAX cell host.

  - typed K1 ``cell_force_newton`` (plain version) against
    ``cell_forces_pallas_newton_rescredit`` with types, and typed K6
    ``cell_force_newton_planar`` against ``cell_forces_pallas_newton_planar``
    (interpret mode), Hermite and the bench's Chebyshev table, energy on
    and off;
  - a typed state through ``convert`` and built by the port, and the
    port's derived half-stencil type plane (JAX ``tnf``);
  - 20 kT = 0 steps of the typed default path, step for step against the
    JAX host: K1 at full cap with the type mask and the 27-stencil hill
    collection at steps 0 and 10 (``last_calls``, ``aid``, ``ts`` and the
    flags exact, the grid to 1e-5 relative); the typed round collects
    fewer candidates than the untyped one.

The binary mixture of ``tests/test_md.py``'s type test (every other atom
type 2, the rest type 1; type pair (1, 2)) on the 600-atom clustered fluid
of the other port tests.  Tolerances as in ``_torch_parity``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    assert_energy,
    assert_exact,
    assert_forces,
    clustered_points,
    np_,
    to_port,
)
from edm_tpu import bias as JB
from edm_tpu.grid import Grid, GridSpec
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import (
    _half_concat,
    _planar_coord_views,
    init_cell_state,
    make_cell_step,
)
from edm_tpu.ops import cellforce_pallas as CP
from edm_tpu.ops import chebyshev as jcheb
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops import chebyshev as tcheb

N = 600
TYPES = np.where(np.arange(N) % 2 == 0, 2, 1).astype(np.int32)
PAIR = (1, 2)
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
TLJ_ = TLJ(epsilon=1.0, sigma=0.3, rcut=0.75)
CFG = ("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\nbox_high 3.0\n"
       "bias_spacing 0.02\nbias_sigma 0.1\n")
BENCH_CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
             "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
             "bias_sigma 0.1\n")
PHASES = [dict(static_do_hills=True, static_do_energy=True, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=True)]
_CTX = {}


def _phase(i):
    return 0 if i % 10 == 0 else 2 if i % 10 == 9 else 1


def _ctx():
    """The typed slot state of the clustered fluid and a bias grid carrying
    80 hills, in both packages."""
    if _CTX:
        return _CTX
    _, bs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=jnp.float32)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(jnp.asarray(rng.uniform(0.2, 3.0, (80, 1)), jnp.float32),
                              jnp.asarray(rng.uniform(0.01, 0.2, 80), jnp.float32))
    core = jpe.init_state(bs, jnp.asarray(clustered_points(N)), jax.random.PRNGKey(0),
                          n_est=N * 40)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    st = init_cell_state(spec, core, with_ids=False, types=TYPES)
    tgg = to_port(dataclasses.replace(bs, bias=gg)).bias
    _CTX.update(spec=spec, st=st, tst=to_port(st), gg=gg, tgg=tgg)
    return _CTX


def _tables(kind):
    c = _ctx()
    if kind == "hermite":
        return CP.hermite_pair_table(c["gg"]), CF.hermite_pair_table(c["tgg"])
    ref = jcheb.fit_gauss_grid(c["gg"], 16, 4)
    return ref, tcheb.ChebTable(cval=torch.as_tensor(np.array(ref.cval)),
                                cder=torch.as_tensor(np.array(ref.cder)), lo=ref.lo, hi=ref.hi)


@pytest.mark.parametrize("kernel", ["newton", "planar"])
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
def test_typed_kernels_plain_vs_pallas(kernel, kind, energy):
    """K1 ("newton", credits applied) and K6 ("planar", credits returned)
    at full cap with the type mask."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg, cap = st.mc.shape
    ref_tab, tab = _tables(kind)
    xc_f, xn_f = _planar_coord_views(st.xs, spec.ncells, cap, Cg)
    mn_f = _half_concat(st.mc, spec.ncells, cap, Cg)
    jkw = dict(cap=cap, box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut,
               energy=energy, types=(st.ts, st.tnf), type_pair=PAIR)
    tkw = dict(ncells=spec.ncells, box=spec.box, lj=TLJ_, energy=energy)
    if kernel == "newton":
        fx, fy, fz, eb = CP.cell_forces_pallas_newton_rescredit(
            xc_f, xn_f, st.mc, mn_f, ref_tab, ncells=spec.ncells, **jkw)
        f, teb = CF.cell_force_newton(tst.xs, tst.mc, tab, k=cap, ts=tst.ts, type_pair=PAIR,
                                      **tkw)
        f0, _ = CF.cell_force_newton(tst.xs, tst.mc, tab, k=cap, **tkw)
    else:
        fx, fy, fz, fnx, fny, fnz, eb = CP.cell_forces_pallas_newton_planar(
            xc_f, xn_f, st.mc, mn_f, ref_tab, **jkw)
        f, cred, teb = CF.cell_force_newton_planar(tst.xs, tst.mc, tab, ts=tst.ts,
                                                   type_pair=PAIR, **tkw)
        assert_forces(cred.reshape(Cg, 13 * cap, 3), np.stack([fnx, fny, fnz], -1),
                      f"typed K6 {kind} credits")
        f0, _, _ = CF.cell_force_newton_planar(tst.xs, tst.mc, tab, **tkw)
    assert_forces(f, np.stack([fx, fy, fz], -1), f"typed {kernel} {kind}")
    assert_energy(teb.sum(), np.asarray(eb).sum(), f"typed {kernel} {kind} energy")
    # the mask drops the bias term of the like pairs
    assert float((f - f0).abs().max()) > 1e-3 * float(f0.abs().max())


def test_typed_state_converts():
    """``convert`` carries ``ts``; the port's half-stencil plane of ``ts``
    is the JAX state's ``tnf``; the port builds the same types itself and
    carries them through a rebin."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    C, cap = spec.n_cells, spec.cap
    assert_exact(tst.ts, st.ts, "ts")
    assert tst.sid is None
    assert_exact(tpc._half_concat(tst.ts, spec.ncells, cap)[:, cap:], np.asarray(st.tnf)[:C],
                 "tnf")
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    own = tpc.init_cell_state(tspec, tst.core, types=torch.as_tensor(TYPES))
    for f in ("aid", "xs", "mc", "ts"):
        assert_exact(getattr(own, f), getattr(st, f), f)


def _bench_state():
    cfg = parse_edm_text(BENCH_CFG)
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = Grid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=jnp.float32, target=target)
    core = jpe.init_state(bs, jnp.asarray(clustered_points(N)), jax.random.PRNGKey(0),
                          n_est=N * 300)
    core = dataclasses.replace(core, v=jnp.zeros_like(core.x).at[:, 1].set(5.0))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    return params, spec, init_cell_state(spec, core, with_ids=False, types=TYPES)


def test_typed_step_matches_jax_step_for_step():
    params, spec, st = _bench_state()
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_capacity=512, energy_stride=10, types=TYPES, type_pair=PAIR)
    jsteps = [jax.jit(make_cell_step(params, lp, LJ, spec, hill_stride=10, rebuild_stride=10,
                                     use_pallas=True, **kw, **ph)) for ph in PHASES]
    tparams, tspec = to_port(params), tcells.CellSpec(**dataclasses.asdict(spec))
    tlp = TLP(dt=0.002, friction=1.0, kT=0.0)
    tsteps = [tpc.make_cell_step(tparams, tlp, TLJ_, tspec, 10, use_pallas=True, **kw, **ph)
              for ph in PHASES]
    ts = ts0 = to_port(st)
    for i in range(20):
        st, e = jsteps[_phase(i)](st, None)
        ts, te = tsteps[_phase(i)](ts)
        for f in ("aid", "ts", "table_overflow"):
            assert_exact(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        for f in ("step", "last_calls", "hills_truncated"):
            assert_exact(getattr(ts.core, f), getattr(st.core, f), f"step {i} core.{f}")
        for f in ("xs", "vs", "fs"):
            assert_forces(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        assert_energy(te, e, f"step {i} energy")
        np.testing.assert_allclose(np_(ts.core.bias.cum_bias), np.asarray(st.core.bias.cum_bias),
                                   rtol=1e-6)
        grid = np.asarray(st.core.bias.bias.grid.values)
        np.testing.assert_allclose(np_(ts.core.bias.bias.grid.values), grid, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(grid).max()))
    assert float(st.core.bias.cum_bias) > 0 and not bool(st.core.hills_truncated)
    # the typed round's candidates are a strict subset of the untyped one's
    untyped = tpc.make_cell_step(tparams, tlp, TLJ_, tspec, 10, use_pallas=True,
                                 hill_capacity=512, energy_stride=10,
                                 **PHASES[0])
    typed_calls = int(tsteps[0](ts0)[0].core.last_calls)
    assert 0 < typed_calls < int(untyped(ts0)[0].core.last_calls)
    with pytest.raises(ValueError, match="slot types"):
        tsteps[1](dataclasses.replace(ts, ts=None))
