"""PyTorch port: the two legacy force paths against the JAX cell host.

  - K6 ``cell_force_newton_planar`` (plain version) against
    ``cell_forces_pallas_newton_planar`` (interpret mode), Hermite and the
    bench's Chebyshev table, energy on and off: row sums, per-offset
    credits and the bias energy;
  - ``newton_lattice_force`` with both credit schemes (K6 and the 13
    subtractions; K1) against the JAX function;
  - K7 ``cell_force_full`` (plain version) against ``cell_forces_pallas``
    on a ``with_ids`` state, with the bench table and the JAX default
    (one panel of degree 64; ``near_jax``);
  - the slot ids of a ``with_ids`` state through ``convert`` and the
    port's derived stencil planes (JAX ``mn`` and ``nid``);
  - 20 kT = 0 steps, step for step against the JAX host, of
    ``use_pallas="newton"`` (exact Hermite lookup) and of
    ``use_pallas="full"`` (4 panels of degree 16, with_ids: a full rebuild
    every 10 steps).

Inputs: the 600-atom clustered fluid of the other port tests (``cap`` 56,
3^3 cells), its bias grid carrying hills.  Tolerances as in
``_torch_parity``: forces 2e-5 * max(1, max|f|), energies 1e-5 relative,
integer and flag leaves exact, the grid 1e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    ENERGY_RTOL,
    FORCE_REL,
    assert_energy,
    assert_exact,
    assert_forces,
    assert_forces_at_edges,
    clustered_points,
    near_jax,
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
    newton_lattice_force,
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
    """The with_ids slot state of the clustered fluid and a bias grid
    carrying 80 hills, in both packages."""
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
    st = init_cell_state(spec, core, with_ids=True)
    tgg = to_port(dataclasses.replace(bs, bias=gg)).bias
    _CTX.update(spec=spec, st=st, tst=to_port(st), gg=gg, tgg=tgg)
    return _CTX


def _tables(kind):
    """The same lookup table for both packages: "hermite", or a Chebyshev
    fit "cheb P deg" of the grid carrying hills."""
    c = _ctx()
    if kind == "hermite":
        return CP.hermite_pair_table(c["gg"]), CF.hermite_pair_table(c["tgg"])
    _, panels, deg = kind.split()
    ref = jcheb.fit_gauss_grid(c["gg"], int(deg), int(panels))
    return ref, tcheb.ChebTable(cval=torch.as_tensor(np.array(ref.cval)),
                                cder=torch.as_tensor(np.array(ref.cder)), lo=ref.lo, hi=ref.hi)


@pytest.mark.parametrize("kind", ["hermite", "cheb 4 16"])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_planar_plain_vs_pallas(kind, energy):
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg, cap = st.mc.shape
    ref_tab, tab = _tables(kind)
    xc_f, xn_f = _planar_coord_views(st.xs, spec.ncells, cap, Cg)
    fx, fy, fz, fnx, fny, fnz, eb = CP.cell_forces_pallas_newton_planar(
        xc_f, xn_f, st.mc, _half_concat(st.mc, spec.ncells, cap, Cg), ref_tab, cap=cap,
        box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut, energy=energy,
    )
    f, cred, teb = CF.cell_force_newton_planar(tst.xs, tst.mc, tab, ncells=spec.ncells,
                                               box=spec.box, lj=TLJ_, energy=energy)
    assert cred.shape == (Cg, 13, cap, 3) and teb.shape == (Cg, cap)
    assert_forces(f, np.stack([fx, fy, fz], -1), f"K6 {kind} rows")
    assert_forces(cred.reshape(Cg, 13 * cap, 3), np.stack([fnx, fny, fnz], -1),
                  f"K6 {kind} credits")
    assert_energy(teb.sum(), np.asarray(eb).sum(), f"K6 {kind} energy")
    assert energy == bool(np.abs(np.asarray(eb)).sum() > 0)
    C = spec.n_cells
    assert not bool(f[C:].any() or cred[C:].any())  # padded cells


@pytest.mark.parametrize("rescredit", [False, True])
def test_newton_lattice_force_matches_jax(rescredit):
    """Row sums minus the 13 rolled credits (K6) or credits in the kernel
    (K1): the JAX function's energy and forces."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    ref_tab, tab = _tables("hermite")
    e, f = newton_lattice_force(st.xs, st.mc, st.mc, spec.ncells, spec.cap, spec.box, LJ,
                                ref_tab, True, rescredit=rescredit)
    te, tf = tpc.newton_lattice_force(tst.xs, tst.mc, spec.ncells, spec.box, TLJ_, tab, True,
                                      rescredit=rescredit)
    assert_forces(tf, f, f"newton_lattice_force rescredit={rescredit}")
    assert_energy(te, e, "newton_lattice_force energy")
    # Newton's third law: the lattice's forces sum to ~0
    assert float(tf.double().sum(dim=(0, 1)).abs().max()) < 1e-3 * float(tf.abs().max())


@pytest.mark.parametrize("kind", ["cheb 4 16", "cheb 1 64"])
def test_cell_force_full_plain_vs_pallas(kind):
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg, cap = st.mc.shape
    C = spec.n_cells
    ref_tab, tab = _tables(kind)
    # the host's 27 lattice rolls (``_stencil_neighbors``), as a gather
    xs = np.asarray(st.xs)
    xn = xs[:C][spec.stencil()].reshape(C, 27 * cap, 3)
    xn = np.concatenate([xn, np.zeros((Cg - C, 27 * cap, 3), np.float32)])
    f, eb = CP.cell_forces_pallas(
        st.xs, jnp.asarray(xn), st.mc, st.mn, st.sid, st.nid, ref_tab.cval, ref_tab.cder,
        cap=cap, box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut,
        cv_lo=ref_tab.lo, cv_hi=ref_tab.hi,
    )
    kw = dict(ncells=spec.ncells, box=spec.box, lj=TLJ_)
    tf, teb = CF.cell_force_full(tst.xs, tst.mc, tst.sid, tab, **kw)
    tab64 = dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())
    f64, eb64 = CF.cell_force_full_ref(tst.xs.double(), tst.mc.double(), tst.sid.double(),
                                       tab64, **kw)
    err, tol = near_jax(tf, f, f64, FORCE_REL)
    assert err <= tol, f"K7 {kind}: {err} > {tol}"
    err, tol = near_jax(teb.sum(), np.asarray(eb).sum(), eb64.sum(), ENERGY_RTOL)
    assert err <= tol, f"K7 {kind} energy: {err} > {tol}"
    assert float(np.abs(np.asarray(eb)).sum()) > 0
    # the same pairs as the half-stencil kernels: K1's forces and twice its
    # energy, within float32 rounding of the two pair orders
    f1, eb1 = CF.cell_force_newton_ref(tst.xs, tst.mc, tab, k=cap, energy=True, **kw)
    if kind == "cheb 4 16":
        assert_forces(tf, f1, "K7 vs K1")
        assert_energy(0.5 * teb.sum(), eb1.sum(), "K7 vs K1 energy")
    with pytest.raises(ValueError, match="ChebTable"):
        CF.cell_force_full(tst.xs, tst.mc, tst.sid, _tables("hermite")[1], **kw)


def test_with_ids_state_converts():
    """``convert`` carries ``sid``; the port's stencil planes of ``mc`` and
    ``sid`` are the JAX state's ``mn`` and ``nid``; the port builds the
    same ids itself."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    C = spec.n_cells
    assert_exact(tst.sid, st.sid, "sid")
    assert tst.ts is None
    mw = CF.stencil_planes(tst.mc, spec.ncells)
    assert_exact(mw, np.asarray(st.mn)[:C], "mn")
    nid = torch.where(mw > 0.5, CF.stencil_planes(tst.sid, spec.ncells), -1.0)
    assert_exact(nid, np.asarray(st.nid)[:C], "nid")
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    own = tpc.init_cell_state(tspec, tst.core, with_ids=True)
    for f in ("aid", "xs", "mc", "sid"):
        assert_exact(getattr(own, f), getattr(st, f), f)


def _bench_state(cheb):
    """The bench's well-tempered, RDF-targeted bias on the clustered fluid
    with a drift along y (rebuilds at steps 9 and 19); with ``cheb`` the
    bench's Chebyshev table and a state with slot ids."""
    cfg = parse_edm_text(BENCH_CFG)
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = Grid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=jnp.float32, target=target)
    kw = dict(pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4) if cheb else {}
    core = jpe.init_state(bs, jnp.asarray(clustered_points(N)), jax.random.PRNGKey(0),
                          n_est=N * 300, **kw)
    core = dataclasses.replace(core, v=jnp.zeros_like(core.x).at[:, 1].set(5.0))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    return params, spec, init_cell_state(spec, core, with_ids=cheb)


@pytest.mark.parametrize("use_pallas", ["newton", "full"])
def test_legacy_step_matches_jax_step_for_step(use_pallas):
    """20 kT = 0 steps from the same converted state: "newton" with the
    exact Hermite lookup, "full" with the bench's Chebyshev table (its
    forces allow a pair at a table edge, ``assert_forces_at_edges``)."""
    cheb = use_pallas == "full"
    params, spec, st = _bench_state(cheb)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_capacity=512, energy_stride=10, use_pallas=use_pallas)
    jsteps = [jax.jit(make_cell_step(params, lp, LJ, spec, hill_stride=10, rebuild_stride=10,
                                     **kw, **ph)) for ph in PHASES]
    tsteps = [tpc.make_cell_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), TLJ_,
                                 tcells.CellSpec(**dataclasses.asdict(spec)), 10, **kw, **ph)
              for ph in PHASES]
    ts = to_port(st)
    for i in range(20):
        tab = ts.core.cheb
        st, e = jsteps[_phase(i)](st, None)
        ts, te = tsteps[_phase(i)](ts)
        for f in ("aid", "sid", "table_overflow") if cheb else ("aid", "table_overflow"):
            assert_exact(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        for f in ("step", "last_calls", "hills_truncated"):
            assert_exact(getattr(ts.core, f), getattr(st.core, f), f"step {i} core.{f}")
        for f in ("xs", "vs"):
            assert_forces(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        if cheb:
            assert_forces_at_edges(ts.fs, st.fs, st.xs, st.mc, spec.box, tab, f"step {i} fs")
        else:
            assert_forces(ts.fs, st.fs, f"step {i} fs")
        assert_energy(te, e, f"step {i} energy")
        np.testing.assert_allclose(np_(ts.core.bias.cum_bias), np.asarray(st.core.bias.cum_bias),
                                   rtol=1e-6)
        grid = np.asarray(st.core.bias.bias.grid.values)
        np.testing.assert_allclose(np_(ts.core.bias.bias.grid.values), grid, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(grid).max()))
    assert float(st.core.bias.cum_bias) > 0 and not bool(st.core.hills_truncated)
    # with ids every rebuild is the full one, with no host read; without,
    # each rebuild reads the rebin plan's feasibility once
    assert tsteps[2].host_syncs == (0 if cheb else 2) and tsteps[1].host_syncs == 0
    if cheb:
        with pytest.raises(ValueError, match="with_ids"):
            tsteps[1](dataclasses.replace(ts, sid=None))
