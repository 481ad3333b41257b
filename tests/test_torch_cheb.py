"""PyTorch port: the Chebyshev pair lookup (K3) against the JAX package.

  - the fit (``fit_gauss_grid``), ``derivative_coeffs`` and
    ``clenshaw_panels`` from the same grid and points, in float64 (to
    1e-12 of max|c|) and float32 (to 1e-5 of max|c|, plus the fit
    product's rounding bound), for the JAX default table (1 panel, degree
    64) and the bench table (4 panels, degree 16);
  - K1's and K2's plain versions with a ``ChebTable`` against the Pallas
    kernels with the same coefficients (interpret mode), forces within
    2e-5 * max(1, max|f|), energies within 1e-5 relative, or within twice
    the Pallas kernel's own float32 error where that is larger (the
    degree-64 table, ``near_jax``);
  - the Chebyshev slice end to end: ``test_torch_slice.py``'s 600-atom,
    20-step kT = 0 run with ``pair_lookup="chebyshev", cheb_deg=16,
    cheb_panels=4``, step for step at that test's tolerances, the refit
    table included; a pair within an ulp of the table's edge may add the
    table's jump there to its atoms' forces (``assert_forces_at_edges``).
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

TABLES = [(1, 64), (4, 16)]  # (panels, degree): the JAX default, the bench
CFG = ("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\nbox_high 3.0\n"
       "bias_spacing 0.02\nbias_sigma 0.1\n")


def _bias_with_hills(dtype):
    """The pair-CV bias state of the cell tests, carrying 80 hills."""
    _, bs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=dtype)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(jnp.asarray(rng.uniform(0.2, 3.0, (80, 1)), dtype),
                              jnp.asarray(rng.uniform(0.01, 0.2, 80), dtype))
    return gg, to_port(dataclasses.replace(bs, bias=gg)).bias


def _assert_coeffs(port, ref, rel, what):
    ref = np.asarray(ref, np.float64)
    atol = rel * float(np.abs(ref).max())
    np.testing.assert_allclose(np.asarray(np_(port), np.float64), ref, rtol=0, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("panels,deg", TABLES)
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_fit_and_series_match_jax(panels, deg, dtype):
    """In float32 the fit's product M @ values also gets its rounding bound
    2 eps (|M| @ |values|): the single-panel degree-64 fit sums terms of up
    to ~1e4 into coefficients of ~1, and both packages then sit ~1.3e-4 off
    the float64 fit.  ``cder`` is held to the JAX recurrence applied to the
    port's own ``cval``."""
    rel = 1e-12 if dtype == "float64" else 1e-5
    gg, tgg = _bias_with_hills(jnp.dtype(dtype))
    ref = jcheb.fit_gauss_grid(gg, deg, panels)
    out = tcheb.fit_gauss_grid(tgg, deg, panels)
    assert (out.lo, out.hi, out.deg, out.npanels) == (ref.lo, ref.hi, deg, panels)
    assert out.cval.dtype == getattr(torch, dtype)
    g = gg.spec.grid
    M = jcheb._ls_fit_matrix((g.min[0], ref.hi, g.dx[0], g.nbins[0]), deg, panels)
    v = np.asarray(gg.grid.values, np.float64)
    eps = 0.0 if dtype == "float64" else float(np.finfo(np.float32).eps)
    cref = np.asarray(ref.cval, np.float64)
    atol = rel * np.abs(cref).max() + 2 * eps * (np.abs(M) @ np.abs(v))
    assert np.all(np.abs(out.cval.double().numpy() - cref) <= atol), "cval"
    pw = (ref.hi - ref.lo) / panels
    cder = np.stack([np.asarray(jcheb.derivative_coeffs(jnp.asarray(c), 0.0, pw))
                     for c in out.cval.numpy()])
    _assert_coeffs(out.cder, cder, rel, "cder")
    # derivative_coeffs and clenshaw_panels on the same coefficients
    c = np.array(ref.cval)
    for p in range(panels):
        _assert_coeffs(tcheb.derivative_coeffs(torch.as_tensor(c[p]), 0.0, pw),
                       jcheb.derivative_coeffs(jnp.asarray(c[p]), 0.0, pw), rel,
                       f"derivative_coeffs panel {p}")
    rng = np.random.default_rng(7)
    x = rng.uniform(ref.lo, ref.hi, 2000).astype(dtype)
    x[:3] = [ref.lo, ref.hi, 0.5 * (ref.lo + ref.hi)]
    for name in ("cval", "cder"):
        cc = np.array(getattr(ref, name))
        v = jcheb.clenshaw_panels(jnp.asarray(cc), jnp.asarray(x), ref.lo, ref.hi)
        tv = tcheb.clenshaw_panels(torch.as_tensor(cc), torch.as_tensor(x), ref.lo, ref.hi)
        _assert_coeffs(tv, v, 10 * rel, f"clenshaw_panels {name}")
    # value_deriv: zero outside [lo, hi]
    xr = np.concatenate([x, [ref.lo - 0.1, ref.hi + 0.1]]).astype(dtype)
    tab = tcheb.ChebTable(cval=torch.as_tensor(np.array(ref.cval)),
                          cder=torch.as_tensor(np.array(ref.cder)), lo=ref.lo, hi=ref.hi)
    for a, b in zip(tab.value_deriv(torch.as_tensor(xr)), ref.value_deriv(jnp.asarray(xr))):
        _assert_coeffs(a, b, 10 * rel, "value_deriv")


@pytest.mark.parametrize("panels,deg", TABLES)
def test_edges_and_edge_jump(panels, deg):
    """``ChebTable.edge_jump`` against the JAX package's ``clenshaw`` of
    dV/dr on both sides of each edge (0 outside [lo, hi]), and
    ``near_edge`` on distances beside an edge and between edges."""
    _, tgg = _bias_with_hills(jnp.float64)
    tab = tcheb.fit_gauss_grid(tgg, deg, panels)
    edges = tab.edges()
    assert len(edges) == panels + 1 and edges[0] == tab.lo
    assert abs(edges[-1] - tab.hi) < 1e-12
    cd = tab.cder.numpy()

    def side(q, x):  # panel q's series of dV/dr at x
        return float(jcheb.clenshaw(jnp.asarray(cd[q]), jnp.asarray(x), edges[q], edges[q + 1]))

    jumps = [abs(side(0, edges[0])), abs(side(panels - 1, edges[-1]))]
    jumps += [abs(side(q - 1, edges[q]) - side(q, edges[q])) for q in range(1, panels)]
    assert abs(tab.edge_jump() - max(jumps)) <= 1e-9 * max(jumps)
    mid = [0.5 * (a + b) for a, b in zip(edges[:-1], edges[1:])]
    assert not tab.near_edge(torch.tensor(mid, dtype=torch.float64))
    for e in edges:
        assert tab.near_edge(torch.tensor(mid + [e + 5e-6], dtype=torch.float64))


@pytest.mark.parametrize("deg", [16, 64])
def test_nodes_and_interpolation_matrix_match_jax(deg):
    """The float64 numpy helpers are copies: equal to the last bit."""
    np.testing.assert_array_equal(tcheb.chebyshev_nodes(deg, 0.0, 3.0),
                                  jcheb.chebyshev_nodes(deg, 0.0, 3.0))
    np.testing.assert_array_equal(tcheb.interpolation_matrix(deg),
                                  jcheb.interpolation_matrix(deg))
    # M @ f(nodes) recovers a polynomial of degree <= deg
    x = tcheb.chebyshev_nodes(deg, 0.0, 3.0)
    c = torch.as_tensor(tcheb.interpolation_matrix(deg) @ (x ** 3 - x))
    xs = torch.linspace(0.0, 3.0, 50, dtype=torch.float64)
    np.testing.assert_allclose(tcheb.clenshaw(c, xs, 0.0, 3.0).numpy(), (xs ** 3 - xs).numpy(),
                               atol=1e-12)


KCAP, OCAP = 24, 128
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
TLJ_ = TLJ(epsilon=1.0, sigma=0.3, rcut=0.75)
_CTX = {}


def _ctx():
    """The 600-atom clustered fluid of ``test_torch_cellforce.py`` (a real
    tail above kernel_cap) and its bias grid carrying hills."""
    if _CTX:
        return _CTX
    n = 600
    gg, _ = _bias_with_hills(jnp.float32)
    _, bs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=jnp.float32)
    rng = np.random.default_rng(5)
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=n, replace=False, p=w / w.sum())
    pts = (gridpts[sel] + rng.uniform(-0.04, 0.04, (n, 3))).astype(np.float32)
    core = jpe.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=n * 40)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=n, cap=56)
    st = init_cell_state(spec, core, with_ids=False, kernel_cap=KCAP, overflow_cap=OCAP)
    _CTX.update(spec=spec, st=st, tst=to_port(st), gg=gg)
    return _CTX


def _f64(tab):
    return dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())


def _tables(panels, deg):
    """The same Chebyshev coefficients for both packages."""
    ref = jcheb.fit_gauss_grid(_ctx()["gg"], deg, panels)
    out = tcheb.ChebTable(cval=torch.as_tensor(np.array(ref.cval)),
                          cder=torch.as_tensor(np.array(ref.cder)), lo=ref.lo, hi=ref.hi)
    return ref, out


@pytest.mark.parametrize("panels,deg,k,energy", [
    (4, 16, 24, False), (4, 16, 24, True), (4, 16, 32, True), (1, 64, 24, False),
    (1, 64, 24, True)])
def test_cell_force_newton_cheb_vs_pallas(panels, deg, k, energy):
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    ref_tab, tab = _tables(panels, deg)
    Cg = st.xs.shape[0]
    xs_k, mc_k = st.xs[:, :k], st.mc[:, :k]
    xc_f, xn_f = _planar_coord_views(xs_k, spec.ncells, k, Cg)
    mn_f = _half_concat(mc_k, spec.ncells, k, Cg)
    fx, fy, fz, eb = CP.cell_forces_pallas_newton_rescredit(
        xc_f, xn_f, mc_k, mn_f, ref_tab, cap=k, ncells=spec.ncells, box=spec.box,
        lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut, energy=energy,
    )
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=TLJ_, energy=energy)
    f, teb = CF.cell_force_newton(tst.xs, tst.mc, tab, **kw)
    f64, eb64 = CF.cell_force_newton_ref(tst.xs.double(), tst.mc.double(), _f64(tab), **kw)
    err, tol = near_jax(f[:, :k], np.stack([fx, fy, fz], -1), f64[:, :k], FORCE_REL)
    assert err <= tol, f"K1 cheb P={panels} k={k}: {err} > {tol}"
    assert not bool(f[:, k:].any())
    err, tol = near_jax(teb.sum(), np.asarray(eb).sum(), eb64.sum(), ENERGY_RTOL)
    assert err <= tol, f"K1 cheb P={panels} energy: {err} > {tol}"
    if energy:
        assert float(np.abs(np.asarray(eb)).sum()) > 0


@pytest.mark.parametrize("panels,deg", TABLES)
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_cheb_vs_pallas(panels, deg, energy):
    c = _ctx()
    spec, st = c["spec"], c["st"]
    ref_tab, tab = _tables(panels, deg)
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
        jnp.asarray(np.pad(xp, ((0, 0), (0, N_pad - N)))), ref_tab, box=spec.box,
        lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut, energy=energy,
    )
    kw = dict(box=spec.box, lj=TLJ_, energy=energy)
    xo, xp = torch.as_tensor(xo), torch.as_tensor(xp)
    tfo, tfp = CF.overflow_force(xo, xp, tab, **kw)
    fo64, fp64 = CF.overflow_force_ref(xo.double(), xp.double(), _f64(tab), **kw)
    fo, fp = np.asarray(fo), np.asarray(fp)
    for what, a, b, e, rel in (("fo", tfo[:3], fo[:3], fo64[:3], FORCE_REL),
                               ("fp", tfp, fp[:3, :N], fp64, FORCE_REL),
                               ("energy", tfo[3].sum(), fo[3].sum(), fo64[3].sum(), ENERGY_RTOL)):
        err, tol = near_jax(a, b, e, rel)
        assert err <= tol, f"K2 cheb P={panels} {what}: {err} > {tol}"


N, DRIFT = 600, 5.0
BENCH_CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
             "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
             "bias_sigma 0.1\n")
PHASES = [dict(static_do_hills=True, static_do_energy=True, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=True)]


def _phase(i):
    return 0 if i % 10 == 0 else 2 if i % 10 == 9 else 1


def test_cheb_slice_matches_jax_step_for_step():
    """``test_torch_slice.py``'s run (full-cap fallback period, then a K2
    period) with the bench's Chebyshev table: 4 panels of degree 16."""
    cfg = parse_edm_text(BENCH_CFG)
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = Grid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=jnp.float32, target=target)
    rng = np.random.default_rng(5)
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=N, replace=False, p=w / w.sum())
    pts = (gridpts[sel] + rng.uniform(-0.04, 0.04, (N, 3))).astype(np.float32)
    core = jpe.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=N * 300,
                          pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4)
    core = dataclasses.replace(core, v=jnp.zeros_like(core.x).at[:, 1].set(DRIFT))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    st = init_cell_state(spec, core, with_ids=False, kernel_cap=KCAP, overflow_cap=48)

    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_capacity=512, energy_stride=10, kernel_cap=KCAP, overflow_cap=48)
    jsteps = [jax.jit(make_cell_step(params, lp, LJ, spec, hill_stride=10, rebuild_stride=10,
                                     use_pallas=True, **kw, **ph)) for ph in PHASES]
    tsteps = [tpc.make_cell_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), TLJ_,
                                 tcells.CellSpec(**dataclasses.asdict(spec)), 10,
                                 use_pallas=True, **kw, **ph)
              for ph in PHASES]
    ts = to_port(st, device="cpu")
    assert ts.core.cheb is not None and ts.core.cheb.npanels == 4 and ts.core.cheb.deg == 16
    periods = []
    for i in range(20):
        tab = ts.core.cheb  # the table this step's force pass reads
        st, e = jsteps[_phase(i)](st, None)
        ts, te = tsteps[_phase(i)](ts)
        for f in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow"):
            assert_exact(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        for f in ("step", "last_calls", "hills_truncated"):
            assert_exact(getattr(ts.core, f), getattr(st.core, f), f"step {i} core.{f}")
        for f in ("xs", "vs"):
            assert_forces(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        assert_forces_at_edges(ts.fs, st.fs, st.xs, st.mc, spec.box, tab, f"step {i} fs")
        assert_energy(te, e, f"step {i} energy")
        np.testing.assert_allclose(np_(ts.core.bias.cum_bias), np.asarray(st.core.bias.cum_bias),
                                   rtol=1e-6)
        grid = np.asarray(st.core.bias.bias.grid.values)
        np.testing.assert_allclose(np_(ts.core.bias.bias.grid.values), grid, rtol=1e-5,
                                   atol=1e-5 * max(1.0, np.abs(grid).max()))
        for name in ("cval", "cder"):  # the refit table rides along
            _assert_coeffs(getattr(ts.core.cheb, name), getattr(st.core.cheb, name), 1e-5,
                           f"step {i} cheb.{name}")
        periods.append(bool(st.tail_ovf))
    assert periods[:9] == [True] * 9 and periods[9:19] == [False] * 10
    assert float(st.core.bias.cum_bias) > 0 and not bool(st.core.hills_truncated)
    assert tsteps[1].host_syncs == 0
