"""PyTorch port: the spatial host and its ``boundary_offset`` machinery
against the JAX package.

  - unit cases in float64 at 1e-12 (indices and masks exactly):
    ``GaussGrid.get_value_deriv`` with an offset; ``hill_windows`` and
    ``dense_tables_1d`` on a non-periodic local grid whose global boundary
    lies inside, at the edge of, and outside it; the McGDP table index
    ``_bc_index`` on lattices whose quotients fall next to integers (float64
    against JAX eager and jitted; float32 against JAX eager, each operation
    rounded once); ``_duplicate_boundary_dynamic`` in 1-D and 2-D, on a
    rank with the boundary in range and one without;
  - the 12 cases of ``tests/test_spatial.py`` that are not ``slow``, on 8
    gloo ranks (``tests/_torch_spatial_ranks.py``, one launch for the
    module, its ranks running every case) against JAX's host on conftest's
    8 CPU devices: each rank's state against JAX's row of it in float64 at
    1e-12 (the key, counters, flags, masks and histogram counts exactly),
    the stitched grids at 1e-12, the written files number by number; an
    external force against JAX's, with the static phases bitwise the
    dynamic step; and ``convert.spatial_state_from_numpy`` and
    ``spatial_subdivide``'s geometry against JAX's.
"""

import dataclasses
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_spatial_ranks as sranks
from _torch_parity import assert_exact, assert_f64, assert_tree, to_numpy_tree
from edm_tpu.gauss import GaussGrid as JGauss
from edm_tpu.grid import Grid as JGrid
from edm_tpu.grid import GridSpec as JSpec
from edm_tpu.models.langevin import LangevinParams as JLP
from edm_tpu.ops import deposit as jdep
from edm_tpu.parallel import make_mesh
from edm_tpu.parallel import spatial as JS
from edm_tpu.utils.config import parse_edm_text
from edm_tpu.utils.hills_log import HillsLog as JHillsLog
from edm_tpu_torch import parallel as tpar
from edm_tpu_torch.gauss import GaussGrid as TGauss
from edm_tpu_torch.ops import deposit as tdep

EDM = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 100\ndimension 1\n"
       "box_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\n")
EDM2D = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 100\ndimension 2\n"
         "box_low 0 0\nbox_high 10 10\nbias_spacing 0.05 0.05\nbias_sigma 0.2 0.2\n")
EDM_WT = ("tempering 1\nbias_factor 10\nglobal_tempering -1\nhill_prefactor 1.0\n"
          "bias_per_step 100\ndimension 1\nbox_low 0\nbox_high 10\nbias_spacing 0.01\n"
          "bias_sigma 0.2\n")
N_DEV = 8
SKIN = 1.25


# ------------------------------------------------------------ unit cases


def _local_grids(D, dtype=jnp.float64):
    """A rank's local grid of a sharded non-periodic box [0, 10]^D: dim 0
    is [-1.25, 2.5] (brick 1.25 wide plus the skin), the rest whole; both
    packages, boundary the global box."""
    mn = [-1.25] + [0.0] * (D - 1)
    mx = [2.5] + [10.0] * (D - 1)
    dx = [0.01] if D == 1 else [0.05] * D
    args = (mn, mx, dx, [False] * D, [0.2] * D)
    jg = JGauss.create(*args, dtype=dtype).set_boundary([0.0] * D, [10.0] * D, [False] * D)
    tg = TGauss.create(*args, dtype=torch.float64, device="cpu").set_boundary(
        [0.0] * D, [10.0] * D, [False] * D)
    return jg, tg


# the global low boundary inside the local grid, at its low edge, and
# outside it (a mid-box rank)
OFFSETS = {"inside": 0.0, "edge": 1.25, "outside": 3.75}


def test_gauss_value_deriv_with_offset():
    rng = np.random.default_rng(11)
    for D in (1, 2):
        jg, tg = _local_grids(D)
        vals = rng.normal(size=tg.grid.values.shape)
        ders = rng.normal(size=tg.grid.derivs.shape)
        jg = dataclasses.replace(jg, grid=dataclasses.replace(
            jg.grid, values=jnp.asarray(vals), derivs=jnp.asarray(ders)))
        tg = dataclasses.replace(tg, grid=dataclasses.replace(
            tg.grid, values=torch.as_tensor(vals), derivs=torch.as_tensor(ders)))
        x = rng.uniform(-2.0, 3.0, (300, D))
        for off in (0.0, 1.25, -1.0, 8.75):
            o = np.zeros(D)
            o[0] = off
            jv, jd = jg.get_value_deriv(jnp.asarray(x), boundary_offset=jnp.asarray(o))
            tv, td = tg.get_value_deriv(torch.as_tensor(x), boundary_offset=torch.as_tensor(o))
            assert_f64(tv, jv, f"value D={D} offset {off}")
            assert_f64(td, jd, f"derivative D={D} offset {off}")
            assert_exact(tg.in_bounds(torch.as_tensor(x), torch.as_tensor(o)),
                         jg.in_bounds(jnp.asarray(x), jnp.asarray(o)))
            assert float(np.abs(np.asarray(jv)).max()) > 0


@pytest.mark.parametrize("where", list(OFFSETS))
def test_hill_windows_and_dense_tables_with_offset(where):
    rng = np.random.default_rng(5)
    for D in (1, 2):
        jg, tg = _local_grids(D)
        o = np.zeros(D)
        o[0] = OFFSETS[where]
        c = rng.uniform(-1.2, 2.4, (13, D))
        jw = jdep.hill_windows(jg, jnp.asarray(c), boundary_offset=jnp.asarray(o))
        tw = tdep.hill_windows(tg, torch.as_tensor(c), boundary_offset=torch.as_tensor(o))
        assert_exact(tw.idx, jw.idx, f"{where} D={D} idx")
        assert_exact(tw.valid, jw.valid, f"{where} D={D} valid")
        assert_f64(tw.value_w, jw.value_w, f"{where} D={D} value_w")
        assert_f64(tw.deriv_w, jw.deriv_w, f"{where} D={D} deriv_w")
        assert bool(np.asarray(jw.valid).any())
        h = rng.uniform(0.1, 1.0, len(c))
        jo, jb = jdep.deposit_precomputed(jg, jw, jnp.asarray(h), boundary_offset=jnp.asarray(o))
        to, tb = tdep.deposit_precomputed(tg, tw, torch.as_tensor(h),
                                          boundary_offset=torch.as_tensor(o))
        assert_f64(to.grid.values, jo.grid.values, f"{where} D={D} deposit")
        assert_f64(to.grid.derivs, jo.grid.derivs, f"{where} D={D} deposit derivs")
        assert_f64(tb, jb, f"{where} D={D} bias_added")
        if D == 1:
            jt = jdep.dense_tables_1d(jg, jnp.asarray(c), boundary_offset=jnp.asarray(o))
            tt = tdep.dense_tables_1d(tg, torch.as_tensor(c), boundary_offset=torch.as_tensor(o))
            for name, a, b in zip(("Mval", "Mder", "s"), tt, jt):
                assert_f64(a, b, f"{where} dense {name}")
            jo = jdep.deposit_from_tables(jg, jt[0], jt[1], jnp.asarray(h),
                                          boundary_offset=jnp.asarray(o))
            to = tdep.deposit_from_tables(tg, tt[0], tt[1], torch.as_tensor(h),
                                          boundary_offset=torch.as_tensor(o))
            assert_f64(to.grid.values, jo.grid.values, f"{where} dense deposit")


# lattices whose table quotients sit next to integers: spacing 0.0197 on
# [0, 3] (every 9th point), and the spatial tests' local grids
BC_LATTICES = [(0.0, 0.0197, 153, 0.0, 3.0), (-1.25, 0.01, 376, 0.0, 10.0),
               (-0.5, 0.05, 200, 0.0, 10.0)]
BC_OFFSETS = (0.0, 1.25, 2.5, 3.75, 8.75, 0.0197 * 37)


def test_bc_index_arrays_match_jax():
    for jdt, tdt in ((jnp.float64, torch.float64), (jnp.float32, torch.float32)):
        for gmin, dx, n, bmin, bmax in BC_LATTICES:
            jit = jax.jit(lambda i, o: jdep._bc_index(
                jnp.asarray(gmin, jdt) + jnp.asarray(dx, jdt) * i + o, bmin, bmax - bmin))
            for off in BC_OFFSETS:
                xxd = (jnp.asarray(gmin, jdt) + jnp.asarray(dx, jdt) * jnp.arange(n, dtype=jdt)
                       + jnp.asarray(off, jdt))
                port = tdep._bc_index(torch.as_tensor(np.array(xxd)), bmin, bmax - bmin)
                what = f"{jdt.__name__} lattice {gmin}+{dx}i offset {off}"
                assert port.dtype == torch.int64
                assert_exact(port, jdep._bc_index(xxd, bmin, bmax - bmin), what + " eager")
                if jdt == jnp.float64:  # XLA fuses the float32 chain (ROADMAP Queue 3)
                    assert_exact(port, jit(jnp.arange(n, dtype=jdt), jnp.asarray(off, jdt)),
                                 what + " jit")


@pytest.mark.parametrize("D", [1, 2])
def test_duplicate_boundary_dynamic_matches_jax(D):
    """A local grid [-1, 11] (dim 0) against the boundary [0, 10]: a copy
    runs only where both of a dim's boundary rows lie in the grid (offsets
    0, 0.73, -0.5 and 1.0, the last with the low row at the grid's edge);
    at 1.5 and 30 the grid keeps its values."""
    mn, mx = [-1.0] + [0.0] * (D - 1), [11.0] + [10.0] * (D - 1)
    args = (mn, mx, [0.05] * D, [False] * D, [0.2] * D)
    jg = JGauss.create(*args, dtype=jnp.float64).set_boundary([0.0] * D, [10.0] * D, [False] * D)
    tg = TGauss.create(*args, dtype=torch.float64, device="cpu").set_boundary(
        [0.0] * D, [10.0] * D, [False] * D)
    vals = np.random.default_rng(3).normal(size=tg.grid.values.shape)
    jg = dataclasses.replace(jg, grid=dataclasses.replace(jg.grid, values=jnp.asarray(vals)))
    tg = dataclasses.replace(tg, grid=dataclasses.replace(tg.grid, values=torch.as_tensor(vals)))
    for off in (0.0, 0.73, -0.5, 1.0, 1.5, 30.0):
        o = np.zeros(D)
        o[0] = off
        j = jdep.duplicate_boundary(jg, jnp.asarray(o))
        t = tdep.duplicate_boundary(tg, torch.as_tensor(o))
        assert_exact(t.grid.values, j.grid.values, f"D={D} offset {off}")
        changed = not np.array_equal(np.asarray(j.grid.values), vals)
        assert changed == (off < 1.5), (D, off)


# ------------------------------------------------- the host on 8 ranks


def _slab_atoms():
    xs = []
    for d in range(N_DEV):
        xs.append([d * 1.25 + 0.3, 0.0, 0.0])
        xs.append([d * 1.25 + 1.2, 0.0, 0.0])
    return np.asarray(xs)


def _brick_atoms(parts=(2, 4), widths=(5.0, 2.5)):
    xs = []
    for i in range(parts[0]):
        for j in range(parts[1]):
            lo = (i * widths[0], j * widths[1])
            xs.append([lo[0] + 0.4, lo[1] + 0.3, 0.0])
            xs.append([lo[0] + widths[0] - 0.3, lo[1] + widths[1] - 0.2, 0.0])
    return np.asarray(xs)


def _target_values():
    xs = np.arange(200) * 0.05
    return 0.8 * np.cos(2 * np.pi * xs / 10.0) + 1.0


def _initial_grid():
    g0 = JGauss.create([0.0], [10.0], [0.01], [True], [0.2], dtype=jnp.float64)
    g0, _ = g0.add_value(jnp.asarray([[2.0], [5.5], [9.9]], jnp.float64),
                         jnp.asarray([0.4, 0.2, 0.3], jnp.float64))
    return g0.grid


def _nonperiodic_atoms():
    x0 = _slab_atoms()
    x0[0, 0], x0[-1, 0] = 0.15, 9.9
    return x0


def _port_cases(out_dir):
    init = _initial_grid()
    return [
        ("targeting", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN, tvals=_target_values(),
                           n_rounds=2)),
        ("initial_bias", dict(cfg=EDM_WT, x0=_slab_atoms(), skin=SKIN,
                              ivals=np.asarray(init.values), iders=np.asarray(init.derivs))),
        ("nonperiodic", dict(cfg=EDM, x0=_nonperiodic_atoms(), skin=SKIN, n_rounds=2)),
        ("density", dict(cfg=EDM, skin=SKIN)),
        ("compacted", dict(cfg=EDM + "hill_density 8\n", x0=_slab_atoms(), skin=SKIN)),
        ("wraparound", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN)),
        ("rebin", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN)),
        ("hills_logging", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN, out_dir=out_dir)),
        ("write_roundtrip", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN, out_dir=out_dir)),
        ("brick_rebin", dict(cfg=EDM2D, x0=_brick_atoms(), skin=SKIN)),
        ("brick_write", dict(case="write_roundtrip", cfg=EDM2D, x0=_brick_atoms(), skin=SKIN,
                             out_dir=out_dir, dim=2, parts=(2, 4))),
        ("overlap", dict(cfg=EDM, x0=_slab_atoms(), skin=SKIN)),
        ("external", dict(cfg=EDM + "hill_density 8\n", x0=_slab_atoms(), skin=SKIN)),
    ]


def _jax_host(cfg, x0, seed=0, lp=None, parts=N_DEV, setup_kw=(), hill_stride=1, **step_kw):
    setup, tmpl = JS.spatial_subdivide(parse_edm_text(cfg), 1.0, 1.0, parts, SKIN,
                                       dtype=jnp.float64, **dict(setup_kw))
    mesh = make_mesh(N_DEV)
    state = JS.init_spatial_state(setup, tmpl, x0, jax.random.PRNGKey(seed), capacity=4,
                                  mesh=mesh)
    lp = lp or JLP(dt=1e-8, friction=0.0, kT=0.0)
    return setup, mesh, state, JS.make_spatial_coord_step(setup, lp, hill_stride=hill_stride,
                                                          mesh=mesh, **step_kw)


def _jax_steps(step, state, n):
    for _ in range(n):
        state, e = step(state)
    return state, e


def _jax_cases(tmp):
    """JAX's side of each case, as numpy trees."""
    out = {}
    tspec = JSpec.create([0.0], [10.0], [0.05], [True])
    target = JGrid(values=jnp.asarray(_target_values()), derivs=None, spec=tspec,
                   interpolate=False)
    setup, _, st, step = _jax_host(EDM, _slab_atoms(), setup_kw=dict(target=target))
    st, e = _jax_steps(step, st, 2)
    out["targeting"] = dict(state=to_numpy_tree(st), energy=float(e),
                            grid=JS.gather_spatial_grid(setup, st))

    setup, _, st, step = _jax_host(EDM_WT, _slab_atoms(),
                                   setup_kw=dict(initial_bias=_initial_grid()))
    init, grid0 = to_numpy_tree(st), JS.gather_spatial_grid(setup, st)
    st, _ = step(st)
    out["initial_bias"] = dict(state=to_numpy_tree(st), init=init, grid0=grid0,
                               grid=JS.gather_spatial_grid(setup, st))

    setup, _, st, step = _jax_host(EDM, _nonperiodic_atoms(), setup_kw=dict(periodic=[False]))
    st, e = _jax_steps(step, st, 2)
    g = JS.stitch_spatial_grid(setup, st)
    out["nonperiodic"] = dict(state=to_numpy_tree(st), energy=float(e),
                              grid=(np.asarray(g.values), np.asarray(g.derivs)))

    out["density"] = {}
    for extra in ("hill_density 2\n", "hill_density 80\n"):
        s, _ = JS.spatial_subdivide(parse_edm_text(EDM + extra), 1.0, 1.0, N_DEV, SKIN,
                                    dtype=jnp.float64)
        out["density"][extra] = (s.params.cfg.hill_density, s.params.cfg.hill_prefactor)

    out["compacted"] = {}
    for cap in (16, 0):
        _, _, st, step = _jax_host(EDM + "hill_density 8\n", _slab_atoms(), seed=3,
                                   hill_capacity=cap)
        out["compacted"][cap] = to_numpy_tree(_jax_steps(step, st, 4)[0])

    _, _, st, step = _jax_host(EDM, _slab_atoms())
    out["wraparound"] = dict(state=to_numpy_tree(step(st)[0]))

    setup, mesh, st, step = _jax_host(EDM, _slab_atoms())
    xs = np.asarray(st.x).copy()
    xs[0, 0, 0] = 4.0
    st = JS.rebin_spatial_atoms(setup, dataclasses.replace(st, x=jnp.asarray(xs)), mesh)
    rebinned = to_numpy_tree(st)
    st, e = step(st)
    out["rebin"] = dict(state=to_numpy_tree(st), rebinned=rebinned, energy=float(e))

    setup, _, st, step = _jax_host(EDM, _slab_atoms(), collect_records=True)
    files = [JHillsLog(str(tmp / f"HILLS_{d}"), 1, setup.params.total_volume)
             for d in range(N_DEV)]
    cum, totals = 0.0, []
    for r in range(2):
        st, _, logs = step(st)
        added = JS.log_spatial_round(files, logs, r, cum)
        totals.append(added)
        cum += added
    for hl in files:
        hl.close()
    out["hills_logging"] = dict(state=to_numpy_tree(st), totals=totals,
                                texts=[(tmp / f"HILLS_{d}").read_text() for d in range(N_DEV)])

    for name, cfg, x0, parts in (("write_roundtrip", EDM, _slab_atoms(), N_DEV),
                                 ("brick_write", EDM2D, _brick_atoms(), (2, 4))):
        setup, _, st, step = _jax_host(cfg, x0, parts=parts)
        st, _ = step(st)
        g = JS.write_spatial_grid(setup, st, str(tmp / name))
        out[name] = dict(state=to_numpy_tree(st), text=(tmp / name).read_text(),
                         written=np.asarray(g.values))

    setup, mesh, st, _ = _jax_host(EDM2D, _brick_atoms(), parts=(2, 4))
    init = to_numpy_tree(st)
    xs = np.array(np.asarray(st.x))
    xs[0, 0] = [0.4, 2.6, 0.0]
    xs[0, 1] = [-0.2, 0.3, 0.0]
    st = JS.rebin_spatial_atoms(setup, dataclasses.replace(st, x=jnp.asarray(xs)), mesh)
    out["brick_rebin"] = dict(state=to_numpy_tree(st), init=init)

    out["overlap"] = {}
    for name, cap, n in (("filt", 16, 3), ("full", 0, 3), ("tiny", 2, 1)):
        _, _, st, step = _jax_host(EDM, _slab_atoms(), lp=JLP(dt=1e-8, friction=0.0, kT=0.5),
                                   overlap_capacity=cap)
        out["overlap"][name] = to_numpy_tree(_jax_steps(step, st, n)[0])

    def harmonic(x):
        d = x - jnp.asarray([5.0, 0.0, 0.0], x.dtype)
        return 0.15 * jnp.sum(d * d, axis=-1), -0.3 * d

    _, _, st, step = _jax_host(EDM + "hill_density 8\n", _slab_atoms(),
                               lp=JLP(dt=1e-3, friction=0.0, kT=0.0), hill_stride=2,
                               external_force=harmonic)
    energies = []
    for _ in range(4):
        st, e = step(st)
        energies.append(float(e))
    out["external"] = dict(state=to_numpy_tree(st), energies=energies)
    return out


def _row(tree, r):
    """Row ``r`` of every array of a JAX state tree (its device axis)."""
    if isinstance(tree, dict):
        return {k: _row(v, r) for k, v in tree.items()}
    return np.asarray(tree[r]) if isinstance(tree, np.ndarray) else tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both sides of every case: (port results by rank, JAX results)."""
    tmp = tmp_path_factory.mktemp("spatial")
    port_dir = tmp / "port"
    port_dir.mkdir()
    path = tmp / "cases.pkl"
    with open(path, "wb") as fh:
        pickle.dump({"cases": _port_cases(str(port_dir))}, fh)
    res, errs = {}, []

    def run():
        try:
            res["port"] = tpar.launch(sranks.spatial_cases, N_DEV, str(path), backend="gloo",
                                      device="cpu", init_file=str(tmp / "store"), timeout=300)
        except Exception as e:  # raised again below, in the test's thread
            errs.append(e)

    th = threading.Thread(target=run)
    th.start()
    jres = _jax_cases(tmp)
    th.join()
    if errs:
        raise errs[0]
    return res["port"], jres


def _rows_match(port, ref, what):
    """Each rank's state against JAX's row of it: float64 at 1e-12, the
    rest exactly."""
    for r in range(N_DEV):
        assert_tree(port[r], _row(ref, r), 1e-12, f"{what} rank {r}")


def _same_grid(port, ref, what):
    for a, b in zip(port, ref):
        assert_f64(a, b, what)


def _same_text(got, want, what):
    """Two files line for line: the same tokens, numbers within 2e-8 (an
    8-decimal rounding, or the sign of a zero, may move by one step)."""
    g, w = got.splitlines(), want.splitlines()
    assert len(g) == len(w), what
    for a, b in zip(g, w):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (what, a, b)
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (what, a, b)
                continue
            assert abs(fx - fy) <= 2e-8, (what, a, b)


def test_spatial_targeting_matches_jax(runs):
    port, ref = runs
    j = ref["targeting"]
    _rows_match([p["targeting"]["state"] for p in port], j["state"], "targeting")
    for p in port:
        assert p["targeting"]["energy"] == pytest.approx(j["energy"], rel=1e-12, abs=1e-12)
        _same_grid(p["targeting"]["grid"], j["grid"], "targeting stitched grid")
    assert np.ptp(j["grid"][1]) > 1e-3


def test_spatial_initial_bias_matches_jax(runs):
    port, ref = runs
    j = ref["initial_bias"]
    _rows_match([p["initial_bias"]["init"] for p in port], j["init"], "initial state")
    _rows_match([p["initial_bias"]["state"] for p in port], j["state"], "after a round")
    _same_grid(port[0]["initial_bias"]["grid0"], j["grid0"], "initial stitched grid")
    _same_grid(port[0]["initial_bias"]["grid"], j["grid"], "stitched grid")


def test_spatial_nonperiodic_boundary_matches_jax(runs):
    port, ref = runs
    j = ref["nonperiodic"]
    _rows_match([p["nonperiodic"]["state"] for p in port], j["state"], "non-periodic")
    for p in port:
        assert p["nonperiodic"]["nonperiodic0"]
        _same_grid(p["nonperiodic"]["grid"], j["grid"], "non-periodic stitched grid")
    assert j["grid"][0].shape == (1001,)


def test_spatial_hill_density_normalization(runs):
    port, ref = runs
    for p in port:
        assert p["density"] == ref["density"]
    assert ref["density"]["hill_density 2\n"][0] == 2.0 / N_DEV


def test_spatial_compacted_exchange_matches_jax(runs):
    port, ref = runs
    for cap in (16, 0):
        _rows_match([p["compacted"][cap] for p in port], ref["compacted"][cap],
                    f"hill_capacity {cap}")
    for p in port:  # the compacted round replays the full exchange's hills
        np.testing.assert_allclose(p["compacted"][16]["bias"]["bias"]["grid"]["values"],
                                   p["compacted"][0]["bias"]["bias"]["grid"]["values"],
                                   rtol=1e-12, atol=1e-12)
        assert not p["compacted"][16]["hills_truncated"]
    assert float(ref["compacted"][16]["bias"]["cum_bias"][0]) > 0


def test_spatial_wraparound_delivery(runs):
    port, ref = runs
    _rows_match([p["wraparound"]["state"] for p in port], ref["wraparound"]["state"],
                "wraparound")
    spec = ref["wraparound"]["state"]["bias"]["bias"]["spec"]["grid"]
    xs_local = spec["min"][0] + spec["dx"][0] * np.arange(spec["nbins"][0])
    vals0 = port[0]["wraparound"]["state"]["bias"]["bias"]["grid"]["values"]
    vals7 = port[7]["wraparound"]["state"]["bias"]["bias"]["grid"]["values"]
    assert vals0[xs_local < -0.5].max() > 1e-4 and vals7[xs_local > 1.25 + 0.5].max() > 1e-4


def test_spatial_rebin(runs):
    port, ref = runs
    j = ref["rebin"]
    _rows_match([p["rebin"]["rebinned"] for p in port], j["rebinned"], "rebinned")
    _rows_match([p["rebin"]["state"] for p in port], j["state"], "a step after the rebin")
    assert port[0]["rebin"]["rebinned"]["valid"].sum() == 1
    assert port[3]["rebin"]["rebinned"]["valid"].sum() == 3


def test_spatial_per_replica_hills_logging(runs):
    port, ref = runs
    j = ref["hills_logging"]
    _rows_match([p["hills_logging"]["state"] for p in port], j["state"], "logged run")
    for p in port:
        np.testing.assert_allclose(p["hills_logging"]["totals"], j["totals"], rtol=1e-12)
    texts = port[0]["hills_logging"]["texts"]
    assert all(p["hills_logging"]["texts"] is None for p in port[1:])
    for d in range(N_DEV):
        assert texts[d].strip()
        _same_text(texts[d], j["texts"][d], f"HILLS_{d}")


def test_write_spatial_grid_roundtrip(runs):
    port, ref = runs
    p, j = port[0]["write_roundtrip"], ref["write_roundtrip"]
    _same_text(p["text"], j["text"], "GBIAS")
    assert_f64(p["written"], j["written"], "written grid")
    np.testing.assert_allclose(p["back"][0], p["written"], atol=1e-8)
    assert p["back"][1] == (1000,)
    assert all(q["write_roundtrip"]["text"] is None for q in port[1:])


def test_spatial_brick_rebin_and_binning(runs):
    port, ref = runs
    j = ref["brick_rebin"]
    _rows_match([p["brick_rebin"]["init"] for p in port], j["init"], "brick init")
    _rows_match([p["brick_rebin"]["state"] for p in port], j["state"], "brick rebin")
    valid = [p["brick_rebin"]["state"]["valid"] for p in port]
    assert valid[0].sum() == 0 and valid[1].sum() == 3 and valid[4].sum() == 3
    parked = port[0]["brick_rebin"]["state"]["x"][~valid[0]]
    assert np.allclose(parked[:, 0], 2.5) and np.allclose(parked[:, 1], 1.25)


def test_spatial_brick_write_roundtrip(runs):
    port, ref = runs
    p, j = port[0]["brick_write"], ref["brick_write"]
    _rows_match([q["brick_write"]["state"] for q in port], j["state"], "brick write")
    _same_text(p["text"], j["text"], "GBIAS2D")
    np.testing.assert_allclose(p["back"][0], p["written"], atol=1e-8)
    np.testing.assert_array_equal(p["stitched"], p["written"])
    assert p["back"][1] == (200, 200)


def test_spatial_overlap_filter_matches_jax(runs):
    port, ref = runs
    for name in ("filt", "full", "tiny"):
        _rows_match([p["overlap"][name] for p in port], ref["overlap"][name],
                    f"overlap {name}")
    for p in port:
        np.testing.assert_allclose(p["overlap"]["filt"]["bias"]["bias"]["grid"]["values"],
                                   p["overlap"]["full"]["bias"]["bias"]["grid"]["values"],
                                   rtol=1e-14, atol=1e-13)
        assert not p["overlap"]["filt"]["hills_truncated"]
    assert any(p["overlap"]["tiny"]["hills_truncated"] for p in port)


def test_spatial_state_from_numpy_and_setup(runs):
    """``convert.spatial_state_from_numpy`` takes JAX's row r as rank r's
    state, exactly; both packages' ``spatial_subdivide`` of one config
    give the same geometry and parameters."""
    from edm_tpu_torch.convert import spatial_state_from_numpy
    from edm_tpu_torch.parallel import spatial as TS

    port, ref = runs
    tree = ref["wraparound"]["state"]
    for r in range(N_DEV):
        st = spatial_state_from_numpy(tree, r, "cpu")
        assert st.x.dtype == torch.float64 and st.valid.dtype == torch.bool
        assert st.key.dtype == np.uint32
        assert_tree(st, _row(tree, r), 0.0, f"row {r}")
        assert_tree(st, port[r]["wraparound"]["state"], 1e-12, f"rank {r}")
    for cfg, parts, per in ((EDM, N_DEV, [True]), (EDM, N_DEV, [False]),
                            (EDM2D, (2, 4), [True, False])):
        js, jt = JS.spatial_subdivide(parse_edm_text(cfg), 1.0, 1.0, parts, SKIN,
                                      dtype=jnp.float64, periodic=per)
        ts, tt = TS.spatial_subdivide(parse_edm_text(cfg), 1.0, 1.0, parts, SKIN,
                                      dtype=torch.float64, periodic=per, device="cpu")
        for name in ("n_dev", "slab_w", "skin", "box_low0", "nonperiodic0", "parts", "widths",
                     "lows", "nonper", "skins"):
            assert getattr(ts, name) == getattr(js, name), (cfg, parts, name)
        assert TS._brick_geometry(ts) == JS._brick_geometry(js)
        assert ts.params.cfg == js.params.cfg
        assert ts.params.total_volume == js.params.total_volume
        assert to_numpy_tree(tt.bias.spec) == to_numpy_tree(jt.bias.spec)
        assert_tree(tt, jt, 0.0, f"template {cfg[:20]} {parts}")


def test_spatial_external_force_and_static_phases(runs):
    """An external force (a harmonic well) with hill_stride 2 against
    JAX's dynamic step, float64 at 1e-12; the static hill and plain steps
    through ``strided_segment`` bitwise the dynamic step, which counts one
    host read a step."""
    port, ref = runs
    j = ref["external"]
    _rows_match([p["external"]["state"] for p in port], j["state"], "external force")
    for p in port:
        np.testing.assert_allclose(p["external"]["energies"], j["energies"], rtol=1e-12)
        assert_tree(p["external"]["static"], p["external"]["state"], 0.0, "static phases")
        assert p["external"]["host_syncs"][0] == 4 + p["external"]["host_syncs"][1]
        assert p["external"]["host_syncs"][2] == 0
    assert float(ref["external"]["state"]["bias"]["cum_bias"][0]) > 0
    assert np.abs(np.diff(j["energies"])).max() > 0
