"""PyTorch port: the 1-D bias engine against the JAX package, in float64.

Grid lookups, Gaussian-grid geometry, dense 1-D deposition (McGovern–De
Pablo boundary terms included), the prefix-sum cap and full hill rounds
(drain, targeting, tempering, histogram) go through both packages from the
same numpy inputs; floats agree to 1e-12 relative, integers and flags
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, assert_f64, to_numpy_tree, to_port
from edm_tpu import bias as JB
from edm_tpu import gauss as jg
from edm_tpu import grid as jgrid
from edm_tpu.ops import deposit as jdep
from edm_tpu.ops import prefix_cap as jcap
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch import bias as TB
from edm_tpu_torch import gauss as tg
from edm_tpu_torch import grid as tgrid
from edm_tpu_torch.ops import deposit as tdep
from edm_tpu_torch.ops import prefix_cap as tcap
from edm_tpu_torch.utils.config import parse_edm_text as t_parse

F64 = torch.float64


def _t(a):
    return torch.as_tensor(np.array(a))


def _jgrid(spec, rng, interpolate=True):
    vals = rng.normal(size=spec.nbins)
    vals[::7] = 0.0  # exercise the |value| < 1e-7 slope guard
    return jgrid.Grid(values=jnp.asarray(vals), derivs=jnp.asarray(rng.normal(size=spec.nbins + (1,))),
                      spec=spec, interpolate=interpolate)


@pytest.mark.parametrize("periodic", [False, True])
def test_grid_lookups(periodic):
    rng = np.random.default_rng(0)
    spec = jgrid.GridSpec.create([-1.0], [2.0], [0.0197], [periodic])
    tspec = tgrid.GridSpec.create([-1.0], [2.0], [0.0197], [periodic])
    assert dataclasses.asdict(tspec) == dataclasses.asdict(spec)
    x = rng.uniform(-1.5, 2.5, (500, 1))
    x[:20, 0] = spec.axis_points(0)[:20]  # grid nodes
    for interp in (True, False):
        jgr = _jgrid(spec, rng, interp)
        tgr = tgrid.Grid(values=_t(jgr.values), derivs=_t(jgr.derivs), spec=tspec,
                         interpolate=interp)
        v, d = jgr.get_value_deriv(jnp.asarray(x))
        tv, td = tgr.get_value_deriv(_t(x))
        assert_f64(tv, v, "value")
        assert_f64(td, d, "deriv")
        assert_exact(tgr.in_grid(_t(x)), jgr.in_grid(jnp.asarray(x)))
        assert_exact(tgr.get_index(_t(x)), jgr.get_index(jnp.asarray(x)))
    # nearest-bin histogram accumulate and targeting's expected bias
    hist = jgrid.Grid.zeros(spec, dtype=jnp.float64)
    thist = tgrid.Grid.zeros(tspec, dtype=F64)
    w = rng.choice([-1.0, 0.0, 1.0], size=500)
    hist, _ = hist.add_value(jnp.asarray(x), jnp.asarray(w))
    thist, _ = thist.add_value(_t(x), _t(w))
    assert_exact(thist.values, hist.values)
    assert_exact(thist.get_value(_t(x)), hist.get_value(jnp.asarray(x)))
    assert_f64(tgrid.Grid(values=_t(jgr.values), derivs=None, spec=tspec).expected_bias(),
               jgr.expected_bias())


@pytest.mark.parametrize("bper", [False, True])
def test_gauss_grid_geometry(bper):
    rng = np.random.default_rng(1)
    kw = dict(boundary_min=[0.1], boundary_max=[2.9], boundary_periodic=[bper])
    jgg = jg.GaussGrid.create([0.0], [3.0], [0.02], [False], [0.1], dtype=jnp.float64, **kw)
    tgg = tg.GaussGrid.create([0.0], [3.0], [0.02], [False], [0.1], dtype=F64, **kw)
    assert dataclasses.asdict(tgg.spec) == dataclasses.asdict(jgg.spec)
    assert tgg.spec.window_shape == jgg.spec.window_shape
    assert_exact(tgg.bc_denom, jgg.bc_denom)
    assert_exact(tgg.bc_denom_deriv, jgg.bc_denom_deriv)
    vals = rng.normal(size=jgg.grid.values.shape)
    ders = rng.normal(size=jgg.grid.derivs.shape)
    jgg = dataclasses.replace(jgg, grid=dataclasses.replace(
        jgg.grid, values=jnp.asarray(vals), derivs=jnp.asarray(ders)))
    tgg = dataclasses.replace(tgg, grid=dataclasses.replace(
        tgg.grid, values=_t(vals), derivs=_t(ders)))
    x = rng.uniform(-3.0, 6.0, (400, 1))
    assert_f64(tgg.remap(_t(x)), jgg.remap(jnp.asarray(x)), "remap")
    assert_exact(tgg.in_bounds(_t(x)), jgg.in_bounds(jnp.asarray(x)))
    v, d = jgg.get_value_deriv(jnp.asarray(x))
    tv, td = tgg.get_value_deriv(_t(x))
    assert_f64(tv, v, "value")
    assert_f64(td, d, "deriv")


@pytest.mark.parametrize("spacing,periodic", [(0.02, False), (0.0197, False), (0.02, True)])
def test_dense_deposit_1d(spacing, periodic):
    """Dense tables (the engine round's deposit), deposit_dense_1d and the
    dispatcher, boundary duplication included; spacing 0.02 on [0, 3] puts
    grid points on lattice-aligned McGDP table quotients."""
    rng = np.random.default_rng(2)
    jgg = jg.GaussGrid.create([0.0], [3.0], [spacing], [periodic], [0.1], dtype=jnp.float64)
    tgg = tg.GaussGrid.create([0.0], [3.0], [spacing], [periodic], [0.1], dtype=F64)
    centers = rng.uniform(-0.2, 3.2, (64, 1))
    centers[:4, 0] = [0.0, 3.0, 1e-3, 2.999]
    heights = rng.uniform(0.0, 0.3, 64)
    assert_exact(tdep._bc_point_index_np(tgg.spec, 0), jdep._bc_point_index_np(jgg.spec, 0))
    Mv, Md, s = jdep.dense_tables_1d(jgg, jnp.asarray(centers))
    tMv, tMd, ts = tdep.dense_tables_1d(tgg, _t(centers))
    assert_f64(tMv, Mv, "Mval")
    assert_f64(tMd, Md, "Mder")
    assert_f64(ts, s, "s")
    out = jdep.deposit_from_tables(jgg, Mv, Md, jnp.asarray(heights))
    tout = tdep.deposit_from_tables(tgg, tMv, tMd, _t(heights))
    assert_f64(tout.grid.values, out.grid.values, "values")
    assert_f64(tout.grid.derivs, out.grid.derivs, "derivs")
    for jf, tf in ((jdep.deposit_dense_1d, tdep.deposit_dense_1d), (jdep.deposit, tdep.deposit)):
        out, ba = jf(jgg, jnp.asarray(centers), jnp.asarray(heights))
        tout, tba = tf(tgg, _t(centers), _t(heights))
        assert_f64(tout.grid.values, out.grid.values, f"{jf.__name__} values")
        assert_f64(tout.grid.derivs, out.grid.derivs, f"{jf.__name__} derivs")
        assert_f64(tba, ba, f"{jf.__name__} bias_added")


def test_cap_and_drain_scans():
    rng = np.random.default_rng(4)
    for trial in range(12):
        H = 96
        h = rng.uniform(0.0, 0.2, H)
        w = rng.uniform(0.5, 1.5, H)
        w[rng.integers(0, H, 5)] = rng.uniform(1.0, 3.0, 5)  # s_k > 1: several crossings
        active = rng.uniform(size=H) < 0.8
        cap = [0.5, 1.0, 3.0][trial % 3]
        cum0 = [0.0, 0.3, 1.2][trial % 3] if trial % 4 else cap  # saturated start
        ref = jcap.cap_scan(jnp.asarray(h), jnp.asarray(w), jnp.asarray(active), cap, cum0)
        out, reads = tcap.cap_scan(_t(h), _t(w), _t(active), cap, cum0)
        assert reads >= 1
        for name in ref._fields:
            assert_f64(getattr(out, name), getattr(ref, name), f"cap_scan {name}")
        dref = jcap.drain_scan(jnp.asarray(h), jnp.asarray(w), jnp.asarray(active), cap)
        dout = tcap.drain_scan(_t(h), _t(w), _t(active), cap)
        for name in dref._fields:
            assert_f64(getattr(dout, name), getattr(dref, name), f"drain_scan {name}")


ENGINE_CFGS = {
    # the bench's well-tempered, targeted configuration, tight cap: the
    # buffer fills, drains and skips rounds
    "bench": "tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 0.05\n"
             "hill_density 250\n",
    # well-tempering active (global_tempering < 0), hill_density unset
    "tempered": "tempering 1\nbias_factor 5\nglobal_tempering -1\nhill_prefactor 0.2\n"
                "bias_per_step 0.5\n",
    # global tempering shrinks the prefactor
    "global": "tempering 1\nbias_factor 5\nglobal_tempering 0.01\nhill_prefactor 0.3\n"
              "bias_per_step 0.2\nhill_density 40\n",
}


@pytest.mark.parametrize("name", sorted(ENGINE_CFGS))
def test_add_hills_round_f64(name):
    text = ENGINE_CFGS[name] + ("dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                                "bias_sigma 0.1\n")
    cfg = parse_edm_text(text)
    tspec = jgrid.GridSpec.create([0.0], [3.0], [0.02], [False])
    r_pts = tspec.axis_points(0)
    tvals = -2.0 * np.log(np.maximum(r_pts, 0.5))
    target = jgrid.Grid(values=jnp.asarray(tvals), derivs=None, spec=tspec)
    params, state = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                                 dtype=jnp.float64, target=target, buffer_size=512)
    tparams, tstate = TB.subdivide(
        t_parse(text), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0], dtype=F64,
        buffer_size=512,
        target=tgrid.Grid(values=_t(tvals), derivs=None,
                          spec=tgrid.GridSpec.create([0.0], [3.0], [0.02], [False])),
    )
    assert_f64(tparams.expected_target, params.expected_target)
    assert to_numpy_tree(tparams.cfg) == to_numpy_tree(params.cfg)
    assert tparams.total_volume == params.total_volume
    tparams = to_port(params)  # the converted parameters drive the rounds
    rnd = jax.jit(JB.add_hills_round)
    rng = np.random.default_rng(5)
    H = 64
    for r in range(6):
        pos = rng.uniform(-0.1, 3.1, (H, 1))
        run = rng.uniform(0.0, 0.02, H)
        active = rng.uniform(size=H) < 0.9
        est = float(rng.integers(500, 5000))
        state, rec = rnd(params, state, jnp.asarray(pos), jnp.asarray(run), jnp.asarray(est),
                         active=jnp.asarray(active))
        tstate, trec, _ = TB.add_hills_round(tparams, tstate, _t(pos), _t(run),
                                             torch.tensor(est, dtype=F64), active=_t(active))
        for f in ("cum_bias", "buf_pos", "buf_h"):
            assert_f64(getattr(tstate, f), getattr(state, f), f"round {r} {f}")
        for f in ("buf_left", "buf_right", "overflow_error", "steps"):
            assert_exact(getattr(tstate, f), getattr(state, f), f"round {r} {f}")
        assert_f64(tstate.bias.grid.values, state.bias.grid.values, f"round {r} values")
        assert_f64(tstate.bias.grid.derivs, state.bias.grid.derivs, f"round {r} derivs")
        assert_exact(tstate.cv_hist.values, state.cv_hist.values, f"round {r} histogram")
        for f in rec._fields:
            assert_f64(getattr(trec, f), getattr(rec, f), f"round {r} record {f}")
        assert_f64(TB.hill_heights(tparams, tstate, _t(pos), torch.tensor(est, dtype=F64)),
                   JB.hill_heights(params, state, jnp.asarray(pos), jnp.asarray(est)))
    assert int(state.buf_right) > 0 or name != "bench"  # the buffer was exercised
    TB.check_state(tstate)
