"""PyTorch port: the N-D grid lookup and the N-D / windowed deposition
against the JAX package.

The same seeded numpy inputs go through ``edm_tpu`` (x64, as the conftest
sets) and ``edm_tpu_torch`` on the CPU, in float64: values, derivatives,
unit tables and per-hill integrals within 1e-12 relative (both sides run
the same IEEE operations; XLA may fold a division by a constant into a
product, an ulp apart); indices and masks exactly.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, assert_f64, np_
from edm_tpu.gauss import GaussGrid as JGG
from edm_tpu.grid import Grid as JGrid
from edm_tpu.grid import GridSpec as JSpec
from edm_tpu.ops import deposit as jdep
from edm_tpu.ops import interp as jinterp
from edm_tpu_torch.gauss import GaussGrid as TGG
from edm_tpu_torch.grid import Grid as TGrid
from edm_tpu_torch.grid import GridSpec as TSpec
from edm_tpu_torch.ops import deposit as tdep
from edm_tpu_torch.ops import interp as tinterp

LO, HI = [0.0, -1.0, 0.5], [3.0, 2.0, 2.9]
SPACING = [0.097, 0.12, 0.15]  # support radii not on the lattice


def _grids(D, periodic, interpolate, seed):
    """A random grid with derivatives, in both packages."""
    lo, hi, sp = LO[:D], HI[:D], SPACING[:D]
    per = [periodic] * D
    js = JSpec.create(lo, hi, sp, per)
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=js.nbins)
    vals[rng.random(js.nbins) < 0.05] = 0.0  # the 1e-7 zero-table guard
    ders = rng.normal(size=js.nbins + (D,))
    jg = JGrid(values=jnp.asarray(vals), derivs=jnp.asarray(ders), spec=js,
               interpolate=interpolate)
    tg = TGrid(values=torch.tensor(vals), derivs=torch.tensor(ders),
               spec=TSpec(**{k: tuple(v) for k, v in js.__dict__.items()}),
               interpolate=interpolate)
    # queries inside, on, and outside the grid's range
    x = rng.uniform(np.array(lo) - 0.4, np.array(hi) + 0.4, (300, D))
    x[:5] = np.array(lo) + np.array(js.dx) * rng.integers(0, 5, (5, D))
    return jg, tg, x


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("interpolate", [True, False])
def test_grid_value_deriv_nd(D, periodic, interpolate):
    jg, tg, x = _grids(D, periodic, interpolate, seed=10 * D + periodic)
    v, d = jinterp.grid_value_deriv(jg, jnp.asarray(x))
    tv, td = tinterp.grid_value_deriv(tg, torch.tensor(x))
    assert_f64(tv, v, "value")
    assert_f64(td, d, "deriv")
    if interpolate:
        # the packed corner table: the same table, and the same lookups
        jp = jinterp.packed_corner_table(jg)
        tp = tinterp.packed_corner_table(tg)
        assert_exact(tp, jp, "packed table")
        pv, pd = tinterp.grid_value_deriv(tg, torch.tensor(x), packed=tp)
        assert_f64(pv, v, "packed value")
        assert_f64(pd, d, "packed deriv")


def _gauss(D, periodic, inner=False):
    """A Gaussian grid in both packages; ``inner``: a non-periodic system
    boundary 0.4 inside the grid on every dim (McGovern-De Pablo terms
    and boundary duplication)."""
    lo, hi, sp = LO[:D], HI[:D], SPACING[:D]
    sig = [0.21, 0.17, 0.23][:D]
    kw = dict(boundary_periodic=[periodic] * D)
    if inner:
        kw.update(boundary_min=[v + 0.4 for v in lo], boundary_max=[v - 0.4 for v in hi])
    jg = JGG.create(lo, hi, sp, [periodic] * D, sig, dtype=jnp.float64, **kw)
    tg = TGG.create(lo, hi, sp, [periodic] * D, sig, dtype=torch.float64, device="cpu", **kw)
    return jg, tg


def _centers(D, n, seed):
    rng = np.random.default_rng(seed)
    c = rng.uniform(np.array(LO[:D]) - 0.3, np.array(HI[:D]) + 0.3, (n, D))
    return c, rng.uniform(0.1, 1.0, n)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("periodic,inner", [(True, False), (False, False), (False, True)])
def test_hill_windows_and_deposit_precomputed(D, periodic, inner):
    jg, tg = _gauss(D, periodic, inner)
    c, h = _centers(D, 7 if D == 3 else 23, seed=D + 2 * periodic)
    jw = jdep.hill_windows(jg, jnp.asarray(c))
    tw = tdep.hill_windows(tg, torch.tensor(c))
    assert_exact(tw.idx, jw.idx, "idx")
    assert_exact(tw.valid, jw.valid, "valid")
    assert_f64(tw.value_w, jw.value_w, "value_w")
    assert_f64(tw.deriv_w, jw.deriv_w, "deriv_w")
    assert np.asarray(jw.valid).any()
    jo, jadd = jdep.deposit_precomputed(jg, jw, jnp.asarray(h))
    to, tadd = tdep.deposit_precomputed(tg, tw, torch.tensor(h))
    assert_f64(tadd, jadd, "bias_added")
    assert_f64(to.grid.values, jo.grid.values, "values")
    assert_f64(to.grid.derivs, jo.grid.derivs, "derivs")
    # the dispatcher takes the windowed scatter for every N-D grid
    do, dadd = tdep.deposit(tg, torch.tensor(c), torch.tensor(h))
    assert_exact(do.grid.values, to.grid.values, "deposit()")
    assert_exact(dadd, tadd, "deposit() bias_added")


@pytest.mark.parametrize("D", [2, 3])
def test_dense_tables_sep(D):
    jg, tg = _gauss(D, True)
    c, h = _centers(D, 9, seed=30 + D)
    jt, js = jdep.dense_tables_sep(jg, jnp.asarray(c))
    tt, ts = tdep.dense_tables_sep(tg, torch.tensor(c))
    assert_f64(ts, js, "s")
    for (ju, jdu), (tu, tdu) in zip(jt, tt):
        assert_f64(tu, ju, "u")
        assert_f64(tdu, jdu, "du")
    jo = jdep.deposit_from_tables_sep(jg, jt, jnp.asarray(h))
    to = tdep.deposit_from_tables_sep(tg, tt, torch.tensor(h))
    assert_f64(to.grid.values, jo.grid.values, "values")
    assert_f64(to.grid.derivs, jo.grid.derivs, "derivs")
    # the limiter's invariant: the grid's integral grew by sum h s
    vol = float(np.prod(tg.spec.grid.dx))
    grown = float(to.grid.values.sum()) * vol
    np.testing.assert_allclose(grown, float((torch.tensor(h) * ts).sum()), rtol=1e-12)
    with pytest.raises(ValueError, match="periodic"):
        tdep.dense_tables_sep(_gauss(D, False)[1], torch.tensor(c))


def test_duplicate_boundary_2d():
    jg, tg = _gauss(2, False, inner=True)
    rng = np.random.default_rng(8)
    vals = rng.normal(size=tg.spec.grid.nbins)
    jg2 = dataclasses.replace(jg, grid=dataclasses.replace(jg.grid, values=jnp.asarray(vals)))
    tg2 = dataclasses.replace(tg, grid=dataclasses.replace(tg.grid, values=torch.tensor(vals)))
    jo = jdep.duplicate_boundary(jg2)
    to = tdep.duplicate_boundary(tg2)
    assert_exact(to.grid.values, jo.grid.values)
    assert not np.array_equal(np_(to.grid.values), vals)
