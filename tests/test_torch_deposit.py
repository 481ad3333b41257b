"""PyTorch port: 1-D periodic deposition on large grids (K4, K5) against the
JAX package.

  - K4's plain version against ``deposit_windowed_1d_pallas`` (interpret
    mode) on ``test_gauss.py``'s windowed grid (G = 65536, sigma =
    0.029317, hills that wrap the period included), at that test's
    tolerances: values within 1e-4 and derivatives within 3e-4 of max|.|,
    bias_added within 2e-6;
  - K5's plain version against ``deposit_dense_1d_pallas`` (interpret mode)
    on G = 16384, sigma = 0.45 (W = 8341: the dense route), at
    ``test_pallas_deposit_matches_dense``'s tolerances;
  - both again on a grid that already carries values and derivatives;
  - the ``deposit`` dispatcher: each route as the JAX package chooses it on
    a TPU (both packages' route functions spied on), and
    ``GaussGrid.add_value`` against the JAX package's on the K4 and K5
    grids;
  - ``deposit_kernels.remap_periodic_1d``, the remap as the CUDA kernels
    compute it per hill, against ``GaussGrid.remap`` of both packages:
    float32, exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# one torch thread per process: with several, the first elementwise call of
# a process was seen to round one thread's chunk of the hill terms
# differently (1e-4 relative), which the bias_added bound can catch
import _torch_parity  # noqa: F401
from edm_tpu import gauss as jg
from edm_tpu.ops import deposit as jdep
from edm_tpu.ops import deposit_pallas as JP
from edm_tpu_torch import gauss as tg
from edm_tpu_torch.ops import deposit as tdep
from edm_tpu_torch.ops import deposit_kernels as DK


def _grids(G, sigma, periodic=True, dtype="float32"):
    dx = 10.0 / G
    kw = dict(periodic=[periodic], sigma=[sigma])
    return (jg.GaussGrid.create([0], [10], [dx], dtype=jnp.dtype(dtype), **kw),
            tg.GaussGrid.create([0], [10], [dx], dtype=getattr(torch, dtype), device="cpu",
                                **kw))


def _windowed_hills():
    """test_gauss.py:330-336: 30 uniform centres and three at the period's
    edges (their windows wrap)."""
    rng = np.random.default_rng(3)
    c = np.concatenate([rng.uniform(0, 10, (30,)), [0.001, 9.999, 0.05]])[:, None]
    return c.astype(np.float32), rng.uniform(0.01, 0.2, (33,)).astype(np.float32)


def _dense_hills():
    rng = np.random.default_rng(9)
    return (rng.uniform(0, 10, (64, 1)).astype(np.float32),
            rng.uniform(0.1, 1.0, (64,)).astype(np.float32))


def _check_fields(tout, gout):
    """Values and derivatives within 1e-4 and 3e-4 of the JAX grid's max|.|."""
    for name, rel in (("values", 1e-4), ("derivs", 3e-4)):
        ref = np.asarray(getattr(gout.grid, name))
        assert float(np.abs(getattr(tout.grid, name).numpy() - ref).max()) < rel * np.abs(ref).max()


def _check_windowed(tout, tba, gout, ba):
    _check_fields(tout, gout)
    np.testing.assert_allclose(tba.numpy(), np.asarray(ba), atol=2e-6)


def _check_dense(tout, tba, gout, ba):
    np.testing.assert_allclose(tba.numpy(), np.asarray(ba), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(tout.grid.values.numpy(), np.asarray(gout.grid.values),
                               rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(tout.grid.derivs.numpy(), np.asarray(gout.grid.derivs),
                               rtol=2e-4, atol=1e-4)


def test_windowed_plain_vs_pallas():
    jgg, tgg = _grids(65536, 0.0293170)
    assert DK.supported(tgg) and JP.supported(jgg)
    W, G = tgg.spec.window_shape[0], tgg.spec.grid.nbins[0]
    assert W + 256 < G // 2  # the K4 route
    c, h = _windowed_hills()
    gout, ba = JP.deposit_windowed_1d_pallas(jgg, jnp.asarray(c), jnp.asarray(h), interpret=True)
    n0 = DK.deposit_windowed_1d.launches
    tout, tba = DK.deposit_windowed_1d(tgg, torch.as_tensor(c), torch.as_tensor(h))
    assert DK.deposit_windowed_1d.launches == n0  # the CPU runs the plain version
    _check_windowed(tout, tba, gout, ba)
    # conservation on a periodic grid: each hill adds its height
    np.testing.assert_allclose(tba.numpy(), h, rtol=1e-3)


def test_dense_plain_vs_pallas():
    jgg, tgg = _grids(16384, 0.45)
    W, G = tgg.spec.window_shape[0], tgg.spec.grid.nbins[0]
    assert W == 8341 and W + 256 >= G // 2  # the K5 route
    c, h = _dense_hills()
    gout, ba = JP.deposit_dense_1d_pallas(jgg, jnp.asarray(c), jnp.asarray(h), interpret=True)
    n0 = DK.deposit_dense_1d_kernel.launches
    tout, tba = DK.deposit_dense_1d_kernel(tgg, torch.as_tensor(c), torch.as_tensor(h))
    assert DK.deposit_dense_1d_kernel.launches == n0
    _check_dense(tout, tba, gout, ba)


@pytest.mark.parametrize("windowed", [True, False])
def test_plain_vs_pallas_on_a_carried_grid(windowed):
    """Both routes add onto a grid that already holds values and derivatives
    (seeded noise, the same in both packages), as every round after the
    first does."""
    G, sigma = (65536, 0.0293170) if windowed else (16384, 0.45)
    jgg, tgg = _grids(G, sigma)
    rng = np.random.default_rng(11)
    v0 = rng.normal(0.0, 1.0, G).astype(np.float32)
    d0 = rng.normal(0.0, 10.0, (G, 1)).astype(np.float32)
    jgg = dataclasses.replace(jgg, grid=dataclasses.replace(
        jgg.grid, values=jnp.asarray(v0), derivs=jnp.asarray(d0)))
    tgg = DK._commit(tgg, torch.as_tensor(v0), torch.as_tensor(d0))
    c, h = _windowed_hills() if windowed else _dense_hills()
    jfn, tfn = ((JP.deposit_windowed_1d_pallas, DK.deposit_windowed_1d) if windowed else
                (JP.deposit_dense_1d_pallas, DK.deposit_dense_1d_kernel))
    gout, ba = jfn(jgg, jnp.asarray(c), jnp.asarray(h), interpret=True)
    tout, tba = tfn(tgg, torch.as_tensor(c), torch.as_tensor(h))
    _check_fields(tout, gout)
    if windowed:
        np.testing.assert_allclose(tba.numpy(), np.asarray(ba), atol=2e-6)
    else:
        np.testing.assert_allclose(tba.numpy(), np.asarray(ba), rtol=2e-5, atol=1e-7)


ROUTES = [
    # (G, sigma, periodic, dtype)
    (65536, 0.0293170, True, "float32"),  # narrow windows: K4
    (16384, 0.45, True, "float32"),  # wide windows: K5
    (8192, 0.05, True, "float32"),  # under 16384 points: the dense XLA form
    (65536, 0.0293170, False, "float32"),  # not periodic: the dense XLA form
    (65536, 0.0293170, True, "float64"),  # float64: the dense XLA form
]


@pytest.mark.parametrize("G,sigma,periodic,dtype", ROUTES)
def test_deposit_routes_as_jax_on_tpu(monkeypatch, G, sigma, periodic, dtype):
    jgg, tgg = _grids(G, sigma, periodic, dtype)
    calls = []

    def spy(name):
        def f(gg, centers, heights, *a, **k):
            calls.append(name)
            return gg, heights
        return f

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(JP, "deposit_windowed_1d_pallas", spy("windowed"))
    monkeypatch.setattr(JP, "deposit_dense_1d_pallas", spy("dense"))
    monkeypatch.setattr(jdep, "deposit_dense_1d", spy("xla"))
    monkeypatch.setattr(DK, "deposit_windowed_1d", spy("windowed"))
    monkeypatch.setattr(DK, "deposit_dense_1d_kernel", spy("dense"))
    monkeypatch.setattr(tdep, "deposit_dense_1d", spy("xla"))
    c = np.array([[1.0], [5.0]])
    jdep.deposit(jgg, jnp.asarray(c, jgg.dtype), jnp.ones(2, jgg.dtype))
    tdep.deposit(tgg, torch.as_tensor(c, dtype=tgg.dtype), torch.ones(2, dtype=tgg.dtype))
    assert len(calls) == 2 and calls[0] == calls[1], calls
    expected = {0: "windowed", 1: "dense"}.get(ROUTES.index((G, sigma, periodic, dtype)), "xla")
    assert calls[0] == expected


@pytest.mark.parametrize("G,sigma", [(65536, 0.0293170), (16384, 0.45)])
def test_add_value_matches_jax(G, sigma):
    """``GaussGrid.add_value`` through the port's route (K4 or K5's plain
    version here) against the JAX package's ``add_value`` (its dense XLA
    form on the CPU)."""
    jgg, tgg = _grids(G, sigma)
    c, h = _windowed_hills() if G == 65536 else _dense_hills()
    gout, ba = jgg.add_value(jnp.asarray(c), jnp.asarray(h))
    tout, tba = tgg.add_value(torch.as_tensor(c), torch.as_tensor(h))
    (_check_windowed if G == 65536 else _check_dense)(tout, tba, gout, ba)
    # a scalar height, as the benchmark passes it
    gout, ba = jgg.add_value(jnp.asarray(c), 0.1)
    tout, tba = tgg.add_value(torch.as_tensor(c), 0.1)
    (_check_windowed if G == 65536 else _check_dense)(tout, tba, gout, ba)


def test_wrappers_reject_other_devices():
    _, tgg = _grids(65536, 0.0293170)
    meta = tg.GaussGrid(grid=type(tgg.grid)(values=tgg.grid.values.to("meta"),
                                            derivs=tgg.grid.derivs.to("meta"),
                                            spec=tgg.grid.spec, interpolate=True),
                        bc_denom=tgg.bc_denom, bc_denom_deriv=tgg.bc_denom_deriv, spec=tgg.spec)
    c = torch.zeros((2, 1), device="meta")
    for fn in (DK.deposit_windowed_1d, DK.deposit_dense_1d_kernel):
        with pytest.raises(ValueError, match="no deposition kernel"):
            fn(meta, c, torch.ones(2, device="meta"))


@pytest.mark.parametrize("lo,hi,G", [(0.0, 10.0, 65536), (-3.3, 7.1, 16384), (2.5, 2.9, 1_000_000)])
def test_kernel_remap_formula(lo, hi, G):
    """Centres inside the grid, outside on both sides, several periods away,
    on the edges and one float beyond them: the formula that K4 and K5 apply
    to the raw centres gives ``GaussGrid.remap``'s float32 results, bit for
    bit, in both packages."""
    dx = (hi - lo) / G
    kw = dict(periodic=[True], sigma=[30 * dx])
    jgg = jg.GaussGrid.create([lo], [hi], [dx], dtype=jnp.float32, **kw)
    tgg = tg.GaussGrid.create([lo], [hi], [dx], dtype=torch.float32, device="cpu", **kw)
    assert DK.supported(tgg)
    L = hi - lo
    rng = np.random.default_rng(21)
    e = np.float32([lo, hi])
    edges = np.concatenate([e, np.nextafter(e, np.float32(-np.inf)),
                            np.nextafter(e, np.float32(np.inf)), e + np.float32(L),
                            e - np.float32(L)])
    x = np.concatenate([rng.uniform(lo, hi, 200), rng.uniform(lo - L, lo, 200),
                        rng.uniform(hi, hi + L, 200), rng.uniform(lo - 40 * L, hi + 40 * L, 400),
                        edges]).astype(np.float32)
    got = DK.remap_periodic_1d(tgg, torch.as_tensor(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, tgg.remap(torch.as_tensor(x)[:, None])[:, 0].numpy())
    np.testing.assert_array_equal(got, np.asarray(jgg.remap(jnp.asarray(x)[:, None]))[:, 0])
    inside = (x >= np.float32(lo)) & (x <= np.float32(hi))
    np.testing.assert_array_equal(got[inside], x[inside])
    assert (got[~inside] != x[~inside]).sum() > 700 and inside.sum() > 200
    assert got.min() >= np.float32(lo) - 1e-5 * L and got.max() <= np.float32(hi) + 1e-5 * L
