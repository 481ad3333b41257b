"""PyTorch port: grid files and the LAMMPS table against the JAX package
and the compiled reference.

The same float64 grids, made from a seed with numpy, are written by both
packages: the files must be byte-identical, and the port's native writer
byte-identical to its Python path.  ``read_grid_file`` round-trips to the
text's 8 decimals (1e-8); ``GridSpec.from_deflated`` equals JAX's.  The
``.ltab`` writer meets the compiled reference's fixtures
(``tests/oracles/oracle.ltab``, ``oracle2.ltab``) as ``test_ltab_oracle.py``
holds JAX to them (header and zero rows byte-identical, values within
5e-7), and its file is byte-identical to JAX's for the same grid.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_f64
from edm_tpu import GaussGrid as JGaussGrid
from edm_tpu.grid import Grid as JGrid
from edm_tpu.grid import GridSpec as JGridSpec
from edm_tpu.grid import grid_points as j_grid_points
from edm_tpu.utils import gridio as jio
from edm_tpu_torch import GaussGrid, Grid, GridSpec, grid_points, native
from edm_tpu_torch.utils import gridio as tio

ORACLES = pathlib.Path(__file__).parent / "oracles"

# (min, max, spacing, periodic) per case: 1-D and 2-D, periodic and not
SPECS = {
    "1d-periodic": ([0.0], [10.0], [0.37], [True]),
    "1d-walled": ([0.5], [3.0], [0.0097], [False]),
    "2d-mixed": ([0.0, -1.0], [2.0, 1.5], [0.13, 0.11], [True, False]),
    "2d-walled": ([0.0, 0.0], [1.0, 2.0], [0.1, 0.15], [False, False]),
}


def _grids(name, derivs, seed=3):
    lo, hi, sp, per = SPECS[name]
    jspec = JGridSpec.create(lo, hi, sp, per)
    rng = np.random.default_rng(seed)
    v = rng.normal(size=jspec.nbins) * 3.0
    d = rng.normal(size=jspec.nbins + (jspec.dim,)) if derivs else None
    jg = JGrid(values=jnp.asarray(v), derivs=None if d is None else jnp.asarray(d), spec=jspec,
               interpolate=derivs)
    tg = Grid(values=torch.as_tensor(v), derivs=None if d is None else torch.as_tensor(d),
              spec=GridSpec.create(lo, hi, sp, per), interpolate=derivs)
    return jg, tg


@pytest.mark.parametrize("derivs", [True, False])
@pytest.mark.parametrize("name", list(SPECS))
def test_write_grid_matches_jax(tmp_path, monkeypatch, name, derivs):
    jg, tg = _grids(name, derivs)
    jio.write_grid(jg, str(tmp_path / "jax"))
    want = (tmp_path / "jax").read_bytes()
    assert native.load() is not None, native.errors
    tg32 = Grid(values=tg.values.float(), derivs=None if not derivs else tg.derivs.float(),
                spec=tg.spec)
    tio.write_grid(tg, str(tmp_path / "native"))
    tio.write_grid(tg32, str(tmp_path / "nat32"))
    assert (tmp_path / "native").read_bytes() == want
    # the Python path: the loader patched to report no library
    monkeypatch.setattr(native, "load", lambda: None)
    tio.write_grid(tg, str(tmp_path / "python"))
    assert (tmp_path / "python").read_bytes() == want
    # float32 grids: the same bytes from both of the port's paths
    tio.write_grid(tg32, str(tmp_path / "py32"))
    assert (tmp_path / "py32").read_bytes() == (tmp_path / "nat32").read_bytes()


@pytest.mark.parametrize("native_path", [True, False])
@pytest.mark.parametrize("name", list(SPECS))
def test_read_grid_round_trip(tmp_path, monkeypatch, name, native_path):
    jg, tg = _grids(name, True, seed=8)
    tio.write_grid(tg, str(tmp_path / "g"))
    if not native_path:
        monkeypatch.setattr(native, "load", lambda: None)
    back = tio.read_grid_file(str(tmp_path / "g"), dim=tg.spec.dim, interpolate=True,
                              dtype=torch.float64, device="cpu")
    jback = jio.read_grid_file(str(tmp_path / "g"), dim=tg.spec.dim, interpolate=True,
                               dtype=np.float64)
    assert back.spec == tg.spec and back.interpolate and back.values.dtype == torch.float64
    np.testing.assert_allclose(back.values.numpy(), tg.values.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_allclose(back.derivs.numpy(), tg.derivs.numpy(), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(back.values.numpy(), np.asarray(jback.values))
    np.testing.assert_array_equal(back.derivs.numpy(), np.asarray(jback.derivs))
    # the header's deflated non-periodic dims, re-inflated as JAX does
    per = SPECS[name][3]
    s = tg.spec
    bins = [n if p else n - 1 for n, p in zip(s.nbins, s.periodic)]
    fmax = [m if p else m - d for m, d, p in zip(s.max, s.dx, s.periodic)]
    assert vars(GridSpec.from_deflated(s.min, fmax, bins, per)) == vars(
        JGridSpec.from_deflated(s.min, fmax, bins, per))
    with pytest.raises(Exception, match="Dimension"):
        tio.read_grid_file(str(tmp_path / "g"), dim=tg.spec.dim + 1, device="cpu")


def test_grid_helpers_match_jax():
    """``Grid.clear``, ``add_grid`` (values and derivatives of another grid
    at this grid's points), ``max_value`` / ``min_value`` and
    ``grid_points`` against JAX's, float64."""
    jg, tg = _grids("2d-mixed", True, seed=11)
    jo, to = _grids("2d-walled", True, seed=12)
    np.testing.assert_array_equal(grid_points(tg.spec, torch.float64, "cpu").numpy(),
                                  np.asarray(j_grid_points(jg.spec, jnp.float64)))
    ja, ta = jg.add_grid(jo, 0.7, 0.25), tg.add_grid(to, 0.7, 0.25)
    assert_f64(ta.values, ja.values, "add_grid values")
    assert_f64(ta.derivs, ja.derivs, "add_grid derivatives")
    assert float(ta.max_value()) == float(ja.max_value())
    assert float(ta.min_value()) == float(ja.min_value())
    c = ta.clear()
    assert float(c.values.abs().sum()) == 0 and float(c.derivs.abs().sum()) == 0
    assert c.spec == ta.spec and c.values.shape == ta.values.shape


def _parse_ltab(text):
    """An .ltab file as (header lines, zero rows, grid rows split)."""
    header, zero_rows, grid_rows = [], [], []
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) == 4 and not ln.startswith("#"):
            if parts[2] == "0.0" and parts[3] == "0.0" and "." not in parts[0]:
                zero_rows.append(ln)
            else:
                grid_rows.append(parts)
        else:
            header.append(ln)
    return header, zero_rows, grid_rows


LTAB_CASES = [
    ("oracle.ltab", 0.0, [(0.05, 0.7), (1.50, 1.0), (2.37, 0.3), (2.98, 0.5)]),
    ("oracle2.ltab", 0.5, [(1.0, 1.0), (2.9, 0.4)]),
]


def ltab_grid(gmin, hills, device="cpu"):
    """The fixtures' grid: [gmin, 3] non-periodic, spacing 0.0097, sigma
    0.1, the hills deposited one at a time (float64)."""
    g = GaussGrid.create([gmin], [3.0], [0.0097], [False], [0.1], boundary_min=[gmin],
                         boundary_max=[3.0], boundary_periodic=[False], dtype=torch.float64,
                         device=device)
    for x, h in hills:
        g, _ = g.add_value(torch.tensor([[x]], dtype=torch.float64, device=device),
                           torch.tensor([h], dtype=torch.float64, device=device))
    return g


def check_ltab(got_text, fixture):
    """``test_ltab_oracle.py``'s comparison: header and zero rows
    byte-identical, grid rows' index and x columns identical, values and
    forces within 5e-7.  Returns the largest value difference."""
    want = _parse_ltab((ORACLES / fixture).read_text())
    got = _parse_ltab(got_text)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert len(got[2]) == len(want[2])
    for grow, wrow in zip(got[2], want[2]):
        assert grow[0] == wrow[0] and grow[1] == wrow[1]
    gv = np.array([[float(r[2]), float(r[3])] for r in got[2]])
    wv = np.array([[float(r[2]), float(r[3])] for r in want[2]])
    np.testing.assert_allclose(gv, wv, atol=5e-7, rtol=0)
    return float(np.abs(gv - wv).max())


@pytest.mark.parametrize("fixture,gmin,hills", LTAB_CASES)
def test_ltab_matches_reference_and_jax(tmp_path, fixture, gmin, hills):
    g = ltab_grid(gmin, hills)
    tio.write_lammps_table(g.grid, str(tmp_path / "port.ltab"), [gmin], [3.0])
    check_ltab((tmp_path / "port.ltab").read_text(), fixture)
    jg = JGaussGrid.create([gmin], [3.0], [0.0097], [False], [0.1], boundary_min=[gmin],
                           boundary_max=[3.0], boundary_periodic=[False], dtype=jnp.float64)
    for x, h in hills:
        jg, _ = jg.add_value(jnp.asarray([[x]], jnp.float64), jnp.asarray([h], jnp.float64))
    jio.write_lammps_table(jg.grid, str(tmp_path / "jax.ltab"), [gmin], [3.0])
    assert (tmp_path / "port.ltab").read_bytes() == (tmp_path / "jax.ltab").read_bytes()
    with pytest.raises(Exception, match="1D"):
        tio.write_lammps_table(_grids("2d-mixed", True)[1], str(tmp_path / "x"), [0], [1])
