"""PyTorch port: the cell host's XLA force pass (``use_pallas=False``, the
JAX default) and ``cell_diag``, against the JAX package.

test_strided.py's bench-like 1000-atom box (a 10^3 lattice, a = 1.26, here
jittered and with random velocities; cells of 3.05, the RDF-targeted
well-tempered bias, ``cell_chunk=81``, energy stride 10, hill and rebuild
strides 10), float32, the same converted state and ``PRNGKey``:

  - 20 kT = 0 steps through the three static phases (hills + energy,
    plain, rebuild), step for step at the tolerance of
    ``test_torch_slice.py``'s trajectory pin: integer and flag leaves
    exactly, slot positions, velocities and forces within 2e-5 *
    max(1, max|.|), energies 1e-5, cum_bias 1e-6, the grid 1e-5 of max|.|;
    the Chebyshev table and the typed CV over 10 steps each through the
    dynamic step;
  - each state's XLA forces against the port's K1 plain version at full cap
    within 2e-5 * max(1, max|f|), and its bias energy within 1e-5;
  - ``cell_diag`` equal to JAX's dict, with and without the tail fields.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_energy, assert_exact, assert_forces, np_, to_port
from edm_tpu import bias as JB
from edm_tpu.grid import Grid, GridSpec
from edm_tpu.models import pair_edm
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import cell_diag, init_cell_state, make_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import cellforce as CF
from test_torch_slice import BENCH_CFG, PHASES, _phase

N = 1000
CHEB = dict(cheb_deg=16, cheb_panels=4)
KW = dict(hill_stride=10, rebuild_stride=10, hill_capacity=512, cell_chunk=81,
          use_pallas=False, energy_stride=10)
TYPES = np.where(np.arange(N) % 2 == 0, 2, 1).astype(np.int32)


def _setup(pair_lookup="interp", kernel_cap=None):
    cfg = parse_edm_text(BENCH_CFG)
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = Grid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=jnp.float32, target=target)
    rng = np.random.default_rng(7)
    side, a = 10, 1.26
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
           * a + 0.5 * a + rng.uniform(-0.1, 0.1, (N, 3))).astype(np.float32)
    core = pair_edm.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=N * 40,
                               pair_lookup=pair_lookup, **CHEB)
    core = dataclasses.replace(core, v=jnp.asarray(rng.normal(0, 1.0, (N, 3)), jnp.float32))
    spec = CellSpec.create([side * a] * 3, cutoff=3.05, n_atoms=N)
    kc = {} if kernel_cap is None else dict(kernel_cap=kernel_cap, overflow_cap=64)
    return params, spec, init_cell_state(spec, core, with_ids=False, **kc)


def _port_step(params, spec, **kw):
    return tpc.make_cell_step(params, TLP(dt=0.002, friction=1.0, kT=0.0), TLJ(),
                              tcells.CellSpec(**dataclasses.asdict(spec)), **kw)


def _held(ts, st, te, e, what):
    for f in ("aid", "table_overflow"):
        assert_exact(getattr(ts, f), getattr(st, f), f"{what} {f}")
    for f in ("step", "last_calls", "hills_truncated"):
        assert_exact(getattr(ts.core, f), getattr(st.core, f), f"{what} core.{f}")
    np.testing.assert_array_equal(ts.core.key, np.asarray(st.core.key))
    for f in ("xs", "vs", "fs"):
        assert_forces(getattr(ts, f), getattr(st, f), f"{what} {f}")
    assert_energy(te, e, f"{what} energy")
    np.testing.assert_allclose(np_(ts.core.bias.cum_bias), np.asarray(st.core.bias.cum_bias),
                               rtol=1e-6)
    grid = np.asarray(st.core.bias.bias.grid.values)
    np.testing.assert_allclose(np_(ts.core.bias.bias.grid.values), grid, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(grid).max()))


def _against_k1(step, ts, what):
    """The XLA pass's forces and bias energy on ``ts`` against K1's plain
    version at full cap (the Hermite table of the live grid, or the
    carried Chebyshev table)."""
    tbl = ts.core.cheb if ts.core.cheb is not None else CF.hermite_pair_table(
        ts.core.bias.bias)
    e, f = step._xla_force(ts, ts.xs, True)
    ts_k, tp = (None, None) if step.types is None else (step._slot_types(ts), step.type_pair)
    f_k1, eb = CF.cell_force_newton(ts.xs, ts.mc, tbl, k=step.spec.cap, ncells=step.spec.ncells,
                                    box=step.spec.box, lj=step.lj, energy=True, ts=ts_k,
                                    type_pair=tp)
    assert_forces(f, f_k1, f"{what}: XLA pass vs K1")
    assert_energy(e, eb.sum(), f"{what}: XLA energy vs K1")


@pytest.fixture(scope="module")
def exact_run():
    """20 kT = 0 steps of the JAX XLA path through its static phases."""
    params, spec, st = _setup()
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    jsteps = [jax.jit(make_cell_step(params, lp, LJParams(), spec, **KW, **ph))
              for ph in PHASES]
    states = [st]
    energies = []
    for i in range(20):
        st, e = jsteps[_phase(i)](st, None)
        states.append(st)
        energies.append(e)
    return params, spec, states, energies


def test_xla_force_path_matches_jax(exact_run):
    params, spec, states, energies = exact_run
    tsteps = [_port_step(to_port(params), spec, **KW, **ph) for ph in PHASES]
    ts = to_port(states[0])
    for i in range(20):
        ts, te = tsteps[_phase(i)](ts)
        _held(ts, states[i + 1], te, energies[i], f"step {i}")
        if i in (0, 9, 19):
            _against_k1(tsteps[0], ts, f"step {i}")
    assert int(ts.core.bias.steps) == 2 and float(ts.core.bias.cum_bias) > 0
    assert not bool(ts.core.hills_truncated)
    assert tsteps[1].host_syncs == 0  # a plain step reads nothing back


@pytest.mark.parametrize("case", ["chebyshev", "typed"])
def test_xla_force_path_variants_match_jax(case):
    params, spec, st = _setup(pair_lookup="chebyshev" if case == "chebyshev" else "interp")
    kw = dict(KW, hill_stride=5, rebuild_stride=5, energy_stride=1)
    if case == "typed":
        kw.update(types=TYPES, type_pair=(1, 2))
    jstep = jax.jit(make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0),
                                   LJParams(), spec, **kw))
    tstep = _port_step(to_port(params), spec, **kw)
    ts = to_port(st)
    for i in range(10):
        st, e = jstep(st, None)
        ts, te = tstep(ts)
        _held(ts, st, te, e, f"{case} step {i}")
    _against_k1(tstep, ts, case)
    assert int(ts.core.bias.steps) == 2 and float(ts.core.bias.cum_bias) > 0


def test_default_step_is_the_xla_pass(exact_run):
    """``make_cell_step`` with the JAX defaults builds the XLA pass, and it
    matches the explicit ``use_pallas=False`` step bitwise."""
    params, spec, states, _ = exact_run
    ts = to_port(states[3])
    tparams = to_port(params)
    kw = {k: v for k, v in KW.items() if k not in ("use_pallas", "cell_chunk")}
    dflt = _port_step(tparams, spec, **kw, **PHASES[1])
    assert not dflt.use_pallas and dflt.cell_chunk == 32
    a, ea = dflt(ts)
    b, eb = _port_step(tparams, spec, **KW, **PHASES[1])(ts)
    for f in ("xs", "vs", "fs"):  # a cell's row sums do not depend on the chunking
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with pytest.raises(ValueError, match="kernel_cap"):
        _port_step(tparams, spec, **kw, kernel_cap=24)
    with pytest.raises(ValueError, match="use_pallas"):
        _port_step(tparams, spec, **kw, use_pallas="xla")


@pytest.mark.parametrize("kernel_cap", [None, 24])
def test_cell_diag_matches_jax(kernel_cap):
    _, spec, st = _setup(kernel_cap=kernel_cap)
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    want = cell_diag(spec, st, kernel_caps=(16, 24, 28))
    got = tpc.cell_diag(tspec, to_port(st), kernel_caps=(16, 24, 28))
    assert got == want
    assert ("state_tail_count" in got) == (kernel_cap is not None)
