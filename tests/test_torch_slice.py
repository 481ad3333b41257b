"""PyTorch port: the first slice end to end against the JAX cell host.

The bench configuration's semantics (``bench.py:bench_pairwise``: exact
Hermite lookup, well-tempered and RDF-targeted bias, kernel_cap with the
dense tail pass, energy stride 10, the hills / 8 plain / rebuild phase
pattern) at 600 atoms, kT = 0, 20 steps from the same converted state and
the same ``PRNGKey``.  The 600-atom clustered fluid of
``test_kernel_cap.py`` starts with a tail of 49 atoms above overflow_cap
48, so the first period runs the full-cap fallback; a uniform drift along
y moves the crowd across a cell face, the rebuild at step 9 brings the
tail under the cap and the second period runs the tail pass (K2).

Step for step: integer and flag leaves exactly; positions, velocities and
forces within 2e-5 * max(1, max|f|); energies within 1e-5 relative;
cum_bias to 1e-6 and the bias grid to 1e-5 relative.
"""

import dataclasses
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parity import assert_energy, assert_exact, assert_forces, np_, to_port
from edm_tpu import bias as JB
from edm_tpu.grid import Grid, GridSpec
from edm_tpu.models import pair_edm
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ

N, KCAP, OCAP, DRIFT = 600, 24, 48, 5.0
BENCH_CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
             "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
             "bias_sigma 0.1\n")
PHASES = [dict(static_do_hills=True, static_do_energy=True, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=True)]


def _phase(i):
    return 0 if i % 10 == 0 else 2 if i % 10 == 9 else 1


def _jax_setup():
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
    core = pair_edm.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=N * 300)
    core = dataclasses.replace(core, v=jnp.zeros_like(core.x).at[:, 1].set(DRIFT))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    state = init_cell_state(spec, core, with_ids=False, kernel_cap=KCAP, overflow_cap=OCAP)
    return params, spec, state


def test_slice_matches_jax_step_for_step():
    params, spec, st = _jax_setup()
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    lj = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
    kw = dict(hill_capacity=512, energy_stride=10, kernel_cap=KCAP, overflow_cap=OCAP)
    jsteps = [jax.jit(make_cell_step(params, lp, lj, spec, hill_stride=10, rebuild_stride=10,
                                     use_pallas=True, **kw, **ph)) for ph in PHASES]
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    tparams, ts = to_port(params), to_port(st)
    tsteps = [tpc.make_cell_step(tparams, TLP(dt=0.002, friction=1.0, kT=0.0),
                                 TLJ(epsilon=1.0, sigma=0.3, rcut=0.75), tspec, **kw, **ph)
              for ph in PHASES]
    ts0 = ts
    assert bool(st.tail_ovf) and ts.tail_ovf_host  # the first period falls back
    periods = []
    for i in range(20):
        st, e = jsteps[_phase(i)](st, None)
        ts, te = tsteps[_phase(i)](ts)
        for f in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow"):
            assert_exact(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        assert ts.tail_ovf_host == bool(st.tail_ovf)
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
        np.testing.assert_array_equal(ts.core.key, np.asarray(st.core.key))
        periods.append(bool(st.tail_ovf))
    # period 0 ran the full-cap fallback, period 1 the reduced pass with K2
    assert periods[:9] == [True] * 9 and periods[9:19] == [False] * 10
    assert int(st.tail_fallbacks) == 1 and not bool(st.core.hills_truncated)
    assert float(st.core.bias.cum_bias) > 0
    # rebuilds: step 9 full (feasibility + tail_ovf reads), step 19 incremental
    assert tsteps[2].host_syncs == 3 and tsteps[1].host_syncs == 0
    assert tsteps[0].host_syncs >= 2

    # models.driver.pattern_segment replays the same run
    seg = pattern_segment([(tsteps[0], 1), (tsteps[1], 8), (tsteps[2], 1)], 20)
    ts2, energies = seg(ts0)
    assert energies.shape == (20,)
    for f in ("aid", "xs", "vs", "fs"):
        assert_exact(getattr(ts2, f), getattr(ts, f), f)
    with pytest.raises(ValueError, match="multiple"):
        pattern_segment([(tsteps[0], 1), (tsteps[1], 8), (tsteps[2], 1)], 15)


def test_make_cell_step_rejects_unported_options():
    params, spec, _ = _jax_setup()
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    args = (to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), TLJ(), tspec)
    with pytest.raises(NotImplementedError, match="static_do"):
        tpc.make_cell_step(*args)
    for kw, item in ((dict(use_pallas="newton"), "item 13"), (dict(types=[0]), "item 5"),
                     (dict(collect_records=True), "item 10"), (dict(slab_axis="x"), "item 12")):
        with pytest.raises(NotImplementedError, match=item):
            tpc.make_cell_step(*args, **PHASES[1], **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        tpc.make_cell_step(*args, **PHASES[1], kernel_cap=20)


def test_port_imports_without_jax():
    """Every module of the port imports with jax blocked, and no source line
    of the package imports jax."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import edm_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(edm_tpu_torch.__path__, 'edm_tpu_torch.')]\n"
        "[importlib.import_module(n) for n in names]\n"
        "assert 'edm_tpu' not in sys.modules\n"
        "print(len(names))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
    import pathlib

    import edm_tpu_torch

    for path in pathlib.Path(edm_tpu_torch.__file__).parent.rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            assert not (s.startswith("import jax") or s.startswith("from jax")), path
