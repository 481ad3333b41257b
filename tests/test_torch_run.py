"""PyTorch port: the HILLS log, ``driver.run_simulation`` and the cell
host's dynamic stride step, against the JAX package.

  - ``HillsLog``: the port's file byte-identical to JAX's over the same
    float64 API rounds, and the port's native formatter byte-identical to
    its Python path;
  - the coordinate host through ``run_simulation`` writes the same HILLS
    file as the API (the JAX package's
    ``test_compiled_host_hills_log_matches_api``);
  - the cell host (600 atoms, kT = 0, kernel_cap with the full-cap period
    first) through ``run_simulation`` with records and every output,
    against JAX's ``run_simulation`` on its host: the final state to the
    tolerances of ``test_torch_slice.py`` (integer leaves exactly, slot
    arrays within 2e-5 * max(1, max|.|), energies 1e-5, cum_bias 1e-6, the
    grid 1e-5 of its max), the HILLS lines' step, type and counter columns
    exactly and their numbers within 1e-5 of the column's max, the written
    files within the same;
  - the port's dynamic cell step bitwise against its own static phases.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, assert_forces, assert_tree, clustered_points, to_port
from edm_tpu import bias as JB
from edm_tpu.api import EDMBias as JEDMBias
from edm_tpu.grid import Grid as JGrid
from edm_tpu.grid import GridSpec as JGridSpec
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.driver import run_simulation as j_run
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu.utils.hills_log import HillsLog as JHillsLog
from edm_tpu_torch import bias as TB
from edm_tpu_torch import native
from edm_tpu_torch.api import EDMBias
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import coord_edm as tce
from edm_tpu_torch.models import langevin as tlang
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.driver import pattern_segment, run_simulation
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import prng
from edm_tpu_torch.utils.hills_log import HillsLog

CAPPED = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 0.6\ndimension 1\n"
          "box_low 0\nbox_high 10\nbias_spacing 0.0097\nbias_sigma 0.2\n")


def _api_rounds(cls, path, rounds, **kw):
    b = cls(str(path), 1.0, 1.0, log_hills=True, **kw)
    b.subdivide([0], [10], [0], [10], [True], [0])
    for pos in rounds:
        b.add_hills(pos, np.ones(len(pos)))
    b.hills_log.close()
    return b


def _rounds(seed=4, n=4, width=6):
    rng = np.random.default_rng(seed)
    return [rng.uniform(1, 9, (width, 1)) for _ in range(n)]


def test_hills_log_matches_jax(tmp_path):
    """Capped float64 rounds through both packages' EDMBias: the HILLS
    files byte-identical, with drain and undo events in them."""
    for name in ("J", "T"):
        (tmp_path / f"{name}.edm").write_text(CAPPED + f"hills_filename {tmp_path}/{name}\n")
    rounds = _rounds()
    _api_rounds(JEDMBias, tmp_path / "J.edm", rounds, dtype=jnp.float64)
    _api_rounds(EDMBias, tmp_path / "T.edm", rounds, device="cpu")
    got, want = (tmp_path / "T_0").read_text(), (tmp_path / "J_0").read_text()
    assert got == want
    types = {line.split()[1] for line in got.splitlines()}
    assert {"h", "u", "b"} <= types and got.count("\n") >= 8


def test_hills_native_matches_python(tmp_path, monkeypatch):
    """The port's C++ formatter against its Python path (the loader patched
    to report no library), byte for byte, over the same capped rounds in
    float64 and in float32 (both paths format from float64 copies of the
    records)."""
    assert native.load_hillslog() is not None, native.errors
    rounds = _rounds(seed=7, n=5, width=8)
    path = tmp_path / "h.edm"
    path.write_text(CAPPED + f"hills_filename {tmp_path}/h\n")
    for dtype in (torch.float64, torch.float32):
        texts = []
        for python_path in (True, False):
            with monkeypatch.context() as m:
                if python_path:
                    m.setattr(native, "load_hillslog", lambda: None)
                _api_rounds(EDMBias, path, rounds, device="cpu", dtype=dtype)
            texts.append((tmp_path / "h_0").read_text())
        assert texts[0] == texts[1]
        assert {"h", "u", "b"} <= {ln.split()[1] for ln in texts[0].splitlines()}


def test_coord_host_hills_log_matches_api(tmp_path):
    """A frozen particle pair (kT = 0, no friction) deposits through the
    coordinate host and ``run_simulation`` the same hills as through the
    API: the two HILLS files byte-identical, and cum_bias equal."""
    n_rounds, xs = 4, [2.5, 5.0]  # the second hill straddles the 0.6 cap
    (tmp_path / "in.edm").write_text(CAPPED + f"hills_filename {tmp_path}/API_HILLS\n")
    b = EDMBias(str(tmp_path / "in.edm"), 1.0, 1.0, log_hills=True, device="cpu")
    b.subdivide([0], [10], [0], [10], [True], [0])
    for _ in range(n_rounds):
        b.add_hills(np.array([[x] for x in xs]), np.ones(len(xs)))
    b.hills_log.close()

    params, bs = TB.subdivide(parse_edm_text(CAPPED), 1.0, 1.0, [0], [10], [0], [10], [True],
                              [0], dtype=torch.float64, device="cpu")
    lp = tlang.LangevinParams(dt=0.001, friction=0.0, kT=0.0)
    step = tce.make_step(params, lp, hill_stride=1, collect_records=True)
    state = tce.init_state(params, bs, torch.tensor([[x] for x in xs], dtype=torch.float64),
                           prng.PRNGKey(0), lp)
    log = HillsLog(str(tmp_path / "HOST_HILLS_0"), 1, params.total_volume)
    state, energies = run_simulation(step, state, n_steps=n_rounds, write_stride=2,
                                     hills_log=log)
    log.close()
    host = (tmp_path / "HOST_HILLS_0").read_text()
    assert host == (tmp_path / "API_HILLS_0").read_text()
    assert any(line.split()[1] == "b" for line in host.splitlines())
    assert abs(b.cum_bias - float(state.bias.cum_bias)) < 1e-12
    assert energies.shape == (2,)


# ------------------------------------------------------------ the cell host

N, KCAP, OCAP = 600, 24, 48
BENCH_CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
             "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
             "bias_sigma 0.1\n")
LP = dict(dt=0.002, friction=1.0, kT=0.0)
LJ = dict(epsilon=1.0, sigma=0.3, rcut=0.75)
STEP_KW = dict(hill_stride=10, rebuild_stride=10, hill_capacity=512, energy_stride=10,
               kernel_cap=KCAP, overflow_cap=OCAP, use_pallas=True)


@pytest.fixture(scope="module")
def cell_setup():
    """The bench configuration's semantics at 600 atoms (as
    ``test_torch_slice.py``): a clustered fluid whose first rebuild period
    runs the full-cap fallback (tail 49 > overflow_cap 48) and a drift
    along y that brings the tail under the cap at the step-9 rebuild."""
    cfg = parse_edm_text(BENCH_CFG)
    tspec = JGridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = JGrid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=jnp.float32, target=target)
    core = jpe.init_state(bs, jnp.asarray(clustered_points(N)), jax.random.PRNGKey(0),
                          n_est=N * 300)
    core = dataclasses.replace(core, v=jnp.zeros_like(core.x).at[:, 1].set(5.0))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    state = init_cell_state(spec, core, with_ids=False, kernel_cap=KCAP, overflow_cap=OCAP)
    assert bool(state.tail_ovf)
    return params, spec, state


def _port_steps(params, spec, **kw):
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    return [tpc.make_cell_step(to_port(params), tlang.LangevinParams(**LP), TLJ(**LJ), tspec,
                               **STEP_KW, **kw)]


def _outputs(d, prefix):
    return dict(bias_file=str(d / f"{prefix}BIAS"), histogram_file=str(d / f"{prefix}HIST"),
                lammps_table=str(d / f"{prefix}BIAS.ltab"), box_low=[0.0], box_high=[3.0])


def _numbers(path):
    """A text file's rows as float arrays (blank lines and headers out)."""
    rows = [ln.split() for ln in open(path).read().splitlines()]
    return [np.array([float(v) for v in r]) for r in rows
            if r and not r[0].startswith("#") and r[0] not in ("EDM", "N")]


def test_cell_host_run_simulation_matches_jax(cell_setup, tmp_path):
    params, spec, st = cell_setup
    jstep = make_cell_step(params, LangevinParams(**LP), LJParams(**LJ), spec,
                           collect_records=True, **STEP_KW)
    jlog = JHillsLog(str(tmp_path / "J_HILLS"), 1, params.total_volume)
    jst, je = j_run(jstep, st, 20, 10, hills_log=jlog, **_outputs(tmp_path, "J"))
    jlog.close()

    (tstep,) = _port_steps(params, spec, collect_records=True)
    tlog = HillsLog(str(tmp_path / "T_HILLS"), 1, to_port(params).total_volume)
    seen = []
    tst, te = run_simulation(tstep, to_port(st), 20, 10, hills_log=tlog,
                                      progress=lambda done, s, e: seen.append(done),
                                      **_outputs(tmp_path, "T"))
    tlog.close()
    assert seen == [10, 20]
    for f in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow"):
        assert_exact(getattr(tst, f), getattr(jst, f), f)
    for f in ("step", "last_calls", "hills_truncated"):
        assert_exact(getattr(tst.core, f), getattr(jst.core, f), f)
    assert_exact(tst.core.bias.steps, jst.core.bias.steps)
    for f in ("xs", "vs", "fs"):
        assert_forces(getattr(tst, f), getattr(jst, f), f)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5, atol=1e-5)
    assert float(te[0]) != 0.0
    np.testing.assert_allclose(float(tst.core.bias.cum_bias), float(jst.core.bias.cum_bias),
                               rtol=1e-6)
    grid = np.asarray(jst.core.bias.bias.grid.values)
    np.testing.assert_allclose(tst.core.bias.bias.grid.values.numpy(), grid, rtol=1e-5,
                               atol=1e-5 * max(1.0, np.abs(grid).max()))
    # the histogram was cleared at the last write, as in the reference
    assert float(tst.core.bias.cv_hist.values.abs().sum()) == 0.0
    # two hill rounds, logged line for line
    tl = (tmp_path / "T_HILLS").read_text().splitlines()
    jl = (tmp_path / "J_HILLS").read_text().splitlines()
    assert len(tl) == len(jl) > 0
    assert [ln.split()[:3] for ln in tl] == [ln.split()[:3] for ln in jl]
    assert {ln.split()[0] for ln in tl} == {"0", "1"}
    tn, jn = (np.array([[float(v) for v in ln.split()[3:]] for ln in x]) for x in (tl, jl))
    np.testing.assert_allclose(tn, jn, rtol=0, atol=1e-5 * max(1.0, np.abs(jn).max()))
    # the HILLS stream's bias_added column reconciles with cum_bias
    assert abs(tn[:, 2].sum() - float(tst.core.bias.cum_bias)) <= 1e-6 * float(
        tst.core.bias.cum_bias) + 1e-7 * len(tn)
    for name in ("BIAS", "HIST", "BIAS.ltab"):
        t, j = _numbers(tmp_path / f"T{name}"), _numbers(tmp_path / f"J{name}")
        assert len(t) == len(j) and all(a.shape == b.shape for a, b in zip(t, j)), name
        t, j = np.concatenate(t), np.concatenate(j)
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * max(1.0, np.abs(j).max()),
                                   err_msg=name)
    assert te.shape == (10,)


def test_dynamic_cell_step_matches_static(cell_setup):
    """The dynamic step (every ``static_do_*`` None) over 20 steps against
    the static phases through ``pattern_segment`` from the same state, on
    the CPU: every leaf bitwise, the energies too.  The first period runs
    K1 at full cap (``tail_ovf`` set), the second the reduced pass with K2;
    the dynamic step reads the counter once a call."""
    params, spec, st = cell_setup
    ts0 = to_port(st)
    (dyn,) = _port_steps(params, spec)
    phases = [_port_steps(params, spec, static_do_hills=h, static_do_energy=e,
                          static_do_rebuild=r)[0]
              for h, e, r in ((True, True, False), (False, False, False), (False, False, True))]
    ts_s, e_s = pattern_segment([(phases[0], 1), (phases[1], 8), (phases[2], 1)], 20)(ts0)
    ts_d, e_d = pattern_segment([(dyn, 1)], 20)(ts0)
    assert_tree(ts_d, ts_s, 0.0, "dynamic vs static")
    assert ts_d.tail_ovf_host == ts_s.tail_ovf_host is False and ts_d.kernel_cap == KCAP
    assert_exact(e_d, e_s)
    assert int(ts_d.tail_fallbacks) == 1
    assert dyn.host_syncs == 20 + sum(p.host_syncs for p in phases)
    # a step dynamic in one phase only fits where its static phases fit
    (half,) = _port_steps(params, spec, static_do_hills=False)
    with pytest.raises(ValueError, match="hill"):
        pattern_segment([(half, 10)], 10)
