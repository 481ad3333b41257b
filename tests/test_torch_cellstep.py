"""PyTorch port: the cell host's step builder and its thermostat.

``make_cell_step`` takes the JAX signature and defaults, so
``bench.py:bench_pairwise``'s keyword arguments build both hosts' three
static phases.  One step at kT = 0.8 from the same converted state and key
pins the thermostat noise's keying by global slot row (the JAX host's
``hashrng.normal_rows_cols``): positions within 4 float32 ulps of max|x|,
velocities within 1e-5 * max(1, max|v|) (the two packages' Box-Muller
``log``/``cos`` differ by float32 rounding, ``test_torch_rng.py``), forces
within 2e-5 * max(1, max|f|).
"""

import dataclasses

import jax
import numpy as np

from _torch_parity import assert_exact, assert_forces, np_, to_port
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import make_cell_step
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from test_torch_slice import PHASES, _jax_setup

# bench.py:130-146 (the 10k cell's kernel_cap and overflow_cap)
BENCH_KW = dict(hill_stride=10, rebuild_stride=10, hill_capacity=2048, cell_chunk=81,
                use_pallas=True, energy_stride=10, kernel_cap=24, overflow_cap=32)
LJ_ARGS = dict(epsilon=1.0, sigma=0.3, rcut=0.75)


def test_make_cell_step_takes_bench_kwargs():
    params, spec, _ = _jax_setup()
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    jsteps = [make_cell_step(params, lp, LJParams(**LJ_ARGS), spec, **BENCH_KW, **ph)
              for ph in PHASES]
    assert all(callable(s) for s in jsteps)
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    tsteps = [tpc.make_cell_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.8),
                                 TLJ(**LJ_ARGS), tspec, **BENCH_KW, **ph) for ph in PHASES]
    assert [s.strides for s in tsteps] == [(10, 10, 10)] * 3
    assert [s.kernel_cap for s in tsteps] == [24] * 3
    # the bench's 1 + 8 + 1 cycle is where the strides put each phase
    pattern_segment([(tsteps[0], 1), (tsteps[1], 8), (tsteps[2], 1)], 20)


def test_cell_step_kT08_matches_jax_one_step():
    params, spec, st = _jax_setup()
    kw = dict(hill_capacity=512, energy_stride=10, kernel_cap=24, overflow_cap=48)
    jstep = jax.jit(make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.8),
                                   LJParams(**LJ_ARGS), spec, hill_stride=10, rebuild_stride=10,
                                   use_pallas=True, **kw, **PHASES[1]))
    tstep = tpc.make_cell_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.8),
                               TLJ(**LJ_ARGS), tcells.CellSpec(**dataclasses.asdict(spec)), 10,
                               use_pallas=True, **kw, **PHASES[1])
    ts = to_port(st)
    st1, _ = jstep(st, None)
    ts1, _ = tstep(ts)
    # the noise moved the velocities: the draw is not multiplied away
    dv = np.abs(np.asarray(st1.vs) - np.asarray(st.vs)).max()
    assert dv > 1e-2
    xs, ref = np_(ts1.xs).astype(np.float64), np.asarray(st1.xs, np.float64)
    ulp = np.spacing(np.float32(np.abs(ref).max()))
    assert np.abs(xs - ref).max() <= 4 * ulp
    vs, vref = np_(ts1.vs).astype(np.float64), np.asarray(st1.vs, np.float64)
    assert np.abs(vs - vref).max() <= 1e-5 * max(1.0, np.abs(vref).max())
    assert_forces(ts1.fs, st1.fs, "fs")
    assert_exact(ts1.core.step, st1.core.step, "step")
    np.testing.assert_array_equal(ts1.core.key, np.asarray(st1.core.key))
