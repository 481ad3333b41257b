"""PyTorch port: the sampled g(r) at kT = 0.8 against the JAX package's.

Every other port test pins trajectories at kT = 0 or single steps; this
one shows that the port samples what JAX samples.  ``bench.py:
bench_pairwise``'s configuration at 600 atoms (the first 600 sites of a
9^3 lattice, a = 1.26, box 11.34^3, cells 3^3; the well-tempered,
RDF-targeted bias on its 151-point grid; energy stride 10, the hills / 8
plain / rebuild cycle): the port's default route (``use_pallas=True``,
kernel_cap 24, overflow_cap 32; on the CPU the kernels' plain versions;
at 22 atoms a cell the tail stays above overflow_cap, so every period
runs K1 at full cap) against the JAX host's XLA pass (``use_pallas=False``, jitted), from the
same state and key.  50 warm-up steps, then 300 measured steps with the
positions sampled every 10 (the minimum-image pair distances binned by
0.05 up to 3.0) and the accepted-hill histogram ``bias.cv_hist`` of those
steps.  Float32 trajectories part within ~15 steps, so the bound is
calibrated in the test: JAX runs a second time with another key, and each
histogram (normalized) must lie within L1(port, JAX) <= 2 L1(JAX, JAX') +
its floor.  Both runs must also pass the bench's checks: finite, no cell
overflow, no truncated round, cum_bias > 0.  The two JAX runs take two
threads of this process while the port runs in the main one (the JAX
host's XLA pass takes ~0.2 s a step on one CPU core).  ``cell_chunk`` is
27, the lattice's cells in one chunk (the bench's 81 would pad the JAX
pass to 81 cells; the port does not read it).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import torch

from _torch_parity import np_, to_port
from edm_tpu import bias as JB
from edm_tpu.grid import Grid, GridSpec
from edm_tpu.models import pair_edm
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.driver import pattern_segment as jax_pattern_segment
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from test_torch_slice import BENCH_CFG, PHASES

N, A, SIDE = 600, 1.26, 9
LP = dict(dt=0.002, friction=1.0, kT=0.8)
LJ = dict(epsilon=1.0, sigma=1.0, rcut=2.5)
KW = dict(hill_stride=10, rebuild_stride=10, hill_capacity=2048, cell_chunk=27, energy_stride=10)
WARM, MEASURED, EVERY = 50, 300, 10
EDGES = np.linspace(0.0, 3.0, 61)
# the floors under the calibrated bounds: the L1 two independent samples of
# this size may differ by beyond twice a lucky small JAX-JAX' distance
GOFR_FLOOR, HIST_FLOOR = 0.02, 0.1


def _setup():
    """The JAX host's initial state and its params/spec (bench_pairwise at
    N atoms)."""
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    target = Grid(values=jnp.asarray(tvals, jnp.float32), derivs=None, spec=tspec)
    params, bs = JB.subdivide(parse_edm_text(BENCH_CFG), 1.0, 1.0, [0], [3.0], [0], [3.0],
                              [False], [0], dtype=jnp.float32, target=target)
    pts = (np.stack(np.meshgrid(*[np.arange(SIDE)] * 3, indexing="ij"), -1).reshape(-1, 3)[:N]
           * A + 0.5 * A).astype(np.float32)
    box = [SIDE * A] * 3
    core = pair_edm.init_state(bs, jnp.asarray(pts), jax.random.PRNGKey(0), n_est=N * 40)
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=N)
    return params, spec, core


def _pair_hist(x, box):
    """The minimum-image pair distances of ``x`` (n, 3), each pair once,
    counted in the bins of EDGES."""
    x = np.asarray(x, np.float64)
    d = x[:, None] - x[None]
    d -= np.round(d / box) * box
    r = np.sqrt((d * d).sum(-1))[np.triu_indices(len(x), 1)]
    return np.histogram(r, EDGES)[0].astype(np.float64)


def _sample(seg, state, xs_of, box):
    """MEASURED steps in segments of EVERY: the summed pair histogram of the
    positions after each segment, and the end state."""
    hist = 0.0
    for _ in range(MEASURED // EVERY):
        state, _ = seg(state)
        hist = hist + _pair_hist(xs_of(state), box)
    return hist / hist.sum(), state


def _norm(h):
    h = np.asarray(h, np.float64)
    return h / h.sum()


def _checks(xs, table_overflow, core):
    assert np.isfinite(np.asarray(xs)).all()
    assert not bool(np.asarray(table_overflow))
    assert not bool(np.asarray(core.hills_truncated))
    assert float(np.asarray(core.bias.cum_bias)) > 0


def _jax_segment(params, spec):
    """The JAX host's stride cycle (the XLA pass), jitted."""
    steps = [make_cell_step(params, LangevinParams(**LP), LJParams(**LJ), spec, use_pallas=False,
                            **KW, **ph) for ph in PHASES]
    return jax.jit(jax_pattern_segment([(steps[0], 1), (steps[1], 8), (steps[2], 1)], EVERY))


def _jax_run(seg, spec, state, key):
    state = dataclasses.replace(state, core=dataclasses.replace(state.core, key=key))
    for _ in range(WARM // EVERY):
        state, _ = seg(state)
    b = state.core.bias
    state = dataclasses.replace(state, core=dataclasses.replace(
        state.core, bias=dataclasses.replace(b, cv_hist=b.cv_hist.clear())))

    def xs_of(s):
        return np.asarray(s.xs).reshape(-1, 3)[np.asarray(s.mc).reshape(-1) > 0.5]

    g, state = _sample(seg, state, xs_of, np.asarray(spec.box))
    _checks(state.xs, state.table_overflow, state.core)
    return g, _norm(state.core.bias.cv_hist.values)


def _port_run(params, spec, core):
    tspec = tcells.CellSpec(**dataclasses.asdict(spec))
    state = tpc.init_cell_state(tspec, to_port(core), kernel_cap=24, overflow_cap=32)
    steps = [tpc.make_cell_step(to_port(params), TLP(**LP), TLJ(**LJ), tspec, use_pallas=True,
                                kernel_cap=24, overflow_cap=32, **KW, **ph) for ph in PHASES]
    pat = [(steps[0], 1), (steps[1], 8), (steps[2], 1)]
    state, _ = pattern_segment(pat, WARM)(state)
    b = state.core.bias
    state = dataclasses.replace(state, core=dataclasses.replace(
        state.core, bias=dataclasses.replace(b, cv_hist=b.cv_hist.clear())))

    def xs_of(s):
        return np_(s.xs).reshape(-1, 3)[np_(s.mc).reshape(-1) > 0.5]

    g, state = _sample(pattern_segment(pat, EVERY), state, xs_of, np.asarray(spec.box))
    _checks(np_(state.xs), np_(state.table_overflow), state.core)
    return g, _norm(np_(state.core.bias.cv_hist.values))


def _in_threads(fns):
    """Start each of ``fns`` in a thread; returns a function that waits for
    them and gives their results in order (raising the first failure)."""
    out, errs = [None] * len(fns), []

    def run(i, fn):
        try:
            out[i] = fn()
        except Exception as e:  # raised again by join, in the test's thread
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in threads:
        t.start()

    def join():
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out

    return join


def test_sampled_gofr_matches_jax():
    params, spec, core = _setup()
    assert spec.ncells == (3, 3, 3)
    jstate = init_cell_state(spec, core)
    seg = _jax_segment(params, spec)
    seg.lower(jstate).compile()
    join = _in_threads([lambda: _jax_run(seg, spec, jstate, core.key),
                        lambda: _jax_run(seg, spec, jstate, jax.random.PRNGKey(1))])
    g_port, h_port = _port_run(params, spec, core)
    (g_jax, h_jax), (g_jax2, h_jax2) = join()
    for what, (p, j, j2), floor in (("g(r)", (g_port, g_jax, g_jax2), GOFR_FLOOR),
                                    ("cv_hist", (h_port, h_jax, h_jax2), HIST_FLOOR)):
        l1, l1_keys = np.abs(p - j).sum(), np.abs(j - j2).sum()
        print(f"{what}: L1(port, JAX) {l1:.4f}, L1(JAX, JAX with another key) {l1_keys:.4f}, "
              f"bound 2 x {l1_keys:.4f} + {floor} = {2 * l1_keys + floor:.4f}")
        assert l1 <= 2 * l1_keys + floor, what
