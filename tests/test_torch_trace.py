"""PyTorch port: the spans and counters of ``edm_tpu_torch.utils.trace``.

One stride cycle (1 hill + 8 plain + 1 rebuild step, ``pattern_segment``)
of the cell host at the sizes of ``test_torch_cellstep.py`` (600 atoms,
cap 56, 3^3 cells), on the CPU through the kernels' plain versions: the
static phases with and without ``kernel_cap`` (the first period falls back
to full cap, so its rebuild is a full one and reads ``tail_ovf``), the
dynamic step, and the Chebyshev lookup.  Tracing changes nothing the
steps compute, off it leaves nothing on a profile, and on each step's
span holds its parts; the counters of the hill rounds are the sums of the
rounds' records.
"""

import gc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from edm_tpu_torch import bias as B
from edm_tpu_torch.grid import Grid, GridSpec
from edm_tpu_torch.models import pair_edm
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.cells import CellSpec
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils import trace
from edm_tpu_torch.utils.config import parse_edm_text

N, KCAP, OCAP = 600, 24, 48
CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step {bps}\n"
       "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
       "bias_sigma 0.1\n")
STATIC = [dict(static_do_hills=True, static_do_energy=True, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=False),
          dict(static_do_hills=False, static_do_energy=False, static_do_rebuild=True)]
# (name, kernel_cap, dynamic step, Chebyshev lookup)
CASES = [("static_kcap", True, False, False), ("static_full", False, False, False),
         ("dynamic", True, True, False), ("chebyshev", False, False, True)]
STEP_CHILDREN = {"edm.baoab", "edm.force", "edm.collect", "edm.round", "edm.refit",
                 "edm.rebuild"}


@pytest.fixture(autouse=True)
def _off():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _setup(kcap=True, cheb=False, bps=1.0, buffer_size=2048, collect_records=False,
           hill_stride=10):
    """The clustered 600-atom fluid of ``test_torch_slice.py``, built
    through the port's entry points, and the steps of one stride cycle."""
    cfg = parse_edm_text(CFG.format(bps=bps))
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tvals = -2.0 * np.log(np.maximum(tspec.min[0] + tspec.dx[0] * np.arange(tspec.nbins[0]),
                                     0.5))
    target = Grid(values=torch.tensor(tvals, dtype=torch.float32), derivs=None, spec=tspec,
                  interpolate=False)
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float32, device="cpu", target=target,
                             buffer_size=buffer_size)
    rng = np.random.default_rng(5)
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=N, replace=False, p=w / w.sum())
    pts = torch.tensor(gridpts[sel] + rng.uniform(-0.04, 0.04, (N, 3)), dtype=torch.float32)
    core = pair_edm.init_state(bs, pts, PRNGKey(0), n_est=N * 300,
                               pair_lookup="chebyshev" if cheb else "interp", cheb_deg=16)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    caps = dict(kernel_cap=KCAP, overflow_cap=OCAP) if kcap else {}
    state = tpc.init_cell_state(spec, core, **caps)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    lj = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)

    def make(**ph):
        return tpc.make_cell_step(params, lp, lj, spec, hill_stride, hill_capacity=512,
                                  energy_stride=10, use_pallas=True,
                                  collect_records=collect_records, **caps, **ph)
    return state, make


def _cycle(case):
    """(state, segment of one cycle, its steps)."""
    _, kcap, dynamic, cheb = case
    state, make = _setup(kcap, cheb)
    if dynamic:
        steps = [make()]
        return state, pattern_segment([(steps[0], 10)], 10), steps
    steps = [make(**ph) for ph in STATIC]
    return state, pattern_segment([(steps[0], 1), (steps[1], 8), (steps[2], 1)], 10), steps


def _leaves(obj):
    """Every tensor and number of a state or output, in order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, np.ndarray):
        return [torch.from_numpy(obj)]
    if hasattr(obj, "__dataclass_fields__"):
        return [x for f in obj.__dataclass_fields__ for x in _leaves(getattr(obj, f))]
    if isinstance(obj, (tuple, list)):
        return [x for o in obj for x in _leaves(o)]
    return [] if obj is None else [torch.tensor(obj)]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tracing_changes_nothing(case):
    runs = []
    for on in (False, True):
        trace.enable(on)
        state, seg, _ = _cycle(case)
        runs.append(_leaves(seg(state)))
    off, on = runs
    assert len(off) == len(on)
    for a, b in zip(off, on):
        assert torch.equal(a, b)


def test_off_leaves_no_trace():
    assert trace.span("edm.force") is trace.span(trace.ROUND)  # the shared no-op
    state, seg, _ = _cycle(CASES[0])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg(state)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert "aten::add" in names or any(n.startswith("aten::") for n in names)
    assert not [n for n in names if n.startswith("edm.")]
    assert trace.report() == {"spans": {}, "counters": {}}


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_span_tree(case):
    name, kcap, dynamic, cheb = case
    state, seg, steps = _cycle(case)
    syncs0 = sum(s.host_syncs for s in steps)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg(state)
    rep = trace.report()
    sp, ctr = rep["spans"], rep["counters"]
    rise = sum(s.host_syncs for s in steps) - syncs0

    def n(span, parent):
        return sp.get(span, {}).get(parent, {}).get("count", 0)

    assert n("edm.segment", "") == 1
    phases = (["dynamic"] * 10 if dynamic else ["hill"] + ["plain"] * 8 + ["rebuild"])
    for ph in set(phases):
        assert n(f"edm.step.{ph}", "edm.segment") == phases.count(ph)
    step_names = {f"edm.step.{ph}" for ph in phases}
    # each step: BAOAB twice (the pre-force stages, the velocity finish), the force once
    for child, per_step in (("edm.baoab", 2), ("edm.force", 1)):
        assert sum(n(child, s) for s in step_names) == 10 * per_step
    hill = "edm.step.dynamic" if dynamic else "edm.step.hill"
    rebuild = "edm.step.dynamic" if dynamic else "edm.step.rebuild"
    assert n("edm.collect", hill) == n("edm.round", hill) == 1
    assert n("edm.refit", hill) == int(cheb)
    assert n("edm.rebuild", rebuild) == 1
    # no other direct child of a step
    for s in step_names:
        assert {k for k, v in sp.items() if s in v} <= STEP_CHILDREN | {
            "edm.read.step_phase", "edm.gc"}
    assert n("edm.force.table", "edm.force") == 10
    assert n("edm.force.k1", "edm.force") == 10
    # the first period falls back to full cap: no tail pass
    assert n("edm.force.tail", "edm.force") == 0
    for child in ("pass1", "pass2"):
        assert n(f"edm.collect.{child}", "edm.collect") == 1
    for child in ("drain", "heights", "limiter", "deposit"):
        assert n(f"edm.round.{child}", "edm.round") == 1
    assert n("edm.rebuild.plan", "edm.rebuild") == 1
    full = n("edm.rebuild.full", "edm.rebuild")
    assert full + n("edm.rebuild.rebin", "edm.rebuild") == 1
    assert ctr.get("rebuild.full", 0) == full and ctr.get("rebuild.rebin", 0) == 1 - full
    if kcap:
        assert full == 1 and n("edm.read.tail_ovf", "edm.rebuild.full") == 1
    assert ctr["rounds"] == 1 and ctr["limiter.passes"] >= 1
    # every read the steps counted is a read span, and a reads.<site> counter
    reads = {k: sum(v["count"] for v in p.values()) for k, p in sp.items()
             if k.startswith("edm.read.")}
    assert sum(reads.values()) == rise
    assert reads == {"edm.read." + k[6:]: v for k, v in ctr.items() if k.startswith("reads.")}
    assert reads.get("edm.read.step_phase", 0) == (10 if dynamic else 0)
    assert reads["edm.read.limiter"] == ctr["limiter.passes"] + 1
    assert reads["edm.read.rebin_feasible"] == 1
    # self time is the host time less the children's, never negative
    for parents in sp.values():
        for v in parents.values():
            assert 0 <= v["self_ns"] <= v["host_ns"]
    # the profiler holds the spans, nested as recorded
    ev = [e for e in prof.profiler.kineto_results.events() if e.name().startswith("edm.")]
    assert sum(e.name() in step_names for e in ev) == 10
    assert sum(e.name() == "edm.round" for e in ev) == 1
    seg_ev = next(e for e in ev if e.name() == "edm.segment")
    for e in ev:
        if e.name() != "edm.gc":
            assert seg_ev.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= seg_ev.start_ns() + seg_ev.duration_ns()


@pytest.mark.parametrize("bps,buffer_size", [(1.0, 2048), (1e-5, 2048), (1e-5, 16)],
                         ids=["no_cap", "deferred", "dropped"])
def test_hill_counters_match_records(bps, buffer_size):
    """Two hill rounds (hill_stride 5), the second with a drain: the device
    counters are the sums of the rounds' records."""
    state, make = _setup(bps=bps, buffer_size=buffer_size, collect_records=True, hill_stride=5)
    hill, plain, rebuild = (make(**ph) for ph in STATIC)
    hill5 = make(static_do_hills=True, static_do_energy=False, static_do_rebuild=False)
    seg = pattern_segment([(hill, 1), (plain, 4), (hill5, 1), (plain, 3), (rebuild, 1)], 10)
    trace.enable()
    _, (_, logs) = seg(state)
    ctr = trace.report()["counters"]
    rec, happened = logs.rec, logs.happened
    assert int(happened.sum()) == ctr["rounds"] == 2
    assert ctr["hills.called"] == int(rec.hill_called.sum()) > 0
    assert ctr["hills.deposited"] == int(rec.hill_deposited.sum()) > 0
    assert ctr["hills.deferred"] == int((rec.hill_defer_h > 0).sum())
    assert ctr["hills.drained"] == int(rec.drain_processed.sum())
    assert ctr["rounds.skipped"] == int((rec.skipped & happened).sum())
    deferred0 = int((rec.hill_defer_h[0] > 0).sum())
    if bps < 1:  # the cap defers most hills; the second round drains and skips
        assert deferred0 > 16 and ctr["hills.drained"] > 0 and ctr["rounds.skipped"] == 1
    assert ctr["hills.dropped"] == max(0, deferred0 - buffer_size)
    trace.reset()
    assert trace.report() == {"spans": {}, "counters": {}}


def test_gc_in_a_step_is_a_span(monkeypatch):
    state, seg, _ = _cycle(CASES[1])
    table = tpc.hermite_pair_table

    def collecting(gg):
        gc.collect()
        return table(gg)

    monkeypatch.setattr(tpc, "hermite_pair_table", collecting)
    trace.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        seg(state)
    sp = trace.report()["spans"]
    assert sp["edm.gc"]["edm.force.table"]["count"] >= 10
    assert any(e.name() == "edm.gc" for e in prof.profiler.kineto_results.events())
    trace.enable(False)
    assert trace._gc_hook not in gc.callbacks


def test_pass_gate_read():
    """A two-pass round on a 1-D bias: the second pass's gate is a read
    span, and the round's count of reads equals its read spans."""
    cfg = parse_edm_text(CFG.format(bps=1.0))
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float64, device="cpu")
    pos = torch.linspace(0.5, 2.5, 8, dtype=torch.float64)[:, None]
    u = torch.zeros(8, dtype=torch.float64)
    trace.enable()
    _, _, reads = B.add_hills_round(params, bs, pos, u, 1000.0, n_passes=2)
    sp = trace.report()["spans"]
    got = sum(v["count"] for k, p in sp.items() if k.startswith("edm.read.") for v in p.values())
    assert got == reads
    assert sp["edm.read.pass_gate"]["edm.round"]["count"] == 1
    assert sp["edm.round.limiter"]["edm.round"]["count"] == 2


def test_counters_and_reads():
    class Owner:
        host_syncs = 0

    o = Owner()
    t = torch.tensor([True, False, True])
    assert trace.read(o, "limiter", t[0]) is True and o.host_syncs == 1
    trace.count("x")
    trace.count_device("y", t)
    assert trace.report() == {"spans": {}, "counters": {}}
    trace.enable()
    assert trace.read(o, "step_phase", torch.tensor(7)) == 7 and o.host_syncs == 2
    assert trace.read(None, "mcgdp_strips", torch.tensor([3, 4])) == [3, 4]
    trace.count("x")
    trace.count("x", 2)
    trace.count_device("y", t)
    trace.count_device("y", t[0])
    trace.count_device("z", torch.tensor(5))
    rep = trace.report()
    assert rep["counters"] == {"reads.step_phase": 1, "reads.mcgdp_strips": 1, "x": 3,
                               "y": 3, "z": 5}
    assert rep["spans"]["edm.read.step_phase"][""]["count"] == 1
    with trace.span("edm.a"):
        with trace.span("edm.b"):
            pass
        with trace.span("edm.b"):
            pass
    sp = trace.report()["spans"]
    assert sp["edm.b"]["edm.a"]["count"] == 2
    a = sp["edm.a"][""]
    assert a["self_ns"] == a["host_ns"] - sp["edm.b"]["edm.a"]["host_ns"]
    trace.reset()
    assert trace.report() == {"spans": {}, "counters": {}}
