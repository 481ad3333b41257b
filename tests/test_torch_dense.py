"""PyTorch port: the dense all-pairs pair host against the JAX package.

The same numpy inputs go through ``edm_tpu.models.pair_edm`` (float64, as
``tests/conftest.py`` sets x64) and its port on the CPU:

  - ``prng.fold_in`` and ``prng.threefry_rows`` bitwise against
    ``jax.random.fold_in`` + ``uniform``, float32 and float64, for unsorted
    row ids with repeats (pass 2's clamped padding rows);
  - ``lj.pair_displacements`` and ``lj.lj_energy_forces`` to 1e-12;
  - ``make_step`` step for step over 20 kT = 0 steps in float64 on
    test_md's 64-atom box (jittered, with random velocities): the exact
    Hermite lookup through the static phases, the Chebyshev table and the
    typed CV through the dynamic step; x, v, f, the grid and the energy to
    1e-12 relative, ``step``, ``last_calls``, ``hills_truncated``, the key
    and the bias counters exactly;
  - one kT = 0.8 step in float32: PyTorch's ``erfinv`` differs from XLA's
    by a few ulps (``ops/prng.py``), so the thermostat normals, and with
    them x and v, are held within 1e-5 of max(1, max|.|), forces within
    2e-5 * max(1, max|f|);
  - ``run_simulation`` with a ``HillsLog`` (the JAX
    ``test_pair_host_collect_records``), an exact checkpoint resumed into a
    fresh template (``test_checkpoint.py``) and the pair run with a target
    file (``test_workflows.py``), the port's files against JAX's number by
    number.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, assert_f64, assert_tree, np_, to_port
from edm_tpu import bias as JB
from edm_tpu.models import lj as jlj
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import lj as tlj
from edm_tpu_torch.models import pair_edm as tpe
from edm_tpu_torch.models.driver import strided_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.ops import prng

PAIR_CFG = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
            "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
A = 1.26
BOX = [4 * A] * 3
CHEB = dict(cheb_deg=16, cheb_panels=4)
F32_REL = 1e-5  # kT = 0.8, float32: the erfinv normals' few ulps
TYPE_PAIR = (1, 2)


def lattice(seed=3, jitter=0.08, side=4):
    """test_md's 4^3 lattice (a = 1.26), jittered, and random velocities."""
    rng = np.random.default_rng(seed)
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
           * A + 0.5 * A)
    return pts + rng.uniform(-jitter, jitter, pts.shape), rng.normal(0.0, 0.5, pts.shape)


def types64(n=64):
    t = np.ones(n, np.int32)
    t[: n // 2] = 2  # half type 2, as test_md's type test
    return t


def jax_pair_setup(dtype=jnp.float64, kT=0.0, pair_lookup="interp", key=0, cfg=PAIR_CFG,
                   jitter=0.08):
    """(params, state) of the JAX dense host on the jittered lattice."""
    params, bs = JB.subdivide(parse_edm_text(cfg), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], dtype=dtype)
    x0, v0 = lattice(jitter=jitter)
    st = jpe.init_state(bs, jnp.asarray(x0, dtype), jax.random.PRNGKey(key),
                        pair_lookup=pair_lookup, **CHEB)
    return params, dataclasses.replace(st, v=jnp.asarray(v0, dtype))


def assert_pair_states(port, ref, rtol, what):
    """Every leaf of two PairEDMStates (the Chebyshev table too): floats to
    ``rtol`` of max(1, max|.|), the rest exactly."""
    assert_tree(port, ref, rtol, what)


def run_both(jsteps, tsteps, st, ts, n_steps, phase, rtol=1e-12):
    """``n_steps`` steps of both hosts from converted states, ``phase(i)``
    picking the step; every state and energy held step by step."""
    for i in range(n_steps):
        st, e = jsteps[phase(i)](st, None)
        ts, te = tsteps[phase(i)](ts)
        assert_pair_states(ts, st, rtol, f"step {i}")
        assert_f64(te, e, f"step {i} energy", rtol=rtol)
    return st, ts


# ---------------------------------------------------------------- the draws


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_row_uniforms_bitwise(dtype):
    key = jax.random.PRNGKey(11)
    rows = np.array([7, 0, 63, 63, 63, 12, 3, 2**31 - 1], np.int32)  # clamped repeats
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax.vmap(lambda k: jax.random.uniform(k, (97,), jd))(
        jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(rows)))
    got = prng.threefry_rows(np.asarray(key, np.uint32), torch.as_tensor(rows), 97, td)
    assert got.dtype == td and got.shape == (len(rows), 97)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for d in (0, 1, 5, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(np.asarray(key, np.uint32), d),
                                      np.asarray(jax.random.fold_in(key, np.uint32(d))))


def test_lj_helpers_match_jax():
    x0, _ = lattice(jitter=0.3)
    disp, r = jlj.pair_displacements(jnp.asarray(x0), BOX)
    tdisp, tr = tlj.pair_displacements(torch.as_tensor(x0), BOX)
    assert_f64(tdisp, disp, "disp")
    assert np.isinf(np_(tr).diagonal()).all()
    fin = np.isfinite(np.asarray(r))
    np.testing.assert_array_equal(np.isfinite(np_(tr)), fin)
    assert_f64(np_(tr)[fin], np.asarray(r)[fin], "r")
    for lj in (LJParams(), LJParams(epsilon=0.7, sigma=1.1, rcut=1.4)):
        e, f = jlj.lj_energy_forces(lj, disp, r)
        te, tf = tlj.lj_energy_forces(tlj.LJParams(**dataclasses.asdict(lj)), tdisp, tr)
        assert_f64(te, e, "energy")
        assert_f64(tf, f, "forces")


# ---------------------------------------------------------------- the step


@pytest.fixture(scope="module")
def zero_temperature():
    """The JAX steps of each case, built and jitted once: the exact lookup
    as static hill / plain phases, the Chebyshev table and the typed CV as
    the dynamic step (its lax.cond)."""
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    cases = {}
    for name, lookup, typed in (("exact", "interp", False), ("chebyshev", "chebyshev", False),
                                ("typed", "interp", True)):
        params, st = jax_pair_setup(pair_lookup=lookup)
        kw = dict(hill_stride=5, hill_capacity=2048)
        if typed:
            kw.update(types=types64(), type_pair=TYPE_PAIR)
        phases = (True, False) if name == "exact" else (None,)
        jsteps = [jax.jit(jpe.make_step(params, lp, LJParams(), BOX, static_do_hills=h, **kw))
                  for h in phases]
        cases[name] = (params, st, kw, phases, jsteps)
    return cases


@pytest.mark.parametrize("case", ["exact", "chebyshev", "typed"])
def test_dense_step_matches_jax(zero_temperature, case):
    params, st, kw, phases, jsteps = zero_temperature[case]
    tparams = to_port(params)
    tsteps = [tpe.make_step(tparams, TLP(dt=0.002, friction=1.0, kT=0.0), tlj.LJParams(), BOX,
                            static_do_hills=h, **kw) for h in phases]
    ts = to_port(st)
    if case == "exact":
        st, ts = run_both(jsteps, tsteps, st, ts, 20, lambda i: int(i % 5 != 0))
        # two host reads a hill round (the capping loop), none on plain steps
        assert tsteps[1].host_syncs == 0 and tsteps[0].host_syncs >= 4
    else:
        st, ts = run_both(jsteps, tsteps, st, ts, 20, lambda i: 0)
        assert tsteps[0].host_syncs >= 20  # the counter, every call
    assert int(st.bias.steps) == 4 and float(st.bias.cum_bias) > 0
    assert not bool(st.hills_truncated)


def test_typed_cv_counts_cross_pairs_only(zero_temperature):
    """The typed step's candidates are the cross-type ordered pairs within
    the CV domain (test_md's type test)."""
    params, st, kw, _, _ = zero_temperature["typed"]
    lp = TLP(dt=0.002, friction=1.0, kT=0.0)
    ts = to_port(st)
    typed = tpe.make_step(to_port(params), lp, tlj.LJParams(), BOX, static_do_hills=True, **kw)
    kw_all = {k: v for k, v in kw.items() if k not in ("types", "type_pair")}
    every = tpe.make_step(to_port(params), lp, tlj.LJParams(), BOX, static_do_hills=True,
                          **kw_all)
    n12, n_all = int(typed(ts)[0].last_calls), int(every(ts)[0].last_calls)
    _, r = tlj.pair_displacements(typed(ts)[0].x, BOX)
    t = torch.as_tensor(types64())
    cross = (t[:, None] != t[None, :]) & (r < 3.0)
    assert n12 == int(cross.sum()) and 0 < n12 < n_all


def test_dense_step_kT08_one_step():
    params, st = jax_pair_setup(dtype=jnp.float32, kT=0.8)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    jstep = jax.jit(jpe.make_step(params, lp, LJParams(), BOX, hill_stride=5, hill_capacity=512))
    tstep = tpe.make_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.8), tlj.LJParams(),
                          BOX, hill_stride=5, hill_capacity=512)
    st1, e = jstep(st, None)
    ts1, te = tstep(to_port(st))
    assert_tree(ts1, st1, F32_REL, "kT=0.8 step")
    assert_f64(te, e, "energy", rtol=F32_REL)
    assert int(st1.bias.steps) == 1


def test_make_step_options():
    params, _ = jax_pair_setup()
    args = (to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), tlj.LJParams(), BOX, 5)
    # ported since: axis_name sums the rounds' bias over a mesh
    assert tpe.make_step(*args, axis_name="dp").axis_name == "dp"
    with pytest.raises(ValueError, match="hill_stride"):
        tpe.make_step(*args[:4], 0)
    hill = tpe.make_step(*args, static_do_hills=True)
    plain = tpe.make_step(*args, static_do_hills=False)
    strided_segment(hill, plain, 5, 10)
    with pytest.raises(ValueError, match="hill step"):
        strided_segment(plain, hill, 5, 10)


# ------------------------------------------------ run_simulation, checkpoints


RECORDS_CFG = ("tempering 0\nhill_prefactor 0.5\nbias_per_step 1.0\nhill_density -1\n"
               "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")


def _word(w):
    try:
        return float(w)
    except ValueError:
        return w


def _numbers(path):
    return [[_word(w) for w in line.split()]
            for line in open(path).read().strip().splitlines()]


def _same_numbers(a, b, rtol=1e-9):
    """Two text files of numbers, line by line: words equal, numbers within
    ``rtol`` of the file's largest (two runs' -0.0 and 0.0 print apart)."""
    na, nb = _numbers(a), _numbers(b)
    assert len(na) == len(nb) and na
    scale = max(1.0, max(abs(w) for row in nb for w in row if isinstance(w, float)))
    for ra, rb in zip(na, nb):
        assert len(ra) == len(rb)
        for wa, wb in zip(ra, rb):
            if isinstance(wb, float):
                assert abs(wa - wb) <= rtol * scale, (ra, rb)
            else:
                assert wa == wb, (ra, rb)


def test_run_simulation_hills_log_matches_jax(tmp_path):
    """``test_hills_host_logging.py``'s 8-atom float64 pair host (kT = 0
    here, so both packages take the same trajectory) through both
    ``run_simulation``s with a ``HillsLog`` and every output file: the final
    state to 1e-12, the HILLS, bias, histogram and .ltab files number by
    number, the HILLS bias_added column summing to cum_bias."""
    from edm_tpu.models.driver import run_simulation as j_run
    from edm_tpu.utils.hills_log import HillsLog as JHillsLog
    from edm_tpu_torch.models.driver import run_simulation
    from edm_tpu_torch.utils.hills_log import HillsLog

    x0 = np.random.default_rng(0).uniform(0.5, 3.5, (8, 3))
    params, bs = JB.subdivide(parse_edm_text(RECORDS_CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], dtype=jnp.float64)
    st = jpe.init_state(bs, jnp.asarray(x0), jax.random.PRNGKey(1))
    kw = dict(hill_stride=2, hill_capacity=128, collect_records=True)
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    jstep = jpe.make_step(params, LangevinParams(**lp), LJParams(rcut=1.4), [4.0] * 3, **kw)
    tstep = tpe.make_step(to_port(params), TLP(**lp), tlj.LJParams(rcut=1.4), [4.0] * 3, **kw)
    ts = to_port(st)
    outs = {}
    for tag, run, log_cls, step, state, p in (("J", j_run, JHillsLog, jstep, st, params),
                                             ("T", run_simulation, HillsLog, tstep, ts, params)):
        log = log_cls(str(tmp_path / f"{tag}_HILLS"), 1, p.total_volume)
        kw_files = dict(bias_file=str(tmp_path / f"{tag}.bias"),
                        histogram_file=str(tmp_path / f"{tag}.hist"),
                        lammps_table=str(tmp_path / f"{tag}.ltab"), box_low=[0], box_high=[3.0])
        outs[tag] = run(step, state, n_steps=6, write_stride=3, hills_log=log, **kw_files)[0]
        log.close()
    assert_tree(outs["T"], outs["J"], 1e-12, "final state")
    for name in ("HILLS", ".bias", ".hist", ".ltab"):
        suffix = "_HILLS" if name == "HILLS" else name
        _same_numbers(tmp_path / f"T{suffix}", tmp_path / f"J{suffix}")
    lines = (tmp_path / "T_HILLS").read_text().strip().splitlines()
    total = sum(float(l.split()[5]) for l in lines)
    assert lines and abs(total - float(outs["T"].bias.cum_bias)) < 1e-6


def test_checkpoint_resume_bitwise(tmp_path):
    """``test_checkpoint.py`` on the port's dense host at kT = 0.5: 6 steps,
    a checkpoint with deferred hills in the buffer, resumed into a fresh
    template; 6 more steps bitwise the 12 uninterrupted ones."""
    from edm_tpu_torch.bias import subdivide
    from edm_tpu_torch.utils.checkpoint import load_state, save_state
    from edm_tpu_torch.utils.config import parse_edm_text as tparse

    def mk():
        cfg = RECORDS_CFG.replace("bias_per_step 1.0", "bias_per_step 0.4")
        params, bs = subdivide(tparse(cfg), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                               dtype=torch.float64, device="cpu")
        x0 = np.random.default_rng(0).uniform(0.5, 3.5, (8, 3))
        step = tpe.make_step(params, TLP(dt=0.002, friction=1.0, kT=0.5),
                             tlj.LJParams(rcut=1.4), [4.0] * 3, hill_stride=2, hill_capacity=64)
        return step, tpe.init_state(bs, torch.as_tensor(x0), prng.PRNGKey(1))

    step, st = mk()
    full, _ = tpe.run_segment(step, st, 12)
    mid, _ = tpe.run_segment(step, st, 6)
    assert int(mid.bias.buf_right) > int(mid.bias.buf_left)
    save_state(mid, str(tmp_path / "state.npz"))
    _, fresh = mk()
    cont, _ = tpe.run_segment(step, load_state(fresh, str(tmp_path / "state.npz")), 6)
    assert_tree(cont, full, 0.0, "resumed")
    np.testing.assert_array_equal(np_(cont.x), np_(full.x))


def test_pair_run_with_target_file_matches_jax(tmp_path):
    """``test_workflows.py``'s pair run with a target file, 30 float32 steps
    at kT = 0 here (both packages, the same file): the state within 2e-5 of
    max(1, max|.|), the bias files number by number."""
    from edm_tpu.grid import Grid as JGrid
    from edm_tpu.grid import GridSpec as JGridSpec
    from edm_tpu.models.driver import run_simulation as j_run
    from edm_tpu.utils.gridio import read_grid_file as j_read
    from edm_tpu.utils.gridio import write_grid as j_write
    from edm_tpu_torch.bias import subdivide
    from edm_tpu_torch.models.driver import run_simulation
    from edm_tpu_torch.utils.config import parse_edm_text as tparse
    from edm_tpu_torch.utils.gridio import read_grid_file

    spec = JGridSpec.create([0], [3.0], [0.05], [False])
    xs = spec.min[0] + spec.dx[0] * np.arange(spec.nbins[0])
    tfile = tmp_path / "target.grid"
    j_write(JGrid(values=jnp.asarray(2.0 * (1 - np.exp(-((xs - 1.5) ** 2) / 0.1))),
                  derivs=None, spec=spec), str(tfile))
    cfg = PAIR_CFG + f"target_filename {tfile}\n"
    jtarget = j_read(str(tfile), dim=1, interpolate=False, dtype=jnp.float32)
    params, bs = JB.subdivide(parse_edm_text(cfg), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], target=jtarget, dtype=jnp.float32)
    ttarget = read_grid_file(str(tfile), dim=1, interpolate=False, dtype=torch.float32,
                             device="cpu")
    tparams, tbs = subdivide(tparse(cfg), 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             target=ttarget, dtype=torch.float32, device="cpu")
    assert float(tparams.expected_target) == pytest.approx(float(params.expected_target),
                                                           rel=1e-6)
    x0, _ = lattice()
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_stride=2, hill_capacity=2048)
    jstep = jpe.make_step(params, LangevinParams(**lp), LJParams(), BOX, **kw)
    tstep = tpe.make_step(tparams, TLP(**lp), tlj.LJParams(), BOX, **kw)
    st = jpe.init_state(bs, jnp.asarray(x0, jnp.float32), jax.random.PRNGKey(3))
    ts = tpe.init_state(tbs, torch.as_tensor(x0, dtype=torch.float32), prng.PRNGKey(3))
    st, e = j_run(jax.jit(jstep), st, 30, 10, bias_file=str(tmp_path / "J.bias"))
    ts, te = run_simulation(tstep, ts, 30, 10, bias_file=str(tmp_path / "T.bias"))
    assert np.isfinite(np_(te)).all() and float(ts.bias.cum_bias) > 0
    assert_exact(ts.last_calls, st.last_calls, "last_calls")
    assert_exact(ts.bias.steps, st.bias.steps, "hill rounds")
    for a, b in ((ts.x, st.x), (ts.v, st.v), (ts.bias.bias.grid.values, st.bias.bias.grid.values)):
        assert_f64(a, b, "state", rtol=2e-5)
    _same_numbers(tmp_path / "T.bias", tmp_path / "J.bias", rtol=2e-5)
