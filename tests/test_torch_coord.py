"""PyTorch port: the 2-D coordinate-EDM host against the JAX host.

The same seeded numpy inputs go through ``edm_tpu`` (x64, as the conftest
sets) and ``edm_tpu_torch`` on the CPU.  Tolerances:

  - Threefry uniforms: bitwise.  Normals: ``sqrt(2) erfinv(u)`` from the
    same ``u``; PyTorch's ``erfinv`` is not XLA's polynomial, and over
    240,000 draws the two differ by at most 89 float32 ulps (5.7e-6
    relative) and 8.1e-13 relative in float64; held at 1e-5 and 2e-12;
  - float64 paths: 1e-12 relative to max(1, max|.|);
  - the float32 trajectory: positions, velocities and forces within
    2e-5 * max(1, max|.|), the bias grid within 1e-5 of its max, cum_bias
    1e-6 relative (XLA fuses the float32 chains into other roundings);
  - integer and flag leaves (counters, keys, buffer indices, histogram
    counts, masks): exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, assert_f64, assert_tree, to_numpy_tree, to_port
from edm_tpu import bias as JB
from edm_tpu.models import coord_edm as jce
from edm_tpu.models import langevin as jlang
from edm_tpu.models.driver import strided_segment as j_strided
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch import bias as TB
from edm_tpu_torch.models import coord_edm as tce
from edm_tpu_torch.models import langevin as tlang
from edm_tpu_torch.models.driver import pattern_segment, strided_segment
from edm_tpu_torch.ops import prng

N, HILL_STRIDE = 512, 2
# well-tempered, capped by bias_per_step (so rounds defer and drain), on a
# periodic 64 x 64 grid
CFG = ("tempering 1\nbias_factor 10\nglobal_tempering -1\nhill_prefactor 1.0\n"
       "bias_per_step 0.5\nhill_density 40\ndimension 2\nbox_low 0 0\nbox_high 10 10\n"
       "bias_spacing 0.15625 0.15625\nbias_sigma 0.3 0.3\n")
TDT = {jnp.float32: torch.float32, jnp.float64: torch.float64}


# ---------------------------------------------------------------- draws


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_uniform_and_normal_match_jax(dtype):
    for seed in (0, 3, 2**33 + 5):
        k, kp = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for shape in ((20000,), (5000, 2), (1,)):
            u = np.asarray(jax.random.uniform(k, shape, dtype))
            up = prng.uniform(kp, shape, TDT[dtype], "cpu").numpy()
            assert up.dtype == u.dtype and up.shape == u.shape
            np.testing.assert_array_equal(up.view(np.uint8), u.view(np.uint8))
            n = np.asarray(jax.random.normal(k, shape, dtype))
            npo = prng.normal(kp, shape, TDT[dtype], "cpu").numpy()
            rel = 1e-5 if dtype == jnp.float32 else 2e-12
            np.testing.assert_allclose(npo, n, rtol=rel, atol=0)
        k, kp = jax.random.split(k)[0], prng.split(kp)[0]
    # the wrapper's bits on the CPU are the numpy chain
    b = prng.threefry_bits(kp, 777, "cpu")
    np.testing.assert_array_equal(b.numpy().view(np.uint32), prng.random_bits(kp, 777))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_baoab_step(dtype):
    rng = np.random.default_rng(4)
    x, v, f = (rng.normal(size=(300, 2)) for _ in range(3))
    kspring = 2.5

    def jforce(x):
        return 0.5 * kspring * jnp.sum(x * x), -kspring * x

    def tforce(x):
        return 0.5 * kspring * torch.sum(x * x), -kspring * x

    jp = jlang.LangevinParams(dt=0.01, friction=1.3, kT=0.7)
    tp = tlang.LangevinParams(dt=0.01, friction=1.3, kT=0.7)
    key, tkey = jax.random.PRNGKey(9), prng.PRNGKey(9)
    ja = [jnp.asarray(a, dtype) for a in (x, v, f)]
    ta = [torch.tensor(a, dtype=TDT[dtype]) for a in (x, v, f)]
    for _ in range(3):
        *ja, je, key = jlang.baoab_step(jp, *ja, key, jforce)
        *ta, te, tkey = tlang.baoab_step(tp, *ta, tkey, tforce)
        np.testing.assert_array_equal(tkey, np.asarray(key))
        rtol = 1e-5 if dtype == jnp.float32 else 1e-12
        for a, b in zip(ta, ja):
            assert a.dtype == TDT[dtype]
            assert_f64(a, b, rtol=rtol)
        assert_f64(te, je, rtol=rtol)


# ------------------------------------------------------------- the round


def _round_setup(periodic, exact, dtype=jnp.float64):
    cfg = parse_edm_text(CFG)
    args = (cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10], [periodic] * 2, [0, 0])
    jparams, jbs = JB.subdivide(*args, dtype=dtype, exact_deposit=exact)
    return jparams, jbs, to_port(jparams), to_port(jbs)


@pytest.mark.parametrize("periodic,exact", [(True, False), (False, True), (False, False)])
def test_add_hills_round_2d(periodic, exact):
    """Two rounds on a fresh 2-D grid: the periodic grid takes the separable
    tables, the non-periodic one with exact_deposit the windowed scatter
    with the McGovern-De Pablo terms, and without it the McGovern-De Pablo
    separable tables; the first round defers hills past bias_per_step, the
    second drains them and skips."""
    jparams, jbs, tparams, tbs = _round_setup(periodic, exact)
    rng = np.random.default_rng(12 + periodic)
    for r in range(2):
        pos = rng.uniform(-0.5, 10.5, (60, 2))
        run = rng.uniform(0, 1, 60) * 0.05
        active = rng.uniform(size=60) < 0.9
        jbs, jrec = JB.add_hills_round(jparams, jbs, jnp.asarray(pos), jnp.asarray(run), 60,
                                       active=jnp.asarray(active))
        tbs, trec, _ = TB.add_hills_round(tparams, tbs, torch.tensor(pos), torch.tensor(run), 60,
                                          active=torch.tensor(active))
        assert_tree(trec, jrec, 1e-12, f"round {r} records")
        assert_tree(tbs, jbs, 1e-12, f"round {r} state")
    assert int(jbs.buf_right) > 0 or bool(jrec.skipped)
    assert float(jbs.cum_bias) > 0


# -------------------------------------------------------------- the host


def _host_setup(dtype, cache=None, periodic=True):
    """The host's start; on the non-periodic grid some particles start
    outside the box and some within a strip width (BC_MAR sigma' = 0.85)
    of the walls."""
    jparams, jbs, _, _ = _round_setup(periodic, False, dtype)
    rng = np.random.default_rng(21)
    x0 = rng.uniform(0, 10, (N, 2))
    v0 = rng.normal(size=(N, 2))
    if not periodic:
        x0[:40] = rng.uniform(-0.4, 10.4, (40, 2))
        x0[40:80, 0] = rng.uniform(-0.2, 0.8, 40)
        x0[80:120, 1] = rng.uniform(9.2, 10.2, 40)
    lp = jlang.LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    st = jce.init_state(jparams, jbs, jnp.asarray(x0, dtype), jax.random.PRNGKey(0), lp,
                        cache_lookup_table=cache)
    st = dataclasses.replace(st, v=jnp.asarray(v0, dtype))
    return jparams, st


CASES = {  # hill_capacity, group mask, cached corner table, periodic grid, hill_passes
    "compacted": (64, False, True, True, 1),
    "full batch": (0, False, None, True, 1),
    "masked, truncated": (16, True, None, True, 1),
    "McGDP": (64, False, True, False, 1),
    # ~40 hills a round: 32 rows spill into the second pass; 64 leave it empty
    "two passes, spilling": (32, False, True, True, 2),
    "two passes, one used": (64, False, True, True, 2),
}


def _run_both(dtype, case):
    cap, masked, cache, periodic, passes = CASES[case]
    jparams, st = _host_setup(dtype, cache, periodic)
    mask = np.arange(N) % 2 == 0 if masked else None
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_stride=HILL_STRIDE, hill_capacity=cap, hill_passes=passes)
    jsteps = [jax.jit(jce.make_step(jparams, jlang.LangevinParams(**lp), **kw,
                                    group_mask=None if mask is None else jnp.asarray(mask),
                                    static_do_hills=h)) for h in (True, False)]
    tparams = to_port(jparams)
    tsteps = [tce.make_step(tparams, tlang.LangevinParams(**lp), **kw, group_mask=mask,
                            static_do_hills=h) for h in (True, False)]
    ts = ts0 = to_port(st)
    return jsteps, tsteps, st, ts, ts0


@pytest.mark.parametrize("dtype,case", [(jnp.float64, c) for c in CASES]
                         + [(jnp.float32, "compacted"), (jnp.float32, "McGDP")])
def test_coord_step_for_step(dtype, case):
    jsteps, tsteps, st, ts, ts0 = _run_both(dtype, case)
    if case == "two passes, spilling":
        # the first round accepts more hills than one pass holds: one pass
        # of the same capacity drops the tail
        one = tce.make_step(tsteps[0].params, tsteps[0].lp, HILL_STRIDE, hill_capacity=32,
                            static_do_hills=True)
        assert bool(one(ts0)[0].hills_truncated) and not bool(tsteps[0](ts0)[0].hills_truncated)
        tsteps[0].host_syncs = 0
    f64 = dtype == jnp.float64
    tol = 1e-12 if f64 else 2e-5
    deferred = 0
    for i in range(20):
        k = 0 if i % HILL_STRIDE == 0 else 1
        st, e = jsteps[k](st, None)
        ts, te = tsteps[k](ts)
        what = f"{case} step {i}"
        for f in ("step", "hills_truncated"):
            assert_exact(getattr(ts, f), getattr(st, f), f"{what} {f}")
        np.testing.assert_array_equal(ts.key, np.asarray(st.key))
        for f in ("x", "v", "f"):
            assert_f64(getattr(ts, f), getattr(st, f), f"{what} {f}", rtol=tol)
        assert_f64(te, e, f"{what} energy", rtol=1e-12 if f64 else 1e-5)
        jb, tb = st.bias, ts.bias
        for f in ("buf_left", "buf_right", "overflow_error", "steps"):
            assert_exact(getattr(tb, f), getattr(jb, f), f"{what} {f}")
        assert_exact(tb.cv_hist.values, jb.cv_hist.values, f"{what} cv_hist")
        assert_f64(tb.cum_bias, jb.cum_bias, f"{what} cum_bias", rtol=1e-12 if f64 else 1e-6)
        for f in ("values", "derivs"):
            assert_f64(getattr(tb.bias.grid, f), getattr(jb.bias.grid, f), f"{what} grid {f}",
                       rtol=1e-12 if f64 else 1e-5)
        if st.ptab is not None:
            assert_f64(ts.ptab, st.ptab, f"{what} ptab", rtol=1e-12 if f64 else 1e-5)
        else:
            assert ts.ptab is None
        deferred = max(deferred, int(jb.buf_right))
    assert float(st.bias.cum_bias) > 0 and int(st.bias.steps) == 20 // HILL_STRIDE
    # hills were deferred past bias_per_step, then drained (16 hills a round
    # stay under it)
    assert (deferred > 0) == (case != "masked, truncated")
    assert bool(st.hills_truncated) == (case == "masked, truncated")
    assert tsteps[0].host_syncs > 0 and tsteps[1].host_syncs == 0
    if case == "McGDP":  # the box's walls stopped no hill from counting
        assert not bool(np.asarray(st.bias.overflow_error))


def test_strided_segment_and_run_segment():
    """The strided runner replays the step-by-step run bitwise; a phase
    pattern against hill_stride is refused."""
    jsteps, tsteps, st, ts, ts0 = _run_both(jnp.float64, "compacted")
    seg = strided_segment(tsteps[0], tsteps[1], HILL_STRIDE, 8)
    ts_seg, energies = seg(ts0)
    ts_loop = ts0
    for i in range(8):
        ts_loop, _ = tsteps[i % HILL_STRIDE](ts_loop)
    assert energies.shape == (8,)
    for f in ("x", "v", "f", "step"):
        assert_exact(getattr(ts_seg, f), getattr(ts_loop, f), f)
    assert_exact(ts_seg.bias.bias.grid.values, ts_loop.bias.bias.grid.values)
    # the JAX strided runner reaches the same state
    st8, je = jax.jit(j_strided(jsteps[0], jsteps[1], HILL_STRIDE, 8))(st)
    assert_f64(ts_seg.x, st8.x, "x")
    assert_f64(energies, je, "energies")
    # one step alone is a plain run of the hill phase's step
    ts_run, e_run = tce.run_segment(tsteps[0], ts0, 1)
    assert_exact(ts_run.x, tsteps[0](ts0)[0].x)
    with pytest.raises(ValueError, match="hill step"):
        strided_segment(tsteps[1], tsteps[0], HILL_STRIDE, 8)
    with pytest.raises(ValueError, match="whole number"):
        strided_segment(tsteps[0], tsteps[1], 3, 9)


def test_segment_unroll_keyword():
    """``unroll`` (the JAX runners' keyword, by name and by position) is
    accepted and changes nothing: each runner reaches the state it reaches
    without it, bitwise."""
    _, tsteps, _, _, ts0 = _run_both(jnp.float64, "compacted")
    pattern = [(tsteps[0], 1), (tsteps[1], HILL_STRIDE - 1)]
    ref = strided_segment(tsteps[0], tsteps[1], HILL_STRIDE, 4)(ts0)
    ref_p = pattern_segment(pattern, 4)(ts0)
    for unroll in (2, 1):
        for got in (strided_segment(tsteps[0], tsteps[1], HILL_STRIDE, 4, unroll=unroll)(ts0),
                    strided_segment(tsteps[0], tsteps[1], HILL_STRIDE, 4, unroll)(ts0)):
            assert_tree(got[0], ref[0], 0.0, f"strided_segment unroll={unroll}")
            assert_exact(got[1], ref[1])
        for got in (pattern_segment(pattern, 4, unroll=unroll)(ts0),
                    pattern_segment(pattern, 4, unroll)(ts0)):
            assert_tree(got[0], ref_p[0], 0.0, f"pattern_segment unroll={unroll}")
            assert_exact(got[1], ref_p[1])


def test_convert_round_trip():
    _, st = _host_setup(jnp.float32, cache=True)
    ts = to_port(st)
    assert isinstance(ts, tce.CoordEDMState) and ts.ptab is not None
    assert ts.x.dtype == torch.float32 and ts.step.dtype == torch.int64
    back, ref = to_numpy_tree(ts), to_numpy_tree(st)
    for k in ("x", "v", "f", "key", "step", "energy", "ptab", "hills_truncated"):
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    assert_tree(ts.bias, st.bias, 0.0, "bias")
    # and the port's init_state builds the same state from the same inputs
    tparams, tbs = to_port(_round_setup(True, False, jnp.float32)[0]), to_port(st.bias)
    ti = tce.init_state(tparams, tbs, ts.x, prng.PRNGKey(0),
                        tlang.LangevinParams(dt=0.002, friction=1.0, kT=0.0),
                        cache_lookup_table=True)
    assert_exact(ti.ptab, st.ptab)


def test_dynamic_hill_step():
    """``static_do_hills=None``: one step that decides from the step counter
    (read back once a call) through ``run_segment``, against the JAX host's
    jitted ``run_segment`` (its ``lax.cond`` in a scan), and bitwise against
    the static pair through ``strided_segment``; its host reads are the
    counter reads plus the hill rounds' reads."""
    jparams, st = _host_setup(jnp.float64, True)
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(hill_stride=HILL_STRIDE, hill_capacity=64)
    jstep = jce.make_step(jparams, jlang.LangevinParams(**lp), **kw)
    tparams, ts0 = to_port(jparams), to_port(st)
    tstep = tce.make_step(tparams, tlang.LangevinParams(**lp), **kw)
    pair = [tce.make_step(tparams, tlang.LangevinParams(**lp), **kw, static_do_hills=h)
            for h in (True, False)]
    n = 6
    st_j, e_j = jax.jit(lambda s: jce.run_segment(jstep, s, n))(st)
    ts_d, e_d = tce.run_segment(tstep, ts0, n)
    assert_tree(ts_d, st_j, 1e-12, "dynamic step vs JAX")
    assert_f64(e_d, e_j, "energies")
    ts_s, e_s = strided_segment(pair[0], pair[1], HILL_STRIDE, n)(ts0)
    assert_tree(ts_d, ts_s, 0.0, "dynamic step vs the static pair")
    assert_exact(e_d, e_s)
    assert int(ts_d.bias.steps) == n // HILL_STRIDE and float(ts_d.bias.cum_bias) > 0
    assert pair[1].host_syncs == 0
    assert tstep.host_syncs == n + pair[0].host_syncs
    # a dynamic step fits every place of a cycle
    pattern_segment([(tstep, 3)], 6)


def test_unported_options_raise():
    """Nothing raises any more: ``boundary_offset`` (the spatial host's) is
    ported, and a round with a zero offset equals JAX's round with the same
    offset, on the periodic grid (the separable route) and the McGDP one
    (the offset turns the McGDP tables off: the windowed scatter), float64
    at 1e-12 and the integer leaves exactly.  Record collection builds,
    static and dynamic; so does ``axis_name``, which on a one-rank mesh
    gives the round without it."""
    from edm_tpu_torch.parallel import make_mesh

    jparams, jbs, tparams, tbs = _round_setup(True, False)
    lp = tlang.LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    for kw in (dict(static_do_hills=True, collect_records=True), dict(collect_records=True)):
        assert tce.make_step(tparams, lp, 2, **kw).collect_records
    for kw in (dict(static_do_hills=True, axis_name="dp"), dict(axis_name="dp")):
        assert tce.make_step(tparams, lp, 2, **kw).axis_name == "dp"
    make_mesh(device="cpu")
    rng = np.random.default_rng(2)
    pos = torch.as_tensor(rng.uniform(0.5, 9.5, (4, 2)))
    run = torch.as_tensor(rng.uniform(0.0, 1.0, 4))
    one, _, _ = TB.add_hills_round(tparams, tbs, pos, run, 4, axis_name="dp")
    ref, _, _ = TB.add_hills_round(tparams, tbs, pos, run, 4)
    assert_tree(one, ref, 0.0, "one-rank axis_name round")
    assert float(one.cum_bias) > 0
    for periodic in (True, False):
        jparams, jbs, tparams, tbs = _round_setup(periodic, False)
        jnew, jrec = JB.add_hills_round(jparams, jbs, jnp.asarray(pos.numpy()),
                                        jnp.asarray(run.numpy()), 4,
                                        boundary_offset=jnp.zeros(2))
        tnew, trec, _ = TB.add_hills_round(tparams, tbs, pos, run, 4,
                                           boundary_offset=torch.zeros(2, dtype=torch.float64))
        assert_tree(tnew, jnew, 1e-12, f"zero-offset round, periodic={periodic}")
        assert_tree(trec, jrec, 1e-12, f"zero-offset records, periodic={periodic}")
        assert float(tnew.cum_bias) > 0
