"""PyTorch port: the blocked pair host against the JAX package.

``make_step_blocked`` on test_md's 64-atom box with ``block_size=16``, the
same numpy inputs through ``edm_tpu.models.pair_edm_blocked`` (float64) and
the port on the CPU, whose per-row acceptance streams come from
``prng.threefry_rows``' plain version:

  - step for step over 20 kT = 0 steps in float64: the exact lookup through
    the static hill / plain phases, the Chebyshev table through the dynamic
    step, and an accept-every-pair run (``hill_density -1``) whose rows
    hold more than ``M_PER_ROW`` accepts, so both hosts flag
    ``hills_truncated``; x, v, f, the grid and the energy to 1e-12
    relative, the integer leaves, the key and the flags exactly;
  - one kT = 0.8 step in float32, within 1e-5 of max(1, max|.|) (the
    thermostat's erfinv, ``test_torch_dense.py``);
  - the port's own mirror of test_md's ``test_pairwise_blocked_matches_dense``:
    20 kT = 0.8 steps of the blocked and the dense host from one state
    (different acceptance streams): finite, nothing truncated, cum_bias
    within 50% of each other, the same deterministic candidate count;
  - ``driver.strided_segment`` over the static phases, bitwise the
    step-by-step run;
  - an atom count that is no whole number of blocks raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from _torch_parity import assert_f64, assert_tree, to_port
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_blocked import make_step_blocked
from edm_tpu_torch.models import lj as tlj
from edm_tpu_torch.models import pair_edm as tpe
from edm_tpu_torch.models import pair_edm_blocked as tpb
from edm_tpu_torch.models.driver import strided_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from test_torch_dense import BOX, F32_REL, PAIR_CFG, jax_pair_setup, lattice, run_both

ACCEPT_ALL = PAIR_CFG.replace("hill_density 20", "hill_density -1")
KW = dict(hill_stride=5, hill_capacity=2048, block_size=16)


@pytest.fixture(scope="module")
def zero_temperature():
    """The JAX blocked steps of each case, built and jitted once."""
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    cases = {}
    for name, lookup, cfg in (("exact", "interp", PAIR_CFG),
                              ("chebyshev", "chebyshev", PAIR_CFG),
                              ("accept_all", "interp", ACCEPT_ALL)):
        params, st = jax_pair_setup(pair_lookup=lookup, cfg=cfg)
        phases = (True, False) if name == "exact" else (None,)
        jsteps = [jax.jit(make_step_blocked(params, lp, LJParams(), BOX, static_do_hills=h,
                                            **KW)) for h in phases]
        cases[name] = (params, st, phases, jsteps)
    return cases


@pytest.mark.parametrize("case", ["exact", "chebyshev", "accept_all"])
def test_blocked_step_matches_jax(zero_temperature, case):
    params, st, phases, jsteps = zero_temperature[case]
    tsteps = [tpb.make_step_blocked(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0),
                                    tlj.LJParams(), BOX, static_do_hills=h, **KW)
              for h in phases]
    phase = (lambda i: int(i % 5 != 0)) if case == "exact" else (lambda i: 0)
    st, ts = run_both(jsteps, tsteps, st, to_port(st), 20, phase)
    assert int(st.bias.steps) == 4 and float(st.bias.cum_bias) > 0
    # every row of the accept-all run holds more than M_PER_ROW accepts
    assert bool(st.hills_truncated) == (case == "accept_all")


def test_blocked_step_kT08_one_step():
    params, st = jax_pair_setup(dtype=jnp.float32)
    lp = dict(dt=0.002, friction=1.0, kT=0.8)
    jstep = jax.jit(make_step_blocked(params, LangevinParams(**lp), LJParams(), BOX, **KW))
    tstep = tpb.make_step_blocked(to_port(params), TLP(**lp), tlj.LJParams(), BOX, **KW)
    st1, e = jstep(st, None)
    ts1, te = tstep(to_port(st))
    assert_tree(ts1, st1, F32_REL, "kT=0.8 step")
    assert_f64(te, e, "energy", rtol=F32_REL)
    assert int(st1.bias.steps) == 1


def test_blocked_matches_dense_statistically():
    """test_md's ``test_pairwise_blocked_matches_dense`` on the port, from
    its exact lattice at rest: the same physics and thermostat noise, other
    acceptance streams."""
    params, st = (to_port(a) for a in jax_pair_setup(dtype=jnp.float32))
    x0 = torch.as_tensor(lattice(jitter=0.0)[0], dtype=torch.float32)
    st = dataclasses.replace(st, x=x0, v=torch.zeros_like(x0))
    lp = TLP(dt=0.002, friction=1.0, kT=0.8)
    kw = dict(hill_stride=2, hill_capacity=2048)
    dense = tpe.make_step(params, lp, tlj.LJParams(), BOX, **kw)
    blocked = tpb.make_step_blocked(params, lp, tlj.LJParams(), BOX, block_size=16, **kw)
    st_d, _ = tpe.run_segment(dense, st, 20)
    st_b, e_b = tpe.run_segment(blocked, st, 20)
    assert torch.isfinite(e_b).all()
    assert not bool(st_b.hills_truncated) and not bool(st_d.hills_truncated)
    cd, cb = float(st_d.bias.cum_bias), float(st_b.bias.cum_bias)
    assert cb > 0 and abs(cd - cb) / max(cd, cb) < 0.5
    assert int(st_b.last_calls) == int(st_d.last_calls)  # deterministic count


def test_strided_segment_drives_blocked_steps(zero_temperature):
    """``driver.strided_segment`` over the blocked host's static hill and
    plain steps replays the step-by-step run bitwise."""
    params, st, _, _ = zero_temperature["exact"]
    lp = TLP(dt=0.002, friction=1.0, kT=0.0)
    hill, plain = (tpb.make_step_blocked(to_port(params), lp, tlj.LJParams(), BOX,
                                         static_do_hills=h, **KW) for h in (True, False))
    ts = to_port(st)
    seg, e_seg = strided_segment(hill, plain, 5, 10)(ts)
    for i in range(10):
        ts, _ = (hill if i % 5 == 0 else plain)(ts)
    assert e_seg.shape == (10,) and int(seg.bias.steps) == 2
    assert_tree(seg, ts, 0.0, "strided_segment")


def test_blocked_rejects_ragged_blocks():
    params, st = jax_pair_setup()
    step = tpb.make_step_blocked(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0),
                                 tlj.LJParams(), BOX, hill_stride=5, block_size=24)
    with pytest.raises(ValueError, match="block_size"):
        step(to_port(st))
    # ported since: axis_name sums the rounds' bias over a mesh
    assert tpb.make_step_blocked(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0),
                                 tlj.LJParams(), BOX, hill_stride=5,
                                 axis_name="dp").axis_name == "dp"
