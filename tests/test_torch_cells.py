"""PyTorch port: cell binning, the incremental rebin and the slot state,
integer outputs exactly the JAX package's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_exact, to_port
from edm_tpu import bias as JB
from edm_tpu.models import cells as jc
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models import pair_edm_cells as jpc
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tc
from edm_tpu_torch.models import pair_edm_cells as tpc


def _spec_pair(box, cutoff, n, cap=None):
    js = jc.CellSpec.create(box, cutoff, n, cap)
    ts = tc.CellSpec.create(box, cutoff, n, cap)
    assert (ts.ncells, ts.edge, ts.box, ts.cap, ts.n_atoms) == (
        js.ncells, js.edge, js.box, js.cap, js.n_atoms)
    assert np.array_equal(ts.stencil(), js.stencil())
    return js, ts


@pytest.mark.parametrize("n,box,cap", [(700, (6.0, 7.5, 9.1), None), (900, (6.0, 6.0, 6.0), 40)])
def test_build_table_exact(n, box, cap):
    js, ts = _spec_pair(box, 2.0, n, cap)
    rng = np.random.default_rng(n)
    x = rng.uniform(-8.0, 16.0, (n, 3)).astype(np.float32)  # wraps both ways
    ref = jc.build_table(js, jnp.asarray(x))
    out = tc.build_table(ts, torch.as_tensor(x))
    assert_exact(out.aid, ref.aid)
    assert_exact(out.overflow, ref.overflow)
    assert_exact(tc.cell_of(ts, torch.as_tensor(x)), jc.cell_of(js, jnp.asarray(x)))


@pytest.mark.parametrize("mover_cap,shift", [(256, 0.25), (32, 0.25), (256, 1.5)])
def test_incremental_rebin_exact(mover_cap, shift):
    """Movers from random displacements; a small mover_cap and large shifts
    make the plan infeasible (the full-rebuild fallback's trigger)."""
    n = 800
    js, ts = _spec_pair((6.0, 6.0, 6.0), 2.0, n, 64)
    Cg = tpc._padded_cells(ts)
    rng = np.random.default_rng(7)
    x0 = rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    aid = np.concatenate([np.asarray(jc.build_table(js, jnp.asarray(x0)).aid),
                          np.full(Cg * ts.cap - ts.n_slots, n, np.int32)])
    x1 = (x0 + rng.uniform(-shift, shift, (n, 3))).astype(np.float32)
    xs = np.where((aid < n)[:, None], x1[np.clip(aid, 0, n - 1)], 0.0).astype(np.float32)
    xs = xs.reshape(Cg, ts.cap, 3)
    ref = jc.plan_incremental_rebin(js, Cg, jnp.asarray(aid), jnp.asarray(xs), mover_cap)
    out = tc.plan_incremental_rebin(ts, Cg, torch.as_tensor(aid).long(), torch.as_tensor(xs),
                                    mover_cap)
    for f in ref._fields:
        assert_exact(getattr(out, f), getattr(ref, f), f)
    payload = rng.normal(size=(Cg * ts.cap, 3)).astype(np.float32)
    raid, routs = jc.apply_incremental_rebin(js, ref, jnp.asarray(aid), [jnp.asarray(payload)])
    taid, touts = tc.apply_incremental_rebin(ts, out, torch.as_tensor(aid).long(),
                                             [torch.as_tensor(payload)])
    assert_exact(taid, raid)
    assert_exact(touts[0], routs[0])


@pytest.mark.parametrize("kcap,ocap", [(16, 64), (24, 16), (24, 128)])
def test_init_cell_state_and_tail_list(kcap, ocap):
    """The slot state built by the port from a converted core matches the
    JAX state (and its conversion) leaf for leaf; the tail list includes
    the overflowed case (tail > overflow_cap)."""
    n = 600
    js, ts = _spec_pair((6.0, 6.0, 6.0), 2.0, n, 64)
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    _, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=jnp.float32)
    rng = np.random.default_rng(11)
    x = rng.uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    x[:40] = rng.uniform(0.0, 2.0, (40, 3))  # a crowded cell: a real tail
    core = jpe.init_state(bs, jnp.asarray(x), jax.random.PRNGKey(3), n_est=n * 40)
    ref = jpc.init_cell_state(js, core, with_ids=False, kernel_cap=kcap, overflow_cap=ocap)
    conv = to_port(ref)
    out = tpc.init_cell_state(ts, to_port(core), kernel_cap=kcap, overflow_cap=ocap)
    for f in ("aid", "xs", "vs", "fs", "mc", "table_overflow", "ovl", "tail_count",
              "tail_ovf", "tail_fallbacks"):
        assert_exact(getattr(out, f), getattr(ref, f), f)
        assert_exact(getattr(conv, f), getattr(ref, f), f)
    assert out.tail_ovf_host == conv.tail_ovf_host == bool(ref.tail_ovf)
    assert not bool(ref.table_overflow) and int(ref.tail_count) > 16
    assert out.kernel_cap == conv.kernel_cap == kcap
    np.testing.assert_array_equal(conv.core.key, np.asarray(core.key))
    x_at = tpc.atom_positions(ts, out)
    np.testing.assert_array_equal(x_at.numpy(), x)


def test_unported_options_raise():
    """The slot ids (``with_ids``) and slot types (``types``) are ported:
    the port builds them exactly as the JAX host does; a types array that
    is not one entry per atom raises."""
    n = 100
    js, ts = _spec_pair((6.0, 6.0, 6.0), 2.0, n, 16)
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    _, bs = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                         dtype=jnp.float32)
    x = np.random.default_rng(2).uniform(0.0, 6.0, (n, 3)).astype(np.float32)
    core = jpe.init_state(bs, jnp.asarray(x), jax.random.PRNGKey(3), n_est=n * 40)
    types = (np.arange(n) % 3 + 1).astype(np.int32)
    ref = jpc.init_cell_state(js, core, with_ids=True, types=types)
    out = tpc.init_cell_state(ts, to_port(core), with_ids=True, types=types)
    for f in ("aid", "xs", "mc", "sid", "ts"):
        assert_exact(getattr(out, f), getattr(ref, f), f)
    with pytest.raises(ValueError, match="one entry per atom"):
        tpc.init_cell_state(ts, to_port(core), types=types[:-1])
