"""PyTorch port: the plain version of pass 1 of the cell host's hill
collections (``ops/collect``, which the CPU runs) takes bounded chunks of
whole cells (``collect.P1_DRAWS``), and the chunking changes nothing.

Each collection is held bitwise between a forced small chunk (7 cells,
which divides none of these lattices) and the default, which takes these
lattices in one chunk: the round's hills, acceptance uniforms, active
flags, ``ncalls`` and truncation flag, and pass 1's per-row counts (read
where ``_select_rows`` takes them).  Cases: the half-stencil collection
with and without truncation at ``hill_capacity``, the typed 27-stencil
one, and the slab and brick ``shard_hills`` forms on 2 gloo ranks (whose
gathered rounds must also be the single-device round).  Last, one hill
step on the 5^3-cell lattice against the JAX host's, whose pass 1 scans 16
chunks of ``cell_chunk`` 8 cells: the candidate count and the truncation
flag exactly, the acceptance uniforms bitwise, the centres to float32
rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import assert_exact, assert_tree, np_, to_numpy_tree, to_port
from edm_tpu import bias as JB
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import collect, prng
from test_torch_parallel import CFG, _launch_bg, _ragged_setup

LAST_CALLS = 4000  # hill_density 20 over this: about 1% of the candidates accepted
TYPES = np.where(np.arange(1728) % 2 == 0, 2, 1).astype(np.int32)


def _p1_cells(n_cells, width):
    """The P1_DRAWS that makes pass 1 take ``n_cells`` cells a chunk on a
    collection of ``width`` draws a slot row and cap 32."""
    return n_cells * 32 * width


def _collect(step, state, p1=None):
    """One collection through ``step`` with P1_DRAWS = ``p1`` (None: the
    default) -> (the round as numpy, pass 1's row counts)."""
    seen = []
    select = step._select_rows
    step._select_rows = lambda rc, *a: seen.append(rc) or select(rc, *a)
    saved = collect.P1_DRAWS
    collect.P1_DRAWS = saved if p1 is None else p1
    try:
        res = step._collect_hills(state, state.xs, prng.PRNGKey(11), torch.tensor(LAST_CALLS),
                                  torch.float32)
    finally:
        collect.P1_DRAWS = saved
        del step._select_rows
    return to_numpy_tree(res), seen[0].numpy()


def _assert_bitwise(a, b, what):
    (ra, ca), (rb, cb) = a, b
    for name, x, y in zip(("hills", "runifs", "active", "ncalls", "truncated"), ra, rb):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(ca, cb, err_msg=f"{what}: row_counts")


def _port_step(params, spec, typed=False, **kw):
    extra = dict(types=TYPES, type_pair=(1, 2)) if typed else {}
    return tpc.make_cell_step(params, TLP(dt=0.002, friction=1.0, kT=0.8), TLJ(), spec, 10,
                              **extra, **kw)


def test_p1_ranges_cover_whole_cells():
    assert collect._p1_ranges(125, 2 * 14 * 32 * 32) == [(0, 125)]
    assert collect._p1_ranges(0, 1) == []
    saved = collect.P1_DRAWS
    collect.P1_DRAWS = 7 * 100 + 99
    try:
        r = collect._p1_ranges(125, 100)
    finally:
        collect.P1_DRAWS = saved
    assert r[0] == (0, 7) and r[-1] == (119, 125) and len(r) == 18
    assert all(b == c for (_, b), (c, _) in zip(r, r[1:]))
    # the default at the bench's widths: 10k one chunk, 100k six
    assert len(collect._p1_ranges(729, 2 * 14 * 32 * 32)) == 1
    assert len(collect._p1_ranges(6859, 2 * 14 * 32 * 32)) == 6
    assert len(collect._p1_ranges(6859, 27 * 32 * 32)) == 6


@pytest.mark.parametrize("hill_capacity", [2048, 64])
def test_half_collection_chunked_is_bitwise(hill_capacity):
    params, core, spec = _ragged_setup()
    assert spec.n_cells == 125 and spec.cap == 32
    state = tpc.init_cell_state(spec, core)
    step = _port_step(params, spec, hill_capacity=hill_capacity)
    one = _collect(step, state)
    seven = _collect(step, state, _p1_cells(7, 2 * 14 * 32))
    _assert_bitwise(seven, one, "half, 7-cell chunks")
    (_, _, active, ncalls, truncated), counts = one
    assert int(ncalls) > 0 and active.sum() > 0
    assert bool(truncated) == (hill_capacity == 64) == (counts.sum() > hill_capacity)


def test_typed_collection_chunked_is_bitwise():
    params, core, spec = _ragged_setup()
    state = tpc.init_cell_state(spec, core, types=torch.as_tensor(TYPES))
    step = _port_step(params, spec, typed=True, hill_capacity=512, use_pallas=True)
    one = _collect(step, state)
    seven = _collect(step, state, _p1_cells(7, 27 * 32))
    _assert_bitwise(seven, one, "typed, 7-cell chunks")
    untyped = _collect(_port_step(params, spec, hill_capacity=512), tpc.init_cell_state(spec, core))
    assert 0 < int(one[0][3]) < int(untyped[0][3])


def test_sharded_collections_chunked_are_bitwise(tmp_path):
    """The slab (2 ranks: 3 + 2 columns) and brick ((1, 2)) collections on
    2 gloo ranks: each rank's row counts and the gathered round bitwise
    between 7-cell chunks and one chunk, and the round the single-device
    one."""
    params, core, spec = _ragged_setup()
    state = tpc.init_cell_state(spec, core)
    base = dict(params=to_numpy_tree(params), spec=dataclasses.asdict(spec), lj={},
                lp=dict(dt=0.002, friction=1.0, kT=0.8), port_state=state, key=11,
                last_calls=LAST_CALLS, hill_capacity=512, p1=[None, _p1_cells(7, 2 * 14 * 32)])
    join = _launch_bg(tmp_path, [(ranks.collect_chunked, 2, dict(base, grid=grid))
                                 for grid in (None, (1, 2))])
    ref = _collect(_port_step(params, spec, hill_capacity=512), state)
    for grid, res in zip(("slab", "brick"), join()):
        for rank, r in enumerate(res):
            one, seven = ((r[p]["round"], r[p]["row_counts"]) for p in base["p1"])
            _assert_bitwise(seven, one, f"{grid} rank {rank}")
            assert 0 < one[1].size < ref[1].size
            for name, x, y in zip(("hills", "runifs", "active", "ncalls", "truncated"),
                                  one[0], ref[0]):
                np.testing.assert_array_equal(x, y, err_msg=f"{grid} rank {rank}: {name}")


def test_chunked_hill_step_matches_jax():
    """One kT = 0 hill step of the XLA-pass host from the same state and key:
    JAX scans pass 1 in 16 chunks of cell_chunk 8, the port in 18 chunks
    of 7 cells."""
    params, bs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], dtype=jnp.float32)
    _, tcore, tspec = _ragged_setup()
    x = jnp.asarray(np_(tcore.x))
    core = jpe.init_state(bs, x, jax.random.PRNGKey(0))
    spec = CellSpec.create(tspec.box, cutoff=3.0, n_atoms=1728)
    assert spec.ncells == (5, 5, 5)
    state = init_cell_state(spec, core)
    kw = dict(hill_capacity=512, cell_chunk=8, collect_records=True, static_do_hills=True,
              static_do_energy=True, static_do_rebuild=False)
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    jstep = jax.jit(make_cell_step(params, LangevinParams(**lp), LJParams(), spec, 10, **kw))
    jst, (_, jlog) = jstep(state, None)
    tstep = tpc.make_cell_step(to_port(params), TLP(**lp), TLJ(),
                               tcells.CellSpec(**dataclasses.asdict(spec)), 10, **kw)
    saved = collect.P1_DRAWS
    collect.P1_DRAWS = _p1_cells(7, 2 * 14 * 32)
    try:
        tst, (_, tlog) = tstep(to_port(state))
    finally:
        collect.P1_DRAWS = saved
    assert_exact(tst.core.last_calls, jst.core.last_calls, "ncalls")
    assert_exact(tst.core.hills_truncated, jst.core.hills_truncated, "truncated")
    assert int(np_(tst.core.last_calls)) > 0
    jl, tl = to_numpy_tree(jlog), to_numpy_tree(tlog)
    assert bool(tl["happened"]) and bool(jl["happened"])
    pos, jpos = np.asarray(tl["positions"], np.float64), np.asarray(jl["positions"], np.float64)
    assert np.abs(pos - jpos).max() <= 2 * np.spacing(np.float32(3.0))
    assert_tree(tl["rec"], jl["rec"], 1e-5, "round records")
