"""PyTorch port: the brick host, the work-sharded cell host and the sharded
coordinate host against the JAX package.

As in ``test_torch_parallel.py``, each case spawns gloo ranks on the CPU
through ``edm_tpu_torch.parallel.launch``, which run
``tests/_torch_ranks.py`` (torch and the port only); the JAX side runs in
this process on conftest's 8 CPU devices while the ranks run.

  - the brick mesh ``(2, 2)``, ``(3, 2)`` and ``(2, 2, 2)``: each axis'
    coordinate is ``np.unravel_index(rank, shape)``, ``psum`` and
    ``all_gather`` over the axis tuple equal numpy in rank order, bitwise on
    every rank, and a mesh of the wrong size raises;
  - the brick host against JAX's ``make_brick_cell_step`` on the 3^3
    lattice of 512 atoms (the small-lattice branch: K1 over the whole
    lattice, rows masked to the owned cells), Chebyshev 16 x 4, 4 steps at
    kT = 0 and 0.8 on ``(2, 2)`` and 3 at kT = 0 on ``(2, 2, 2)``: the
    cell state at ``test_torch_parallel._assert_cell_state``'s tolerances
    (x within 4 float32 ulps of max|x|, v within 1e-5 * max(1, max|v|), f
    within 2e-5 * max(1, max|f|), the integers exactly), the grid within
    1e-5 of JAX's and bitwise the port's single-device host's, and every
    rank's state bitwise rank 0's;
  - the sliceable brick path (K1's owned-row pass over the brick box) on
    the 5-cell lattice of 1,728 atoms against the port's single-device host
    on ``(2, 2)`` (3 + 2 cells a side), ``(3, 2)`` (2 + 2 + 1 by 3 + 2) and
    ``(2, 2, 2)``: 10 kT = 0 steps each from the single-device trajectory's
    state, with ``kernel_cap`` 24 and ``overflow_cap`` 32 (K2 with the
    brick ownership masks) and 16 (a ``tail_ovf`` period, K1 at full cap);
    forces at 2e-5 * max(1, max|f|), integers and the hill grids exactly;
  - the brick hill collection (``slab_collect=True``) bitwise the
    replicated one (``False``) over 4 kT = 0.8 steps on the 5-cell lattice;
  - the work-sharded cell host against JAX's ``make_sharded_cell_step`` on
    2 ranks: 512 atoms, ``cell_chunk`` 8 (so the padded lattice has more
    cells than the real one), 4 steps with ``hill_stride`` 2 at kT = 0 and
    0.8, the ``collect_records`` logs against JAX's;
  - the sharded coordinate host against JAX's on 2 and 4 ranks, as
    ``test_parallel.test_sharded_coord_host`` (64 walkers, 6 steps) and
    ``::test_sharded_coord_compaction_matches_full`` (128 walkers,
    ``hill_capacity`` 64 against 0): x and the grid at that test's
    tolerances, ``cv_hist``, ``hills_truncated`` and the counters exactly,
    the replicas bitwise across ranks;
  - ``ops.deposit.hill_weights`` and the hill-event codes against JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import assert_exact, assert_forces, assert_tree, to_numpy_tree, to_port
from edm_tpu import bias as JB
from edm_tpu.models import coord_edm as jce
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.parallel import (
    make_brick_mesh,
    make_mesh,
    make_sharded_coord_step,
    shard_coord_state,
)
from edm_tpu.parallel.cells import (
    init_sharded_cell_state,
    make_brick_cell_step,
    make_sharded_cell_step,
)
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch import bias as TB
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import deposit as TD
from test_torch_parallel import (
    CHEB,
    _assert_cell_state,
    _launch,
    _launch_bg,
    _ragged_setup,
    _setup,
    _slab_inputs,
)

# ------------------------------------------------------------ the brick mesh


@pytest.mark.parametrize("grid", [(2, 2), (3, 2), (2, 2, 2)])
def test_brick_mesh_coords_and_collectives(tmp_path, grid):
    wrong = (grid[0] + 1,) + tuple(grid[1:])
    res = _launch(tmp_path, ranks.brick_mesh, int(np.prod(grid)),
                  dict(grid=grid, seed=5, wrong=wrong))
    axes = ("bx", "by", "bz")[:len(grid)]
    for r in res:
        assert r["shape"] == grid and r["axes"] == axes
        assert tuple(r["coords"]) == tuple(int(c) for c in np.unravel_index(r["rank"], grid))
        assert r["wrong"] is not None and "asked for" in r["wrong"]
        for name in ("f32", "i64"):
            acc = res[0]["in"][name]
            for q in res[1:]:
                acc = acc + q["in"][name]
            np.testing.assert_array_equal(r[name + "_psum"], acc)
            np.testing.assert_array_equal(r[name + "_gather"],
                                          np.concatenate([q["in"][name] for q in res]))
    assert [r["rank"] for r in res] == list(range(len(res)))


# ------------------------------------------------------------ the brick host


def _brick_job(grid, kT, runs, n_steps=4):
    params, spec, st0, lp = _slab_inputs(kT)
    return (ranks.slab_steps, int(np.prod(grid)), dict(
        params=to_numpy_tree(params), state=to_numpy_tree(st0), spec=dataclasses.asdict(spec),
        lp=lp, lj={}, hill_stride=2, n_steps=n_steps, runs=runs, grid=grid))


@pytest.mark.parametrize("grid,kT,n_steps", [((2, 2), 0.0, 4), ((2, 2), 0.8, 4),
                                             ((2, 2, 2), 0.0, 3)],
                         ids=["2x2-kT0", "2x2-kT0.8", "2x2x2-kT0"])
def test_brick_host_matches_jax(tmp_path, grid, kT, n_steps):
    """The brick host on the 3^3 lattice (the small-lattice branch on every
    sharded axis) against JAX's on the same grid of ranks, and bitwise the
    port's single-device host in its hill rounds."""
    join = _launch_bg(tmp_path, [_brick_job(grid, kT, [("run", dict(hill_capacity=512))],
                                            n_steps)])
    params, spec, st0, lp = _slab_inputs(kT)
    assert spec.ncells == (3, 3, 3)
    jstep = make_brick_cell_step(params, LangevinParams(**lp), LJParams(), spec, hill_stride=2,
                                 mesh=make_brick_mesh(*grid), hill_capacity=512)
    s = st0
    for _ in range(n_steps):
        s, _ = jstep(s)
    jref = to_numpy_tree(s)
    tstep = tpc.make_cell_step(to_port(params), TLP(**lp), TLJ(),
                               tpc.CellSpec(**dataclasses.asdict(spec)), 2, use_pallas=True,
                               hill_capacity=512)
    t = to_port(st0)
    for _ in range(n_steps):
        t, _ = tstep(t)
    single = to_numpy_tree(t)
    res, = join()
    got = res[0]["run"][-1]
    what = f"brick {grid} kT={kT}"
    _assert_cell_state(got, jref, what)
    np.testing.assert_array_equal(got["core"]["bias"]["bias"]["grid"]["values"],
                                  single["core"]["bias"]["bias"]["grid"]["values"])
    assert_exact(got["core"]["last_calls"], single["core"]["last_calls"], what)
    assert float(got["core"]["bias"]["cum_bias"]) > 0
    for r in res[1:]:
        for a, b in zip(jax.tree.leaves(r["run"][-1]), jax.tree.leaves(got)):
            np.testing.assert_array_equal(a, b)


def _ragged_trajectories(params, core, spec, lp, kw):
    """The single-device host's 10 kT = 0 steps on the 5-cell lattice with
    overflow_cap 32 and 16: their input states and the states after them."""
    traj, refs = {}, {}
    for name, ocap in (("reduced", 32), ("tail_ovf", 16)):
        s = tpc.init_cell_state(spec, core, kernel_cap=24, overflow_cap=ocap)
        assert s.tail_ovf_host == (ocap == 16)
        step = tpc.make_cell_step(params, TLP(**lp), TLJ(), spec, 10, overflow_cap=ocap, **kw)
        traj[name], refs[name] = [], []
        for _ in range(10):
            traj[name].append(s)
            s, _ = step(s)
            refs[name].append(to_numpy_tree(s))
    return traj, refs


@pytest.mark.parametrize("grid", [(2, 2), (3, 2), (2, 2, 2)])
def test_brick_host_sliceable_lattice(tmp_path, grid):
    """K1's owned-row pass over each rank's brick box on the 5-cell lattice
    (windows of 5 x 5 x 5 cells on (2, 2), 4 x 5 x 5 on (3, 2), 5^3 on
    (2, 2, 2)), with K2 and the brick ownership masks, against the port's
    single-device host: 20 kT = 0 steps, each from its state."""
    params, core, spec = _ragged_setup()
    assert spec.ncells == (5, 5, 5)
    lp = dict(dt=0.002, friction=1.0, kT=0.0)
    kw = dict(rebuild_stride=10, hill_capacity=512, use_pallas=True, kernel_cap=24)
    traj, refs = _ragged_trajectories(params, core, spec, lp, kw)
    runs = [(name, dict(kw, overflow_cap=ocap)) for name, ocap in (("reduced", 32),
                                                                    ("tail_ovf", 16))]
    res = _launch(tmp_path, ranks.slab_steps, int(np.prod(grid)), dict(
        params=to_numpy_tree(params), spec=dataclasses.asdict(spec), lj={}, hill_stride=10,
        port_state=traj, lp=lp, each=True, runs=runs, grid=grid))
    for name in ("reduced", "tail_ovf"):
        for i, (got, ref) in enumerate(zip(res[0][name], refs[name])):
            what = f"brick {grid}, {name} step {i}"
            assert_forces(got["fs"], ref["fs"], what)
            assert_forces(got["xs"], ref["xs"], what)
            for f in ("aid", "mc", "ovl", "tail_count", "tail_ovf", "tail_fallbacks"):
                assert_exact(got[f], ref[f], f"{what} {f}")
            for f in ("step", "last_calls", "hills_truncated"):
                assert_exact(got["core"][f], ref["core"][f], f"{what} {f}")
            np.testing.assert_array_equal(got["core"]["bias"]["bias"]["grid"]["values"],
                                          ref["core"]["bias"]["bias"]["grid"]["values"])
        for r in res[1:]:
            for a, b in zip(jax.tree.leaves(r[name]), jax.tree.leaves(res[0][name])):
                np.testing.assert_array_equal(a, b)


def test_brick_window_and_box():
    """Each rank's window and row box on the 10k lattice (9^3 cells): 7 x 7
    x 9 with the box ((1, 1, 0), (5, 5, 9)) on (2, 2), 7^3 with ((1, 1, 1),
    (5, 5, 5)) on (2, 2, 2); the ranks' owned cells (the box's cells with a
    row mask) tile the lattice once; the row mask is the window's occupancy
    inside the owned cells."""
    ncells, cap = (9, 9, 9), 32
    Cg = 736
    xs = torch.rand(Cg, cap, 3)
    cell_id = torch.arange(Cg, dtype=torch.float32)[:, None].expand(Cg, cap).contiguous()
    mc = (torch.rand(Cg, cap) < 0.7).float()
    for grid, dims, box in (((2, 2), (7, 7, 9), ((1, 1, 0), (5, 5, 9))),
                            ((2, 2, 2), (7, 7, 7), ((1, 1, 1), (5, 5, 5)))):
        g3 = tuple(grid) + (1,) * (3 - len(grid))
        owned = torch.zeros(Cg)
        for rank in range(int(np.prod(grid))):
            coord = tuple(int(c) for c in np.unravel_index(rank, g3))
            sub, rows, subm, idx, wdims, rb = tpc.shard_window(ncells, g3, coord, xs, mc)
            assert (wdims, rb) == (dims, box), (grid, rank)
            assert torch.equal(sub, tpc.sub_lattice(xs, ncells, idx))
            ids = tpc.sub_lattice(cell_id, ncells, idx)[:, 0].long()
            ones = torch.ones(Cg, cap)
            _, own_rows, _, _, _, _ = tpc.shard_window(ncells, g3, coord, xs, ones)
            mine = ids[own_rows[:, 0] > 0]
            parts = [tpc.shard_part(ncells, g3, coord, d) for d in range(3)]
            assert mine.numel() == int(np.prod([p[1] for p in parts]))
            owned[mine] += 1
            assert torch.equal(rows, subm * own_rows)
        assert torch.equal(owned[:729], torch.ones(729))


def test_brick_collection_matches_replicated(tmp_path):
    """The brick-sharded hill collection, merged by global row key, is
    bitwise the replicated collection: 4 kT = 0.8 steps (two hill rounds)
    on the 5-cell lattice on (2, 2) and (2, 2, 2), every leaf."""
    params, core, spec = _ragged_setup()
    s0 = tpc.init_cell_state(spec, core)
    runs = [("sharded", dict(hill_capacity=512)),
            ("replicated", dict(hill_capacity=512, slab_collect=False))]
    jobs = [(ranks.slab_steps, int(np.prod(grid)), dict(
        params=to_numpy_tree(params), spec=dataclasses.asdict(spec), lj={}, hill_stride=2,
        port_state=s0, lp=dict(dt=0.002, friction=1.0, kT=0.8), n_steps=4, runs=runs,
        grid=grid)) for grid in ((2, 2), (2, 2, 2))]
    for res in _launch_bg(tmp_path, jobs)():
        sh, rep = res[0]["sharded"][-1], res[0]["replicated"][-1]
        for a, b in zip(jax.tree.leaves(sh), jax.tree.leaves(rep)):
            np.testing.assert_array_equal(a, b)
        assert float(sh["core"]["bias"]["cum_bias"]) > 0


# ------------------------------------------------------------ the work-sharded host


def test_sharded_cell_host_matches_jax(tmp_path):
    """The work-sharded cell host on 2 ranks against JAX's: 512 atoms on 3^3
    cells, cell_chunk 8 (Cp = 32 > C = 27), Chebyshev 16 x 4, 4 steps with
    hill_stride 2 at kT = 0 and 0.8, and the records of each step."""
    kw = dict(hill_capacity=64, cell_chunk=8, collect_records=True)
    inputs = {}
    for kT in (0.0, 0.8):
        params, bias_state, x0, box = _setup(8, jitter=0.05)
        spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
        core = jpe.init_state(bias_state, x0, jax.random.PRNGKey(0), **CHEB)
        inputs[kT] = (params, spec, init_sharded_cell_state(spec, core),
                      dict(dt=0.002, friction=1.0, kT=kT))
    join = _launch_bg(tmp_path, [(ranks.sharded_cells, 2, dict(
        params=to_numpy_tree(p), state=to_numpy_tree(s), spec=dataclasses.asdict(sp), lp=lp,
        lj={}, hill_stride=2, n_steps=4, kw=kw)) for p, sp, s, lp in inputs.values()])
    mesh = make_mesh(2)
    jout = {}
    for kT, (params, spec, st, lp) in inputs.items():
        jstep = make_sharded_cell_step(params, LangevinParams(**lp), LJParams(), spec,
                                       hill_stride=2, mesh=mesh, **kw)
        states, logs = [], []
        for _ in range(4):
            st, _, lg = jstep(st)
            states.append(to_numpy_tree(st))
            logs.append(to_numpy_tree(lg))
        jout[kT] = states, logs
    assert spec.ncells == (3, 3, 3)
    for kT, res in zip(inputs, join()):
        jstates, jlogs = jout[kT]
        for i, (got, ref) in enumerate(zip(res[0]["states"], jstates)):
            what = f"work-sharded kT={kT} step {i}"
            c, cref = got["core"], ref["core"]
            x, xref = np.asarray(c["x"], np.float64), np.asarray(cref["x"], np.float64)
            assert np.abs(x - xref).max() <= 4 * np.spacing(np.float32(np.abs(xref).max())), what
            v, vref = np.asarray(c["v"], np.float64), np.asarray(cref["v"], np.float64)
            assert np.abs(v - vref).max() <= 1e-5 * max(1.0, np.abs(vref).max()), what
            assert_forces(c["f"], cref["f"], what)
            for f in ("step", "last_calls", "hills_truncated", "key"):
                assert_exact(c[f], cref[f], f"{what} core.{f}")
            assert_exact(got["aid"], ref["aid"], f"{what} aid")
            assert_exact(got["table_overflow"], ref["table_overflow"], what)
            g, gref = c["bias"], cref["bias"]
            assert_tree(g["bias"]["grid"], gref["bias"]["grid"], 1e-5, f"{what} grid")
            assert_exact(g["cv_hist"]["values"], gref["cv_hist"]["values"], f"{what} histogram")
        for i, (lg, jl) in enumerate(zip(res[0]["logs"], jlogs)):
            assert_tree(lg, jl, 1e-5, f"work-sharded kT={kT} log {i}")
        for a, b in zip(jax.tree.leaves(res[1]), jax.tree.leaves(res[0])):
            np.testing.assert_array_equal(a, b)
        assert float(res[0]["states"][-1]["core"]["bias"]["cum_bias"]) > 0
        assert res[0]["host_syncs"] >= 4  # the dynamic step reads its counter


# ------------------------------------------------------------ the sharded coordinate host

COORD_CFG = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 10\n{density}dimension 1\n"
             "box_low 0\nbox_high 10\nbias_spacing 0.05\nbias_sigma 0.3\n")


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_coord_host_matches_jax(tmp_path, n):
    """test_parallel's two sharded coordinate cases on n ranks: 64 walkers
    with the default capacity (no compaction: every candidate gathered), and
    128 walkers with hill_capacity 64 against 0 (the compacted exchange
    against the full gather), 6 steps of hill_stride 2 each."""
    cases = {}
    for name, density, walkers, seed, key, caps in (("walkers", "", 64, 0, 0, (None,)),
                                                     ("compact", "hill_density 24\n", 128, 5, 2,
                                                      (64, 0))):
        params, state = JB.subdivide(parse_edm_text(COORD_CFG.format(density=density)), 1.0, 1.0,
                                     [0], [10], [0], [10], [True], [0], dtype=jnp.float32)
        lp = dict(dt=0.01, friction=2.0, kT=1.0)
        x0 = jnp.asarray(np.random.default_rng(seed).uniform(0, 10, (walkers, 1)), jnp.float32)
        st = jce.init_state(params, state, x0, jax.random.PRNGKey(key), LangevinParams(**lp))
        cases[name] = (params, st, lp, caps)
    join = _launch_bg(tmp_path, [(ranks.sharded_coord, n, dict(
        params=to_numpy_tree(p), state=to_numpy_tree(st), lp=lp, hill_stride=2, n_steps=6,
        capacities=caps)) for p, st, lp, caps in cases.values()])
    mesh = make_mesh(n)
    jref = {}
    for name, (params, st, lp, caps) in cases.items():
        for cap in caps:
            step = make_sharded_coord_step(params, LangevinParams(**lp), hill_stride=2, mesh=mesh,
                                           hill_capacity=cap)
            s = shard_coord_state(st, mesh)
            for _ in range(6):
                s, _ = step(s)
            jref[name, cap] = to_numpy_tree(s)
    results = dict(zip(cases, join()))
    for name, (_, _, _, caps) in cases.items():
        res = results[name]
        for cap in caps:
            ref = jref[name, cap]
            what = f"{name} hill_capacity={cap} on {n} ranks"
            x = np.concatenate([r[cap]["x"] for r in res])
            np.testing.assert_allclose(x, ref["x"], rtol=1e-5, atol=1e-5, err_msg=what)
            for r in res:
                got = r[cap]
                gv, gref = got["bias"]["bias"]["grid"]["values"], ref["bias"]["bias"]["grid"]["values"]
                np.testing.assert_allclose(gv, gref, rtol=1e-5,
                                           atol=1e-6 * max(1.0, np.abs(gref).max()), err_msg=what)
                assert_exact(got["bias"]["cv_hist"]["values"], ref["bias"]["cv_hist"]["values"], what)
                for f in ("step", "hills_truncated", "key"):
                    assert_exact(got[f], ref[f], f"{what} {f}")
                assert_exact(got["bias"]["steps"], ref["bias"]["steps"], what)
                assert abs(float(got["bias"]["cum_bias"]) - float(ref["bias"]["cum_bias"])) < 1e-5
                for a, b in zip(jax.tree.leaves(got["bias"]), jax.tree.leaves(res[0][cap]["bias"])):
                    np.testing.assert_array_equal(a, b)
            assert float(ref["bias"]["cum_bias"]) > 0 and not bool(ref["hills_truncated"])
    for r in results["compact"]:  # the compacted exchange replays the full gather's hills
        assert_exact(r[64]["bias"]["cv_hist"]["values"], r[0]["bias"]["cv_hist"]["values"])


# ------------------------------------------------------------ item 8: public names


def test_hill_weights_and_event_codes():
    from edm_tpu.ops.deposit import hill_weights as jhw

    for periodic in (False, True):
        params, state = JB.subdivide(parse_edm_text(COORD_CFG.format(density="")), 1.0, 1.0,
                                     [0], [10], [0], [10], [periodic], [0], dtype=jnp.float64)
        centers = np.random.default_rng(3).uniform(-0.5, 10.5, (40, 1))
        ref = np.asarray(jhw(state.bias, jnp.asarray(centers)))
        got = TD.hill_weights(to_port(state).bias, torch.as_tensor(centers))
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=1e-14)
        assert (ref > 0).any()
    for name in ("NEIGH_HILL", "BUFF_HILL", "BUFF_UNDO_HILL", "ADD_HILL", "ADD_UNDO_HILL",
                 "BUFF_ZERO_HILL"):
        assert getattr(TB, name) == getattr(JB, name)
