"""PyTorch port: the multi-device layer against the JAX package.

Each multi-rank case spawns 2 to 4 gloo ranks on the CPU through
``edm_tpu_torch.parallel.launch``, with a ``FileStore`` in ``tmp_path``;
the ranks run ``tests/_torch_ranks.py``, which imports only torch and the
port.  Their inputs are made here with numpy from a seed (the JAX states
flattened to numpy trees) and passed as a file; their results come back as
numpy trees.  The JAX side runs in this process on ``make_mesh(n)`` of
conftest's 8 CPU devices, with the port's rank count, so that both split
the columns alike.

  - collectives: ``psum`` and ``all_gather`` on 2 and 3 ranks equal a numpy
    sum and concatenation in rank order, bitwise, on every rank;
  - ``bias.add_hills_round(axis_name=...)`` on 2 ranks against JAX's under
    ``shard_map``, float64 at 1e-12;
  - the sharded dense host (64 atoms, ``hill_stride=2``, ``hill_capacity=
    512``, 6 steps) on 2 and 4 ranks in float64: x, v, f, the grid and
    ``cum_bias`` at 1e-12, the counters exactly, the grid replicas bitwise,
    the ``collect_records`` logs against JAX's;
  - K1's owned-row pass (the plain version): bitwise the full-window pass
    with the halo rows masked, and JAX's owned-row ``newton_lattice_force``
    at the cell kernels' float32 tolerance, on a brick window and a slab
    window;
  - the slab host against JAX's ``make_slab_cell_step`` (512 atoms,
    Chebyshev 16 x 4, 4 steps) on 4 ranks over nx = 3 (the owned-row path;
    one rank owns no column) and on 2 ranks (the small-lattice branch), at
    kT = 0 and 0.8: positions within 4 float32 ulps of max|x|, velocities
    within 1e-5 * max(1, max|v|), forces within 2e-5 * max(1, max|f|) (the
    tolerances of ``test_torch_cellstep.py``), the integers exactly;
  - the ragged owned-row path on a 5-cell lattice (1,728 atoms, 2 ranks of
    3 + 2 columns and 3 ranks of 2 + 2 + 1) against the port's single-device
    host (itself pinned to JAX by the other files): 20 kT = 0 steps, each
    from the single-device trajectory's state, with ``kernel_cap`` 24 and
    ``overflow_cap`` 32 (K2 with the ownership masks) and 16 (a ``tail_ovf``
    period, K1 at full cap), forces at 2e-5 * max(1, max|f|), integers
    exactly; and ``pattern_segment`` over the slab phases, whose records
    equal the single-device host's;
  - the port's own bitwise identities: ``slab_collect`` and ``shard_floor``
    True equal False, and every rank's state equals rank 0's;
  - a round with a zero ``boundary_offset`` against JAX's; the item-7b
    entry points build.
"""

import dataclasses
import functools
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from _torch_parity import (
    assert_exact,
    assert_f64,
    assert_forces,
    assert_forces_at_edges,
    assert_tree,
    np_,
    to_numpy_tree,
    to_port,
)
from edm_tpu import bias as JB
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec, build_table
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import (
    _padded_cells,
    init_cell_state,
    newton_lattice_force,
)
from edm_tpu.parallel import make_mesh, make_sharded_pair_step, shard_pair_state
from edm_tpu.parallel.cells import make_slab_cell_step
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch import bias as TB
from edm_tpu_torch import parallel as tpar
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm as tpe
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import prng

CFG = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
       "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
A = 1.26
CHEB = dict(pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4)


def _setup(n_side, dtype=jnp.float32, jitter=0.0, seed=3):
    """test_parallel's lattice of n_side^3 atoms (a = 1.26), jittered by a
    normal of scale ``jitter`` from ``seed`` (on the perfect lattice the
    forces cancel below their terms' float32 rounding)."""
    params, state = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                                 [0], dtype=dtype)
    pts = (np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3)
           * A + 0.5 * A)
    pts = (pts + np.random.default_rng(seed).normal(scale=jitter, size=pts.shape)) % (n_side * A)
    return params, state, jnp.asarray(pts, dtype), [n_side * A] * 3


def _launch(tmp_path, fn, n, inputs, tag="run"):
    """Run ``fn`` on ``n`` gloo ranks with ``inputs`` pickled to a file."""
    path = tmp_path / f"{tag}.pkl"
    with open(path, "wb") as fh:
        pickle.dump(inputs, fh)
    return tpar.launch(fn, n, str(path), backend="gloo", device="cpu",
                       init_file=str(tmp_path / f"{tag}.store"), timeout=180)


def _launch_bg(tmp_path, jobs):
    """Start several launches at once (threads of this process), so that
    the ranks run while this process computes the JAX side; returns a
    function that waits for them and gives their results in job order."""
    out = [None] * len(jobs)
    errs = []

    def run(i, fn, n, inputs):
        try:
            out[i] = _launch(tmp_path, fn, n, inputs, tag=f"job{i}")
        except Exception as e:  # raised again by join, in the test's thread
            errs.append(e)

    th = [threading.Thread(target=run, args=(i, *j)) for i, j in enumerate(jobs)]
    for t in th:
        t.start()

    def join():
        for t in th:
            t.join()
        if errs:
            raise errs[0]
        return out

    return join


def _launch_all(tmp_path, jobs):
    return _launch_bg(tmp_path, jobs)()


# ------------------------------------------------------------ collectives


def test_collectives_rank_order(tmp_path):
    """psum and all_gather on 2 and 3 ranks: a numpy concatenation and a
    sum in rank order, bitwise, the same on every rank; the ranks run one
    torch thread and hold no jax."""
    r2, r3 = _launch_all(tmp_path, [(ranks.collectives, 2, 11), (ranks.collectives, 3, 11)])
    for res in (r2, r3):
        n = len(res)
        assert [r["rank"] for r in res] == list(range(n)) and res[0]["size"] == n
        assert not any(r["jax"] for r in res), "a spawned rank imported jax"
        assert all(r["threads"] == 1 for r in res)
        for name in ("f32", "f64", "i64", "b"):
            cat = np.concatenate([r[name] for r in res])
            for r in res:
                np.testing.assert_array_equal(r[name + "_gather"], cat)
                assert r[name + "_gather"].dtype == cat.dtype
            if name == "b":
                continue
            acc = res[0][name]
            for r in res[1:]:
                acc = acc + r[name]
            for r in res:
                np.testing.assert_array_equal(r[name + "_psum"], acc)
        want = 0.25
        for k in range(1, n):
            want = want + (k + 0.25)
        assert all(float(r["scalar_psum"]) == want for r in res)


def test_launch_reraises_a_rank_failure(tmp_path):
    with pytest.raises(RuntimeError, match="ranks failed"):
        _launch(tmp_path, ranks.hills_round, 2, {"missing": True})


def test_launch_stops_hung_ranks_after_the_grace(tmp_path):
    """A rank that fails while another hangs outside any collective: the
    launch raises with the failed rank's traceback once the grace
    (``timeout`` + 30 s) is over, and stops the hung rank at once."""
    import time

    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 fails on purpose") as err:
        tpar.launch(ranks.fail_and_hang, 2, None, backend="gloo", device="cpu",
                    init_file=str(tmp_path / "store"), timeout=1)
    assert "ranks [1] were stopped" in str(err.value)
    assert time.monotonic() - t < 1 + 30 + 15


def test_one_rank_mesh_without_a_group():
    mesh = tpar.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.axis_index(), mesh.devices.size) == (1, 0, 0, 1)
    assert mesh.axis_names == ("dp",) and tpar.mesh_of("dp") is mesh
    t = torch.arange(3.0)
    assert tpar.psum(t, "dp") is t and torch.equal(tpar.all_gather(t, mesh), t)


# ------------------------------------------------------------ hill rounds


def test_add_hills_round_axis_name_matches_jax(tmp_path):
    """Each rank deposits its own hills; ``axis_name`` sums the rounds'
    bias into every rank's cum_bias (float64, 1e-12)."""
    from jax.sharding import PartitionSpec as P

    params, state = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0],
                                 [False], [0], dtype=jnp.float64)
    rng = np.random.default_rng(4)
    n, H = 2, 16
    pos = rng.uniform(0.2, 2.8, (n, H, 1))
    run = rng.uniform(0.0, 1.0, (n, H))
    act = rng.random((n, H)) < 0.8
    mesh = make_mesh(n)
    join = _launch_bg(tmp_path, [(ranks.hills_round, n, dict(
        params=to_numpy_tree(params), state=to_numpy_tree(state), pos=pos, run=run, active=act,
        n_est=40.0))])

    def body(p, u, a):
        new, rec = JB.add_hills_round(params, state, p[0], u[0], 40.0, active=a[0],
                                      axis_name="dp")
        return jax.tree.map(lambda l: l[None], (new, rec))

    fn = jax.shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp"), P("dp")), out_specs=P("dp"),
                       check_vma=False)
    jout = jax.jit(fn)(jnp.asarray(pos), jnp.asarray(run), jnp.asarray(act))
    res, = join()
    for r in range(n):
        ref = to_numpy_tree(jax.tree.map(lambda l: np.asarray(np.asarray(l)[r]), jout))
        for got, want, what in zip(res[r], ref, ("state", "records")):
            assert_tree(got, want, 1e-12, f"rank {r} {what}")
    assert float(res[0][0]["cum_bias"]) == float(res[1][0]["cum_bias"]) > 0


# ------------------------------------------------------------ sharded pair host


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pair_host_matches_jax(tmp_path, n):
    params, bias_state, x0, box = _setup(4, jnp.float64)
    lp = dict(dt=0.002, friction=1.0, kT=0.8)
    mesh = make_mesh(n)
    st = jpe.init_state(bias_state, x0, jax.random.PRNGKey(0))
    kw = dict(hill_capacity=512, collect_records=True)
    join = _launch_bg(tmp_path, [(ranks.sharded_pair, n, dict(
        params=to_numpy_tree(params), state=to_numpy_tree(st), lp=lp, lj={},
        box=box, kw=dict(hill_stride=2, **kw), n_steps=6))])
    jstep = make_sharded_pair_step(params, LangevinParams(**lp), LJParams(), box, 2, mesh, **kw)
    js = shard_pair_state(st, mesh)
    jlogs = []
    for _ in range(6):
        js, _, lg = jstep(js)
        jlogs.append(to_numpy_tree(lg))
    res, = join()
    ref = to_numpy_tree(js)
    for f in ("x", "v", "f"):
        assert_f64(np.concatenate([r["state"][f] for r in res]), ref[f], f)
    for r in res:
        st_r = r["state"]
        assert_tree(st_r["bias"], ref["bias"], 1e-12, "bias")
        assert_f64(st_r["energy"], ref["energy"], "energy")
        for f in ("step", "last_calls", "hills_truncated", "key"):
            assert_exact(st_r[f], ref[f], f)
        # the grid replica is bitwise the same on every rank
        np.testing.assert_array_equal(st_r["bias"]["bias"]["grid"]["values"],
                                      res[0]["state"]["bias"]["bias"]["grid"]["values"])
        assert len(r["logs"]) == 6
        for k, (lg, jl) in enumerate(zip(r["logs"], jlogs)):
            assert_tree(lg, jl, 1e-12, f"log {k}")
    assert float(ref["bias"]["cum_bias"]) > 0 and not bool(ref["hills_truncated"])


# ------------------------------------------------------------ K1's owned rows


def _window_lattice():
    """test_parallel's 6 x 5 x 3 window of 500 random atoms, its slot
    lattice, and the Chebyshev 16 x 4 table (JAX and the port)."""
    rng = np.random.default_rng(7)
    box = [6 * 3.1, 5 * 3.1, 3 * 3.1]
    n = 500
    pts = (rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(box)).astype(np.float32)
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n)
    params, bias_state = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.05], [0], [3.05],
                                      [False], [0], dtype=jnp.float32)
    core = jpe.init_state(bias_state, jnp.asarray(pts), jax.random.PRNGKey(0), **CHEB)
    t = build_table(spec, jnp.asarray(pts))
    Cg, cap, C = _padded_cells(spec), spec.cap, spec.n_cells
    aid = np.concatenate([np.asarray(t.aid), np.full(Cg * cap - spec.n_slots, n)]).reshape(Cg, cap)
    mc = (aid < n).astype(np.float32)
    xs = np.where(aid[..., None] < n, pts[np.minimum(aid, n - 1)], 0.0).astype(np.float32)
    return spec, xs, mc, core.cheb, to_port(core).cheb


@pytest.mark.parametrize("row_box", [((1, 1, 0), (4, 3, 3)), ((1, 0, 0), (4, 5, 3))],
                         ids=["brick", "slab"])
def test_owned_row_kernel_matches_full_window_rows(row_box):
    """The owned-row pass equals the full-window pass with the rows outside
    the box masked (bitwise: the halo rows add exact zeros and the owned
    cells' sums run in the same order), and JAX's owned-row pass at the
    cell kernels' float32 tolerance.  The slab window masks its surplus
    column (x = 4) out of the rows inside the box, as a ragged rank does."""
    spec, xs, mc, jtab, ttab = _window_lattice()
    C, Cg = spec.n_cells, xs.shape[0]
    (ox, oy, oz), (rx, ry, rz) = row_box
    gx, gy, gz = np.meshgrid(*[np.arange(k) for k in spec.ncells], indexing="ij")
    own = ((gx >= ox) & (gx < ox + rx) & (gy >= oy) & (gy < oy + ry) & (gz >= oz)
           & (gz < oz + rz))
    if row_box[1][1] == spec.ncells[1]:
        own &= gx < ox + rx - 1  # the ragged rank's surplus column
    row_ok = np.concatenate([own.reshape(C), np.zeros(Cg - C, bool)])
    mc_rows = mc * row_ok[:, None].astype(np.float32)
    lj = LJParams()
    t = dict(xs=torch.as_tensor(xs), mc=torch.as_tensor(mc), rows=torch.as_tensor(mc_rows))
    kw = dict(rescredit=True, mc_cand=t["mc"])
    e_full, f_full = tpc.newton_lattice_force(t["xs"], t["rows"], spec.ncells, spec.box, TLJ(),
                                              ttab, True, **kw)
    e_own, f_own = tpc.newton_lattice_force(t["xs"], t["rows"], spec.ncells, spec.box, TLJ(),
                                            ttab, True, row_box=row_box, **kw)
    assert torch.isfinite(f_own).all() and float(f_own.abs().max()) > 0
    assert torch.equal(f_own, f_full)
    assert float(e_own) == pytest.approx(float(e_full), rel=1e-6)
    je, jf = jax.jit(lambda a, b, c: newton_lattice_force(
        a, b, c, spec.ncells, spec.cap, spec.box, lj, jtab, True, rescredit=True,
        row_box=row_box))(jnp.asarray(xs), jnp.asarray(mc_rows), jnp.asarray(mc))
    assert_forces_at_edges(f_own, jf, xs, mc, spec.box, ttab, "owned rows vs JAX")
    assert float(e_own) == pytest.approx(float(je), rel=1e-5)
    # the checks of the owned-row form
    R = rx * ry * rz
    rows = t["rows"][tpc.box_cells(spec.ncells, row_box, "cpu")]
    with pytest.raises(ValueError, match="rows"):
        tpc.cell_force_newton(t["xs"], rows[:-1], ttab, k=spec.cap, ncells=spec.ncells,
                              box=spec.box, lj=TLJ(), energy=True, row_box=row_box)
    with pytest.raises(ValueError, match="inside"):
        tpc.cell_force_newton(t["xs"], rows, ttab, k=spec.cap, ncells=spec.ncells, box=spec.box,
                              lj=TLJ(), energy=True, row_box=((3, 0, 0), (rx, ry, rz)))
    assert rows.shape[0] == R


# ------------------------------------------------------------ the slab host


@functools.lru_cache(maxsize=2)
def _slab_inputs(kT):
    params, bias_state, x0, box = _setup(8, jitter=0.05)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=x0.shape[0])
    core = jpe.init_state(bias_state, x0, jax.random.PRNGKey(0), **CHEB)
    st0 = init_cell_state(spec, core)
    lp = dict(dt=0.002, friction=1.0, kT=kT)
    return params, spec, st0, lp


def _assert_cell_state(port, ref, what):
    """The cell state at test_torch_cellstep.py's float32 tolerances, the
    integer leaves exactly."""
    xs, xref = np.asarray(port["xs"], np.float64), np.asarray(ref["xs"], np.float64)
    assert np.abs(xs - xref).max() <= 4 * np.spacing(np.float32(np.abs(xref).max())), what
    vs, vref = np.asarray(port["vs"], np.float64), np.asarray(ref["vs"], np.float64)
    assert np.abs(vs - vref).max() <= 1e-5 * max(1.0, np.abs(vref).max()), what
    assert_forces(port["fs"], ref["fs"], what)
    for f in ("aid", "mc", "table_overflow"):
        assert_exact(port[f], ref[f], f"{what} {f}")
    for f in ("step", "last_calls", "hills_truncated", "key"):
        assert_exact(port["core"][f], ref["core"][f], f"{what} core.{f}")
    g, gref = port["core"]["bias"], ref["core"]["bias"]
    assert_tree(g["bias"]["grid"], gref["bias"]["grid"], 1e-5, f"{what} grid")
    assert_exact(g["cv_hist"]["values"], gref["cv_hist"]["values"], f"{what} histogram")
    assert abs(float(g["cum_bias"]) - float(gref["cum_bias"])) <= 1e-5 * max(
        1.0, float(gref["cum_bias"]))


@pytest.mark.parametrize("n", [4, 2], ids=["row_box", "small_lattice"])
def test_slab_host_matches_jax(tmp_path, n):
    """4 steps of the slab host at kT = 0 and 0.8 against JAX's on the same
    rank count (hill_stride 2: two hill rounds each); the ranks' states
    bitwise rank 0's; slab_collect and shard_floor bitwise identities at
    kT = 0.8 (the JAX package's test_parallel pins the same)."""
    runs = [("kT0", dict(hill_capacity=512)),
            ("kT08", dict(hill_capacity=512)),
            ("kT08_replicated_collect", dict(hill_capacity=512, slab_collect=False)),
            ("kT08_replicated_floor", dict(hill_capacity=512, shard_floor=False))]
    jobs = []
    for kT, rr in ((0.0, runs[:1]), (0.8, runs[1:])):
        params, spec, st0, lp = _slab_inputs(kT)
        jobs.append((ranks.slab_steps, n, dict(
            params=to_numpy_tree(params), state=to_numpy_tree(st0), spec=dataclasses.asdict(spec),
            lp=lp, lj={}, hill_stride=2, n_steps=4, runs=rr)))
    join = _launch_bg(tmp_path, jobs)
    jref = {}
    mesh = make_mesh(n)
    for kT in (0.0, 0.8):
        params, spec, st0, lp = _slab_inputs(kT)
        jstep = make_slab_cell_step(params, LangevinParams(**lp), LJParams(), spec,
                                    hill_stride=2, mesh=mesh, hill_capacity=512)
        s = st0
        for _ in range(4):
            s, _ = jstep(s)
        jref[kT] = to_numpy_tree(s)
    assert spec.ncells == (3, 3, 3)
    res0, res8 = join()
    for res, name, kT in ((res0, "kT0", 0.0), (res8, "kT08", 0.8)):
        got = res[0][name][-1]
        _assert_cell_state(got, jref[kT], f"{name} on {n} ranks")
        assert float(got["core"]["bias"]["cum_bias"]) > 0
        for r in res[1:]:
            for a, b in zip(jax.tree.leaves(r[name][-1]), jax.tree.leaves(got)):
                np.testing.assert_array_equal(a, b)
    for other in ("kT08_replicated_collect", "kT08_replicated_floor"):
        for a, b in zip(jax.tree.leaves(res8[0][other][-1]), jax.tree.leaves(res8[0]["kT08"][-1])):
            np.testing.assert_array_equal(a, b, err_msg=other)


def _ragged_setup():
    """A 12^3 jittered lattice (a = 1.26) on 5 x 5 x 5 cells of cap 32."""
    params, bs = TB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(3)
    box = [12 * A] * 3
    pts = (np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3) * A
           + 0.5 * A + rng.normal(scale=0.05, size=(1728, 3))) % box[0]
    core = tpe.init_state(bs, torch.as_tensor(pts, dtype=torch.float32), prng.PRNGKey(0), **CHEB)
    return params, core, tcells.CellSpec.create(box, cutoff=3.0, n_atoms=1728)


def test_slab_host_ragged_lattice(tmp_path):
    """The ragged owned-row path against the port's single-device host on
    a 5-cell lattice, 2 ranks (3 + 2 columns) and 3 (2 + 2 + 1): 20 kT = 0
    steps, each from the single-device trajectory's state, 10 with K2 and
    its ownership masks (kernel_cap 24, overflow_cap 32) and 10 on a
    tail_ovf period (overflow_cap 16: K1 at full cap); then
    pattern_segment with records over a 10-step cycle at kT = 0.8."""
    params, core, spec = _ragged_setup()
    assert spec.ncells == (5, 5, 5)
    lp, lp8 = (dict(dt=0.002, friction=1.0, kT=kT) for kT in (0.0, 0.8))
    kw = dict(rebuild_stride=10, hill_capacity=512, use_pallas=True, kernel_cap=24)
    base = dict(params=to_numpy_tree(params), spec=dataclasses.asdict(spec), lj={}, hill_stride=10)
    # the segment: one cycle of a hill (+ energy) step, 8 plain steps and a
    # rebuild step, from the initial state
    phases = [dict(static_do_hills=True, static_do_rebuild=False),
              dict(static_do_hills=False, static_do_rebuild=False),
              dict(static_do_hills=False, static_do_rebuild=True)]
    s0 = tpc.init_cell_state(spec, core, kernel_cap=24, overflow_cap=32)
    join_seg = _launch_bg(tmp_path, [
        (ranks.slab_segment, n, dict(base, port_state=s0, lp=lp8, phases=phases,
                                     counts=(1, 8, 1), length=10, kw=dict(kw, overflow_cap=32)))
        for n in (2, 3)])
    traj, refs = {}, {}
    for name, ocap in (("reduced", 32), ("tail_ovf", 16)):
        s = tpc.init_cell_state(spec, core, kernel_cap=24, overflow_cap=ocap)
        assert s.tail_ovf_host == (ocap == 16) and 16 < int(s.tail_count) <= 32
        step = tpc.make_cell_step(params, TLP(**lp), TLJ(), spec, 10, overflow_cap=ocap, **kw)
        traj[name], refs[name] = [], []
        for _ in range(10):
            traj[name].append(s)
            s, _ = step(s)
            refs[name].append(to_numpy_tree(s))
    steps1 = [tpc.make_cell_step(params, TLP(**lp8), TLJ(), spec, 10, collect_records=True,
                                 overflow_cap=32, **kw, **ph) for ph in phases]
    s1, (_, log1) = pattern_segment(list(zip(steps1, (1, 8, 1))), 10)(s0)
    segs = join_seg()
    runs = [(name, dict(kw, overflow_cap=ocap)) for name, ocap in (("reduced", 32),
                                                                    ("tail_ovf", 16))]
    out = _launch_all(tmp_path, [(ranks.slab_steps, n, dict(
        base, port_state=traj, lp=lp, each=True, runs=runs)) for n in (2, 3)])
    for n, res, seg in zip((2, 3), out, segs):
        for name in ("reduced", "tail_ovf"):
            for i, (got, ref) in enumerate(zip(res[0][name], refs[name])):
                what = f"{n} ranks, {name} step {i}"
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
        ref_log = to_numpy_tree(log1)
        for r in seg:  # every rank's records: the single-device host's
            for a, b in zip(jax.tree.leaves(r["log"]), jax.tree.leaves(ref_log)):
                np.testing.assert_array_equal(a, b)
            assert_forces(r["state"]["xs"], np_(s1.xs), f"segment on {n} ranks")
            assert_exact(r["state"]["aid"], np_(s1.aid), "segment aid")
            assert r["host_syncs"] == [s.host_syncs for s in steps1]
    assert float(log1.rec.round_bias.sum()) > 0


# ------------------------------------------------------------ what raises


def test_unported_multi_device_options_raise():
    """Nothing raises any more: a round with a zero ``boundary_offset`` (the
    spatial host's; on this 1-D grid the dense tables with the table index
    computed from the shifted points) equals JAX's round with the same
    offset, float64 at 1e-12 and the integer leaves exactly.  The item-7b
    entry points build: ``make_brick_mesh`` (a one-rank mesh here: a 2 x 2
    grid needs 4 ranks), the brick step over a 1 x 1 grid, the work-sharded
    cell step and ``make_cell_step(axis_name=...)``."""
    params, _, x0, box = _setup(8)
    tspec = tcells.CellSpec(**dataclasses.asdict(CellSpec.create(box, 3.0, x0.shape[0])))
    args = (to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), TLJ(), tspec, 2)
    with pytest.raises(ValueError, match="asked for"):
        tpar.make_brick_mesh(2, 2, device="cpu")
    mesh = tpar.make_brick_mesh(1, 1, device="cpu")
    assert mesh.shape == (1, 1) and tpar.mesh_of(("bx", "by")) is mesh
    brick = tpar.make_brick_cell_step(*args, mesh=mesh)
    assert brick.grid == (1, 1, 1) and brick.mesh is mesh
    sharded = tpar.make_sharded_cell_step(*args, mesh=tpar.make_mesh(device="cpu"))
    assert sharded.chunks == 1 and sharded.Cp == 32
    assert tpc.make_cell_step(*args, use_pallas=True, axis_name="dp").axis_name == "dp"
    jparams, jbs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                                [0], dtype=jnp.float64)
    rng = np.random.default_rng(6)
    pos, run = rng.uniform(0.05, 2.95, (16, 1)), rng.uniform(0.0, 0.5, 16)
    jnew, jrec = JB.add_hills_round(jparams, jbs, jnp.asarray(pos), jnp.asarray(run), 16,
                                    boundary_offset=jnp.zeros(1))
    tnew, trec, _ = TB.add_hills_round(to_port(jparams), to_port(jbs), torch.as_tensor(pos),
                                       torch.as_tensor(run), 16,
                                       boundary_offset=torch.zeros(1, dtype=torch.float64))
    assert_tree(tnew, jnew, 1e-12, "zero-offset round")
    assert_tree(trec, jrec, 1e-12, "zero-offset records")
    assert float(tnew.cum_bias) > 0
