"""What the ranks of ``tests/test_torch_parallel.py`` run.

Each function here is the body of one rank, spawned by
``edm_tpu_torch.parallel.launch`` on the gloo backend on the CPU.  This
module imports only torch, numpy and the port: a rank never imports jax.
Inputs come in as a pickle file of numpy trees written by the test; each
rank returns its results as numpy trees.
"""

from __future__ import annotations

import pickle
import sys

import numpy as np
import torch

from _torch_parity import to_numpy_tree
from edm_tpu_torch import bias as TB
from edm_tpu_torch.convert import params_from_numpy, state_from_numpy
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.parallel import (
    all_gather,
    init_sharded_cell_state,
    make_brick_cell_step,
    make_brick_mesh,
    make_mesh,
    make_sharded_cell_step,
    make_sharded_coord_step,
    make_sharded_pair_step,
    make_slab_cell_step,
    psum,
    shard_coord_state,
    shard_pair_state,
)


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def collectives(path: str):
    """psum and all_gather of per-rank arrays from a seed (float32,
    float64, int64, bool), and whether jax is in this rank's modules."""
    seed = _load(path)
    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(seed + mesh.rank)
    out = {"rank": mesh.axis_index(), "size": mesh.size, "jax": "jax" in sys.modules,
           "threads": torch.get_num_threads()}
    for name, a in (("f32", rng.normal(size=(5, 3)).astype(np.float32)),
                    ("f64", rng.normal(size=(4,))),
                    ("i64", rng.integers(-9, 9, size=(6,))),
                    ("b", rng.random(7) < 0.5)):
        t = torch.as_tensor(a)
        out[name] = a
        out[name + "_gather"] = all_gather(t, mesh).numpy()
        if name != "b":
            out[name + "_psum"] = psum(t, mesh).numpy()
    out["scalar_psum"] = psum(torch.tensor(float(mesh.rank) + 0.25, dtype=torch.float64),
                              mesh).numpy()
    return out


def hills_round(path: str):
    """One ``add_hills_round(axis_name="dp")`` of this rank's hills."""
    d = _load(path)
    make_mesh(device="cpu")
    rank = torch.distributed.get_rank()
    params = params_from_numpy(d["params"], "cpu")
    state = state_from_numpy(d["state"], "cpu")
    pos, run, act = (torch.as_tensor(a[rank]) for a in (d["pos"], d["run"], d["active"]))
    new, rec, _ = TB.add_hills_round(params, state, pos, run, d["n_est"], active=act,
                                     axis_name="dp")
    return to_numpy_tree((new, rec))


def sharded_pair(path: str):
    """``n_steps`` of the sharded dense host from the full state; returns
    the rank's rows, the replicated leaves and the logs."""
    d = _load(path)
    mesh = make_mesh(device="cpu")
    params = params_from_numpy(d["params"], "cpu")
    state = shard_pair_state(_state(d), mesh)
    step = make_sharded_pair_step(params, LangevinParams(**d["lp"]), LJParams(**d["lj"]),
                                  d["box"], mesh=mesh, **d["kw"])
    logs = []
    for _ in range(d["n_steps"]):
        state, y = step(state)
        if isinstance(y, tuple):
            logs.append(to_numpy_tree(y[1]))
    return {"state": to_numpy_tree(state), "logs": logs}


def _state(d):
    """The input state: a numpy tree of the JAX package's (``state``) or a
    pickled state of the port's (``port_state``)."""
    if "port_state" in d:
        return d["port_state"]
    return state_from_numpy(d["state"], "cpu")


def _cell_setup(d, mesh):
    params = params_from_numpy(d["params"], "cpu")
    spec = tcells.CellSpec(**d["spec"])
    return params, spec, LangevinParams(**d["lp"]), LJParams(**d["lj"])


def brick_mesh(path: str):
    """The brick mesh of shape ``grid``: each axis' coordinate, psum and
    all_gather over the axis tuple of per-rank arrays from a seed, and what
    a mesh of the wrong size raises."""
    d = _load(path)
    mesh = make_brick_mesh(*d["grid"], device="cpu")
    axes = mesh.axis_names
    rng = np.random.default_rng(d["seed"] + mesh.rank)
    a = {"f32": rng.normal(size=(3, 2)).astype(np.float32), "i64": rng.integers(-9, 9, size=4)}
    out = {"rank": mesh.rank, "shape": mesh.shape, "axes": axes,
           "coords": [mesh.axis_index(ax) for ax in axes], "in": a}
    for name, v in a.items():
        out[name + "_psum"] = psum(torch.as_tensor(v), axes).numpy()
        out[name + "_gather"] = all_gather(torch.as_tensor(v), axes).numpy()
    try:
        make_brick_mesh(*d["wrong"], device="cpu")
        out["wrong"] = None
    except ValueError as e:
        out["wrong"] = str(e)
    return out


def slab_steps(path: str):
    """The slab host over every rank (or, with ``grid``, the brick host over
    that mesh), for each entry of ``runs`` (a name and the step's keyword
    arguments): ``n_steps`` steps from the input state, or (``each``) one
    step from each of the run's list of input states (``port_state[name]``).
    Returns the states after each step."""
    d = _load(path)
    if d.get("grid"):
        mesh = make_brick_mesh(*d["grid"], device="cpu")
        make = make_brick_cell_step
    else:
        mesh, make = make_mesh(device="cpu"), make_slab_cell_step
    params, spec, lp, lj = _cell_setup(d, mesh)
    out = {}
    for name, kw in d["runs"]:
        step = make(params, lp, lj, spec, d["hill_stride"], mesh, **kw)
        if d.get("each"):
            out[name] = [to_numpy_tree(step(s)[0]) for s in d["port_state"][name]]
            continue
        state, states = _state(d), []
        for _ in range(d["n_steps"]):
            state, _ = step(state)
            states.append(to_numpy_tree(state))
        out[name] = states
    return out


def collect_chunked(path: str):
    """One hill collection of the slab host (or, with ``grid``, the brick
    host) from the input state, for each pass-1 chunk limit of ``p1``
    (``ops.collect.P1_DRAWS``; None keeps the default); returns per
    limit the gathered round (hills, runifs, active, ncalls, truncated) and
    this rank's pass-1 row counts."""
    from edm_tpu_torch.ops import collect, prng

    d = _load(path)
    if d.get("grid"):
        mesh, make = make_brick_mesh(*d["grid"], device="cpu"), make_brick_cell_step
    else:
        mesh, make = make_mesh(device="cpu"), make_slab_cell_step
    params, spec, lp, lj = _cell_setup(d, mesh)
    state, default = _state(d), collect.P1_DRAWS
    out = {}
    for p1 in d["p1"]:
        collect.P1_DRAWS = default if p1 is None else p1
        try:
            step = make(params, lp, lj, spec, 10, mesh, hill_capacity=d["hill_capacity"])
            seen = []
            select = step._select_rows
            step._select_rows = lambda rc, *a: seen.append(rc) or select(rc, *a)
            res = step._collect_hills(state, state.xs, prng.PRNGKey(d["key"]),
                                      torch.tensor(d["last_calls"]), torch.float32)
        finally:
            collect.P1_DRAWS = default
        out[p1] = {"round": to_numpy_tree(res), "row_counts": seen[0].numpy()}
    return out


def slab_segment(path: str):
    """``pattern_segment`` over the slab host's three static phases with
    ``collect_records``; returns the final state and the stacked log."""
    d = _load(path)
    mesh = make_mesh(device="cpu")
    params, spec, lp, lj = _cell_setup(d, mesh)
    steps = [make_slab_cell_step(params, lp, lj, spec, d["hill_stride"], mesh,
                                 collect_records=True, **d["kw"], **ph) for ph in d["phases"]]
    seg = pattern_segment(list(zip(steps, d["counts"])), d["length"])
    state, (energies, log) = seg(_state(d))
    return {"state": to_numpy_tree(state), "log": to_numpy_tree(log),
            "energies": energies.numpy(), "host_syncs": [s.host_syncs for s in steps]}


def slab_on_card(path: str):
    """A slab step (or, with ``grid``, a brick step over that mesh) on the
    card against the single-device step: the ragged 12^3 lattice of
    test_torch_parallel (kernel_cap 24, overflow_cap 32), built on the
    rank's card through the port's entry points; each of ``n_steps`` steps
    from the single-device trajectory's state.  Returns both hosts' states
    after each step."""
    from edm_tpu_torch.models import pair_edm as tpe
    from edm_tpu_torch.models import pair_edm_cells as tpc
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.utils.config import parse_edm_text

    d = _load(path)
    mesh = make_brick_mesh(*d["grid"]) if d.get("grid") else make_mesh()
    dev = mesh.device
    params, bs = TB.subdivide(parse_edm_text(d["cfg"]), 1.0, 1.0, [0], [3.0], [0], [3.0],
                              [False], [0], dtype=torch.float32, device=dev)
    core = tpe.init_state(bs, torch.as_tensor(d["pts"], dtype=torch.float32, device=dev),
                          prng.PRNGKey(0), pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4)
    spec = tcells.CellSpec.create(d["box"], cutoff=3.0, n_atoms=len(d["pts"]))
    state = tpc.init_cell_state(spec, core, kernel_cap=24, overflow_cap=32)
    kw = dict(hill_stride=2, rebuild_stride=10, hill_capacity=512, kernel_cap=24,
              overflow_cap=32)
    lp, lj = LangevinParams(**d["lp"]), LJParams()
    one = tpc.make_cell_step(params, lp, lj, spec, use_pallas=True, **kw)
    make = make_brick_cell_step if d.get("grid") else make_slab_cell_step
    slab = make(params, lp, lj, spec, mesh=mesh, **kw)
    out = []
    for _ in range(d["n_steps"]):
        ref, _ = one(state)
        got, _ = slab(state)
        out.append((to_numpy_tree(got), to_numpy_tree(ref)))
        state = ref
    return out


def sharded_cells(path: str):
    """``n_steps`` of the work-sharded cell host from the input state, with
    records; returns the states and the logs after each step."""
    d = _load(path)
    mesh = make_mesh(device="cpu")
    params, spec, lp, lj = _cell_setup(d, mesh)
    step = make_sharded_cell_step(params, lp, lj, spec, d["hill_stride"], mesh, **d["kw"])
    state = init_sharded_cell_state(spec, _state(d).core)
    states, logs = [], []
    for _ in range(d["n_steps"]):
        state, (_, log) = step(state)
        states.append(to_numpy_tree(state))
        logs.append(to_numpy_tree(log))
    return {"states": states, "logs": logs, "host_syncs": step.host_syncs}


def sharded_coord(path: str):
    """``n_steps`` of the sharded coordinate host from the full state, for
    each ``hill_capacity`` of ``capacities``; returns the rank's states."""
    d = _load(path)
    mesh = make_mesh(device="cpu")
    params = params_from_numpy(d["params"], "cpu")
    out = {}
    for cap in d["capacities"]:
        step = make_sharded_coord_step(params, LangevinParams(**d["lp"]), d["hill_stride"], mesh,
                                       hill_capacity=cap)
        state = shard_coord_state(_state(d), mesh)
        for _ in range(d["n_steps"]):
            state, _ = step(state)
        out[cap] = to_numpy_tree(state)
    return out


def _ckpt_slab(mesh):
    """The slab host of tests/test_checkpoint.py's sharded case (an 8^3
    lattice, the Chebyshev table, kT = 0.8, hill_stride 2) with a bias that
    defers hills (tempering, a per-step cap below a hill's height)."""
    from edm_tpu_torch.models import pair_edm as tpe
    from edm_tpu_torch.models import pair_edm_cells as tpc
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.utils.config import parse_edm_text

    cfg = parse_edm_text("tempering 1\nbias_factor 10\nhill_prefactor 2.0\nbias_per_step 0.2\n"
                         "hill_density 20\ndimension 1\nbox_low 0\nbox_high 3.0\n"
                         "bias_spacing 0.02\nbias_sigma 0.1\n")
    params, bs = TB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=torch.float32, device="cpu")
    a = 1.26
    pts = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing="ij"), -1).reshape(-1, 3) * a + a / 2
    core = tpe.init_state(bs, torch.as_tensor(pts, dtype=torch.float32), prng.PRNGKey(0),
                          pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4)
    spec = tcells.CellSpec.create([8 * a] * 3, cutoff=3.0, n_atoms=len(pts))
    step = make_slab_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.8), LJParams(),
                               spec, 2, mesh, hill_capacity=512)
    return step, tpc.init_cell_state(spec, core)


def _ckpt_coord(mesh):
    """The sharded coordinate host over test_torch_checkpoint.py's coordinate
    case: 8 walkers on a 1-D grid, kT = 0.5, hill_stride 2, a per-step cap
    that defers hills."""
    from edm_tpu_torch.models import coord_edm as tce
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.utils.config import parse_edm_text

    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.5\nbias_per_step 0.4\nhill_density -1\n"
                         "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                         "bias_sigma 0.1\n")
    params, bs = TB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=torch.float64, device="cpu")
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.5, (8, 1)))
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.5)
    state = tce.init_state(params, bs, x0, prng.PRNGKey(1), lp)
    return make_sharded_coord_step(params, lp, 2, mesh), shard_coord_state(state, mesh)


def _ckpt_spatial(mesh):
    """The spatial host of tests/test_checkpoint.py's spatial case on this
    mesh's ranks: a 1-D grid over [0, 10] in slabs with a skin of 1.25, two
    frozen walkers a slab, hill_stride 1, and a per-step cap below a hill's
    height, so that rounds defer hills."""
    from _torch_spatial_ranks import _host

    cfg = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 0.5\ndimension 1\n"
           "box_low 0\nbox_high 10\nbias_spacing 0.01\nbias_sigma 0.2\n")
    w = 10.0 / mesh.size
    x0 = np.asarray([[d * w + 0.3, 0.0, 0.0] for d in range(mesh.size)]
                    + [[d * w + 1.2, 0.0, 0.0] for d in range(mesh.size)])
    _, state, step = _host(mesh, cfg, x0, 1.25, seed=3, setup_kw=dict(parts=mesh.size))
    return step, state


_CKPT_HOSTS = {"slab": _ckpt_slab, "coord": _ckpt_coord, "spatial": _ckpt_spatial}


def checkpoint_resume(path: str):
    """A sharded run checkpointed part way (``save_state`` with the mesh)
    and resumed into a freshly built template (``load_state`` with the
    mesh), against the uninterrupted run: ``n_steps`` steps in all, the
    checkpoint after ``n_mid``.  Returns both end states, the deferred
    hills at the checkpoint and the error of loading the file on a mesh of
    the same ranks in another shape."""
    from edm_tpu_torch.utils.checkpoint import load_state, save_state
    from edm_tpu_torch.utils.errors import EDMError

    d = _load(path)
    mesh = make_mesh(device="cpu")
    make = _CKPT_HOSTS[d["host"]]

    def run(step, state, n):
        for _ in range(n):
            state, _ = step(state)
        return state

    step, state = make(mesh)
    full = run(step, state, d["n_steps"])
    step, state = make(mesh)
    mid = run(step, state, d["n_mid"])
    bias = mid.core.bias if hasattr(mid, "core") else mid.bias
    save_state(mid, d["file"], mesh)
    step, fresh = make(mesh)
    cont = run(step, load_state(fresh, d["file"], mesh), d["n_steps"] - d["n_mid"])
    out = {"full": to_numpy_tree(full), "cont": to_numpy_tree(cont),
           "deferred": int(bias.buf_right) - int(bias.buf_left)}
    try:  # the same ranks as a 2-D mesh of another shape
        load_state(fresh, d["file"], make_brick_mesh(mesh.size, 1, device="cpu"))
        out["other_shape_error"] = None
    except EDMError as e:
        out["other_shape_error"] = str(e)
    return out


def _card_lattice(dev):
    """test_slab_step_two_ranks_on_card's jittered 12^3 lattice (a = 1.26,
    default_rng(3)) with the Chebyshev table, on ``dev``: (params, core,
    spec)."""
    from edm_tpu_torch.models import pair_edm as tpe
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.utils.config import parse_edm_text

    rng = np.random.default_rng(3)
    box = [12 * 1.26] * 3
    pts = (np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3) * 1.26
           + 0.63 + rng.normal(scale=0.05, size=(1728, 3))) % box[0]
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
                         "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                         "bias_sigma 0.1\n")
    params, bs = TB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=torch.float32, device=dev)
    core = tpe.init_state(bs, torch.as_tensor(pts, dtype=torch.float32, device=dev),
                          prng.PRNGKey(0), pair_lookup="chebyshev", cheb_deg=16, cheb_panels=4)
    return params, core, tcells.CellSpec.create(box, cutoff=3.0, n_atoms=len(pts))


COORD2D = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 64\n"
           "dimension 2\nbox_low 0 0\nbox_high 10 10\nbias_spacing 0.05 0.05\n"
           "bias_sigma 0.2 0.2\n")


def _card_host(host, mesh):
    """(step, state) of a sharded host on this rank's card, from a seed:
    ``cells`` the work-sharded cell host and ``brick`` the brick host over
    ``mesh`` (the lattice of ``_card_lattice``), ``coord`` the sharded 2-D
    host (1,024 walkers on a periodic 200 x 200 grid), ``spatial`` the
    spatial host on the same grid split (2, 1) or (2, 2) by the rank
    count.  kT = 0, hill_stride 2."""
    from edm_tpu_torch.models import coord_edm as tce
    from edm_tpu_torch.models import pair_edm_cells as tpc
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.parallel import spatial as S
    from edm_tpu_torch.utils.config import parse_edm_text

    dev = mesh.device
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    if host in ("cells", "brick"):
        params, core, spec = _card_lattice(dev)
        if host == "cells":
            step = make_sharded_cell_step(params, lp, LJParams(), spec, 2, mesh, hill_capacity=512)
            return step, init_sharded_cell_state(spec, core)
        step = make_brick_cell_step(params, lp, LJParams(), spec, 2, mesh, rebuild_stride=10,
                                    hill_capacity=512, kernel_cap=24, overflow_cap=32)
        return step, tpc.init_cell_state(spec, core, kernel_cap=24, overflow_cap=32)
    cfg = parse_edm_text(COORD2D)
    x0 = np.random.default_rng(5).uniform(0, 10, (1024, 2))
    if host == "coord":
        params, bs = TB.subdivide(cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10],
                                  [True, True], [0, 0], dtype=torch.float32, device=dev)
        state = tce.init_state(params, bs, torch.as_tensor(x0, dtype=torch.float32, device=dev),
                               prng.PRNGKey(1), lp)
        return make_sharded_coord_step(params, lp, 2, mesh), shard_coord_state(state, mesh)
    parts = (2, mesh.size // 2)
    setup, tmpl = S.spatial_subdivide(cfg, 1.0, 1.0, parts, 1.0, dtype=torch.float32,
                                      periodic=[True, True], device=dev)
    state = S.init_spatial_state(setup, tmpl, x0, prng.PRNGKey(0), 1024, mesh)
    return S.make_spatial_coord_step(setup, lp, 2, mesh), state


def card_host_steps(path: str):
    """``n_steps`` kT = 0 steps of one sharded host on the rank's card
    (``_card_host``: ``host`` and, for the brick, ``grid``); returns this
    rank's state after each step, the backend and the device."""
    d = _load(path)
    mesh = make_brick_mesh(*d["grid"]) if d.get("grid") else make_mesh()
    step, state = _card_host(d["host"], mesh)
    states = []
    for _ in range(d["n_steps"]):
        state, _ = step(state)
        states.append(to_numpy_tree(state))
    return {"states": states, "backend": mesh.backend, "device": str(mesh.device)}


def nccl_failure(path: str):
    """Rank 1 passes a host tensor to an NCCL collective, which raises
    there, after writing the time it does so to ``path``; the others wait
    in the collective that rank 1 never joins."""
    import time

    mesh = make_mesh()
    x = torch.ones(4, device=mesh.device)
    all_gather(x, mesh)  # the communicator is up on every rank
    if mesh.rank == 1:
        with open(path, "w") as fh:
            fh.write(repr(time.time()))
        all_gather(x.cpu(), mesh)
    return float(all_gather(x, mesh).sum())


def fail_and_hang(_):
    """Rank 0 raises at once; the others hang outside any collective."""
    import time

    make_mesh(device="cpu")
    if torch.distributed.get_rank() == 0:
        raise RuntimeError("rank 0 fails on purpose")
    time.sleep(600)
