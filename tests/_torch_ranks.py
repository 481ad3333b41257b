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
