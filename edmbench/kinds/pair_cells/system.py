"""The pair kind's system under test: ``edm_tpu_torch``'s pair-distance
cell host, built through the port's public entry points from a
configuration (``configs/<name>.json``), a traffic mix
(``mixes/<name>.json``) and the seed.  The mix's ``host`` picks the host: ``single`` (``make_cell_step`` on one card), ``slab``
(``parallel.make_slab_cell_step`` over ``parallel.make_mesh()``) or
``brick`` (``parallel.make_brick_cell_step`` over
``parallel.make_brick_mesh(*mix["mesh"])``); a sharded host is built in
each rank of a ``parallel.launch``, on the rank's replica of the state.

Only this module touches the port's models; the reference
(``reference.py``) never imports the port.  The port is imported
inside the functions, so that importing this module loads nothing."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ... import lattice

PATTERN = [("hill", 1), ("plain", 8), ("rebuild", 1)]  # the stride cycle


def edm_text(bias: dict) -> str:
    """The ``fix edm_pair`` configuration text of a 1-D pair-distance bias."""
    return (f"tempering {bias['tempering']}\nbias_factor {bias['bias_factor']}\n"
            f"hill_prefactor {bias['hill_prefactor']}\nbias_per_step {bias['bias_per_step']}\n"
            f"hill_density {bias['hill_density']}\ndimension 1\nbox_low 0\n"
            f"box_high {bias['box_high']}\nbias_spacing {bias['bias_spacing']}\n"
            f"bias_sigma {bias['bias_sigma']}\n")


def target_values(bias: dict, n_points: int, lo: float, dx: float) -> np.ndarray:
    """The target grid's values at its points, float64: ``-2 ln max(r,
    floor)``."""
    t = bias["target"]
    if t["kind"] != "neg2log":
        raise ValueError(f"unknown target kind {t['kind']!r}")
    r = np.arange(n_points) * dx + lo
    return -2.0 * np.log(np.maximum(r, t["floor"]))


@dataclasses.dataclass
class System:
    spec: object  # the port's CellSpec
    state: object  # the port's CellPairState
    steps: dict  # {phase: step} of PATTERN's phases
    box: list
    n_atoms: int
    mover_cap: int

    def host_syncs(self) -> int:
        return sum(s.host_syncs for s in self.steps.values())


def make_mesh(mix: dict):
    """This rank's mesh of the mix's sharded host (inside a
    ``parallel.launch``), or None for the single-card host."""
    from edm_tpu_torch import parallel

    host = mix.get("host", "single")
    if host == "single":
        return None
    if host == "slab":
        return parallel.make_mesh()
    if host == "brick":
        return parallel.make_brick_mesh(*mix["mesh"])
    raise ValueError(f"unknown host {host!r}: single, slab or brick")


def build(cfg: dict, mix: dict, seed: int, device, mesh=None) -> System:
    """Positions from the lattice, the Threefry key from ``seed``, the bias
    and target grids from the configuration; the static step of each phase
    of the stride cycle (``PATTERN``), of the mix's host (``mesh``: this
    rank's, from ``make_mesh``)."""
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.grid import Grid, GridSpec
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.cells import CellSpec
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.utils.config import parse_edm_text

    host = mix.get("host", "single")
    if (mesh is None) != (host == "single"):
        raise ValueError(f"host {host!r} wants {'a' if mesh is None else 'no'} mesh (make_mesh)")
    if mesh is None:
        make = make_cell_step
    else:
        from edm_tpu_torch import parallel

        sharded = parallel.make_slab_cell_step if host == "slab" else parallel.make_brick_cell_step
        make = functools.partial(sharded, mesh=mesh)
    b, c, h = cfg["bias"], cfg["cells"], cfg["host"]
    bh = float(b["box_high"])
    tspec = GridSpec.create([0.0], [bh], [b["bias_spacing"]], [False])
    target = Grid(values=torch.tensor(target_values(b, tspec.nbins[0], tspec.min[0], tspec.dx[0]),
                                      dtype=torch.float32, device=device),
                  derivs=None, spec=tspec, interpolate=False)
    params, bias_state = B.subdivide(parse_edm_text(edm_text(b)), b["temperature"],
                                     b["boltzmann_constant"], [0.0], [bh], [0.0], [bh], [False],
                                     [0.0], dtype=torch.float32, device=device, target=target)
    pts, box = lattice.positions(cfg, mix, device)
    n = pts.shape[0]
    core = pair_edm.init_state(bias_state, pts, PRNGKey(seed), n_est=n * h["n_est_per_atom"],
                               pair_lookup=cfg["lookup"])
    spec = CellSpec.create(box, cutoff=c["cutoff"], n_atoms=n, cap=c["cap"])
    caps = ({} if c["kernel_cap"] is None
            else dict(kernel_cap=c["kernel_cap"], overflow_cap=c["overflow_cap"]))
    state = init_cell_state(spec, core, **caps)
    lg, lj = cfg["langevin"], cfg["lj"]
    lp = LangevinParams(dt=lg["dt"], friction=lg["friction"], kT=lg["kT"], mass=lg["mass"])
    ljp = LJParams(epsilon=lj["epsilon"], sigma=lj["sigma"], rcut=lj["rcut"])
    mover_cap = max(256, -(-n // 32))
    flags = dict(hill=(True, True, False), plain=(False, False, False),
                 rebuild=(False, False, True))  # static hills, energy, rebuild
    steps = {phase: make(params, lp, ljp, spec, hill_stride=h["hill_stride"],
                         rebuild_stride=h["rebuild_stride"], energy_stride=h["energy_stride"],
                         hill_capacity=h["hill_capacity"], row_cap=h["row_cap"],
                         m_per_row=h["m_per_row"], cell_chunk=h["cell_chunk"],
                         mover_cap=mover_cap, use_pallas=True, static_do_hills=hs,
                         static_do_energy=es, static_do_rebuild=rs, **caps)
             for phase, (hs, es, rs) in flags.items()}
    return System(spec=spec, state=state, steps=steps, box=list(spec.box), n_atoms=n,
                  mover_cap=mover_cap)


def geometry(system: System) -> dict:
    """What the reference needs of the program's cell lattice to read its
    state: the slot layout (cells, cap, padded cells) and the host's
    mover budget.  The reference re-derives every value from positions."""
    spec = system.spec
    cg = system.state.mc.shape[0]
    return dict(ncells=tuple(spec.ncells), cap=spec.cap, cells_padded=cg, box=list(spec.box),
                n_atoms=spec.n_atoms, mover_cap=system.mover_cap)


def snapshot(state) -> dict:
    """A state's leaves as plain tensors and numbers (no port types): what
    the reference reads and judges."""
    core, bias = state.core, state.core.bias
    out = dict(
        xs=state.xs, vs=state.vs, fs=state.fs, mc=state.mc, aid=state.aid,
        key=np.asarray(core.key, np.uint32).copy(), step=core.step,
        last_calls=core.last_calls, energy=core.energy, hills_truncated=core.hills_truncated,
        table_overflow=state.table_overflow,
        grid_values=bias.bias.grid.values, grid_derivs=bias.bias.grid.derivs[:, 0],
        cum_bias=bias.cum_bias, buf_pos=bias.buf_pos[:, 0], buf_h=bias.buf_h,
        buf_left=bias.buf_left, buf_right=bias.buf_right,
    )
    if state.tail_count is not None:
        out.update(tail_count=state.tail_count, tail_fallbacks=state.tail_fallbacks,
                   kernel_cap=state.kernel_cap, overflow_cap=int(state.ovl.shape[0]))
    return out


def replicated(state) -> list:
    """The leaves of a sharded host's state that every rank must hold
    bitwise alike: positions, velocities, the bias grid's values, the bias
    added and the Threefry key."""
    bias = state.core.bias
    key = torch.as_tensor(np.asarray(state.core.key, np.uint32).astype(np.int64),
                          device=state.xs.device)
    return [state.xs, state.vs, bias.bias.grid.values, bias.cum_bias, key]


def counters(system: System) -> dict:
    """The port's own counters: the steps' host syncs and the state's
    fallback periods (one read of the device)."""
    st = system.state
    out = dict(host_syncs=system.host_syncs())
    if st.tail_fallbacks is not None:
        out["tail_fallbacks"] = int(st.tail_fallbacks)
    return out

