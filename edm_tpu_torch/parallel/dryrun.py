"""The multi-device dry-run probes of ``__graft_entry__.py`` on the port.

Counterpart of ``__graft_entry__._dryrun_impl``: one step of each sharded
topology on small shapes, each held to the port's own single-device host
or serial engine on the same device, with the JAX probes' sizes, seeds and
bounds.  One function per probe, in the JAX order; each takes this rank's
``Mesh`` (every rank of it must call the probe) and returns ``{check:
(worst error, bound)}``, raising ``AssertionError`` if a check fails:

  1. ``sharded_pair_probe``: the sharded dense host, one hill step; the
     grid replicas bitwise the same on every rank;
  2. ``spatial_probe``: the spatial host on a 1-D grid, its stitched grid
     against the serial engine's replay of the same hills (``err < 1e-5``);
  3. ``overlap_probe``: the same with the overlap filter
     (``overlap_capacity=24``; ``ferr < 1e-5``, nothing truncated);
  4. ``sharded_cells_probe``: the work-sharded cell host (a finite step);
  5. ``slab_probe``: the slab host against the single-device cell host
     (grid ``gerr < 1e-4``, cum_bias 1e-3 relative);
  6. ``slab_kcap_probe``: the slab host at ``kernel_cap`` 8 against the
     single-device host at full cap (grid ``kerr < 1e-4``, positions 1e-4);
  7. ``brick_probe``: the brick host on 2 x 2 (a world of 4 ranks) or
     2 x 2 x 2 (8) against the single-device host (``bgerr < 1e-5``,
     positions 1e-5);
  8. ``brick_spatial_probe``: the spatial host on a 2-D grid split (2,
     n/2), its stitched grid against windowed deposits of the same hills
     (``bserr < 2e-5``).

A port mesh spans its whole world, so ``dryrun_multichip(n)`` launches the
1-D probes on ``n`` ranks, the 2 x 2 brick on 4 and the 2 x 2 x 2 brick on
8 (``parallel.launch``: NCCL with a card per rank, else gloo), and prints
each probe's seconds and worst error beside its bound.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import bias as B
from ..gauss import GaussGrid
from ..models import pair_edm
from ..models.cells import CellSpec
from ..models.langevin import LangevinParams
from ..models.lj import LJParams
from ..models.pair_edm_cells import init_cell_state, make_cell_step
from ..ops import prng
from ..utils.config import parse_edm_text
from .cells import (init_sharded_cell_state, make_brick_cell_step, make_sharded_cell_step,
                    make_slab_cell_step)
from .collectives import all_gather
from .mesh import Mesh, launch, make_brick_mesh, make_mesh
from .pair import make_sharded_pair_step, shard_pair_state
from .spatial import (gather_spatial_grid, init_spatial_state, make_spatial_coord_step,
                      spatial_subdivide, stitch_spatial_grid)

F32 = torch.float32
FROZEN = LangevinParams(dt=1e-9, friction=0.0, kT=0.0)
LJ = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
SPATIAL_CFG = ("tempering 0\nhill_prefactor 1.0\nbias_per_step 10\ndimension 1\n"
               "box_low 0\nbox_high 16\nbias_spacing 0.02\nbias_sigma 0.2\n")
CELL_CFG = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\ndimension 1\nbox_low 0\n"
            "box_high 2.6\nbias_spacing 0.02\nbias_sigma 0.1\n")


def _check(out: dict, what: str, err: float, bound: float, strict: bool = True):
    """Record ``what``'s worst error and its bound; raise unless ``err <
    bound`` (``err <= bound`` with ``strict`` False)."""
    out[what] = (float(err), float(bound))
    if not (err < bound if strict else err <= bound):
        raise AssertionError(f"dry run: {what} {err!r} beyond its bound {bound!r}")


def _finite(what: str, *ts):
    if not all(bool(torch.isfinite(t).all()) for t in ts):
        raise AssertionError(f"dry run: non-finite {what}")


def _max_diff(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _common(n_atoms: int, device):
    """__graft_entry__._common: the pair bias on [0, 3] and a cubic lattice
    of ``n_atoms`` at spacing 1.26."""
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\n"
                         "hill_density 50\ndimension 1\nbox_low 0\nbox_high 3.0\n"
                         "bias_spacing 0.02\nbias_sigma 0.1\n")
    params, bias_state = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                                     dtype=F32, device=device)
    side = int(round(n_atoms ** (1 / 3)))
    while side**3 < n_atoms:
        side += 1
    a = 1.26
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
           [:n_atoms] * a + 0.5 * a)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.8)
    x0 = torch.as_tensor(pts, dtype=F32).to(device)
    return params, bias_state, lp, [side * a] * 3, x0


def sharded_pair_probe(mesh: Mesh) -> dict:
    params, bias_state, lp, box, x0 = _common(8 * mesh.size, mesh.device)
    state = shard_pair_state(pair_edm.init_state(bias_state, x0, prng.PRNGKey(0)), mesh)
    step = make_sharded_pair_step(params, lp, LJ, box, hill_stride=1, mesh=mesh,
                                  hill_capacity=64)
    new, e = step(state)
    _finite("energy in the pair probe", e)
    g = all_gather(new.bias.bias.grid.values[None], mesh)
    out = {}
    _check(out, "pair grid replicas vs rank 0 (bitwise)", _max_diff(g, g[:1].expand_as(g)), 0.0,
           strict=False)
    if not float(new.bias.cum_bias) > 0:
        raise AssertionError("dry run: the pair probe deposited nothing")
    return out


def _spatial_1d(mesh: Mesh, **step_kw):
    """The 1-D spatial probe: frozen atoms, one hill round; returns
    (stitched grid's error against the serial replay, final state)."""
    dev = mesh.device
    n = mesh.size
    scfg = parse_edm_text(SPATIAL_CFG)
    setup, tmpl = spatial_subdivide(scfg, 1.0, 1.0, n, skin=1.2, device=dev)
    n_per = 4
    # hill centres off the grid points: 4 sigma / dx is exactly 40 here, and
    # an on-grid centre puts the float32 support cutoff on a knife edge
    # between the local and the global frames
    sx0 = np.stack([np.linspace(0.5037, 15.5037, n_per * n), np.zeros(n_per * n),
                    np.zeros(n_per * n)], axis=-1)
    state = init_spatial_state(setup, tmpl, sx0, prng.PRNGKey(1), capacity=8, mesh=mesh)
    step = make_spatial_coord_step(setup, FROZEN, hill_stride=1, mesh=mesh, **step_kw)
    state, e = step(state)
    _finite("energy in the spatial probe", e)
    params_f, state_f = B.subdivide(scfg, 1.0, 1.0, [0], [16], [0], [16], [True], [0],
                                    dtype=F32, device=dev)
    slab = (sx0[:, 0] // setup.slab_w).astype(int) % n
    n_loc = np.bincount(slab, minlength=n)
    h_per = np.asarray([scfg.hill_prefactor / max(int(n_loc[s]), 1) for s in slab])
    state_f, _, _ = B.add_hills_round(
        params_f, state_f, torch.as_tensor(sx0[:, :1], dtype=F32).to(dev),
        torch.zeros(len(sx0), dtype=F32, device=dev), 1.0,
        override_heights=torch.as_tensor(h_per, dtype=F32).to(dev))
    xg, vg = gather_spatial_grid(setup, state, mesh)
    err = np.abs(vg[np.argsort(xg)] - state_f.bias.grid.values.cpu().numpy()).max()
    return err, state


def spatial_probe(mesh: Mesh) -> dict:
    out = {}
    err, _ = _spatial_1d(mesh)
    _check(out, "spatial stitch vs serial engine", err, 1e-5)
    return out


def overlap_probe(mesh: Mesh) -> dict:
    out = {}
    err, state = _spatial_1d(mesh, overlap_capacity=24)
    _check(out, "overlap-filtered stitch vs serial engine", err, 1e-5)
    if bool(all_gather(state.hills_truncated[None], mesh).any()):
        raise AssertionError("dry run: the overlap filter truncated reachable hills")
    return out


def _cell_setup(device, n_c=128, L=8.0, seed=2):
    """The probes' cell host: ``n_c`` atoms uniform in a box of side ``L``
    from ``default_rng(seed)``, the cutoff 2.6, the bias on [0, 2.6]."""
    x = np.random.default_rng(seed).uniform(0, L, (n_c, 3))
    spec = CellSpec.create([L] * 3, cutoff=2.6, n_atoms=n_c)
    params, bias = B.subdivide(parse_edm_text(CELL_CFG), 1.0, 1.0, [0], [2.6], [0], [2.6],
                               [False], [0], dtype=F32, device=device)
    return spec, params, bias, torch.as_tensor(x, dtype=F32).to(device)


def sharded_cells_probe(mesh: Mesh) -> dict:
    spec, params, bias, x = _cell_setup(mesh.device)
    core = pair_edm.init_state(bias, x, prng.PRNGKey(3), pair_lookup="chebyshev")
    step = make_sharded_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.5), LJ,
                                  spec, hill_stride=1, mesh=mesh, hill_capacity=128)
    state, e = step(init_sharded_cell_state(spec, core))
    _finite("energy in the work-sharded cell probe", e, state.core.bias.bias.grid.values)
    return {}


def _slab_pair(mesh: Mesh, **kw):
    """One slab step (``kw``: kernel_cap, overflow_cap) and one step of the
    single-device cell host at full cap, from the same state."""
    spec, params, bias, x = _cell_setup(mesh.device)
    core = pair_edm.init_state(bias, x, prng.PRNGKey(4), pair_lookup="interp")
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.5)
    state = init_cell_state(spec, core, with_ids=False, **kw)
    slab = make_slab_cell_step(params, lp, LJ, spec, hill_stride=1, mesh=mesh,
                               hill_capacity=128, energy_stride=2, **kw)
    got, e = slab(state)
    _finite("energy in the slab probe", e)
    ref = make_cell_step(params, lp, LJ, spec, hill_stride=1, hill_capacity=128,
                         use_pallas=True, energy_stride=2)
    want, _ = ref(init_cell_state(spec, core, with_ids=False), None)
    return got, want


def slab_probe(mesh: Mesh) -> dict:
    got, want = _slab_pair(mesh)
    out = {}
    _check(out, "slab grid vs single device", _max_diff(got.core.bias.bias.grid.values,
                                                         want.core.bias.bias.grid.values), 1e-4)
    c, c_ref = float(got.core.bias.cum_bias), float(want.core.bias.cum_bias)
    _check(out, "slab cum_bias vs single device", abs(c - c_ref), 1e-3 * max(1.0, abs(c_ref)),
           strict=False)
    return out


def slab_kcap_probe(mesh: Mesh) -> dict:
    got, want = _slab_pair(mesh, kernel_cap=8, overflow_cap=8)
    out = {}
    _check(out, "kernel_cap slab grid vs single device at full cap",
           _max_diff(got.core.bias.bias.grid.values, want.core.bias.bias.grid.values), 1e-4)
    _check(out, "kernel_cap slab positions vs single device at full cap",
           _max_diff(got.xs, want.xs), 1e-4)
    if bool(got.table_overflow):
        raise AssertionError("dry run: the kernel_cap slab table overflowed")
    return out


def brick_probe(mesh: Mesh) -> dict:
    """The brick host on 2 x 2 (a world of 4 ranks) or 2 x 2 x 2 (8)."""
    grid = {4: (2, 2), 8: (2, 2, 2)}.get(mesh.size)
    if grid is None:
        raise ValueError(f"the brick probe runs on 4 or 8 ranks, not {mesh.size}")
    bmesh = make_brick_mesh(*grid, device=mesh.device)
    spec, params, bias, x = _cell_setup(mesh.device, L=12.0, seed=5)
    if min(spec.ncells) < 4:
        raise AssertionError("the brick probe needs >= 4 cells a dim")
    core = pair_edm.init_state(bias, x, prng.PRNGKey(6), pair_lookup="chebyshev", cheb_deg=16,
                               cheb_panels=4)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    step = make_brick_cell_step(params, lp, LJ, spec, hill_stride=1, mesh=bmesh,
                                hill_capacity=128)
    got, e = step(init_cell_state(spec, core, with_ids=False))
    _finite("energy in the brick probe", e)
    ref = make_cell_step(params, lp, LJ, spec, hill_stride=1, hill_capacity=128,
                         use_pallas=True)
    want, _ = ref(init_cell_state(spec, core, with_ids=False), None)
    label = "x".join(map(str, grid))
    out = {}
    _check(out, f"brick {label} grid vs single device",
           _max_diff(got.core.bias.bias.grid.values, want.core.bias.bias.grid.values), 1e-5)
    _check(out, f"brick {label} positions vs single device", _max_diff(got.xs, want.xs), 1e-5)
    return out


def brick_spatial_probe(mesh: Mesh) -> dict:
    if mesh.size % 2:
        return {}
    dev = mesh.device
    cfg = parse_edm_text("tempering 0\nhill_prefactor 1.0\nbias_per_step 10\ndimension 2\n"
                         "box_low 0 0\nbox_high 16 16\nbias_spacing 0.1 0.1\n"
                         "bias_sigma 0.4 0.4\n")
    parts = (2, mesh.size // 2)
    setup, tmpl = spatial_subdivide(cfg, 1.0, 1.0, parts, skin=1.2, device=dev)
    w0, w1 = setup.widths
    x0 = []
    for i in range(parts[0]):
        for j in range(parts[1]):
            x0.append([i * w0 + 0.5037, j * w1 + 0.4037, 0.0])
            x0.append([i * w0 + w0 - 0.3037, j * w1 + w1 - 0.2037, 0.0])
    x0 = np.asarray(x0)
    state = init_spatial_state(setup, tmpl, x0, prng.PRNGKey(7), capacity=8, mesh=mesh)
    step = make_spatial_coord_step(setup, FROZEN, hill_stride=1, mesh=mesh)
    state, e = step(state)
    _finite("energy in the brick-spatial probe", e)
    # the oracle deposits through the windowed route (GaussGrid.add_value),
    # as the local grids do: the engine's separable route differs by the
    # e^-8 corner class
    g = GaussGrid.create([0, 0], [16, 16], [0.1, 0.1], [True, True], [0.4, 0.4], dtype=F32,
                         device=dev)
    g, _ = g.add_value(torch.as_tensor(x0[:, :2], dtype=F32).to(dev),
                       torch.full((len(x0),), cfg.hill_prefactor / 2.0, dtype=F32, device=dev))
    st = stitch_spatial_grid(setup, state, mesh)
    out = {}
    _check(out, f"brick-spatial {parts[0]}x{parts[1]} stitch vs windowed deposits",
           _max_diff(st.values, g.grid.values), 2e-5)
    return out


PROBES = (sharded_pair_probe, spatial_probe, overlap_probe, sharded_cells_probe, slab_probe,
          slab_kcap_probe, brick_probe, brick_spatial_probe)


def _run(names):
    """One launch's probes on this rank: [(name, seconds, checks)] (rank 0's
    list; None on the others)."""
    mesh = make_mesh()
    fns = {f.__name__: f for f in PROBES}
    out = []
    for name in names:
        t = time.perf_counter()
        checks = fns[name](mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        out.append((name, time.perf_counter() - t, checks))
    return out if mesh.rank == 0 else None


def dryrun_multichip(n_devices: int, device=None, **launch_kw):
    """Run the eight probes in order through ``parallel.launch``: the 1-D
    probes on ``n_devices`` ranks, the brick probe on 4 and on 8 ranks;
    ``device`` (default the card) is the ranks' device.  Prints each
    probe's seconds and its worst error beside its bound, and returns
    [(probe, world size, seconds, checks)]."""
    device = "cuda" if device is None else device
    plan = [(n_devices, [f.__name__ for f in PROBES[:6]]), (4, ["brick_probe"]),
            (8, ["brick_probe"]), (n_devices, ["brick_spatial_probe"])]
    merged = []
    for n, names in plan:  # consecutive launches of one world size run as one
        if merged and merged[-1][0] == n:
            merged[-1][1].extend(names)
        else:
            merged.append((n, list(names)))
    results = []
    for n, names in merged:
        for name, secs, checks in launch(_run, n, names, device=device, **launch_kw)[0]:
            results.append((name, n, secs, checks))
            worst = "; ".join(f"{k} {e:.3e} (bound {b:.0e})" for k, (e, b) in checks.items())
            print(f"dry run {name} on {n} ranks: {secs:.2f} s" + (f"; {worst}" if worst else ""),
                  flush=True)
    return results


__all__ = ["PROBES", "dryrun_multichip"] + [f.__name__ for f in PROBES]
