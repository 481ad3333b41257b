"""What the ranks of ``tests/test_torch_spatial*.py`` run: the spatial
host's cases of ``tests/test_spatial.py`` and the dry-run probes, on gloo
ranks on the CPU.

Like ``_torch_ranks.py`` this module imports only torch and the port.
``spatial_cases(path)`` reads a pickle of ``{"cases": [(name, kwargs),
...]}``, runs each case on a mesh over every rank and returns ``{name:
result}`` with the results as numpy trees (this rank's row of each state);
the files a case writes go to its ``out_dir``.  ``probes(path)`` runs the
named probes of ``edm_tpu_torch.parallel.dryrun``.
"""

from __future__ import annotations

import dataclasses
import os
import pickle

import torch

from _torch_parity import to_numpy_tree
from edm_tpu_torch import bias as TB
from edm_tpu_torch.grid import Grid, GridSpec
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.ops import prng
from edm_tpu_torch.parallel import make_mesh
from edm_tpu_torch.parallel import spatial as S
from edm_tpu_torch.utils.config import parse_edm_text
from edm_tpu_torch.utils.gridio import read_grid_file
from edm_tpu_torch.utils.hills_log import HillsLog

F64 = torch.float64
FROZEN = LangevinParams(dt=1e-8, friction=0.0, kT=0.0)


def _host(mesh, cfg, x0, skin, seed=0, lp=FROZEN, capacity=4, setup_kw=None, hill_stride=1,
          **step_kw):
    """(setup, state, step) of the spatial host on ``mesh`` in float64."""
    setup_kw = dict(setup_kw)
    setup, tmpl = S.spatial_subdivide(parse_edm_text(cfg), 1.0, 1.0, setup_kw.pop("parts"),
                                      skin, dtype=F64, device="cpu", **setup_kw)
    state = S.init_spatial_state(setup, tmpl, x0, prng.PRNGKey(seed), capacity, mesh)
    return setup, state, S.make_spatial_coord_step(setup, lp, hill_stride, mesh, **step_kw)


def _steps(step, state, n):
    for _ in range(n):
        state, e = step(state)
    return state, e


def _row(state, **extra):
    out = {"state": to_numpy_tree(state)}
    out.update(extra)
    return out


def targeting(mesh, cfg, x0, skin, tvals, n_rounds):
    tspec = GridSpec.create([0.0], [10.0], [0.05], [True])
    target = Grid(values=torch.as_tensor(tvals), derivs=None, spec=tspec, interpolate=False)
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8, target=target))
    state, e = _steps(step, state, n_rounds)
    return _row(state, energy=float(e), grid=S.gather_spatial_grid(setup, state))


def initial_bias(mesh, cfg, x0, skin, ivals, iders):
    spec = GridSpec.create([0.0], [10.0], [0.01], [True])
    initial = Grid(values=torch.as_tensor(ivals), derivs=torch.as_tensor(iders), spec=spec,
                   interpolate=True)
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8, initial_bias=initial))
    first = S.gather_spatial_grid(setup, state)
    init = to_numpy_tree(state)
    state, _ = step(state)
    return _row(state, init=init, grid0=first, grid=S.gather_spatial_grid(setup, state))


def nonperiodic(mesh, cfg, x0, skin, n_rounds):
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8, periodic=[False]))
    state, e = _steps(step, state, n_rounds)
    g = S.stitch_spatial_grid(setup, state)
    return _row(state, energy=float(e), nonperiodic0=setup.nonperiodic0,
                grid=(g.values.numpy(), g.derivs.numpy()))


def density(mesh, cfg, skin):
    out = {}
    for extra in ("hill_density 2\n", "hill_density 80\n"):
        setup, _ = S.spatial_subdivide(parse_edm_text(cfg + extra), 1.0, 1.0, 8, skin, dtype=F64,
                                       device="cpu")
        out[extra] = (setup.params.cfg.hill_density, setup.params.cfg.hill_prefactor)
    return out


def compacted(mesh, cfg, x0, skin):
    out = {}
    for cap in (16, 0):
        _, state, step = _host(mesh, cfg, x0, skin, seed=3, setup_kw=dict(parts=8),
                               hill_capacity=cap)
        out[cap] = to_numpy_tree(_steps(step, state, 4)[0])
    return out


def wraparound(mesh, cfg, x0, skin):
    _, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8))
    return _row(step(state)[0])


def rebin(mesh, cfg, x0, skin):
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8))
    if mesh.rank == 0:  # move one atom from slab 0 into slab 3's range
        x = state.x.clone()
        x[0, 0] = 4.0
        state = dataclasses.replace(state, x=x)
    state = S.rebin_spatial_atoms(setup, state, mesh)
    rebinned = to_numpy_tree(state)
    state, e = step(state)
    return _row(state, rebinned=rebinned, energy=float(e))


def hills_logging(mesh, cfg, x0, skin, out_dir):
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=8), collect_records=True)
    files = None
    if mesh.rank == 0:
        files = [HillsLog(os.path.join(out_dir, f"HILLS_{d}"), 1, setup.params.total_volume)
                 for d in range(mesh.size)]
    cum, totals = 0.0, []
    for r in range(2):
        state, _, log = step(state)
        added = S.log_spatial_round(files, log, r, cum)
        totals.append(added)
        cum += added
    texts = None
    if files is not None:
        for hl in files:
            hl.close()
        texts = [open(os.path.join(out_dir, f"HILLS_{d}")).read() for d in range(mesh.size)]
    return _row(state, texts=texts, totals=totals)


def write_roundtrip(mesh, cfg, x0, skin, out_dir, dim=1, parts=8):
    setup, state, step = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=parts))
    state, _ = step(state)
    path = os.path.join(out_dir, f"GBIAS{dim}")
    g = S.write_spatial_grid(setup, state, path)
    st = S.stitch_spatial_grid(setup, state)
    text = back = None
    if mesh.rank == 0:
        text = open(path).read()
        back = read_grid_file(path, dim=dim, interpolate=True, dtype=F64, device="cpu")
        back = (back.values.numpy(), tuple(back.spec.nbins))
    return _row(state, text=text, back=back, written=g.values.numpy(),
                stitched=st.values.numpy())


def brick_rebin(mesh, cfg, x0, skin):
    setup, state, _ = _host(mesh, cfg, x0, skin, setup_kw=dict(parts=(2, 4)))
    init = to_numpy_tree(state)
    if mesh.rank == 0:  # across the dim-1 face, and across the periodic dim-0 wrap
        x = state.x.clone()
        x[0] = torch.tensor([0.4, 2.6, 0.0], dtype=F64)
        x[1] = torch.tensor([-0.2, 0.3, 0.0], dtype=F64)
        state = dataclasses.replace(state, x=x)
    return _row(S.rebin_spatial_atoms(setup, state, mesh), init=init, widths=setup.widths)


def overlap(mesh, cfg, x0, skin):
    lp = LangevinParams(dt=1e-8, friction=0.0, kT=0.5)
    out = {}
    for name, cap, n in (("filt", 16, 3), ("full", 0, 3), ("tiny", 2, 1)):
        _, state, step = _host(mesh, cfg, x0, skin, lp=lp, setup_kw=dict(parts=8),
                               overlap_capacity=cap)
        out[name] = to_numpy_tree(_steps(step, state, n)[0])
    return out


def harmonic(x):
    """A harmonic well at x = 5 along dim 0 (per-atom energies, forces)."""
    d = x - torch.tensor([5.0, 0.0, 0.0], dtype=x.dtype)
    return 0.15 * torch.sum(d * d, dim=-1), -0.3 * d


def external(mesh, cfg, x0, skin):
    """Four steps with an external force and hill_stride 2: the dynamic
    step, and the static hill and plain steps through ``strided_segment``."""
    from edm_tpu_torch.models.driver import strided_segment

    lp = LangevinParams(dt=1e-3, friction=0.0, kT=0.0)
    kw = dict(lp=lp, setup_kw=dict(parts=8), hill_stride=2, external_force=harmonic)
    _, state, step = _host(mesh, cfg, x0, skin, **kw)
    energies = []
    for _ in range(4):
        state, e = step(state)
        energies.append(float(e))
    pair = [_host(mesh, cfg, x0, skin, **kw, static_do_hills=h)[2] for h in (True, False)]
    _, state0, _ = _host(mesh, cfg, x0, skin, **kw)
    static, _ = strided_segment(pair[0], pair[1], 2, 4)(state0)
    return _row(state, energies=energies, static=to_numpy_tree(static),
                host_syncs=(step.host_syncs, pair[0].host_syncs, pair[1].host_syncs))


def brick_serial(mesh, cfg, x0, skin, periodic, n_rounds=2):
    """A (2, 4) brick run against the port's serial windowed engine: the
    stitched grid and the windowed deposits of the same hills at the
    replayed heights (``GaussGrid.add_value``), float64."""
    setup, state, step = _host(mesh, cfg, x0, skin,
                               setup_kw=dict(parts=(2, 4), periodic=periodic))
    state, e = _steps(step, state, n_rounds)
    g = S.stitch_spatial_grid(setup, state)
    c = parse_edm_text(cfg)
    _, ref = TB.subdivide(c, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10], periodic, [0, 0],
                          dtype=F64, device="cpu")
    gf = ref.bias
    h = torch.full((x0.shape[0],), c.hill_prefactor / 2.0, dtype=F64)
    for _ in range(n_rounds):
        gf, _ = gf.add_value(torch.as_tensor(x0[:, :2]), h)
    return {"grid": (g.values.numpy(), g.derivs.numpy()),
            "ref": (gf.grid.values.numpy(), gf.grid.derivs.numpy()),
            "nbins": tuple(g.spec.nbins), "energy": float(e), "nonper": setup.nonper,
            "per_rank": float(state.bias.bias.grid.values.sum()),
            "cum_bias": float(state.bias.cum_bias), "total_volume": setup.params.total_volume}


CASES = {f.__name__: f for f in (targeting, initial_bias, nonperiodic, density, compacted,
                                 wraparound, rebin, hills_logging, write_roundtrip, brick_rebin,
                                 overlap, external, brick_serial)}


def spatial_cases(path: str):
    with open(path, "rb") as fh:
        d = pickle.load(fh)
    mesh = make_mesh(device="cpu")
    return {name: CASES[kw.pop("case", name)](mesh, **kw) for name, kw in d["cases"]}


def probes(path: str):
    """The named dry-run probes on this rank's mesh: {name: result}."""
    from edm_tpu_torch.parallel import dryrun

    with open(path, "rb") as fh:
        d = pickle.load(fh)
    mesh = make_mesh(device="cpu")
    return {name: getattr(dryrun, name)(mesh) for name in d["probes"]}
