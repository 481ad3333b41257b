"""The spatially-sharded coordinate host: the CV range split into bricks,
one local bias grid per rank (the reference's MPI domain decomposition,
edm_bias.cpp:98-222, with its hill exchange, :614-920).

Counterpart of ``edm_tpu/parallel/spatial.py``.  The JAX host runs one SPMD
program whose state carries a leading device axis; here every rank is a
process that holds its own row of that state (``SpatialCoordState``, no
device axis) and decodes its brick from its rank, row-major over
``parts`` (``_dev_strides``).

* ``spatial_subdivide`` splits the CV range into equal bricks (an int
  ``n_dev`` is the slab decomposition ``(n_dev, 1, ...)``): every rank's
  local grid is the same static shape, in local coordinates (the brick
  starts at 0 along every sharded dim) with a skin on the sharded dims.
  A periodic sharded dim keeps the global length centred on the brick, so
  ``GaussGrid.remap`` delivers every hill's nearest image; a non-periodic
  one keeps the global box as its static boundary and shifts local
  coordinates by the rank's ``boundary_offset`` in every boundary-relative
  term (McGovern-De Pablo terms, masks, the boundary copies of
  ``ops/deposit._duplicate_boundary_dynamic``).
* A hill step: each rank draws its candidates' uniforms
  (``fold_in(key, 17)``), accepts against its own atom count, computes the
  heights on its round-start grid (the target evaluated at global
  positions), rank-compacts its accepted (position, height) pairs into
  ``hill_capacity`` rows, the rows are gathered in rank order and compacted
  again, optionally filtered to the hills that can reach this rank's grid
  (``overlap_capacity``), and replayed on every rank with those heights;
  ``cum_bias`` is the ``psum`` of the ranks' round bias, bitwise the same
  on every rank.
* Atoms follow bricks: ``rebin_spatial_atoms`` gathers every rank's atoms
  and each rank keeps its brick's; between calls an atom may drift up to
  ``skin`` outside its brick.
* The grid helpers (``stitch_``, ``gather_``, ``write_spatial_grid``) and
  ``init_spatial_state``, ``rebin_spatial_atoms`` and ``log_spatial_round``
  are called by every rank: the first three and the last two gather over
  the mesh, which hangs if a rank stays away.

Collectives of a step, entered by every rank whether or not it owns an
atom or accepts a hill: the bias energy's ``psum`` (two with an external
force); on a hill step also one ``all_gather`` of the (position, height,
active) rows, one ``psum`` of the count and the truncation flag, and the
round's ``psum``.  Everything but the force lookup and the replayed
deposit is integer or rank-order work, so the compacted exchange and the
overlap filter are exact.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import bias as B
from ..grid import Grid, GridSpec, device_const, grid_points
from ..models.coord_edm import CoordStep, compact_accepted
from ..models.langevin import LangevinParams, baoab_step
from ..ops import prng
from ..utils.config import EDMConfig
from .collectives import all_gather, psum
from .mesh import DATA_AXIS, Mesh, mesh_of

_NP = {torch.float32: np.float32, torch.float64: np.float64}


@dataclasses.dataclass(frozen=True)
class SpatialCoordState:
    """This rank's row of the spatial host's state."""

    x: torch.Tensor  # (cap, 3) GLOBAL coordinates of this brick's atoms
    v: torch.Tensor
    f: torch.Tensor
    valid: torch.Tensor  # (cap,) bool
    key: np.ndarray  # (2,) uint32 Threefry key, on the host
    bias: B.BiasState  # this rank's local-coordinate bias
    step: torch.Tensor  # int64 scalar
    energy: torch.Tensor
    # True once a compacted exchange or the overlap filter overflowed its
    # capacity (the round then dropped its tail)
    hills_truncated: Optional[torch.Tensor] = None


class SpatialSetup(NamedTuple):
    params: B.BiasParams  # local-coordinate params; the target stays global
    n_dev: int
    slab_w: float
    skin: float
    box_low0: float
    initial_stack: Optional[tuple] = None  # (values (n_dev, ...), derivs
    # (n_dev, ..., D)): each rank's local samples of the global initial bias
    nonperiodic0: bool = False
    parts: Optional[tuple] = None  # per-dim rank counts, prod = n_dev
    widths: Optional[tuple] = None  # per-dim brick widths
    lows: Optional[tuple] = None  # global box_low per dim
    nonper: Optional[tuple] = None  # per dim: sharded and globally non-periodic
    skins: Optional[tuple] = None  # per-dim skin (0 on unsharded dims)


def _brick_geometry(setup: SpatialSetup):
    """(parts, widths, lows, nonper), a slab setup built without them
    normalized."""
    if setup.parts is not None:
        return setup.parts, setup.widths, setup.lows, setup.nonper
    cfg = setup.params.cfg
    D = cfg.dim
    return (
        (setup.n_dev,) + (1,) * (D - 1),
        (setup.slab_w,) + tuple(cfg.box_high[d] - cfg.box_low[d] for d in range(1, D)),
        (setup.box_low0,) + tuple(cfg.box_low[d] for d in range(1, D)),
        (setup.nonperiodic0,) + (False,) * (D - 1),
    )


def _dev_strides(parts):
    """Row-major flat-index strides (dim 0 slowest): rank r's brick
    multi-index is i_k = (r // stride_k) % parts[k]."""
    D = len(parts)
    strides = [1] * D
    for d in range(D - 2, -1, -1):
        strides[d] = strides[d + 1] * parts[d + 1]
    return tuple(strides)


def spatial_subdivide(cfg: EDMConfig, temperature: float, boltzmann_constant: float, n_dev,
                      skin, dtype=torch.float32, buffer_size: int = B.BIAS_BUFFER_SIZE,
                      target=None, initial_bias=None, periodic=None, device="cuda"):
    """Equal-brick decomposition of the CV range over a grid of ranks.

    ``n_dev``: an int shards dim 0 into that many slabs; a tuple ``(p0,
    ..., pD-1)`` into a grid of bricks (dims with ``p_d == 1`` stay whole,
    in global coordinates).  ``skin``: a float for every sharded dim or one
    per dim.  ``periodic``: the global boundary's periodicity per dim
    (default all True); a non-periodic sharded dim engages
    ``boundary_offset``.  The hill density and prefactor are divided by the
    rank count (edm_bias.cpp:173-180, reset to 1 only on an exact-zero
    quotient).  ``target`` / ``initial_bias``: global grids (read from the
    config's files when not given); the target stays global, the initial
    bias is sampled at each rank's local grid points and added by
    ``init_spatial_state``.  Returns (SpatialSetup, the rank-independent
    BiasState template on ``device``)."""
    from ..utils.gridio import read_grid_file

    if target is None and cfg.target_filename:
        target = read_grid_file(cfg.target_filename, dim=cfg.dim, interpolate=False,
                                dtype=dtype, device=device)
    if initial_bias is None and cfg.initial_bias_filename:
        initial_bias = read_grid_file(cfg.initial_bias_filename, dim=cfg.dim, interpolate=True,
                                      dtype=dtype, device=device)
    D = cfg.dim
    if isinstance(n_dev, (int, np.integer)):
        parts = (int(n_dev),) + (1,) * (D - 1)
    else:
        parts = tuple(int(p) for p in n_dev)
        if len(parts) < D:
            parts = parts + (1,) * (D - len(parts))
        if len(parts) != D or any(p < 1 for p in parts):
            raise ValueError(f"parts {parts} incompatible with dim {D}")
    n_total = int(np.prod(parts))
    skins_in = [float(skin)] * D if np.isscalar(skin) else [float(s) for s in skin]
    sharded = [p > 1 for p in parts]
    lows = tuple(float(lo) for lo in cfg.box_low)
    lens = tuple(float(cfg.box_high[d] - cfg.box_low[d]) for d in range(D))
    widths = tuple(lens[d] / parts[d] for d in range(D))
    if cfg.hill_density > 0:
        hd = cfg.hill_density / n_total
        cfg = dataclasses.replace(cfg, hill_density=hd if hd != 0 else 1.0,
                                  hill_prefactor=cfg.hill_prefactor / n_total)
    periodic = [True] * D if periodic is None else [bool(p) for p in periodic]
    box_lo_loc, box_hi_loc, sublo, subhi, skins = [], [], [], [], []
    for d in range(D):
        if not sharded[d]:
            box_lo_loc.append(cfg.box_low[d])
            box_hi_loc.append(cfg.box_high[d])
            sublo.append(cfg.box_low[d])
            subhi.append(cfg.box_high[d])
            skins.append(0.0)
            continue
        mid = widths[d] / 2.0
        if periodic[d]:  # the global length centred on the brick
            box_lo_loc.append(mid - lens[d] / 2.0)
            box_hi_loc.append(mid + lens[d] / 2.0)
        else:  # the global box, shifted so that box_low_d -> 0
            box_lo_loc.append(0.0)
            box_hi_loc.append(lens[d])
        sublo.append(0.0)
        subhi.append(widths[d])
        skins.append(skins_in[d])
    cfg_loc = dataclasses.replace(cfg, box_low=tuple(box_lo_loc), box_high=tuple(box_hi_loc))
    params, state = B.subdivide(cfg_loc, temperature, boltzmann_constant, sublo, subhi,
                                cfg_loc.box_low, cfg_loc.box_high, periodic, skins, dtype=dtype,
                                device=device, buffer_size=buffer_size, n_replicas=n_total)
    for d in range(D):
        if not (sharded[d] and periodic[d]):
            continue
        # a hill must have a unique nearest image with respect to each grid
        support = 4.0 * np.sqrt(2.0) * cfg.bias_sigma[d]
        if widths[d] + 2 * skins[d] + 2 * support >= lens[d]:
            raise ValueError(
                f"dim {d} bricks too wide for unique nearest-image hill delivery: width "
                f"{widths[d]} + 2*skin {skins[d]} + 2*support {support} >= L {lens[d]}")
    if target is not None:
        params = dataclasses.replace(params, target=target,
                                     expected_target=target.expected_bias().to(dtype))

    strides = _dev_strides(parts)
    initial_stack = None
    if initial_bias is not None:
        pts = grid_points(state.bias.grid.spec, dtype, device)  # local coordinates
        vals, ders = [], []
        for dev in range(n_total):
            ptsd = pts.clone()
            for d in range(D):
                if sharded[d]:
                    i_d = (dev // strides[d]) % parts[d]
                    ptsd[..., d] = ptsd[..., d] + (lows[d] + i_d * widths[d])
            v, dv = initial_bias.get_value_deriv(ptsd)
            vals.append(v)
            ders.append(dv)
        initial_stack = (torch.stack(vals), torch.stack(ders))

    nonper = tuple(sharded[d] and not periodic[d] for d in range(D))
    setup = SpatialSetup(params, n_total, float(widths[0]), float(skins[0] or skins_in[0]),
                         float(lows[0]), initial_stack=initial_stack, nonperiodic0=nonper[0],
                         parts=parts, widths=widths, lows=lows, nonper=nonper,
                         skins=tuple(skins))
    return setup, state


def _bin_devices(setup: SpatialSetup, x: np.ndarray) -> np.ndarray:
    """Host-side brick of each atom: the flat rank, row-major over the
    sharded dims (periodic dims wrap, non-periodic ones clip to the edge
    brick)."""
    parts, widths, lows, nonper = _brick_geometry(setup)
    strides = _dev_strides(parts)
    dev_of = np.zeros(x.shape[0], int)
    for d in range(len(parts)):
        if parts[d] == 1:
            continue
        L = widths[d] * parts[d]
        if nonper[d]:
            wrapped = np.clip(x[:, d], lows[d], lows[d] + L)
        else:
            wrapped = lows[d] + np.mod(x[:, d] - lows[d], L)
        i_d = np.clip((wrapped - lows[d]) // widths[d], 0, parts[d] - 1)
        dev_of += i_d.astype(int) * strides[d]
    return dev_of


def _park_empty(setup: SpatialSetup, xs: np.ndarray, dev: int, start: int):
    """Park rank ``dev``'s empty slots ``xs[start:]`` (this rank's rows) at
    the brick centre along every sharded dim, so that masked lookups stay in
    range; other columns keep what they hold."""
    parts, widths, lows, _ = _brick_geometry(setup)
    strides = _dev_strides(parts)
    for d in range(len(parts)):
        if parts[d] == 1:
            continue
        i_d = (dev // strides[d]) % parts[d]
        xs[start:, d] = lows[d] + i_d * widths[d] + widths[d] / 2


def _check_capacity(dev_of: np.ndarray, ok: np.ndarray, n_dev: int, capacity: int):
    """Raise on every rank alike if a brick holds more atoms than its slots."""
    counts = np.bincount(dev_of[ok], minlength=n_dev)
    for d in range(n_dev):
        if counts[d] > capacity:
            raise ValueError(f"device {d}: {counts[d]} atoms > capacity {capacity}")


def init_spatial_state(setup: SpatialSetup, state_template: B.BiasState, x0, key,
                       capacity: int, mesh: Mesh) -> SpatialCoordState:
    """This rank's initial state: every rank bins the same ``x0`` on the
    host and keeps its brick's atoms in its first slots; its key is
    ``prng.split(key, n_dev)[rank]``; its bias is the template (on the
    mesh's device) plus, with an initial bias, its local samples of it."""
    n_dev, rank, dev = setup.n_dev, mesh.rank, mesh.device
    if mesh.size != n_dev:
        raise ValueError(f"a setup of {n_dev} bricks on a mesh of {mesh.size} ranks")
    x0 = np.asarray(x0, float)
    dev_of = _bin_devices(setup, x0)
    _check_capacity(dev_of, np.ones(len(x0), bool), n_dev, capacity)
    dtype = state_template.bias.dtype
    mine = np.nonzero(dev_of == rank)[0]
    xs = np.zeros((capacity, x0.shape[1]))
    xs[: len(mine)] = x0[mine]
    _park_empty(setup, xs, rank, len(mine))
    valid = np.zeros(capacity, bool)
    valid[: len(mine)] = True
    bias = state_template
    if setup.initial_stack is not None:  # edm_bias.cpp:166-167, per rank
        iv, idr = setup.initial_stack
        g = bias.bias.grid
        g = dataclasses.replace(g, values=g.values + iv[rank].to(dtype),
                                derivs=g.derivs + idr[rank].to(dtype))
        bias = dataclasses.replace(bias, bias=dataclasses.replace(bias.bias, grid=g))
    zeros = torch.zeros((capacity, x0.shape[1]), dtype=dtype, device=dev)
    return SpatialCoordState(
        x=torch.as_tensor(xs, dtype=dtype).to(dev), v=zeros, f=zeros.clone(),
        valid=torch.as_tensor(valid).to(dev), key=np.asarray(prng.split(key, n_dev)[rank]),
        bias=bias, step=torch.zeros((), dtype=torch.int64, device=dev),
        energy=torch.zeros((), dtype=dtype, device=dev),
        hills_truncated=torch.zeros((), dtype=torch.bool, device=dev))


def rebin_spatial_atoms(setup: SpatialSetup, state: SpatialCoordState,
                        mesh: Mesh) -> SpatialCoordState:
    """Atom migration (the LAMMPS re-decomposition analog): every rank's x,
    v, f and valid are gathered in rank order (one ``all_gather``), binned
    by brick on the host, and each rank keeps its brick's atoms in order;
    its empty slots keep their positions, parked at the brick centre along
    the sharded dims.  Every rank must call it."""
    cap, ncol = state.x.shape
    dtype, dev = state.x.dtype, state.x.device
    rows = torch.cat([state.x, state.v, state.f, state.valid[:, None].to(dtype)], 1)
    g = all_gather(rows, mesh).cpu().numpy()
    xs, vs, fs = g[:, :ncol], g[:, ncol:2 * ncol], g[:, 2 * ncol:3 * ncol]
    ok = g[:, 3 * ncol] > 0.5
    dev_of = _bin_devices(setup, xs)
    _check_capacity(dev_of, ok, setup.n_dev, cap)
    mine = np.nonzero(ok & (dev_of == mesh.rank))[0]
    nx = state.x.cpu().numpy().copy()
    nv = np.zeros_like(nx)
    nf = np.zeros_like(nx)
    nx[: len(mine)] = xs[mine]
    _park_empty(setup, nx, mesh.rank, len(mine))
    nv[: len(mine)] = vs[mine]
    nf[: len(mine)] = fs[mine]
    nvalid = np.zeros(cap, bool)
    nvalid[: len(mine)] = True
    return dataclasses.replace(state, x=torch.as_tensor(nx).to(dev), v=torch.as_tensor(nv).to(dev),
                               f=torch.as_tensor(nf).to(dev),
                               valid=torch.as_tensor(nvalid).to(dev))


def _global_spec(setup: SpatialSetup, spec) -> GridSpec:
    """The GLOBAL GridSpec of the stitched grid: unsharded dims pass through
    (``GridSpec.create`` of the local spec's range, its non-periodic max
    deflated); a sharded dim spans the full CV range with ``parts[d]`` times
    the brick's ``round(w_d / dx_d)`` owned points, plus the global-max
    point when it is non-periodic.  The JAX package takes
    ``ceil(L / dx_local)`` points there, which gives one point more, never
    written, where the local spacing rounds a hair below the global one
    (the 1-D dry-run grid on 2 ranks); elsewhere the two agree."""
    parts, widths, lows, nonper = _brick_geometry(setup)
    mins, maxs, dxs, ns, per = [], [], [], [], []
    for d in range(spec.dim):
        if parts[d] == 1:
            hi = spec.max[d] - (0 if spec.periodic[d] else spec.dx[d])
            g = GridSpec.create([spec.min[d]], [hi], [spec.dx[d]], [spec.periodic[d]])
            mins.append(g.min[0])
            maxs.append(g.max[0])
            dxs.append(g.dx[0])
            ns.append(g.nbins[0])
            per.append(g.periodic[0])
            continue
        lo, hi = lows[d], lows[d] + widths[d] * parts[d]
        n = int(round(widths[d] / float(spec.dx[d]))) * parts[d]
        dx = (hi - lo) / n
        mins.append(lo)
        maxs.append(hi + dx if nonper[d] else hi)
        dxs.append(dx)
        ns.append(n + 1 if nonper[d] else n)
        per.append(not nonper[d])
    return GridSpec(tuple(mins), tuple(maxs), tuple(dxs), tuple(ns), tuple(per))


def _stitch_arrays(setup: SpatialSetup, spec, arrs):
    """Global numpy arrays from the ranks' owned brick regions.  ``arrs``:
    (n_dev, *local grid shape, *trailing) arrays.  Each rank contributes the
    rows whose local coordinate along every sharded dim lies in [0, w_d),
    plus the global-max point on the last brick of a non-periodic dim,
    chosen in integer index space.  Returns (global arrays, gspec)."""
    parts, widths, _, nonper = _brick_geometry(setup)
    strides = _dev_strides(parts)
    gspec = _global_spec(setup, spec)
    D = spec.dim
    loc_idx = [[None, None] for _ in range(D)]  # [not the last brick, the last]
    n_own = [0] * D
    for d in range(D):
        n_d = int(spec.nbins[d])
        if parts[d] == 1:
            idx = np.arange(n_d)
            loc_idx[d] = [idx, idx]
            continue
        k0 = int(round(-float(spec.min[d]) / float(spec.dx[d])))
        n_own[d] = int(round(widths[d] / float(spec.dx[d])))
        idx = np.arange(k0, k0 + n_own[d])
        idx_last = np.arange(k0, k0 + n_own[d] + 1) if nonper[d] else idx
        if k0 < 0 or idx_last[-1] >= n_d:
            raise ValueError(f"dim {d}: owned rows [{k0}, {idx_last[-1]}] exceed the local "
                             f"grid ({n_d} points)")
        loc_idx[d] = [idx, idx_last]
    outs = [np.zeros(tuple(int(b) for b in gspec.nbins) + a.shape[1 + D:], a.dtype)
            for a in arrs]
    for dev in range(int(np.prod(parts))):
        lsel, gsel = [], []
        for d in range(D):
            i_d = (dev // strides[d]) % parts[d]
            li = loc_idx[d][1 if i_d == parts[d] - 1 else 0]
            lsel.append(li)
            gsel.append(li if parts[d] == 1 else li - li[0] + i_d * n_own[d])
        for a, out in zip(arrs, outs):
            out[np.ix_(*gsel)] = a[dev][np.ix_(*lsel)]
    return outs, gspec


def _gathered_grids(state: SpatialCoordState, mesh):
    """Every rank's local grid values and derivatives, in rank order, on the
    host: [(n_dev, ...), (n_dev, ..., D)]."""
    mesh = mesh_of(DATA_AXIS) if mesh is None else mesh
    g = state.bias.bias.grid
    return [all_gather(t[None], mesh).cpu().numpy() for t in (g.values, g.derivs)]


def stitch_spatial_grid(setup: SpatialSetup, state: SpatialCoordState, mesh=None) -> Grid:
    """The GLOBAL bias grid (values and derivatives) stitched from the
    ranks' bricks, on every rank, on the state's device.  ``mesh``: the
    host's mesh (default: the one registered under "dp").  Every rank must
    call it."""
    spec = state.bias.bias.spec.grid
    (gv, gd), gspec = _stitch_arrays(setup, spec, _gathered_grids(state, mesh))
    dev = state.x.device
    return Grid(values=torch.as_tensor(gv).to(dev), derivs=torch.as_tensor(gd).to(dev),
                spec=gspec, interpolate=bool(state.bias.bias.grid.interpolate))


def gather_spatial_grid(setup: SpatialSetup, state: SpatialCoordState, mesh=None):
    """The stitched grid as (global dim-0 coordinates, values), numpy, on
    every rank (the slab view; ``stitch_spatial_grid`` gives the Grid)."""
    g = stitch_spatial_grid(setup, state, mesh)
    xg = g.spec.min[0] + g.spec.dx[0] * np.arange(int(g.spec.nbins[0]))
    return xg, g.values.cpu().numpy()


def write_spatial_grid(setup: SpatialSetup, state: SpatialCoordState, filename: str,
                       mesh=None) -> Grid:
    """Stitch the global grid from the owned brick rows and write it as one
    Plumed-1 file (the reference's multi_write, grid.h:509-674, as a gather
    and one write): every rank stitches, rank 0 writes.  Returns the grid."""
    from ..utils.gridio import write_grid

    mesh = mesh_of(DATA_AXIS) if mesh is None else mesh
    g = dataclasses.replace(stitch_spatial_grid(setup, state, mesh), interpolate=True)
    if mesh.rank == 0:
        write_grid(g, filename)
    return g


class SpatialCoordStep(CoordStep):
    """This rank's step of the spatial host (``make_spatial_coord_step``):
    ``step(state) -> (new_state, energy)``, with ``collect_records`` ``->
    (new_state, energy, bias.HillRoundLog)`` whose positions are global.
    ``round_shapes(cap)``: (compact exchange?, gathered round size, overlap
    capacity, replayed batch size) at slot capacity ``cap``."""

    def __init__(self, setup: SpatialSetup, lp, hill_stride, mesh: Mesh, external_force,
                 collect_records, hill_capacity, overlap_capacity, do_hills):
        super().__init__(setup.params, lp, hill_stride, external_force, None, hill_capacity,
                         do_hills, collect_records=collect_records)
        self.setup, self.mesh, self.overlap_capacity = setup, mesh, overlap_capacity
        D = self.params.cfg.dim
        parts, widths, lows, nonper = _brick_geometry(setup)
        strides = _dev_strides(parts)
        self.parts, self.widths, self.lows, self.nonper = parts, widths, lows, nonper
        self.brick = tuple((mesh.rank // strides[d]) % parts[d] for d in range(D))
        self.sharded_dims = [d for d in range(D) if parts[d] > 1]

    def round_shapes(self, cap: int):
        """The static batch shapes of a round at slot capacity ``cap``: the
        overlap filter's capacity is ~4x the expected share of the round
        that can reach this rank, rounded to 256, and the automatic mode
        engages only where that at least halves the replayed batch."""
        setup, params = self.setup, self.params
        D = params.cfg.dim
        n_dev = self.mesh.size
        density = float(params.cfg.hill_density)
        Hc = self.hill_capacity
        compact = 0 < Hc < cap * n_dev and density >= 0
        n_round = Hc if compact else cap * n_dev
        if self.overlap_capacity == 0 or not self.sharded_dims:
            return compact, n_round, 0, n_round
        if self.overlap_capacity:
            k2 = min(int(self.overlap_capacity), n_round)
            return compact, n_round, k2, k2
        cov = 1.0
        sk = setup.skins or ((setup.skin,) + (0.0,) * (D - 1))
        for d in self.sharded_dims:
            sup = 4.0 * np.sqrt(2.0) * params.cfg.bias_sigma[d] + params.cfg.bias_dx[d]
            w = self.widths[d]
            cov *= min(1.0, (w + 2 * sk[d] + 2 * sup) / (w * self.parts[d]))
        k2 = max(256, int(-(-4.0 * cov * n_round // 256)) * 256)
        if k2 * 2 > n_round:
            return compact, n_round, 0, n_round
        return compact, n_round, k2, k2

    def _to_local(self, x):
        """Global -> this rank's local coordinates: the sharded columns less
        ``lows[d] + i_d * widths[d]``, formed in x's dtype as the JAX host
        forms it."""
        t = _NP[x.dtype]
        off = [0.0] * x.shape[-1]
        for d in self.sharded_dims:
            off[d] = float(t(self.lows[d]) + t(self.brick[d]) * t(self.widths[d]))
        return x - device_const(tuple(off), x.device, x.dtype)

    def _boundary_off(self, dtype, device):
        """This rank's local -> shifted-global offset (D,) on the
        non-periodic sharded dims (``i_d * widths[d]`` in ``dtype``), or
        None when no sharded dim is non-periodic."""
        if not any(self.nonper):
            return None
        t = _NP[dtype]
        off = tuple(float(t(self.brick[d]) * t(self.widths[d])) if self.nonper[d] else 0.0
                    for d in range(self.params.cfg.dim))
        return device_const(off, device, dtype)

    def __call__(self, state: SpatialCoordState, _=None):
        params, mesh = self.params, self.mesh
        D = params.cfg.dim
        dtype, dev = state.x.dtype, state.x.device
        valid = state.valid
        zero = torch.zeros((), dtype=dtype, device=dev)
        boff = self._boundary_off(dtype, dev)

        def force_fn(x):
            e_b, der = B.update_forces(params, state.bias, self._to_local(x), mask=valid,
                                       boundary_offset=boff)
            f = torch.zeros_like(x)
            f[..., :D] = f[..., :D] + (-der)
            f = torch.where(valid[..., None], f, zero)
            e = psum(e_b, mesh)
            if self.external_force is not None:
                e_ext, f_ext = self.external_force(x)
                f = f + torch.where(valid[..., None], f_ext, zero)
                e = e + psum(torch.sum(torch.where(valid, e_ext, zero)), mesh)
            return e, f

        x, v, f, energy, key = baoab_step(self.lp, state.x, state.v, state.f, state.key,
                                          force_fn)
        x = torch.where(valid[..., None], x, state.x)  # parked slots stay put
        v = torch.where(valid[..., None], v, zero)
        do_hills = self.do_hills
        if do_hills is None:  # the JAX host's lax.cond, decided on the host
            do_hills = int(state.step) % self.hill_stride == 0
            self.host_syncs += 1
        cap = x.shape[0]
        compact, _, K2, n_log = self.round_shapes(cap)
        bias_state = state.bias
        trunc = torch.zeros((), dtype=torch.bool, device=dev)
        log = None
        if do_hills:
            bias_state, log, trunc = self._round(state.bias, x, key, valid, boff, compact, K2)
        elif self.collect_records:
            log = B.round_log_zeros(params, state.bias, n_log)
        new_trunc = None if state.hills_truncated is None else state.hills_truncated | trunc
        out = SpatialCoordState(x=x, v=v, f=f, valid=valid, key=key, bias=bias_state,
                                step=state.step + 1, energy=energy, hills_truncated=new_trunc)
        if self.collect_records:
            return out, energy, log
        return out, energy

    def _round(self, bs, x, key, valid, boff, compact, K2):
        """One hill round: (new bias state, record or None, truncated)."""
        params, mesh = self.params, self.mesh
        D = params.cfg.dim
        dtype, dev = x.dtype, x.device
        cap = x.shape[0]
        Hc = self.hill_capacity
        runif = prng.uniform(prng.fold_in(key, 17), (cap,), dtype, dev)
        pos_loc = self._to_local(x)[:, :D]
        est = torch.clamp(torch.sum(valid.to(dtype)), min=1.0)
        if params.cfg.hill_density < 0:
            accept = valid
        else:
            accept = valid & (runif < B._rdiv(params.cfg.hill_density, est))
        # heights on this rank's round-start grid; the target at global positions
        h = B.hill_heights(params, bs, pos_loc, est, target_positions=x[:, :D],
                           boundary_offset=boff)
        rows = torch.cat([x[:, :D], h[:, None]], 1)  # (position, height), zero-filled
        if compact:
            rows_c, _, cnt = compact_accepted(accept, rows, h, Hc)
            act_c = torch.arange(Hc, device=dev) < cnt
            g = all_gather(torch.cat([rows_c, act_c[:, None].to(dtype)], 1), mesh)
            total, n_over = psum(torch.stack([torch.clamp(cnt, max=Hc), (cnt > Hc).long()]),
                                 mesh)
            rows_g, _, _ = compact_accepted(g[:, D + 1] > 0.5, g[:, :D + 1], g[:, D], Hc)
            act_g = torch.arange(Hc, device=dev) < total
            trunc = (n_over > 0) | (total > Hc)
        else:
            g = all_gather(torch.cat([rows, accept[:, None].to(dtype)], 1), mesh)
            rows_g, act_g = g[:, :D + 1], g[:, D + 1] > 0.5
            trunc = torch.zeros((), dtype=torch.bool, device=dev)
        if K2:
            # the overlap filter (infer_neighbors per hill, edm_bias.cpp:708-789):
            # keep the hills whose nearest local image lies within one support
            # window of this grid along every sharded dim
            gs = bs.bias.spec
            rmapped = bs.bias.remap(self._to_local(rows_g[:, :D]))
            keep = act_g
            for d in self.sharded_dims:
                hw = (gs.minisize[d] + 1) * gs.grid.dx[d]
                keep = keep & ((rmapped[..., d] >= gs.grid.min[d] - hw)
                               & (rmapped[..., d] <= gs.grid.max[d] + hw))
            rows_g, _, kcnt = compact_accepted(keep, rows_g, rows_g[:, D], K2)
            act_g = torch.arange(K2, device=dev) < kcnt
            trunc = trunc | (kcnt > K2)
        pos_g, h_g = rows_g[:, :D], rows_g[:, D]
        new_bs, rec, reads = B.add_hills_round(
            params, bs, self._to_local(pos_g), torch.zeros(pos_g.shape[:1], dtype=dtype,
                                                           device=dev),
            est, active=act_g, axis_name=mesh, override_heights=h_g, boundary_offset=boff)
        self.host_syncs += reads
        log = None
        if self.collect_records:
            log = B.HillRoundLog(torch.ones((), dtype=torch.bool, device=dev), pos_g, rec)
        return new_bs, log, trunc


def make_spatial_coord_step(setup: SpatialSetup, lp: LangevinParams, hill_stride: int,
                            mesh: Mesh, external_force: Optional[Callable] = None,
                            collect_records: bool = False, hill_capacity: Optional[int] = None,
                            overlap_capacity: Optional[int] = None,
                            static_do_hills: Optional[bool] = None) -> SpatialCoordStep:
    """This rank's step of the spatial host, with the JAX signature.
    ``external_force(x_global) -> (per-atom energies, forces)``.

    ``hill_capacity``: the accepted hills each rank compacts into, and the
    round's size after the gather (the reference's bounded exchange buffer,
    edm_bias.h:151-154); default ~8x the expected global acceptances,
    rounded to 512 and at least 512; 0 gathers every candidate; an overflow
    sets ``hills_truncated``.  ``overlap_capacity``: the replayed batch
    after the overlap filter (None: automatic, on when it at least halves
    the batch; 0: off).  ``static_do_hills``: True or False builds one
    static stride phase, None a step that reads ``state.step`` to decide
    (one host sync a step, counted in ``host_syncs``).  ``collect_records``:
    each step also returns a ``bias.HillRoundLog`` for
    ``log_spatial_round``."""
    if hill_stride < 1:
        raise ValueError("hill_stride must be >= 1")
    density = float(setup.params.cfg.hill_density)
    if hill_capacity is None:
        hill_capacity = 0 if density < 0 else max(
            512, int(-(-8.0 * max(mesh.size * density, 64.0) // 512)) * 512)
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return SpatialCoordStep(setup, lp, hill_stride, mesh, external_force, collect_records,
                            hill_capacity, overlap_capacity, do_hills)


def log_spatial_round(hills_logs, logs, round_counter: int, cum_before: float, mesh=None) -> float:
    """Append one step's records of every rank to the per-replica HILLS
    files (reference '<hills_filename>_<rank>', edm_bias.cpp:1075-1084).
    Every rank calls it with its own ``logs``; they are gathered in rank
    order, and a rank that passes ``hills_logs`` (one ``HillsLog`` per rank,
    usually rank 0's list; the others pass None) writes them.  Returns the
    global bias added this round, the same on every rank."""
    mesh = mesh_of(DATA_AXIS) if mesh is None else mesh
    happened = all_gather(logs.happened[None], mesh)
    rec = type(logs.rec)(*[all_gather(t[None], mesh) for t in logs.rec])
    positions = all_gather(logs.positions[None], mesh)
    if not bool(happened.any()):
        return 0.0
    if hills_logs is not None:
        for d, hl in enumerate(hills_logs):
            hl.log_round(round_counter, cum_before, type(rec)(*[t[d] for t in rec]),
                         positions[d])
    return float(sum(float(t) for t in rec.round_bias.cpu().double()))


__all__ = [
    "SpatialCoordState",
    "SpatialSetup",
    "SpatialCoordStep",
    "spatial_subdivide",
    "init_spatial_state",
    "rebin_spatial_atoms",
    "stitch_spatial_grid",
    "gather_spatial_grid",
    "write_spatial_grid",
    "make_spatial_coord_step",
    "log_spatial_round",
]
