"""PyTorch port: what the CUDA kernels K2 (``overflow_force``) and K4
(``deposit_windowed_1d``) rest on, on the CPU.

The kernels (``csrc/cellforce.cu`` ``k2_partners`` / ``k2_finish``,
``csrc/deposit.cu`` ``dep_tiles`` / ``dep_bias_added``) run only on a card;
here the arithmetic their designs rest on is held to the plain versions:

  - K4 writes a hill's partial integrals into a compact scratch (H, T), at
    column (tile - the hill's first tile) mod blocks, and its second pass
    sums the hill's ``count`` columns.  ``deposit_kernels.hill_tiles`` and
    ``tiles_per_hill`` state that arithmetic; a brute-force count over the
    plain version's pair terms shows that every (hill, tile) pair with a
    support point lies inside the hill's range, and that no range exceeds T:
    on the bench's 1e6-point grid, a grid whose size is a multiple of the
    tile, the widest window the route admits, and with hills on the wrap
    seam and outside the grid; and, where a hill's reach and a tile span
    the grid (``wide_reach``), that the range is every tile;
  - K2 evaluates only the (tail row, partner) pairs with r^2 <= r2_far.
    ``overflow_force_ref`` with every other pair masked out equals
    ``overflow_force_ref`` bitwise: both lookups, energy on and off, the LJ
    cutoff below and above the table's end.

``overflow_case`` also makes the inputs of K2's tests on the card
(``test_torch_gpu.py``).  This file imports neither jax nor the JAX package.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from edm_tpu_torch import gauss as tg
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops import deposit_kernels as DK
from edm_tpu_torch.ops.chebyshev import ChebTable
from test_torch_rowpass import reach2, tables

BOX = (6.0, 6.0, 6.0)


# ------------------------------------------------------------------ K4 tiles

TILE_CASES = {
    # name: (G, sigma, tile)
    "bench 1e6, ragged last tile": (1_000_000, 0.01, 1024),
    "G a multiple of the tile": (65536, 0.0293170, 1024),
    "small tile": (65538, 0.0293170, 256),
    "widest window of the route": (65536, 0.43847, 1024),
}


def _hills(G, n=40, seed=3):
    """Raw centres: uniform over three periods around the grid, and on and
    next to the wrap seam."""
    rng = np.random.default_rng(seed)
    dx = 10.0 / G
    seam = [0.0, 10.0, 0.4 * dx, 10.0 - 0.4 * dx, 1023.6 * dx, 1024.0 * dx, -0.3 * dx,
            10.0 + 0.3 * dx]
    return torch.tensor(np.concatenate([rng.uniform(-10, 20, n), seam]), dtype=torch.float32)


@pytest.mark.parametrize("case", list(TILE_CASES))
def test_hill_tiles_cover_the_support(case):
    G, sigma, tile = TILE_CASES[case]
    gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device="cpu")
    W = gg.spec.window_shape[0]
    assert W + 256 < G // 2  # the K4 route
    if case.startswith("widest"):
        assert W + 258 >= G // 2
    n_blocks = -(-G // tile)
    reach, T = DK.hill_reach(gg), DK.tiles_per_hill(gg, tile)
    assert not DK.wide_reach(gg, tile)  # the route's reaches never meet themselves
    x = DK.remap_periodic_1d(gg, _hills(G))
    first, count = DK.hill_tiles(gg, x, tile)
    assert int(count.max()) <= T < n_blocks and int(count.min()) >= 1
    if case.startswith("bench"):
        assert T == 10 and set(count.tolist()) <= {8, 9, 10}
    # brute force: the points where the plain version's unit term is not 0
    half = gg.spec.minisize[0] + 2
    ic = torch.floor(x / DK._scalar(10.0 / G, x)).to(torch.int64)
    idx = torch.remainder(ic[:, None] + torch.arange(-half, half + 1)[None, :], G)
    e, _ = DK._terms(gg, 10.0 / G * idx.to(torch.float32), x[:, None])
    assert bool((e[:, 0] == 0).all() and (e[:, -1] == 0).all())  # the window holds the support
    seen = 0
    for j in range(len(x)):
        tiles = np.unique((idx[j][e[j] > 0] // tile).numpy())
        col = (tiles - int(first[j])) % n_blocks
        assert (col < int(count[j])).all(), (case, j, tiles, int(first[j]), int(count[j]))
        # and the range is tight: at most 2 tiles more than the support meets
        assert int(count[j]) <= len(tiles) + 2
        seen += len(tiles)
    assert seen > len(x)


WIDE_CASES = {
    # name: (G, sigma, tile): the reach and a tile just past the grid, the
    # support radius past half the period, and past the whole period
    "reach and a tile just span the grid": (16384, 1.8, 512),
    "support past half the period": (16384, 2.5, 1024),
    "support past the period": (4096, 4.0, 1024),
    "ragged last tile": (17000, 1.7, 1024),
}


@pytest.mark.parametrize("case", list(WIDE_CASES))
def test_hill_tiles_wide_reach(case):
    """Where a hill's reach and one tile span the grid (``wide_reach``: the
    range of 2 reach + 2 points would meet itself around the period), every
    hill is listed on every tile from tile 0 and T is the grid's tiles; a
    brute force over the plain version's terms finds support points on
    tiles only inside that range; K4's plain version there equals K5's (each
    point takes each hill once, at its minimum image), whose windows would
    otherwise repeat points."""
    G, sigma, tile = WIDE_CASES[case]
    gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device="cpu")
    n_blocks = -(-G // tile)
    reach = DK.hill_reach(gg)
    assert DK.wide_reach(gg, tile) and 2 * reach + 2 + tile > G
    assert not DK.wide_reach(tg.GaussGrid.create([0], [10], [10.0 / G], [True], [0.05],
                                                 device="cpu"), tile)
    x = DK.remap_periodic_1d(gg, _hills(G, n=10))
    first, count = DK.hill_tiles(gg, x, tile)
    assert DK.tiles_per_hill(gg, tile) == n_blocks
    assert bool((first == 0).all() and (count == n_blocks).all())
    xx = 10.0 / G * torch.arange(G, dtype=torch.float32)
    e, _ = DK._terms(gg, xx[None, :], x[:, None])
    for j in range(len(x)):
        tiles = np.unique((torch.nonzero(e[j] > 0)[:, 0] // tile).numpy())
        assert len(tiles) and ((tiles - int(first[j])) % n_blocks < int(count[j])).all()
    h = torch.linspace(0.05, 0.2, len(x))
    out_w, ba_w = DK.deposit_windowed_1d_ref(gg, x, h)
    out_d, ba_d = DK.deposit_dense_1d_kernel_ref(gg, x, h)
    if 2 * (gg.spec.minisize[0] + 2) + 1 > G:  # the windows would repeat points
        assert torch.equal(out_w.grid.values, out_d.grid.values) and torch.equal(ba_w, ba_d)
    else:
        assert float((out_w.grid.values - out_d.grid.values).abs().max()) <= 1e-5 * float(
            out_d.grid.values.abs().max())


# ------------------------------------------------------------------ K2 reach


def overflow_case(O, n_live, N, seed=0, own_every=3):
    """K2's inputs from a numpy seed, float32: xo (5, O) with ``n_live``
    live tail rows scattered over the O rows, ``own`` cleared on every
    ``own_every``-th live row; xp (4, N) with one partner in eight masked.
    The atoms sit on a jittered 0.4 lattice in the 6^3 box, so no two are
    closer than 0.34."""
    rng = np.random.default_rng(seed)
    axes = [np.arange(0.2, b, 0.4) for b in BOX]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    sel = rng.choice(len(pts), O + N, replace=False)
    x = (pts[sel] + rng.uniform(-0.03, 0.03, (O + N, 3))).astype(np.float32)
    live = np.zeros(O, np.float32)
    live[rng.choice(O, n_live, replace=False)] = 1.0
    own = live.copy()
    own[np.nonzero(live)[0][::own_every]] = 0.0
    xo = np.concatenate([x[:O].T, live[None], own[None]])
    xp = np.concatenate([x[O:].T, (rng.uniform(size=N) > 0.125)[None]])
    return tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32)) for a in (xo, xp))


def f32_table(kind):
    tab = tables()[kind]
    if kind == "cheb":
        return ChebTable(cval=tab.cval.float(), cder=tab.cder.float(), lo=tab.lo, hi=tab.hi)
    return CF.HermiteTable(tab=tab.tab.float(), geom=tab.geom)


@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("rcut", [0.75, 2.2])
def test_overflow_ref_ignores_pairs_beyond_reach(monkeypatch, kind, energy, rcut):
    lj = LJParams(epsilon=1.0, sigma=0.3, rcut=rcut)
    tab = f32_table(kind)
    xo, xp = overflow_case(32, 8, 700)
    kw = dict(box=BOX, lj=lj, energy=energy)
    fo, fp = CF.overflow_force_ref(xo, xp, tab, **kw)
    assert float(fo[:3].abs().max()) > 0 and float(fp.abs().max()) > 0
    assert energy == bool(fo[3].abs().max() > 0)

    r2_far = torch.tensor(np.float32(reach2(tab, lj)))  # make_params rounds it to float32
    real, masked = CF._pair_terms, []

    def within_reach(dx, dy, dz, ok, *args):
        near = dx * dx + dy * dy + dz * dz <= r2_far  # pair_r2's order of operations
        masked.append(int((ok & ~near).sum()))
        return real(dx, dy, dz, ok & near, *args)

    monkeypatch.setattr(CF, "_pair_terms", within_reach)
    fo_near, fp_near = CF.overflow_force_ref(xo, xp, tab, **kw)
    assert sum(masked) > 1000  # most pairs are skipped
    assert torch.equal(fo, fo_near) and torch.equal(fp, fp_near)
