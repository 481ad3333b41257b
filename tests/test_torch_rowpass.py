"""PyTorch port: what the CUDA row pass of K1, K6 and K7 rests on, on the CPU.

The CUDA kernel (``csrc/cellforce.cu`` ``k1_rows`` / ``k1_credits``) runs
only on a card; here what its design rests on is held to the plain
versions:

  - K7's identity: ``cell_force_full_ref`` (every ordered pair of the
    27-stencil, self pair masked by slot id) equals the half-stencil pass at
    full cap whose credits carry the pair's value beside its force, the
    force credits subtracted and the value credits added in HALF_OFFSETS
    order, the self block's value taken whole (float64, to 1e-12 of max|.|);
  - the reach test: a pair beyond the larger of the LJ cutoff and the
    table's upper edge contributes exact zeros, so the row pass may skip it;
  - the pieces form's cull (``k1_rows_pieces``, stated plainly by
    ``cull_bins``, ``bin_keys``, ``piece_chunks``, ``chunk_box`` and
    ``box_reaches``): the bins a cell from k and the cell edge over the
    reach, and, on random positions at in.lj's geometry (cells of 4.097,
    reach 4.0, k = 96) and on a 3^3 lattice of large cells (k = 256), each
    drifted by up to two strides' travel, some past their cell's faces and
    some moved by a box length across the periodic boundary, no pair within
    r2_far has its candidate in a chunk whose box the row fails.

The kernel itself is held to the plain versions on the card
(``test_torch_gpu.py``), on the slot states made here.

Inputs, from numpy seeds: a jittered lattice sampled in clusters, so that
some cells stay empty and slots have holes, on 3x4x5 cells; the same with
one cell filled to cap; and 3x3x3 cells, the smallest lattice both
packages take.  The lookup tables are random: a two-panel Chebyshev table
and a 40-row Hermite table.
"""

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from edm_tpu_torch.models.cells import CellSpec, build_table
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops.chebyshev import ChebTable

LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
TYPE_PAIR = (1, 2)
CASES = {
    # name: (box, cap, atoms, one cell filled to cap)
    "clustered 3x4x5": ((6.0, 8.0, 10.0), 12, 150, False),
    "full cell 3x4x5": ((6.0, 8.0, 10.0), 8, 120, True),
    "lattice 3x3x3": ((6.0, 6.0, 6.0), 16, 160, False),
}


def slot_state(case, seed=7, cap=None, n=None, dtype=torch.float64):
    """(spec, xs (Cg, cap, 3), mc, sid, ts (Cg, cap)) on the CPU: atoms on a
    jittered 0.4 lattice, drawn in clusters; a fifth of the placed slots
    are then emptied, which leaves holes below occupied slots.  ``cap`` and
    ``n`` replace the case's cap and atom count."""
    box, cap0, n0, fill = CASES[case]
    cap, n = cap or cap0, n or n0
    rng = np.random.default_rng(seed)
    axes = [np.arange(0.2, b, 0.4) for b in box]
    pts = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    centres = pts[rng.choice(len(pts), 4, replace=False)]
    d = pts[:, None] - centres[None]
    d -= np.round(d / np.asarray(box)) * np.asarray(box)
    w = np.exp(-(d * d).sum(-1).min(1) / 2.0) + 1e-4
    spec = CellSpec.create(box, cutoff=2.0, n_atoms=n, cap=cap)
    sel = []
    if fill:  # cap atoms of one cell first
        inside = np.nonzero((pts < np.asarray(spec.edge)).all(1))[0]
        sel = list(rng.choice(inside, cap, replace=False))
        w[inside] = 0.0
    # no cell may take more than cap: draw, then drop the surplus per cell
    free = np.nonzero(w)[0]
    order = rng.choice(free, len(free), replace=False, p=w[free] / w.sum())
    cell = (np.floor(pts / np.asarray(spec.edge)).astype(int)
            * np.array([spec.ncells[1] * spec.ncells[2], spec.ncells[2], 1])).sum(1)
    count = np.bincount(cell[sel], minlength=spec.n_cells) if sel else np.zeros(spec.n_cells, int)
    for i in order:
        if len(sel) == n:
            break
        if count[cell[i]] < cap and i not in sel:
            sel.append(i)
            count[cell[i]] += 1
    x = torch.tensor(pts[sel] + rng.uniform(-0.03, 0.03, (n, 3)), dtype=torch.float64)
    table = build_table(spec, x)
    assert not bool(table.overflow)
    C = spec.n_cells
    Cg = -(-C // CF.CELLS_PER_GROUP) * CF.CELLS_PER_GROUP
    aid = torch.full((Cg * cap,), n, dtype=torch.int64)
    aid[:C * cap] = table.aid
    occ = aid < n
    holes = torch.tensor(rng.uniform(size=Cg * cap) < 0.2)
    if fill:
        holes[:cap] = False  # cell 0 stays full
    occ = occ & ~holes
    safe = torch.where(occ, aid, torch.zeros_like(aid))
    xs = torch.where(occ[:, None], x[safe], torch.zeros(1, dtype=torch.float64))
    types = torch.tensor(rng.integers(1, 3, n), dtype=torch.float64)
    shape = (Cg, cap)
    return (spec, xs.reshape(Cg, cap, 3).to(dtype), occ.to(dtype).reshape(shape),
            torch.where(occ, aid, n).to(dtype).reshape(shape),
            torch.where(occ, types[safe], 0.0).to(dtype).reshape(shape))


def tables(seed=11):
    rng = np.random.default_rng(seed)
    scale = 0.5 ** np.arange(7)
    cheb = ChebTable(cval=torch.tensor(rng.normal(size=(2, 7)) * scale),
                     cder=torch.tensor(rng.normal(size=(2, 7)) * scale), lo=0.3, hi=1.9)
    G, glo, gdx = 40, 0.1, 0.05
    herm = CF.HermiteTable(tab=torch.tensor(rng.normal(size=(G, 4))),
                           geom=(G, glo, gdx, glo + (G - 1) * gdx, 0.25, 1.8))
    return {"cheb": cheb, "hermite": herm}


def close(a, b, what):
    scale = max(1.0, float(b.abs().max()))
    err = float((a - b).abs().max())
    assert err <= 1e-12 * scale, f"{what}: {err} of {scale}"


def half_pass_with_values(xs, mc, table, *, ncells, box, lj):
    """The half-stencil pass at full cap, every unordered pair once: row
    sums f (C, cap, 3) and eb (C, cap) with the self block's value whole,
    and credits (C, 13, cap, 4): per offset the column sums of the force
    and of the value."""
    C = int(np.prod(ncells))
    cap = xs.shape[1]
    nbr = CF.half_neighbors(tuple(ncells), xs.device)
    xl, ml = xs[:C], mc[:C] > 0.5
    xw = torch.cat([xl, xs[nbr].reshape(C, 13 * cap, 3)], 1)
    mw = torch.cat([ml, (mc[nbr] > 0.5).reshape(C, 13 * cap)], 1)
    d = [CF._mimage(xl[:, :, None, c] - xw[:, None, :, c], box[c]) for c in range(3)]
    ok = ml[:, :, None] & mw[:, None, :]
    ok = ok & ~torch.eye(cap, 14 * cap, dtype=torch.bool)[None]
    f_over_r, val = CF._pair_terms(*d, ok, table, lj, True)
    g = torch.stack([f_over_r * dc for dc in d] + [val], dim=-1)  # (C, cap, 14cap, 4)
    cred = g[:, :, cap:].sum(1).reshape(C, 13, cap, 4)
    rows = g.sum(2)
    return rows[..., :3], rows[..., 3], cred


@pytest.mark.parametrize("case", list(CASES))
def test_full_stencil_is_the_half_stencil_with_value_credits(case):
    spec, xs, mc, sid, _ = slot_state(case)
    C = spec.n_cells
    assert min(spec.ncells) >= 3
    if case.startswith("clustered"):
        assert bool((mc[:C].sum(1) == 0).any())  # an empty cell
    if case.startswith("full"):
        assert float(mc[0].sum()) == xs.shape[1]
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ)
    tab = tables()["cheb"]
    f_ref, eb_ref = CF.cell_force_full_ref(xs, mc, sid, tab, **kw)
    assert float(eb_ref.abs().max()) > 0
    f_own, eb_own, cred = half_pass_with_values(xs, mc, tab, **kw)
    src = CF.credit_sources(tuple(spec.ncells), xs.device)
    inc = cred[src, torch.arange(13)]  # (C, 13, cap, 4): what each cell is credited
    f, eb = f_own, eb_own
    for o in range(13):
        f = f - inc[:, o, :, :3]
        eb = eb + inc[:, o, :, 3]
    close(f, f_ref[:C], "forces")
    close(eb, eb_ref[:C], "eb")


def reach2(table, lj):
    """The row pass's r^2 bound of a pair that can contribute (``r2_far`` of
    ``csrc/cellforce.cu:make_params``): the larger of rcut and the table's
    upper edge (Chebyshev hi; Hermite the lower of the grid's and the
    boundary's), squared, with a 1e-5 margin."""
    hi = table.hi if isinstance(table, ChebTable) else min(table.geom[3], table.geom[5])
    far = max(lj.rcut, hi)
    return far * far * (1.0 + 1e-5)


@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("rcut", [0.75, 2.2])
def test_pairs_beyond_reach_are_exact_zeros(kind, dtype, rcut):
    """The row pass evaluates only the pairs with r^2 <= r2_far.  That is
    exact because the plain pair terms of every pair beyond it are zeros,
    not small numbers: from the first float above r2_far outwards, with the
    LJ cutoff below the table's edge and above it."""
    lj = LJParams(epsilon=1.0, sigma=0.3, rcut=rcut)
    tab = tables()[kind]
    if dtype == torch.float32 and kind == "cheb":
        tab = ChebTable(cval=tab.cval.float(), cder=tab.cder.float(), lo=tab.lo, hi=tab.hi)
    elif dtype == torch.float32:
        tab = CF.HermiteTable(tab=tab.tab.float(), geom=tab.geom)
    r2_far = torch.tensor(reach2(tab, lj), dtype=dtype)
    first = torch.nextafter(r2_far, torch.tensor(float("inf"), dtype=dtype))
    rng = np.random.default_rng(5)
    r2 = torch.cat([first[None], r2_far * torch.tensor(1.0 + rng.uniform(0, 3, 4000) ** 4,
                                                       dtype=dtype)])
    r2 = r2[r2 > r2_far]
    # directions on the sphere: dx, dy, dz with dx^2 + dy^2 + dz^2 = r2 up to rounding
    u = torch.tensor(rng.normal(size=(len(r2), 3)), dtype=dtype)
    d = u / u.norm(dim=1, keepdim=True) * torch.sqrt(r2)[:, None]
    d = d[(d * d).sum(1) > r2_far]
    ok = torch.ones(len(d), dtype=torch.bool)
    f_over_r, val = CF._pair_terms(d[:, 0], d[:, 1], d[:, 2], ok, tab, lj, True)
    assert len(d) > 3000
    assert not bool(f_over_r.any()) and not bool(val.any())
    # and the bound is not vacuous: just inside it some pair term is non-zero
    inside = d * (0.97 * torch.sqrt(r2_far) / d.norm(dim=1, keepdim=True))
    f_in, v_in = CF._pair_terms(inside[:, 0], inside[:, 1], inside[:, 2], ok, tab, lj, True)
    assert bool(f_in.any()) or bool(v_in.any())


def drift(xs, mc, box, seed, step=0.05, wrap_share=0.1):
    """``xs`` with each occupied slot moved by up to ``step`` per axis (0.05:
    a 10-step stride's travel at dt 0.002 and 2.5 per axis, about 2.8
    sigma of the thermal speed at kT 0.8) and a ``wrap_share`` of them moved
    by a box length along one axis (unwrapped coordinates across the
    periodic boundary); the slots stay where the rebin put them, so atoms
    leave their cells."""
    rng = np.random.default_rng(seed)
    pick = rng.random(xs.shape[:2]) < wrap_share
    axis = rng.integers(0, 3, xs.shape[:2])
    sign = rng.choice([-1.0, 1.0], xs.shape[:2])
    move = rng.uniform(-step, step, xs.shape)
    for d in range(3):
        move[..., d] += np.where(pick & (axis == d), sign * box[d], 0.0)
    move = torch.tensor(move, dtype=xs.dtype, device=xs.device)
    return torch.where((mc > 0.5)[..., None], xs + move, xs)


def pair_r2_f32(a, b, box):
    """``pair_r2`` of csrc/cellforce.cu in float32, op for op: rows ``a``
    (m, 3) against ``b`` (n, 3), the box's reciprocal rounded once as the
    launch rounds it.  (m, n)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    r2 = None
    for d in range(3):
        x = CF._mimage32(a[:, None, d] - b[None, :, d], box[d])
        r2 = x * x if r2 is None else r2 + x * x
    return r2


def stencil_pair_counts(xs, mc, k, ncells, box, r2_far):
    """What the pieces form's counters must read for one launch over the
    whole lattice: (rows x occupied candidates of the 14 cells, summed over
    the cells; the unordered pairs of the half stencil within r2_far, a
    self-block pair once), in ``pair_r2``'s float32 arithmetic."""
    nbr = CF.half_neighbors(tuple(ncells), torch.device("cpu")).numpy()
    x, m = xs.double().numpy(), (mc > 0.5).numpy()
    unculled = in_reach = 0
    for c in range(int(np.prod(ncells))):
        rows = x[c, :k][m[c, :k]]
        cands = np.concatenate([x[o, :k][m[o, :k]] for o in [c] + list(nbr[c])])
        unculled += len(rows) * len(cands)
        inside = pair_r2_f32(rows, cands, box) <= np.float32(r2_far)
        in_reach += int(np.triu(inside[:, :len(rows)], 1).sum() + inside[:, len(rows):].sum())
    return unculled, in_reach


def cull_geometry(name, seed=3):
    """(xs (C, k, 3) float32 slot positions, mc, k, ncells, box, r2_far):
    ``in.lj`` - the in.lj liquid's density 0.8442 on 4^3 cells of its edge
    4.097 with the reach of its bias (4.0), k = 96; ``lattice 3x3x3`` - 3^3
    cells of edge 3.1 holding 128 to 255 atoms each, cell 0 full, reach
    3.0, k = 256.  Positions uniform, slotted by cell, then ``drift``-ed by
    up to two strides' travel."""
    rng = np.random.default_rng(seed)
    if name == "in.lj":
        n_side, edge, k, reach = 4, 4.097, 96, 4.0
        L = n_side * edge
        counts = rng.poisson(0.8442 * edge ** 3, n_side ** 3).clip(0, k)
    else:
        n_side, edge, k, reach = 3, 3.1, 256, 3.0
        L = n_side * edge
        counts = rng.integers(k // 2, k, n_side ** 3)
        counts[0] = k
    ncells, box = (n_side,) * 3, (L, L, L)
    C = n_side ** 3
    lo = np.stack(np.meshgrid(*[np.arange(n_side)] * 3, indexing="ij"), -1).reshape(-1, 3) * edge
    xs = np.zeros((C, k, 3))
    mc = np.zeros((C, k))
    for c in range(C):
        slots = np.sort(rng.choice(k, counts[c], replace=False))  # holes between the atoms
        xs[c, slots] = lo[c] + rng.uniform(0, edge, (counts[c], 3))
        mc[c, slots] = 1.0
    xs, mc = torch.tensor(xs, dtype=torch.float32), torch.tensor(mc, dtype=torch.float32)
    xs = drift(xs, mc, box, seed + 1, step=0.1)  # two strides' travel
    return xs, mc, k, ncells, box, float(np.float32(reach * reach * (1.0 + 1e-5)))


def test_cull_bins_from_k_and_the_edge_over_the_reach():
    """Two bins along an axis where a cell fills more than one chunk and
    its edge is at least half the reach; one elsewhere; the keys take the
    side of the cell's centre on each split axis, x the high bit, by the
    minimum image (an atom out of its cell, or a box length away, keeps its
    side)."""
    assert CF.cull_bins(96, (4.097,) * 3, 4.0) == (2, 2, 2)
    assert CF.cull_bins(CF.CHUNK, (4.097,) * 3, 4.0) == (1, 1, 1)
    assert CF.cull_bins(CF.CHUNK + 1, (1.9, 2.0, 2.1), 4.0) == (1, 2, 2)
    edge, r2 = 4.0, 16.0 * (1 + 1e-5)
    xs = np.zeros((27, 6, 3), np.float32)
    # cell 0 at (0, 0, 0) and cell 26 at (2, 2, 2) (upper corner (12, 12, 12))
    xs[0] = [[0.5, 0.5, 0.5], [2.5, 0.5, 0.5], [0.5, 2.5, 3.9], [-0.3, 4.2, 0.5],
             [12.5, 0.5, 2.1], [0.5, -11.9, 0.5]]
    xs[26] = [[8.5, 11.5, 8.5], [12.2, 8.1, 7.9], [-3.5, 8.5, 8.5], [0, 0, 0], [0, 0, 0],
              [0, 0, 0]]
    keys = CF.bin_keys(xs, 96, (3 * edge,) * 3, (3, 3, 3), r2)
    assert keys[0].tolist() == [0, 4, 3, 2, 1, 0]
    assert keys[26, :3].tolist() == [2, 4, 0]
    assert not CF.bin_keys(xs, CF.CHUNK, (3 * edge,) * 3, (3, 3, 3), r2).any()


@pytest.mark.parametrize("name", ["in.lj", "lattice 3x3x3"])
def test_cull_keeps_every_pair_in_reach(name):
    """For every row cell: the piece plan at k (K1, Hermite table), each
    piece's candidates sorted and cut into chunks as the kernel does, each
    chunk's box from its members; every candidate within r2_far of a row
    (``pair_r2``'s float32 arithmetic) lies in a chunk whose box the row
    reaches; and the cull drops a fair share of the other tests (at in.lj's
    geometry about the share the sub-cell boxes were sized for)."""
    xs, mc, k, ncells, box, r2_far = cull_geometry(name)
    plan = CF.row_plan(k, 3, False, CF.HERMITE, 201, 0)
    assert not plan.small
    nbr = CF.half_neighbors(tuple(ncells), torch.device("cpu")).numpy()
    x, m = xs.numpy(), (mc > 0.5).numpy()
    keys = CF.bin_keys(x, k, box, ncells, r2_far)
    tests = kept = in_reach = 0
    for c in range(int(np.prod(ncells))):
        cells = [c] + list(nbr[c])
        occ, key, pos = m[cells, :k], keys[cells, :k], x[cells, :k]
        rows = pos[0][occ[0]]
        for piece, (order, chunks) in zip(CF.piece_candidates(k, plan),
                                          CF.piece_chunks(k, plan, occ, key)):
            cpos = pos[piece[order, 0], piece[order, 1]]
            inside = pair_r2_f32(rows, cpos, box) <= np.float32(r2_far)
            passes = np.zeros_like(inside)
            for a, b in chunks:
                centre, half = CF.chunk_box(cpos[a:b], box)
                passes[:, a:b] = CF.box_reaches(rows, centre, half, box, r2_far)[:, None]
            assert not (inside & ~passes).any(), (name, c)
            tests += inside.size
            kept += int(passes.sum())
            in_reach += int(inside.sum())
    assert in_reach > 0
    cull = 1 - kept / tests
    assert cull > (0.5 if name == "in.lj" else 0.3), cull
