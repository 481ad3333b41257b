"""PyTorch port: the cell-force kernels' plain versions past the shapes the
CUDA kernels once refused, against the Pallas kernels (interpret mode on
the CPU), and the launch plans that let the CUDA kernels take any shape.

Inputs: 1,700 atoms on a jittered 14^3 lattice in a 6^3 box with a denser
octant, 3^3 cells at cap 96 (occupancies up to 93, 47 atoms past slot 72),
and a bias grid carrying 80 hills.

  - the port's ``make_cell_step`` against JAX's at cap 96 with
    ``kernel_cap`` 72 and ``overflow_cap`` 136: 5 kT = 0 steps with the
    energy on each, every one through K1 (``cell_force_newton``) at k = 72
    and K2 (``overflow_force``) on the 47-row tail; integer leaves exactly;
  - K1 at k = 96 with a 16-panel Chebyshev table of degree 16 (past the old
    limit of 8 panels), energy on; typed K1 and typed K6
    (``cell_force_newton_planar``) at 96 with the binary types; K7
    (``cell_force_full``) at 96 with the bench's table (4 panels of degree
    16); K2 with ``overflow_cap`` 256 (two of the kernel's row tiles) and
    the 16-panel table;
  - ``ops.cellforce.row_plan`` and ``k2_plan`` at every cap 8 ... 1,024 in
    steps of 8 and every tail 8 ... 2,048: each fits a block's 227 KB, and
    the pieces and tiles the kernels map from them (``piece_candidates``,
    ``k2_blocks``) take every candidate, tail row and partner once; the
    pieces form's sort and chunks (``piece_chunks``, on a random occupancy
    and random sub-cell bins) take each occupied candidate slot once, in
    chunks of at most ``CHUNK`` inside one cell, no more than
    ``max_chunks`` a piece.

Each interpret-mode kernel is an XLA compile of ~9 s here, so the cases
share them: K1 at k = 72 is checked inside the step, the 16-panel table
with K1 at k = 96 and with K2 at 256 rows.  Tolerances as in
``_torch_parity``: forces 2e-5 * max(1, max|f|), energies 1e-5 relative,
the Chebyshev forces within ``near_jax`` of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (
    ENERGY_RTOL,
    FORCE_REL,
    assert_energy,
    assert_exact,
    assert_forces,
    near_jax,
    to_port,
)
from edm_tpu import bias as JB
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import (
    _half_concat,
    _planar_coord_views,
    init_cell_state,
    make_cell_step,
)
from edm_tpu.ops import cellforce_pallas as CP
from edm_tpu.ops import chebyshev as jcheb
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import cells as tcells
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops import chebyshev as tcheb

N, CAP, KCAP = 1700, 96, 72
TYPES = np.where(np.arange(N) % 2 == 0, 2, 1).astype(np.int32)
PAIR = (1, 2)
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)
TLJ_ = TLJ(epsilon=1.0, sigma=0.3, rcut=0.75)
CFG = ("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
       "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
       "bias_sigma 0.1\n")
_CTX = {}


def _points():
    rng = np.random.default_rng(5)
    g = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1).reshape(-1, 3)
         * (6.0 / 14) + 0.2)
    w = np.where((g < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(g), size=N, replace=False, p=w / w.sum())
    return (g[sel] + rng.uniform(-0.04, 0.04, (N, 3))).astype(np.float32)


def _ctx():
    """The cap-96 slot state (with ids and types) and the bias carrying
    hills, in both packages."""
    if _CTX:
        return _CTX
    params, bs = JB.subdivide(parse_edm_text(CFG), 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                              [0], dtype=jnp.float32)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(jnp.asarray(rng.uniform(0.2, 3.0, (80, 1)), jnp.float32),
                              jnp.asarray(rng.uniform(0.01, 0.2, 80), jnp.float32))
    bs = dataclasses.replace(bs, bias=gg)
    core = jpe.init_state(bs, jnp.asarray(_points()), jax.random.PRNGKey(0), n_est=N * 300)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=CAP)
    st = init_cell_state(spec, core, with_ids=True, types=TYPES)
    occ = np.asarray(st.mc).sum(1)
    assert occ.max() <= CAP and 20 < np.maximum(occ - KCAP, 0).sum() <= 136
    _CTX.update(params=params, spec=spec, core=core, st=st, tst=to_port(st), gg=gg,
                tgg=to_port(bs).bias)
    return _CTX


def _tables(kind):
    """The same table for both packages: "hermite", or a Chebyshev fit
    "cheb P deg" of the grid carrying hills."""
    c = _ctx()
    if kind == "hermite":
        return CP.hermite_pair_table(c["gg"]), CF.hermite_pair_table(c["tgg"])
    _, panels, deg = kind.split()
    ref = jcheb.fit_gauss_grid(c["gg"], int(deg), int(panels))
    return ref, tcheb.ChebTable(cval=torch.as_tensor(np.array(ref.cval)),
                                cder=torch.as_tensor(np.array(ref.cder)), lo=ref.lo, hi=ref.hi)


def _f64(tab):
    return dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())


def _check_forces(kind, f, ref, f64, what):
    """Hermite: ``assert_forces``; Chebyshev: within ``near_jax``."""
    if kind == "hermite":
        assert_forces(f, ref, what)
    else:
        err, tol = near_jax(f, ref, f64, FORCE_REL)
        assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("k, kind", [(96, "cheb 16 16")])
def test_cell_force_newton_large_cap(k, kind):
    """K1 at full cap 96 with the 16-panel table (k = 72 with the Hermite
    table: the step test)."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg = st.xs.shape[0]
    ref_tab, tab = _tables(kind)
    xs_k, mc_k = st.xs[:, :k], st.mc[:, :k]
    xc_f, xn_f = _planar_coord_views(xs_k, spec.ncells, k, Cg)
    fx, fy, fz, eb = CP.cell_forces_pallas_newton_rescredit(
        xc_f, xn_f, mc_k, _half_concat(mc_k, spec.ncells, k, Cg), ref_tab, cap=k,
        ncells=spec.ncells, box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut,
        energy=True)
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=TLJ_, energy=True)
    f, teb = CF.cell_force_newton(tst.xs, tst.mc, tab, **kw)
    f64 = None
    if kind != "hermite":
        f64, _ = CF.cell_force_newton_ref(tst.xs.double(), tst.mc.double(), _f64(tab), **kw)
        f64 = f64[:, :k]
    _check_forces(kind, f[:, :k], np.stack([fx, fy, fz], -1), f64, f"K1 {kind} k={k}")
    assert not bool(f[:, k:].any())
    assert_energy(teb.sum(), np.asarray(eb).sum(), f"K1 {kind} k={k} energy")
    assert float(np.abs(np.asarray(eb)).sum()) > 0


@pytest.mark.parametrize("kernel", ["newton", "planar", "full"])
def test_typed_planar_and_full_at_cap_96(kernel):
    """Typed K1 and typed K6 (Hermite) and K7 (the bench's Chebyshev table:
    4 panels of degree 16) at full cap 96."""
    c = _ctx()
    spec, st, tst = c["spec"], c["st"], c["tst"]
    Cg = st.xs.shape[0]
    lj = dict(box=spec.box, lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut)
    tkw = dict(ncells=spec.ncells, box=spec.box, lj=TLJ_)
    if kernel == "full":
        ref_tab, tab = _tables("cheb 4 16")
        C = spec.n_cells
        xs = np.asarray(st.xs)
        xn = np.concatenate([xs[:C][spec.stencil()].reshape(C, 27 * CAP, 3),
                             np.zeros((Cg - C, 27 * CAP, 3), np.float32)])
        f, eb = CP.cell_forces_pallas(st.xs, jnp.asarray(xn), st.mc, st.mn, st.sid, st.nid,
                                      ref_tab.cval, ref_tab.cder, cap=CAP, cv_lo=ref_tab.lo,
                                      cv_hi=ref_tab.hi, **lj)
        tf, teb = CF.cell_force_full(tst.xs, tst.mc, tst.sid, tab, **tkw)
        f64, _ = CF.cell_force_full_ref(tst.xs.double(), tst.mc.double(), tst.sid.double(),
                                        _f64(tab), **tkw)
        _check_forces("cheb", tf, f, f64, "K7 cap=96")
        assert_energy(teb.sum(), np.asarray(eb).sum(), "K7 cap=96 energy")
        return
    ref_tab, tab = _tables("hermite")
    xc_f, xn_f = _planar_coord_views(st.xs, spec.ncells, CAP, Cg)
    mn_f = _half_concat(st.mc, spec.ncells, CAP, Cg)
    jkw = dict(cap=CAP, energy=True, types=(st.ts, st.tnf), type_pair=PAIR, **lj)
    if kernel == "newton":
        fx, fy, fz, eb = CP.cell_forces_pallas_newton_rescredit(
            xc_f, xn_f, st.mc, mn_f, ref_tab, ncells=spec.ncells, **jkw)
        f, teb = CF.cell_force_newton(tst.xs, tst.mc, tab, k=CAP, ts=tst.ts, type_pair=PAIR,
                                      energy=True, **tkw)
    else:
        fx, fy, fz, fnx, fny, fnz, eb = CP.cell_forces_pallas_newton_planar(
            xc_f, xn_f, st.mc, mn_f, ref_tab, **jkw)
        f, cred, teb = CF.cell_force_newton_planar(tst.xs, tst.mc, tab, ts=tst.ts,
                                                   type_pair=PAIR, energy=True, **tkw)
        assert_forces(cred.reshape(Cg, 13 * CAP, 3), np.stack([fnx, fny, fnz], -1),
                      "typed K6 credits")
    assert_forces(f, np.stack([fx, fy, fz], -1), f"typed {kernel} cap=96")
    assert_energy(teb.sum(), np.asarray(eb).sum(), f"typed {kernel} energy")


def _tail_inputs(st, O):
    """K2's inputs from the slot state ``st`` at kernel_cap KCAP: the tail
    (slots >= KCAP) compacted into O rows as the hosts list it, (xo (5, O),
    xp (4, N))."""
    Cg, cap = st.mc.shape
    S = Cg * cap
    mc = np.asarray(st.mc)
    ids = np.nonzero((mc > 0.5) & (np.arange(cap) >= KCAP)[None])
    ovl = np.full(O, S)
    ovl[:len(ids[0])] = ids[0] * cap + ids[1]
    xs = np.asarray(st.xs).reshape(S, 3)
    mo = (ovl < S).astype(np.float32)
    xo = np.concatenate([(xs[np.clip(ovl, 0, S - 1)] * mo[:, None]).T, mo[None], mo[None]])
    xp = np.concatenate([np.asarray(st.xs)[:, :KCAP].reshape(-1, 3).T,
                         mc[:, :KCAP].reshape(1, -1)])
    return xo.astype(np.float32), xp.astype(np.float32)


def test_overflow_force_tail_256():
    """K2 with overflow_cap 256 (47 live tail rows) and the 16-panel table,
    energy on."""
    c = _ctx()
    spec, st = c["spec"], c["st"]
    ref_tab, tab = _tables("cheb 16 16")
    xo, xp = _tail_inputs(st, 256)
    O, N = xo.shape[1], xp.shape[1]
    assert 20 < int(xo[3].sum()) < 128
    N_pad = -(-N // 128) * 128
    fo, fp = CP.overflow_forces_pallas(
        jnp.asarray(np.concatenate([xo, np.zeros((3, O), np.float32)])),
        jnp.asarray(np.pad(xp, ((0, 0), (0, N_pad - N)))), ref_tab, box=spec.box,
        lj_eps=LJ.epsilon, lj_sig=LJ.sigma, lj_rcut=LJ.rcut, energy=True)
    kw = dict(box=spec.box, lj=TLJ_, energy=True)
    txo, txp = torch.as_tensor(xo), torch.as_tensor(xp)
    tfo, tfp = CF.overflow_force(txo, txp, tab, **kw)
    fo, fp = np.asarray(fo), np.asarray(fp)
    fo64, fp64 = CF.overflow_force_ref(txo.double(), txp.double(), _f64(tab), **kw)
    _check_forces("cheb", tfo[:3], fo[:3], fo64[:3], "K2 fo")
    _check_forces("cheb", tfp, fp[:3, :N], fp64, "K2 fp")
    assert_energy(tfo[3].sum(), fo[3].sum(), "K2 energy", rtol=ENERGY_RTOL)


def test_cell_step_kernel_cap_72_matches_jax():
    """The cell host at cap 96 with kernel_cap 72 and overflow_cap 136, 5
    kT = 0 steps from the same state, the energy on each (energy_stride 1:
    one compiled phase; K1 at k = 72 and K2 on every step): integer and
    flag leaves exactly, the rest at the parity tolerances."""
    c = _ctx()
    spec, params = c["spec"], c["params"]
    st = init_cell_state(spec, c["core"], kernel_cap=KCAP, overflow_cap=136)
    assert not bool(st.tail_ovf) and int(st.tail_count) > 20
    kw = dict(hill_capacity=512, energy_stride=1, kernel_cap=KCAP, overflow_cap=136,
              use_pallas=True, static_do_hills=False, static_do_energy=True,
              static_do_rebuild=False)
    jstep = jax.jit(make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ,
                                   spec, hill_stride=10, rebuild_stride=10, **kw))
    tstep = tpc.make_cell_step(to_port(params), TLP(dt=0.002, friction=1.0, kT=0.0), TLJ_,
                               tcells.CellSpec(**dataclasses.asdict(spec)), 10, **kw)
    ts = to_port(st)
    for i in range(5):
        st, e = jstep(st, None)
        ts, te = tstep(ts)
        for f in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow"):
            assert_exact(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        for f in ("step", "last_calls", "hills_truncated"):
            assert_exact(getattr(ts.core, f), getattr(st.core, f), f"step {i} core.{f}")
        for f in ("xs", "vs", "fs"):
            assert_forces(getattr(ts, f), getattr(st, f), f"step {i} {f}")
        assert_energy(te, e, f"step {i} energy")
        assert float(np.abs(np.asarray(e))) > 0
    assert not bool(st.tail_ovf) and int(st.tail_fallbacks) == 0  # K2 ran on every step


def test_plans_fit_and_cover():
    """Every row-pass plan (K1, K6: 3 credit components; K7: 4; typed or
    not; the Hermite table of 201 rows, the 16 x 16 Chebyshev table and
    one past ``TABLE_SMEM_MAX``) at caps 8 ... 1,024 in steps of 8 fits
    227 KB, its pieces take each of the 14 cells' first k slots once, and
    in the pieces form, sorted by sub-cell bin and cut into chunks, each
    occupied slot once, in chunks of at most CHUNK within one cell, at most
    ``max_chunks`` a piece; its row tiles take each row once; every K2 plan
    for tails 8 ... 2,048 fits and its blocks take each (tail row, partner)
    once."""
    tables = [(CF.HERMITE, 201, 0), (CF.CHEB, 16, 17), (CF.CHEB, 1024, 8)]
    rng = np.random.default_rng(0)
    for k in range(8, 1025, 8):
        occ = rng.random((14, k)) < rng.uniform(0.3, 1.0)
        keys = rng.integers(0, CF.NKEY, (14, k))
        for nc, typed in ((3, False), (3, True), (4, False)):
            for look in tables:
                plan = CF.row_plan(k, nc, typed, *look)
                assert plan.smem <= CF.SMEM_MAX, (k, nc, typed, look, plan)
                assert plan.small == (k <= CF.SMALL_K and look[1] < 1024), (k, look, plan)
                assert plan.table_smem == (look[1] < 1024)
                pieces = CF.piece_candidates(k, plan)
                got = np.concatenate(pieces)
                want = np.stack(np.meshgrid(np.arange(14), np.arange(k), indexing="ij"),
                                -1).reshape(-1, 2)
                np.testing.assert_array_equal(got, want)
                if not plan.small:
                    tiles = [min(k, t + plan.row_tile) - t for t in range(0, k, plan.row_tile)]
                    assert sum(tiles) == k and plan.row_tile == min(k, CF.ROW_TILE)
                    assert plan.piece_words <= CF.PIECE_WORDS
                    _check_piece_chunks(k, plan, pieces, occ, keys)
    N = 3 * 128 + 5  # a ragged last tile of partners
    for O in range(8, 2049, 8):
        for look in tables:
            assert CF.k2_plan(O, N, *look).smem <= CF.SMEM_MAX
        plan = CF.k2_plan(O, N, *tables[0])
        blocks = CF.k2_blocks(O, N, plan)
        row_tiles = sorted({r for *_, r in blocks})
        assert _partition(row_tiles, O), O
        for y, rows in enumerate(row_tiles):  # each row tile meets every partner once
            for tail, n in ((False, N), (True, O)):
                got = sorted(p for _, yy, t, p, r in blocks if yy == y and t == tail)
                assert _partition(got, n) and all(r == rows for _, yy, _, _, r in blocks
                                                  if yy == y), (O, y, tail)


def _check_piece_chunks(k, plan, pieces, occ, keys):
    """The pieces form's sort and chunks take each occupied slot once: by
    cell, bin and slot within a piece, chunks of 1 to CHUNK candidates that
    tile the piece and never span two cells, at most ``max_chunks``."""
    seen = []
    for cand, (order, chunks) in zip(pieces, CF.piece_chunks(k, plan, occ, keys)):
        o, sl = cand[order, 0], cand[order, 1]
        assert occ[o, sl].all() and len(order) == int(occ[cand[:, 0], cand[:, 1]].sum())
        assert (np.diff((o * CF.NKEY + keys[o, sl]) * k + sl) > 0).all()  # by cell, bin, slot
        assert len(chunks) <= CF.max_chunks(plan.piece_words), (k, plan)
        if len(order):
            a, b = np.asarray(chunks).T
            assert a[0] == 0 and b[-1] == len(order) and (a[1:] == b[:-1]).all(), (k, plan)
            assert ((b - a >= 1) & (b - a <= CF.CHUNK) & (o[a] == o[b - 1])).all(), (k, plan)
        seen.append(o * k + sl)
    hits = np.bincount(np.concatenate(seen), minlength=14 * k)
    np.testing.assert_array_equal(hits, occ.reshape(-1))


def _partition(ranges, n) -> bool:
    """Whether the sorted [start, stop) ranges tile [0, n) without overlap."""
    return bool(ranges) and ranges[0][0] == 0 and ranges[-1][1] == n and all(
        a[1] == b[0] and a[0] < a[1] for a, b in zip(ranges, ranges[1:] + [(n, n + 1)]))
