"""PyTorch port: the counter hash and pass 1 of the hill collections.

``ops/collect``'s plain versions of pass 1, ``p1_counts_half_ref`` and
``p1_counts_typed_ref`` (what the CPU runs, and what ``chip_smoke.py``
holds the CUDA kernels to), against JAX's own pass 1: the ``row_counts``
and ``ncalls`` that the ``lax.scan`` of ``p1_chunk`` carries out of JAX's
``collect_hills_half`` / typed ``collect_hills`` (read from their jaxpr),
exactly, on the jittered 12^3 lattice on 5^3 cells of cap 32, with the
acceptance threshold on (hill_density 20 over 4,000 calls) and off
(hill_density -1).  The half-stencil pass is held over the whole lattice,
in 7-cell chunks of ``P1_DRAWS``, and over the owned boxes of a 2-rank slab
and a 2 x 2 brick (each box's rows those of JAX's single-device pass, and
the boxes' ncalls summing to its); the typed pass over the lattice and in
7-cell chunks.  Both passes also at cap 128 in float64 on
``chip_smoke.dense_lattice`` (3^3 cells; the typed kernel stages their
candidate cells in two pieces in float64).  The plain uniforms bitwise JAX's
and the plain normals within the tolerance of ``test_torch_rng.py`` at 1,
5 and 897 columns and row ids at and above 2^31 and 2^32.  Then the
dispatching ``uniform_rows_cols`` /
``normal_rows_cols`` on the CPU bitwise their ``_ref`` (no launch
counted), and every wrapper raising on a device that is neither the CPU
nor CUDA.  The kernels themselves are held to these plain versions on the
card (``tests/test_torch_gpu.py``, ``chip_smoke.hash_kernel_phase``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend import core as jcore

from _torch_parity import np_, to_port
from chip_smoke import dense_lattice, edge_lattice
from edm_tpu import bias as JB
from edm_tpu.models import pair_edm as jpe
from edm_tpu.models.cells import CellSpec
from edm_tpu.models.langevin import LangevinParams
from edm_tpu.models.lj import LJParams
from edm_tpu.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu.ops import hashrng as jh
from edm_tpu.utils.config import parse_edm_text
from edm_tpu_torch.models import pair_edm_cells as tpc
from edm_tpu_torch.models.langevin import LangevinParams as TLP
from edm_tpu_torch.models.lj import LJParams as TLJ
from edm_tpu_torch.ops import collect, hashrng, prng
from edm_tpu_torch.ops.cellforce import box_cells, half_neighbors, stencil_neighbors
from test_torch_parallel import CFG, _ragged_setup

KEY, LAST_CALLS = 11, 4000
TYPES = np.where(np.arange(1728) % 2 == 0, 2, 1).astype(np.int32)
BMAX2 = 3.0 * 3.0  # the CV's box_high squared


def _cfg(hill_density):
    return CFG.replace("hill_density 20", f"hill_density {hill_density}")


@pytest.fixture(scope="module")
def lattice():
    _, tcore, tspec = _ragged_setup()
    spec = CellSpec.create(tspec.box, cutoff=3.0, n_atoms=1728)
    assert spec.ncells == (5, 5, 5) and spec.cap == 32
    return spec, np_(tcore.x)


def _jax_pass1(lattice, hill_density, typed, types=TYPES, dtype=jnp.float32):
    """JAX's pass-1 (row_counts, ncalls) of one collection in ``dtype``
    (the positions cast to it): the outputs of the ``lax.scan`` in the
    collection's jaxpr whose carry is (int32[rows], int32[]), evaluated; and
    the state."""
    spec, x = lattice
    params, bs = JB.subdivide(parse_edm_text(_cfg(hill_density)), 1.0, 1.0, [0], [3.0], [0],
                              [3.0], [False], [0], dtype=jnp.float32)
    state = init_cell_state(spec, jpe.init_state(bs, jnp.asarray(x), jax.random.PRNGKey(0)))
    kw = dict(types=types, type_pair=(1, 2)) if typed else {}
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.8), LJParams(),
                          spec, 10, hill_capacity=512, cell_chunk=8, **kw)
    free = dict(zip(step.__code__.co_freevars, (c.cell_contents for c in step.__closure__)))
    coll = free["collect_hills" if typed else "collect_hills_half"]
    args = (state, jax.random.PRNGKey(KEY), jnp.asarray(LAST_CALLS, jnp.int32))
    closed = jax.make_jaxpr(lambda st, k, lc: coll(st, st.xs.astype(dtype), k, lc, dtype))(*args)
    scans = [e for e in closed.jaxpr.eqns if e.primitive.name == "scan" and len(e.outvars) == 2
             and all(v.aval.dtype == jnp.int32 for v in e.outvars)
             and [v.aval.ndim for v in e.outvars] == [1, 0]]
    assert len(scans) == 1
    fn = jcore.jaxpr_as_fun(jcore.ClosedJaxpr(
        closed.jaxpr.replace(outvars=list(scans[0].outvars)), closed.consts))
    rc, nc = jax.jit(fn)(*jax.tree.leaves(args))
    return np.asarray(rc).astype(np.int64), int(nc), state


def _thresh(hill_density):
    if hill_density < 0:
        return None
    return torch.div(torch.full((), float(hill_density)), torch.tensor(float(LAST_CALLS)))


def _seeds():
    return hashrng.seeds_from_key(prng.PRNGKey(KEY))


@pytest.fixture(scope="module", params=[20, -1], ids=["thresh", "accept-all"])
def half_case(request, lattice):
    rc, nc, state = _jax_pass1(lattice, request.param, typed=False)
    return request.param, rc, nc, to_port(state)


def _half_counts(spec, pstate, cells, hill_density):
    """The plain pass 1 over the row cells ``cells`` (a tensor of cell ids)
    of the slot lattice: (row_counts, ncalls, the rows' global ids)."""
    cap = spec.cap
    gids = (cells[:, None] * cap + torch.arange(cap)[None, :]).reshape(-1)
    nbr = half_neighbors(tuple(spec.ncells), torch.device("cpu"))
    box = torch.tensor(spec.box, dtype=torch.float32)
    rc, nc = collect.p1_counts_half_ref(pstate.xs, pstate.mc, cells, nbr, box, BMAX2,
                                        _thresh(hill_density), _seeds())
    return rc.numpy(), int(nc), gids.numpy()


def _chunks(n_cells, width):
    """P1_DRAWS for chunks of ``n_cells`` cells of a ``width``-draw row."""
    return n_cells * 32 * width


@pytest.mark.parametrize("form", ["lattice", "chunks", "slab", "brick"])
def test_p1_counts_half_ref_matches_jax(lattice, half_case, form):
    spec, _ = lattice
    hd, jrc, jnc, pstate = half_case
    C, cap = spec.n_cells, spec.cap
    assert jnc > 0 and not jrc[C * cap:].any()
    if form in ("lattice", "chunks"):
        saved = collect.P1_DRAWS
        if form == "chunks":
            collect.P1_DRAWS = _chunks(7, 2 * 14 * cap)
            assert len(collect._p1_ranges(C, 2 * 14 * cap * cap)) == 18
        try:
            rc, nc, _ = _half_counts(spec, pstate, torch.arange(C), hd)
        finally:
            collect.P1_DRAWS = saved
        np.testing.assert_array_equal(rc, jrc[:C * cap])
        assert nc == jnc
        assert (rc.sum() == jnc) == (hd < 0)
        return
    if form == "slab":  # 2 ranks over nx = 5: columns 3 + 2, contiguous cell ranges
        boxes = [torch.arange(0, 75), torch.arange(75, 125)]
    else:  # 2 x 2 bricks: x columns 3 + 2 by y rows 3 + 2, z whole
        boxes = [box_cells(spec.ncells, ((x0, y0, 0), (wx, wy, 5)), "cpu")
                 for x0, wx in ((0, 3), (3, 2)) for y0, wy in ((0, 3), (3, 2))]
    total, seen = 0, []
    for cells in boxes:
        rc, nc, gids = _half_counts(spec, pstate, cells, hd)
        np.testing.assert_array_equal(rc, jrc[gids], err_msg=f"{form} box {cells}")
        total += nc
        seen.append(gids)
    assert total == jnc
    assert np.array_equal(np.sort(np.concatenate(seen)), np.arange(C * cap))


@pytest.mark.parametrize("chunked", [False, True], ids=["one-chunk", "chunks"])
@pytest.mark.parametrize("hill_density", [20, -1], ids=["thresh", "accept-all"])
def test_p1_counts_typed_ref_matches_jax(lattice, hill_density, chunked):
    spec, _ = lattice
    jrc, jnc, state = _jax_pass1(lattice, hill_density, typed=True)
    C, cap = spec.n_cells, spec.cap
    pstate = to_port(state)
    t = torch.as_tensor(TYPES, dtype=torch.int64)[torch.clamp(pstate.aid, 0, 1727)]
    tslot = torch.where(pstate.aid < 1728, t, 0).to(torch.float32).reshape(pstate.mc.shape)
    nbr = stencil_neighbors(tuple(spec.ncells), torch.device("cpu"))
    saved = collect.P1_DRAWS
    if chunked:
        collect.P1_DRAWS = _chunks(7, 27 * cap)
    try:
        rc, nc = collect.p1_counts_typed_ref(pstate.xs, pstate.aid, tslot, nbr,
                                             torch.tensor(spec.box, dtype=torch.float32), BMAX2,
                                             _thresh(hill_density), _seeds(), 1728, (1, 2))
    finally:
        collect.P1_DRAWS = saved
    assert jnc > 0 and not jrc[C * cap:].any()
    np.testing.assert_array_equal(rc.numpy(), jrc[:C * cap])
    assert int(nc) == jnc


def test_p1_counts_half_ref_any_cell_order(lattice, half_case):
    """Pass 1 over an unordered cell-id tensor (the kernel's cell list):
    each cell's rows are its rows of the whole-lattice pass, and an
    unordered subset's ncalls and its complement's sum to the lattice's."""
    spec, _ = lattice
    hd, jrc, jnc, pstate = half_case
    C, cap = spec.n_cells, spec.cap
    perm = torch.as_tensor(np.random.default_rng(7).permutation(C))
    total = 0
    for cells in (perm[:40], perm[40:]):
        rc, nc, _ = _half_counts(spec, pstate, cells, hd)
        np.testing.assert_array_equal(rc.reshape(-1, cap),
                                      jrc[:C * cap].reshape(C, cap)[cells.numpy()])
        total += nc
    assert total == jnc


@pytest.fixture(scope="module")
def edge():
    pts, box, cap, types = edge_lattice()
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts), cap=cap)
    assert spec.ncells == (5, 3, 5) and spec.edge == (3.0, 3.0, 3.0)
    return (spec, pts.astype(np.float32)), types


@pytest.mark.parametrize("typed", [False, True], ids=["half", "typed"])
@pytest.mark.parametrize("hill_density", [2000, -1], ids=["thresh", "accept-all"])
def test_p1_counts_ref_edge_lattice_matches_jax(edge, typed, hill_density):
    """The edge lattice (full and empty cells of cap 8, displacements at
    +-L/4 and +-L/2, r^2 at bmax^2 and one float32 step either side of it):
    the plain pass 1 equals JAX's exactly, with the threshold at 0.5 and
    with none."""
    lat, types = edge
    spec = lat[0]
    C, cap, n = spec.n_cells, spec.cap, spec.n_atoms
    jrc, jnc, state = _jax_pass1(lat, hill_density, typed, types)
    pstate = to_port(state)
    assert (pstate.mc.sum(1) == cap).sum() == 2 and (pstate.mc.sum(1) == 0).sum() > C // 2
    thresh = _thresh(hill_density)
    box = torch.tensor(spec.box, dtype=torch.float32)
    if typed:
        t = torch.as_tensor(types, dtype=torch.int64)[torch.clamp(pstate.aid, 0, n - 1)]
        tslot = torch.where(pstate.aid < n, t, 0).to(torch.float32).reshape(pstate.mc.shape)
        rc, nc = collect.p1_counts_typed_ref(
            pstate.xs, pstate.aid, tslot, stencil_neighbors(tuple(spec.ncells), "cpu"), box,
            BMAX2, thresh, _seeds(), n, (1, 2))
    else:
        rc, nc = collect.p1_counts_half_ref(
            pstate.xs, pstate.mc, torch.arange(C), half_neighbors(tuple(spec.ncells), "cpu"),
            box, BMAX2, thresh, _seeds())
    assert jnc > 0 and not jrc[C * cap:].any()
    np.testing.assert_array_equal(rc.numpy(), jrc[:C * cap])
    assert int(nc) == jnc
    if hill_density > 0:
        assert 0 < rc.sum() < (jnc if typed else 2 * jnc)


@pytest.fixture(scope="module")
def large():
    pts, box, cap, types = dense_lattice(128)
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts), cap=cap)
    assert spec.ncells == (3, 3, 3) and spec.cap == 128
    return (spec, pts.astype(np.float32)), types


@pytest.mark.parametrize("typed", [False, True], ids=["half", "typed"])
@pytest.mark.parametrize("hill_density", [20, -1], ids=["thresh", "accept-all"])
def test_p1_counts_ref_large_cap_matches_jax(large, typed, hill_density):
    """Cap 128 in float64 (``chip_smoke.dense_lattice``: 3^3 cells, one
    full, one empty, the rest half to fully occupied; the typed kernel
    stages their candidate cells in two pieces in float64): the plain pass
    1 equals JAX's exactly, with the threshold on and with none.  2-11 s a
    case on one worker, 20 s the four."""
    lat, types = large
    spec = lat[0]
    C, cap, n = spec.n_cells, spec.cap, spec.n_atoms
    f64 = torch.float64
    jrc, jnc, state = _jax_pass1(lat, hill_density, typed, types, jnp.float64)
    pstate = to_port(state)
    assert (pstate.mc.sum(1) == cap).sum() == 1
    thresh = None if hill_density < 0 else torch.div(torch.full((), float(hill_density), dtype=f64),
                                                     torch.tensor(float(LAST_CALLS), dtype=f64))
    box = torch.tensor(spec.box, dtype=f64)
    xs = pstate.xs.to(f64)
    if typed:
        t = torch.as_tensor(types, dtype=torch.int64)[torch.clamp(pstate.aid, 0, n - 1)]
        tslot = torch.where(pstate.aid < n, t, 0).to(f64).reshape(pstate.mc.shape)
        rc, nc = collect.p1_counts_typed_ref(
            xs, pstate.aid, tslot, stencil_neighbors(tuple(spec.ncells), "cpu"), box, BMAX2,
            thresh, _seeds(), n, (1, 2))
    else:
        rc, nc = collect.p1_counts_half_ref(
            xs, pstate.mc.to(f64), torch.arange(C), half_neighbors(tuple(spec.ncells), "cpu"),
            box, BMAX2, thresh, _seeds())
    assert jnc > 0 and not jrc[C * cap:].any()
    np.testing.assert_array_equal(rc.numpy(), jrc[:C * cap])
    assert int(nc) == jnc
    if hill_density > 0:
        assert 0 < rc.sum() < (jnc if typed else 2 * jnc)


def _wide_ids():
    """Row ids from 0 up, about 2^31 and 2^32, and up to 2^40 (all taken
    mod 2^32, as ``rows.astype(uint32)``)."""
    rng = np.random.default_rng(6)
    return np.concatenate([np.arange(16), 2**31 + np.arange(-8, 8), 2**32 + np.arange(-8, 8),
                           rng.integers(2**31, 2**40, 24)]).astype(np.int64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cols", [1, 5, 897])
def test_uniform_rows_cols_ref_matches_jax(n_cols, dtype):
    """The plain uniforms bitwise JAX's at the widths at the edges of the
    kernel's tiles (a thread a row up to 16 columns, a warp a row beyond)
    and row ids at and above 2^31 and 2^32."""
    rows = _wide_ids()
    seeds = (0x9E3779B9, 987654321)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = jh.uniform_rows_cols(jnp.asarray(seeds, jnp.uint32), jnp.asarray(rows), n_cols, jdt)
    out = hashrng.uniform_rows_cols_ref(seeds, torch.as_tensor(rows), n_cols, dtype)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_cols", [1, 5, 897])
def test_normal_rows_cols_ref_matches_jax(n_cols, dtype):
    """The plain normals against JAX's at the same widths and row ids,
    within ``test_torch_rng``'s tolerance (log and cos round differently in
    XLA and PyTorch)."""
    rows = _wide_ids()
    seeds = (123456789, 987654321)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    ref = np.asarray(jh.normal_rows_cols(jnp.asarray(seeds, jnp.uint32), jnp.asarray(rows),
                                         n_cols, jdt))
    out = hashrng.normal_rows_cols_ref(seeds, torch.as_tensor(rows), n_cols, dtype).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("normal", [False, True], ids=["uniform", "normal"])
def test_hash_dispatch_on_cpu_is_the_plain_version(dtype, normal):
    rng = np.random.default_rng(4)
    rows = torch.as_tensor(np.concatenate([np.arange(50), rng.integers(0, 2**33, 50)]))
    seeds = (0x9E3779B9, 12345)
    fn, ref = ((hashrng.normal_rows_cols, hashrng.normal_rows_cols_ref) if normal else
               (hashrng.uniform_rows_cols, hashrng.uniform_rows_cols_ref))
    n0 = fn.launches
    out = fn(seeds, rows, 7, dtype)
    assert out.dtype == dtype and out.shape == (100, 7)
    assert torch.equal(out, ref(seeds, rows, 7, dtype))
    assert fn.launches == n0  # the CPU launches no kernel
    # row ids are taken mod 2^32 (rows.astype(uint32))
    assert torch.equal(fn(seeds, rows + 2**32, 7, dtype), out)


def _meta_calls():
    meta = torch.device("meta")
    rows = torch.zeros(4, dtype=torch.int64, device=meta)
    box = torch.zeros(3, device=meta)
    xs = torch.zeros(27, 4, 3, device=meta)
    aid = torch.zeros(27 * 4, dtype=torch.int64, device=meta)
    nbr = torch.zeros(27, 27, dtype=torch.int64, device=meta)
    return {
        "uniform_rows_cols": lambda: hashrng.uniform_rows_cols((1, 2), rows, 3, torch.float32),
        "normal_rows_cols": lambda: hashrng.normal_rows_cols((1, 2), rows, 3, torch.float32),
        "p1_counts_half": lambda: collect.p1_counts_half(
            xs, xs[..., 0], rows[:2], nbr[:, :13], box, BMAX2, None, (1, 2)),
        "p1_counts_typed": lambda: collect.p1_counts_typed(
            xs, aid, xs[..., 0], nbr, box, BMAX2, None, (1, 2), 27 * 4, (1, 2)),
    }


@pytest.mark.parametrize("name", ["uniform_rows_cols", "normal_rows_cols", "p1_counts_half",
                                  "p1_counts_typed"])
def test_unknown_device_raises(name):
    with pytest.raises(ValueError, match=f"no {name} kernel for device meta"):
        _meta_calls()[name]()


def test_collections_call_the_module_names():
    """The cell host's pass 1 and its draws go through ``pair_edm_cells``'
    module-level names (what ``chip_smoke.plain_versions`` swaps): one
    ``p1_counts_half`` a half-stencil round, one ``p1_counts_typed`` a typed
    round, ``uniform_rows_cols`` for pass 2 and ``normal_rows_cols`` for the
    thermostat."""
    params, core, tspec = _ragged_setup()
    calls = []
    names = ("p1_counts_half", "p1_counts_typed", "uniform_rows_cols", "normal_rows_cols")
    saved = {n: getattr(tpc, n) for n in names}
    for n, fn in saved.items():
        setattr(tpc, n, lambda *a, _n=n, _fn=fn: calls.append(_n) or _fn(*a))
    try:
        for typed in (False, True):
            kw = dict(types=TYPES, type_pair=(1, 2)) if typed else {}
            state = tpc.init_cell_state(tspec, core)
            step = tpc.make_cell_step(params, TLP(dt=0.002, friction=1.0, kT=0.8), TLJ(), tspec,
                                      10, hill_capacity=512, static_do_hills=True,
                                      static_do_energy=False, static_do_rebuild=False, **kw)
            step(state)
    finally:
        for n, fn in saved.items():
            setattr(tpc, n, fn)
    assert calls == ["normal_rows_cols", "p1_counts_half", "uniform_rows_cols",
                     "normal_rows_cols", "p1_counts_typed", "uniform_rows_cols"]
