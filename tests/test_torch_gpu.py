"""PyTorch port on a GPU: each CUDA kernel against its plain version.

Every test here needs a CUDA device and skips without one.  The file
imports neither jax nor the JAX package, so it runs on a GPU machine
without them, skipping the repository's conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

Inputs: a 600-atom LJ fluid with a crowded octant (a real tail above
kernel_cap), built with the port's own entry points from a numpy seed,
and a bias grid carrying deposited hills; K1 and K2 run with the Hermite
table and with two Chebyshev tables (K3: 4 panels of degree 16, 1 panel of
degree 64); K6 (typed and not) and typed K1 on the same atoms with the
binary types of ``test_torch_typed.py``; K7 on states with slot ids at cap
56 and cap 32.  The row pass that K1, K6 and K7 share is also run on the
slot states of ``test_torch_rowpass.py`` (clustered atoms with empty cells
and holes, a cell full to cap, 3^3 cells) at k = 1, 24, 32 and 64, with
``torch.empty`` poisoned, since the kernels must write every element of
their outputs.  K2 is also run on ``test_torch_k2k4.overflow_case`` (1, 32
and 128 tail rows of which none, one, 8 or all are live, ``own`` partly
cleared, 1,000 partners, which is no multiple of the kernel's tile) on
poisoned outputs.  K4 and K5 deposit on the periodic grids of
``test_torch_deposit.py``, empty and carrying values, and on grids whose
size is no multiple of 4 with 1, 200 and 300 raw centres up to three
periods outside the grid and on its wrap seam.  The user's entry points
run on the card against the CPU: ``EDMBias(device="cuda")`` in float64
(1-D and 2-D), ``run_simulation`` of a small cell host with records and
every output, and a checkpoint resumed bitwise.  The Threefry draws: the
draw kernel's bits and uniforms bitwise and its normals within 4 (float32)
and 7 (float64) ulps of their plain versions (n = 1 to 10^6 + 3), one
launch a draw.  The dense and
blocked pair hosts: ``threefry_rows`` bitwise against its numpy chain at
the blocked host's widths, the work-sharded host's, ragged and short rows,
70,000 rows and strided row tiles, int32 and int64 ids, one launch a call;
and one hill step of each host on the card against the CPU.  The
multi-device layer: K1's owned-row form (``row_box``) on the slab host's
windows of the 10,000-atom bench lattice (2, 3 and 4 ranks
over its 9 columns, ragged ranks included) at k = 24 and 32, against its
plain version and bitwise against the full-window kernel with the rows
outside the box masked, and with the Chebyshev table (4 panels of degree
16) on slab and brick windows; and a 2-rank slab step on the card
(``parallel.launch``, a rank per card or both on one) against the
single-device step.  With several cards (each case skips, naming the
count, where the machine has fewer cards than its ranks): the work-sharded
cell host and the sharded 2-D host on 2 ranks, the spatial host on (2, 1)
and 2 x 2, and the brick host on 2 x 2 x 2, 4 kT = 0 steps each over NCCL
(a card a rank) and over gloo (the ranks on card 0), every leaf of every
rank bitwise the same; and a rank that raises inside an NCCL collective,
reported by ``launch`` within its timeout.  The counter hash and pass 1 of the hill
collections (``csrc/hashrng.cu``): ``hash_uniforms`` bitwise and
``hash_normals`` within 2 ulps of their plain versions at the edges of
their tiles (1 to 897 columns, 1 to 65,569 rows, ids above 2^32, a strided
view), in float32 and float64; ``p1_count_half`` (the lattice, a 2-rank
slab's and a 2 x 2 brick's owned cells) and ``p1_count_typed`` on the
10,000-atom lattice, both on ``chip_smoke.edge_lattice`` (cap 8) in
float32 and float64, and both on ``chip_smoke.dense_lattice`` at caps
whose cells take more than one shared-memory piece (128 to 3000), row
counts and ncalls exactly, the threshold on and off; and whole hill
collections, half and typed, bitwise through the kernels and the plain
versions.
Past the kernels' old shape limits (their launch plans in
``ops/cellforce``): K1 at k = 72 to 512 on ``chip_smoke.cap_lattice``
(caps 96, 256 and 512: the row in pieces, its sweep culled by the chunks'
boxes, at 512 the rows in tiles too), typed K1, K6 and K7 at cap 96, each
also on the lattice's atoms drifted by a stride's travel (some past their
cells' faces, some by a box length across the periodic boundary), the
cull's counters against the plain count of pairs in reach (none dropped,
fewer tests than rows x candidates), K2 with 136, 384 and 1,024 tail rows (row
tiles), Chebyshev tables of degree 80, of 16 panels and of 1,024 panels
(read from global memory), and K4/K5 hills whose reach spans the grid.
Tolerances as in the CPU parity tests: forces within 2e-5 * max(1, max|f|), energies 1e-5
relative; deposited values
and derivatives within 1e-4 and 3e-4 of max|.|, bias_added within 2e-6.
Every kernel repeats bitwise.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_energy, assert_forces, tree_leaves
from edm_tpu_torch import bias as B
from edm_tpu_torch import gauss as tg
from edm_tpu_torch.models import pair_edm
from edm_tpu_torch.models import pair_edm_cells as PCELLS
from edm_tpu_torch.models.cells import CellSpec
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu_torch.ops import cellforce as CF
from edm_tpu_torch.ops import deposit_kernels as DK
from edm_tpu_torch.ops.chebyshev import f32_error_bound, fit_gauss_grid
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils.config import parse_edm_text
from edm_tpu_torch.utils import trace
from test_torch_k2k4 import BOX, overflow_case
from test_torch_rowpass import CASES, drift, reach2, slot_state, stencil_pair_counts

KCAP, OCAP = 24, 128
LJ = LJParams(epsilon=1.0, sigma=0.3, rcut=0.75)


@pytest.fixture(scope="module")
def cuda_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    dev = torch.device("cuda", 0)
    n = 600
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(5)
    gg, _ = bs.bias.add_value(
        torch.tensor(rng.uniform(0.2, 3.0, (80, 1)), dtype=torch.float32, device=dev),
        torch.tensor(rng.uniform(0.01, 0.2, 80), dtype=torch.float32, device=dev))
    gridpts = (np.stack(np.meshgrid(*[np.arange(14)] * 3, indexing="ij"), -1)
               .reshape(-1, 3) * (6.0 / 14) + 0.2)
    w = np.where((gridpts < 2.2).all(1), 1.6, 1.0)
    sel = rng.choice(len(gridpts), size=n, replace=False, p=w / w.sum())
    pts = gridpts[sel] + rng.uniform(-0.04, 0.04, (n, 3))
    core = pair_edm.init_state(bs, torch.tensor(pts, dtype=torch.float32, device=dev),
                               PRNGKey(0), n_est=n * 40)
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=n, cap=56)
    st = init_cell_state(spec, core, kernel_cap=KCAP, overflow_cap=OCAP)
    return params, spec, st, CF.hermite_pair_table(gg), gg


@pytest.mark.gpu
@pytest.mark.parametrize("k", [24, 32, 56])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_kernel(cuda_state, k, energy):
    _, spec, st, tbl, _ = cuda_state
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy)
    n0 = CF.cell_force_newton.launches
    f, eb = CF.cell_force_newton(st.xs, st.mc, tbl, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tbl, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.launches == n0 + 1
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 k={k}")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 k={k} energy")
    # deterministic credits: a second launch repeats bitwise
    f2, _ = CF.cell_force_newton(st.xs, st.mc, tbl, **kw)
    assert torch.equal(f, f2)


@pytest.mark.gpu
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_kernel(cuda_state, energy):
    params, spec, st, tbl, _ = cuda_state
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ, spec, 10,
                          use_pallas=True, static_do_hills=False,
                          static_do_energy=energy, static_do_rebuild=False,
                          kernel_cap=KCAP, overflow_cap=OCAP)
    xo, xp = step._overflow_inputs(st, st.xs)
    assert int((xo[3] > 0.5).sum()) > 20
    kw = dict(box=spec.box, lj=LJ, energy=energy)
    n0 = CF.overflow_force.launches
    fo, fp = CF.overflow_force(xo, xp, tbl, **kw)
    fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tbl, **kw)
    torch.cuda.synchronize()
    assert CF.overflow_force.launches == n0 + 1
    assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), "K2 fo")
    assert_forces(fp.cpu(), fp_ref.cpu(), "K2 fp")
    assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), "K2 energy")


@pytest.mark.gpu
def test_wrappers_check_inputs(cuda_state):
    _, spec, st, tbl, _ = cuda_state
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ, energy=False)
    with pytest.raises(TypeError, match="float32"):
        CF.cell_force_newton(st.xs.double(), st.mc, tbl, k=24, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        CF.cell_force_newton(st.xs.transpose(0, 1).contiguous().transpose(0, 1), st.mc, tbl,
                             k=24, **kw)
    with pytest.raises(ValueError, match="outside"):
        CF.cell_force_newton(st.xs, st.mc, tbl, k=st.xs.shape[1] + 8, **kw)
    with pytest.raises(ValueError, match="is on"):
        CF.cell_force_newton(st.xs, st.mc.cpu(), tbl, k=24, **kw)


TABLES = [(4, 16), (1, 64)]  # (panels, degree): the bench, the JAX default


@pytest.mark.gpu
@pytest.mark.parametrize("panels,deg", TABLES)
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_cheb_kernel(cuda_state, panels, deg, k, energy):
    _, spec, st, _, gg = cuda_state
    tab = fit_gauss_grid(gg, deg, panels)
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy)
    n0 = CF.cell_force_newton.launches
    f, eb = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tab, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.launches == n0 + 1
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 cheb P={panels} k={k}")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 cheb P={panels} energy")
    f2, eb2 = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
    assert torch.equal(f, f2) and torch.equal(eb, eb2)


@pytest.mark.gpu
@pytest.mark.parametrize("panels,deg", TABLES)
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_cheb_kernel(cuda_state, panels, deg, energy):
    params, spec, st, _, gg = cuda_state
    tab = fit_gauss_grid(gg, deg, panels)
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ, spec, 10,
                          use_pallas=True, static_do_hills=False, static_do_energy=energy,
                          static_do_rebuild=False, kernel_cap=KCAP, overflow_cap=OCAP)
    xo, xp = step._overflow_inputs(st, st.xs)
    kw = dict(box=spec.box, lj=LJ, energy=energy)
    n0 = CF.overflow_force.launches
    fo, fp = CF.overflow_force(xo, xp, tab, **kw)
    fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tab, **kw)
    torch.cuda.synchronize()
    assert CF.overflow_force.launches == n0 + 1
    assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), "K2 cheb fo")
    assert_forces(fp.cpu(), fp_ref.cpu(), "K2 cheb fp")
    assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), "K2 cheb energy")
    fo2, fp2 = CF.overflow_force(xo, xp, tab, **kw)
    assert torch.equal(fo, fo2) and torch.equal(fp, fp2)


@pytest.mark.gpu
def test_cheb_table_limits(cuda_state):
    """No Chebyshev table is refused: K1 and K2 take a degree-80 series (past
    the old limit of 64), 16 panels of degree 16 (past the old 8 panels) and
    1,024 panels of degree 7 (64 KB: past ``TABLE_SMEM_MAX``, read from
    global memory), each against its plain version; the one limit left, the
    Hermite table's 1,024 rows (JAX's own), raises."""
    params, spec, st, _, gg = cuda_state
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ, spec, 10,
                          use_pallas=True, static_do_hills=False, static_do_energy=True,
                          static_do_rebuild=False, kernel_cap=KCAP, overflow_cap=OCAP)
    xo, xp = step._overflow_inputs(st, st.xs)
    for deg, panels in ((80, 1), (16, 16), (7, 1024)):
        tab = fit_gauss_grid(gg, deg, panels)
        assert CF.row_plan(24, 3, False, CF.CHEB, panels, deg + 1).table_smem == (panels < 1024)
        for energy in (False, True):
            kw = dict(k=24, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy)
            f, eb = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
            f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tab, **kw)
            fo, fp = CF.overflow_force(xo, xp, tab, box=spec.box, lj=LJ, energy=energy)
            fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tab, box=spec.box, lj=LJ,
                                                   energy=energy)
            torch.cuda.synchronize()
            what = f"P={panels} deg={deg} energy={energy}"
            if deg == 80:  # one panel of high degree: ill-conditioned in float32
                t64 = dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())
                f64, _ = CF.cell_force_newton_ref(st.xs.double(), st.mc.double(), t64, **kw)
                assert float((f - f_ref).abs().max()) <= f32_error_bound(f_ref, f64, 2e-5), what
            else:
                assert_forces(f.cpu(), f_ref.cpu(), f"K1 {what}")
                assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), f"K2 fo {what}")
                assert_forces(fp.cpu(), fp_ref.cpu(), f"K2 fp {what}")
                assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 energy {what}")
                assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), f"K2 energy {what}")
    G = 1025
    big = CF.HermiteTable(tab=torch.zeros((G, 4), device=st.xs.device),
                          geom=(G, 0.0, 0.01, 10.24, 0.0, 10.24))
    with pytest.raises(ValueError, match="beyond"):
        CF.cell_force_newton(st.xs, st.mc, big, k=24, ncells=spec.ncells, box=spec.box, lj=LJ,
                             energy=False)


def _deposit_case(windowed):
    """(grid, centres, heights) on the card: test_torch_deposit.py's K4 and
    K5 grids and hills."""
    dev = torch.device("cuda", 0)
    G, sigma = (65536, 0.0293170) if windowed else (16384, 0.45)
    gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device=dev)
    rng = np.random.default_rng(3 if windowed else 9)
    if windowed:
        c = np.concatenate([rng.uniform(0, 10, (30,)), [0.001, 9.999, 0.05]])[:, None]
        h = rng.uniform(0.01, 0.2, (33,))
    else:
        c, h = rng.uniform(0, 10, (64, 1)), rng.uniform(0.1, 1.0, (64,))
    return (gg, torch.tensor(c, dtype=torch.float32, device=dev),
            torch.tensor(h, dtype=torch.float32, device=dev))


@pytest.mark.gpu
@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("carried", [False, True])
def test_deposit_kernel(cuda_state, windowed, carried):
    """``carried``: the grid already holds values and derivatives (seeded
    noise, so a dropped or shifted read of the old grid shows)."""
    gg, c, h = _deposit_case(windowed)
    if carried:
        rng = np.random.default_rng(11)
        G = gg.spec.grid.nbins[0]
        gg = DK._commit(gg, torch.tensor(rng.normal(0.0, 1.0, G), dtype=torch.float32,
                                         device=c.device),
                        torch.tensor(rng.normal(0.0, 10.0, (G, 1)), dtype=torch.float32,
                                     device=c.device))
    kernel, ref = ((DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref) if windowed else
                   (DK.deposit_dense_1d_kernel, DK.deposit_dense_1d_kernel_ref))
    n0 = kernel.launches
    out, ba = kernel(gg, c, h)
    out_ref, ba_ref = ref(gg, c, h)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    for a, b, rel in ((out.grid.values, out_ref.grid.values, 1e-4),
                      (out.grid.derivs, out_ref.grid.derivs, 3e-4)):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert float((ba - ba_ref).abs().max()) <= 2e-6
    assert float(((ba - h) / h).abs().max()) <= 1e-3  # conservation
    out2, ba2 = kernel(gg, c, h)
    assert torch.equal(out.grid.values, out2.grid.values)
    assert torch.equal(out.grid.derivs, out2.grid.derivs) and torch.equal(ba, ba2)


@pytest.mark.gpu
def test_add_value_routes_through_the_kernels(cuda_state):
    for windowed, kernel in ((True, DK.deposit_windowed_1d), (False, DK.deposit_dense_1d_kernel)):
        gg, c, _ = _deposit_case(windowed)
        n0 = kernel.launches
        out, ba = gg.add_value(c, 0.1)
        torch.cuda.synchronize()
        assert kernel.launches == n0 + 1
        assert bool(torch.isfinite(out.grid.values).all()) and ba.shape == (c.shape[0],)


@pytest.mark.gpu
@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("H", [1, 200, 300])
@pytest.mark.parametrize("carried", [False, True])
def test_deposit_kernel_raw_centres(cuda_state, poisoned_empty, windowed, H, carried):
    """K4 and K5 remap the centres themselves: raw centres up to three
    periods outside the grid, on the wrap seam and on the edges; one hill,
    200, and 300 (two list chunks); a grid size that is no multiple of 4 or
    of the tile; outputs over poisoned memory; bitwise repeats."""
    dev = torch.device("cuda", 0)
    G, sigma = (65538, 0.0293170) if windowed else (16386, 0.45)
    gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device=dev)
    W = gg.spec.window_shape[0]
    assert (W + 256 < G // 2) == windowed and G % 4
    rng = np.random.default_rng(17)
    seam = [10.0, 0.0, 9.9999, 1e-4, -1e-4, 10.0001, 20.0, -10.0]
    c = np.concatenate([seam, rng.uniform(-30, 40, 300)])[:H, None]
    h = rng.uniform(0.05, 0.2, H)
    c, h = (torch.tensor(a, dtype=torch.float32, device=dev) for a in (c, h))
    if carried:
        gg = DK._commit(gg, torch.tensor(rng.normal(0.0, 1.0, G), dtype=torch.float32, device=dev),
                        torch.tensor(rng.normal(0.0, 10.0, (G, 1)), dtype=torch.float32,
                                     device=dev))
    kernel, ref = ((DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref) if windowed else
                   (DK.deposit_dense_1d_kernel, DK.deposit_dense_1d_kernel_ref))
    out, ba = kernel(gg, c, h)
    out_ref, ba_ref = ref(gg, c, h)
    torch.cuda.synchronize()
    for a, b, rel in ((out.grid.values, out_ref.grid.values, 1e-4),
                      (out.grid.derivs, out_ref.grid.derivs, 3e-4)):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert float((ba - ba_ref).abs().max()) <= 2e-6
    assert float(((ba - h) / h).abs().max()) <= 1e-3  # conservation
    out2, ba2 = kernel(gg, c, h)
    assert torch.equal(out.grid.values, out2.grid.values)
    assert torch.equal(out.grid.derivs, out2.grid.derivs) and torch.equal(ba, ba2)


@pytest.mark.gpu
def test_windowed_kernel_rejects_wide_windows(cuda_state):
    """Called directly on a grid of the dense route, K4 no longer raises:
    a hill whose reach meets itself around the period is listed on every
    tile, each point taking it once at its minimum image, as its plain
    version (there K5's) computes it."""
    gg = tg.GaussGrid.create([0], [10], [10.0 / 16384], [True], [1.2],
                             device=torch.device("cuda", 0))
    c = torch.tensor([[0.0], [3.3]], device=gg.grid.values.device)
    h = torch.tensor([1.0, 0.5], device=c.device)
    assert DK.wide_reach(gg, 1024)
    _check_deposit(DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref, gg, c, h)


def _check_deposit(kernel, ref, gg, c, h):
    """One deposition through ``kernel`` against ``ref``: one launch, the
    values and derivatives within 1e-4 and 3e-4 of max|.|, bias_added
    within 2e-6, a bitwise repeat."""
    n0 = kernel.launches
    out, ba = kernel(gg, c, h)
    out_ref, ba_ref = ref(gg, c, h)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    for a, b, rel in ((out.grid.values, out_ref.grid.values, 1e-4),
                      (out.grid.derivs, out_ref.grid.derivs, 3e-4)):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert float((ba - ba_ref).abs().max()) <= 2e-6 * max(1.0, float(ba_ref.abs().max()))
    out2, ba2 = kernel(gg, c, h)
    assert torch.equal(out.grid.values, out2.grid.values) and torch.equal(ba, ba2)


@pytest.mark.gpu
@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("G, sigma", [(16384, 1.8), (16384, 4.0), (40000, 3.0), (17000, 1.7)])
def test_deposit_kernel_grid_wide_reach(cuda_state, poisoned_empty, windowed, G, sigma):
    """K4 and K5 with hills whose reach spans the grid (``wide_reach``: the
    support radius sqrt(8) sigma up to more than the whole period), on a
    carried grid, raw centres on and off the grid: against their plain
    versions (K4's there K5's: a point takes each hill once)."""
    dev = torch.device("cuda", 0)
    gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device=dev)
    tile = 1024 if windowed else 512
    assert DK.wide_reach(gg, tile)
    rng = np.random.default_rng(G)
    gg = DK._commit(gg, torch.tensor(rng.normal(0.0, 1.0, G), dtype=torch.float32, device=dev),
                    torch.tensor(rng.normal(0.0, 1.0, (G, 1)), dtype=torch.float32, device=dev))
    c = torch.tensor(np.concatenate([rng.uniform(-10, 20, 37), [0.0, 10.0]])[:, None],
                     dtype=torch.float32, device=dev)
    h = torch.tensor(rng.uniform(0.05, 0.2, 39), dtype=torch.float32, device=dev)
    kernel, ref = ((DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref) if windowed else
                   (DK.deposit_dense_1d_kernel, DK.deposit_dense_1d_kernel_ref))
    _check_deposit(kernel, ref, gg, c, h)


TYPES = np.where(np.arange(600) % 2 == 0, 2, 1).astype(np.int32)  # test_torch_typed.py's


@pytest.fixture(scope="module")
def cuda_ids_types(cuda_state):
    """The same atoms in a state with slot ids and types, at cap 56 (3^3
    cells) and at cap 32 (4^3 cells)."""
    _, spec, st, _, gg = cuda_state
    spec32 = CellSpec.create([6.0] * 3, cutoff=1.5, n_atoms=600, cap=32)
    states = {spec.cap: (spec, init_cell_state(spec, st.core, with_ids=True, types=TYPES)),
              32: (spec32, init_cell_state(spec32, st.core, with_ids=True, types=TYPES))}
    assert not any(bool(s.table_overflow) for _, s in states.values())
    return states, gg


def _table(gg, kind):
    return CF.hermite_pair_table(gg) if kind == "hermite" else fit_gauss_grid(gg, 16, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_planar_kernel(cuda_ids_types, kind, typed, energy):
    """K6: row sums, credits and energy against its plain version."""
    states, gg = cuda_ids_types
    spec, st = states[56]
    tab = _table(gg, kind)
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy,
              ts=st.ts if typed else None, type_pair=(1, 2) if typed else None)
    n0 = CF.cell_force_newton_planar.launches
    f, cred, eb = CF.cell_force_newton_planar(st.xs, st.mc, tab, **kw)
    f_ref, cred_ref, eb_ref = CF.cell_force_newton_planar_ref(st.xs, st.mc, tab, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton_planar.launches == n0 + 1
    assert_forces(f.cpu(), f_ref.cpu(), f"K6 {kind} typed={typed}")
    assert_forces(cred.cpu(), cred_ref.cpu(), f"K6 {kind} credits")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K6 {kind} energy")
    f2, cred2, eb2 = CF.cell_force_newton_planar(st.xs, st.mc, tab, **kw)
    assert torch.equal(f, f2) and torch.equal(cred, cred2) and torch.equal(eb, eb2)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("k", [24, 56])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_typed_kernel(cuda_ids_types, kind, k, energy):
    """K1 with the type mask: against its plain version, repeats bitwise,
    and differs from the untyped kernel."""
    states, gg = cuda_ids_types
    spec, st = states[56]
    tab = _table(gg, kind)
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy)
    f, eb = CF.cell_force_newton(st.xs, st.mc, tab, ts=st.ts, type_pair=(1, 2), **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tab, ts=st.ts, type_pair=(1, 2), **kw)
    torch.cuda.synchronize()
    assert_forces(f.cpu(), f_ref.cpu(), f"typed K1 {kind} k={k}")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"typed K1 {kind} energy")
    f2, eb2 = CF.cell_force_newton(st.xs, st.mc, tab, ts=st.ts, type_pair=(1, 2), **kw)
    assert torch.equal(f, f2) and torch.equal(eb, eb2)
    f0, _ = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
    assert float((f - f0).abs().max()) > 1e-3 * float(f0.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize("cap", [32, 56])
@pytest.mark.parametrize("panels,deg", TABLES)
def test_cell_force_full_kernel(cuda_ids_types, cap, panels, deg):
    """K7 against its plain version (the degree-64 table within twice the
    plain version's own distance from float64, as on the CPU), bitwise
    repeats, and the cap limit."""
    states, gg = cuda_ids_types
    spec, st = states[cap]
    tab = fit_gauss_grid(gg, deg, panels)
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ)
    n0 = CF.cell_force_full.launches
    f, eb = CF.cell_force_full(st.xs, st.mc, st.sid, tab, **kw)
    f_ref, eb_ref = CF.cell_force_full_ref(st.xs, st.mc, st.sid, tab, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_full.launches == n0 + 1
    if deg == 16:
        assert_forces(f.cpu(), f_ref.cpu(), f"K7 cap={cap}")
        assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K7 cap={cap} energy")
    else:
        t64 = dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())
        f64, _ = CF.cell_force_full_ref(st.xs.double(), st.mc.double(), st.sid.double(), t64,
                                        **kw)
        err = float((f - f_ref).abs().max())
        assert err <= max(2e-5 * float(f_ref.abs().max()),
                          2 * float((f_ref.double() - f64).abs().max())), err
    f2, eb2 = CF.cell_force_full(st.xs, st.mc, st.sid, tab, **kw)
    assert torch.equal(f, f2) and torch.equal(eb, eb2)
    # no cap limit: an empty lattice at cap 72 (the pieces form) gives zeros
    big = torch.zeros((st.xs.shape[0], 72, 3), device=st.xs.device)
    m = torch.zeros(big.shape[:2], device=st.xs.device)
    f72, eb72 = CF.cell_force_full(big, m, m, tab, **kw)
    torch.cuda.synchronize()
    assert not bool(f72.any() or eb72.any())


# ------------------------------------------------ the shared row pass (K1, K6, K7)


@pytest.fixture(scope="module")
def row_states(cuda_state):
    """``test_torch_rowpass.slot_state`` in float32 on the card, at cap 64
    and cap 32: {(case, cap): (spec, xs, mc, sid, ts)}."""
    dev = torch.device("cuda", 0)
    out = {}
    for case in CASES:
        for cap, n in ((64, 900), (32, 500)):
            spec, *planes = slot_state(case, cap=cap, n=n, dtype=torch.float32)
            out[case, cap] = (spec, *(t.to(dev).contiguous() for t in planes))
    return out


@pytest.fixture
def poisoned_empty(monkeypatch):
    """``torch.empty`` and ``torch.empty_like`` hand out NaNs: an output
    element that its kernel leaves unwritten shows."""
    real = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, **kw: real(*a, **kw).fill_(float("nan")))
    monkeypatch.setattr(torch, "empty_like",
                        lambda t, **kw: torch.full_like(t, float("nan"), **kw))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


LIVE = {"none": 0, "one": 1, "eight": 8, "all": 128}


@pytest.mark.gpu
@pytest.mark.parametrize("O", [1, 32, 128])
@pytest.mark.parametrize("live", list(LIVE))
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_rows(cuda_state, poisoned_empty, O, live, kind, energy):
    """K2 on poisoned outputs: O tail rows of which none, one, 8 or all are
    live, ``own`` cleared on every third live row, against 1,000 partners
    (8 tiles, the last one ragged), one in eight masked: the plain version's
    forces, credits and energies, zeros at dead rows and masked partners,
    and a bitwise repeat."""
    dev = torch.device("cuda", 0)
    n_live = min(LIVE[live], O)
    xo, xp = (t.to(dev) for t in overflow_case(O, n_live, 1000, seed=O + n_live))
    tab = _table(cuda_state[4], kind)
    kw = dict(box=BOX, lj=LJ, energy=energy)
    out = CF.overflow_force(xo, xp, tab, **kw)
    fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tab, **kw)
    torch.cuda.synchronize()
    fo, fp = out
    assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), f"K2 O={O} live={n_live} fo")
    assert_forces(fp.cpu(), fp_ref.cpu(), f"K2 O={O} live={n_live} fp")
    assert_forces(fo[3].cpu(), fo_ref[3].cpu(), f"K2 O={O} live={n_live} energy rows")
    assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), f"K2 O={O} live={n_live} energy")
    assert not bool(fo[:, xo[3] < 0.5].any() or fp[:, xp[3] < 0.5].any())
    assert bool(fp.any()) == (n_live > 0)
    assert bool(fo[3].any()) == (energy and n_live > 0)
    assert _same(out, CF.overflow_force(xo, xp, tab, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("k", [1, 24, 32, 64])
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [False, True])
def test_row_pass_k1(cuda_state, row_states, poisoned_empty, case, k, kind, typed, energy):
    """K1 on poisoned outputs: the plain version's forces and energy, zeros
    in rows >= k and pad cells, and a bitwise repeat."""
    spec, xs, mc, _, ts = row_states[case, 64]
    tab = _table(cuda_state[4], kind)
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy,
              ts=ts if typed else None, type_pair=(1, 2) if typed else None)
    out = CF.cell_force_newton(xs, mc, tab, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(xs, mc, tab, **kw)
    torch.cuda.synchronize()
    f, eb = out
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 {case} k={k}")
    assert_forces(eb.cpu(), eb_ref.cpu(), f"K1 {case} k={k} eb rows")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 {case} k={k} energy")
    assert not bool(f[:, k:].any() or f[spec.n_cells:].any() or eb[spec.n_cells:].any())
    assert not bool(f[mc < 0.5].any())
    assert energy == bool(eb.abs().sum() > 0) or k == 1
    assert _same(out, CF.cell_force_newton(xs, mc, tab, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cap", [32, 64])
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("energy", [False, True])
def test_row_pass_k6(cuda_state, row_states, poisoned_empty, case, cap, kind, typed, energy):
    """K6 on poisoned outputs: rows, credits and energy of the plain
    version; credits zero at the neighbours' empty slots and in pad cells."""
    spec, xs, mc, _, ts = row_states[case, cap]
    C = spec.n_cells
    tab = _table(cuda_state[4], kind)
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ, energy=energy,
              ts=ts if typed else None, type_pair=(1, 2) if typed else None)
    out = CF.cell_force_newton_planar(xs, mc, tab, **kw)
    f_ref, cred_ref, eb_ref = CF.cell_force_newton_planar_ref(xs, mc, tab, **kw)
    torch.cuda.synchronize()
    f, cred, eb = out
    assert_forces(f.cpu(), f_ref.cpu(), f"K6 {case} rows")
    assert_forces(cred.cpu(), cred_ref.cpu(), f"K6 {case} credits")
    assert_forces(eb.cpu(), eb_ref.cpu(), f"K6 {case} eb rows")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K6 {case} energy")
    nbr = CF.half_neighbors(tuple(spec.ncells), xs.device)
    assert not bool(cred[C:].any() or cred[:C][mc[nbr] < 0.5].any())
    assert not bool(f[C:].any() or eb[C:].any() or f[mc < 0.5].any())
    assert _same(out, CF.cell_force_newton_planar(xs, mc, tab, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("cap", [32, 64])
@pytest.mark.parametrize("panels,deg", TABLES)
def test_row_pass_k7(cuda_state, row_states, poisoned_empty, case, cap, panels, deg):
    """K7 through the half-stencil row pass on poisoned outputs: the
    27-stencil plain version's forces and per-row energies (the degree-64
    table within ``f32_error_bound``), zeros at empty slots and pad cells."""
    spec, xs, mc, sid, _ = row_states[case, cap]
    C = spec.n_cells
    tab = fit_gauss_grid(cuda_state[4], deg, panels)
    kw = dict(ncells=spec.ncells, box=spec.box, lj=LJ)
    out = CF.cell_force_full(xs, mc, sid, tab, **kw)
    f_ref, eb_ref = CF.cell_force_full_ref(xs, mc, sid, tab, **kw)
    torch.cuda.synchronize()
    f, eb = out
    t64 = dataclasses.replace(tab, cval=tab.cval.double(), cder=tab.cder.double())
    f64, eb64 = CF.cell_force_full_ref(xs.double(), mc.double(), sid.double(), t64, **kw)
    for a, ref, exact, rel in ((f, f_ref, f64, 2e-5), (eb, eb_ref, eb64, 2e-5),
                               (eb.sum(), eb_ref.sum(), eb64.sum(), 1e-5)):
        err = float((a - ref).abs().max())
        assert err <= f32_error_bound(ref, exact, rel), (case, cap, err)
    assert float(eb.abs().sum()) > 0
    assert not bool(f[C:].any() or eb[C:].any() or f[mc < 0.5].any() or eb[mc < 0.5].any())
    assert _same(out, CF.cell_force_full(xs, mc, sid, tab, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 31, 257, 10000, 20001, 10**6, 10**6 + 3])
@pytest.mark.parametrize("wide", [False, True])
def test_threefry_kernel(cuda_state, n, wide):
    """The draw kernel ``tf_bits`` against its plain versions (``ops/prng``'s
    numpy chain and the PyTorch ops on the CPU), for ragged n and n = 1, a
    thread an element and 16-byte stores (from ``prng.DRAW_VEC_MIN``): the
    bits bitwise (so every word was written), the uniforms bitwise, the
    normals within ``chip_smoke.TF_NORMAL_ULPS`` (CUDA's erfinv against
    PyTorch's CPU one), in float32 and float64; one launch a draw."""
    from chip_smoke import TF_NORMAL_ULPS
    from edm_tpu_torch.ops import prng

    dev = torch.device("cuda", 0)
    for seed in (0, 123456789, 2**33 + 5):
        key = prng.PRNGKey(seed)
        n0 = prng.threefry_bits.launches
        out = prng.threefry_bits(key, n, dev, wide=wide)
        torch.cuda.synchronize()
        assert prng.threefry_bits.launches == n0 + 1
        assert torch.equal(out.cpu(), prng._bits_ref(key, n, wide))
    for dtype in (torch.float32, torch.float64):
        n0 = prng.threefry_bits.launches
        u = prng.uniform(key, (n,), dtype, dev)
        z = prng.normal(key, (n,), dtype, dev)
        torch.cuda.synchronize()
        assert prng.threefry_bits.launches == n0 + 2
        assert u.dtype == z.dtype == dtype and u.shape == z.shape == (n,)
        assert torch.equal(u.cpu(), prng.uniform(key, (n,), dtype, "cpu"))
        assert _ulps(z, prng.normal(key, (n,), dtype, "cpu")).max() <= TF_NORMAL_ULPS[str(dtype)]


def _dense_grid(G, m, dev):
    """A periodic [0, 10] grid of G points whose window half-width is m
    points (W = 2 m + 1): sigma puts 4 sigma' / dx mid-way between m and
    m + 1."""
    dx = 10.0 / G
    sigma = (m + 0.5) * dx / 4 / np.sqrt(2.0)
    gg = tg.GaussGrid.create([0], [10], [dx], [True], [sigma], device=dev)
    assert gg.spec.minisize[0] == m
    return gg


@pytest.mark.gpu
@pytest.mark.parametrize("G", [16384, 32768, 65536])
@pytest.mark.parametrize("H", [1, 31, 200, 1000])
def test_dense_kernel_chunks(cuda_state, poisoned_empty, G, H):
    """K5's (tile, chunk) layout: 1, 31 (one short chunk), 200 and 1,000
    hills (many chunks) on carried grids of the dense route, outputs over
    poisoned memory, against the plain version; bitwise repeats."""
    dev = torch.device("cuda", 0)
    gg = _dense_grid(G, int(0.3 * G), dev)
    W = gg.spec.window_shape[0]
    assert W + 256 >= G // 2 and W < G
    rng = np.random.default_rng(G + H)
    gg = DK._commit(gg, torch.tensor(rng.normal(0.0, 1.0, G), dtype=torch.float32, device=dev),
                    torch.tensor(rng.normal(0.0, 10.0, (G, 1)), dtype=torch.float32, device=dev))
    c = torch.tensor(rng.uniform(-5, 15, (H, 1)), dtype=torch.float32, device=dev)
    h = torch.tensor(rng.uniform(0.05, 0.2, H), dtype=torch.float32, device=dev)
    out, ba = DK.deposit_dense_1d_kernel(gg, c, h)
    out_ref, ba_ref = DK.deposit_dense_1d_kernel_ref(gg, c, h)
    torch.cuda.synchronize()
    for a, b, rel in ((out.grid.values, out_ref.grid.values, 1e-4),
                      (out.grid.derivs, out_ref.grid.derivs, 3e-4)):
        assert float((a - b).abs().max()) <= rel * float(b.abs().max())
    assert float((ba - ba_ref).abs().max()) <= 2e-6
    out2, ba2 = DK.deposit_dense_1d_kernel(gg, c, h)
    assert torch.equal(out.grid.values, out2.grid.values)
    assert torch.equal(out.grid.derivs, out2.grid.derivs) and torch.equal(ba, ba2)


@pytest.mark.gpu
@pytest.mark.parametrize("wide", [False, True])
def test_route_boundary(cuda_state, wide):
    """At W + 256 = G / 2 ``deposit`` takes K5, one window point narrower
    (W + 256 = G / 2 - 2) K4; both against their plain versions."""
    from edm_tpu_torch.ops.deposit import deposit

    dev = torch.device("cuda", 0)
    G = 16386  # G // 2 odd, as the odd W + 256 needs
    m = (G // 2 - 257) // 2 - (0 if wide else 1)
    gg = _dense_grid(G, m, dev)
    W = gg.spec.window_shape[0]
    assert (W + 256 == G // 2) == wide and (W + 256 < G // 2) != wide
    rng = np.random.default_rng(3)
    c = torch.tensor(rng.uniform(0, 10, (64, 1)), dtype=torch.float32, device=dev)
    h = torch.tensor(rng.uniform(0.05, 0.2, 64), dtype=torch.float32, device=dev)
    kernel, ref = ((DK.deposit_dense_1d_kernel, DK.deposit_dense_1d_kernel_ref) if wide else
                   (DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref))
    n0 = kernel.launches
    out, ba = deposit(gg, c, h)
    out_ref, ba_ref = ref(gg, c, h)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    assert float((out.grid.values - out_ref.grid.values).abs().max()) <= \
        1e-4 * float(out_ref.grid.values.abs().max())
    assert float((ba - ba_ref).abs().max()) <= 2e-6


@pytest.mark.gpu
def test_coord_step_card_vs_cpu(cuda_state):
    """The 2-D coordinate host at the CPU parity test's size (512 particles,
    a periodic 64 x 64 grid, hill_stride 2, compaction to 64 rows, the
    cached corner table), 20 steps at kT = 0 on the card, each also taken
    on the CPU from the same input state: integer leaves exactly, positions,
    velocities and forces within 4 float32 ulps of their max, the grid and
    its table within 1e-5 of max|.|, cum_bias 1e-5 relative."""
    from edm_tpu_torch.models import coord_edm
    from edm_tpu_torch.ops import prng

    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\nglobal_tempering -1\nhill_prefactor 1.0\n"
        "bias_per_step 0.5\nhill_density 40\ndimension 2\nbox_low 0 0\nbox_high 10 10\n"
        "bias_spacing 0.15625 0.15625\nbias_sigma 0.3 0.3\n")
    rng = np.random.default_rng(21)
    x0, v0 = rng.uniform(0, 10, (512, 2)), rng.normal(size=(512, 2))
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.0)
    hosts = {}
    for name in ("cuda", "cpu"):
        params, bs = B.subdivide(cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10],
                                 [True, True], [0, 0], dtype=torch.float32, device=name)
        steps = [coord_edm.make_step(params, lp, 2, hill_capacity=64, static_do_hills=h)
                 for h in (True, False)]
        st = coord_edm.init_state(params, bs, torch.tensor(x0, dtype=torch.float32, device=name),
                                  prng.PRNGKey(0), lp, cache_lookup_table=True)
        hosts[name] = (dataclasses.replace(st, v=torch.tensor(v0, dtype=torch.float32,
                                                              device=name)), steps)
    st, steps = hosts["cuda"]
    steps_cpu = hosts["cpu"][1]

    def to_cpu(obj):
        if isinstance(obj, torch.Tensor):
            return obj.cpu()
        if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
            return dataclasses.replace(obj, **{f.name: to_cpu(getattr(obj, f.name))
                                               for f in dataclasses.fields(obj)})
        return obj

    for i in range(20):
        ref, e_ref = steps_cpu[i % 2](to_cpu(st))
        st, e = steps[i % 2](st)
        np.testing.assert_array_equal(st.key, ref.key)
        for a, b in ((st.step, ref.step), (st.hills_truncated, ref.hills_truncated),
                     (st.bias.buf_right, ref.bias.buf_right), (st.bias.steps, ref.bias.steps),
                     (st.bias.cv_hist.values, ref.bias.cv_hist.values)):
            assert torch.equal(a.cpu(), b), i
        for a, b in ((st.x, ref.x), (st.v, ref.v), (st.f, ref.f)):
            scale = max(1.0, float(b.abs().max()))
            assert float((a.cpu() - b).abs().max()) <= 4 * np.spacing(np.float32(scale)), i
        for a, b in ((st.bias.bias.grid.values, ref.bias.bias.grid.values),
                     (st.bias.bias.grid.derivs, ref.bias.bias.grid.derivs), (st.ptab, ref.ptab)):
            assert float((a.cpu() - b).abs().max()) <= 1e-5 * max(1.0, float(b.abs().max())), i
        assert abs(float(st.bias.cum_bias) - float(ref.bias.cum_bias)) <= \
            1e-5 * max(1.0, float(ref.bias.cum_bias))
        assert abs(float(e) - float(e_ref)) <= 1e-5 * max(1.0, abs(float(e_ref)))
    assert float(st.bias.cum_bias) > 0


@pytest.mark.gpu
def test_windowed_scatter_card_vs_cpu(cuda_state):
    """The N-D windowed scatter (``hill_windows`` + ``deposit_precomputed``)
    on a non-periodic 2-D grid with McGovern-De Pablo terms: the card's
    ``index_put_(accumulate=True)`` adds in no fixed order, so values and
    derivatives are held to the CPU's within 1e-5 of max|.| and bias_added
    within 1e-6 relative; a histogram's integer-valued counts are exact."""
    from edm_tpu_torch.grid import Grid, GridSpec
    from edm_tpu_torch.ops import deposit as D

    rng = np.random.default_rng(31)
    c = rng.uniform(-0.2, 3.2, (150, 2))
    h = rng.uniform(0.05, 0.2, 150)
    out = {}
    for dev in ("cuda", "cpu"):
        gg = tg.GaussGrid.create([0.0, -1.0], [3.0, 2.0], [0.037, 0.041], [False, False],
                                 [0.21, 0.17], boundary_min=[0.4, -0.6],
                                 boundary_max=[2.6, 1.6], device=dev)
        ct = torch.tensor(c, dtype=torch.float32, device=dev)
        ht = torch.tensor(h, dtype=torch.float32, device=dev)
        o, ba = D.deposit_precomputed(gg, D.hill_windows(gg, ct), ht)
        hist = Grid.zeros(GridSpec.create([0.0, -1.0], [3.0, 2.0], [0.1, 0.1], [False, False]),
                          device=dev)
        hist, _ = hist.add_value(ct, 1.0)
        out[dev] = [t.cpu() for t in (o.grid.values, o.grid.derivs, ba, hist.values)]
    (v, d, ba, hist), (v0, d0, ba0, hist0) = out["cuda"], out["cpu"]
    for a, b in ((v, v0), (d, d0)):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    assert float(((ba - ba0) / ba0.abs().clamp(min=1e-30)).abs().max()) <= 1e-6
    assert torch.equal(hist, hist0) and float(hist.sum()) > 0


def _near_card(a, b, rel=1e-5):
    """Card against CPU in float32: within ``rel`` of max(1, max|.|)."""
    a, b = a.cpu().double(), b.cpu().double()
    return float((a - b).abs().max()) <= rel * max(1.0, float(b.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("branch", ["compacted", "dense"])
def test_mcgdp_deposit_card_vs_cpu(cuda_state, monkeypatch, branch):
    """The McGovern-De Pablo tables and deposit on a non-periodic 201 x 201
    grid with 512 hills (some outside the box, some on the strips), on the
    card against the CPU: the strip passes' compacted branch (the near-wall
    hills fit the capacity of 256) and the dense one (capacity 16, so
    max(16, 512 // 8) = 64 < the near-wall count).  The tables, s and the
    grid within 1e-5 of max|.|; one strip-count read on each device."""
    from edm_tpu_torch.ops import deposit as D

    rng = np.random.default_rng(41)
    H = 512
    c = rng.uniform(-0.1, 4.1, (H, 2))
    h = rng.uniform(0.0, 0.01, H)
    h[::13] = 0.0
    reach = (2.0 + np.sqrt(8.0)) * 0.05 * np.sqrt(2.0) + 0.02
    near = [int((((np.abs(c[:, d]) < reach) | (np.abs(c[:, d] - 4.0) < reach)) & (h != 0)).sum())
            for d in range(2)]
    assert 64 < min(near) and max(near) <= 256, near
    if branch == "dense":
        monkeypatch.setattr(D, "_STRIP_COMPACT_CAP", 16)
    out = {}
    for dev in ("cuda", "cpu"):
        gg = tg.GaussGrid.create([0.0, 0.0], [4.0, 4.0], [0.02, 0.02], [False, False],
                                 [0.05, 0.05], device=dev)
        tabs = D.dense_tables_mcgdp(gg, torch.tensor(c, dtype=torch.float32, device=dev))
        o, reads = D.deposit_from_mcgdp(gg, tabs, torch.tensor(h, dtype=torch.float32, device=dev))
        assert reads == 1
        out[dev] = [t.cpu() for t in (tabs.s, *tabs.sep_value, o.grid.values, o.grid.derivs)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert _near_card(a, b)
    assert float(out["cpu"][-2].abs().max()) > 0


@pytest.mark.gpu
def test_mcgdp_round_two_passes_card_vs_cpu(cuda_state):
    """One well-tempered McGDP engine round in two passes (the first pass
    over bias_per_step, so hills defer), on the card against the CPU:
    integer and bool records and state exactly, floats within 1e-5 of
    max(1, max|.|)."""
    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\nglobal_tempering -1\nhill_prefactor 0.6\n"
        "bias_per_step 0.5\nhill_density 40\ndimension 2\nbox_low 0 0\nbox_high 4 3\n"
        "bias_spacing 0.05 0.06\nbias_sigma 0.2 0.15\n")
    rng = np.random.default_rng(43)
    H = 64
    pos = rng.uniform(-0.1, 4.1, (H, 2)) * [1.0, 0.75]
    run = rng.uniform(0, 1, H)
    out = {}
    for dev in ("cuda", "cpu"):
        params, bs = B.subdivide(cfg, 1.0, 1.0, [0, 0], [4, 3], [0, 0], [4, 3], [False, False],
                                 [0, 0], dtype=torch.float32, device=dev)
        bs, rec, reads = B.add_hills_round(
            params, bs, torch.tensor(pos, dtype=torch.float32, device=dev),
            torch.tensor(run, dtype=torch.float32, device=dev), 100.0, n_passes=2)
        out[dev] = (bs, rec, reads)
    (bs, rec, reads), (bs0, rec0, reads0) = out["cuda"], out["cpu"]
    assert reads == reads0 and bool(rec0.hill_called[H // 2:].any())
    assert float(rec0.hill_defer_h.sum()) > 0
    for name in rec._fields:
        a, b = getattr(rec, name), getattr(rec0, name)
        if b.dtype.is_floating_point:
            assert _near_card(a, b), name
        else:
            assert torch.equal(a.cpu(), b), name
    for a, b in ((bs.buf_right, bs0.buf_right), (bs.steps, bs0.steps),
                 (bs.overflow_error, bs0.overflow_error), (bs.cv_hist.values, bs0.cv_hist.values)):
        assert torch.equal(a.cpu(), b)
    for a, b in ((bs.bias.grid.values, bs0.bias.grid.values),
                 (bs.bias.grid.derivs, bs0.bias.grid.derivs), (bs.buf_h, bs0.buf_h),
                 (bs.buf_pos, bs0.buf_pos), (bs.cum_bias, bs0.cum_bias)):
        assert _near_card(a, b)


# ------------------------------------------- the user's entry points on the card


def _tree_cpu(obj):
    """A state's tensors on the CPU (dataclasses and tuples rebuilt)."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: _tree_cpu(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        vals = [_tree_cpu(v) for v in obj]
        return type(obj)(*vals) if hasattr(obj, "_fields") else type(obj)(vals)
    return obj


def _assert_states_close(card, cpu, rel, what):
    """Every leaf of a card state against a CPU state: float leaves within
    ``rel`` of max(1, max|.|), the others exactly."""
    from _torch_parity import assert_tree

    assert_tree(_tree_cpu(card), cpu, rel, what)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["1d", "2d"])
def test_api_card_vs_cpu(cuda_state, tmp_path, case):
    """``EDMBias(device="cuda")`` against ``device="cpu"`` in float64 over
    the same capped, masked rounds: the state within 1e-10 of max|.|
    (deposits add in another order on the card), integer leaves exactly,
    forces and the HILLS files' step, type and counter columns equal."""
    from edm_tpu_torch.api import EDMBias

    text = {"1d": "tempering 1\nbias_factor 8\nhill_prefactor 0.8\nbias_per_step 1.2\n"
                  "hill_density 6\ndimension 1\nbox_low 0\nbox_high 10\n"
                  "bias_spacing 0.0097\nbias_sigma 0.25\n",
            "2d": "tempering 0\nhill_prefactor 0.5\nbias_per_step 0.3\nhill_density -1\n"
                  "dimension 2\nbox_low 0 0\nbox_high 4 4\nbias_spacing 0.09 0.11\n"
                  "bias_sigma 0.3 0.25\n"}[case]
    bs = {}
    for dev in ("cuda", "cpu"):
        (tmp_path / f"{dev}.edm").write_text(text + f"hills_filename {tmp_path}/{dev}_H\n")
        b = EDMBias(str(tmp_path / f"{dev}.edm"), 1.0, 1.0, device=dev)
        b.set_box([0.0] * b.dim, [10.0 if b.dim == 1 else 4.0] * b.dim, [case == "2d"] * b.dim)
        b.set_mask(np.arange(40) % 3)
        bs[dev] = b
    rng = np.random.default_rng(3)
    D = bs["cpu"].dim
    for r in range(5):
        pos = rng.uniform(0, 10.0 if D == 1 else 4.0, (40, D))
        uni = rng.uniform(0, 1, 40)
        for b in bs.values():
            b.add_hills(pos, uni, apply_mask=1 if r % 2 else None)
        _assert_states_close(bs["cuda"].state, bs["cpu"].state, 1e-10, f"round {r}")
    assert bs["cuda"].state.bias.grid.values.is_cuda and bs["cpu"].cum_bias > 0
    q = rng.uniform(0, 4.0, (40, D + 1))
    fc, fp = np.zeros((40, D + 1)), np.zeros((40, D + 1))
    ec, ep = (bs[d].update_forces(q, f, apply_mask=2) for d, f in (("cuda", fc), ("cpu", fp)))
    assert abs(ec - ep) <= 1e-10 * max(1.0, abs(ep))
    np.testing.assert_allclose(fc, fp, rtol=0, atol=1e-10 * max(1.0, np.abs(fp).max()))
    for b in bs.values():
        b.hills_log.close()
    lines = {d: (tmp_path / f"{d}_H_0").read_text().splitlines() for d in bs}
    assert [ln.split()[:3] for ln in lines["cuda"]] == [ln.split()[:3] for ln in lines["cpu"]]


def _small_cell(dev):
    """The 600-atom clustered fluid of ``test_torch_slice.py`` at kT = 0 with
    kernel_cap (its first rebuild period at full cap): the dynamic cell
    step with records and a fresh state, on ``dev``."""
    from _torch_parity import clustered_points

    cfg = parse_edm_text("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
                         "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\n"
                         "bias_spacing 0.02\nbias_sigma 0.1\n")
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float32, device=dev)
    core = pair_edm.init_state(bs, torch.tensor(clustered_points(600), device=dev),
                               PRNGKey(0), n_est=600 * 300)
    # a drift along y takes the crowd across a cell face: the step-9
    # rebuild leaves the full-cap period and the next one runs K2
    core = dataclasses.replace(core, v=torch.zeros_like(core.x).index_fill_(
        1, torch.tensor([1], device=dev), 5.0))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=600, cap=56)
    st = init_cell_state(spec, core, kernel_cap=KCAP, overflow_cap=48)
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0), LJ, spec, 10,
                          rebuild_stride=10, hill_capacity=512, energy_stride=10,
                          use_pallas=True, kernel_cap=KCAP, overflow_cap=48,
                          collect_records=True)
    return params, step, st


def _small_cell_run(dev, tmp_path, n_steps=20):
    """``run_simulation`` of ``_small_cell`` with every output, a write every
    10 steps; returns (state, energies, HILLS lines)."""
    from edm_tpu_torch.models.driver import run_simulation
    from edm_tpu_torch.utils.hills_log import HillsLog

    params, step, st = _small_cell(dev)
    log = HillsLog(str(tmp_path / f"{dev}_HILLS"), 1, params.total_volume)
    st, e = run_simulation(step, st, n_steps, 10, bias_file=str(tmp_path / f"{dev}_B"),
                           histogram_file=str(tmp_path / f"{dev}_H"),
                           lammps_table=str(tmp_path / f"{dev}.ltab"), box_low=[0.0],
                           box_high=[3.0], hills_log=log)
    log.close()
    return st, e, (tmp_path / f"{dev}_HILLS").read_text().splitlines()


@pytest.mark.gpu
def test_run_simulation_card_vs_cpu(cuda_state, tmp_path):
    """``run_simulation`` on a small cell host (the dynamic step with
    records, every output) on the card and on the CPU: the same hill
    rounds logged line for line (step, type, counter exactly, numbers
    within 1e-5), the slot arrays within 2e-5 * max(1, max|f|), integer
    leaves exactly; K1 and K2 launched on the card."""
    n1, n2 = CF.cell_force_newton.launches, CF.overflow_force.launches
    card, e_card, h_card = _small_cell_run("cuda", tmp_path)
    assert CF.cell_force_newton.launches > n1 and CF.overflow_force.launches > n2
    cpu, e_cpu, h_cpu = _small_cell_run("cpu", tmp_path)
    for f in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    assert card.tail_ovf_host == cpu.tail_ovf_host
    for f in ("xs", "vs", "fs"):
        assert_forces(getattr(card, f).cpu(), getattr(cpu, f), f)
    assert_energy(e_card[-1].cpu(), e_cpu[-1], "energy")
    assert len(h_card) == len(h_cpu) > 0
    assert [ln.split()[:3] for ln in h_card] == [ln.split()[:3] for ln in h_cpu]
    a = np.array([[float(v) for v in ln.split()[3:]] for ln in h_card])
    b = np.array([[float(v) for v in ln.split()[3:]] for ln in h_cpu])
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * max(1.0, np.abs(b).max()))


@pytest.mark.gpu
def test_checkpoint_resume_on_card(cuda_state, tmp_path):
    """10 steps, ``save_state``, ``load_state`` into a freshly built card
    template, 10 more: bitwise the 20 uninterrupted steps on the card."""
    from _torch_parity import assert_tree
    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.utils.checkpoint import load_state, save_state

    _, step, st = _small_cell(torch.device("cuda", 0))
    seg = pattern_segment([(step, 1)], 10)
    mid = seg(st)[0]
    full = seg(mid)[0]
    save_state(mid, str(tmp_path / "c.npz"))
    _, step2, fresh = _small_cell(torch.device("cuda", 0))
    resumed = load_state(fresh, str(tmp_path / "c.npz"))
    assert resumed.xs.is_cuda and resumed.tail_ovf_host == mid.tail_ovf_host
    cont = pattern_segment([(step2, 1)], 10)(resumed)[0]
    assert_tree(_tree_cpu(cont), _tree_cpu(full), 0.0, "resumed vs uninterrupted")


# ------------------------------------------- the dense and blocked pair hosts


THREEFRY_ROWS = [(R, n) for R in (1, 3, 500, 2048) for n in (1, 3, 5, 448, 864, 10000, 10001)]
THREEFRY_ROWS += [(70000, n) for n in (1, 3, 5)]


def _threefry_rows_check(R, n, dev):
    """``threefry_rows`` bitwise its plain version on R unsorted row ids of
    n columns (ids above 2^31 and repeats, as pass 2's clamped padding
    rows), float32 and float64, int64 ids and (below 2^31) int32; one
    launch a call."""
    from edm_tpu_torch.ops import prng

    rng = np.random.default_rng(R + n)
    rows = rng.integers(0, 2**32, R)
    rows[-(R // 4):] = rows[0]
    key = prng.fold_in(prng.PRNGKey(5), 3)
    for ids in (rows, rows % 2**31):
        for dtype in (torch.float32, torch.float64):
            ref = prng._rows_ref(key, ids, n, dtype)
            for id_dt in (torch.int64, torch.int32)[:1 if ids is rows else 2]:
                n0 = prng.threefry_rows.launches
                out = prng.threefry_rows(key, torch.as_tensor(ids, device=dev).to(id_dt), n, dtype)
                torch.cuda.synchronize()
                assert prng.threefry_rows.launches == n0 + 1
                assert out.dtype == dtype and out.shape == (R, n)
                assert torch.equal(out.cpu(), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("R,n", THREEFRY_ROWS)
def test_threefry_rows_kernel(cuda_state, R, n):
    """``threefry_rows`` against its plain version (the numpy chain),
    bitwise, at the blocked host's widths (n = 10,000; 500 rows of pass 1,
    2048 of pass 2), the work-sharded host's (448, 864), ragged and short
    rows and 70,000 rows (``_threefry_rows_check``)."""
    _threefry_rows_check(R, n, torch.device("cuda", 0))


@pytest.mark.gpu
@pytest.mark.parametrize("R,n", [(500, 5), (700, 10001), (300, 1)])
def test_threefry_rows_kernel_strided(cuda_state, monkeypatch, R, n):
    """The same with the grid's y extent cut to 3 row tiles, so that the
    kernel strides over its row tiles."""
    from edm_tpu_torch.ops import prng

    monkeypatch.setattr(prng, "ROWS_MAX_TILES", 3)
    assert prng.rows_plan(R, n, False).grid[1] == 3
    _threefry_rows_check(R, n, torch.device("cuda", 0))


def _pair_host(dev, blocked, kT=0.0):
    """test_torch_dense's jittered 64-atom lattice in float32 on ``dev``
    with the static hill step of the dense or the blocked host (block 16)
    and hill records."""
    from edm_tpu_torch.models import pair_edm_blocked

    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
                         "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                         "bias_sigma 0.1\n")
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                             dtype=torch.float32, device=dev)
    rng = np.random.default_rng(3)
    a = 1.26
    pts = (np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"), -1).reshape(-1, 3) * a
           + 0.5 * a + rng.uniform(-0.08, 0.08, (64, 3)))
    st = pair_edm.init_state(bs, torch.tensor(pts, dtype=torch.float32, device=dev),
                             PRNGKey(0))
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    kw = dict(hill_stride=5, hill_capacity=2048, static_do_hills=True, collect_records=True)
    if blocked:
        step = pair_edm_blocked.make_step_blocked(params, lp, LJParams(), [4 * a] * 3,
                                                  block_size=16, **kw)
    else:
        step = pair_edm.make_step(params, lp, LJParams(), [4 * a] * 3, **kw)
    return st, step


@pytest.mark.gpu
@pytest.mark.parametrize("blocked", [False, True])
def test_pair_hill_round_card_vs_cpu(cuda_state, blocked):
    """One hill step of the dense (N^2 uniforms through ``threefry_bits``)
    or the blocked host (per-row streams through ``threefry_rows``) on the
    card and on the CPU from the same state: the same hill list (bitwise
    draws; distances within 1e-6 relative), counts and flags equal, the
    grid within 1e-5 of max|.|, forces within 2e-5 * max(1, max|f|)."""
    from edm_tpu_torch.ops import prng

    st_c, step_c = _pair_host(torch.device("cuda", 0), blocked)
    st_h, step_h = _pair_host("cpu", blocked)
    counter = prng.threefry_rows if blocked else prng.threefry_bits
    n0 = counter.launches
    card, (e_c, log_c) = step_c(st_c)
    torch.cuda.synchronize()
    assert counter.launches > n0
    cpu, (e_h, log_h) = step_h(st_h)
    for a, b in ((card.last_calls, cpu.last_calls), (card.hills_truncated, cpu.hills_truncated),
                 (card.bias.steps, cpu.bias.steps), (card.bias.buf_right, cpu.bias.buf_right),
                 (log_c.rec.hill_called, log_h.rec.hill_called)):
        assert torch.equal(a.cpu(), b)
    np.testing.assert_allclose(log_c.positions.cpu().numpy(), log_h.positions.numpy(),
                               rtol=1e-6)
    np.testing.assert_array_equal(card.key, cpu.key)
    assert int(log_h.rec.hill_called.sum()) > 0
    g_c, g_h = card.bias.bias.grid.values.cpu(), cpu.bias.bias.grid.values
    assert float((g_c - g_h).abs().max()) <= 1e-5 * max(1.0, float(g_h.abs().max()))
    assert_forces(card.f.cpu(), cpu.f, "forces")
    assert_energy(e_c.cpu(), e_h, "energy")


# ------------------------------------------------ the multi-device layer


@pytest.fixture(scope="module")
def cuda_slab(cuda_state):
    """bench_pairwise's 10,000-atom lattice (a = 1.26, jittered) on its 9^3
    cells of cap 32, with the bias of ``cuda_state`` (hills deposited) as
    the Hermite table."""
    _, _, _, tbl, gg = cuda_state
    dev = torch.device("cuda", 0)
    pts = (np.stack(np.meshgrid(*[np.arange(22)] * 3, indexing="ij"), -1).reshape(-1, 3)[:10000]
           * 1.26 + 0.63 + np.random.default_rng(9).uniform(-0.1, 0.1, (10000, 3)))
    box = [22 * 1.26] * 3
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    _, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                        dtype=torch.float32, device=dev)
    core = pair_edm.init_state(bs, torch.tensor(pts % box[0], dtype=torch.float32, device=dev),
                               PRNGKey(0))
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=10000)
    assert spec.ncells == (9, 9, 9) and spec.cap == 32
    return spec, init_cell_state(spec, core), CF.hermite_pair_table(gg)


def _slab_window(spec, xs, mc, n, rank):
    """Rank ``rank`` of ``n``'s window as the slab host builds it: its
    columns and a halo column a side, the full-window row mask (halo and
    surplus columns out), the candidate mask and the row box."""
    nx, ny, nz = spec.ncells
    q, rem = divmod(nx, n)
    x0, wd = rank * q + min(rank, rem), q + (rank < rem)
    nxd = -(-nx // n)
    w = nxd + 2
    cols = (x0 - 1 + torch.arange(w, device=xs.device)) % nx
    C = nx * ny * nz

    def win(a):
        return a[:C].reshape((nx, ny * nz) + a.shape[1:])[cols].reshape((-1,) + a.shape[1:])

    sub, subm = win(xs), win(mc)
    jj = torch.arange(w, device=xs.device)
    rows = subm.view(w, ny * nz, -1) * ((jj >= 1) & (jj <= wd)).to(subm.dtype)[:, None, None]
    return sub, rows.reshape(subm.shape), subm, (w, ny, nz), ((1, 0, 0), (nxd, ny, nz))


@pytest.mark.gpu
@pytest.mark.parametrize("n,rank", [(2, 0), (2, 1), (3, 2), (4, 0), (4, 3)])
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_row_box_kernel(cuda_slab, n, rank, k, energy):
    """K1's owned-row form on the slab windows of the 10k lattice: 2 ranks
    take 7 x 9 x 9 windows with 405 rows (rank 1 owns 4 of its 5 columns),
    3 and 4 ranks 5 x 9 x 9 windows with 243 (4 ranks: rank 0 owns 3
    columns, rank 3 2 of 3)."""
    spec, st, tbl = cuda_slab
    sub, rows_full, subm, ncells, rb = _slab_window(spec, st.xs, st.mc, n, rank)
    cells = CF.box_cells(ncells, rb, sub.device)
    mrows = rows_full[cells].contiguous()
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    kw = dict(k=k, ncells=ncells, box=spec.box, lj=lj, energy=energy, mc_cand=subm)
    box = dict(row_box=rb)
    n0 = CF.cell_force_newton.row_box_launches
    f, eb = CF.cell_force_newton(sub, mrows, tbl, **kw, **box)
    f_ref, eb_ref = CF.cell_force_newton_ref(sub, mrows, tbl, **kw, **box)
    f_full, eb_full = CF.cell_force_newton(sub, rows_full, tbl, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.row_box_launches == n0 + 1
    assert eb.shape == (cells.numel(), k) and float(f.abs().max()) > 0
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 row_box {n} ranks, rank {rank}, k={k}")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), "K1 row_box energy")
    # bitwise the full-window pass with the rows outside the box masked
    assert torch.equal(f, f_full)
    assert torch.equal(eb, eb_full[cells])
    f2, _ = CF.cell_force_newton(sub, mrows, tbl, **kw, **box)
    assert torch.equal(f, f2)


@pytest.mark.gpu
@pytest.mark.parametrize("grid,box", [((2, 2), ((1, 1, 0), (5, 5, 9))),
                                      ((2, 2, 2), ((1, 1, 1), (5, 5, 5)))], ids=["2x2", "2x2x2"])
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_brick_box_kernel(cuda_slab, grid, box, k, energy):
    """K1's owned-row form over every rank's brick box of the 10k lattice
    (9 cells a side as 5 + 4): 7 x 7 x 9 windows on 2 x 2 ranks, 7^3 on 2 x
    2 x 2, built as the brick host builds them; against the plain version
    and bitwise the full-window kernel with the rows outside the box masked."""
    from edm_tpu_torch.models.pair_edm_cells import shard_window

    spec, st, tbl = cuda_slab
    g3 = tuple(grid) + (1,) * (3 - len(grid))
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    for rank in range(int(np.prod(grid))):
        coord = tuple(int(c) for c in np.unravel_index(rank, g3))
        sub, rows_full, subm, _, ncells, rb = shard_window(spec.ncells, g3, coord, st.xs, st.mc)
        assert rb == box
        cells = CF.box_cells(ncells, rb, sub.device)
        mrows = rows_full[cells].contiguous()
        kw = dict(k=k, ncells=ncells, box=spec.box, lj=lj, energy=energy, mc_cand=subm)
        n0 = CF.cell_force_newton.row_box_launches
        f, eb = CF.cell_force_newton(sub, mrows, tbl, row_box=rb, **kw)
        f_ref, eb_ref = CF.cell_force_newton_ref(sub, mrows, tbl, row_box=rb, **kw)
        f_full, eb_full = CF.cell_force_newton(sub, rows_full, tbl, **kw)
        torch.cuda.synchronize()
        assert CF.cell_force_newton.row_box_launches == n0 + 1
        what = f"K1 brick box {grid}, rank {rank}, k={k}"
        assert eb.shape == (cells.numel(), k) and float(f.abs().max()) > 0
        assert_forces(f.cpu(), f_ref.cpu(), what)
        assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), what)
        assert torch.equal(f, f_full), what
        assert torch.equal(eb, eb_full[cells]), what


@pytest.mark.gpu
@pytest.mark.parametrize("window", ["slab 2 rank 0", "slab 2 rank 1", "brick 2x2 rank 3",
                                    "brick 2x2x2 rank 5"])
@pytest.mark.parametrize("k", [24, 32])
@pytest.mark.parametrize("energy", [False, True])
def test_cell_force_newton_row_box_cheb_kernel(cuda_state, cuda_slab, window, k, energy):
    """K1's owned-row form with the Chebyshev lookup (K3: the bench's table,
    4 panels of degree 16, fitted to ``cuda_state``'s grid), the form the
    sharded hosts run with ``pair_lookup="chebyshev"``: on a slab window of
    the 10k lattice (``_slab_window``) and on a brick window
    (``pair_edm_cells.shard_window``), against the plain version and
    bitwise the full-window kernel with the rows outside the box masked."""
    from edm_tpu_torch.models.pair_edm_cells import shard_window

    spec, st, _ = cuda_slab
    tab = fit_gauss_grid(cuda_state[4], 16, 4)
    kind, grid, _, rank = window.split()
    if kind == "slab":
        sub, rows_full, subm, ncells, rb = _slab_window(spec, st.xs, st.mc, int(grid),
                                                        int(rank))
    else:
        g3 = tuple(int(g) for g in grid.split("x")) + (1,) * (3 - len(grid.split("x")))
        coord = tuple(int(c) for c in np.unravel_index(int(rank), g3))
        sub, rows_full, subm, _, ncells, rb = shard_window(spec.ncells, g3, coord, st.xs, st.mc)
    cells = CF.box_cells(ncells, rb, sub.device)
    mrows = rows_full[cells].contiguous()
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    kw = dict(k=k, ncells=ncells, box=spec.box, lj=lj, energy=energy, mc_cand=subm)
    n0 = CF.cell_force_newton.row_box_launches
    f, eb = CF.cell_force_newton(sub, mrows, tab, row_box=rb, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(sub, mrows, tab, row_box=rb, **kw)
    f_full, eb_full = CF.cell_force_newton(sub, rows_full, tab, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.row_box_launches == n0 + 1
    what = f"K1 row_box cheb {window}, k={k}"
    assert eb.shape == (cells.numel(), k) and float(f.abs().max()) > 0
    assert_forces(f.cpu(), f_ref.cpu(), what)
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), what)
    assert torch.equal(f, f_full), what
    assert torch.equal(eb, eb_full[cells]), what


@pytest.mark.gpu
def test_slab_step_two_ranks_on_card(cuda_state, tmp_path):
    """A 2-rank slab step on the card (``parallel.launch``: NCCL with a
    card per rank, else gloo on one card) against the single-device step
    from the same state, 4 steps from the single-device trajectory (two of
    them hill steps): forces and positions within 2e-5 * max(1, max|.|),
    the integers exactly, the hill rounds' grids bitwise, both ranks
    bitwise equal."""
    import pickle

    import _torch_ranks as ranks
    from edm_tpu_torch.parallel import launch

    rng = np.random.default_rng(3)
    box = [12 * 1.26] * 3
    pts = (np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3) * 1.26
           + 0.63 + rng.normal(scale=0.05, size=(1728, 3))) % box[0]
    cfg = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
           "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    path = tmp_path / "in.pkl"
    with open(path, "wb") as fh:
        pickle.dump(dict(cfg=cfg, pts=pts, box=box, n_steps=4,
                         lp=dict(dt=0.002, friction=1.0, kT=0.0)), fh)
    res = launch(ranks.slab_on_card, 2, str(path), device="cuda",
                 init_file=str(tmp_path / "store"), timeout=300)
    for i, (got, ref) in enumerate(res[0]):
        for name in ("xs", "vs", "fs"):
            assert_forces(got[name], ref[name], f"step {i} {name}")
        for name in ("aid", "ovl", "tail_count", "tail_ovf"):
            np.testing.assert_array_equal(got[name], ref[name])
        for name in ("step", "last_calls", "hills_truncated"):
            np.testing.assert_array_equal(got["core"][name], ref["core"][name])
        np.testing.assert_array_equal(got["core"]["bias"]["bias"]["grid"]["values"],
                                      ref["core"]["bias"]["bias"]["grid"]["values"])
        for name in ("xs", "vs", "fs", "aid"):
            np.testing.assert_array_equal(res[1][i][0][name], got[name])


@pytest.mark.gpu
def test_brick_step_on_card(cuda_state, tmp_path):
    """A 2 x 2 brick step on the card (4 ranks through ``parallel.launch``:
    NCCL with a card per rank, else gloo on one card) against the
    single-device step on the 5-cell lattice (windows of 5^3 cells, K1's
    brick box and K2 with the brick ownership masks), 4 steps from the
    single-device trajectory: forces and positions within 2e-5 * max(1,
    max|.|), the integers exactly, the hill rounds' grids bitwise, every
    rank bitwise rank 0."""
    import pickle

    import _torch_ranks as ranks
    from edm_tpu_torch.parallel import launch

    rng = np.random.default_rng(3)
    box = [12 * 1.26] * 3
    pts = (np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"), -1).reshape(-1, 3) * 1.26
           + 0.63 + rng.normal(scale=0.05, size=(1728, 3))) % box[0]
    cfg = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 20\n"
           "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    path = tmp_path / "in.pkl"
    with open(path, "wb") as fh:
        pickle.dump(dict(cfg=cfg, pts=pts, box=box, n_steps=4, grid=(2, 2),
                         lp=dict(dt=0.002, friction=1.0, kT=0.0)), fh)
    res = launch(ranks.slab_on_card, 4, str(path), device="cuda",
                 init_file=str(tmp_path / "store"), timeout=300)
    for i, (got, ref) in enumerate(res[0]):
        for name in ("xs", "vs", "fs"):
            assert_forces(got[name], ref[name], f"step {i} {name}")
        for name in ("aid", "ovl", "tail_count", "tail_ovf"):
            np.testing.assert_array_equal(got[name], ref[name])
        for name in ("step", "last_calls", "hills_truncated"):
            np.testing.assert_array_equal(got["core"][name], ref["core"][name])
        np.testing.assert_array_equal(got["core"]["bias"]["bias"]["grid"]["values"],
                                      ref["core"]["bias"]["bias"]["grid"]["values"])
        for r in res[1:]:
            for name in ("xs", "vs", "fs", "aid"):
                np.testing.assert_array_equal(r[i][0][name], got[name])


# ------------------------------------------- the sharded hosts on NCCL

NCCL_CASES = {  # case: (host, ranks, brick grid)
    "work-sharded cells": ("cells", 2, None),
    "sharded 2-D": ("coord", 2, None),
    "spatial (a) 2x1": ("spatial", 2, None),
    "spatial (b) 2x2": ("spatial", 4, None),
    "brick 2x2x2": ("brick", 8, (2, 2, 2)),
}


def _needs_cards(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on the card)")
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards for NCCL ({n} ranks, a card each); this machine has "
                    f"{torch.cuda.device_count()}")


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(NCCL_CASES))
def test_sharded_host_nccl_matches_gloo(case, tmp_path):
    """One sharded host over 4 kT = 0 steps (two hill steps) from the same
    seeded inputs, launched over NCCL (a card a rank) and over gloo (every
    rank on card 0, the collectives staged through the host): every leaf of
    every rank's state after each step bitwise the same, integers and
    floats, and the hill rounds deposited something.  Every collective is a
    gather and ``psum`` adds the gathered parts in rank order on each rank,
    so both routes hand each rank the same bits."""
    import pickle

    import _torch_ranks as ranks
    from edm_tpu_torch.parallel import launch

    host, n, grid = NCCL_CASES[case]
    _needs_cards(n)
    path = tmp_path / "in.pkl"
    with open(path, "wb") as fh:
        pickle.dump(dict(host=host, grid=grid, n_steps=4), fh)
    runs = {b: launch(ranks.card_host_steps, n, str(path), backend=b, device="cuda",
                      init_file=str(tmp_path / f"{b}.store"), timeout=300)
            for b in ("nccl", "gloo")}
    assert [r["device"] for r in runs["nccl"]] == [f"cuda:{r}" for r in range(n)]
    assert {r["device"] for r in runs["gloo"]} == {"cuda:0"}
    for rank, (a, b) in enumerate(zip(runs["nccl"], runs["gloo"])):
        for i, (sa, sb) in enumerate(zip(a["states"], b["states"])):
            la, lb = dict(tree_leaves(sa)), dict(tree_leaves(sb))
            assert la.keys() == lb.keys()
            for name, x in la.items():
                y, what = lb[name], f"{case} rank {rank} step {i} {name}"
                assert (x.shape, x.dtype) == (y.shape, y.dtype), what
                np.testing.assert_array_equal(x, y, err_msg=what)
    cum = [v for k, v in tree_leaves(runs["nccl"][0]["states"][-1]) if k.endswith("cum_bias")]
    assert cum and float(cum[0]) > 0, f"{case}: no hill was deposited"


@pytest.mark.gpu
def test_nccl_rank_failure_reported(tmp_path):
    """A rank that raises inside an NCCL collective (a host tensor handed
    to it) while the other waits in its own: ``launch`` raises with that
    rank's traceback within its timeout and the 30 s grace of the failure."""
    import time

    import _torch_ranks as ranks
    from edm_tpu_torch.parallel import launch

    _needs_cards(2)
    timeout, failed_at = 10, tmp_path / "failed_at"
    with pytest.raises(RuntimeError, match="ranks failed") as err:
        launch(ranks.nccl_failure, 2, str(failed_at), backend="nccl", device="cuda",
               init_file=str(tmp_path / "store"), timeout=timeout)
    elapsed = time.time() - float(failed_at.read_text())
    assert "--- rank 1 ---" in str(err.value) and "all_gather" in str(err.value)
    # from the failure: the grace, then the parent's poll (1 s), the stop of
    # the hung rank (terminate, 5 s, then kill) and its exit
    assert elapsed < timeout + 30 + 20, f"launch took {elapsed:.1f} s after the failure"


# ------------------------------------------- the counter hash and pass 1

HASH_SEEDS = (0x9E3779B9, 987654321)


def _ulps(a, b):
    """Per element |a - b| in units of the spacing at the larger |.|."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("normal", [False, True], ids=["uniform", "normal"])
def test_hash_rows_kernel(cuda_state, dtype, normal):
    """``hash_rows`` against its plain version (the int64 hash on the card)
    at the edges of its tiles (``chip_smoke.hash_edge_rows``): n = 1, 3, 5,
    7 (a thread an element, or a row from 2^16 rows on) and 864, 896, 897
    (a warp a row, 897 with rows on every 16-byte phase), R = 1, 33, the
    10k thermostat's 23,552 and 2^16 + 33, row ids near and above 2^32, a
    non-contiguous view of the rows.  Uniforms bitwise, normals within 2
    ulps (the largest printed), one launch a call."""
    from chip_smoke import HASH_EDGE_COLS, hash_edge_rows
    from edm_tpu_torch.ops import hashrng as H

    dev = torch.device("cuda", 0)
    fn, ref = ((H.normal_rows_cols, H.normal_rows_cols_ref) if normal else
               (H.uniform_rows_cols, H.uniform_rows_cols_ref))
    worst = 0.0
    for label, r in hash_edge_rows(torch, dev):
        for n in HASH_EDGE_COLS:
            n0 = fn.launches
            out = fn(HASH_SEEDS, r, n, dtype)
            want = ref(HASH_SEEDS, r, n, dtype)
            torch.cuda.synchronize()
            assert fn.launches == n0 + 1 and out.dtype == dtype and out.shape == (len(r), n)
            if normal:
                ulps = float(_ulps(out, want).max())
                assert ulps <= 2, (label, n, ulps)
                worst = max(worst, ulps)
            else:
                assert torch.equal(out, want), (label, n)
    assert fn(HASH_SEEDS, r[:0], 3, dtype).shape == (0, 3)
    if normal:
        print(f"hash_normals {dtype}: at most {worst:g} ulps from the plain version")


def _half_inputs(spec, st, cells, dtype):
    """Pass 1's lattice inputs in ``dtype``: (xs, mc, cells, nbr)."""
    nbr = CF.half_neighbors(tuple(spec.ncells), st.xs.device)
    return st.xs.to(dtype), st.mc.to(dtype), cells, nbr


def _threshold(on, dtype, dev):
    return torch.full((), 0.01, dtype=dtype, device=dev) if on else None


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("thresh", [True, False], ids=["thresh", "accept-all"])
@pytest.mark.parametrize("form", ["lattice", "slab", "brick"])
def test_p1_counts_half_kernel(cuda_slab, form, thresh, dtype):
    """``p1_count_half`` against its plain version on the 10k lattice:
    row_counts and ncalls exactly, over every cell, the owned cells of a
    2-rank slab and of a 2 x 2 brick; a second launch repeats them."""
    from edm_tpu_torch.ops import collect

    spec, st, _ = cuda_slab
    dev = st.xs.device
    boxes = {"lattice": [torch.arange(spec.n_cells, device=dev)],
             "slab": [torch.arange(0, 5 * 81, device=dev),
                      torch.arange(5 * 81, 9 * 81, device=dev)],
             "brick": [CF.box_cells(spec.ncells, ((x0, y0, 0), (wx, wy, 9)), dev)
                       for x0, wx in ((0, 5), (5, 4)) for y0, wy in ((0, 5), (5, 4))]}[form]
    box = torch.tensor(spec.box, dtype=dtype, device=dev)
    th = _threshold(thresh, dtype, dev)
    for cells in boxes:
        args = _half_inputs(spec, st, cells, dtype) + (box, 9.0, th, HASH_SEEDS)
        n0 = collect.p1_counts_half.launches
        rc, nc = collect.p1_counts_half(*args)
        rc_ref, nc_ref = collect.p1_counts_half_ref(*args)
        torch.cuda.synchronize()
        assert collect.p1_counts_half.launches == n0 + 1
        assert int(nc_ref) > 0 and torch.equal(rc, rc_ref) and int(nc) == int(nc_ref)
        rc2, nc2 = collect.p1_counts_half(*args)
        assert torch.equal(rc2, rc) and int(nc2) == int(nc)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("thresh", [True, False], ids=["thresh", "accept-all"])
def test_p1_counts_typed_kernel(cuda_slab, thresh, dtype):
    """``p1_count_typed`` against its plain version on the 10k lattice with
    every other atom type 2, type pair (1, 2): row_counts and ncalls
    exactly."""
    from edm_tpu_torch.ops import collect

    spec, st, _ = cuda_slab
    dev = st.xs.device
    n = spec.n_atoms
    types = torch.tensor(np.where(np.arange(n) % 2 == 0, 2, 1), device=dev)
    t = types[torch.clamp(st.aid, 0, n - 1)]
    tslot = torch.where(st.aid < n, t, 0).to(dtype).reshape(st.mc.shape)
    nbr = CF.stencil_neighbors(tuple(spec.ncells), dev)
    args = (st.xs.to(dtype), st.aid, tslot, nbr, torch.tensor(spec.box, dtype=dtype, device=dev),
            9.0, _threshold(thresh, dtype, dev), HASH_SEEDS, n, (1, 2))
    n0 = collect.p1_counts_typed.launches
    rc, nc = collect.p1_counts_typed(*args)
    rc_ref, nc_ref = collect.p1_counts_typed_ref(*args)
    torch.cuda.synchronize()
    assert collect.p1_counts_typed.launches == n0 + 1
    assert int(nc_ref) > 0 and torch.equal(rc, rc_ref) and int(nc) == int(nc_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("thresh", [True, False], ids=["thresh", "accept-all"])
@pytest.mark.parametrize("typed", [False, True], ids=["half", "typed"])
def test_p1_counts_kernels_edge_lattice(cuda_state, typed, thresh, dtype):
    """Both pass-1 kernels on ``chip_smoke.edge_lattice`` (cap 8: full and
    empty cells, displacements at +-L/4 and +-L/2, r^2 at bmax^2 and one
    float32 step either side of it), threshold 0.5 and none: row counts
    and ncalls exactly the plain version's, one launch a call; the half
    pass also over an unordered cell list."""
    from chip_smoke import edge_lattice
    from edm_tpu_torch.ops import collect

    dev = torch.device("cuda", 0)
    pts, box, cap, types = edge_lattice()
    n = len(pts)
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\ndimension 1\nbox_low 0\n"
                         "box_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    _, bs = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                        dtype=torch.float32, device=dev)
    core = pair_edm.init_state(bs, torch.tensor(pts, dtype=torch.float32, device=dev),
                               PRNGKey(0))
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=n, cap=cap)
    st = init_cell_state(spec, core)
    assert spec.ncells == (5, 3, 5) and int((st.mc.sum(1) == cap).sum()) == 2
    boxt = torch.tensor(spec.box, dtype=dtype, device=dev)
    th = torch.full((), 0.5, dtype=dtype, device=dev) if thresh else None
    if typed:
        t = torch.as_tensor(types, device=dev)[torch.clamp(st.aid, 0, n - 1)]
        tslot = torch.where(st.aid < n, t, 0).to(dtype).reshape(st.mc.shape)
        calls = [(collect.p1_counts_typed, collect.p1_counts_typed_ref,
                  (st.xs.to(dtype), st.aid, tslot, CF.stencil_neighbors(spec.ncells, dev), boxt,
                   9.0, th, HASH_SEEDS, n, (1, 2)))]
    else:
        perm = torch.randperm(spec.n_cells, generator=torch.Generator().manual_seed(3)).to(dev)
        calls = [(collect.p1_counts_half, collect.p1_counts_half_ref,
                  _half_inputs(spec, st, cells, dtype) + (boxt, 9.0, th, HASH_SEEDS))
                 for cells in (torch.arange(spec.n_cells, device=dev), perm[:20])]
    for fn, ref, args in calls:
        n0 = fn.launches
        rc, nc = fn(*args)
        rc_ref, nc_ref = ref(*args)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        assert int(nc_ref) > 0 and torch.equal(rc, rc_ref) and int(nc) == int(nc_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("thresh", [True, False], ids=["thresh", "accept-all"])
@pytest.mark.parametrize("typed, cap, dtype", [
    (True, 128, torch.float64), (False, 300, torch.float64), (False, 512, torch.float32),
    (False, 3000, torch.float64), (True, 3000, torch.float64)],
    ids=["typed-128-f64", "half-300-f64", "half-512-f32", "half-3000-f64", "typed-3000-f64"])
def test_p1_counts_kernels_large_cap(cuda_state, typed, cap, dtype, thresh):
    """Both pass-1 kernels above the largest cap whose candidate cells fit
    one shared-memory piece, on ``chip_smoke.dense_lattice`` (3^3 cells,
    one full, one empty, the rest half to fully occupied): typed cap 128 in
    float64, half cap 300 in float64 and 512 in float32 (the cells in two
    pieces), and cap 3000 in float64 (the rows tiled too and each cell in
    runs of slots).  Row counts and ncalls exactly the plain version's,
    threshold 0.5 and none, one launch a call."""
    from chip_smoke import dense_lattice, lattice_state
    from edm_tpu_torch.ops import collect

    dev = torch.device("cuda", 0)
    pts, box, cap, types = dense_lattice(cap)
    n = len(pts)
    spec, st = lattice_state(torch, dev, pts, box, cap)
    assert spec.ncells == (3, 3, 3) and int(st.mc.sum()) == n
    boxt = torch.tensor(spec.box, dtype=dtype, device=dev)
    th = torch.full((), 0.5, dtype=dtype, device=dev) if thresh else None
    if typed:
        t = torch.as_tensor(types, device=dev)[torch.clamp(st.aid, 0, n - 1)]
        tslot = torch.where(st.aid < n, t, 0).to(dtype).reshape(st.mc.shape)
        fn, ref = collect.p1_counts_typed, collect.p1_counts_typed_ref
        args = (st.xs.to(dtype), st.aid, tslot, CF.stencil_neighbors(spec.ncells, dev), boxt, 9.0,
                th, HASH_SEEDS, n, (1, 2))
    else:
        fn, ref = collect.p1_counts_half, collect.p1_counts_half_ref
        args = _half_inputs(spec, st, torch.arange(spec.n_cells, device=dev), dtype) + (
            boxt, 9.0, th, HASH_SEEDS)
    n0 = fn.launches
    rc, nc = fn(*args)
    rc_ref, nc_ref = ref(*args)
    torch.cuda.synchronize()
    assert fn.launches == n0 + 1
    assert int(nc_ref) > 0 and torch.equal(rc, rc_ref) and int(nc) == int(nc_ref)


@pytest.mark.gpu
@pytest.mark.parametrize("typed", [False, True], ids=["half", "typed"])
def test_collection_kernels_vs_plain(cuda_slab, typed):
    """One hill collection of the 10k cell host through the kernels and
    through their plain versions (the module names of ``pair_edm_cells``
    swapped): hills, runifs, active, ncalls and the truncation flag
    bitwise."""
    from edm_tpu_torch.ops import collect
    from edm_tpu_torch.ops import hashrng as H

    spec, st, _ = cuda_slab
    n = spec.n_atoms
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
                         "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                         "bias_sigma 0.1\n")
    params, _ = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                            dtype=torch.float32, device=st.xs.device)
    kw = dict(types=np.where(np.arange(n) % 2 == 0, 2, 1), type_pair=(1, 2)) if typed else {}
    step = make_cell_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.8), LJ, spec, 10,
                          **kw)
    args = (st, st.xs, PRNGKey(7), torch.tensor(40000, device=st.xs.device), torch.float32)
    got = step._collect_hills(*args)
    plain = {"p1_counts_half": collect.p1_counts_half_ref,
             "p1_counts_typed": collect.p1_counts_typed_ref,
             "uniform_rows_cols": H.uniform_rows_cols_ref}
    saved = {k: getattr(PCELLS, k) for k in plain}
    try:
        for k, fn in plain.items():
            setattr(PCELLS, k, fn)
        want = step._collect_hills(*args)
    finally:
        for k, fn in saved.items():
            setattr(PCELLS, k, fn)
    assert int(want[3]) > 0 and bool(want[2].any())
    for name, a, b in zip(("hills", "runifs", "active", "ncalls", "truncated"), got, want):
        assert torch.equal(a, b), name


# ---------------------------------------- any cap, tail length and table (K1, K2, K6, K7)


@pytest.fixture(scope="module")
def cap_states(cuda_state):
    """``chip_smoke.cap_lattice`` on the card at caps 96, 256 and 512 (3^3
    cells, one full, one empty), with slot ids and the binary types:
    {cap: (spec, state)}."""
    from chip_smoke import cap_lattice, lattice_state

    dev = torch.device("cuda", 0)
    out = {}
    for cap in (96, 256, 512):
        pts, box, cap, types = cap_lattice(cap)
        out[cap] = lattice_state(torch, dev, pts, box, cap, with_ids=True, types=types)
    return out


CAP_LJ = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)  # the dense liquid's


def _cap_state(cap_states, cap, drifted):
    """``cap_states[cap]``, or with its atoms ``drift``-ed: each moved by up
    to a 10-step stride's travel, some past their cell's faces, a tenth by
    a box length across the periodic boundary, the slots unchanged (the
    state between two rebuilds)."""
    spec, st = cap_states[cap]
    if drifted:
        st = dataclasses.replace(st, xs=drift(st.xs, st.mc, spec.box, seed=cap))
    return spec, st


@pytest.mark.gpu
@pytest.mark.parametrize("cap, k", [(96, 72), (96, 96), (256, 128), (256, 256), (512, 512)])
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("drifted", [False, True])
def test_row_pass_k1_large_cap(cuda_state, cap_states, poisoned_empty, cap, k, kind, energy,
                               drifted):
    """K1 past k = 64 (the pieces form, its sweep culled by the chunks'
    boxes; at 512 the rows tiled too) on poisoned outputs, on the lattice
    and on its drifted atoms: the plain version's forces and per-row
    energies, zeros past k, one launch, a bitwise repeat."""
    spec, st = _cap_state(cap_states, cap, drifted)
    tab = _table(cuda_state[4], kind)
    lid, _, _, rows, degp, _ = CF._table_args(tab, st.xs.device)
    plan = CF.row_plan(k, 3, False, lid, rows, degp)
    assert not plan.small and (plan.row_tile < k) == (k > CF.ROW_TILE)
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=CAP_LJ, energy=energy)
    n0 = CF.cell_force_newton.launches
    out = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tab, **kw)
    torch.cuda.synchronize()
    assert CF.cell_force_newton.launches == n0 + 1
    f, eb = out
    assert_forces(f.cpu(), f_ref.cpu(), f"K1 cap={cap} k={k}")
    assert_forces(eb.cpu(), eb_ref.cpu(), f"K1 cap={cap} k={k} eb rows")
    assert_energy(eb.sum().cpu(), eb_ref.sum().cpu(), f"K1 cap={cap} k={k} energy")
    assert not bool(f[:, k:].any() or f[spec.n_cells:].any() or f[st.mc < 0.5].any())
    assert energy == bool(eb.abs().sum() > 0)
    assert _same(out, CF.cell_force_newton(st.xs, st.mc, tab, **kw))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
@pytest.mark.parametrize("drifted", [False, True])
def test_row_pass_typed_k6_k7_large_cap(cuda_state, cap_states, poisoned_empty, kind, energy,
                                        drifted):
    """At cap 96 (the pieces form), on the lattice and on its drifted
    atoms: typed K1, K6 (typed and not) and, with the Chebyshev table, K7,
    each against its plain version on poisoned outputs, with a bitwise
    repeat."""
    spec, st = _cap_state(cap_states, 96, drifted)
    tab = _table(cuda_state[4], kind)
    geo = dict(ncells=spec.ncells, box=spec.box, lj=CAP_LJ)
    kw = dict(geo, energy=energy, ts=st.ts, type_pair=(1, 2))
    out = CF.cell_force_newton(st.xs, st.mc, tab, k=96, **kw)
    f_ref, eb_ref = CF.cell_force_newton_ref(st.xs, st.mc, tab, k=96, **kw)
    torch.cuda.synchronize()
    assert_forces(out[0].cpu(), f_ref.cpu(), f"typed K1 {kind}")
    assert_energy(out[1].sum().cpu(), eb_ref.sum().cpu(), f"typed K1 {kind} energy")
    assert _same(out, CF.cell_force_newton(st.xs, st.mc, tab, k=96, **kw))
    for typed in (False, True):
        kw6 = dict(geo, energy=energy, ts=st.ts if typed else None,
                   type_pair=(1, 2) if typed else None)
        n0 = CF.cell_force_newton_planar.launches
        out = CF.cell_force_newton_planar(st.xs, st.mc, tab, **kw6)
        f_ref, cred_ref, eb_ref = CF.cell_force_newton_planar_ref(st.xs, st.mc, tab, **kw6)
        torch.cuda.synchronize()
        assert CF.cell_force_newton_planar.launches == n0 + 1
        assert_forces(out[0].cpu(), f_ref.cpu(), f"K6 {kind} typed={typed} rows")
        assert_forces(out[1].cpu(), cred_ref.cpu(), f"K6 {kind} typed={typed} credits")
        assert_energy(out[2].sum().cpu(), eb_ref.sum().cpu(), f"K6 {kind} energy")
        assert _same(out, CF.cell_force_newton_planar(st.xs, st.mc, tab, **kw6))
    if kind == "cheb" and energy:
        n0 = CF.cell_force_full.launches
        out = CF.cell_force_full(st.xs, st.mc, st.sid, tab, **geo)
        f_ref, eb_ref = CF.cell_force_full_ref(st.xs, st.mc, st.sid, tab, **geo)
        torch.cuda.synchronize()
        assert CF.cell_force_full.launches == n0 + 1
        assert_forces(out[0].cpu(), f_ref.cpu(), "K7 cap=96")
        assert_forces(out[1].cpu(), eb_ref.cpu(), "K7 cap=96 eb rows")
        assert_energy(out[1].sum().cpu(), eb_ref.sum().cpu(), "K7 cap=96 energy")
        assert _same(out, CF.cell_force_full(st.xs, st.mc, st.sid, tab, **geo))


@pytest.mark.gpu
@pytest.mark.parametrize("cap, k", [(96, 96), (256, 256)])
@pytest.mark.parametrize("drifted", [False, True])
def test_row_pass_cull_counts(cuda_state, cap_states, cap, k, drifted):
    """With tracing on, the pieces form's counters of one K1 launch:
    ``k1.unculled`` is rows x occupied candidates and ``k1.in_reach`` the
    plain count of unordered half-stencil pairs within r2_far (the cull
    drops no pair), and the cull runs fewer r^2 tests than that; with
    tracing off nothing is counted and the forces are bitwise the same."""
    spec, st = _cap_state(cap_states, cap, drifted)
    tab = _table(cuda_state[4], "hermite")
    kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=CAP_LJ, energy=False)
    off = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
    trace.enable()
    try:
        trace.reset()
        on = CF.cell_force_newton(st.xs, st.mc, tab, **kw)
        got = trace.report()["counters"]
    finally:
        trace.enable(False)
        trace.reset()
    assert _same(off, on)
    unculled, in_reach = stencil_pair_counts(st.xs.cpu(), st.mc.cpu(), k, spec.ncells, spec.box,
                                             reach2(tab, CAP_LJ))
    assert got["k1.unculled"] == unculled and got["k1.in_reach"] == in_reach, got
    assert in_reach <= got["k1.tested"] < unculled, got


@pytest.mark.gpu
@pytest.mark.parametrize("O", [136, 384, 1024])
@pytest.mark.parametrize("live", ["one", "eight", "all"])
@pytest.mark.parametrize("kind", ["hermite", "cheb"])
@pytest.mark.parametrize("energy", [False, True])
def test_overflow_force_rows_past_tile(cuda_state, poisoned_empty, O, live, kind, energy):
    """K2 past one tile of 128 tail rows (the rows tiled over the grid's y,
    the tail-tail blocks over the tail's tiles, the partners' credits added
    in tile order) on poisoned outputs, ``test_overflow_force_rows``'s
    checks."""
    dev = torch.device("cuda", 0)
    n_live = {"one": 1, "eight": 8, "all": O}[live]
    xo, xp = (t.to(dev) for t in overflow_case(O, n_live, 1000, seed=O + n_live))
    tab = _table(cuda_state[4], kind)
    kw = dict(box=BOX, lj=LJ, energy=energy)
    n0 = CF.overflow_force.launches
    out = CF.overflow_force(xo, xp, tab, **kw)
    fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tab, **kw)
    torch.cuda.synchronize()
    assert CF.overflow_force.launches == n0 + 1
    fo, fp = out
    assert_forces(fo[:3].cpu(), fo_ref[:3].cpu(), f"K2 O={O} live={n_live} fo")
    assert_forces(fp.cpu(), fp_ref.cpu(), f"K2 O={O} live={n_live} fp")
    assert_forces(fo[3].cpu(), fo_ref[3].cpu(), f"K2 O={O} live={n_live} energy rows")
    assert_energy(fo[3].sum().cpu(), fo_ref[3].sum().cpu(), f"K2 O={O} live={n_live} energy")
    assert not bool(fo[:, xo[3] < 0.5].any() or fp[:, xp[3] < 0.5].any())
    assert _same(out, CF.overflow_force(xo, xp, tab, **kw))
