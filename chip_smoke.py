"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives seventeen paths of the port through their CUDA kernels and checks
each kernel against its plain PyTorch version on the same card:

  - the 10,000-atom pairwise-EDM cell-list MD step of
    ``bench.py:bench_pairwise`` (well-tempered, RDF-targeted bias on a
    151-point grid, kernel_cap 24, overflow_cap 32, energy stride 10, the
    hills / 8 plain / rebuild stride cycle) with the exact Hermite lookup:
    K1 ``cell_force_newton`` and K2 ``overflow_force``;
  - the same step on ``bench.py:378-382``'s 100,000-atom cell (47^3
    lattice sites, cells 19^3, nothing cut), the north-star scale: K1 and
    K2 again; on every cell path the thermostat's normals through
    ``hash_normals``, the hill collection's pass 1 through
    ``p1_count_half`` (typed: ``p1_count_typed``) and pass 2's draws
    through ``hash_uniforms`` (``csrc/hashrng.cu``, the counter hash);
  - the dense 32,000-atom liquid of LAMMPS's ``bench/in.lj`` (fcc at
    rho* = 0.8442, LJ rcut 2.5) with the bench's bias out to r = 4.0 on
    8^3 cells of the automatic cap 96 (``dense_liquid_phase``): K1 at full
    cap past k = 64 (the pieces form), K2 with 384 tail rows (row tiles)
    under kernel_cap 72, and both with 16 Chebyshev panels of degree 16;
    then each force kernel past the old shape limits, and K4/K5 with hills
    wider than the grid;
  - the same step with the Chebyshev lookup (``pair_lookup="chebyshev"``,
    4 panels of degree 16, refit after every hill round): K1 and K2 with
    the Clenshaw chains (K3);
  - the same 10k step without kernel_cap through the other force paths:
    ``use_pallas="newton"`` (exact Hermite; K6
    ``cell_force_newton_planar`` and the 13 credit subtractions),
    ``use_pallas="full"`` (the Chebyshev table, a state with slot ids;
    K7 ``cell_force_full`` and a full rebuild every 10 steps), and the
    typed CV (the binary mixture, every other atom type 2, type pair
    (1, 2); K1 with the type mask at full cap and the 27-stencil hill
    collection);
  - ``bench.py:bench_deposition``: 200 hills per ``GaussGrid.add_value`` on
    the periodic 1e6-point grid, K4 ``deposit_windowed_1d``; and one round
    on a grid whose windows are wide, K5 ``deposit_dense_1d_kernel``;
  - ``bench.py:bench_coord2d``: the 2-D coordinate host
    (``models/coord_edm``, 10,000 free particles, a periodic 1000 x 1000
    grid, hill_density 250, hill_capacity 2048, the cached corner table,
    ``driver.strided_segment`` with hill_stride 10): every draw (the
    thermostat's normals, the acceptance uniforms) one launch of the
    Threefry draw kernel ``tf_bits``; and its ``mcgdp=True``
    form, a non-periodic 1001 x 1001 grid with McGovern-De Pablo walls on
    both dims, whose hill rounds deposit through ``dense_tables_mcgdp`` +
    ``deposit_from_mcgdp``;
  - the single-device pair hosts of the JAX package that run no Pallas
    kernel: the blocked all-pairs host (``models/pair_edm_blocked``) on
    bench_pairwise's 10,000-atom fluid and bias with block_size 500, its
    per-row acceptance streams through the Threefry kernel
    ``prng.threefry_rows``; the cell host's XLA force pass
    (``use_pallas=False``, the JAX default, cell_chunk 81) on the 10k exact
    cell at full cap, held to K1; and the dense all-pairs host
    (``models/pair_edm``) at bench.py --quick's 1,000 atoms, its N^2
    acceptance uniforms through ``tf_bits``;
  - the multi-device layer (``parallel``), its ranks spawned by
    ``parallel.launch`` (NCCL with a card per rank, else gloo with the ranks
    sharing the card): the slab-sharded cell host
    (``parallel.make_slab_cell_step``) on the 10k exact cell at 2 and 4
    ranks, K1's owned-row form (``row_box``) on every step; and the
    sharded dense host (``parallel.make_sharded_pair_step``) at 1,000
    atoms on 2 ranks; the brick host on 2 x 2 and 2 x 2 x 2, the
    work-sharded cell host and the sharded 2-D host; a sharded run
    checkpointed into one file and resumed (``utils/checkpoint`` with a
    mesh);
  - the spatial host (``parallel/spatial.py``): the 2-D heavy cell's CV
    range split into bricks, one local grid a rank, hills exchanged and
    replayed at their heights: periodic on 2 ranks (2, 1) and on 2 x 2,
    and on the McGDP box on 2 ranks through ``boundary_offset``; every
    draw through ``tf_bits``;
  - the multi-device dry run (``parallel.dryrun.dryrun_multichip(8)``):
    the eight probes of ``__graft_entry__.py``, each held to the port's
    single-device host or serial engine (K1's owned-row forms and K2 on
    the card again);
  - the user's entry points: ``EDMBias`` on the card replaying the
    compiled reference's ``tests/oracles/workload.txt`` and writing its
    ``.ltab`` fixtures; the 10k exact cell through ``driver.run_simulation``
    with the dynamic step (every ``static_do_*`` None), hill records, a
    ``HillsLog`` and bias, histogram and .ltab files (K1 and K2 again);
    ``utils/checkpoint`` save and resume; the C++ text formatters of
    ``native/``;
  - the user's example scripts (``examples/torch_*.py``), each through its
    own functions: the boundary sweep (``EDMBias`` in float64), the single
    particle (the coordinate host's dynamic step, 2,000 steps), the
    pairwise RDF run (the dense host under ``run_simulation``, 400 steps),
    the occupancy diagnostic on the 10k and the 100k cells (K1 at full
    cap), the weak-scaling script's slab and bricks (K1's owned-row form
    with the Chebyshev table) and the spatial script on 8 ranks.

Phases: the card (nvidia-smi name and power limit) and software versions;
the kernel build from ``edm_tpu_torch/csrc`` (one nvcc per source, sm_90a);
each kernel against its plain version at the main paths' shapes; per MD
path 20 steps at kT = 0 through the kernels, each step held to the same
step through the plain versions, then the bench's kT = 0.8 run with the
launch counters reset (rate, host syncs, the device-busy share of a
stride cycle, end-state checks; the typed path also holds its first hill
round's candidates below the untyped round's; the counter-hash and
pass-1 kernels launched as often as the steps ask); after the exact path,
the counter-hash and pass-1 kernels against their plain versions on its
end state (``hash_kernel_phase``: uniforms bitwise, normals within 2 ulps,
the row counts and ncalls of pass 1 exactly over the lattice, a 2-rank
slab's and a 2 x 2 brick's owned cells and the typed stencil, whole
collections bitwise; and both pass-1 kernels on ``edge_lattice`` in
float32 and float64), then the sampled g(r) at kT = 0.8: 300 steps from one thermalized state through
the kernels and through the plain versions with the same key, and through
the kernels with another key, the first two within twice the distance of
the kernel runs plus ``GOFR_FLOOR`` (L1 of the normalized histograms);
after the five 10k paths, the 100k cell: 10 kT = 0 steps from a
thermalized state (200 kT = 0.8 steps) held to the plain versions, the
bench's segment at kT = 0.8 (360 warm-up and 360 timed steps, the same
prints and checks), the counter hash's and pass 1's share of a stride
cycle's device time through the kernels and through the plain versions, a
hill step's peak memory through the kernels (below 2 GB) and through the
plain pass 1 chunked and in one chunk, ``hash_kernel_phase`` at its
shapes, K1 and K2 against their plain versions on its state, and a
short typed run at 100k (``p1_count_typed[100k]``), with each part's
seconds; the deposition run (hills/s,
host syncs, device-busy share and device launches of a round; its final
grid held to the same rounds through the plain versions); the Threefry
draw kernel against its plain versions (bits and uniforms bitwise, normals
within 2 ulps, n = 1 to 10^6 + 3, one launch a draw) and its time on the
2-D thermostat's normals and the dense host's 10^6 uniforms; the 2-D slice, 20 kT = 0 steps
each taken from the same input state on the card and on the CPU (integer
leaves exactly, the rest within ``COORD_*``; the worst difference of each
leaf printed), then the bench's kT = 1.0 run (100 warm-up steps, each hill
round's growth of the grid's integral held to its round_bias; 1,000 timed
steps: steps/s, the device-busy share of a cycle, device launches per
step, the top device operations, host syncs per hill and plain step, each
named by its line and all of them counted by the steps' ``host_syncs``);
then the same two phases on the McGDP grid, with its
first hill round deposited through the McGDP tables and through the
windowed route and the two held to each other (the e^-8 corner class);
``threefry_rows`` against the numpy chain, bitwise, at the blocked host's
pass-1 and pass-2 shapes, the work-sharded host's, ragged and short rows
and 70,000 rows, one launch a call; the blocked host's 20 kT = 0 steps through the
kernel and through its plain version, bitwise, then its kT = 0.8 run
(10 warm-up and 20 timed steps through ``driver.strided_segment``:
steps/s, device launches per step, the cycle's busy share and top device
operations, host syncs per hill and plain step named by line, the Threefry
launches, end-state checks); the XLA pass's 20 kT = 0 steps from a
thermalized state, each state's forces held to K1 at full cap, then its
kT = 0.8 run as the other cell paths' but 50 steps after 20; the dense host's 20 kT = 0 steps
from a thermalized state, each on the card and on the CPU from the same
input, then its kT = 0.8 run as the blocked host's, 300 steps after 100;
the multi-device phases, the kernels built in this process before the
ranks are spawned (the backend, the rank count, the ranks per card and the
cards used printed first; every launch whose rank count the machine's
cards cover runs over NCCL, a card a rank, and must stage nothing through
the host; the timed runs in one table, ``ranks_table``, rank 0's busy
share "not measured" over NCCL): on each rank's window of the 10k state
K1's owned-row form
against its plain version and bitwise against the full-window kernel with
the halo rows masked, at k = 24 and 32 (the ranks take turns on the card
to time it); 20 kT = 0 steps through the slab host and the single-device
host from the same input state (forces within FORCE_REL, integers and the
hill rounds' grids exactly, every rank bitwise rank 0, a hill round with
``slab_collect=False`` bitwise the default); the kT = 0.8 run (rate,
launches and collectives a step, host stagings, rank 0's busy share, the
syncs of a hill, a plain and a rebuild step named by line, end checks;
100 steps after 50); on
2 ranks also the sharded dense host's 20 kT = 0 steps against the dense
host on the card, the work-sharded cell host and the sharded 2-D host
(each held to one device, then timed), and ``sharded_checkpoint_phase``
(the slab host and the spatial case (a) checkpointed after 10 steps with
the mesh, resumed into fresh templates, 10 more steps bitwise the
uninterrupted run on every rank); the brick host on 2 x 2 (4 ranks: 20
kT = 0 steps, 100 steps after 50) and 2 x 2 x 2 (8 ranks: 5 kT = 0
steps, 100 after 50); the spatial cases (2 ranks: (a) and (c); 4 ranks: (b)),
each with 3 hill rounds of frozen walkers, the stitched grid after each
held to a single-device windowed deposit of the round's hills, the forces
to ``update_forces`` on the stitched grid, then the kT = 1.0 run (100
steps after 20, a rebin every 20: steps/s, Threefry launches,
collectives and kB a step, host syncs, rank 0's busy share, end checks);
``dryrun_multichip(8)`` (each probe's seconds and worst error beside its
bound); before the launches, K1's owned-row form with the bench's
Chebyshev table on the weak-scaling example's slab windows and on the 10k
state's slab and brick windows, against its plain version and bitwise the
masked full window; at the end of each launch the examples' share of that
rank count (``example_rank_part``: the weak-scaling script's slab on 2
ranks, 2 x 2 brick on 4, 2 x 2 x 2 brick on 8, each row printed, and on 8
the spatial script: cum_bias equal on every rank, its files written);
then the entry points: the workload replay within 1e-9 of the compiled
reference (cum_bias each round, 31 probes; rounds/s and the syncs of a
round named by line) and the two .ltab fixtures; ``run_simulation`` at
kT = 0 for 20 steps bitwise against ``pattern_segment``'s static phases,
its HILLS file against the plain versions' run line for line and against
cum_bias; at kT = 0.8 its steps/s against ``pattern_segment``'s in turns,
the wall time of a write and the syncs of a write period named by line; a
checkpoint after 50 steps resumed into a fresh template, bitwise the 100
uninterrupted steps; the native formatters loaded and the 1001 x 1001 grid
written and read back; then the example scripts' single-process parts
(``examples_phase``, the launch counts set to 0 before each script and
read after it, each script's seconds printed): the boundary sweep within
1e-9 of ``tests/oracles/boundary_sweep.txt``, the single particle's host
path within 1e-12 of the CPU and its 2,000-step run (cum_bias > 0, the
visits equal to the hill rounds), the RDF run's 400 steps (finite, every
file, the well below the outside), the occupancy diagnostic at 10k (2
segments of 300 steps) and 100k (2 of 200) with each ``cell_diag`` line's
sums, and the weak-scaling script's 1-rank slab.  The
deposition kernels are checked on grids that already carry hills.  It prints one
``kernels`` JSON line (launches, errors, times, the card's least time for
the work; ``ms`` is the wrapper's time per call by CUDA events, which the
host bounds, ``device_ms`` the device time per launch in the path's
profile) and, last, ``{"ok": true, "device": {...}}``.

Usage: ``python3 chip_smoke.py`` from the repository root (one GPU; on a
machine with several, the rank counts they cover run over NCCL).  Any
failed check raises, and the script exits non-zero without the last line.
``python3 chip_smoke.py --ranks`` builds the kernels and runs only the
multi-device part on the rank counts the machine's cards cover (over NCCL;
on one card all three, over gloo) and the dry run on the most of them;
``--ranks gloo`` also runs each NCCL launch's timed runs again over gloo
with the ranks sharing card 0, the same hosts on both routes in one table.
``python3 chip_smoke.py --ab-slice OTHER`` times only the exact-lookup
kT = 0.8 run and the 256-round deposition, of the checkout OTHER (say, the
parent commit unpacked by ``git archive``) and of this one in turns, to
compare the two in one call (steps/s, hills/s and the device launches of
one 10k hill step; medians and ranges).
``python3 chip_smoke.py --ab-kernels OTHER`` compares the kernels the same
way: the device time per launch of every entry of the ``kernels`` line,
from the profile of a stride cycle of each MD path (and of the exact and
the typed path at 100k), of a deposition round on each route and of the
Threefry kernels on the 2-D, blocked and dense hosts (``time_threefry``,
with the device launches of a 2-D step and of its draws and those hosts'
steps/s), one process per run, medians and ranges printed;
``--ab-kernels OTHER threefry`` times the Threefry kernels alone,
``--ab-kernels OTHER cells`` the force kernels on the 10k paths and the
100k exact cell alone.  Both checkouts must name their device functions
as ``PORT_KERNELS`` does.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np

N_ATOMS = 10000  # the bench's 10k cell
BIG_N = 100000  # bench.py:378-382's 100k cell, the north-star scale
# the MD paths: the bench's default force path with each lookup, and the
# other force paths (no kernel_cap: the JAX host allows it only on the
# default path, untyped)
PATHS = {
    "interp": dict(),
    "chebyshev": dict(pair_lookup="chebyshev"),
    "newton": dict(use_pallas="newton"),
    "full": dict(pair_lookup="chebyshev", use_pallas="full", with_ids=True),
    "typed": dict(typed=True),
}
TYPE_PAIR = (1, 2)
FORCE_REL = 2e-5  # kernel vs plain: |df| <= 2e-5 * max(1, max|f|)
ENERGY_RTOL = 1e-5
CHEB = dict(cheb_deg=16, cheb_panels=4)  # the bench's Chebyshev table
# the H100 SXM's published peaks (NVIDIA data sheet): f32 outside the
# tensor cores, and HBM3
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# operations per pair, counted from csrc/cellforce.cu.  Every occupied pair:
# the minimum-image r^2.  A pair within reach of the LJ cutoff or the table
# (beyond it the terms are exact zeros): r^2, r, LJ, the force and its row
# and credit sums; the Hermite lookup; the Chebyshev set-up and 3 per
# Clenshaw step (a second chain on energy)
R2_FLOPS, PAIR_FLOPS, HERMITE_FLOPS, CHEB_FLOPS, STEP_FLOPS = 23, 48, 16, 15, 3
# operations per grid point and hill, counted from csrc/deposit.cu: the
# minimum-image distance and support test, then the terms in the support
DIST_FLOPS, HILL_FLOPS = 9, 10
# the device functions of csrc/*.cu, as the profiler names them, by wrapper:
# the row pass and its credit pass (K1, K6, K7), K2's two passes, the
# deposition's
ROW_FUNCS, K2_FUNCS, DEPOSIT_FUNCS, TF_FUNCS = ("k1_", "k7_"), ("k2_",), ("dep_",), ("tf_",)
# the counter hash and pass 1 of the hill collections (csrc/hashrng.cu): each
# wrapper's module under edm_tpu_torch/ops and its device function
HASH_KERNELS = {"uniform_rows_cols": ("hashrng", ("hash_uniforms",)),
                "normal_rows_cols": ("hashrng", ("hash_normals",)),
                "p1_counts_half": ("collect", ("p1_count_half",)),
                "p1_counts_typed": ("collect", ("p1_count_typed",))}
PORT_KERNELS = ROW_FUNCS + K2_FUNCS + DEPOSIT_FUNCS + TF_FUNCS + ("hash_", "p1_")
# operations counted from csrc/hashrng.cu: a hash, 12 integer operations (at
# half the f32 rate); its uniform, the conversion and the scale; a normal's
# Box-Muller, 7 more (each libm call counted as one); a pair's minimum-image
# r^2 and its test in pass 1 (per axis a subtraction, the division, rint, a
# product, a subtraction and the square; two sums, one comparison)
HASH_INT_OPS, UNIFORM_FLOPS, BOX_MULLER_FLOPS = 12, 2, 7
# operations counted from csrc/threefry.cu: a Threefry-2x32 block
# (tf_block), 20 rounds of an add, a rotation (one funnel shift) and an xor
# plus six key injections of two adds, 72 integer operations; a key's
# schedule (tf_key: the parity word, two xors, and the five counter sums)
# 7 more, once a key; the mantissa trick, 3 integer operations (xor,
# shift, or; float32) and the subtraction; a normal past its uniform, the
# product, the sum, the max, erfinv (a libm call, counted as one) and the
# product by sqrt(2)
TF_BLOCK_INT_OPS, TF_KEY_INT_OPS, TF_MANTISSA_INT_OPS = 72, 7, 3
TF_UNIFORM_FLOPS, TF_NORMAL_FLOPS = 1, 5
# pass 1's r^2 a pair: 3 subtractions, 3 |d| <= L/4 tests, 3 squares, 2
# adds, the bmax test; a component across a periodic face adds its image
# (a division, rint, a product and a subtraction)
P1_PAIR_FLOPS, P1_WRAP_FLOPS = 12, 4


def card_lines() -> list:
    """Each card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()


def card_line() -> str:
    """The first card's name and power limit, and the machine's card count
    (each card's line where they differ)."""
    lines = card_lines()
    if len(set(lines)) == 1:
        return f"{lines[0]} ({len(lines)} card{'s' if len(lines) > 1 else ''})"
    return "; ".join(f"card {i}: {line}" for i, line in enumerate(lines))


def bench_types(n_atoms=None):
    """The binary mixture of tests/test_md.py's type test: every other atom
    type 2, the rest type 1 (``n_atoms`` atoms, default ``N_ATOMS``)."""
    return np.where(np.arange(n_atoms or N_ATOMS) % 2 == 0, 2, 1).astype(np.int32)


def bench_bias(torch, device, box_high=3.0):
    """bench_pairwise's well-tempered, RDF-targeted pair bias on its
    151-point grid (``box_high`` 3.0; the dense liquid's 4.0: 201 points):
    ``bias.subdivide`` with the target ``-2 ln max(r, 0.5)``; returns
    (params, bias_state)."""
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.grid import Grid, GridSpec
    from edm_tpu_torch.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
        f"hill_density 250\ndimension 1\nbox_low 0\nbox_high {box_high}\n"
        "bias_spacing 0.02\nbias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [box_high], [0.02], [False])
    r_pts = np.arange(tspec.nbins[0]) * tspec.dx[0] + tspec.min[0]
    target = Grid(values=torch.tensor(-2.0 * np.log(np.maximum(r_pts, 0.5)),
                                      dtype=torch.float32, device=device),
                  derivs=None, spec=tspec, interpolate=False)
    return B.subdivide(cfg, 1.0, 1.0, [0], [box_high], [0], [box_high], [False], [0],
                       dtype=torch.float32, device=device, target=target)


def edge_lattice():
    """The edge lattice of pass 1: (positions (n, 3), box, cap, types) on
    5 x 3 x 5 cells of edge 3 (the CV's bmax) and cap 8.  Cells (0, 0, 0)
    and (4, 2, 4) are full (8 atoms each, the second a neighbour of the
    first across all three periodic faces), most cells are empty, and the
    pairs in between put a component of the displacement at -L/4 (x, 15
    wide), +-L/4 and +-L/2 (y, 9 wide: there L/4 < bmax) and r^2 at bmax^2
    exactly, just below it and just above it."""
    full = np.stack(np.meshgrid(*[[0.75, 2.25]] * 3, indexing="ij"), -1).reshape(-1, 3)
    corner = np.stack(np.meshgrid([12.5, 14.5], [6.5, 8.5], [12.5, 14.5], indexing="ij"),
                      -1).reshape(-1, 3)
    pairs = [
        (6.25, 4.0, 7.0), (10.0, 4.0, 7.0),  # dx = -L/4
        (7.0, 4.0, 1.0), (7.0, 6.25, 1.0),  # dy = -L/4, within bmax
        (8.9, 4.0, 10.0), (9.1, 1.75, 10.0),  # dy = +L/4 on the (1, -1, 0) face
        (7.0, 7.25, 4.0), (7.0, 0.5, 4.0),  # dy = -L/4 across the periodic face
        (1.0, 4.0, 7.0), (1.0, 8.5, 7.0),  # dy = -L/2
        (4.0, 7.0, 10.0), (4.0, 2.5, 10.0),  # dy = +L/2 across the periodic face
        (10.0, 1.0, 1.0), (10.0, 4.0, 1.0),  # r^2 = bmax^2 = 9
        (4.0, 4.5, 4.0), (5.0, 6.5, 6.0),  # r^2 = 1 + 4 + 4 = bmax^2
        (10.0, 1.0, 13.0), (10.0, 3.9999998, 13.0),  # r^2 just below bmax^2 (float32)
        (10.0, 4.0000005, 13.0),  # and just above it
    ]
    pts = np.concatenate([full, corner, np.array(pairs)])
    return pts, [15.0, 9.0, 15.0], 8, bench_types(len(pts))


def dense_lattice(cap, seed=0):
    """A lattice for pass 1 at large cell caps: (positions (n, 3), box, cap,
    types) on 3 x 3 x 3 cells of edge 3.1 (just above the CV's bmax),
    cell 0 full (``cap`` atoms), the last cell empty and each other cell
    holding between cap / 2 and cap - 1 atoms, uniform inside it (0.1% of
    the edge clear of its faces, so each atom's cell is certain)."""
    rng = np.random.default_rng(seed)
    edge = 3.1
    counts = rng.integers(cap // 2, cap, 27)
    counts[0], counts[-1] = cap, 0
    lo = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3) * edge
    pts = np.concatenate([lo[c] + rng.uniform(0.001, 0.999, (k, 3)) * edge
                          for c, k in enumerate(counts)])
    return pts, [3 * edge] * 3, cap, bench_types(len(pts))


def cap_lattice(cap, seed=0):
    """``dense_lattice``'s cells and occupancies (3 x 3 x 3 cells of edge
    3.1, cell 0 full at ``cap``, the last empty, the others cap / 2 to cap -
    1), the atoms on a jittered sub-lattice of each cell (m^3 >= cap sites,
    a random subset, each moved by up to 0.15 of the spacing), so no two
    atoms come closer than 0.7 of the spacing and LJ stays finite in float32:
    the force kernels' large-cap states.  (positions, box, cap, types)."""
    rng = np.random.default_rng(seed)
    edge = 3.1
    m = int(np.ceil(cap ** (1 / 3) - 1e-9))
    a = edge / m
    sites = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"), -1).reshape(-1, 3) + 0.5) * a
    counts = rng.integers(cap // 2, cap, 27)
    counts[0], counts[-1] = cap, 0
    lo = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"), -1).reshape(-1, 3) * edge
    pts = np.concatenate([lo[c] + sites[rng.choice(len(sites), k, replace=False)]
                          + rng.uniform(-0.15, 0.15, (k, 3)) * a for c, k in enumerate(counts)])
    return pts, [3 * edge] * 3, cap, bench_types(len(pts))


def lattice_state(torch, device, pts, box, cap, **kw):
    """The cell state of ``pts`` in ``box`` on cells of the CV's bmax (3.0)
    and slot cap ``cap``, with bench_bias (``kw``: ``init_cell_state``'s
    options): (spec, state)."""
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.cells import CellSpec
    from edm_tpu_torch.models.pair_edm_cells import init_cell_state
    from edm_tpu_torch.ops.prng import PRNGKey

    _, bias_state = bench_bias(torch, device)
    core = pair_edm.init_state(bias_state, torch.tensor(pts, dtype=torch.float32, device=device),
                               PRNGKey(0))
    spec = CellSpec.create(box, cutoff=3.0, n_atoms=len(pts), cap=cap)
    return spec, init_cell_state(spec, core, **kw)


def bench_lattice(n_atoms):
    """bench_pairwise's LJ fluid at density ~0.5: the first ``n_atoms``
    sites of a cubic lattice (a = 1.26) and its periodic box."""
    side = int(np.ceil(n_atoms ** (1 / 3)))
    a = 1.26
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
           .reshape(-1, 3)[:n_atoms] * a + 0.5 * a)
    return pts, [side * a] * 3


def bench_setup(torch, kT: float, device, path="interp", dynamic=False, mesh=None,
                n_atoms=None, **extra):
    """The bench_pairwise configuration at ``n_atoms`` atoms (default
    ``N_ATOMS``), built through the port's entry
    points: bias.subdivide -> pair_edm.init_state -> CellSpec.create ->
    init_cell_state, and the three static phase steps of ``path``
    (``PATHS``, or "xla": the XLA force pass, ``use_pallas=False``, at full
    cap); with ``dynamic``, a fourth step: the same host with every
    ``static_do_*`` None (the JAX default, which ``run_simulation`` drives)
    and ``collect_records=True``.  With a ``mesh``, the steps are this
    rank's of the slab host (``parallel.make_slab_cell_step``, ``extra``
    its options; on a 2-D or 3-D mesh the brick host's,
    ``parallel.make_brick_cell_step``)."""
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.cells import CellSpec
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.parallel import make_brick_cell_step, make_slab_cell_step

    sharded = make_slab_cell_step if mesh is None or mesh.devices.ndim == 1 else (
        make_brick_cell_step)
    build = make_cell_step if mesh is None else (
        lambda *a, **kw: sharded(*a, mesh=mesh, **kw, **extra))
    opts = dict(use_pallas=False) if path == "xla" else PATHS[path]
    n_atoms = n_atoms or N_ATOMS
    params, bias_state = bench_bias(torch, device)
    pts, box = bench_lattice(n_atoms)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    core = pair_edm.init_state(bias_state, torch.tensor(pts, dtype=torch.float32,
                                                        device=device),
                               PRNGKey(0), n_est=n_atoms * 40,
                               pair_lookup=opts.get("pair_lookup", "interp"), **CHEB)
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=n_atoms)
    kw = dict(hill_stride=10, rebuild_stride=10, hill_capacity=2048, cell_chunk=81,
              use_pallas=True, energy_stride=10)
    st_kw = dict(with_ids=opts.get("with_ids", False))
    if "use_pallas" in opts:
        kw["use_pallas"] = opts["use_pallas"]
    elif opts.get("typed"):
        kw.update(types=bench_types(n_atoms), type_pair=TYPE_PAIR)
        st_kw["types"] = bench_types(n_atoms)
    else:
        kw.update(kernel_cap=24, overflow_cap=32)
        st_kw.update(kernel_cap=24, overflow_cap=32)
    state = init_cell_state(spec, core, **st_kw)
    steps = [
        build(params, lp, lj, spec, static_do_hills=h, static_do_energy=e,
              static_do_rebuild=r, **kw)
        for h, e, r in ((True, True, False), (False, False, False), (False, False, True))
    ]
    if dynamic:
        steps.append(build(params, lp, lj, spec, collect_records=True, **kw))
    return spec, state, steps


def pattern(steps):
    return [(steps[0], 1), (steps[1], 8), (steps[2], 1)]


FORCE_KERNELS = ("cell_force_newton", "overflow_force", "cell_force_newton_planar",
                 "cell_force_full")


def hash_module(name):
    """The module of ``edm_tpu_torch.ops`` that holds the wrapper ``name``
    of ``HASH_KERNELS``."""
    import importlib

    return importlib.import_module("edm_tpu_torch.ops." + HASH_KERNELS[name][0])


def port_wrappers():
    """{name: wrapper} of the force kernels and the counter-hash and pass-1
    kernels (a checkout without the latter, in ``--ab-kernels``, has the
    former only)."""
    from edm_tpu_torch.ops import cellforce as CF

    out = {name: getattr(CF, name) for name in FORCE_KERNELS}
    for name in HASH_KERNELS:
        try:
            fn = getattr(hash_module(name), name)
        except (ImportError, AttributeError):
            continue
        if hasattr(fn, "launches"):
            out[name] = fn
    return out


def wrapper_funcs(name):
    """The device functions of a wrapper of ``port_wrappers``, as the
    profiler names them (prefixes)."""
    if name in HASH_KERNELS:
        return HASH_KERNELS[name][1]
    return K2_FUNCS if name == "overflow_force" else ROW_FUNCS


@contextlib.contextmanager
def plain_hash():
    """Route the cell host's counter-hash draws and pass 1 through their
    plain versions (``*_ref``)."""
    from edm_tpu_torch.models import pair_edm_cells as PC

    saved = {name: getattr(PC, name) for name in HASH_KERNELS}
    for name in HASH_KERNELS:
        setattr(PC, name, getattr(hash_module(name), name + "_ref"))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(PC, name, fn)


@contextlib.contextmanager
def plain_versions():
    """Route the host's force pass, its counter-hash draws and pass 1 through
    the kernels' plain versions."""
    from edm_tpu_torch.models import pair_edm_cells as PC
    from edm_tpu_torch.ops import cellforce as CF

    saved = {name: getattr(PC, name) for name in FORCE_KERNELS}
    for name in FORCE_KERNELS:
        setattr(PC, name, getattr(CF, name + "_ref"))
    try:
        with plain_hash():
            yield
    finally:
        for name, fn in saved.items():
            setattr(PC, name, fn)


def cuda_ms(torch, fn, reps=50, warm=5) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


PROFILE_PAD_S = 0.05


def device_time_us(torch, fn, n):
    """Device time per call of ``fn`` (kernels and copies, µs), from
    ``torch.profiler`` over n calls after one warm-up; the same per kernel
    name; as text, the three kernels that take most of it, then each of the
    port's; and the device launches (kernels and copies) per call.  0 when
    the profiler saw no device activity.  The calls run ``PROFILE_PAD_S``
    inside each end of the profile's window: the profiler keeps only
    device activity whose timestamps fall in the window, and the card's
    clock has run up to 8 ms behind the host's (kineto's "GPU op timestamp
    < runtime timestamp"), which emptied the profiles of short calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    per, count = {}, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            count += 1
            name = e.name.replace("(anonymous namespace)::", "").split(" (")[0]
            name = name.split("(")[0].removeprefix("void ")
            if "::" in name:  # a PyTorch kernel: its bare name
                name = name.split("<")[0].split("::")[-1]
            per[name] = per.get(name, 0.0) + e.time_range.elapsed_us() / n
    ranked = sorted(per.items(), key=lambda kv: -kv[1])
    ours = [kv for kv in ranked if kv[0].startswith(PORT_KERNELS)]
    return sum(per.values()), per, "; ".join(
        ", ".join(f"{k} {v:.1f}" for k, v in kvs) for kvs in (ranked[:3], ours)), count / n


def funcs_ms(per_us, funcs, launches=1.0) -> float:
    """Device ms per launch of a wrapper: the profile's time per call of its
    device functions (every pass), over its launches per call."""
    return sum(v for k, v in per_us.items() if k.startswith(funcs)) / launches / 1e3


def cycle_device_ms(torch, cycle, state):
    """Profile of one stride cycle (two, after a warm-up one) from ``state``:
    (device µs per cycle, the text of ``device_time_us``, {wrapper: device
    ms per launch} for each wrapper of ``port_wrappers`` the cycle
    launched).  A path runs one of the row-pass wrappers, so the row pass's
    functions are its."""
    wrappers = port_wrappers()
    n0 = {name: w.launches for name, w in wrappers.items()}
    dev_us, per, top, _ = device_time_us(torch, lambda: cycle(state), 2)
    ms = {}
    for name, w in wrappers.items():
        n = (w.launches - n0[name]) / 3  # the warm-up cycle launched too
        if n > 0:
            ms[name] = funcs_ms(per, wrapper_funcs(name), n)
    return dev_us, top, ms


def busy_line(what, dev_us, wall_us, kernels, measured=True) -> str:
    share = f"{dev_us / wall_us:.1%}" if measured and dev_us > 0 else "not measured"
    return (f"{what}: device busy {dev_us:.1f} us of {wall_us:.1f} us wall ({share}); "
            f"top kernels; the port's kernels (us): {kernels}")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def check_forces(what, f, f_ref):
    scale = max(1.0, float(f_ref.abs().max()))
    err = max_err(f, f_ref)
    if not err <= FORCE_REL * scale:
        raise AssertionError(f"{what}: max |df| {err:.3e} > {FORCE_REL} * {scale:.3e}")
    return err


def check_energy(what, e, e_ref):
    e, e_ref = float(e), float(e_ref)
    if not abs(e - e_ref) <= ENERGY_RTOL * max(1.0, abs(e_ref)):
        raise AssertionError(f"{what}: energy {e!r} vs plain {e_ref!r}")


def bound(flops: float, nbytes: float):
    """The card's least time for the work, in ms, and what sets it: the
    operations over the f32 peak or the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def lookup_flops(table, energy: bool) -> int:
    from edm_tpu_torch.ops.chebyshev import ChebTable

    if isinstance(table, ChebTable):
        return CHEB_FLOPS + STEP_FLOPS * table.deg * (2 if energy else 1)
    return HERMITE_FLOPS


def table_bytes(table) -> int:
    from edm_tpu_torch.ops.chebyshev import ChebTable

    if isinstance(table, ChebTable):
        return 4 * (table.cval.numel() + table.cder.numel())
    return 4 * table.tab.numel()


def reach(table, lj) -> float:
    """The distance beyond which a pair contributes exact zeros: past the LJ
    cutoff and past the table's upper edge (Chebyshev hi; Hermite the lower
    of the grid's and the boundary's)."""
    from edm_tpu_torch.ops.chebyshev import ChebTable

    hi = table.hi if isinstance(table, ChebTable) else min(table.geom[3], table.geom[5])
    return max(float(lj.rcut), float(hi))


def pair_counts(spec, xs, mc, k, far, ts=None, rows=None, mc_rows=None):
    """The work a force pass over slots < k needs on this state, each
    unordered pair once (forces are antisymmetric, the value symmetric): the
    pairs within a cell and those with its 13 half-stencil neighbours, which
    with 3 or more cells per dimension are the 27-stencil's pairs.  Returns
    (occupied pairs: each needs its minimum-image r^2; those with r <= far:
    the only ones that need the pair arithmetic; those of them on the CV's
    type pair: the only ones that need the lookup, all of them with ``ts``
    None).  ``rows`` (R,): K1's owned-row form, only those cells are rows,
    their own slots masked by ``mc_rows`` (R, cap) and the neighbours' by
    ``mc``."""
    import torch

    from edm_tpu_torch.ops.cellforce import half_neighbors, type_pair_mask

    C = int(np.prod(spec.ncells))
    nbr = half_neighbors(tuple(spec.ncells), mc.device)
    if rows is None:
        rows, mc_rows = torch.arange(C, device=mc.device), mc[:C]
    L = torch.tensor(spec.box, dtype=torch.float64, device=xs.device)
    out = np.zeros(3)
    step = max(1, int(5e7 // (14 * k * k)))  # row cells a chunk: ~5e7 pairs
    for r0 in range(0, rows.shape[0], step):
        rr = rows[r0:r0 + step]
        nb = nbr[rr]

        def window(plane, own):  # (Cg, cap, ...) -> each row cell's 14k candidates, own first
            return torch.cat([own[:, :k], plane[nb][:, :, :k].flatten(1, 2)], 1)

        occ_w = window(mc, mc_rows[r0:r0 + step]) > 0.5
        ok = occ_w[:, :k, None] & occ_w[:, None, :]
        ok[:, :, :k] &= torch.ones(k, k, dtype=torch.bool, device=mc.device).triu(1)
        xw = window(xs, xs[rr]).double()
        d = xw[:, :k, None] - xw[:, None, :]
        d = d - torch.round(d / L) * L
        near = ok & ((d * d).sum(-1) <= far * far)
        cv = near
        if ts is not None:
            tw = window(ts, ts[rr])
            cv = near & type_pair_mask(tw[:, :k, None], tw[:, None, :], TYPE_PAIR)
        out += [float(ok.sum()), float(near.sum()), float(cv.sum())]
    return tuple(float(v) for v in out)


def pair_flops(counts, table, energy: bool) -> float:
    pairs, near, cv = counts
    return pairs * R2_FLOPS + near * (PAIR_FLOPS - R2_FLOPS) + cv * lookup_flops(table, energy)


def half_work(spec, xs, mc, table, lj, k, energy, ts=None, credits_out=False):
    """K1's least time (K6's with ``credits_out``): ``pair_counts`` of this
    state and the inputs and outputs read and written once."""
    flops = pair_flops(pair_counts(spec, xs, mc, k, reach(table, lj), ts), table, energy)
    Cg, cap = mc.shape
    outs = Cg * cap * 3 + Cg * k + (Cg * 13 * k * 3 if credits_out else 0)
    ins = Cg * cap * (5 if ts is not None else 4)
    return bound(flops, 4 * (ins + outs) + table_bytes(table))


def full_work(spec, xs, mc, table, lj):
    """K7's least time: the pairs of K1 at full cap, each unordered pair
    once as K7's function needs it, with the value chain; xs, mc and sid
    read, forces and eb written once."""
    counts = pair_counts(spec, xs, mc, mc.shape[1], reach(table, lj))
    Cg, cap = mc.shape
    return bound(pair_flops(counts, table, True),
                 4 * (Cg * cap * 5 + Cg * cap * 4) + table_bytes(table))


def k2_work(xo, xp, table, lj, box, energy):
    """K2's least time: occupied tail rows against occupied partners, plus
    the tail-tail block as the function defines it (rows with ``own``
    against occupied rows, both orders, the diagonal out); every such pair
    its r^2, the pair arithmetic and the lookup only for those within
    ``reach``."""
    import torch

    far = reach(table, lj)
    L = torch.tensor(box, dtype=torch.float64, device=xo.device)
    rows_ok = xo[3] > 0.5

    def counts(cols, ok):  # (pairs, those within reach) of the tail rows with ``cols``
        d = xo[:3].T.double()[:, None] - cols[:3].T.double()[None]
        d = d - torch.round(d / L) * L
        return float(ok.sum()), float((ok & ((d * d).sum(-1) <= far * far)).sum())

    O, N = xo.shape[1], xp.shape[1]
    p_low, n_low = counts(xp, rows_ok[:, None] & (xp[3] > 0.5)[None])
    not_self = ~torch.eye(O, dtype=torch.bool, device=xo.device)
    p_tail, n_tail = counts(xo, (xo[4] > 0.5)[:, None] & rows_ok[None] & not_self)
    near = n_low + n_tail
    nbytes = 4 * (5 * O + 4 * N + 4 * O + 3 * N) + table_bytes(table)
    return bound(pair_flops((p_low + p_tail, near, near), table, energy), nbytes)


def kernel_phase(torch, device, pair_lookup="interp"):
    """K1/K2 against their plain versions on the 10k bench state after one
    hill step, at k = 24 and 32 (energy off and on) and K2 on the live tail.
    With the Chebyshev lookup: the carried bench table (4 panels, degree
    16) and a single-panel degree-64 table fitted to the same grid."""
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops.chebyshev import fit_gauss_grid

    spec, state, steps = bench_setup(torch, 0.8, device, pair_lookup)
    step = steps[0]
    # a state with real forces and a live bias table: one hill step
    state, _ = step(state)
    if pair_lookup == "interp":
        tables = {"hermite": CF.hermite_pair_table(state.core.bias.bias)}
    else:
        tables = {"cheb P=4 deg=16": state.core.cheb,
                  "cheb P=1 deg=64": fit_gauss_grid(state.core.bias.bias, 64, 1)}
    rows = k1k2_rows(torch, spec, state, step, tables)
    print_rows(rows)
    return rows


def k1k2_rows(torch, spec, state, step, tables, ks=(24, 32), tag=""):
    """K1 at each k of ``ks`` (energy off and on) and K2 on the state's live
    tail (energy off and on) against their plain versions on ``state``,
    with each of ``tables``: {row name: (max |diff|, kernel ms, plain ms,
    bound ms, what bounds it)}; ``tag`` follows the wrapper's name in the
    row names."""
    from edm_tpu_torch.ops import cellforce as CF

    xs, mc = state.xs, state.mc
    xo, xp = step._overflow_inputs(state, xs)
    n_tail = int((xo[3] > 0.5).sum())
    if n_tail == 0:
        raise AssertionError("K2 check needs a real tail: the bench state has none")
    rows = {}
    for tname, tbl in tables.items():
        for k in ks:
            for energy in (False, True):
                kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=step.lj, energy=energy)
                f, eb = CF.cell_force_newton(xs, mc, tbl, **kw)
                f_ref, eb_ref = CF.cell_force_newton_ref(xs, mc, tbl, **kw)
                torch.cuda.synchronize()
                what = f"cell_force_newton{tag} {tname} k={k} energy={int(energy)}"
                err = check_forces(what, f, f_ref)
                check_energy(what, eb.sum(), eb_ref.sum())
                ms = cuda_ms(torch, lambda: CF.cell_force_newton(xs, mc, tbl, **kw))
                plain = cuda_ms(torch, lambda: CF.cell_force_newton_ref(xs, mc, tbl, **kw),
                                reps=10)
                rows[what] = (err, ms, plain) + half_work(spec, xs, mc, tbl, step.lj, k, energy)
        for energy in (False, True):
            kw = dict(box=spec.box, lj=step.lj, energy=energy)
            fo, fp = CF.overflow_force(xo, xp, tbl, **kw)
            fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tbl, **kw)
            torch.cuda.synchronize()
            what = f"overflow_force{tag} {tname} tail={n_tail} energy={int(energy)}"
            err = max(check_forces(what + " fo", fo[:3], fo_ref[:3]),
                      check_forces(what + " fp", fp, fp_ref))
            check_energy(what, fo[3].sum(), fo_ref[3].sum())
            ms = cuda_ms(torch, lambda: CF.overflow_force(xo, xp, tbl, **kw))
            plain = cuda_ms(torch, lambda: CF.overflow_force_ref(xo, xp, tbl, **kw), reps=10)
            rows[what] = (err, ms, plain) + k2_work(xo, xp, tbl, step.lj, spec.box, energy)
    return rows


def check_near_f64(what, a, a_ref, a64, rel):
    """|a - a_ref| within ``f32_error_bound(a_ref, a64, rel)``, the plain
    version's result held against its float64 evaluation ``a64``: the
    single-panel degree-64 table is ill-conditioned in float32."""
    from edm_tpu_torch.ops.chebyshev import f32_error_bound

    err, tol = max_err(a, a_ref), f32_error_bound(a_ref, a64, rel)
    if not err <= tol:
        raise AssertionError(f"{what}: max |diff| {err:.3e} > {tol:.3e}")
    return err


def legacy_kernel_phase(torch, device):
    """K6 (both lookups, typed and untyped), typed K1 at full cap and K7
    (the bench table, and one panel of degree 64) against their plain
    versions, on the 10k bench state after one hill step rebuilt with slot
    ids and the binary types."""
    import dataclasses

    from edm_tpu_torch.models.pair_edm_cells import atom_positions, init_cell_state
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops.chebyshev import fit_gauss_grid

    spec, state, steps = bench_setup(torch, 0.8, device)
    state, _ = steps[0](state)
    core = dataclasses.replace(state.core, x=atom_positions(spec, state))
    st = init_cell_state(spec, core, with_ids=True,
                         types=torch.as_tensor(bench_types(), device=device))
    grid = state.core.bias.bias
    tables = {"hermite": CF.hermite_pair_table(grid), "cheb P=4 deg=16": fit_gauss_grid(grid, 16, 4)}
    xs, mc, ts, lj, cap = st.xs, st.mc, st.ts, steps[0].lj, spec.cap
    geo = dict(ncells=spec.ncells, box=spec.box, lj=lj)
    rows = {}
    for tname, tbl in tables.items():
        for typed in (False, True):
            for energy in (False, True):
                kw = dict(geo, energy=energy, ts=ts if typed else None,
                          type_pair=TYPE_PAIR if typed else None)
                f, cred, eb = CF.cell_force_newton_planar(xs, mc, tbl, **kw)
                f_ref, cred_ref, eb_ref = CF.cell_force_newton_planar_ref(xs, mc, tbl, **kw)
                torch.cuda.synchronize()
                what = f"cell_force_newton_planar {tname} typed={int(typed)} energy={int(energy)}"
                err = max(check_forces(what, f, f_ref),
                          check_forces(what + " credits", cred, cred_ref))
                check_energy(what, eb.sum(), eb_ref.sum())
                ms = cuda_ms(torch, lambda: CF.cell_force_newton_planar(xs, mc, tbl, **kw))
                plain = cuda_ms(torch, lambda: CF.cell_force_newton_planar_ref(xs, mc, tbl, **kw),
                                reps=10)
                rows[what] = (err, ms, plain) + half_work(spec, xs, mc, tbl, lj, cap, energy,
                                                          kw["ts"], credits_out=True)
    for tname, tbl in tables.items():
        for energy in (False, True):
            kw = dict(geo, k=cap, energy=energy, ts=ts, type_pair=TYPE_PAIR)
            f, eb = CF.cell_force_newton(xs, mc, tbl, **kw)
            f_ref, eb_ref = CF.cell_force_newton_ref(xs, mc, tbl, **kw)
            f0, _ = CF.cell_force_newton(xs, mc, tbl, **dict(kw, ts=None, type_pair=None))
            torch.cuda.synchronize()
            what = f"cell_force_newton[typed] {tname} k={cap} energy={int(energy)}"
            err = check_forces(what, f, f_ref)
            check_energy(what, eb.sum(), eb_ref.sum())
            if not max_err(f, f0) > 1e-3 * float(f0.abs().max()):
                raise AssertionError(f"{what}: the type mask changed no force")
            ms = cuda_ms(torch, lambda: CF.cell_force_newton(xs, mc, tbl, **kw))
            plain = cuda_ms(torch, lambda: CF.cell_force_newton_ref(xs, mc, tbl, **kw), reps=10)
            rows[what] = (err, ms, plain) + half_work(spec, xs, mc, tbl, lj, cap, energy, ts)
    for tname, tbl in (("P=4 deg=16", tables["cheb P=4 deg=16"]),
                       ("P=1 deg=64", fit_gauss_grid(grid, 64, 1))):
        f, eb = CF.cell_force_full(xs, mc, st.sid, tbl, **geo)
        f_ref, eb_ref = CF.cell_force_full_ref(xs, mc, st.sid, tbl, **geo)
        t64 = dataclasses.replace(tbl, cval=tbl.cval.double(), cder=tbl.cder.double())
        f64, eb64 = CF.cell_force_full_ref(xs.double(), mc.double(), st.sid.double(), t64, **geo)
        torch.cuda.synchronize()
        what = f"cell_force_full cheb {tname} cap={cap}"
        err = check_near_f64(what, f, f_ref, f64, FORCE_REL)
        check_near_f64(what + " energy", eb.sum(), eb_ref.sum(), eb64.sum(), ENERGY_RTOL)
        ms = cuda_ms(torch, lambda: CF.cell_force_full(xs, mc, st.sid, tbl, **geo))
        plain = cuda_ms(torch, lambda: CF.cell_force_full_ref(xs, mc, st.sid, tbl, **geo), reps=10)
        rows[what] = (err, ms, plain) + full_work(spec, xs, mc, tbl, lj)
    print_rows(rows)
    return rows


def print_rows(rows):
    print("kernel vs plain version (CUDA events, ms per call; bound = the card's least time):")
    for name, (err, ms, plain, bms, by) in rows.items():
        print(f"  {name:60s} max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain:.4f} ms"
              f"  bound {bms:.5f} ms ({by})")


def check_slot_forces(torch, what, f, f_ref, xs, mc, box, table):
    """``check_forces``, except that with a Chebyshev table an atom with a
    pair near a table edge (``ChebTable.near_edge``) may differ by up to the
    table's largest jump of dV/dr at an edge (``ChebTable.edge_jump``): its
    distance, off by an ulp, can fall on either side.  Returns the atoms it
    let through."""
    from edm_tpu_torch.ops.chebyshev import ChebTable

    scale = max(1.0, float(f_ref.abs().max()))
    err = (f.double() - f_ref.double()).abs().amax(-1).reshape(-1)
    if float(err.max()) <= FORCE_REL * scale or not isinstance(table, ChebTable):
        return check_forces(what, f, f_ref), 0
    jump = table.edge_jump()
    x = xs.reshape(-1, 3).double()
    occ = mc.reshape(-1) > 0.5
    L = torch.tensor(box, dtype=torch.float64, device=xs.device)
    slots = torch.nonzero(err > FORCE_REL * scale).reshape(-1).tolist()
    for s in slots:
        d = x[occ] - x[s]
        nr = table.near_edge((d - torch.round(d / L) * L).norm(dim=1))
        if not (nr and float(err[s]) <= FORCE_REL * scale + jump):
            raise AssertionError(f"{what}: slot {s} off by {float(err[s]):.3e} "
                                 f"(bound {FORCE_REL * scale:.3e}; near a table edge: {nr})")
    return float(err.max()), len(slots)


def states_match(torch, ks, ps, i, box, table):
    """Step-for-step check of a kernel-run state against the plain run;
    returns the number of atoms whose forces needed the table-edge
    allowance of ``check_slot_forces``."""
    for name in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow",
                 "ts", "sid"):
        a, b = getattr(ks, name), getattr(ps, name)
        if a is None and b is None:  # a field this path does not carry
            continue
        if a is None or b is None or not bool((a == b).all()):
            raise AssertionError(f"step {i}: {name} differs from the plain run")
    for name in ("step", "last_calls", "hills_truncated"):
        if not bool((getattr(ks.core, name) == getattr(ps.core, name)).all()):
            raise AssertionError(f"step {i}: core.{name} differs from the plain run")
    if ks.tail_ovf_host != ps.tail_ovf_host:
        raise AssertionError(f"step {i}: tail_ovf_host differs")
    for name in ("xs", "vs"):
        check_forces(f"step {i} {name}", getattr(ks, name), getattr(ps, name))
    _, n_edge = check_slot_forces(torch, f"step {i} fs", ks.fs, ps.fs, ks.xs, ks.mc, box, table)
    check_energy(f"step {i} energy", ks.core.energy, ps.core.energy)
    kb, pb = ks.core.bias, ps.core.bias
    if not abs(float(kb.cum_bias) - float(pb.cum_bias)) <= 1e-6 * abs(float(pb.cum_bias)):
        raise AssertionError(f"step {i}: cum_bias {float(kb.cum_bias)} vs {float(pb.cum_bias)}")
    gv, pv = kb.bias.grid.values, pb.bias.grid.values
    if not max_err(gv, pv) <= 1e-5 * max(1.0, float(pv.abs().max())):
        raise AssertionError(f"step {i}: bias grid differs from the plain run")
    if ks.core.cheb is not None:  # the refit table
        for name in ("cval", "cder"):
            a, b = getattr(ks.core.cheb, name), getattr(ps.core.cheb, name)
            if not max_err(a, b) <= 1e-5 * max(1.0, float(b.abs().max())):
                raise AssertionError(f"step {i}: cheb.{name} differs from the plain run")
    return n_edge


def slice_zero_temperature(torch, device, path="interp", n_steps=20, n_atoms=None,
                           warm_steps=0):
    """20 steps at kT = 0 through the kernels; each step is also taken
    through the plain versions from the same input state and the two
    results are held to each other.  (Two free-running f32 trajectories
    part after ~15 steps at 10k atoms: a 1-ulp position difference can move
    a pair distance across a table node or edge.)  With ``warm_steps``, the
    steps start from the state of that many kT = 0.8 steps
    (``thermalized``).  Returns how many of the steps ran K2."""
    from edm_tpu_torch.ops import cellforce as CF

    spec, state, steps = bench_setup(torch, 0.0, device, path, n_atoms=n_atoms)
    if warm_steps:
        state = thermalized(torch, device, path, warm_steps, n_atoms)
    n_edge, k2 = 0, 0
    for i in range(n_steps):
        step = steps[0 if i % 10 == 0 else 2 if i % 10 == 9 else 1]
        table = state.core.cheb
        with plain_versions():
            plain, _ = step(state)
        k2_before = CF.overflow_force.launches
        state, _ = step(state)
        k2 += CF.overflow_force.launches > k2_before
        n_edge += states_match(torch, state, plain, i, spec.box, table)
    label = path if n_atoms is None else f"{path} N={n_atoms}"
    print(f"kT=0 {label}: {n_steps} steps through the kernels match the plain versions "
          f"step for step (same input state each step; {n_edge} atom(s) by a table-edge pair; "
          f"{k2} step(s) ran K2)")
    return k2


def sync_census(torch, steps, state):
    """One stride cycle under PyTorch's CUDA sync-debug mode: the number of
    operations that synchronized the host with the device, per phase
    (explicit flag reads and any implicit ones)."""
    counts = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        for name, (step, cnt) in zip(("hills", "plain", "rebuild"), pattern(steps)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for _ in range(cnt):
                    state, _ = step(state)
            counts[name] = sum("synchroniz" in str(w.message) for w in caught)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return state, counts


def slice_run(torch, device, path="interp", warm_steps=100, timed_steps=300, n_atoms=None):
    """The bench's kT = 0.8 run of ``path`` through the kernels: the launch
    counters are set to 0 just before it and read just after.  Returns
    {"rate": steps/s, "launches": the force, counter-hash and pass-1
    wrappers', "device_ms": device ms a launch of each, "dev_us": a stride
    cycle's device µs, "state", "steps"}."""
    from edm_tpu_torch.models.driver import pattern_segment

    spec, state, steps = bench_setup(torch, 0.8, device, path, n_atoms=n_atoms)
    label = path if n_atoms is None else f"{path} N={n_atoms}"
    calls = {}
    if path == "typed":  # one hill round, typed and untyped, from this state
        _, st_u, steps_u = bench_setup(torch, 0.8, device, n_atoms=n_atoms)
        calls = {"typed": int(steps[0](state)[0].core.last_calls),
                 "untyped": int(steps_u[0](st_u)[0].core.last_calls)}
    for s in steps:
        s.host_syncs = 0
    wrappers = port_wrappers()
    for w in wrappers.values():
        w.launches = 0
    state, e_warm = pattern_segment(pattern(steps), warm_steps)(state)
    torch.cuda.synchronize()
    warm_tail = (f"tail after warm-up {int(state.tail_count)} (fallback periods "
                 f"{int(state.tail_fallbacks)}), " if state.tail_count is not None else "")
    syncs0 = sum(s.host_syncs for s in steps)
    t0 = time.perf_counter()
    state, e = pattern_segment(pattern(steps), timed_steps)(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    syncs = sum(s.host_syncs for s in steps) - syncs0
    # device time of one stride cycle (two cycles from this state), beside
    # the timed run's wall time per cycle
    dev_us, top, device_ms = cycle_device_ms(torch, pattern_segment(pattern(steps), 10), state)
    print(busy_line(f"kT=0.8 {label} stride cycle", dev_us, 10 * dt / timed_steps * 1e6, top))
    if path == "interp":  # the device launches (kernels and copies) of one plain step
        _, _, _, n_plain = device_time_us(torch, lambda: steps[1](state), 2)
        print(f"device launches of a plain step, {label}: {n_plain:.1f}")
    state, census = sync_census(torch, steps, state)
    core = state.core
    n_steps = warm_steps + timed_steps
    finite = all(bool(torch.isfinite(t).all()) for t in (state.xs, state.vs, state.fs, e))
    checks = {
        "finite": finite,
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "cum_bias > 0": float(core.bias.cum_bias) > 0,
        "no sync on plain steps": census["plain"] == 0,
        "at most 5 syncs on hill steps": census["hills"] <= 5,
        # the counter hash and pass 1 on the card: the thermostat's normals
        # every step, pass 1 and pass 2's draws every hill step
        "hash_normals on every step": launches["normal_rows_cols"] == n_steps,
        "pass 1 kernel on every hill step": launches[
            "p1_counts_typed" if path == "typed" else "p1_counts_half"] == n_steps // 10,
        "hash_uniforms on every hill step": launches["uniform_rows_cols"] == n_steps // 10,
    }
    if path in ("interp", "chebyshev"):
        checks["K1 launched"] = launches["cell_force_newton"] > 0
        checks["K2 launched"] = launches["overflow_force"] > 0
    elif path == "newton":
        checks["K6 on every step, K1 never"] = (
            launches["cell_force_newton_planar"] == n_steps and launches["cell_force_newton"] == 0)
    elif path == "full":
        checks["K7 on every step"] = launches["cell_force_full"] == n_steps
        checks["slot ids carried"] = state.sid is not None
    elif path == "xla":
        checks["no force kernel launched (the XLA pass)"] = not any(
            launches[name] for name in FORCE_KERNELS)
    else:
        checks["typed K1 on every step"] = launches["cell_force_newton"] == n_steps
        checks["typed round collects fewer candidates"] = 0 < calls["typed"] < calls["untyped"]
    if core.cheb is not None:
        checks["Chebyshev table carried"] = bool(torch.isfinite(core.cheb.cder).all())
    print(f"host syncs in one stride cycle, {label} (CUDA sync-debug mode): {census}")
    tail = (f"{warm_tail}tail at the end {int(state.tail_count)} (fallback periods "
            f"{int(state.tail_fallbacks)}), " if state.tail_count is not None else "")
    print(f"kT=0.8 {label}: {timed_steps} steps after {warm_steps} warm-up: "
          f"{timed_steps / dt:.2f} steps/s, {syncs / (timed_steps / 10):.2f} host syncs "
          f"per stride cycle, launches {launches}, {tail}cum_bias "
          f"{float(core.bias.cum_bias):.6g}, last energy {float(e[-1]):.6g}"
          + (f", first-round candidates {calls}" if calls else ""))
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 {label} run failed: {failed}")
    return dict(rate=timed_steps / dt, launches=launches, device_ms=device_ms, dev_us=dev_us,
                state=state, steps=steps)


# the sampled g(r): pair distances binned by 0.05 up to 3.0 (the bias
# grid's range), positions sampled every 10 steps over 300 steps; the
# kernel route's histogram against the plain versions' within twice the
# distance between two kernel runs of other keys plus GOFR_FLOOR (L1 of
# the normalized histograms)
GOFR_EDGES = np.linspace(0.0, 3.0, 61)
GOFR_STEPS, GOFR_EVERY, GOFR_FLOOR = 300, 10, 0.01


def pair_histogram(torch, x, box):
    """Counts of the minimum-image distances of the pairs of ``x`` (N, 3),
    each once, in the bins of ``GOFR_EDGES`` (float64)."""
    n = x.shape[0]
    L = torch.tensor(box, dtype=x.dtype, device=x.device)
    edges = torch.tensor(GOFR_EDGES, dtype=x.dtype, device=x.device)
    counts = torch.zeros(len(GOFR_EDGES) - 1, dtype=torch.float64, device=x.device)
    j = torch.arange(n, device=x.device)
    for i0 in range(0, n, 1024):
        d = x[i0:i0 + 1024, None] - x[None]
        d = d - torch.round(d / L) * L
        r = torch.sqrt((d * d).sum(-1))
        r = r[(j[i0:i0 + 1024, None] < j[None]) & (r < edges[-1])]
        b = torch.bucketize(r, edges, right=True) - 1
        counts += torch.bincount(b, minlength=counts.numel()).double()
    return counts


def sampled_gofr(torch, steps, state, box):
    """``GOFR_STEPS`` steps of the stride cycle from ``state``: the pair
    histogram of the atoms' positions after every ``GOFR_EVERY``,
    summed and normalized, and the end state, held to the bench's checks."""
    from edm_tpu_torch.models.driver import pattern_segment

    hist = 0.0
    for _ in range(GOFR_STEPS // GOFR_EVERY):
        state, _ = pattern_segment(pattern(steps), GOFR_EVERY)(state)
        hist = hist + pair_histogram(torch, state.xs.reshape(-1, 3)[state.mc.reshape(-1) > 0.5],
                                     box)
    core = state.core
    if not (bool(torch.isfinite(state.xs).all()) and not bool(state.table_overflow)
            and not bool(core.hills_truncated) and float(core.bias.cum_bias) > 0):
        raise AssertionError("g(r) run: not finite, overflowed, truncated or no bias")
    return hist / hist.sum()


def gofr_phase(torch, device):
    """The bench-scale sampled g(r) at kT = 0.8: ``GOFR_STEPS`` steps of the
    10k exact cell from one thermalized state (100 steps) through the
    kernels and through the plain versions with the same key, and through
    the kernels with another key; the kernel route's g(r) within
    2 L1(kernels, kernels') + ``GOFR_FLOOR`` of the plain route's."""
    import dataclasses

    from edm_tpu_torch.ops.prng import PRNGKey

    spec, _, steps = bench_setup(torch, 0.8, device)
    start = thermalized(torch, device, "interp")
    g_kernel = sampled_gofr(torch, steps, start, spec.box)
    with plain_versions():
        g_plain = sampled_gofr(torch, steps, start, spec.box)
    other = dataclasses.replace(start, core=dataclasses.replace(start.core, key=PRNGKey(1)))
    g_other = sampled_gofr(torch, steps, other, spec.box)
    l1_plain = float((g_kernel - g_plain).abs().sum())
    l1_keys = float((g_kernel - g_other).abs().sum())
    limit = 2 * l1_keys + GOFR_FLOOR
    print(f"g(r) at kT=0.8 (10k exact, {GOFR_STEPS} steps from one thermalized state, sampled "
          f"every {GOFR_EVERY}, bins of 0.05 to 3.0): L1(kernels, plain versions) {l1_plain:.5f}, "
          f"L1(kernels, kernels with another key) {l1_keys:.5f}, bound 2 x {l1_keys:.5f} + "
          f"{GOFR_FLOOR} = {limit:.5f}")
    if not l1_plain <= limit:
        raise AssertionError(f"g(r): the kernel route is {l1_plain:.5f} off the plain route")


def hash_bound(flops: float, int_ops: float, nbytes: float):
    """``bound`` with integer operations at half the f32 rate."""
    return bound(flops + 2 * int_ops, nbytes)


def tf_bound(elements: int, nbytes: int, rows: int = 0, normal: bool = False):
    """``hash_bound`` of Threefry uniforms (``normal``: normals), the work
    the function needs: a block and the mantissa trick an element, the
    launch key's schedule once, and for per-row streams a row key a row
    (its ``fold_in`` block and its schedule)."""
    int_ops = ((TF_BLOCK_INT_OPS + TF_MANTISSA_INT_OPS) * elements
               + (TF_BLOCK_INT_OPS + TF_KEY_INT_OPS) * rows + TF_KEY_INT_OPS)
    flops = (TF_UNIFORM_FLOPS + (TF_NORMAL_FLOPS if normal else 0)) * elements
    return hash_bound(flops, int_ops, nbytes)


def max_ulps(a, b) -> float:
    """The largest |a - b| in units of the spacing of the type at the
    larger of |a| and |b|."""
    a, b = a.cpu().numpy(), b.cpu().numpy()
    return float((np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))).max())


def half_inputs(torch, spec, state, cells, dtype=None):
    """Pass 1's inputs on the row cells ``cells`` (a tensor of global cell
    ids) of the cell state, in ``dtype`` (default the state's): the slot
    lattice (xs, mc), the cells and ``half_neighbors``."""
    from edm_tpu_torch.ops import cellforce as CF

    dtype = dtype or state.xs.dtype
    nbr = CF.half_neighbors(tuple(spec.ncells), state.xs.device)
    return state.xs.to(dtype), state.mc.to(dtype), cells, nbr


def stencil_work(torch, spec, occ_a, occ_b, offsets, nbr, half: bool):
    """Pass 1's pairs and the displacement components among them that
    cross a periodic face (where the minimum image needs its division; on
    lattices of 8 or more cells a side no other component does), from the
    per-cell counts of row atoms ``occ_a`` and candidate atoms ``occ_b``
    (C,) over the stencil ``offsets`` / ``nbr`` (C, len(offsets)); with
    ``half`` the cell's own pairs are counted once (occ_a = occ_b) and
    ``offsets`` are the 13 neighbours, else every ordered pair of the
    stencil, the cell's own included (an atom with itself excluded by the
    caller's counts being of distinct types)."""
    C = spec.n_cells
    dev = nbr.device
    a, b = occ_a[:C].to(torch.int64), occ_b[:C].to(torch.int64)
    cid = torch.arange(C, device=dev)
    ny, nz = spec.ncells[1], spec.ncells[2]
    co = (cid // (ny * nz), (cid // nz) % ny, cid % nz)
    pairs = (a * (a - 1) // 2).sum() if half else 0
    wraps = 0
    for k, off in enumerate(offsets):
        p = a * b[nbr[:, k]]
        pairs = pairs + p.sum()
        cross = sum(((co[d] + off[d] < 0) | (co[d] + off[d] >= spec.ncells[d])).to(torch.int64)
                    for d in range(3))
        wraps = wraps + (p * cross).sum()
    return int(pairs), int(wraps)


def edge_lattice_phase(torch, device):
    """Both pass-1 kernels on ``edge_lattice`` (cap 8), in float32 and
    float64, with the threshold at 0.5 and with none: row counts and ncalls
    exactly the plain versions'; the half pass also over an unordered cell
    list."""
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import collect
    from edm_tpu_torch.ops.hashrng import seeds_from_key
    from edm_tpu_torch.ops.prng import PRNGKey

    pts, box, cap, types = edge_lattice()
    n = len(pts)
    spec, state = lattice_state(torch, device, pts, box, cap)
    full, empty = (int((state.mc.sum(1) == k).sum()) for k in (cap, 0))
    if not (spec.ncells == (5, 3, 5) and full == 2):
        raise AssertionError(f"edge lattice: {spec.ncells} cells, {full} full")
    seeds = seeds_from_key(PRNGKey(5))
    t = torch.as_tensor(types, device=device)[torch.clamp(state.aid, 0, n - 1)]
    perm = torch.randperm(spec.n_cells, generator=torch.Generator().manual_seed(3)).to(device)
    checked = []
    for dt in (torch.float32, torch.float64):
        boxt = torch.tensor(spec.box, dtype=dt, device=device)
        tslot = torch.where(state.aid < n, t, 0).to(dt).reshape(state.mc.shape)
        for th in (torch.full((), 0.5, dtype=dt, device=device), None):
            calls = [("p1_count_half", collect.p1_counts_half, collect.p1_counts_half_ref,
                      half_inputs(torch, spec, state, cells, dt) + (boxt, 9.0, th, seeds))
                     for cells in (torch.arange(spec.n_cells, device=device), perm[:20])]
            calls.append(("p1_count_typed", collect.p1_counts_typed,
                          collect.p1_counts_typed_ref,
                          (state.xs.to(dt), state.aid, tslot,
                           CF.stencil_neighbors(spec.ncells, device), boxt, 9.0, th, seeds, n,
                           TYPE_PAIR)))
            for name, fn, ref, args in calls:
                rc, nc = fn(*args)
                rc_ref, nc_ref = ref(*args)
                if not (torch.equal(rc, rc_ref) and int(nc) == int(nc_ref) > 0):
                    raise AssertionError(f"{name} on the edge lattice ({dt}, threshold "
                                         f"{th is not None}): row counts or ncalls ({int(nc)} "
                                         f"vs {int(nc_ref)}) differ from the plain version")
                checked.append(int(nc))
    print(f"edge lattice ({n} atoms on {spec.ncells} cells of cap {cap}: {full} full, {empty} "
          f"empty; displacements at +-L/4 and +-L/2, r^2 at bmax^2 and a float32 step either "
          f"side): p1_count_half (every cell, 20 unordered) and p1_count_typed exact in float32 "
          f"and float64, threshold 0.5 and none; ncalls {checked[:3]}")
    large_cap_phase(torch, device)


def large_cap_phase(torch, device):
    """Both pass-1 kernels above the largest cap whose candidate cells fit
    one shared-memory piece, on ``dense_lattice``: typed at cap 128 and
    half at cap 300, in float64 (the cells in two pieces), threshold 0.5
    and none: row counts and ncalls exactly the plain versions'."""
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import collect
    from edm_tpu_torch.ops.hashrng import seeds_from_key
    from edm_tpu_torch.ops.prng import PRNGKey

    f64 = torch.float64
    seeds = seeds_from_key(PRNGKey(5))
    for typed, cap in ((True, 128), (False, 300)):
        t0 = time.perf_counter()
        pts, box, cap, types = dense_lattice(cap)
        n = len(pts)
        spec, state = lattice_state(torch, device, pts, box, cap)
        boxt = torch.tensor(spec.box, dtype=f64, device=device)
        if typed:
            t = torch.as_tensor(types, device=device)[torch.clamp(state.aid, 0, n - 1)]
            tslot = torch.where(state.aid < n, t, 0).to(f64).reshape(state.mc.shape)
            name, fn, ref = "p1_count_typed", collect.p1_counts_typed, collect.p1_counts_typed_ref
            nbr = CF.stencil_neighbors(spec.ncells, device)
            args = lambda th: (state.xs.to(f64), state.aid, tslot, nbr, boxt, 9.0, th, seeds, n,
                               TYPE_PAIR)
        else:
            name, fn, ref = "p1_count_half", collect.p1_counts_half, collect.p1_counts_half_ref
            inputs = half_inputs(torch, spec, state, torch.arange(spec.n_cells, device=device), f64)
            args = lambda th: inputs + (boxt, 9.0, th, seeds)
        ncalls = []
        for th in (torch.full((), 0.5, dtype=f64, device=device), None):
            rc, nc = fn(*args(th))
            rc_ref, nc_ref = ref(*args(th))
            if not (torch.equal(rc, rc_ref) and int(nc) == int(nc_ref) > 0):
                raise AssertionError(f"{name} at cap {cap} (float64, threshold {th is not None}): "
                                     f"row counts or ncalls ({int(nc)} vs {int(nc_ref)}) differ "
                                     "from the plain version")
            ncalls.append(int(nc))
        print(f"{name} at cap {cap} (float64, {n} atoms on {spec.ncells} cells, one full): exact, "
              f"threshold 0.5 and none, ncalls {ncalls}; {time.perf_counter() - t0:.1f} s")


# hash_rows' tile edges: row counts (R = 1, 33, the 10k thermostat's 23,552
# and 2^16 + 33, either side of the narrow rows' switch to a thread a row,
# with ids near and above 2^32; a strided view) and widths (a thread a row
# or an element up to 16, a warp a row beyond, 897 on every 16-byte phase)
HASH_EDGE_COLS = (1, 3, 5, 7, 864, 896, 897)


def hash_edge_rows(torch, device):
    """(label, rows) of ``hash_rows``' tile edges (``HASH_EDGE_COLS``)."""
    rng = np.random.default_rng(2)
    ids = np.concatenate([np.arange(16000), rng.integers(2**31, 2**40, 4224),
                          2**32 + np.arange(-1664, 1664)])
    many = np.concatenate([ids, rng.integers(0, 2**40, 2**16 + 33 - len(ids))])
    wide = torch.tensor(rng.integers(0, 2**40, 2 * 33), device=device)
    return [("R=1", torch.tensor([2**32 - 1], device=device)),
            ("R=33", torch.arange(2**32 - 16, 2**32 + 17, device=device)),
            ("R=23552", torch.tensor(ids, device=device)),
            ("R=65569", torch.tensor(many, device=device)), ("R=33 strided", wide[::2])]


def hash_edge_phase(torch, device, seeds):
    """``hash_rows`` at its tile edges (``hash_edge_rows`` x
    ``HASH_EDGE_COLS``) in float32 and float64: uniforms bitwise, normals
    within 2 ulps, one launch a call."""
    from edm_tpu_torch.ops import hashrng as H

    t0 = time.perf_counter()
    worst = {}
    for fn, ref in ((H.uniform_rows_cols, H.uniform_rows_cols_ref),
                    (H.normal_rows_cols, H.normal_rows_cols_ref)):
        normal = fn is H.normal_rows_cols
        for dt in (torch.float32, torch.float64):
            for label, r in hash_edge_rows(torch, device):
                for n in HASH_EDGE_COLS:
                    n0 = fn.launches
                    out, want = fn(seeds, r, n, dt), ref(seeds, r, n, dt)
                    ok = fn.launches == n0 + 1 and out.shape == want.shape
                    if normal:
                        worst[dt] = max(worst.get(dt, 0.0), max_ulps(out, want))
                        ok = ok and worst[dt] <= 2
                    else:
                        ok = ok and torch.equal(out, want)
                    if not ok:
                        raise AssertionError(f"{fn.__name__} {label} x {n} {dt}: not the plain "
                                             "version's, or not one launch")
    print(f"hash_rows tile edges (R = 1, 33, 23,552, 65,569 with ids near and above 2^32, a "
          f"strided view; n = {', '.join(map(str, HASH_EDGE_COLS))}): uniforms bitwise, normals "
          f"within {worst[torch.float32]:g} (f32) and {worst[torch.float64]:g} (f64) ulps, one "
          f"launch a call; {time.perf_counter() - t0:.1f} s")


def hash_kernel_phase(torch, device, state, steps, tag=""):
    """The counter-hash and pass-1 kernels of ``csrc/hashrng.cu`` against
    their plain versions on the card, on a cell state of the bench (the 10k
    or the 100k cell) and its hill step ``steps[0]``: ``hash_rows``'
    uniforms bitwise in float32 and float64 at the thermostat's rows (Cg
    cap x 6), at the plain pass 1's first chunk (x 2W) and at pass 2's
    ``row_cap`` unsorted rows (x 2W); its normals (Cg cap x 3) within 2
    ulps; ``p1_count_half``'s row counts and ncalls exactly over every
    cell, over the owned cells of a 2-rank slab and of a 2 x 2 brick (the
    boxes' ncalls summing to the lattice's), and ``p1_count_typed``'s on
    the binary mixture's slot types; and one whole hill collection, half
    and typed, through the kernels bitwise through the plain versions.
    Each kernel is timed at the main path's shape beside its plain version
    and its bound.  Returns the rows."""
    from edm_tpu_torch.grid import device_const
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import collect
    from edm_tpu_torch.ops import hashrng as H
    from edm_tpu_torch.ops.prng import PRNGKey

    f32, f64 = torch.float32, torch.float64
    step = steps[0]
    spec = step.spec
    cap, C, Cg, n = spec.cap, spec.n_cells, state.mc.shape[0], spec.n_atoms
    W = 14 * cap
    seeds = H.seeds_from_key(PRNGKey(3))
    thermo = torch.arange(Cg * cap, device=device)
    chunk = torch.arange(collect._p1_ranges(C, 2 * W * cap)[0][1] * cap, device=device)
    gen = torch.Generator().manual_seed(5)
    pass2 = torch.randperm(C * cap, generator=gen)[:step.row_cap].to(device)
    for label, r, m in (("thermostat", thermo, 6), ("pass-1 chunk", chunk, 2 * W),
                        ("pass 2", pass2, 2 * W)):
        for dt in (f32, f64):
            bad = int((H.uniform_rows_cols(seeds, r, m, dt)
                       != H.uniform_rows_cols_ref(seeds, r, m, dt)).sum())
            if bad:
                raise AssertionError(f"hash_uniforms{tag} {label} {len(r)}x{m} {dt}: {bad} "
                                     "draws differ from the plain version")
    if not tag:
        hash_edge_phase(torch, device, seeds)
    ulps = {}
    for dt in (f32, f64):
        z, z_ref = (fn(seeds, thermo, 3, dt) for fn in (H.normal_rows_cols, H.normal_rows_cols_ref))
        ulps[dt] = max_ulps(z, z_ref)
        if dt == f32:
            z_err = max_err(z, z_ref)
        if not ulps[dt] <= 2:
            raise AssertionError(f"hash_normals{tag} {dt}: {ulps[dt]} ulps from the plain version")
    rows = {}
    R2 = len(pass2)
    ms = cuda_ms(torch, lambda: H.uniform_rows_cols(seeds, pass2, 2 * W, f32))
    plain = cuda_ms(torch, lambda: H.uniform_rows_cols_ref(seeds, pass2, 2 * W, f32), reps=10)
    d = R2 * 2 * W
    rows[f"uniform_rows_cols{tag} pass 2 {R2}x{2 * W}"] = (0.0, ms, plain) + hash_bound(
        UNIFORM_FLOPS * d, HASH_INT_OPS * d, 8 * R2 + 4 * d)
    ms = cuda_ms(torch, lambda: H.normal_rows_cols(seeds, thermo, 3, f32))
    plain = cuda_ms(torch, lambda: H.normal_rows_cols_ref(seeds, thermo, 3, f32), reps=10)
    d = len(thermo) * 3
    rows[f"normal_rows_cols{tag} thermostat {len(thermo)}x3"] = (z_err, ms, plain) + hash_bound(
        (2 * UNIFORM_FLOPS + BOX_MULLER_FLOPS) * d, 2 * HASH_INT_OPS * d, 8 * len(thermo) + 4 * d)

    # pass 1, half stencil: the lattice, a 2-rank slab's and a 2 x 2 brick's owned boxes
    thresh = step._accept_threshold(state.core.last_calls, f32)
    box = device_const(spec.box, device, f32)
    bmax2 = step.params.cfg.box_high[0] * step.params.cfg.box_high[0]
    nx, ny, nz = spec.ncells
    qx, qy = -(-nx // 2), -(-ny // 2)
    every = torch.arange(C, device=device)
    forms = {"lattice": [every],
             "slab": [every[:qx * ny * nz], every[qx * ny * nz:]],
             "brick": [CF.box_cells(spec.ncells, ((x0, y0, 0), (wx, wy, nz)), device)
                       for x0, wx in ((0, qx), (qx, nx - qx)) for y0, wy in ((0, qy), (qy, ny - qy))]}
    total = {}
    for form, boxes in forms.items():
        total[form] = 0
        for cells in boxes:
            args = half_inputs(torch, spec, state, cells) + (box, bmax2, thresh, seeds)
            rc, nc = collect.p1_counts_half(*args)
            rc_ref, nc_ref = collect.p1_counts_half_ref(*args)
            if not (torch.equal(rc, rc_ref) and int(nc) == int(nc_ref)):
                raise AssertionError(f"p1_count_half{tag} {form}: row counts or ncalls "
                                     f"({int(nc)} vs {int(nc_ref)}) differ from the plain version")
            total[form] += int(nc)
    if not total["slab"] == total["brick"] == total["lattice"] > 0:
        raise AssertionError(f"p1_count_half{tag}: the boxes' ncalls {total} do not partition")
    args = half_inputs(torch, spec, state, every) + (box, bmax2, thresh, seeds)
    ms = cuda_ms(torch, lambda: collect.p1_counts_half(*args))
    plain = cuda_ms(torch, lambda: collect.p1_counts_half_ref(*args), reps=5, warm=1)
    occ = state.mc.sum(1).round()
    pairs, wraps = stencil_work(torch, spec, occ, occ, CF.HALF_OFFSETS, args[3], half=True)
    draws = total["lattice"] if thresh is not None else 0
    # the lattice's slot blocks (xyz, mask) once, the neighbour table and the
    # cell list, the row counts out
    rows[f"p1_counts_half{tag} {C} cells"] = (0.0, ms, plain) + hash_bound(
        P1_PAIR_FLOPS * pairs + P1_WRAP_FLOPS * wraps + (UNIFORM_FLOPS + 1) * draws,
        HASH_INT_OPS * draws, 16 * C * cap + 8 * 13 * C + 8 * C + 8 * C * cap)
    print(f"p1_count_half{tag}: {pairs} pairs of occupied slots, {wraps} of their components "
          f"across a periodic face, {draws} draws hashed; {C} cells of cap {cap}")

    # pass 1, typed: the binary mixture's slot types
    types = torch.tensor(bench_types(n), device=device, dtype=torch.int64)
    real = state.aid < n
    tslot = torch.where(real, types[torch.clamp(state.aid, 0, n - 1)], 0).to(f32).reshape(
        state.mc.shape)
    nbr = CF.stencil_neighbors(tuple(spec.ncells), device)
    targs = (state.xs, state.aid, tslot, nbr, box, bmax2, thresh, seeds, n, TYPE_PAIR)
    rc, nc = collect.p1_counts_typed(*targs)
    rc_ref, nc_ref = collect.p1_counts_typed_ref(*targs)
    if not (torch.equal(rc, rc_ref) and int(nc) == int(nc_ref) > 0):
        raise AssertionError(f"p1_count_typed{tag}: row counts or ncalls ({int(nc)} vs "
                             f"{int(nc_ref)}) differ from the plain version")
    ms = cuda_ms(torch, lambda: collect.p1_counts_typed(*targs))
    plain = cuda_ms(torch, lambda: collect.p1_counts_typed_ref(*targs), reps=5, warm=1)
    k1, k2 = (((tslot == t) & real.reshape(tslot.shape)).sum(1) for t in TYPE_PAIR)
    p12, w12 = stencil_work(torch, spec, k1, k2, CF.STENCIL_OFFSETS, nbr, half=False)
    p21, w21 = stencil_work(torch, spec, k2, k1, CF.STENCIL_OFFSETS, nbr, half=False)
    draws = int(nc) if thresh is not None else 0
    # the lattice's slot blocks (xyz, aid, type) once, the stencil table, the row counts out
    rows[f"p1_counts_typed{tag} {C} cells"] = (0.0, ms, plain) + hash_bound(
        (P1_PAIR_FLOPS + 1) * (p12 + p21) + P1_WRAP_FLOPS * (w12 + w21)
        + (UNIFORM_FLOPS + 1) * draws, HASH_INT_OPS * draws,
        24 * C * cap + 8 * 27 * C + 8 * C * cap)
    if not tag:
        edge_lattice_phase(torch, device)

    # whole collections, half and typed: the kernels against the plain versions
    typed_step = bench_setup(torch, 0.8, device, "typed", n_atoms=n)[2][0]
    for label, st in (("half", step), ("typed", typed_step)):
        cargs = (state, state.xs, PRNGKey(7), state.core.last_calls, f32)
        got = st._collect_hills(*cargs)
        with plain_hash():
            want = st._collect_hills(*cargs)
        for name, a, b in zip(("hills", "runifs", "active", "ncalls", "truncated"), got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"{label} collection{tag}: {name} differs from the plain "
                                     "route")
    print(f"counter hash and pass 1{tag}: hash_uniforms bitwise the plain version (f32, f64; "
          f"{len(thermo)}x6, {len(chunk)}x{2 * W}, {R2}x{2 * W}), hash_normals within "
          f"{ulps[f32]:g} (f32) and {ulps[f64]:g} (f64) ulps, p1_count_half exact (lattice, 2-rank "
          f"slab, 2 x 2 brick; ncalls {total['lattice']}), p1_count_typed exact (ncalls "
          f"{int(nc)}), the half and typed collections bitwise the plain route")
    print_rows(rows)
    return rows


@contextlib.contextmanager
def recorded_draws(calls):
    """Record the cell host's counter-hash draws and pass 1 (the wrappers of
    ``HASH_KERNELS``) into ``calls`` as (name, arguments)."""
    from edm_tpu_torch.models import pair_edm_cells as PC

    saved = {name: getattr(PC, name) for name in HASH_KERNELS}

    def recording(name, fn):
        def draw(*args):
            calls.append((name, args))
            return fn(*args)
        return draw

    for name, fn in saved.items():
        setattr(PC, name, recording(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(PC, name, fn)


def hill_step_peak_gb(torch, step, state, p1_draws=None):
    """The device memory one hill step takes beyond what was allocated
    before it (GB), with the plain pass 1's chunk limit ``p1_draws``
    (default ``collect.P1_DRAWS``)."""
    from edm_tpu_torch.ops import collect

    saved = collect.P1_DRAWS
    collect.P1_DRAWS = p1_draws or saved
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step(state)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_allocated() - base) / 1e9
    finally:
        collect.P1_DRAWS = saved


def big_cell_phase(torch, device):
    """The 100k exact cell (``bench.py:378-382``, nothing cut): 10 kT = 0
    steps from a thermalized state (200 kT = 0.8 steps) held to the plain
    versions; the bench segment at kT = 0.8 (360 warm-up and 360 timed
    steps, ``slice_run``'s checks); the counter hash's and pass 1's share
    of a stride cycle's device time through the kernels and through the
    plain versions; a hill step's peak memory through the kernels and
    through the plain pass 1, chunked and in one chunk; the hash and pass-1
    kernels against their plain versions (``hash_kernel_phase``) and K1 and
    K2 against theirs on the end state; then the typed configuration at
    100k (20 warm-up and 40 timed kT = 0.8 steps, ``slice_run``'s checks),
    whose profile gives ``p1_count_typed[100k]``.  Returns {"rows",
    "launches", "device_ms", "typed_launches", "typed_device_ms"}."""
    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import collect

    t0 = time.perf_counter()
    k2 = slice_zero_temperature(torch, device, "interp", n_steps=10, n_atoms=BIG_N,
                                warm_steps=200)
    t1 = time.perf_counter()
    run = slice_run(torch, device, "interp", warm_steps=360, timed_steps=360, n_atoms=BIG_N)
    t2 = time.perf_counter()
    state, steps = run["state"], run["steps"]
    spec = steps[0].spec
    calls = []
    with recorded_draws(calls):
        pattern_segment(pattern(steps), 10)(state)
    share = {}
    for route, suffix in (("kernels", ""), ("plain versions", "_ref")):
        fns = {name: getattr(hash_module(name), name + suffix) for name in HASH_KERNELS}
        us, _, _, n_dev = device_time_us(torch, lambda: [fns[nm](*a) for nm, a in calls], 2)
        pct = f"{us / run['dev_us']:.1%}" if run["dev_us"] > 0 else "not measured"
        share[route] = f"{us:.1f} us in {n_dev:.0f} device launches ({pct})"
    print(f"100k counter-hash draws and pass 1 in one stride cycle ({len(calls)} calls), against "
          f"the cycle's {run['dev_us']:.1f} us of device time: through the kernels "
          f"{share['kernels']}, through the plain versions {share['plain versions']}")
    cells = spec.n_cells
    chunks = len(collect._p1_ranges(cells, 2 * 14 * spec.cap * spec.cap))
    peak = hill_step_peak_gb(torch, steps[0], state)
    with plain_hash():
        peak_plain = hill_step_peak_gb(torch, steps[0], state)
        peak_one = hill_step_peak_gb(torch, steps[0], state, 1 << 62)
    print(f"100k hill step peak memory beyond its input: {peak:.3f} GB through the kernels; "
          f"{peak_plain:.3f} GB through the plain pass 1 in {chunks} chunks of whole cells "
          f"(P1_DRAWS {collect.P1_DRAWS}), {peak_one:.3f} GB in one chunk; {cells} cells, cap "
          f"{spec.cap}")
    if not peak < 2.0:
        raise AssertionError(f"100k hill step takes {peak:.3f} GB (limit 2 GB)")
    t3 = time.perf_counter()
    rows = hash_kernel_phase(torch, device, state, steps, tag="[100k]")
    t4 = time.perf_counter()
    for _ in range(10):  # K2's check needs a live tail: on to the next rebuild without one
        if int(state.tail_count) > 0:
            break
        state, _ = pattern_segment(pattern(steps), 10)(state)
    rows.update(k1k2_rows(torch, spec, state, steps[0],
                          {"hermite": CF.hermite_pair_table(state.core.bias.bias)}, ks=(24,),
                          tag="[100k]"))
    print_rows({k: v for k, v in rows.items() if k.startswith(("cell_", "overflow_"))})
    t5 = time.perf_counter()
    # the typed configuration at 100k: p1_count_typed's launches and device
    # time on its own path
    typed = slice_run(torch, device, "typed", warm_steps=20, timed_steps=40, n_atoms=BIG_N)
    print(f"100k phase seconds: kT=0 check {t1 - t0:.1f}, kT=0.8 run {t2 - t1:.1f}, hash share "
          f"and peak memory {t3 - t2:.1f}, hash kernel checks {t4 - t3:.1f}, K1/K2 rows "
          f"{t5 - t4:.1f}, typed run {time.perf_counter() - t5:.1f}; {k2} of the 10 kT=0 steps "
          f"ran K2")
    return dict(rows=rows, launches=run["launches"], device_ms=run["device_ms"],
                typed_launches=typed["launches"], typed_device_ms=typed["device_ms"])


# The dense liquid (LAMMPS's own LJ benchmark, bench/in.lj): an fcc lattice
# at rho* = 0.8442, 20^3 unit cells, 32,000 atoms, box 33.592^3, LJ eps =
# sigma = 1, rcut 2.5, with the bench's well-tempered RDF-targeted pair
# bias out to r = 4.0 (201 Hermite points, the second and third shells)
# and its hill settings, Langevin kT = 0.8, dt 0.002.  Cells of edge >=
# 4.05 (the bias domain's 4.0 and a margin): 8^3 cells of 4.199 and the
# automatic cap (mean 62.5 + 4 sqrt(62.5), rounded up to 8): 96.  Nothing
# is cut.  Three runs: (a) K1 at full cap (k = 96) on every step; (b)
# kernel_cap 72 with 384 tail rows for K2 (3x the old limit of 128) and the
# full-cap fallback at 96; (c) (b) with the Chebyshev lookup, 16 panels of
# degree 16 (the old limit was 8 panels).
LIQUID_CELLS, LIQUID_RHO, LIQUID_BOX_HIGH, LIQUID_CUTOFF = 20, 0.8442, 4.0, 4.05
LIQUID_RUNS = {
    "a": dict(),
    "b": dict(kernel_cap=72, overflow_cap=384),
    "c": dict(kernel_cap=72, overflow_cap=384, pair_lookup="chebyshev", cheb_deg=16,
              cheb_panels=16),
}
LIQUID_JITTER = 0.05  # the kT = 0 steps' input: each site moved by up to this (sigma)
# K2's checks past one row tile take the liquid's slots past this one as
# their tail (~4,000 atoms), so that every tile of 128 rows is full
K2_CHECK_CAP = 56
# the large-cap lattices of the kernel checks: (cap, the k of K1 on it); at
# 256 a row takes several pieces, at 1,024 the rows take several tiles too
LIQUID_LATTICES = ((256, (128, 256)), (1024, (1024,)))
LIQUID_DEPTH = (50, 100)  # the kT = 0.8 runs: warm-up and timed steps


def fcc_lattice(cells, rho):
    """An fcc lattice of ``cells``^3 unit cells at reduced density ``rho``
    (LAMMPS ``lattice fcc``): (positions (4 cells^3, 3), box)."""
    a = (4.0 / rho) ** (1 / 3)
    basis = np.array([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.0, 0.5], [0.0, 0.5, 0.5]])
    sites = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing="ij"), -1).reshape(-1, 1, 3)
    return ((sites + basis[None]) * a).reshape(-1, 3), [cells * a] * 3


def liquid_setup(torch, kT: float, device, run, jitter=0.0):
    """The dense liquid's run ``run`` of ``LIQUID_RUNS`` through the port's
    entry points (bias.subdivide -> pair_edm.init_state -> CellSpec.create
    with the automatic cap -> init_cell_state), the lattice sites moved by
    up to ``jitter`` (seeded), and the three static phase steps of the
    bench's stride cycle: (spec, state, steps)."""
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.cells import CellSpec
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu_torch.ops.prng import PRNGKey

    opts = LIQUID_RUNS[run]
    params, bias_state = bench_bias(torch, device, LIQUID_BOX_HIGH)
    pts, box = fcc_lattice(LIQUID_CELLS, LIQUID_RHO)
    if jitter:
        pts = pts + np.random.default_rng(7).uniform(-jitter, jitter, pts.shape)
    n = len(pts)
    core = pair_edm.init_state(bias_state, torch.tensor(pts, dtype=torch.float32, device=device),
                               PRNGKey(0), n_est=n * 40,
                               pair_lookup=opts.get("pair_lookup", "interp"),
                               cheb_deg=opts.get("cheb_deg", 64),
                               cheb_panels=opts.get("cheb_panels", 1))
    spec = CellSpec.create(box, cutoff=LIQUID_CUTOFF, n_atoms=n)
    caps = {k: v for k, v in opts.items() if k in ("kernel_cap", "overflow_cap")}
    state = init_cell_state(spec, core, **caps)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    steps = [make_cell_step(params, lp, lj, spec, hill_stride=10, rebuild_stride=10,
                            hill_capacity=2048, cell_chunk=81, use_pallas=True, energy_stride=10,
                            static_do_hills=h, static_do_energy=e, static_do_rebuild=r, **caps)
             for h, e, r in ((True, True, False), (False, False, False), (False, False, True))]
    return spec, state, steps


def liquid_label(run) -> str:
    o = LIQUID_RUNS[run]
    caps = (f"kernel_cap {o['kernel_cap']}, overflow_cap {o['overflow_cap']}"
            if "kernel_cap" in o else "full cap")
    look = (f", Chebyshev {o['cheb_panels']} x {o['cheb_deg']}" if "cheb_deg" in o else "")
    return f"32k liquid ({run}) {caps}{look}"


def liquid_zero_temperature(torch, device, run, n_steps=20):
    """20 steps at kT = 0 of run ``run`` from the jittered lattice, each step
    through the kernels and through the plain versions from the same input
    state, held to each other (``states_match``: integer leaves exactly,
    forces within FORCE_REL).  Returns (steps that ran K2, fallback
    periods)."""
    from edm_tpu_torch.ops import cellforce as CF

    spec, state, steps = liquid_setup(torch, 0.0, device, run, LIQUID_JITTER)
    n_edge, k2 = 0, 0
    for i in range(n_steps):
        step = steps[0 if i % 10 == 0 else 2 if i % 10 == 9 else 1]
        with plain_versions():
            plain, _ = step(state)
        k2_before = CF.overflow_force.launches
        state, _ = step(state)
        k2 += CF.overflow_force.launches > k2_before
        n_edge += states_match(torch, state, plain, i, spec.box, state.core.cheb)
    falls = int(state.tail_fallbacks) if state.tail_fallbacks is not None else 0
    print(f"kT=0 {liquid_label(run)}: cap {spec.cap} on {spec.ncells} cells, {n_steps} steps "
          f"through the kernels match the plain versions step for step ({n_edge} atom(s) by a "
          f"table-edge pair; {k2} step(s) ran K2; fallback periods {falls})")
    return k2, falls


def liquid_run(torch, device, run):
    """Run ``run``'s kT = 0.8 segment (``LIQUID_DEPTH``: 100 steps after 50)
    through the kernels, the launch counters set to 0 just before it and
    read just after; counted only if the state is finite, no cap overflowed
    (table_overflow, hills_truncated) and cum_bias > 0.  Prints steps/s, the
    stride cycle's busy share and K1's and K2's device ms a launch, the
    syncs of a cycle, the tail population and the fallback periods, beside
    the card.  Returns {"rate", "launches", "device_ms", "state", "steps",
    "spec"}."""
    from edm_tpu_torch.models.driver import pattern_segment

    warm_steps, timed_steps = LIQUID_DEPTH
    spec, state, steps = liquid_setup(torch, 0.8, device, run)
    if spec.cap <= 64:
        raise AssertionError(f"the dense liquid's automatic cap is {spec.cap}: not above 64")
    wrappers = port_wrappers()
    for w in wrappers.values():
        w.launches = 0
    for s in steps:
        s.host_syncs = 0
    state, _ = pattern_segment(pattern(steps), warm_steps)(state)
    torch.cuda.synchronize()
    tail_warm = (int(state.tail_count), int(state.tail_fallbacks)) if state.tail_count is not None \
        else None
    syncs0 = sum(s.host_syncs for s in steps)
    t0 = time.perf_counter()
    state, e = pattern_segment(pattern(steps), timed_steps)(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: w.launches for name, w in wrappers.items()}
    syncs = sum(s.host_syncs for s in steps) - syncs0
    dev_us, top, device_ms = cycle_device_ms(torch, pattern_segment(pattern(steps), 10), state)
    label = liquid_label(run)
    print(busy_line(f"kT=0.8 {label} stride cycle", dev_us, 10 * dt / timed_steps * 1e6, top))
    state, census = sync_census(torch, steps, state)
    core = state.core
    n_steps = warm_steps + timed_steps
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.xs, state.vs, state.fs, e)),
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "cum_bias > 0": float(core.bias.cum_bias) > 0,
        "K1 launched": launches["cell_force_newton"] > 0,
        "pass 1 kernel on every hill step": launches["p1_counts_half"] == n_steps // 10,
    }
    if "kernel_cap" in LIQUID_RUNS[run]:
        checks["K2 launched"] = launches["overflow_force"] > 0
    else:
        checks["K1 at full cap on every step"] = launches["cell_force_newton"] == n_steps
    tail = ""
    if tail_warm is not None:
        tail = (f"; tail after warm-up {tail_warm[0]} (fallback periods {tail_warm[1]}), at the "
                f"end {int(state.tail_count)} (fallback periods {int(state.tail_fallbacks)} of "
                f"{n_steps // 10})")
    k1 = device_ms.get("cell_force_newton")
    k2 = device_ms.get("overflow_force")
    print(f"kT=0.8 {label}: {timed_steps} steps after {warm_steps} warm-up: "
          f"{timed_steps / dt:.2f} steps/s, {syncs / (timed_steps / 10):.2f} host syncs per "
          f"stride cycle (sync-debug census {census}), K1 "
          f"{'not measured' if k1 is None else f'{k1:.4f}'} / K2 "
          f"{'not launched' if k2 is None else f'{k2:.4f}'} device ms a launch, launches "
          f"{launches}{tail}, cum_bias {float(core.bias.cum_bias):.6g}; card {card_line()}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 {label} run failed: {failed}")
    return dict(rate=timed_steps / dt, launches=launches, device_ms=device_ms, state=state,
                steps=steps, spec=spec)


def check_row(torch, what, kernel, ref, compare, work, reps=20, plain_reps=3):
    """One kernel against its plain version on the same inputs: ``compare``
    (kernel out, plain out) -> the worst error, raising past its bound; the
    kernel's and the plain version's ms a call (CUDA events) and ``work``,
    the bound.  Returns the row."""
    got, want = kernel(), ref()
    torch.cuda.synchronize()
    err = compare(what, got, want)
    ms = cuda_ms(torch, kernel, reps=reps, warm=2)
    plain = cuda_ms(torch, ref, reps=plain_reps, warm=1)
    return (err, ms, plain) + work


def forces_compare(*names):
    """A ``compare`` of ``check_row`` for outputs (f, ..., e?): each named
    output as forces, an output named "energy" summed as an energy."""
    def compare(what, got, want):
        err = 0.0
        for name, a, b in zip(names, got, want):
            if name == "energy":
                check_energy(f"{what} energy", a.sum(), b.sum())
            elif name:
                err = max(err, check_forces(f"{what} {name}", a, b))
        return err
    return compare


def k2_compare(what, got, want):
    """K2's ``compare``: fo (forces and per-row energies) and fp as forces,
    the energy row's sum as an energy."""
    check_energy(what, got[0][3].sum(), want[0][3].sum())
    return forces_compare("fo", "fp")(what, got, want)


def tail_inputs(torch, state, xs, kcap, O, ovl=None):
    """K2's planes (``CellStep._overflow_inputs``) at kernel cap ``kcap``
    with the tail list ``ovl`` (default the state's) taken to O rows: its
    first O entries, padded with the empty sentinel."""
    Cg, cap = state.mc.shape
    S = Cg * cap
    ovl = (state.ovl if ovl is None else ovl)[:O]
    if ovl.shape[0] < O:
        ovl = torch.cat([ovl, ovl.new_full((O - ovl.shape[0],), S)])
    mo = (ovl < S).to(xs.dtype)
    xo3 = xs.reshape(S, 3)[torch.clamp(ovl, 0, S - 1)] * mo[:, None]
    xo = torch.cat([xo3.T, mo[None], mo[None]]).contiguous()
    xp = torch.cat([xs[:, :kcap].reshape(-1, 3).T, state.mc[:, :kcap].reshape(1, -1)])
    return xo, xp.contiguous()


def liquid_kernel_phase(torch, device, runs):
    """Each force kernel against its plain version at the shapes past the old
    limits, on the runs' end states (``runs``: {run: liquid_run's result})
    and on ``cap_lattice`` states: K1 at k = 72 and 96 on the liquid and
    128 and 256 on the cap-256 lattice, energy off and on; typed K1, K6
    (typed and not) and K7 at cap 96 on the liquid rebuilt with slot ids and
    the binary types; K1's row box over a slab of the liquid's cells; K1 at
    k = 1,024 on the cap-1,024 lattice (the rows in tiles, the candidates in
    pieces); K2 on run (b)'s tail list and at 136, 384 and 1,024 full tail
    rows (the slots past K2_CHECK_CAP); K1 and K2 with run (c)'s
    16 x 16 table and with a table past TABLE_SMEM_MAX (1,024 panels of
    degree 7, read from global memory); K4 and K5 with hills whose reach
    spans the grid.  Returns the rows; each kernel launch on these shapes
    is counted by its wrapper."""
    import dataclasses

    from edm_tpu_torch import gauss as tg
    from edm_tpu_torch.models.pair_edm_cells import atom_positions, init_cell_state
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import deposit_kernels as DK
    from edm_tpu_torch.ops.chebyshev import fit_gauss_grid

    t0 = time.perf_counter()
    rows = {}
    a, b, c = runs["a"], runs["b"], runs["c"]
    spec, lj = a["spec"], a["steps"][0].lj
    geo = dict(ncells=spec.ncells, box=spec.box, lj=lj)
    herm = CF.hermite_pair_table(a["state"].core.bias.bias)
    cheb = c["state"].core.cheb
    wide_tab = fit_gauss_grid(c["state"].core.bias.bias, 7, 1024)
    counts0 = {n: getattr(CF, n).launches for n in FORCE_KERNELS}

    def k1_rows(tag, sp, st, tbl, ks, **kw):
        g = dict(ncells=sp.ncells, box=sp.box, lj=lj)
        for k in ks:
            for energy in (False, True):
                args = dict(g, k=k, energy=energy, **kw)
                what = f"cell_force_newton{tag} k={k} energy={int(energy)}"
                rows[what] = check_row(
                    torch, what, lambda: CF.cell_force_newton(st.xs, st.mc, tbl, **args),
                    lambda: CF.cell_force_newton_ref(st.xs, st.mc, tbl, **args),
                    forces_compare("f", "energy"),
                    half_work(sp, st.xs, st.mc, tbl, lj, k, energy, kw.get("ts")))

    # K1 on the liquid, run (a)'s main-path shape first
    k1_rows("[cap 96] hermite", spec, a["state"], herm, (96, 72))
    # K1 past one piece and past one row tile, on cap_lattice states
    for cap, ks in LIQUID_LATTICES:
        pts, box, cap, _ = cap_lattice(cap)
        sp, st = lattice_state(torch, device, pts, box, cap)
        k = max(ks)
        plan = CF.row_plan(k, 3, False, CF.HERMITE, herm.tab.shape[0], 0)
        if plan.small or (k > CF.ROW_TILE) != (plan.row_tile < k):
            raise AssertionError(f"cap {cap}: plan {plan} is not the pieces form")
        k1_rows(f"[large cap] hermite cap={cap}", sp, st, herm, ks)
    # typed K1, K6 and K7 at cap 96 on the liquid with slot ids and types
    st_a = a["state"]
    core = dataclasses.replace(st_a.core, x=atom_positions(spec, st_a))
    st = init_cell_state(spec, core, with_ids=True,
                         types=torch.as_tensor(bench_types(spec.n_atoms), device=device))
    k1_rows("[typed cap 96] hermite", spec, st, herm, (96,), ts=st.ts, type_pair=TYPE_PAIR)
    for tname, tbl in (("hermite", herm), ("cheb 16x16", cheb)):
        for typed in (False, True):
            kw = dict(geo, energy=True, ts=st.ts if typed else None,
                      type_pair=TYPE_PAIR if typed else None)
            what = f"cell_force_newton_planar[cap 96] {tname} typed={int(typed)}"
            rows[what] = check_row(
                torch, what, lambda: CF.cell_force_newton_planar(st.xs, st.mc, tbl, **kw),
                lambda: CF.cell_force_newton_planar_ref(st.xs, st.mc, tbl, **kw),
                forces_compare("f", "credits", "energy"),
                half_work(spec, st.xs, st.mc, tbl, lj, spec.cap, True, kw["ts"],
                          credits_out=True))
    what = "cell_force_full[cap 96] cheb 16x16"
    rows[what] = check_row(
        torch, what, lambda: CF.cell_force_full(st.xs, st.mc, st.sid, cheb, **geo),
        lambda: CF.cell_force_full_ref(st.xs, st.mc, st.sid, cheb, **geo),
        forces_compare("f", "energy"), full_work(spec, st.xs, st.mc, cheb, lj))
    # K1's row box: the owned rows of a slab of x-columns (4 of the 8^3 cells)
    nx = spec.ncells[0]
    box_ = ((nx // 4, 0, 0), (max(1, nx // 2),) + tuple(spec.ncells[1:]))
    cells = CF.box_cells(tuple(spec.ncells), box_, device)
    mc_rows = st_a.mc[cells].contiguous()
    counts = pair_counts(spec, st_a.xs, st_a.mc, spec.cap, reach(herm, lj), rows=cells,
                         mc_rows=mc_rows)
    Cg, cap = st_a.mc.shape
    nbytes = 4 * (Cg * cap * 4 + cells.shape[0] * cap * 2 + Cg * cap * 3) + table_bytes(herm)
    for energy in (False, True):
        kw = dict(geo, k=spec.cap, energy=energy, mc_cand=st_a.mc, row_box=box_)
        what = f"cell_force_newton[row_box cap 96] hermite energy={int(energy)}"
        rows[what] = check_row(
            torch, what, lambda: CF.cell_force_newton(st_a.xs, mc_rows, herm, **kw),
            lambda: CF.cell_force_newton_ref(st_a.xs, mc_rows, herm, **kw),
            forces_compare("f", "energy"), bound(pair_flops(counts, herm, energy), nbytes))
    # K2: run (b)'s own 384-row tail list (its main-path shape), then the
    # end state's slots past 56 as a tail (every row tile full) at 136, 384
    # and 1,024 rows
    st_b, step_b = b["state"], b["steps"][0]
    kcap = step_b.kernel_cap
    n_tail = int(st_b.tail_count)
    Cg, cap = st_b.mc.shape
    past = torch.nonzero(st_b.mc[:, K2_CHECK_CAP:] > 0.5)
    full = past[:, 0] * cap + K2_CHECK_CAP + past[:, 1]
    if full.shape[0] < 1024:
        raise AssertionError(f"only {full.shape[0]} atoms past slot {K2_CHECK_CAP}")
    for O, ovl, kc in ((384, None, kcap), (136, full, K2_CHECK_CAP), (384, full, K2_CHECK_CAP),
                       (1024, full, K2_CHECK_CAP)):
        xo, xp = tail_inputs(torch, st_b, st_b.xs, kc, O, ovl)
        for energy in (False, True):
            kw = dict(box=spec.box, lj=lj, energy=energy)
            what = (f"overflow_force[{O} tail rows] hermite kernel_cap={kc} "
                    f"live={int((xo[3] > 0.5).sum())} energy={int(energy)}")
            rows[what] = check_row(
                torch, what, lambda: CF.overflow_force(xo, xp, herm, **kw),
                lambda: CF.overflow_force_ref(xo, xp, herm, **kw), k2_compare,
                k2_work(xo, xp, herm, lj, spec.box, energy))
    # K3: run (c)'s 16 x 16 table and one past the shared-memory fit, in K1 and K2
    st_c = c["state"]
    past = torch.nonzero(st_c.mc[:, K2_CHECK_CAP:] > 0.5)
    tails = (tail_inputs(torch, st_c, st_c.xs, kcap, 384),
             tail_inputs(torch, st_c, st_c.xs, K2_CHECK_CAP, 384,
                         past[:, 0] * cap + K2_CHECK_CAP + past[:, 1]))
    for tname, tbl in (("16x16", cheb), ("1024x7", wide_tab)):
        plan = CF.row_plan(kcap, 3, False, CF.CHEB, *tbl.cval.shape)
        if plan.table_smem != (tname == "16x16"):
            raise AssertionError(f"the {tname} table's plan {plan}")
        for energy in (False, True):
            kw = dict(geo, k=kcap, energy=energy)
            what = f"cell_force_newton[cheb {tname}] k={kcap} energy={int(energy)}"
            rows[what] = check_row(
                torch, what, lambda: CF.cell_force_newton(st_c.xs, st_c.mc, tbl, **kw),
                lambda: CF.cell_force_newton_ref(st_c.xs, st_c.mc, tbl, **kw),
                forces_compare("f", "energy"),
                half_work(spec, st_c.xs, st_c.mc, tbl, lj, kcap, energy))
            kw = dict(box=spec.box, lj=lj, energy=energy)
            for xo, xp in tails:
                what = (f"overflow_force[cheb {tname}] 384 tail rows live="
                        f"{int((xo[3] > 0.5).sum())} energy={int(energy)}")
                rows[what] = check_row(
                    torch, what, lambda: CF.overflow_force(xo, xp, tbl, **kw),
                    lambda: CF.overflow_force_ref(xo, xp, tbl, **kw), k2_compare,
                    k2_work(xo, xp, tbl, lj, spec.box, energy))
    counts = {n: getattr(CF, n).launches - counts0[n] for n in FORCE_KERNELS}
    if not all(counts.values()):
        raise AssertionError(f"a force kernel did not launch on the large shapes: {counts}")
    # K4 and K5 with hills whose reach spans the grid
    rng = np.random.default_rng(11)
    for G, sigma in ((16384, 4.0), (40000, 3.0)):
        gg = tg.GaussGrid.create([0], [10], [10.0 / G], [True], [sigma], device=device)
        gg = DK._commit(gg, torch.tensor(rng.normal(0.0, 1.0, G), dtype=torch.float32,
                                         device=device),
                        torch.tensor(rng.normal(0.0, 1.0, (G, 1)), dtype=torch.float32,
                                     device=device))
        cen = torch.tensor(rng.uniform(-10, 20, (200, 1)), dtype=torch.float32, device=device)
        hts = torch.tensor(rng.uniform(0.05, 0.2, 200), dtype=torch.float32, device=device)
        for name, kernel, ref, tile in (
                ("deposit_windowed_1d", DK.deposit_windowed_1d, DK.deposit_windowed_1d_ref, 1024),
                ("deposit_dense_1d_kernel", DK.deposit_dense_1d_kernel,
                 DK.deposit_dense_1d_kernel_ref, 512)):
            if not DK.wide_reach(gg, tile):
                raise AssertionError(f"{name} G={G} sigma={sigma}: the reach does not span the grid")
            n0 = kernel.launches
            what = f"{name}[reach spans the grid] G={G} sigma={sigma}"

            def compare(what, got, want):
                errs = check_deposit(what, got[0], got[1], want[0], want[1])
                return max(e for e, _ in errs.values())
            # a listed hill meets every point (the support counted once a point)
            support, dense, nbytes = deposit_work(gg, cen)
            work = bound(dense * DIST_FLOPS + min(support, dense) * HILL_FLOPS, nbytes)
            rows[what] = check_row(torch, what, lambda: kernel(gg, cen, hts),
                                   lambda: ref(gg, cen, hts), compare, work)
            if kernel.launches == n0:
                raise AssertionError(f"{what}: the kernel did not launch")
    print_rows(rows)
    print(f"dense liquid kernel checks (K2's tail {n_tail} rows at the end of run (b); launches "
          f"{counts}): {time.perf_counter() - t0:.1f} s")
    return rows


def dense_liquid_phase(torch, device):
    """The dense 32,000-atom liquid at cap 96 (``liquid_setup``): for each
    run (a), (b), (c) the 20 kT = 0 steps through both routes
    (``liquid_zero_temperature``) and the kT = 0.8 run (``liquid_run``),
    then ``liquid_kernel_phase`` on the runs' end states.  Returns {"rows",
    "runs", "seconds"}."""
    t0 = time.perf_counter()
    runs, seconds = {}, {}
    for run in LIQUID_RUNS:
        t = time.perf_counter()
        liquid_zero_temperature(torch, device, run)
        t1 = time.perf_counter()
        runs[run] = liquid_run(torch, device, run)
        seconds[run] = (t1 - t, time.perf_counter() - t1)
    t = time.perf_counter()
    rows = liquid_kernel_phase(torch, device, runs)
    seconds["checks"] = time.perf_counter() - t
    print(f"dense liquid phase seconds: " + ", ".join(
        f"({k}) kT=0 {v[0]:.1f} + run {v[1]:.1f}" if isinstance(v, tuple) else f"{k} {v:.1f}"
        for k, v in seconds.items()) + f"; total {time.perf_counter() - t0:.1f}")
    return dict(rows=rows, runs=runs, seconds=seconds)


@contextlib.contextmanager
def plain_deposition():
    """Route ``ops/deposit.deposit`` through K4's and K5's plain versions."""
    from edm_tpu_torch.ops import deposit_kernels as DK

    saved = DK.deposit_windowed_1d, DK.deposit_dense_1d_kernel
    DK.deposit_windowed_1d = DK.deposit_windowed_1d_ref
    DK.deposit_dense_1d_kernel = DK.deposit_dense_1d_kernel_ref
    try:
        yield
    finally:
        DK.deposit_windowed_1d, DK.deposit_dense_1d_kernel = saved


def deposit_grids(torch, device, carried=False):
    """The two deposition cases: bench_deposition's (G = 1e6 periodic over
    [0, 10], sigma 0.01, 200 centres from default_rng(3), height 0.1; the
    K4 route) and G = 32768 over [0, 10] with sigma 0.5 (W = 18,537; the K5
    route), with the same hills.  ``carried``: each grid already carries a
    round of 200 other hills (centres from default_rng(4), heights 0.05 to
    0.15, deposited by the plain versions), as every round of the main path
    after the first finds it."""
    from edm_tpu_torch.gauss import GaussGrid

    rng = np.random.default_rng(3)
    c = torch.tensor(rng.uniform(0, 10, (200, 1)), dtype=torch.float32, device=device)
    h = torch.full((200,), 0.1, dtype=torch.float32, device=device)
    k4 = GaussGrid.create([0], [10], [10.0 / 1_000_000], [True], [0.01], device=device)
    k5 = GaussGrid.create([0], [10], [10.0 / 32768], [True], [0.5], device=device)
    for gg, narrow in ((k4, True), (k5, False)):
        W, G = gg.spec.window_shape[0], gg.spec.grid.nbins[0]
        if (W + 256 < G // 2) != narrow:
            raise AssertionError(f"G={G}, W={W} does not take the intended route")
    if carried:
        rng = np.random.default_rng(4)
        c0 = torch.tensor(rng.uniform(0, 10, (200, 1)), dtype=torch.float32, device=device)
        h0 = torch.tensor(rng.uniform(0.05, 0.15, 200), dtype=torch.float32, device=device)
        with plain_deposition():
            k4, _ = k4.add_value(c0, h0)
            k5, _ = k5.add_value(c0, h0)
        if not (float(k4.grid.values.abs().max()) > 0 and float(k5.grid.derivs.abs().max()) > 0):
            raise AssertionError("the carried grids are empty")
    return k4, k5, c, h


def check_deposit(what, gg, added, gg_ref, added_ref):
    """A deposition against its plain version, field by field: values and
    derivatives within 1e-4 and 3e-4 of the plain version's max|.|,
    bias_added within 2e-6.  Returns {field: (max |diff|, bound)}."""
    out = {}
    for name, a, b, bnd in (
            ("values", gg.grid.values, gg_ref.grid.values, 1e-4),
            ("derivs", gg.grid.derivs, gg_ref.grid.derivs, 3e-4),
            ("bias_added", added, added_ref, None)):
        bnd = 2e-6 if bnd is None else bnd * float(b.abs().max())
        e = max_err(a, b)
        if not e <= bnd:
            raise AssertionError(f"{what} {name}: max |diff| {e:.3e} > bound {bnd:.3e}")
        out[name] = (e, bnd)
    print(f"  {what}: " + ", ".join(f"{k} {e:.3e} (bound {b:.3e})" for k, (e, b) in out.items()))
    return out


def deposit_work(gg, c):
    """A deposition's least time: every point against every hill for the
    dense kernel, the support points only for the windowed one; values and
    derivatives read and written once, centres and heights read,
    bias_added written."""
    g = gg.spec.grid
    G, H = g.nbins[0], c.shape[0]
    radius = np.sqrt(8.0) * gg.spec.sigma[0]  # p^2 < GAUSS_SUPPORT
    x = (c.double().cpu().numpy().reshape(-1) - g.min[0]) / g.dx[0]
    support = float(np.sum(np.floor(x + radius / g.dx[0]) - np.ceil(x - radius / g.dx[0]) + 1))
    nbytes = 4 * (4 * G + 3 * H)
    return support, G * H, nbytes


def deposit_kernel_phase(torch, device):
    """K4 and K5 against their plain versions (``check_deposit``) on grids
    that already carry hills, so that the kernels' read of the old grid is
    held to the plain version's; and each bias_added within 1e-3 of its
    height (a periodic grid keeps every hill whole)."""
    from edm_tpu_torch.ops import deposit_kernels as DK

    k4, k5, c, h = deposit_grids(torch, device, carried=True)
    rows = {}
    print("deposition kernels vs plain versions, on carried grids:")
    for name, gg, kern, ref in (
            ("deposit_windowed_1d G=1000000 sigma=0.01", k4, DK.deposit_windowed_1d,
             DK.deposit_windowed_1d_ref),
            ("deposit_dense_1d_kernel G=32768 sigma=0.5", k5, DK.deposit_dense_1d_kernel,
             DK.deposit_dense_1d_kernel_ref)):
        out, ba = kern(gg, c, h)
        out_ref, ba_ref = ref(gg, c, h)
        torch.cuda.synchronize()
        errs = check_deposit(name, out, ba, out_ref, ba_ref)
        cons = float(((ba.double() - h.double()) / h.double()).abs().max())
        if not cons <= 1e-3:
            raise AssertionError(f"{name}: bias_added off its height by {cons:.3e} relative")
        ms = cuda_ms(torch, lambda: kern(gg, c, h))
        plain = cuda_ms(torch, lambda: ref(gg, c, h), reps=10)
        support, dense, nbytes = deposit_work(gg, c)
        windowed = kern is DK.deposit_windowed_1d
        flops = (support * (DIST_FLOPS + HILL_FLOPS) if windowed
                 else dense * DIST_FLOPS + support * HILL_FLOPS)
        rows[name] = (max(e for e, _ in errs.values()), ms, plain) + bound(flops, nbytes)
    print_rows(rows)
    return rows


def deposition_run(torch, device, rounds=256):
    """bench_deposition through ``GaussGrid.add_value``: 256 rounds of the
    200 hills at c + k * 1e-7 on the 1e6-point grid, timed by the host clock
    up to a device sync; the K4 counter is set to 0 just before and read
    just after.  The grid those rounds leave is held to the same rounds
    through the plain versions (``check_deposit``).  Then one round on the
    K5 grid, carrying hills already, counted and held the same way; the
    host syncs of a round on each route (none allowed), and the device-busy
    share and the device launches of a round (``torch.profiler``; at most
    12 launches on the K4 route)."""
    from edm_tpu_torch.ops import deposit_kernels as DK

    k4, _, c, h = deposit_grids(torch, device)
    _, k5, _, _ = deposit_grids(torch, device, carried=True)
    g, _ = k4.add_value(c, h)  # warm-up
    torch.cuda.synchronize()
    DK.deposit_windowed_1d.launches = 0
    g = k4
    total = torch.zeros((), dtype=torch.float64, device=device)
    t0 = time.perf_counter()
    for k in range(rounds):
        g, added = g.add_value(c + k * 1e-7, h)
        total = total + added.sum()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n4 = DK.deposit_windowed_1d.launches
    DK.deposit_dense_1d_kernel.launches = 0
    g5, added5 = k5.add_value(c, h)
    torch.cuda.synchronize()
    n5 = DK.deposit_dense_1d_kernel.launches
    print("deposition path vs the same rounds through the plain versions:")
    with plain_deposition():
        g_ref = k4
        for k in range(rounds):
            g_ref, added_ref = g_ref.add_value(c + k * 1e-7, h)
        g5_ref, added5_ref = k5.add_value(c, h)
    check_deposit(f"K4, after {rounds} rounds (last round's bias_added)", g, added, g_ref,
                  added_ref)
    check_deposit("K5, one round on a carried grid", g5, added5, g5_ref, added5_ref)
    expected = rounds * float(h.sum())
    # host syncs of a round on each route (CUDA sync-debug mode)
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for gg in (g, g5):
                gg.add_value(c, h)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    device_ms, round_launches = {}, {}
    for what, gg, wall in (("K4 round", g, dt / rounds * 1e6), ("K5 round", g5, None)):
        dev_us, per, top, round_launches[what[:2]] = device_time_us(
            torch, lambda: gg.add_value(c, h), 20)
        device_ms[what[:2]] = funcs_ms(per, DEPOSIT_FUNCS)
        if wall is None:  # the K5 round's wall time, host clock to a sync
            t0 = time.perf_counter()
            for _ in range(20):
                gg.add_value(c, h)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 20 * 1e6
        print(busy_line(f"add_value {what}", dev_us, wall, top))
    checks = {
        "finite": bool(torch.isfinite(g.grid.values).all()) and bool(
            torch.isfinite(g5.grid.values).all()),
        "K4 launched every round": n4 >= rounds,
        "K5 launched": n5 > 0,
        "conservation": abs(float(total) - expected) <= 1e-3 * expected,
        "no host sync in add_value": syncs == 0,
        "at most 12 device launches in a K4 round": 0 < round_launches["K4"] <= 12,
    }
    print(f"deposition (GaussGrid.add_value, G=1e6, 200 hills x {rounds} rounds): "
          f"{200 * rounds / dt:.1f} hills/s, launches K4 {n4} K5 {n5}, "
          f"bias added {float(total):.6g} of {expected:.6g}, host syncs per round "
          f"{syncs / 2:g}, device launches per add_value round {round_launches}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"deposition run failed: {failed}")
    return (200 * rounds / dt, {"deposit_windowed_1d": n4, "deposit_dense_1d_kernel": n5},
            device_ms)


COORD_N = 10000  # bench.py:bench_coord2d
COORD_CFG = ("tempering 0\nhill_prefactor 0.1\nbias_per_step 1.0\nhill_density 250\n"
             "dimension 2\nbox_low 0 0\nbox_high 10 10\nbias_spacing 0.01 0.01\n"
             "bias_sigma 0.05 0.05\n")
# card vs CPU, each step from the same input state: positions, velocities
# and forces take the same IEEE operations on both (no transcendental in the
# lookup) and are held to 4 float32 ulps of their max; the bias grid,
# its corner table and the buffered heights sum 2048 hills in another order
# (cuBLAS against the CPU's BLAS) from exp() an ulp apart: 1e-5 of max|.|;
# cum_bias and the energy (sums of the same) 1e-5 relative
COORD_ULPS, COORD_GRID_REL = 4, 1e-5
# each hill round's growth of the grid's integral against its round_bias:
# float32 grids add terms of ~1e-4 at ~3e5 points a round (6.7e-8 seen on
# the CPU at full width)
COORD_INTEGRAL_REL = 1e-5


def coord_setup(torch, kT: float, device, periodic=True):
    """bench.py:bench_coord2d's configuration through the port's entry
    points: bias.subdivide ([0, 10]^2; periodic, 1000 x 1000 points, or
    with ``periodic=False`` the bench's ``mcgdp=True`` box, 1001 x 1001
    points with McGovern-De Pablo walls on both dims) ->
    coord_edm.init_state (10,000 free particles from default_rng(77),
    PRNGKey(0), the cached corner table) -> make_step(hill_stride=10,
    static_do_hills=True / False), hill_capacity at its default 2048."""
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.models import coord_edm
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.utils.config import parse_edm_text

    cfg = parse_edm_text(COORD_CFG)
    params, bs = B.subdivide(cfg, 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10],
                             [periodic] * 2, [0, 0], dtype=torch.float32, device=device)
    rng = np.random.default_rng(77)
    x0 = torch.tensor(rng.uniform(0, 10, (COORD_N, 2)), dtype=torch.float32, device=device)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    steps = [coord_edm.make_step(params, lp, hill_stride=10, static_do_hills=h)
             for h in (True, False)]
    state = coord_edm.init_state(params, bs, x0, PRNGKey(0), lp)
    if state.ptab is None or steps[0].hill_capacity != 2048:
        raise AssertionError("the 2-D bench state lacks its corner table or hill capacity")
    return state, steps


def tree_to(obj, device):
    """A state's tensors on ``device`` (dataclasses rebuilt field by field)."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: tree_to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    return obj


def coord_compare(i, ks, ps, worst, label="2-D"):
    """One step of the card's 2-D run against the CPU's from the same
    input: integer leaves exactly, the rest as ``COORD_*`` states; the
    worst difference of each leaf goes to ``worst``."""

    def exact(name, a, b):
        if not bool((a.cpu() == b.cpu()).all()):
            raise AssertionError(f"{label} step {i}: {name} differs between the card and the CPU")

    def near(name, a, b, rel, ulps=None):
        a, b = a.cpu().double(), b.cpu().double()
        scale = max(1.0, float(b.abs().max()))
        bnd = ulps * float(np.spacing(np.float32(scale))) if ulps else rel * scale
        e = float((a - b).abs().max())
        worst[name] = max(worst.get(name, 0.0), e)
        if not e <= bnd:
            raise AssertionError(f"{label} step {i}: {name} differs by {e:.3e} > {bnd:.3e}")

    if not np.array_equal(ks.key, ps.key):
        raise AssertionError(f"{label} step {i}: key differs")
    exact("step", ks.step, ps.step)
    exact("hills_truncated", ks.hills_truncated, ps.hills_truncated)
    kb, pb = ks.bias, ps.bias
    for name in ("buf_left", "buf_right", "overflow_error", "steps"):
        exact(name, getattr(kb, name), getattr(pb, name))
    exact("cv_hist", kb.cv_hist.values, pb.cv_hist.values)
    for name in ("x", "v", "f"):
        near(name, getattr(ks, name), getattr(ps, name), None, COORD_ULPS)
    for name, a, b in (("grid values", kb.bias.grid.values, pb.bias.grid.values),
                       ("grid derivs", kb.bias.grid.derivs, pb.bias.grid.derivs),
                       ("ptab", ks.ptab, ps.ptab), ("buf_h", kb.buf_h, pb.buf_h),
                       ("buf_pos", kb.buf_pos, pb.buf_pos)):
        near(name, a, b, COORD_GRID_REL)
    for name, a, b in (("cum_bias", kb.cum_bias, pb.cum_bias), ("energy", ks.energy, ps.energy)):
        a, b = float(a), float(b)
        worst[name] = max(worst.get(name, 0.0), abs(a - b))
        if not abs(a - b) <= COORD_GRID_REL * max(1.0, abs(b)):
            raise AssertionError(f"{label} step {i}: {name} {a!r} on the card, {b!r} on the CPU")


def coord_label(periodic) -> str:
    return "2-D" if periodic else "McGDP"


def require_full_f32(torch):
    """The 2-D deposits run their products in full float32 (the JAX
    package's Precision.HIGHEST)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the 2-D phases need full float32")


def coord_zero_temperature(torch, device, n_steps=20, periodic=True):
    """The 2-D slice at full width, 20 steps at kT = 0 (the thermostat's
    normals drop out): each step taken from the same input state by the
    port on the card and by the port on the CPU (float32), held to each
    other by ``coord_compare``; two of them are hill steps."""
    require_full_f32(torch)
    cpu = torch.device("cpu")
    state, steps = coord_setup(torch, 0.0, device, periodic)
    _, steps_cpu = coord_setup(torch, 0.0, cpu, periodic)
    worst, hills = {}, 0
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 1
        ref, _ = steps_cpu[k](tree_to(state, cpu))
        state, _ = steps[k](state)
        coord_compare(i, state, ref, worst, coord_label(periodic))
        hills += k == 0
    if hills < 2 or not float(state.bias.cum_bias) > 0:
        raise AssertionError(f"the kT = 0 {coord_label(periodic)} run deposited no hills")
    b = state.bias
    print(f"kT=0 {coord_label(periodic)}: {n_steps} steps ({hills} hill steps) on the card match the port on the "
          f"CPU step for step; integer leaves equal (last: step {int(state.step)}, hill rounds "
          f"{int(b.steps)}, buf_left {int(b.buf_left)}, buf_right {int(b.buf_right)}, "
          f"overflow {bool(b.overflow_error)}, truncated {bool(state.hills_truncated)}); "
          f"worst |diff|: " + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))


def sync_sites(torch, fn):
    """Run ``fn`` under CUDA sync-debug mode: {"file:line": count} of the
    Python lines whose calls synchronized with the card."""
    sites = {}
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    root = os.path.dirname(os.path.abspath(__file__))
    for w in caught:
        if "synchroniz" in str(w.message):
            site = f"{os.path.relpath(w.filename, root)}:{w.lineno}"
            sites[site] = sites.get(site, 0) + 1
    return sites


def coord_run(torch, device, warm_steps=100, timed_steps=1000, periodic=True):
    """The bench's kT = 1.0 2-D run: ``warm_steps`` step by step, each hill
    round's growth of the grid's integral (values.sum() dx dy, in float64)
    held to its round_bias; then ``timed_steps`` in whole stride cycles
    through ``driver.strided_segment`` (host clock up to a device sync),
    with the Threefry counter set to 0 just before and read just after.
    Then one cycle's profile (device-busy share, launches per step, top
    device operations) and the host syncs of a hill step and a plain step
    (CUDA sync-debug mode), each named by the line that made it."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.ops import prng

    require_full_f32(torch)
    label = coord_label(periodic)
    state, steps = coord_setup(torch, 1.0, device, periodic)
    g = state.bias.bias.spec.grid
    vol = g.dx[0] * g.dx[1]
    worst_int = 0.0
    for i in range(warm_steps):
        hill = i % 10 == 0
        if hill:
            before = float(state.bias.bias.grid.values.double().sum()) * vol
            cum0 = float(state.bias.cum_bias)
        state, _ = steps[0 if hill else 1](state)
        if hill:
            grown = float(state.bias.bias.grid.values.double().sum()) * vol - before
            rb = float(state.bias.cum_bias) - cum0
            worst_int = max(worst_int, abs(grown - rb) / max(rb, 1e-30))
            if not (rb > 0 and abs(grown - rb) <= COORD_INTEGRAL_REL * rb):
                raise AssertionError(f"{label} hill round at step {i}: the grid's integral "
                                     f"grew by {grown!r}, its round_bias is {rb!r}")
    for s in steps:
        s.host_syncs = 0
    seg = strided_segment(steps[0], steps[1], 10, timed_steps)
    torch.cuda.synchronize()
    prng.threefry_bits.launches = 0
    t0 = time.perf_counter()
    state, e = seg(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_tf = prng.threefry_bits.launches
    syncs = sum(s.host_syncs for s in steps)
    cycle = strided_segment(steps[0], steps[1], 10, 10)
    dev_us, per, top, per_cycle = device_time_us(torch, lambda: cycle(state), 2)
    print(busy_line(f"kT=1.0 {label} stride cycle", dev_us, 10 * dt / timed_steps * 1e6, top))
    census, counted = {}, {}
    for name, step in (("hill step", steps[0]), ("plain step", steps[1])):
        before = step.host_syncs
        census[name] = sync_sites(torch, lambda: step(state))
        counted[name] = step.host_syncs - before
    b = state.bias
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.f, e,
                                                               b.bias.grid.values)),
        "no overflow_error": not bool(b.overflow_error),
        "no hills_truncated": not bool(state.hills_truncated),
        "cum_bias > 0": float(b.cum_bias) > 0,
        "Threefry kernel: two launches a step": n_tf == 2 * timed_steps,
        "no sync on plain steps": not census["plain step"],
        "every sync counted by the steps": all(
            sum(census[k].values()) == counted[k] for k in census),
    }
    for name, sites in census.items():
        print(f"host syncs of a {label} {name} (CUDA sync-debug mode): {sum(sites.values())}"
              + "".join(f"; {site} x{n}" for site, n in sites.items())
              + f" (counted by the step: {counted[name]})")
    print(f"host syncs counted by the {label} steps: {syncs / (timed_steps / 10):.2f} per "
          f"stride cycle")
    shape = "x".join(map(str, g.nbins))
    print(f"kT=1.0 {label} (N={COORD_N}, {shape} grid, hill_capacity 2048): {timed_steps} steps "
          f"after {warm_steps} warm-up: {timed_steps / dt:.2f} steps/s, device launches per step "
          f"{per_cycle / 10:.1f}, Threefry launches {n_tf}, cum_bias {float(b.cum_bias):.6g}, "
          f"hill rounds {int(b.steps)}, buffered {int(b.buf_right)}, worst integral vs "
          f"round_bias {worst_int:.3e} relative")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=1.0 {label} run failed: {failed}")
    return timed_steps / dt, n_tf, funcs_ms(per, TF_FUNCS, 20.0)


# the McGDP deposit against the windowed one: the e^-8 corner class of
# tests/test_deposit_mcgdp2d.py (3 B on values, 40 B on derivatives, B =
# sum(h) e^-8 / (pi sigma'_0 sigma'_1)), plus float32 rounding: 1e-5 of
# max|.| (COORD_GRID_REL)
MCGDP_CORNER = (3.0, 40.0)


def mcgdp_deposit_phase(torch, device):
    """The first hill round of the McGDP run at full width: its compacted
    centres and effective heights deposited on its round-start grid through
    ``dense_tables_mcgdp`` + ``deposit_from_mcgdp`` and through
    ``hill_windows`` + ``deposit_precomputed`` (the reference-exact route of
    ``exact_deposit=True``), on the card; the two held to each other within
    the corner class, and h s to the windowed bias_added."""
    import math

    from edm_tpu_torch import bias as B
    from edm_tpu_torch.ops import deposit as D

    require_full_f32(torch)
    state, steps = coord_setup(torch, 1.0, device, periodic=False)
    rounds = []
    add_hills_round = B.add_hills_round

    def spy(params, bs, pos, *args, **kw):
        out = add_hills_round(params, bs, pos, *args, **kw)
        rounds.append((bs.bias, pos, out[1].hill_dep_h))
        return out

    B.add_hills_round = spy
    try:
        steps[0](state)
    finally:
        B.add_hills_round = add_hills_round
    gg, pos, dep_h = rounds[0]
    tabs = D.dense_tables_mcgdp(gg, pos)
    gm, reads = D.deposit_from_mcgdp(gg, tabs, dep_h)
    gw, added = D.deposit_precomputed(gg, D.hill_windows(gg, pos), dep_h)
    sig = gg.spec.sigma
    B_ = float(dep_h.double().sum()) * math.exp(-8.0) / (math.pi * sig[0] * sig[1])
    errs = {}
    for name, a, b, k in (("values", gm.grid.values, gw.grid.values, MCGDP_CORNER[0]),
                          ("derivs", gm.grid.derivs, gw.grid.derivs, MCGDP_CORNER[1])):
        lim = k * B_ + COORD_GRID_REL * float(b.abs().max())
        errs[name] = (max_err(a, b), lim)
    vol = float(np.prod(gg.spec.grid.dx))
    hs = float((dep_h.double() * tabs.s.double()).sum())
    errs["h s vs bias_added"] = (abs(hs - float(added.double().sum())),
                                 5.0 * B_ * vol * gm.grid.values.numel()
                                 + COORD_GRID_REL * abs(hs))
    n_hills = int((dep_h != 0).sum())
    ms_m = cuda_ms(torch, lambda: D.deposit_from_mcgdp(gg, D.dense_tables_mcgdp(gg, pos), dep_h),
                   reps=5, warm=1)
    ms_w = cuda_ms(torch, lambda: D.deposit_precomputed(gg, D.hill_windows(gg, pos), dep_h),
                   reps=5, warm=1)
    print(f"McGDP deposit vs windowed (first hill round, {n_hills} of {pos.shape[0]} rows "
          f"deposit, {'x'.join(map(str, gg.spec.grid.nbins))} grid, strip-count reads {reads}): "
          + ", ".join(f"{k} {e:.3e} (bound {b:.3e})" for k, (e, b) in errs.items())
          + f"; B = {B_:.3e}; {ms_m:.2f} ms tables + deposit, {ms_w:.2f} ms windowed "
          "(CUDA events)")
    bad = [k for k, (e, b) in errs.items() if not e <= b]
    if bad or n_hills == 0:
        raise AssertionError(f"McGDP deposit vs windowed failed: {bad or 'no hill deposited'}")


# the draw kernel's shapes: ragged and tiny n, the 2-D step's acceptance
# (10,000) and thermostat (20,000) draws, the dense host's N^2 = 10^6
# uniforms (16-byte stores from prng.DRAW_VEC_MIN) and a ragged large n
TF_DRAW_SIZES = (1, 31, 257, 10000, 20000, 20001, 10**6, 10**6 + 3)
# a normal on the card against its plain version, in ulps: CUDA's erfinvf /
# erfinv (at most 2 / 5 ulps from the exact value, CUDA's math library
# documentation), PyTorch's CPU erfinv (within 1 ulp of the exact value at
# every argument sampled), and the product by sqrt(2), one rounding
TF_NORMAL_ULPS = {"torch.float32": 4, "torch.float64": 7}


def erfinv_ulps(torch, device):
    """``torch.erfinv`` on the card (CUDA's erfinv, what the earlier card
    route of a normal draw called) against PyTorch's CPU erfinv, in ulps of
    the result: over every float32 argument a Threefry normal can take
    (u = max(lo, f span + lo) for each of the 2^23 float32 uniforms f) and
    over the arguments of 4 x 10^6 float64 draws.  {dtype: (max ulps,
    counts of 0, 1, 2, ... ulps)}."""
    from edm_tpu_torch.ops import prng

    out = {}
    for dt in (torch.float32, torch.float64):
        lo, span, _ = prng._normal_consts(dt)
        if dt == torch.float32:
            f = (torch.arange(2**23, dtype=torch.float64) * 2.0**-23).to(dt)
        else:
            f = prng.uniform_ref(prng.PRNGKey(9), (4 * 10**6,), dt)
        lo_t = torch.tensor(lo, dtype=dt)
        u = torch.maximum(lo_t, f * torch.tensor(span, dtype=dt) + lo_t)
        a, b = torch.erfinv(u.to(device)).cpu().numpy(), torch.erfinv(u).numpy()
        e = np.abs(a - b) / np.spacing(np.maximum(np.abs(a), np.abs(b)))
        out[str(dt)] = (float(e.max()), np.bincount(np.rint(e).astype(np.int64)).tolist())
    return out


def threefry_kernel_phase(torch, device):
    """The draw kernel ``tf_bits`` against its plain versions at
    ``TF_DRAW_SIZES``, two keys: the bits (both forms) and the uniforms
    (float32, float64) bitwise, the normals within ``TF_NORMAL_ULPS`` (the
    ulps printed, and whether they are bitwise the earlier card route: the
    kernel's bits through the PyTorch ops on the card), one launch a draw.
    Its time on the 2-D thermostat's 20,000 normals and on the dense host's
    10^6 uniforms beside the plain versions' (the numpy chain, the PyTorch
    ops on the CPU and the copy to the card), the earlier card route's and
    the bound; the phase's seconds."""
    from edm_tpu_torch.ops import prng

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    ulps, old_ulps, z_err = {f32: 0.0, f64: 0.0}, {f32: 0.0, f64: 0.0}, 0.0
    for n in TF_DRAW_SIZES:
        for seed in (0, 2**33 + 5):
            key = prng.PRNGKey(seed)
            got = {}
            for what, fn, ref in (
                    ("bits", lambda: prng.threefry_bits(key, n, device),
                     lambda: prng._bits_ref(key, n, False)),
                    ("wide bits", lambda: prng.threefry_bits(key, n, device, wide=True),
                     lambda: prng._bits_ref(key, n, True)),
                    ("float32 uniforms", lambda: prng.uniform(key, (n,), f32, device),
                     lambda: prng.uniform_ref(key, (n,), f32)),
                    ("float64 uniforms", lambda: prng.uniform(key, (n,), f64, device),
                     lambda: prng.uniform_ref(key, (n,), f64))):
                n0 = prng.threefry_bits.launches
                got[what] = fn()
                torch.cuda.synchronize()
                bad = int((got[what].cpu() != ref()).sum())
                if bad or prng.threefry_bits.launches != n0 + 1:
                    raise AssertionError(f"tf_bits {what} n={n} seed={seed}: {bad} differ from the "
                                         f"plain version, {prng.threefry_bits.launches - n0} "
                                         "launches")
            for dt in (f32, f64):
                n0 = prng.threefry_bits.launches
                z = prng.normal(key, (n,), dt, device)
                if prng.threefry_bits.launches != n0 + 1:
                    raise AssertionError(f"tf_bits normals n={n}: not one launch")
                bits = got["wide bits" if dt == f64 else "bits"]
                old = prng._normal_chain(prng._uniform_chain(bits, dt), dt)
                z_ref = prng.normal_ref(key, (n,), dt)
                ulps[dt] = max(ulps[dt], max_ulps(z, z_ref))
                old_ulps[dt] = max(old_ulps[dt], max_ulps(z, old))
                if dt == f32:
                    z_err = max(z_err, max_err(z.cpu(), z_ref))
    if not all(ulps[dt] <= TF_NORMAL_ULPS[str(dt)] for dt in (f32, f64)):
        raise AssertionError(f"tf_bits normals: {ulps[f32]} / {ulps[f64]} ulps (float32 / "
                             f"float64) from the plain version, bound {TF_NORMAL_ULPS}")
    same = "bitwise" if max(old_ulps.values()) == 0 else (
        f"not bitwise: {old_ulps[f32]} / {old_ulps[f64]} ulps from")
    erf = erfinv_ulps(torch, device)
    rows = {}
    key = prng.PRNGKey(0)
    shape = (COORD_N, 2)
    d = COORD_N * 2
    ms = cuda_ms(torch, lambda: prng.normal(key, shape, f32, device))
    plain = cuda_ms(torch, lambda: prng.normal_ref(key, shape, f32).to(device), reps=10)
    old_ms = cuda_ms(torch, lambda: prng._normal_chain(
        prng._uniform_chain(prng.threefry_bits(key, d, device), f32), f32))
    rows[f"threefry_bits normal {d}"] = (z_err, ms, plain) + tf_bound(d, 4 * d, normal=True)
    d2 = PAIR_N["dense"] ** 2
    ms2 = cuda_ms(torch, lambda: prng.uniform(key, (d2,), f32, device))
    plain2 = cuda_ms(torch, lambda: prng.uniform_ref(key, (d2,), f32).to(device), reps=3, warm=1)
    old_ms2 = cuda_ms(torch, lambda: prng._uniform_chain(prng.threefry_bits(key, d2, device), f32))
    rows[f"threefry_bits uniform {d2}"] = (0.0, ms2, plain2) + tf_bound(d2, 4 * d2)
    print(f"tf_bits (the draw kernel): bits and uniforms bitwise the plain versions, normals "
          f"{ulps[f32]} / {ulps[f64]} ulps (float32 / float64; bound {TF_NORMAL_ULPS[str(f32)]} / "
          f"{TF_NORMAL_ULPS[str(f64)]}), {same} the earlier card route (tf_bits' bits through "
          f"the PyTorch ops on the card); one launch a draw; n = "
          f"{', '.join(map(str, TF_DRAW_SIZES))}, 2 keys.  The earlier card route: {old_ms:.4f} "
          f"ms for {d} normals, {old_ms2:.4f} ms for {d2} uniforms (CUDA events, against "
          f"{ms:.4f} and {ms2:.4f}); {time.perf_counter() - t0:.1f} s")
    for dt, (worst, hist) in erf.items():
        print(f"torch.erfinv on the card against the CPU, {dt} "
              f"({'every argument of a normal' if dt == str(f32) else '4e6 draws'}): max {worst} "
              f"ulps; arguments at 0, 1, 2, ... ulps: {hist}")
    print_rows(rows)
    return rows


# ---------------------------- the dense and blocked pair hosts, the XLA pass

PAIR_N = {"blocked": 10000, "dense": 1000}  # bench_pairwise; its --quick size
PAIR_BLOCK = 500  # bench_pairwise's block=500
# card vs CPU, each dense step from the same input state: forces sum 1,000
# pairs a row in another order (2e-5 * max(1, max|.|), as the kernels);
# positions and velocities follow them; the grid, its buffer and cum_bias
# as the 2-D cell's
PAIR_REL = FORCE_REL


def pair_setup(torch, kT: float, device, host):
    """bench_pairwise's LJ fluid and bias on the dense or the blocked host
    (``PAIR_N`` atoms; box 27.72^3 at 10,000, 12.6^3 at 1,000; kT, dt
    0.002, hill_stride 10, hill_capacity 2048, the exact lookup; the
    blocked host with block_size 500): pair_edm.init_state and the static
    hill and plain steps."""
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.models.pair_edm_blocked import make_step_blocked
    from edm_tpu_torch.ops.prng import PRNGKey

    n = PAIR_N[host]
    params, bias_state = bench_bias(torch, device)
    pts, box = bench_lattice(n)
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    state = pair_edm.init_state(bias_state, torch.tensor(pts, dtype=torch.float32,
                                                         device=device),
                                PRNGKey(0), n_est=n * 40)
    kw = dict(hill_stride=10, hill_capacity=2048)
    if host == "blocked":
        steps = [make_step_blocked(params, lp, lj, box, block_size=PAIR_BLOCK,
                                   static_do_hills=h, **kw) for h in (True, False)]
    else:
        steps = [pair_edm.make_step(params, lp, lj, box, static_do_hills=h, **kw)
                 for h in (True, False)]
    return state, steps


@contextlib.contextmanager
def plain_rows():
    """Route ``prng.threefry_rows`` through its plain version (the numpy
    chain), its draws copied to the card."""
    from edm_tpu_torch.ops import prng

    kernel = prng.threefry_rows
    prng.threefry_rows = lambda key, rows, n, dtype: (
        prng._rows_ref(key, rows, n, dtype).to(rows.device))
    try:
        yield
    finally:
        prng.threefry_rows = kernel


def threefry_rows_cases():
    """``threefry_rows``' check shapes, (label, ids (int64), n, dtypes): the
    blocked host's pass 1 (500 rows of 10,000) and pass 2 (2048 unsorted
    rows, the clamped padding rows repeating), the work-sharded host's
    chunks of 14 cap = 448 and 27 cap = 864 columns (1024 rows), a ragged
    n, short rows, and 70,000 rows (ids up to 2^32 - 1)."""
    n = PAIR_N["blocked"]
    pass2 = np.random.default_rng(9).permutation(n)[:2048]
    pass2[1500:] = n - 1  # padding rows draw row n-1's stream
    wide = np.random.default_rng(4).integers(0, 2**32, 70000)
    wide[:3] = (2**32 - 1, 2**31, 0)
    both = (np.float32, np.float64)
    cases = [("pass 1", np.arange(PAIR_BLOCK, 2 * PAIR_BLOCK), n, both),
             ("pass 2", pass2, n, (np.float32,)),
             ("work-sharded", np.arange(1024) + 7 * 1024, 864, both),
             ("work-sharded", np.arange(1024) + 7 * 1024, 448, both),
             ("ragged", np.arange(PAIR_BLOCK), n + 1, both)]
    cases += [("short", wide[:R], m, both) for R in (1, 3) for m in (1, 3, 5, 448, n + 1)]
    return cases + [("70,000 rows", wide, m, both) for m in (1, 3, 5)]


def threefry_rows_phase(torch, device):
    """``threefry_rows`` against its plain version, bitwise, at
    ``threefry_rows_cases`` in float32 and float64 (pass 1 and pass 2 also
    with int32 ids), one launch a call; the kernel's time at pass 1, pass 2
    and the work-sharded host's 1024 x 864 beside the plain version's (the
    numpy chain and its copy to the card, one call) and the bound; the
    phase's seconds."""
    from edm_tpu_torch.ops import prng

    t0 = time.perf_counter()
    key = prng.fold_in(prng.PRNGKey(0), 1)
    rows, checked = {}, 0
    for label, ids, n, types in threefry_rows_cases():
        for np_dt in types:
            dtype = torch.float64 if np_dt == np.float64 else torch.float32
            ref = prng._rows_ref(key, ids, n, dtype)
            for id_dt in (torch.int64, torch.int32)[:2 if label.startswith("pass") else 1]:
                r = torch.tensor(ids.astype(np.int64), device=device).to(id_dt)
                n0 = prng.threefry_rows.launches
                out = prng.threefry_rows(key, r, n, dtype)
                torch.cuda.synchronize()
                bad = int((out.cpu() != ref).sum())
                if bad or prng.threefry_rows.launches != n0 + 1:
                    raise AssertionError(f"threefry_rows {label} {len(ids)}x{n} {dtype} {id_dt}: "
                                         f"{bad} of {ref.numel()} uniforms differ from the numpy "
                                         f"chain, {prng.threefry_rows.launches - n0} launches")
                checked += 1
        if label in ("pass 1", "pass 2") or (label == "work-sharded" and n == 864):
            r = torch.tensor(ids, device=device)
            ms = cuda_ms(torch, lambda: prng.threefry_rows(key, r, n))
            plain = cuda_ms(torch, lambda: prng._rows_ref(key, ids, n, torch.float32).to(device),
                            reps=1, warm=0)
            R = len(ids)
            rows[f"threefry_rows {label} {R}x{n}"] = (0.0, ms, plain) + tf_bound(
                R * n, 4 * R * n + 8 * R, rows=R)
    print(f"threefry_rows: bitwise equal to the numpy chain in {checked} calls of one launch "
          f"each (pass 1 and 2 of 10000 columns, work-sharded 1024 x 864 and x 448, 500 x 10001, "
          f"1 and 3 rows of 1 to 10001, 70000 rows of 1, 3 and 5; float32 and float64, int64 "
          f"ids, pass 1 and 2 also int32); {time.perf_counter() - t0:.1f} s")
    print_rows(rows)
    return rows


def pair_zero_temperature(torch, device, host, n_steps=20):
    """20 steps at kT = 0 of the dense or the blocked host at full width,
    each from the same input state through two routes, two of them hill
    steps.  Blocked: the card with ``threefry_rows`` and the card with its
    plain version, held bitwise (every leaf).  Dense: the card and the CPU,
    integer leaves exactly, x, v and f within ``PAIR_REL`` of max(1,
    max|.|), the grid, cum_bias and the energy within ``COORD_GRID_REL``."""
    state, steps = pair_setup(torch, 0.0, device, host)
    if host == "dense":
        _, steps_cpu = pair_setup(torch, 0.0, torch.device("cpu"), host)
        state = thermalized(torch, device, host)
    worst = {}
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 1
        if host == "blocked":
            with plain_rows():
                ref, _ = steps[k](state)
        else:
            ref, _ = steps_cpu[k](tree_to(state, torch.device("cpu")))
        state, _ = steps[k](state)
        if host == "blocked":
            diffs = bitwise_diffs(state, ref)
            if diffs:
                raise AssertionError(f"blocked step {i}: threefry_rows against its plain "
                                     f"version changed {diffs}")
        else:
            pair_compare(i, state, ref, worst)
    b = state.bias
    if int(b.steps) < 2 or not float(b.cum_bias) > 0 or bool(state.hills_truncated):
        raise AssertionError(f"the kT = 0 {host} run: {int(b.steps)} hill rounds, cum_bias "
                             f"{float(b.cum_bias)}, truncated {bool(state.hills_truncated)}")
    how = ("with threefry_rows bitwise equal to the run with its plain version"
           if host == "blocked" else "match the port on the CPU step for step; worst |diff|: "
           + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    print(f"kT=0 {host} (N={PAIR_N[host]}): {n_steps} steps on the card {how} (hill rounds "
          f"{int(b.steps)}, last_calls {int(state.last_calls)}, cum_bias {float(b.cum_bias):.6g})")


def thermalized(torch, device, host, n_steps=100, n_atoms=None):
    """The start state of a kT = 0 check with real forces: ``n_steps``
    steps at kT = 0.8 from the lattice (on the lattice the net forces are
    sums of terms that cancel to ~1e-4, below float32 rounding of the
    terms); a cell path's at ``n_atoms`` (default ``N_ATOMS``)."""
    from edm_tpu_torch.models.driver import pattern_segment, strided_segment

    if host not in PAIR_N:  # a cell path
        _, state, hot = bench_setup(torch, 0.8, device, host, n_atoms=n_atoms)
        return pattern_segment(pattern(hot), n_steps)(state)[0]
    state, hot = pair_setup(torch, 0.8, device, host)
    return strided_segment(hot[0], hot[1], 10, n_steps)(state)[0]


def pair_compare(i, ks, ps, worst):
    """A dense step on the card against the CPU's from the same input."""
    def exact(name, a, b):
        if not bool((a.cpu() == b.cpu()).all()):
            raise AssertionError(f"dense step {i}: {name} differs between the card and the CPU")

    def near(name, a, b, rel):
        a, b = a.cpu().double(), b.cpu().double()
        e = float((a - b).abs().max())
        worst[name] = max(worst.get(name, 0.0), e)
        if not e <= rel * max(1.0, float(b.abs().max())):
            raise AssertionError(f"dense step {i}: {name} differs by {e:.3e}")

    if not np.array_equal(ks.key, ps.key):
        raise AssertionError(f"dense step {i}: key differs")
    for name in ("step", "last_calls", "hills_truncated"):
        exact(name, getattr(ks, name), getattr(ps, name))
    kb, pb = ks.bias, ps.bias
    for name in ("buf_left", "buf_right", "overflow_error", "steps"):
        exact(name, getattr(kb, name), getattr(pb, name))
    for name in ("x", "v", "f"):
        near(name, getattr(ks, name), getattr(ps, name), PAIR_REL)
    for name, a, b in (("grid values", kb.bias.grid.values, pb.bias.grid.values),
                       ("buf_h", kb.buf_h, pb.buf_h), ("cum_bias", kb.cum_bias, pb.cum_bias),
                       ("energy", ks.energy, ps.energy)):
        near(name, a, b, COORD_GRID_REL)


def pair_run(torch, device, host, warm_steps=100, timed_steps=300):
    """The kT = 0.8 run of the dense or the blocked host: ``warm_steps``,
    then ``timed_steps`` through ``driver.strided_segment`` (host clock up
    to a device sync) with the Threefry counters set to 0 just before and
    read just after; one stride cycle's profile (busy share, launches per
    step, top device operations) and the host syncs of a hill step and a
    plain step, each named by its line and all of them counted by the
    steps' ``host_syncs``."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.ops import prng

    state, steps = pair_setup(torch, 0.8, device, host)
    state, _ = strided_segment(steps[0], steps[1], 10, warm_steps)(state)
    for s in steps:
        s.host_syncs = 0
    seg = strided_segment(steps[0], steps[1], 10, timed_steps)
    torch.cuda.synchronize()
    prng.threefry_bits.launches = prng.threefry_rows.launches = 0
    t0 = time.perf_counter()
    state, e = seg(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_bits, n_rows = prng.threefry_bits.launches, prng.threefry_rows.launches
    syncs = sum(s.host_syncs for s in steps)
    cycle = strided_segment(steps[0], steps[1], 10, 10)
    dev_us, per, top, per_cycle = device_time_us(torch, lambda: cycle(state), 2)
    print(busy_line(f"kT=0.8 {host} stride cycle", dev_us, 10 * dt / timed_steps * 1e6, top))
    census, counted = {}, {}
    for name, step in (("hill step", steps[0]), ("plain step", steps[1])):
        before = step.host_syncs
        census[name] = sync_sites(torch, lambda: step(state))
        counted[name] = step.host_syncs - before
    for name, sites in census.items():
        print(f"host syncs of a {host} {name} (CUDA sync-debug mode): {sum(sites.values())}"
              + "".join(f"; {site} x{n}" for site, n in sites.items())
              + f" (counted by the step: {counted[name]})")
    cycles = timed_steps // 10
    blocks = PAIR_N[host] // PAIR_BLOCK
    b = state.bias
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.f, e,
                                                               b.bias.grid.values)),
        "no overflow_error": not bool(b.overflow_error),
        "no hills_truncated": not bool(state.hills_truncated),
        "cum_bias > 0": float(b.cum_bias) > 0,
        "no sync on plain steps": not census["plain step"],
        "every sync counted by the steps": all(
            sum(census[k].values()) == counted[k] for k in census),
    }
    if host == "blocked":
        checks["threefry_rows: a launch a block in pass 1 and one in pass 2, each hill step"] = (
            n_rows == cycles * (blocks + 1))
        checks["threefry_bits: the thermostat's draw each step"] = n_bits == timed_steps
    else:
        checks["threefry_bits: one a step and the N^2 draw a hill step"] = (
            n_bits == timed_steps + cycles and n_rows == 0)
    print(f"kT=0.8 {host} (N={PAIR_N[host]}): {timed_steps} steps after {warm_steps} warm-up: "
          f"{timed_steps / dt:.2f} steps/s, device launches per step {per_cycle / 10:.1f}, "
          f"host syncs {syncs / cycles:.2f} per stride cycle, threefry_bits launches {n_bits}, "
          f"threefry_rows launches {n_rows}, last_calls {int(state.last_calls)}, cum_bias "
          f"{float(b.cum_bias):.6g}, hill rounds {int(b.steps)}, buffered {int(b.buf_right)}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 {host} run failed: {failed}")
    # a cycle's draws: its 10 steps' normals, and the dense host's N^2 uniforms
    return timed_steps / dt, {"threefry_bits": n_bits, "threefry_rows": n_rows}, {
        "threefry_rows": funcs_ms(per, ("tf_rows",), blocks + 1),
        "threefry_bits": funcs_ms(per, ("tf_bits",), 10 if host == "blocked" else 11)}


def xla_zero_temperature(torch, device, n_steps=20):
    """20 kT = 0 steps of the 10k exact cell through the XLA force pass
    (``use_pallas=False``, ``cell_chunk=81``, full cap), from the state of
    100 kT = 0.8 steps (``thermalized``): before each step,
    the pass's forces and bias energy on the step's input state against
    K1's at full cap on the same state (the Hermite table of the live
    grid), within ``FORCE_REL``; K1 is the reference here, not on the
    path."""
    from edm_tpu_torch.ops import cellforce as CF

    spec, _, steps = bench_setup(torch, 0.0, device, "xla")
    state = thermalized(torch, device, "xla")
    worst = 0.0
    for i in range(n_steps):
        step = steps[0 if i % 10 == 0 else 2 if i % 10 == 9 else 1]
        e, f = step._xla_force(state, state.xs, True)
        f_k1, eb = CF.cell_force_newton(state.xs, state.mc,
                                        CF.hermite_pair_table(state.core.bias.bias),
                                        k=spec.cap, ncells=spec.ncells, box=spec.box,
                                        lj=step.lj, energy=True)
        worst = max(worst, check_forces(f"XLA pass step {i}", f, f_k1))
        check_energy(f"XLA pass step {i}", e, eb.sum())
        state, _ = step(state)
    b = state.core.bias
    if int(b.steps) < 2 or not float(b.cum_bias) > 0:
        raise AssertionError("the kT = 0 XLA run deposited no hills")
    print(f"kT=0 xla: {n_steps} steps of the XLA force pass, each state's forces against K1 "
          f"at full cap: worst |df| {worst:.3e} (bound {FORCE_REL} * max(1, max|f|)); hill "
          f"rounds {int(b.steps)}, cum_bias {float(b.cum_bias):.6g}")


# ------------------------------------------------ the multi-device layer

SLAB_RANKS = (2, 4)  # the slab host's rank counts at 10k: 9 columns as 5 + 4, and 3 + 2 + 2 + 2
# the brick host's grids at 10k (9 cells a side as 5 + 4): 7 x 7 x 9 windows
# with the row box ((1, 1, 0), (5, 5, 9)) on 2 x 2, 7^3 with ((1, 1, 1), (5, 5,
# 5)) on 2 x 2 x 2
BRICK_GRIDS = ((2, 2), (2, 2, 2))


def brick_label(grid) -> str:
    """"brick 2x2" for the grid (2, 2)."""
    return "brick " + "x".join(map(str, grid))


def mesh_label(mesh) -> str:
    """"slab" on a 1-D mesh, "brick 2x2" (the grid) on a brick mesh."""
    return "slab" if mesh.devices.ndim == 1 else brick_label(mesh.shape)


def multi_rank_line(n) -> str:
    """How ``parallel.launch`` places ``n`` ranks on this machine."""
    import torch

    from edm_tpu_torch.parallel.mesh import pick_backend

    backend = pick_backend(n, "cuda")
    cards = n if backend == "nccl" else 1
    lines = card_lines()[:cards]
    used = lines[0] if len(set(lines)) == 1 else "; ".join(lines)
    return (f"{n} ranks, backend {backend}, {cards} card(s) of {torch.cuda.device_count()}, "
            f"{n // cards} rank(s) per card: cuda:{'-'.join(map(str, sorted({0, cards - 1})))} "
            f"({used})")


def run_record(mesh, what, timed_steps, dt, coll, syncs, busy, **extra):
    """A sharded run's numbers for the records (``ranks_table``): steps/s,
    collectives and bytes a step, host stagings and the steps' counted host
    syncs a step, rank 0's busy share of a stride cycle (``rank_busy``).
    Over NCCL no collective may stage through the host."""
    if mesh.backend == "nccl" and coll["host_syncs"]:
        raise AssertionError(f"{what}: {coll['host_syncs']} host stagings on NCCL")
    return dict(steps_per_s=timed_steps / dt, collectives=coll, timed_steps=timed_steps,
                syncs_per_step=syncs / timed_steps, busy=busy, backend=mesh.backend, **extra)


def rank_busy(mesh, what, dev_us, wall_us, top):
    """Print rank 0's device time in a sharded run's stride cycle and
    return its busy share: None where it is not measured, which over NCCL
    is always (its collective kernels spin on the card while they wait for
    the other ranks, and the profile counts that as busy)."""
    measured = mesh.backend != "nccl" and dev_us > 0
    rank_print(mesh, busy_line(what, dev_us, wall_us, top, measured))
    return dev_us / wall_us if measured else None


def rank_print(mesh, text):
    """A line from rank 0 only (the ranks' replicas print alike)."""
    if mesh.rank == 0:
        print(text, flush=True)


def all_ranks_equal(torch, mesh, what, tensors):
    """Every rank's tensors bitwise equal to rank 0's (gathered in rank
    order, compared as their bits)."""
    from edm_tpu_torch.parallel import all_gather

    for name, t in tensors.items():
        bits = t.reshape(-1)
        bits = bits.view(torch.int32) if bits.dtype == torch.float32 else bits.to(torch.int64)
        g = all_gather(bits[None], mesh)
        if not bool((g == g[0]).all()):
            raise AssertionError(f"{what}: {name} differs between the ranks")


def row_box_kernel_phase(torch, mesh, state, step):
    """K1's owned-row form on this rank's window of the 10k bench state
    (``owned_box_rows``: against its plain version and bitwise the
    full-window kernel with the rows outside the box masked, at k = 24 and
    32, energy off and on).  The ranks take turns (a barrier between), so
    that each times the card alone; returns rank 0's rows (its first: the
    main path's k = 24, energy off)."""
    import torch.distributed as dist

    from edm_tpu_torch.ops import cellforce as CF

    tbl = CF.hermite_pair_table(state.core.bias.bias)
    window = step._window(state.xs, state.mc)
    if window is None:
        raise AssertionError(f"{mesh.size} ranks over {step.spec.ncells[0]} columns take no "
                             "window")
    out = {}
    for r in range(mesh.size):
        if r == mesh.rank:
            owned_box_rows(torch, f"cell_force_newton[row_box] rank {r}/{mesh.size}", window,
                           step.spec.box, tbl, step.lj, (24, 32), out)
        dist.barrier()
    return out


def slab_zero_temperature(torch, mesh, n_steps=20):
    """``n_steps`` kT = 0 steps of the 10k exact cell, each from the
    single-device trajectory's state (100 kT = 0.8 steps from the lattice
    first: on the lattice the forces cancel below their terms' rounding)
    through the single-device host and through the slab host (the brick host
    on a brick mesh) on the card: forces, positions and velocities within
    FORCE_REL of max(1, max|.|) (the psum adds the owned and halo
    contributions in another order), integers and flags exactly, the hill
    rounds' grids bitwise (the sharded collection replays the round), every
    rank's state bitwise rank 0's; at the first hill step
    ``slab_collect=False`` bitwise the default."""
    device = mesh.device
    _, _, steps1 = bench_setup(torch, 0.0, device)
    _, _, stepsN = bench_setup(torch, 0.0, device, mesh=mesh)
    _, _, steps_rep = bench_setup(torch, 0.0, device, mesh=mesh, slab_collect=False)
    state = thermalized(torch, device, "interp")
    label = mesh_label(mesh)
    worst = {}
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 2 if i % 10 == 9 else 1
        ref, _ = steps1[k](state)
        got, _ = stepsN[k](state)
        for name in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks",
                     "table_overflow", "mc"):
            if not bool((getattr(got, name) == getattr(ref, name)).all()):
                raise AssertionError(f"{label} step {i}: {name} differs from one device")
        for name in ("step", "last_calls", "hills_truncated"):
            if not bool((getattr(got.core, name) == getattr(ref.core, name)).all()):
                raise AssertionError(f"{label} step {i}: core.{name} differs from one device")
        for name in ("xs", "vs", "fs"):
            worst[name] = max(worst.get(name, 0.0),
                              check_forces(f"{label} step {i} {name}", getattr(got, name),
                                           getattr(ref, name)))
        check_energy(f"{label} step {i}", got.core.energy, ref.core.energy)
        if k == 0:
            if not torch.equal(got.core.bias.bias.grid.values, ref.core.bias.bias.grid.values):
                raise AssertionError(f"{label} step {i}: the hill round is not one device's")
            if i == 0:
                rep, _ = steps_rep[0](state)
                if bitwise_diffs(rep, got):
                    raise AssertionError("slab_collect=False differs from the default: "
                                         f"{bitwise_diffs(rep, got)}")
        all_ranks_equal(torch, mesh, f"{label} step {i}", {
            "xs": got.xs, "vs": got.vs, "fs": got.fs, "aid": got.aid,
            "grid": got.core.bias.bias.grid.values})
        state = ref
    rank_print(mesh, f"kT=0 {label} ({mesh.size} ranks): {n_steps} steps of the 10k exact cell, "
               "each from the single-device trajectory's state, match one device (worst "
               + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
               + "); hill rounds bitwise; every rank bitwise rank 0; slab_collect=False "
               "bitwise the default")


def slab_run(torch, mesh, warm_steps=100, timed_steps=300):
    """The bench's kT = 0.8 run on the slab host (the brick host on a brick
    mesh): ``warm_steps``, then
    ``timed_steps`` through ``pattern_segment`` with the launch counters,
    the collectives' counters and the steps' host syncs set to 0 just
    before and read just after; one stride cycle's profile (rank 0's busy
    share; its K1 device time per launch); the host syncs of a hill, a
    plain and a rebuild step named by line; ``slice_run``'s end checks."""
    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.parallel import collectives

    _, state, steps = bench_setup(torch, 0.8, mesh.device, mesh=mesh)
    label = mesh_label(mesh)
    state, _ = pattern_segment(pattern(steps), warm_steps)(state)
    for s in steps:
        s.host_syncs = 0
    for name in FORCE_KERNELS:
        getattr(CF, name).launches = 0
    CF.cell_force_newton.row_box_launches = 0
    collectives.reset_stats()
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    state, e = pattern_segment(pattern(steps), timed_steps)(state)
    torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    launches = {name: getattr(CF, name).launches for name in FORCE_KERNELS}
    launches["row_box"] = CF.cell_force_newton.row_box_launches
    coll = dict(collectives.stats)
    syncs = sum(s.host_syncs for s in steps)
    dev_us, top, device_ms = cycle_device_ms(torch, pattern_segment(pattern(steps), 10), state)
    busy = rank_busy(mesh, f"kT=0.8 {label} ({mesh.size} ranks) stride cycle, rank 0", dev_us,
                     10 * dt / timed_steps * 1e6, top)
    census, counted = {}, {}
    for name, step in zip(("hill", "plain", "rebuild"), steps):
        before = step.host_syncs
        census[name] = sync_sites(torch, lambda: step(state))
        counted[name] = step.host_syncs - before
    for name, sites in census.items():
        rank_print(mesh, f"host syncs of a {label} {name} step, rank 0 (CUDA sync-debug mode): "
                   f"{sum(sites.values())}" + "".join(f"; {k} x{n}" for k, n in sites.items())
                   + f" (counted by the step: {counted[name]})")
    core = state.core
    owns = steps[0]._owns_cells()
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.xs, state.vs, state.fs, e)),
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "cum_bias > 0": float(core.bias.cum_bias) > 0,
        "K1 owned rows on every step": launches["row_box"] == (timed_steps if owns else 0),
        "K2 launched": launches["overflow_force"] > 0 or not owns,
        "every K1 launch owned-row": launches["row_box"] == launches["cell_force_newton"],
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 {label} run on rank {mesh.rank} failed: {failed}")
    rank_print(mesh, f"kT=0.8 {label} ({mesh.size} ranks): {timed_steps} steps after {warm_steps} "
               f"warm-up: {timed_steps / dt:.2f} steps/s, rank 0 launches {launches} "
               f"({launches['row_box'] / timed_steps:.2f} K1 owned-row a step), "
               f"collectives {coll['calls'] / timed_steps:.2f} a step moving "
               f"{coll['bytes'] / timed_steps / 1e3:.1f} kB a step, "
               f"{coll['host_syncs'] / timed_steps:.2f} host stagings a step, host syncs "
               f"counted by the steps {syncs / (timed_steps / 10):.2f} per stride cycle, tail "
               f"{int(state.tail_count)} (fallback periods {int(state.tail_fallbacks)}), "
               f"cum_bias {float(core.bias.cum_bias):.6g}")
    all_ranks_equal(torch, mesh, f"the kT = 0.8 {label} run", {
        "xs": state.xs, "vs": state.vs, "aid": state.aid,
        "grid": core.bias.bias.grid.values})
    return run_record(mesh, f"kT=0.8 {label}", timed_steps, dt, coll, syncs, busy,
                      launches=launches, device_ms=device_ms)


def sharded_pair_zero_temperature(torch, mesh, n_steps=20):
    """The sharded dense host at bench.py --quick's 1,000 atoms: 20 kT = 0
    steps, each from the single-device dense trajectory's state (100 kT =
    0.8 steps from the lattice first) through the single-device dense host
    and through the sharded host on the card; this rank's rows of x, v and
    f within PAIR_REL of max(1, max|.|), step, last_calls and
    hills_truncated exactly (the acceptance draws differ by design: each
    rank draws from its own stream, so the grids are not compared), the
    grid replicas bitwise the same on every rank."""
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.parallel import make_sharded_pair_step, shard_pair_state

    device = mesh.device
    _, steps1 = pair_setup(torch, 0.0, device, "dense")
    params, _ = bench_bias(torch, device)
    _, box = bench_lattice(PAIR_N["dense"])
    stepsN = [make_sharded_pair_step(params, LangevinParams(dt=0.002, friction=1.0, kT=0.0),
                                     LJParams(epsilon=1.0, sigma=1.0, rcut=2.5), box, 10, mesh,
                                     hill_capacity=2048, static_do_hills=h) for h in (True, False)]
    state = thermalized(torch, device, "dense")
    nl = PAIR_N["dense"] // mesh.size
    mine = slice(mesh.rank * nl, (mesh.rank + 1) * nl)
    worst = {}
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 1
        ref, _ = steps1[k](state)
        got, _ = stepsN[k](shard_pair_state(state, mesh))
        for name in ("step", "last_calls", "hills_truncated"):
            if not bool((getattr(got, name) == getattr(ref, name)).all()):
                raise AssertionError(f"sharded pair step {i}: {name} differs from one device")
        for name in ("x", "v", "f"):
            worst[name] = max(worst.get(name, 0.0), check_forces(
                f"sharded pair step {i} {name}", getattr(got, name), getattr(ref, name)[mine]))
        all_ranks_equal(torch, mesh, f"sharded pair step {i}",
                        {"grid": got.bias.bias.grid.values, "cum_bias": got.bias.cum_bias})
        state = ref
    rank_print(mesh, f"kT=0 sharded pair ({mesh.size} ranks, N={PAIR_N['dense']}): {n_steps} "
               "steps on the card, each from the dense host's state, match it (worst "
               + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
               + "); last_calls exact; grid replicas bitwise")


def owned_box_rows(torch, what, window, box, tbl, lj, ks, out):
    """K1's owned-row form over one window (``pair_edm_cells.shard_window``'s
    tuple) at each k of ``ks``, energy off and on: the kernel against its
    plain version (FORCE_REL, energies ENERGY_RTOL) and bitwise the
    full-window kernel with the rows outside the box masked; each timed
    (CUDA events) beside its plain version and its bound, into ``out``
    under ``what`` and the shape.  Prints the largest |f| of the plain
    version, the scale of the force check.  Returns the first call's
    arguments."""
    import types

    from edm_tpu_torch.ops import cellforce as CF

    sub, rows_full, subm, _, ncells, rb = window
    cells = CF.box_cells(ncells, rb, sub.device)
    mrows = rows_full[cells].contiguous()
    wspec = types.SimpleNamespace(ncells=ncells, box=box)
    first, f_max = None, 0.0
    for k in ks:
        for energy in (False, True):
            kw = dict(k=k, ncells=ncells, box=box, lj=lj, energy=energy, mc_cand=subm,
                      row_box=rb)
            first = first or (sub, mrows, tbl, kw)
            f, eb = CF.cell_force_newton(sub, mrows, tbl, **kw)
            f_ref, eb_ref = CF.cell_force_newton_ref(sub, mrows, tbl, **kw)
            kw_full = {**kw, "row_box": None}
            f_full, eb_full = CF.cell_force_newton(sub, rows_full, tbl, **kw_full)
            torch.cuda.synchronize()
            name = (f"{what} window {'x'.join(map(str, ncells))} box {rb} R={cells.numel()} "
                    f"k={k} energy={int(energy)}")
            err = check_forces(name, f, f_ref)
            f_max = max(f_max, float(f_ref.abs().max()))
            check_energy(name, eb.sum(), eb_ref.sum())
            if not (torch.equal(f, f_full) and torch.equal(eb, eb_full[cells])):
                raise AssertionError(f"{name}: not bitwise the masked full window")
            ms = cuda_ms(torch, lambda: CF.cell_force_newton(sub, mrows, tbl, **kw))
            plain = cuda_ms(torch, lambda: CF.cell_force_newton_ref(sub, mrows, tbl, **kw),
                            reps=10)
            counts = pair_counts(wspec, sub, subm, k, reach(tbl, lj), rows=cells, mc_rows=mrows)
            cap = sub.shape[1]
            nbytes = 4 * (sub.numel() + subm.numel() + mrows.numel()
                          + sub.shape[0] * cap * 3 + cells.numel() * k)
            out[name] = (err, ms, plain) + bound(pair_flops(counts, tbl, energy),
                                                 nbytes + table_bytes(tbl))
    print(f"{what}: max |f_ref| {f_max:.4e} (the force check's scale: max(1, max |f_ref|))")
    return first


def brick_box_kernel_phase(torch, device):
    """K1's owned-row form over every rank's brick box of the 10k bench state
    after one hill step, in this process: each window of ``BRICK_GRIDS`` cut
    as the brick host cuts it (``pair_edm_cells.shard_window``), at k = 24
    and 32 (``owned_box_rows``).  Returns the rows, the main path's first
    (2 x 2, rank 0, k = 24, energy off)."""
    from edm_tpu_torch.models.pair_edm_cells import shard_window
    from edm_tpu_torch.ops import cellforce as CF

    spec, state, steps = bench_setup(torch, 0.8, device)
    state, _ = steps[0](state)  # a state with a live bias: one hill step
    tbl = CF.hermite_pair_table(state.core.bias.bias)
    out = {}
    for grid in BRICK_GRIDS:
        g3 = tuple(grid) + (1,) * (3 - len(grid))
        for rank in range(int(np.prod(grid))):
            coord = tuple(int(c) for c in np.unravel_index(rank, g3))
            window = shard_window(spec.ncells, g3, coord, state.xs, state.mc)
            owned_box_rows(torch, f"cell_force_newton[brick row_box] {'x'.join(map(str, grid))} "
                           f"rank {rank}", window, spec.box, tbl, steps[0].lj, (24, 32), out)
    print_rows(out)
    return out


def row_box_cheb_kernel_phase(torch, device):
    """K1's owned-row form with the bench's Chebyshev table (``CHEB``: 4
    panels of degree 16, K3), the form the weak-scaling example's slab and
    brick ranks run: on both ranks' windows of that script's 2-rank slab
    lattice (16 x 8 x 8 sites, 6 x 3 x 3 cells) at its full cap, first (the
    main path's shape), then on rank 0 of the 10k bench state's 2-rank slab
    and 2 x 2 brick at k = 24 and 32 (``owned_box_rows``); the table is the
    10k Chebyshev path's after one hill step (a live bias).  The script's
    lattice is perfect: an atom's whole force vanishes by symmetry, and
    only the half stencil's partial sums are left to compare.  So each of
    its atoms is moved by up to 0.1 on each axis first (the GPU tests'
    jitter, which keeps every atom in its cell), and every force compared
    is a real one.
    Returns the rows and the first row's device ms per launch (its
    profile)."""
    import dataclasses

    from edm_tpu_torch.models.pair_edm_cells import shard_window
    from edm_tpu_torch.ops import cellforce as CF

    ws = example("torch_weak_scaling")
    spec, state, steps = bench_setup(torch, 0.8, device, "chebyshev")
    state, _ = steps[0](state)  # a state with a live bias and its refitted table
    tbl, lj = state.core.cheb, steps[0].lj
    _, wspec, wstate = ws.lattice_setup(ws.rank_grid(2), device)
    jitter = np.random.default_rng(9).uniform(-0.1, 0.1, tuple(wstate.xs.shape))
    wstate = dataclasses.replace(wstate, xs=wstate.xs + torch.tensor(
        jitter, dtype=wstate.xs.dtype, device=device) * wstate.mc[..., None])
    out, first = {}, None
    for what, sp, st, g3, rank, ks in (
            ("examples slab 2", wspec, wstate, (2, 1, 1), 0, (wspec.cap,)),
            ("examples slab 2", wspec, wstate, (2, 1, 1), 1, (wspec.cap,)),
            ("10k slab 2", spec, state, (2, 1, 1), 0, (24, 32)),
            ("10k brick 2x2", spec, state, (2, 2, 1), 0, (24, 32))):
        coord = tuple(int(c) for c in np.unravel_index(rank, g3))
        window = shard_window(sp.ncells, g3, coord, st.xs, st.mc)
        args = owned_box_rows(torch, f"cell_force_newton[row_box cheb] {what} rank {rank}",
                              window, sp.box, tbl, lj, ks, out)
        first = first or args
    sub, mrows, tbl, kw = first
    _, per, _, _ = device_time_us(torch, lambda: CF.cell_force_newton(sub, mrows, tbl, **kw), 20)
    print_rows(out)
    return out, funcs_ms(per, ROW_FUNCS)


def sharded_cells_setup(torch, mesh, kT: float):
    """The work-sharded host (``parallel.make_sharded_cell_step``, its
    defaults: cell_chunk 32, hill_capacity and row_cap 1024 a rank) on the
    10k Chebyshev cell, its three static phases as the cell host's stride
    cycle; returns (spec, the cell state, the single-device cell host's
    three phases, the work-sharded host's three)."""
    from edm_tpu_torch.parallel import make_sharded_cell_step

    spec, state, steps1 = bench_setup(torch, kT, mesh.device, "chebyshev")
    s0 = steps1[0]
    wsteps = [make_sharded_cell_step(s0.params, s0.lp, s0.lj, spec, 10, mesh, rebuild_stride=10,
                                     static_do_hills=h, static_do_rebuild=r)
              for h, r in ((True, False), (False, False), (False, True))]
    return spec, state, steps1, wsteps


def sharded_cells_state(spec, state):
    """The work-sharded state of a cell state: its atoms in atom order, in
    the cell state's own slot table.  Between rebuilds atoms drift from the
    cells they were binned in, and a pair within the CV's range can drift
    two cells apart, out of the stencil: a table made anew would pair atoms
    that the cell host, binned at its last rebuild, does not see."""
    import dataclasses

    from edm_tpu_torch.models.pair_edm_cells import _atoms_from_slots
    from edm_tpu_torch.parallel import ShardedCellPairState

    x, v, f = _atoms_from_slots(spec, state.aid, state.xs, state.vs, state.fs)
    return ShardedCellPairState(core=dataclasses.replace(state.core, x=x, v=v, f=f),
                                aid=state.aid[:spec.n_slots],
                                table_overflow=state.table_overflow)


# last_calls of the work-sharded host against the cell host's: both count
# the pairs within the CV's range twice, but from positions one force
# rounding apart, so a pair at the range's edge may fall on either side
CALLS_REL = 1e-5


def sharded_cells_zero_temperature(torch, mesh, n_steps=10):
    """``n_steps`` kT = 0 steps of the 10k Chebyshev cell, each from the
    single-device cell host's trajectory (100 kT = 0.8 steps from the
    lattice first), through the cell host and through the work-sharded host
    on the card: positions, velocities and forces, the latter's atoms laid
    into the cell host's slots, within FORCE_REL of max(1, max|.|) (an atom
    with a pair within an ulp of a Chebyshev table edge up to the table's
    jump there: ``check_slot_forces``), step, hills_truncated and
    table_overflow exactly, last_calls within CALLS_REL and the energy
    within ENERGY_RTOL on hill steps, every rank bitwise rank 0."""
    spec, _, steps1, wsteps = sharded_cells_setup(torch, mesh, 0.0)
    state = thermalized(torch, mesh.device, "chebyshev")
    worst, calls, edge = {}, 0.0, 0
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 2 if i % 10 == 9 else 1
        ref, _ = steps1[k](state)
        got, _ = wsteps[k](sharded_cells_state(spec, state))
        what = f"work-sharded step {i}"
        slot = torch.clamp(ref.aid, 0, spec.n_atoms - 1)
        for name in ("x", "v", "f"):
            a = getattr(got.core, name)[slot].reshape(ref.xs.shape) * ref.mc[..., None]
            err, n_edge = check_slot_forces(torch, f"{what} {name}", a, getattr(ref, name + "s"),
                                            ref.xs, ref.mc, spec.box, state.core.cheb)
            worst[name], edge = max(worst.get(name, 0.0), err), edge + n_edge
        for name, a, b in (("step", got.core.step, ref.core.step),
                           ("hills_truncated", got.core.hills_truncated,
                            ref.core.hills_truncated),
                           ("table_overflow", got.table_overflow, ref.table_overflow)):
            if not bool((a == b).all()):
                raise AssertionError(f"{what}: {name} differs from the cell host")
        if k == 0:
            a, b = int(got.core.last_calls), int(ref.core.last_calls)
            calls = max(calls, abs(a - b) / b)
            if not abs(a - b) <= CALLS_REL * b:
                raise AssertionError(f"{what}: last_calls {a} against the cell host's {b}")
            check_energy(what, got.core.energy, ref.core.energy)
        all_ranks_equal(torch, mesh, what, {"x": got.core.x, "f": got.core.f, "aid": got.aid,
                                            "grid": got.core.bias.bias.grid.values})
        state = ref
    rank_print(mesh, f"kT=0 work-sharded ({mesh.size} ranks): {n_steps} steps of the 10k Chebyshev "
               "cell, each from the cell host's state, match it atom for atom (worst "
               + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
               + f"; {edge} atom(s) by a table-edge pair; last_calls {calls:.2e} relative); "
               "every rank bitwise rank 0")


def sharded_cells_run(torch, mesh, warm_steps=20, timed_steps=50):
    """The work-sharded host at kT = 0.8 on the 10k Chebyshev cell:
    ``warm_steps``, then ``timed_steps`` through ``pattern_segment`` with the
    collectives' counters and the steps' host syncs set to 0 just before
    and read just after; end checks; every rank bitwise rank 0."""
    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.parallel import collectives

    spec, state, _, wsteps = sharded_cells_setup(torch, mesh, 0.8)
    state, _ = pattern_segment(pattern(wsteps), warm_steps)(sharded_cells_state(spec, state))
    for s in wsteps:
        s.host_syncs = 0
    collectives.reset_stats()
    torch.cuda.synchronize(mesh.device)
    t0 = time.perf_counter()
    state, e = pattern_segment(pattern(wsteps), timed_steps)(state)
    torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    coll = dict(collectives.stats)
    core = state.core
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (core.x, core.v, core.f, e)),
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "cum_bias > 0": float(core.bias.cum_bias) > 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 work-sharded run on rank {mesh.rank} failed: {failed}")
    syncs = sum(s.host_syncs for s in wsteps)
    dev_us, _, top, _ = device_time_us(torch, lambda: pattern_segment(pattern(wsteps), 10)(state),
                                       2)
    busy = rank_busy(mesh, f"kT=0.8 work-sharded ({mesh.size} ranks) stride cycle, rank 0",
                     dev_us, 10 * dt / timed_steps * 1e6, top)
    rank_print(mesh, f"kT=0.8 work-sharded ({mesh.size} ranks, 10k Chebyshev): {timed_steps} steps "
               f"after {warm_steps} warm-up: {timed_steps / dt:.2f} steps/s, collectives "
               f"{coll['calls'] / timed_steps:.2f} a step moving "
               f"{coll['bytes'] / timed_steps / 1e3:.1f} kB a step, "
               f"{coll['host_syncs'] / timed_steps:.2f} host stagings a step, host syncs counted "
               f"by the steps {syncs / (timed_steps / 10):.2f} per stride cycle, cum_bias "
               f"{float(core.bias.cum_bias):.6g}")
    all_ranks_equal(torch, mesh, "the kT = 0.8 work-sharded run", {
        "x": core.x, "v": core.v, "aid": state.aid, "grid": core.bias.bias.grid.values})
    return run_record(mesh, "kT=0.8 work-sharded", timed_steps, dt, coll, syncs, busy)


def sharded_coord_setup(torch, mesh, kT: float):
    """The sharded coordinate host (``parallel.make_sharded_coord_step``,
    hill_capacity at its default 2048) on ``coord_setup``'s 2-D heavy cell;
    returns (the full state, the single-device host's hill and plain steps,
    the sharded host's)."""
    from edm_tpu_torch.parallel import make_sharded_coord_step

    state, steps = coord_setup(torch, kT, mesh.device)
    wsteps = [make_sharded_coord_step(steps[0].params, steps[0].lp, 10, mesh, static_do_hills=h)
              for h in (True, False)]
    if wsteps[0].hill_capacity != 2048:
        raise AssertionError("the sharded 2-D host's hill capacity is not the bench's 2048")
    return state, steps, wsteps


@contextlib.contextmanager
def drawn_uniforms(u):
    """``prng.uniform`` returns ``u`` for a draw of its shape (the
    single-device coordinate host's acceptance draw)."""
    from edm_tpu_torch.ops import prng

    saved = prng.uniform

    def uniform(key, shape, *args, **kw):
        if tuple(shape) == tuple(u.shape):
            return u
        return saved(key, shape, *args, **kw)

    prng.uniform = uniform
    try:
        yield
    finally:
        prng.uniform = saved


def sharded_coord_zero_temperature(torch, mesh, n_steps=20):
    """``n_steps`` kT = 0 steps of the 2-D heavy cell (two of them hill
    steps), each from the single-device host's trajectory, through the
    sharded host and through the single-device host on the card, the latter
    drawing its acceptance uniforms as the ranks draw theirs (rank r's
    ``fold_in(fold_in(key, r), 11)``, in rank order), so that both deposit
    the same hills: this rank's x, v and f within COORD_GRID_REL of max(1,
    max|.|) (the sharded host looks up without the corner table), the grid,
    the buffer and cum_bias within COORD_GRID_REL (the deposition's sums
    run in another order), cv_hist and the integer leaves exactly (not the
    key: the sharded host advances it once a step, the single-device host
    twice), every rank's replica bitwise rank 0's."""
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.parallel import shard_coord_state

    require_full_f32(torch)
    state, steps, wsteps = sharded_coord_setup(torch, mesh, 0.0)
    nl = COORD_N // mesh.size
    mine = slice(mesh.rank * nl, (mesh.rank + 1) * nl)
    worst, hills = {}, 0
    for i in range(n_steps):
        k = 0 if i % 10 == 0 else 1
        got, _ = wsteps[k](shard_coord_state(state, mesh))
        if k == 0:
            u = torch.cat([prng.uniform(prng.fold_in(prng.fold_in(state.key, r), 11), (nl,),
                                        torch.float32, mesh.device) for r in range(mesh.size)])
            with drawn_uniforms(u):
                ref, _ = steps[0](state)
            hills += 1
        else:
            ref, _ = steps[1](state)
        what = f"sharded 2-D step {i}"
        for name, a, b in (("step", got.step, ref.step),
                           ("hills_truncated", got.hills_truncated, ref.hills_truncated),
                           ("cv_hist", got.bias.cv_hist.values, ref.bias.cv_hist.values),
                           ("rounds", got.bias.steps, ref.bias.steps),
                           ("buf_left", got.bias.buf_left, ref.bias.buf_left),
                           ("buf_right", got.bias.buf_right, ref.bias.buf_right)):
            if not bool((a == b).all()):
                raise AssertionError(f"{what}: {name} differs from one device")
        for name, a, b in (("x", got.x, ref.x[mine]), ("v", got.v, ref.v[mine]),
                           ("f", got.f, ref.f[mine]),
                           ("grid values", got.bias.bias.grid.values, ref.bias.bias.grid.values),
                           ("grid derivs", got.bias.bias.grid.derivs, ref.bias.bias.grid.derivs),
                           ("buf_h", got.bias.buf_h, ref.bias.buf_h),
                           ("cum_bias", got.bias.cum_bias, ref.bias.cum_bias),
                           ("energy", got.energy, ref.energy)):
            a, b = a.double(), b.double()
            e = float((a - b).abs().max())
            worst[name] = max(worst.get(name, 0.0), e)
            if not e <= COORD_GRID_REL * max(1.0, float(b.abs().max())):
                raise AssertionError(f"{what}: {name} differs by {e:.3e} from one device")
        all_ranks_equal(torch, mesh, what, {"grid": got.bias.bias.grid.values,
                                            "derivs": got.bias.bias.grid.derivs,
                                            "cv_hist": got.bias.cv_hist.values,
                                            "cum_bias": got.bias.cum_bias})
        state = ref
    if hills < 2 or not float(state.bias.cum_bias) > 0:
        raise AssertionError("the kT = 0 sharded 2-D run deposited no hills")
    rank_print(mesh, f"kT=0 sharded 2-D ({mesh.size} ranks, N={COORD_N}): {n_steps} steps "
               f"({hills} hill steps), each from the single-device host's state with the ranks' "
               "acceptance draws, match it (worst "
               + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
               + "); cv_hist and the integer leaves exact; replicas bitwise")


def sharded_coord_run(torch, mesh, warm_steps=50, timed_steps=200):
    """The sharded 2-D host at kT = 1.0: ``warm_steps``, then
    ``timed_steps`` through ``driver.strided_segment`` with the Threefry
    counter, the collectives' counters and the steps' host syncs set to 0
    just before and read just after; end checks (one normal draw a step and
    one acceptance draw a hill step through ``threefry_bits``); every
    rank's replica bitwise rank 0's."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.parallel import collectives, shard_coord_state

    require_full_f32(torch)
    state, _, wsteps = sharded_coord_setup(torch, mesh, 1.0)
    state, _ = strided_segment(wsteps[0], wsteps[1], 10, warm_steps)(
        shard_coord_state(state, mesh))
    for s in wsteps:
        s.host_syncs = 0
    collectives.reset_stats()
    torch.cuda.synchronize(mesh.device)
    prng.threefry_bits.launches = 0
    t0 = time.perf_counter()
    state, e = strided_segment(wsteps[0], wsteps[1], 10, timed_steps)(state)
    torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    n_tf = prng.threefry_bits.launches
    coll = dict(collectives.stats)
    b = state.bias
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.f, e,
                                                               b.bias.grid.values)),
        "no overflow_error": not bool(b.overflow_error),
        "no hills_truncated": not bool(state.hills_truncated),
        "cum_bias > 0": float(b.cum_bias) > 0,
        "Threefry kernel: a draw a step and one a hill step": n_tf == timed_steps + timed_steps // 10,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=1.0 sharded 2-D run on rank {mesh.rank} failed: {failed}")
    syncs = sum(s.host_syncs for s in wsteps)
    dev_us, _, top, _ = device_time_us(
        torch, lambda: strided_segment(wsteps[0], wsteps[1], 10, 10)(state), 2)
    busy = rank_busy(mesh, f"kT=1.0 sharded 2-D ({mesh.size} ranks) stride cycle, rank 0",
                     dev_us, 10 * dt / timed_steps * 1e6, top)
    rank_print(mesh, f"kT=1.0 sharded 2-D ({mesh.size} ranks, N={COORD_N}): {timed_steps} steps "
               f"after {warm_steps} warm-up: {timed_steps / dt:.2f} steps/s, Threefry launches "
               f"{n_tf}, collectives {coll['calls'] / timed_steps:.2f} a step moving "
               f"{coll['bytes'] / timed_steps / 1e3:.1f} kB a step, "
               f"{coll['host_syncs'] / timed_steps:.2f} host stagings a step, host syncs counted "
               f"by the steps {syncs / (timed_steps / 10):.2f} per stride cycle, cum_bias "
               f"{float(b.cum_bias):.6g}, hill rounds {int(b.steps)}")
    all_ranks_equal(torch, mesh, "the kT = 1.0 sharded 2-D run", {
        "grid": b.bias.grid.values, "cv_hist": b.cv_hist.values})
    return run_record(mesh, "kT=1.0 sharded 2-D", timed_steps, dt, coll, syncs, busy,
                      threefry_bits=n_tf)


# the spatial host (parallel/spatial.py) on the 2-D heavy cell, split with
# skin 1.0: (a) periodic on 2 ranks, parts (2, 1); (b) periodic on 2 x 2;
# (c) non-periodic on 2 ranks (the McGDP box: boundary_offset on dim 0).
# Walker slots a rank, and the steps between two rebins
SPATIAL_CASES = {"a": dict(parts=(2, 1), periodic=True), "b": dict(parts=(2, 2), periodic=True),
                 "c": dict(parts=(2, 1), periodic=False)}
SPATIAL_CAP = {2: 6000, 4: 3000}
SPATIAL_REBIN = 20
# stitched grid against the single-device deposit: values within
# COORD_GRID_REL * max(1, max|values|).  The derivatives within
# SPATIAL_DERIV_REL * max(1, max|derivs|): a rank's local frame moves a
# hill's float32 offset from a grid point by up to half an ulp of 10
# (4.8e-7, 6.7e-6 sigma'), and a derivative term's slope in that offset is
# 2 / sigma' times the value term, ~3e-5 of the largest derivative term per
# hill: float32 rounding of the same size as each frame's own error
SPATIAL_DERIV_REL = 5e-5
# ... plus one support-edge term: a grid point whose dp^2 rounds to either
# side of GAUSS_SUPPORT (8) in the two frames takes a hill's edge term in
# one and not the other, e^-8 h / (pi sigma'^2) on the value (below
# COORD_GRID_REL at the bench's heights) and 2 sqrt(8) / sigma' times that
# on a derivative (6.8e-4 at h = 4e-4)
# forces against update_forces on the stitched grid: FORCE_REL * max(1,
# max|f|), plus, walker by walker, the spread of that lookup when a sharded
# coordinate moves by one float32 ulp of 10 (a rank's frame rounds a
# walker's offset in its cell differently, by up to half an ulp of the
# coordinate; on the McGDP box the lookup next to a wall can be steep
# enough for that to pass FORCE_REL)
SPATIAL_ULP = float(np.spacing(np.float32(10.0)))


def spatial_label(case) -> str:
    c = SPATIAL_CASES[case]
    return (f"spatial ({case}) {'x'.join(map(str, c['parts']))} "
            f"{'periodic' if c['periodic'] else 'McGDP'}")


def spatial_setup(torch, mesh, case, lp, collect_records=False):
    """``coord_setup``'s 2-D heavy cell on the spatial host: the bench's
    10,000 walkers (default_rng(77)) binned into the bricks of
    ``spatial_subdivide(COORD_CFG, parts, skin=1.0)`` with ``SPATIAL_CAP``
    slots a rank, PRNGKey(0); the hill and the plain static steps
    (hill_stride 10, hill_capacity at its default, which must come to the
    bench's 2048).  Returns (setup, state, steps)."""
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.parallel import spatial as S
    from edm_tpu_torch.utils.config import parse_edm_text

    c = SPATIAL_CASES[case]
    setup, tmpl = S.spatial_subdivide(parse_edm_text(COORD_CFG), 1.0, 1.0, c["parts"], 1.0,
                                      dtype=torch.float32, periodic=[c["periodic"]] * 2,
                                      device=mesh.device)
    x0 = np.random.default_rng(77).uniform(0, 10, (COORD_N, 2))
    state = S.init_spatial_state(setup, tmpl, x0, PRNGKey(0), SPATIAL_CAP[mesh.size], mesh)
    steps = [S.make_spatial_coord_step(setup, lp, 10, mesh, collect_records=collect_records,
                                       static_do_hills=h) for h in (True, False)]
    if steps[0].hill_capacity != 2048:
        raise AssertionError(f"{spatial_label(case)}: hill capacity {steps[0].hill_capacity}, "
                             "not the bench's 2048")
    return setup, state, steps


def spatial_reference(torch, mesh, case):
    """The single-device global grid of the case on the card: the periodic
    1000 x 1000 grid, or the McGDP box's 1001 x 1001 (``bias.subdivide``
    over [0, 10]^2).  Returns (params, bias state)."""
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.utils.config import parse_edm_text

    per = SPATIAL_CASES[case]["periodic"]
    return B.subdivide(parse_edm_text(COORD_CFG), 1.0, 1.0, [0, 0], [10, 10], [0, 0], [10, 10],
                       [per] * 2, [0, 0], dtype=torch.float32, device=mesh.device)


def spatial_zero_temperature(torch, mesh, case, n_rounds=3):
    """Frozen walkers (dt 1e-9, friction 0, kT 0) through ``n_rounds`` hill
    steps with records: after each round the stitched grid's values and
    derivatives against a windowed deposit (``GaussGrid.add_value``) on
    the single-device global grid of the round's gathered hills at their
    recorded heights, the values within COORD_GRID_REL * max(1, max|values|),
    the derivatives within SPATIAL_DERIV_REL * max(1, max|derivs|) plus one
    support-edge term of the largest hill; then one
    plain step, and each rank's forces against ``bias.update_forces`` on
    the stitched grid at its walkers, within FORCE_REL * max(1, max|f|) plus
    each walker's spread of that lookup over ``SPATIAL_ULP``.  Every rank
    runs every check."""
    import dataclasses

    from edm_tpu_torch import bias as B
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.parallel import spatial as S

    require_full_f32(torch)
    label = spatial_label(case)
    setup, state, steps = spatial_setup(torch, mesh, case,
                                        LangevinParams(dt=1e-9, friction=0.0, kT=0.0), True)
    params_g, ref = spatial_reference(torch, mesh, case)
    g_ref = ref.bias
    sig = ref.bias.spec.sigma  # sigma' = sqrt(2) sigma
    worst, hills, h_max, n_edge = {}, 0, 0.0, 0
    for r in range(n_rounds):
        state, _, log = steps[0](state)
        rec = log.rec
        on = rec.hill_called & (rec.hill_dep_h > 0)
        g_ref, _ = g_ref.add_value(log.positions[on], rec.hill_dep_h[on])
        hills += int(on.sum())
        h_max = max(h_max, float(rec.hill_dep_h.max()))
        edge = 2 * np.sqrt(8.0) / min(sig) * np.exp(-8.0) * h_max / (np.pi * sig[0] * sig[1])
        st = S.stitch_spatial_grid(setup, state, mesh)
        for name, a, b, rel, extra in (
                ("values", st.values, g_ref.grid.values, COORD_GRID_REL, 0.0),
                ("derivs", st.derivs, g_ref.grid.derivs, SPATIAL_DERIV_REL, edge)):
            if a.shape != b.shape:
                raise AssertionError(f"{label}: stitched {name} {tuple(a.shape)}, the "
                                     f"single-device grid {tuple(b.shape)}")
            diff = (a.double() - b.double()).abs()
            e = float(diff.max())
            worst[name] = max(worst.get(name, 0.0), e)
            base = rel * max(1.0, float(b.abs().max()))
            if extra:
                n_edge = max(n_edge, int((diff > base).any(-1).sum()))
            if not e <= base + extra:
                raise AssertionError(f"{label} round {r}: stitched {name} differ from the "
                                     f"single-device deposit by {e:.3e} > {base + extra:.3e}")
    state, _, _ = steps[1](state)
    st = S.stitch_spatial_grid(setup, state, mesh)
    g_st = dataclasses.replace(ref, bias=dataclasses.replace(ref.bias, grid=dataclasses.replace(
        ref.bias.grid, values=st.values, derivs=st.derivs)))
    x, f = state.x[state.valid], state.f[state.valid]

    def f_ref(xq):
        return -B.update_forces(params_g, g_st, xq)[1]

    # the lookup's spread over SPATIAL_ULP of each sharded coordinate: how far
    # the rounding of a walker's cell offset in another frame can move it
    # (the McGDP box's 2-D corrections leave jumps at the support edges
    # near a wall, where a cubic-Hermite cell is steep)
    want = f_ref(x)
    spread = torch.zeros_like(want)
    for d in steps[0].sharded_dims:
        for sgn in (-1.0, 1.0):
            xq = x.clone()
            xq[:, d] += sgn * SPATIAL_ULP
            spread = torch.maximum(spread, (f_ref(xq) - want).abs())
    err = (f - want).abs()
    tol = FORCE_REL * max(1.0, float(want.abs().max()))
    beyond = err > tol
    if bool((err > tol + spread).any()):
        k = int(torch.argmax((err - tol - spread).max(-1).values))
        raise AssertionError(f"{label} rank {mesh.rank}: walker at {x[k].tolist()} force "
                             f"{f[k].tolist()}, on the stitched grid {want[k].tolist()}: "
                             f"beyond {tol:.3e} + its spread {spread[k].tolist()}")
    if bool((state.f[~state.valid] != 0).any()):
        raise AssertionError(f"{label}: an empty slot carries a force")
    worst["forces"] = float(err.max())
    n_beyond = int(beyond.any(-1).sum())
    if hills < 3 or not float(state.bias.cum_bias) > 0:
        raise AssertionError(f"{label}: the frozen rounds deposited nothing")
    rank_print(mesh, f"kT=0 {label} ({mesh.size} ranks, N={COORD_N}, local grid "
               f"{'x'.join(map(str, state.bias.bias.spec.grid.nbins))}): {n_rounds} frozen hill "
               f"rounds ({hills} hills on rank 0) stitch to the single-device windowed deposit "
               f"(worst values {worst['values']:.3e}, bound COORD_GRID_REL x max(1, "
               f"max|values|); derivs {worst['derivs']:.3e}, bound SPATIAL_DERIV_REL x max(1, "
               f"max|derivs|) plus one support-edge term {edge:.3e}, taken by {n_edge} points); "
               f"rank 0's forces against update_forces on the stitched grid: "
               f"worst {worst['forces']:.3e}, bound FORCE_REL x max(1, max|f|) = {tol:.3e}, "
               f"{n_beyond} walkers beyond it, each within its lookup's spread over "
               f"{SPATIAL_ULP:.3g} of its sharded coordinates")


def spatial_segment(setup, steps, mesh, state, n):
    """``n`` steps (a multiple of 10) in whole stride cycles, with
    ``rebin_spatial_atoms`` after each ``SPATIAL_REBIN`` of them."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.parallel import spatial as S

    e = None
    while n > 0:
        k = min(n, SPATIAL_REBIN)
        state, e = strided_segment(steps[0], steps[1], 10, k)(state)
        if k == SPATIAL_REBIN:
            state = S.rebin_spatial_atoms(setup, state, mesh)
        n -= k
    return state, e


def spatial_run(torch, mesh, case, warm_steps=50, timed_steps=200):
    """The spatial host at kT = 1.0 (dt 0.002, friction 1.0):
    ``warm_steps``, then ``timed_steps`` (``spatial_segment``: a rebin
    every 20 steps) with the Threefry counter, the collectives' counters
    and the steps' host syncs set to 0 just before and read just after;
    one stride cycle's profile (rank 0's busy share); end checks
    (``hills_truncated`` and ``overflow_error`` false, everything finite,
    one Threefry launch a step and one a hill step, cum_bias bitwise the
    same on every rank)."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.ops import prng
    from edm_tpu_torch.parallel import all_gather, collectives

    require_full_f32(torch)
    label = spatial_label(case)
    setup, state, steps = spatial_setup(torch, mesh, case,
                                        LangevinParams(dt=0.002, friction=1.0, kT=1.0))
    state, _ = spatial_segment(setup, steps, mesh, state, warm_steps)
    for s in steps:
        s.host_syncs = 0
    collectives.reset_stats()
    torch.cuda.synchronize(mesh.device)
    prng.threefry_bits.launches = 0
    t0 = time.perf_counter()
    state, e = spatial_segment(setup, steps, mesh, state, timed_steps)
    torch.cuda.synchronize(mesh.device)
    dt = time.perf_counter() - t0
    n_tf = prng.threefry_bits.launches
    coll = dict(collectives.stats)
    syncs = sum(s.host_syncs for s in steps)
    cycle = strided_segment(steps[0], steps[1], 10, 10)
    dev_us, _, top, per_cycle = device_time_us(torch, lambda: cycle(state), 2)
    busy = rank_busy(mesh, f"kT=1.0 {label} ({mesh.size} ranks) stride cycle, rank 0", dev_us,
                     10 * dt / timed_steps * 1e6, top)
    b = state.bias
    n_valid = int(all_gather(state.valid.sum()[None], mesh).sum())
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.x, state.v, state.f, e,
                                                               b.bias.grid.values)),
        "no overflow_error": not bool(b.overflow_error),
        "no hills_truncated": not bool(state.hills_truncated),
        "cum_bias > 0": float(b.cum_bias) > 0,
        "every walker in a brick": n_valid == COORD_N,
        "Threefry kernel: a draw a step and one a hill step": n_tf == timed_steps + timed_steps // 10,
    }
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=1.0 {label} run on rank {mesh.rank} failed: {failed}")
    all_ranks_equal(torch, mesh, f"the kT = 1.0 {label} run", {"cum_bias": b.cum_bias})
    rank_print(mesh, f"kT=1.0 {label} ({mesh.size} ranks, N={COORD_N}): {timed_steps} steps "
               f"after {warm_steps} warm-up, a rebin every {SPATIAL_REBIN}: "
               f"{timed_steps / dt:.2f} steps/s, Threefry launches {n_tf}, collectives "
               f"{coll['calls'] / timed_steps:.2f} a step moving "
               f"{coll['bytes'] / timed_steps / 1e3:.1f} kB a step, "
               f"{coll['host_syncs'] / timed_steps:.2f} host stagings a step, host syncs counted "
               f"by the steps {syncs / (timed_steps / 10):.2f} per stride cycle, device launches "
               f"a step {per_cycle / 10:.1f} (rank 0), cum_bias {float(b.cum_bias):.6g}, hill "
               f"rounds {int(b.steps)}, walkers on rank 0 {int(state.valid.sum())}")
    return run_record(mesh, f"kT=1.0 {label}", timed_steps, dt, coll, syncs, busy,
                      threefry_bits=n_tf)


def rank_cases(size):
    """The spatial cases of a world size (2 ranks: (a) and (c); 4: (b))."""
    return [case for case, c in SPATIAL_CASES.items() if int(np.prod(c["parts"])) == size]


def rank_runs(torch, mesh):
    """The timed runs of this world size, in order: {host: a thunk that
    runs it and returns its ``run_record``}.  The slab host on
    ``SLAB_RANKS`` (100 steps after 50), on 2 ranks the work-sharded cell
    host (50 after 20) and the sharded 2-D host (100 after 20), the brick
    host on 2 x 2 (4 ranks) and 2 x 2 x 2 (8 ranks), 100 after 50 each, the
    spatial cases (100 after 20)."""
    from edm_tpu_torch.parallel import make_brick_mesh

    runs = {}
    if mesh.size in SLAB_RANKS:
        runs["slab"] = lambda: slab_run(torch, mesh, warm_steps=50, timed_steps=100)
    if mesh.size == 2:
        runs["work-sharded"] = lambda: sharded_cells_run(torch, mesh)
        runs["sharded 2-D"] = lambda: sharded_coord_run(torch, mesh, warm_steps=20,
                                                        timed_steps=100)
    # the bench's lattice runs its first ~80 steps in the full-cap fallback,
    # where K2 does not launch: a shorter run than 100 after 50 never reaches
    # it (the 2 x 2 x 2 brick at 50 after 20 did not)
    for grid in BRICK_GRIDS:
        if int(np.prod(grid)) == mesh.size:
            runs[brick_label(grid)] = lambda g=grid: slab_run(
                torch, make_brick_mesh(*g), warm_steps=50, timed_steps=100)
    for case in rank_cases(mesh.size):
        runs[spatial_label(case)] = lambda c=case: spatial_run(torch, mesh, c, warm_steps=20,
                                                               timed_steps=100)
    return runs


def sharded_checkpoint_phase(torch, mesh, workdir, n=10):
    """A sharded run checkpointed into one file and resumed: the slab host
    on the 10k exact cell at kT = 0.8 (its ranks' states alike: each leaf
    stored once) and the spatial case (a) at kT = 1.0 (a row a rank), each
    ``n`` steps, ``save_state`` with the mesh, ``load_state`` with it into a
    freshly built template, ``n`` more steps: every leaf on every rank
    bitwise the ``2 n`` uninterrupted steps."""
    from edm_tpu_torch.models.driver import pattern_segment, strided_segment
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.utils.checkpoint import load_state, save_state

    lp = LangevinParams(dt=0.002, friction=1.0, kT=1.0)
    hosts = {
        "slab": (lambda: bench_setup(torch, 0.8, mesh.device, mesh=mesh)[1:],
                 lambda steps, state, k: pattern_segment(pattern(steps), k)(state)[0],
                 "replicated"),
        "spatial (a)": (lambda: spatial_setup(torch, mesh, "a", lp)[1:],
                        lambda steps, state, k: strided_segment(steps[0], steps[1], 10, k)(
                            state)[0], "rows"),
    }
    for name, (make, run, layout) in hosts.items():
        t = time.perf_counter()
        state0, steps = make()
        full = run(steps, state0, 2 * n)
        mid = run(steps, state0, n)
        path = os.path.join(workdir, f"ckpt_{name.split()[0]}.npz")
        save_state(mid, path, mesh)
        with np.load(path) as data:
            saved = bytes(data["__fingerprint__"]).decode().split("layout=")[-1]
        if saved != layout:
            raise AssertionError(f"{name} checkpoint: layout {saved}, expected {layout}")
        fresh, steps2 = make()
        resumed = load_state(fresh, path, mesh)
        diffs = bitwise_diffs(run(steps2, resumed, n), full)
        if diffs:
            raise AssertionError(f"{name} checkpoint on rank {mesh.rank}: leaves differ from the "
                                 f"uninterrupted run {diffs}")
        rank_print(mesh, f"checkpoint of the {name} host on {mesh.size} ranks: {n} steps, "
                   f"save_state with the mesh ({os.path.getsize(path)} bytes, layout {layout}), "
                   f"load_state into a fresh "
                   f"template on every rank, {n} more: bitwise the {2 * n} uninterrupted steps "
                   f"on every rank (every leaf); {time.perf_counter() - t:.1f} s")


def multi_rank_phase(workdir):
    """One rank's share of the multi-device phases (run by
    ``parallel.launch``), by the world size, each part's checks and then
    its timed run of ``rank_runs``: on ``SLAB_RANKS`` K1's owned-row form on
    the rank's slab window and the slab host's kT = 0 steps; on 2 ranks
    also the sharded dense host, the work-sharded cell host, the sharded
    2-D host and ``sharded_checkpoint_phase``; on 4 the brick host on 2 x 2
    (20 kT = 0 steps), on 8 on 2 x 2 x 2 (5 kT = 0 steps); the spatial
    cases of the world size; then the example scripts' share of this rank
    count (``example_rank_part``, files in ``workdir``).  Each part's
    seconds printed by rank 0.  Returns rank 0's kernel rows and run
    records."""
    import torch

    from edm_tpu_torch.parallel import make_brick_mesh, make_mesh

    mesh = make_mesh()
    torch.backends.cuda.matmul.allow_tf32 = False
    runs = rank_runs(torch, mesh)
    out = {"runs": {}}

    def timed(what, fn):
        t = time.perf_counter()
        res = fn()
        rank_print(mesh, f"  {what}: {time.perf_counter() - t:.1f} s")
        return res

    def part(what, checks, host):
        out["runs"][host] = timed(what, lambda: (checks(), runs[host]())[1])

    if mesh.size in SLAB_RANKS:
        def slab_checks():
            _, state, steps = bench_setup(torch, 0.8, mesh.device, mesh=mesh)
            state, _ = steps[0](state)  # a state with a live bias: one hill step
            out["rows"] = row_box_kernel_phase(torch, mesh, state, steps[0])
            if mesh.rank == 0:
                print_rows(out["rows"])
            slab_zero_temperature(torch, mesh)

        part(f"slab host on {mesh.size} ranks", slab_checks, "slab")
    if mesh.size == 2:
        timed("sharded pair host", lambda: sharded_pair_zero_temperature(torch, mesh))
        part("work-sharded cell host", lambda: sharded_cells_zero_temperature(torch, mesh),
             "work-sharded")
        part("sharded 2-D host", lambda: sharded_coord_zero_temperature(torch, mesh),
             "sharded 2-D")
        timed("checkpoint and resume on 2 ranks",
              lambda: sharded_checkpoint_phase(torch, mesh, workdir))
    for grid, n_steps in zip(BRICK_GRIDS, (20, 5)):
        if int(np.prod(grid)) == mesh.size:
            bmesh = make_brick_mesh(*grid)
            part(f"brick host on {' x '.join(map(str, grid))}",
                 lambda: slab_zero_temperature(torch, bmesh, n_steps=n_steps), brick_label(grid))
    for case in rank_cases(mesh.size):
        part(spatial_label(case), lambda: spatial_zero_temperature(torch, mesh, case),
             spatial_label(case))
    out["examples"] = timed(f"example scripts on {mesh.size} ranks",
                            lambda: example_rank_part(torch, mesh, workdir))
    return out if mesh.rank == 0 else None


def multi_rank_runs():
    """One rank's timed runs of ``rank_runs`` alone (the same host over
    another backend, for the records); returns rank 0's records."""
    import torch

    from edm_tpu_torch.parallel import make_mesh

    mesh = make_mesh()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {host: run() for host, run in rank_runs(torch, mesh).items()}
    return out if mesh.rank == 0 else None


def ranks_table(records):
    """The records of each sharded host by rank count and backend, one row
    each: steps/s, collectives and kB a step, host stagings and counted
    host syncs a step, rank 0's busy share."""
    print("sharded hosts (rank 0; " + card_line() + "): host | ranks | backend | steps/s | "
          "collectives a step | kB a step | host stagings a step | host syncs a step | "
          "rank 0 busy", flush=True)
    for (n, backend), runs in records.items():
        for host, r in runs.items():
            c, k = r["collectives"], r["timed_steps"]
            busy = "not measured" if r["busy"] is None else f"{r['busy']:.1%}"
            print(f"  {host} | {n} | {backend} | {r['steps_per_s']:.2f} | {c['calls'] / k:.2f} | "
                  f"{c['bytes'] / k / 1e3:.1f} | {c['host_syncs'] / k:.2f} | "
                  f"{r['syncs_per_step']:.2f} | {busy}", flush=True)


def multi_rank_phases(counts=(2, 4, 8), gloo=False):
    """The multi-device phases on each of ``counts`` ranks through
    ``parallel.launch`` (the kernels are built already, in this process);
    a failing or hung rank raises.  Where the machine has a card per rank
    the launch is NCCL's; with ``gloo`` the same host's timed runs then run
    again over gloo with the ranks sharing card 0, for the records.  Prints
    the runs' table (``ranks_table``) and returns rank 0's results of each
    launch, by rank count."""
    import tempfile

    from edm_tpu_torch.parallel import launch
    from edm_tpu_torch.parallel.mesh import pick_backend

    out, records = {}, {}
    for n in counts:
        t_phase = time.perf_counter()
        print(f"multi-device: {multi_rank_line(n)}", flush=True)
        with tempfile.TemporaryDirectory() as workdir:
            out[n] = launch(multi_rank_phase, n, workdir, timeout=300)[0]
        backend = pick_backend(n, "cuda")
        records[(n, backend)] = out[n]["runs"]
        print(f"multi-device phases on {n} ranks: {time.perf_counter() - t_phase:.1f} s",
              flush=True)
        if gloo and backend == "nccl":
            t_phase = time.perf_counter()
            print(f"multi-device, the same runs: {n} ranks, backend gloo, 1 card: cuda:0 "
                  f"({card_lines()[0]})", flush=True)
            records[(n, "gloo")] = launch(multi_rank_runs, n, backend="gloo", timeout=300)[0]
            print(f"the gloo runs on {n} ranks: {time.perf_counter() - t_phase:.1f} s",
                  flush=True)
    ranks_table(records)
    return out


def ranks_main(torch, *args) -> int:
    """``--ranks [gloo]``: the multi-device part alone, for a machine with
    several cards (each of its seconds costs one a card): the launches of
    the rank counts its cards cover, over NCCL a card a rank (on one card
    all three, over gloo), with ``gloo`` each NCCL launch's timed runs again
    over gloo on card 0, then the dry run on the most ranks launched."""
    from edm_tpu_torch.parallel.dryrun import dryrun_multichip

    if args not in ((), ("gloo",)):
        print("usage: chip_smoke.py --ranks [gloo]", file=sys.stderr)
        return 2
    counts = tuple(n for n in (2, 4, 8) if n <= torch.cuda.device_count()) or (2, 4, 8)
    t_phase = time.perf_counter()
    multi_rank_phases(counts, gloo=bool(args))
    print(f"multi-device phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    dryrun_multichip(max(counts), timeout=300)
    print(f"dry run (dryrun_multichip({max(counts)})): {time.perf_counter() - t_phase:.1f} s")
    print(f"--ranks: the launches of {', '.join(map(str, counts))} ranks and the dry run passed")
    return 0


# ------------------------------------------------ the user's entry points

ORACLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "oracles")
API_TOL = 1e-9  # the compiled reference's fixtures (float64)
WORKLOAD_EDM = ("tempering 0\nhill_prefactor 10.0\nbias_per_step 1.0\nhill_density 250\n"
                "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
# the .ltab fixtures: (file, grid min, hills (x, h)) on [gmin, 3], spacing
# 0.0097, sigma 0.1 (tests/oracles/oracle_ltab.cpp)
LTAB_CASES = [("oracle.ltab", 0.0, [(0.05, 0.7), (1.50, 1.0), (2.37, 0.3), (2.98, 0.5)]),
              ("oracle2.ltab", 0.5, [(1.0, 1.0), (2.9, 0.4)])]
LTAB_TOL = 5e-7  # the table's values are written with 8 decimals


def read_workload():
    """tests/oracles/workload.txt: the 500 pair distances, each round's 1000
    acceptance uniforms and the reference's cum_bias after it, and the 31
    probe values at the end."""
    lines = open(os.path.join(ORACLES, "workload.txt")).read().strip().splitlines()
    r = np.array([float(v) for v in lines[0].split()[1:]])
    rounds, probes, i = [], None, 1
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] == "U":
            rounds.append((np.array([float(v) for v in tok[1:]]),
                           float(lines[i + 1].split()[1])))
            i += 2
        else:
            if tok[0] == "PROBES":
                probes = np.array([float(v) for v in tok[1:]])
            i += 1
    return r, rounds, probes


def parse_ltab(text):
    """An .ltab file as (header lines, zero rows, grid rows split)."""
    header, zero_rows, grid_rows = [], [], []
    for ln in text.splitlines():
        parts = ln.split()
        if len(parts) == 4 and not ln.startswith("#"):
            if parts[2] == "0.0" and parts[3] == "0.0" and "." not in parts[0]:
                zero_rows.append(ln)
            else:
                grid_rows.append(parts)
        else:
            header.append(ln)
    return header, zero_rows, grid_rows


def check_ltab(text, fixture) -> float:
    """tests/test_ltab_oracle.py's comparison with the compiled reference's
    table: header and zero rows byte-identical, each grid row's index and x
    identical, values and forces within ``LTAB_TOL``.  Returns the largest
    value difference."""
    want = parse_ltab(open(os.path.join(ORACLES, fixture)).read())
    got = parse_ltab(text)
    if got[0] != want[0] or got[1] != want[1] or len(got[2]) != len(want[2]):
        raise AssertionError(f"{fixture}: header, zero rows or row count differ")
    if any(g[:2] != w[:2] for g, w in zip(got[2], want[2])):
        raise AssertionError(f"{fixture}: a row's index or x differs")
    gv = np.array([[float(v) for v in r[2:]] for r in got[2]])
    wv = np.array([[float(v) for v in r[2:]] for r in want[2]])
    err = float(np.abs(gv - wv).max())
    if not err <= LTAB_TOL:
        raise AssertionError(f"{fixture}: values differ by {err:.3e} > {LTAB_TOL}")
    return err


def api_phase(torch, device):
    """The binding surface on the card: ``EDMBias(device="cuda")`` in
    float64 replays tests/oracles/workload.txt (500 pairs x 2 hills x 6
    rounds, heavy capping) through pre_add_hill / add_hill_r /
    post_add_hill as an MD engine drives it; cum_bias after each round and
    the 31 probes within 1e-9 of the compiled reference, deferred hills
    left at the end.  Hill rounds per second (host clock, each round with
    its 1,000 add_hill_r calls and the cum_bias read), the host syncs a
    round counts, and a seventh round's syncs under CUDA sync-debug mode,
    named by line.  Then the two .ltab fixtures from grids deposited on the
    card (``write_lammps_table``)."""
    import tempfile

    from edm_tpu_torch.api import EDMBias
    from edm_tpu_torch.gauss import GaussGrid
    from edm_tpu_torch.utils.gridio import write_lammps_table

    r, rounds, probes = read_workload()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "wl.edm")
        with open(path, "w") as f:
            f.write(WORKLOAD_EDM)
        b = EDMBias(path, 1.0, 1.0, log_hills=False, device=device)
        b.set_box([0], [3.0], [False])
        if b.state.bias.grid.values.device != torch.device(device) or b.dtype != torch.float64:
            raise AssertionError("EDMBias did not build a float64 bias on the card")

        def one_round(us):
            b.pre_add_hill(len(r) * 2)
            for k, rk in enumerate(r):
                b.add_hill_r([rk], us[2 * k])
                b.add_hill_r([rk], us[2 * k + 1])
            b.post_add_hill()

        worst, t_rounds = 0.0, 0.0
        for us, want in rounds:
            t0 = time.perf_counter()
            one_round(us)
            got = b.cum_bias
            t_rounds += time.perf_counter() - t0
            worst = max(worst, abs(got - want))
            if not abs(got - want) < API_TOL:
                raise AssertionError(f"workload round: cum_bias {got!r}, reference {want!r}")
        got = np.array([b.bias_value([0.05 + k * 0.095]) for k in range(31)])
        probe_err = float(np.abs(got - probes).max())
        deferred = int(b.state.buf_right) - int(b.state.buf_left)
        counted = b.host_syncs / len(rounds)
        before = b.host_syncs
        sites = sync_sites(torch, lambda: one_round(rounds[0][0]))
        counted7 = b.host_syncs - before
        errs = {}
        for fixture, gmin, hills in LTAB_CASES:
            g = GaussGrid.create([gmin], [3.0], [0.0097], [False], [0.1], boundary_min=[gmin],
                                 boundary_max=[3.0], boundary_periodic=[False],
                                 dtype=torch.float64, device=device)
            for x, h in hills:
                g, _ = g.add_value(torch.tensor([[x]], dtype=torch.float64, device=device),
                                   torch.tensor([h], dtype=torch.float64, device=device))
            out = os.path.join(d, fixture)
            write_lammps_table(g.grid, out, [gmin], [3.0])
            errs[fixture] = check_ltab(open(out).read(), fixture)
    if not probe_err < API_TOL or deferred <= 0:
        raise AssertionError(f"workload: probes off by {probe_err:.3e} or no deferred hills "
                             f"({deferred})")
    if sum(sites.values()) > counted7:
        raise AssertionError(f"an API round synchronized {sites}, more than the "
                             f"{counted7} it counts")
    print(f"API on the card (EDMBias float64, tests/oracles/workload.txt): 6 rounds of 1,000 "
          f"hills match the compiled reference, worst cum_bias |diff| {worst:.3e}, 31 probes "
          f"{probe_err:.3e} (bound {API_TOL}); {deferred} hills deferred at the end; "
          f"{len(rounds) / t_rounds:.2f} hill rounds/s (each with its 1,000 add_hill_r calls); "
          f"{counted:.2f} host syncs counted per round; a round under sync-debug mode: "
          f"{sum(sites.values())}" + "".join(f"; {s} x{n}" for s, n in sites.items())
          + f" (counted {counted7})")
    print("  .ltab from grids on the card vs the compiled reference: "
          + ", ".join(f"{k} max |diff| {v:.3e}" for k, v in errs.items())
          + f" (bound {LTAB_TOL}; header and zero rows byte-identical)")
    return len(rounds) / t_rounds


def leaf_paths(obj, path=""):
    """(path, value) of every tensor, numpy array and plain value of a
    state (dataclasses, NamedTuples, tuples)."""
    import dataclasses

    import torch

    if isinstance(obj, (torch.Tensor, np.ndarray)) or obj is None or isinstance(
            obj, (bool, int, float, str)):
        return [(path, obj)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [lv for f in dataclasses.fields(obj)
                for lv in leaf_paths(getattr(obj, f.name), f"{path}.{f.name}")]
    if isinstance(obj, tuple):
        return [lv for i, v in enumerate(obj) for lv in leaf_paths(v, f"{path}[{i}]")]
    return [(path, obj)]  # static structure (specs): compared by ==


def bitwise_diffs(a, b):
    """The leaves where two states differ, with the largest difference:
    every tensor bitwise (NaN-aware), everything else by ==."""
    import torch

    la, lb = leaf_paths(a), leaf_paths(b)
    if [p for p, _ in la] != [p for p, _ in lb]:
        raise AssertionError("the two states have different structures")
    out = {}
    for (p, x), (_, y) in zip(la, lb):
        if isinstance(x, torch.Tensor):
            if x.shape != y.shape or x.dtype != y.dtype or not torch.equal(x, y):
                out[p] = float((x.double() - y.double()).abs().max()) if x.shape == y.shape \
                    else float("inf")
        elif isinstance(x, np.ndarray):
            if not np.array_equal(x, y):
                out[p] = float("inf")
        elif x != y:
            out[p] = float("inf")
    return out


def cleared_hist(state):
    """``state`` with its CV histogram zeroed, as ``run_simulation`` leaves it
    after a write."""
    import dataclasses

    core = state.core
    bias = dataclasses.replace(core.bias, cv_hist=core.bias.cv_hist.clear())
    return dataclasses.replace(state, core=dataclasses.replace(core, bias=bias))


def production_outputs(d, tag):
    return dict(bias_file=os.path.join(d, f"{tag}_BIAS"),
                histogram_file=os.path.join(d, f"{tag}_HIST"),
                lammps_table=os.path.join(d, f"{tag}_BIAS.ltab"), box_low=[0.0],
                box_high=[3.0])


def hills_rows(lines):
    """HILLS lines as (step/type/counter columns, the numbers)."""
    return ([ln.split()[:3] for ln in lines],
            np.array([[float(v) for v in ln.split()[3:]] for ln in lines]))


def production_zero_temperature(torch, device, n_steps=20, write_stride=10):
    """The production run as users drive it: the 10k exact configuration
    of ``bench_setup`` through ``driver.run_simulation`` with the dynamic
    step (every ``static_do_*`` None) and ``collect_records=True``, a
    ``HillsLog``, and bias, histogram and .ltab files, at kT = 0 for 20
    steps (a write every 10), with the launch counters set to 0 just before
    and read just after (K1 on every step; these two periods run at full
    cap).  Held: bitwise against the same 20 steps through
    ``pattern_segment``'s static phases from the same state (the histogram
    cleared at the same writes); the HILLS file's bias_added column against
    the growth of cum_bias (1e-6 relative, plus half a unit of the 8th
    decimal for each line's rounding); the HILLS file line for line
    against the same run through the kernels' plain versions (step, type and
    counter exactly, the numbers within FORCE_REL of each column's max)."""
    import tempfile

    from edm_tpu_torch.models.driver import pattern_segment, run_simulation
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.utils.hills_log import HillsLog

    spec, state0, steps = bench_setup(torch, 0.0, device, dynamic=True)
    dyn = steps[3]
    with tempfile.TemporaryDirectory() as d:
        def run(tag):
            log = HillsLog(os.path.join(d, f"{tag}_HILLS_0"), 1, dyn.params.total_volume)
            st, e = run_simulation(dyn, state0, n_steps, write_stride, hills_log=log,
                                   **production_outputs(d, tag))
            log.close()
            return st, e, open(os.path.join(d, f"{tag}_HILLS_0")).read().splitlines()

        for name in FORCE_KERNELS:
            getattr(CF, name).launches = 0
        dyn.host_syncs = 0
        st, e, hills = run("card")
        torch.cuda.synchronize()
        launches = {name: getattr(CF, name).launches for name in FORCE_KERNELS}
        step_reads = dyn.host_syncs
        ref, e_ref = state0, []
        for _ in range(n_steps // write_stride):
            ref, e_seg = pattern_segment(pattern(steps[:3]), write_stride)(ref)
            ref = cleared_hist(ref)
            e_ref.append(e_seg)
        diffs = bitwise_diffs(st, ref)
        if not torch.equal(e, e_ref[-1]):
            diffs["energies"] = max_err(e, e_ref[-1])
        with plain_versions():
            _, _, hills_plain = run("plain")
        files = {k: os.path.getsize(os.path.join(d, f"card_{k}"))
                 for k in ("BIAS", "HIST", "BIAS.ltab")}
        ltab_rows = parse_ltab(open(os.path.join(d, "card_BIAS.ltab")).read())[2]
    if diffs:
        raise AssertionError(f"run_simulation vs pattern_segment: leaves differ {diffs}")
    cols, nums = hills_rows(hills)
    cols_p, nums_p = hills_rows(hills_plain)
    if cols != cols_p:
        raise AssertionError("the HILLS file through the kernels and through the plain versions "
                             "differ in their lines, types or counters")
    col_err = np.abs(nums - nums_p).max(0)
    col_bnd = FORCE_REL * np.maximum(1.0, np.abs(nums_p).max(0))
    cum = float(st.core.bias.cum_bias)
    added = float(nums[:, 2].sum())
    checks = {
        # the bench state's tail (192 atoms above kernel_cap) outgrows
        # overflow_cap: these periods run K1 at full cap; the kT = 0.8 run
        # reaches the reduced-cap periods and K2
        "K1 on every step": launches["cell_force_newton"] == n_steps,
        "two hill rounds logged": sorted({c[0] for c in cols}) == ["0", "1"],
        "HILLS numbers within the kT=0 tolerance": bool((col_err <= col_bnd).all()),
        "bias_added sums to cum_bias": abs(added - cum) <= 1e-6 * cum + 5e-9 * len(hills),
        "outputs written": all(v > 0 for v in files.values()) and len(ltab_rows) > 0,
        "finite": all(bool(torch.isfinite(t).all()) for t in (st.xs, st.vs, st.fs, e)),
    }
    print(f"kT=0 run_simulation (10k exact, dynamic step with records, a write every "
          f"{write_stride}): {n_steps} steps bitwise equal to pattern_segment's static phases "
          f"(every leaf of the state and the energies); launches {launches}; counter and flag "
          f"reads counted by the step {step_reads}; HILLS {len(hills)} lines (types "
          f"{sorted({c[1] for c in cols})}), equal to the plain versions' run line for line, "
          f"worst column |diff| {col_err.max():.3e}; bias_added sum {added!r} vs cum_bias "
          f"{cum!r} ({abs(added - cum) / cum:.3e} relative); files {files}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0 run_simulation failed: {failed}")
    return launches


@contextlib.contextmanager
def timed_writes(torch, log):
    """Wall time spent in each part of ``run_simulation``'s writes: the
    records' copy to the host, the HILLS replay, the grid and .ltab files.
    Each timed call starts after a device sync, so it holds only its own
    work.  Yields the dict of seconds."""
    from edm_tpu_torch.models import driver as D

    spent = {"records to host": 0.0, "HILLS replay": 0.0, "grid files": 0.0}
    saved = D.to_host, D.write_grid, D.write_lammps_table, log.log_round

    def timed(fn, key):
        def wrapper(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            spent[key] += time.perf_counter() - t0
            return out
        return wrapper

    D.to_host = timed(saved[0], "records to host")
    D.write_grid = timed(saved[1], "grid files")
    D.write_lammps_table = timed(saved[2], "grid files")
    log.log_round = timed(saved[3], "HILLS replay")
    try:
        yield spent
    finally:
        D.to_host, D.write_grid, D.write_lammps_table = saved[:3]
        del log.log_round


def production_run(torch, device, warm_steps=100, timed_steps=300, write_stride=100):
    """The production run at kT = 0.8: ``run_simulation`` (the dynamic
    step with records, a write every 100 steps with every output) and
    ``pattern_segment``'s static phases (no output), in turns from the same
    warmed state, host clock up to a device sync; the K1 / K2 counters set
    to 0 just before each run_simulation run and summed just after.  Then
    one write period with its writers timed (``timed_writes``), and one
    under CUDA sync-debug mode, its syncs named by line."""
    import tempfile

    from edm_tpu_torch.models.driver import pattern_segment, run_simulation
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.utils.hills_log import HillsLog

    spec, state, steps = bench_setup(torch, 0.8, device, dynamic=True)
    dyn = steps[3]
    state, _ = pattern_segment(pattern(steps[:3]), warm_steps)(state)
    rates = {"pattern_segment": [], "run_simulation": []}
    launches = {name: 0 for name in FORCE_KERNELS}
    with tempfile.TemporaryDirectory() as d:
        log = HillsLog(os.path.join(d, "HILLS_0"), 1, dyn.params.total_volume)
        out = production_outputs(d, "run")
        seg = pattern_segment(pattern(steps[:3]), timed_steps)

        def rs(s):
            return run_simulation(dyn, s, timed_steps, write_stride, hills_log=log, **out)

        for name in ("pattern_segment", "run_simulation", "run_simulation", "pattern_segment"):
            if name == "run_simulation":
                for k in FORCE_KERNELS:
                    getattr(CF, k).launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, e = (rs if name == "run_simulation" else seg)(state)
            torch.cuda.synchronize()
            rates[name].append(timed_steps / (time.perf_counter() - t0))
            if name == "run_simulation":
                for k in FORCE_KERNELS:
                    launches[k] += getattr(CF, k).launches
        with timed_writes(torch, log) as spent:
            state, _ = run_simulation(dyn, state, write_stride, write_stride, hills_log=log, **out)
        n0 = dyn.host_syncs
        holder = {}
        sites = sync_sites(torch, lambda: holder.update(out=run_simulation(
            dyn, state, write_stride, write_stride, hills_log=log, **out)))
        counted = dyn.host_syncs - n0
        state = holder["out"][0]
        log.close()
        n_lines = sum(1 for _ in open(os.path.join(d, "HILLS_0")))
    core = state.core
    checks = {
        "finite": all(bool(torch.isfinite(t).all()) for t in (state.xs, state.vs, state.fs)),
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "K1 and K2 launched": launches["cell_force_newton"] > 0 and launches[
            "overflow_force"] > 0,
        "HILLS lines written": n_lines > 0,
    }
    total = sum(sites.values())
    print(f"kT=0.8 run_simulation vs pattern_segment (10k exact, {timed_steps} steps a run, in "
          f"turns after {warm_steps} warm-up): run_simulation "
          + ", ".join(f"{v:.2f}" for v in rates["run_simulation"]) + " steps/s; pattern_segment "
          + ", ".join(f"{v:.2f}" for v in rates["pattern_segment"]) + " steps/s; "
          f"run_simulation launches {launches}; HILLS lines {n_lines}")
    print(f"  a write every {write_stride} steps: wall time per write "
          f"{1e3 * sum(spent.values()):.2f} ms (" + ", ".join(
              f"{k} {1e3 * v:.2f} ms" for k, v in spent.items()) + ")")
    print(f"  host syncs of one write period (CUDA sync-debug mode): {total} in {write_stride} "
          f"steps, {total / write_stride:.2f} per step" + "".join(
              f"; {s} x{n}" for s, n in sorted(sites.items(), key=lambda kv: -kv[1]))
          + f" (counted by the step: {counted})")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 run_simulation failed: {failed}")
    return rates, launches


def checkpoint_phase(torch, device, n=50):
    """``save_state`` after 50 steps of the 10k exact run at kT = 0.8,
    ``load_state`` into a freshly built template on the card, 50 more
    steps: every leaf bitwise the 100 uninterrupted steps (``tail_ovf_host``
    and ``kernel_cap`` included, which pick K1's cap)."""
    import tempfile

    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.utils.checkpoint import load_state, save_state

    _, state0, steps = bench_setup(torch, 0.8, device)
    full, _ = pattern_segment(pattern(steps), 2 * n)(state0)
    mid, _ = pattern_segment(pattern(steps), n)(state0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        save_state(mid, path)
        size = os.path.getsize(path)
        _, fresh, steps2 = bench_setup(torch, 0.8, device)
        resumed = load_state(fresh, path)
    if resumed.xs.device != torch.device(device):
        raise AssertionError("load_state did not restore onto the card")
    cont, _ = pattern_segment(pattern(steps2), n)(resumed)
    diffs = bitwise_diffs(cont, full)
    buffered = int(mid.core.bias.buf_right) - int(mid.core.bias.buf_left)
    if diffs:
        raise AssertionError(f"checkpoint resume: leaves differ from the uninterrupted run {diffs}")
    print(f"checkpoint on the card: {n} steps, save_state ({size} bytes), load_state into a fresh "
          f"template, {n} more: bitwise the {2 * n} uninterrupted steps (every leaf; "
          f"{buffered} deferred hills and tail_ovf_host {mid.tail_ovf_host} at the checkpoint)")


def native_io_phase(torch, device):
    """The port's C++ formatters loaded on this machine (no Python
    fallback here), and ``write_grid`` of the McGDP cell's 1001 x 1001 bias
    grid after one hill round (values and two derivatives a point), timed
    by the host clock from a device sync; read back by
    ``read_grid_file`` within the text's 8 decimals."""
    import tempfile

    from edm_tpu_torch import native
    from edm_tpu_torch.utils.gridio import read_grid_file, write_grid

    if native.load() is None or native.load_hillslog() is None:
        raise AssertionError(f"the native formatters did not load: {native.errors}")
    state, steps = coord_setup(torch, 1.0, device, periodic=False)
    state, _ = steps[0](state)
    grid = state.bias.bias.grid
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "BIAS")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        write_grid(grid, path)
        dt = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        back = read_grid_file(path, dim=2, interpolate=True, dtype=torch.float64, device=device)
        dt_read = time.perf_counter() - t0
    err = max(max_err(back.values, grid.values), max_err(back.derivs, grid.derivs))
    if not err <= 1e-8 + 1e-7 * float(grid.derivs.abs().max()):
        raise AssertionError(f"the 1001 x 1001 grid read back off by {err:.3e}")
    print(f"native I/O: gridio and hillslog loaded; write_grid of the "
          f"{'x'.join(map(str, grid.spec.nbins))} McGDP grid (values and derivatives): "
          f"{1e3 * dt:.1f} ms, {size} bytes; read_grid_file {1e3 * dt_read:.1f} ms, "
          f"max |diff| {err:.3e}")
    return dt


# ------------------------------------------------ the example scripts

EXAMPLES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
SINGLE_HOST_TOL = 1e-12  # the single-particle host path, card against CPU (float64)
# the occupancy script at each width: (segments, steps a segment); the JAX
# script's defaults are 8 segments of 300 steps (10k) and of 200 (100k)
OCC_DEPTH = {10000: (2, 300), 100000: (2, 200)}
# the weak-scaling script's configurations on the card, by rank count: one
# of each decomposition (the 1-rank slab runs in this process, the others
# in the multi-device launches)
EXAMPLE_WEAK = {1: ((1, None),), 2: ((2, None),), 4: ((4, (2, 2)),), 8: ((8, (2, 2, 2)),)}


def example(name):
    """The module of ``examples/<name>.py``."""
    import importlib

    if EXAMPLES not in sys.path:
        sys.path.insert(0, EXAMPLES)
    return importlib.import_module(name)


@contextlib.contextmanager
def example_dir():
    """A scratch directory for a script's files: new temporary directories
    go under it while the block runs, and the working directory (which the
    scripts change) is restored after it."""
    import tempfile

    cwd, saved = os.getcwd(), tempfile.tempdir
    with tempfile.TemporaryDirectory() as d:
        tempfile.tempdir = d
        try:
            yield d
        finally:
            tempfile.tempdir = saved
            os.chdir(cwd)


def launch_counters():
    """[(name, object with the counter, attribute)] of every kernel wrapper.
    The examples phases zero and read every counter at once through it; the
    earlier phases keep their own resets of the wrappers they drive."""
    from edm_tpu_torch.ops import cellforce as CF
    from edm_tpu_torch.ops import deposit_kernels as DK
    from edm_tpu_torch.ops import prng

    out = [(name, w, "launches") for name, w in port_wrappers().items()]
    out.append(("row_box", CF.cell_force_newton, "row_box_launches"))
    for name, w in (("threefry_bits", prng.threefry_bits), ("threefry_rows", prng.threefry_rows),
                    ("deposit_windowed_1d", DK.deposit_windowed_1d),
                    ("deposit_dense_1d_kernel", DK.deposit_dense_1d_kernel)):
        out.append((name, w, "launches"))
    return out


def reset_launches():
    for _, obj, attr in launch_counters():
        setattr(obj, attr, 0)


def read_launches() -> dict:
    """The kernel launches since ``reset_launches``, those not zero."""
    return {name: getattr(obj, attr) for name, obj, attr in launch_counters()
            if getattr(obj, attr)}


def require_launches(what, launches, names):
    """Raise unless each kernel of ``names`` was launched in the part."""
    missing = [n for n in names if not launches.get(n)]
    if missing:
        raise AssertionError(f"{what}: no launch of {missing} (launches {launches})")


def example_sweep(torch, device, d):
    """``torch_boundary_sweep.sweep`` on the card (float64; the script's
    ``main`` adds a summary of 601 lookups a deposit, left out here): each deposit's
    cum_bias, values and derivatives at the fixture's probes within 1e-9
    (``API_TOL``) of the compiled reference; the seven grid files."""
    bs = example("torch_boundary_sweep")
    grids = bs.sweep(d, device)
    runs = bs.read_oracle(os.path.join(ORACLES, "boundary_sweep.txt"))
    if not len(grids) == len(runs) == 7:
        raise AssertionError(f"boundary sweep: {len(grids)} deposits, fixture {len(runs)}")
    worst = [0.0, 0.0, 0.0]
    for (x_ref, cum_ref, probes), (x, b) in zip(runs, grids):
        if b.device != device or b.dtype != torch.float64 or abs(x - x_ref) > 1e-12:
            raise AssertionError(f"boundary sweep: deposit at {x} on {b.device} in {b.dtype}")
        worst[0] = max(worst[0], abs(b.cum_bias - cum_ref))
        for q, v_ref, d_ref in probes:
            v, (dv,) = b.get_force([q])
            worst[1], worst[2] = max(worst[1], abs(v - v_ref)), max(worst[2], abs(dv - d_ref))
    if not max(worst) <= API_TOL:
        raise AssertionError(f"boundary sweep: worst |diff| {worst} > {API_TOL}")
    files = [f for f in (f"grid_{i + 1}.dat" for i in range(7))
             if os.path.getsize(os.path.join(d, f)) > 0]
    if len(files) != 7:
        raise AssertionError(f"boundary sweep: grid files written {files}")
    print(f"boundary sweep on the card (float64): 7 deposits against the compiled reference, "
          f"worst |diff| cum_bias {worst[0]:.3e}, values {worst[1]:.3e}, derivatives "
          f"{worst[2]:.3e} (bound {API_TOL:g}); 7 grid files")


def example_single_particle(torch, device):
    """``torch_single_particle.main`` on the card at full length (2,000
    steps): the host path's U and dU/dx after one hill and after 20 more
    within ``SINGLE_HOST_TOL`` of the same calls on the CPU; after the run
    cum_bias > 0, the step counter at 2,000 and the CV histogram's visits
    equal to the hill rounds (one particle, one visit a round: 200), the
    energies finite, the BIAS file written."""
    import random

    sp = example("torch_single_particle")
    random.seed(0)
    card = sp.main(device)
    random.seed(0)
    cpu = sp.main("cpu", n_steps=10)
    errs = {k: abs(card[k] - cpu[k]) for k in ("u", "du", "u20", "du20")}
    if not all(e <= SINGLE_HOST_TOL * max(1.0, abs(cpu[k])) for k, e in errs.items()):
        raise AssertionError(f"single particle host path, card vs CPU: {errs}")
    st = card["state"]
    visits, rounds = float(st.bias.cv_hist.values.sum()), int(st.bias.steps)
    cum = float(st.bias.cum_bias)
    if not (int(st.step) == sp.N_STEPS and cum > 0 and rounds == sp.N_STEPS // 10
            and visits == rounds and bool(torch.isfinite(card["energies"]).all())
            and os.path.getsize(os.path.join(card["workdir"], "BIAS")) > 0):
        raise AssertionError(f"single particle: step {int(st.step)}, cum_bias {cum}, rounds "
                             f"{rounds}, visits {visits}")
    print(f"single particle on the card: host path within {max(errs.values()):.3e} of the CPU "
          f"(bound {SINGLE_HOST_TOL:g}); {sp.N_STEPS} steps, cum_bias {cum:.4f}, {rounds} "
          f"rounds, visits {visits:.0f}")


def example_rdf(torch, device):
    """``torch_pairwise_rdf.main(400)`` on the card: the state, grid and
    energies finite, every output file written, and the script's verdict:
    the bias in the target well below the bias outside it."""
    r = example("torch_pairwise_rdf").main(400, device)
    st = r["state"]
    files = {f: os.path.getsize(os.path.join(r["workdir"], f))
             for f in ("BIAS", "BIAS.ltab", "HIST", "target.grid")}
    finite = all(bool(torch.isfinite(t).all())
                 for t in (st.x, st.v, st.bias.bias.grid.values, r["energies"]))
    if not (finite and int(st.step) == 400 and all(files.values())
            and r["well"] < r["outside"]):
        raise AssertionError(f"pairwise RDF: finite {finite}, step {int(st.step)}, files "
                             f"{files}, well {r['well']} vs outside {r['outside']}")
    print(f"pairwise RDF on the card: 400 steps finite, files {sorted(files)}, bias in the "
          f"well {r['well']:.4f} < outside {r['outside']:.4f}")


def example_occupancy(torch, device, n):
    """``torch_occupancy_diag`` on the card at ``n`` atoms (``OCC_DEPTH``):
    every ``cell_diag`` line's histogram sums to the cells and its
    occupancies to the atoms, no cell overflowed (the script asserts no hill
    was dropped).  Returns the lines."""
    segs, steps = OCC_DEPTH[n]
    lines, state = example("torch_occupancy_diag").main(
        ["--n", str(n), "--segments", str(segs), "--steps", str(steps), "--device", str(device)])
    for d in lines:
        hist = np.asarray(d["occ_hist"])
        if not (hist.sum() == d["n_cells"] and (hist * np.arange(len(hist))).sum() == n
                and not d["cell_overflow"]):
            raise AssertionError(f"occupancy at {n} ({d['at']}): {d}")
    if len(lines) != segs + 1 or int(state.core.step) != segs * steps:
        raise AssertionError(f"occupancy at {n}: {len(lines)} lines, step {int(state.core.step)}")
    return lines


def examples_phase(torch, device):
    """The example scripts' single-process parts on the card, each with the
    launch counters set to 0 just before it and read just after (the 2-, 4-
    and 8-rank parts run in the multi-device launches:
    ``example_rank_part``): the boundary sweep, the single particle, the
    RDF run, the occupancy diagnostic at 10k and 100k, the weak-scaling
    script's 1-rank slab.  Returns each part's seconds and launches."""
    ws = example("torch_weak_scaling")
    seconds, launches = {}, {}
    need = {"occupancy 10k": ("cell_force_newton", "normal_rows_cols", "p1_counts_half",
                              "uniform_rows_cols"),
            "single particle": ("threefry_bits",), "pairwise RDF": ("threefry_bits",),
            "weak scaling 1 rank": ("cell_force_newton",)}
    need["occupancy 100k"] = need["occupancy 10k"]
    parts = (
        ("boundary sweep", lambda d: example_sweep(torch, device, d)),
        ("single particle", lambda d: example_single_particle(torch, device)),
        ("pairwise RDF", lambda d: example_rdf(torch, device)),
        ("occupancy 10k", lambda d: example_occupancy(torch, device, 10000)),
        ("occupancy 100k", lambda d: example_occupancy(torch, device, 100000)),
        ("weak scaling 1 rank", lambda d: [print(json.dumps(ws.run(n, grid, device=device)))
                                           for n, grid in EXAMPLE_WEAK[1]]))
    for name, fn in parts:
        reset_launches()
        t = time.perf_counter()
        with example_dir() as d:
            fn(d)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t
        launches[name] = read_launches()
        require_launches(f"example {name}", launches[name], need.get(name, ()))
        print(f"  example {name}: {seconds[name]:.1f} s; kernel launches {launches[name]}",
              flush=True)
    return {"seconds": seconds, "launches": launches}


def example_rank_part(torch, mesh, workdir):
    """One rank's share of the example scripts, with the launch counters set
    to 0 just before each script and read just after: the weak-scaling
    script's configuration of this rank count (``EXAMPLE_WEAK``: the slab
    on 2 ranks, the 2 x 2 brick on 4, the 2 x 2 x 2 brick on 8; K1's owned
    box with the Chebyshev table on every step, its JSON line printed),
    and on 8 ranks the spatial script's ``rank_main`` in ``workdir``:
    cum_bias, the rounds and the segment numbers equal on every rank,
    ``BIAS_GLOBAL`` and the eight ``HILLS_<r>`` written.  Returns this
    rank's launches and seconds by script."""
    from edm_tpu_torch.parallel import all_gather

    ws = example("torch_weak_scaling")
    out = {"launches": {}, "seconds": {}}
    reset_launches()
    t = time.perf_counter()
    for row in ws.run_group(EXAMPLE_WEAK[mesh.size], ws.STEPS):
        rank_print(mesh, json.dumps(row))
    out["seconds"]["weak scaling"] = time.perf_counter() - t
    out["launches"]["weak scaling"] = read_launches()
    require_launches(f"example weak scaling, rank {mesh.rank}", out["launches"]["weak scaling"],
                     ("row_box",))
    if mesh.size == 8:
        sp = example("torch_spatial_sharded")
        reset_launches()
        t = time.perf_counter()
        cwd = os.getcwd()
        os.chdir(workdir)
        try:
            res = sp.rank_main()
        finally:
            os.chdir(cwd)
        out["seconds"]["spatial"] = time.perf_counter() - t
        out["launches"]["spatial"] = read_launches()
        require_launches(f"example spatial, rank {mesh.rank}", out["launches"]["spatial"],
                         ("threefry_bits",))
        nums = torch.tensor([res["cum"], res["rounds"]] + [v for s in res["segments"] for v in s],
                            dtype=torch.float64, device=mesh.device)
        g = all_gather(nums[None], mesh)
        if not bool((g == g[0]).all()) or res["truncated"]:
            raise AssertionError(f"example spatial: the ranks differ or truncated: {g.tolist()}")
        if mesh.rank == 0:
            files = {f: os.path.getsize(os.path.join(workdir, f))
                     for f in ["BIAS_GLOBAL"] + [f"HILLS_{r}" for r in range(8)]}
            if not all(files.values()):
                raise AssertionError(f"example spatial: files {files}")
            print(f"spatial example (8 ranks): cum_bias {res['cum']:.4f} over {res['rounds']} "
                  f"rounds equal on every rank; BIAS_GLOBAL and HILLS_0..7 written", flush=True)
    return out


def kernel_entry(name, source, replaces, launches, device_ms, rows, prefix):
    """One ``kernels`` record: the worst error over the prefix's checks,
    the time and bound of its first row (the main path's shape), and the
    device time per launch in the main path's profile."""
    sel = [v for k, v in rows.items() if k.startswith(prefix)]
    err, ms, plain, bms, by = sel[0]
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max(v[0] for v in sel), "ms": ms,
            "device_ms": device_ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": None}


def time_slice(torch, tree, runs=2, warm_steps=100, timed_steps=300):
    """The exact-lookup kT = 0.8 run of the checkout at ``tree``, through
    that checkout's own ``chip_smoke.bench_setup`` and package: one warm-up
    of ``warm_steps``, then ``runs`` timed runs of ``timed_steps`` (host
    clock up to a device sync), each printed as a JSON line, and the device
    launches of one hill step and of one plain step from the end state; the
    same for the 100k
    cell (360 warm-up steps, runs of 360).  Then the
    deposition the same way: ``runs`` timed runs of 256 ``add_value``
    rounds of 200 hills on that checkout's 1e6-point grid."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import importlib

    smoke = importlib.import_module("chip_smoke")
    from edm_tpu_torch.models.driver import pattern_segment

    _, state, steps = smoke.bench_setup(torch, 0.8, torch.device("cuda", 0))
    state, _ = pattern_segment(smoke.pattern(steps), warm_steps)(state)
    torch.cuda.synchronize()
    for _ in range(runs):
        t0 = time.perf_counter()
        state, _ = pattern_segment(smoke.pattern(steps), timed_steps)(state)
        torch.cuda.synchronize()
        print(json.dumps({"tree": tree, "steps_per_s": timed_steps / (time.perf_counter() - t0)}))
    # the device launches (kernels and copies) of one hill step and of one
    # plain step
    for key, step in (("hill_step_launches", steps[0]), ("plain_step_launches", steps[1])):
        _, _, _, n_launch = device_time_us(torch, lambda: step(state), 2)
        print(json.dumps({"tree": tree, key: n_launch}))
    # the 100k cell the same way: 360 warm-up steps, then runs of 360
    _, state, steps = smoke.bench_setup(torch, 0.8, torch.device("cuda", 0), n_atoms=BIG_N)
    state, _ = pattern_segment(smoke.pattern(steps), 360)(state)
    torch.cuda.synchronize()
    for _ in range(runs):
        t0 = time.perf_counter()
        state, _ = pattern_segment(smoke.pattern(steps), 360)(state)
        torch.cuda.synchronize()
        print(json.dumps({"tree": tree, "steps_per_s_100k": 360 / (time.perf_counter() - t0)}))
    del state, steps
    k4, _, c, h = smoke.deposit_grids(torch, torch.device("cuda", 0))
    for i in range(runs + 1):  # the first run warms up
        g = k4
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for k in range(256):
            g, _ = g.add_value(c + k * 1e-7, h)
        torch.cuda.synchronize()
        if i > 0:
            print(json.dumps({"tree": tree,
                              "hills_per_s": 200 * 256 / (time.perf_counter() - t0)}))


def time_threefry(torch, smoke, device, out, launches, rates):
    """The Threefry kernels' device time in the checkout of ``smoke`` (its
    ``coord_setup`` and ``pair_setup``): a launch of ``tf_bits`` in the 2-D
    heavy cell's stride cycle (after 20 steps) and the cycle's device
    launches a step; a step's two draws alone (20,000 normals, 10,000
    uniforms), all their device time and launches; ``tf_rows`` a launch in a
    blocked hill step (10,000 atoms, its 21 launches); the dense host's
    hill step (1,000 atoms), its two ``tf_bits`` launches (the thermostat's
    normals and the N^2 uniforms) and all its launches, and the N^2 draw
    alone, all its device time and launches.  Each host's steps/s at kT
    1.0 (2-D) or 0.8 over 100 steps (blocked 10) through
    ``driver.strided_segment``, host clock up to a device sync."""
    from edm_tpu_torch.models.driver import strided_segment
    from edm_tpu_torch.ops import prng

    def rate(name, steps, state, n):
        seg = strided_segment(steps[0], steps[1], 10, n)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seg(state)
        torch.cuda.synchronize()
        rates[name] = n / (time.perf_counter() - t0)

    f32 = torch.float32
    state, steps = smoke.coord_setup(torch, 1.0, device)
    state, _ = strided_segment(steps[0], steps[1], 10, 20)(state)
    rate("2-D steps/s", steps, state, 100)
    cycle = strided_segment(steps[0], steps[1], 10, 10)
    _, per, _, n = device_time_us(torch, lambda: cycle(state), 2)
    out["2-D tf_bits"] = funcs_ms(per, ("tf_bits",), 20)
    launches["2-D a step"] = n / 10
    key = prng.PRNGKey(1)
    us, _, _, n = device_time_us(torch, lambda: (
        prng.normal(key, (COORD_N, 2), f32, device), prng.uniform(key, (COORD_N,), f32, device)),
        20)
    out["2-D a step's draws, every launch"] = us / 1e3
    launches["2-D a step's draws"] = n
    del state, steps
    state, steps = smoke.pair_setup(torch, 0.8, device, "blocked")
    rate("blocked steps/s", steps, state, 10)
    _, per, _, _ = device_time_us(torch, lambda: steps[0](state), 1)
    out["blocked hill step tf_rows"] = funcs_ms(per, ("tf_rows",),
                                                PAIR_N["blocked"] // PAIR_BLOCK + 1)
    del state, steps
    state, steps = smoke.pair_setup(torch, 0.8, device, "dense")
    rate("dense steps/s", steps, strided_segment(steps[0], steps[1], 10, 20)(state)[0], 100)
    _, per, _, n = device_time_us(torch, lambda: steps[0](state), 5)
    out["dense hill step tf_bits"] = funcs_ms(per, ("tf_bits",), 2)
    launches["dense hill step"] = n
    d2 = PAIR_N["dense"] ** 2
    us, _, _, n = device_time_us(torch, lambda: prng.uniform(key, (d2,), f32, device), 10)
    out["dense N^2 draw, every launch"] = us / 1e3
    launches["dense N^2 draw"] = n


def time_kernels(torch, tree, group="all", warm_steps=200):
    """Device time per launch of every kernel entry of the checkout at
    ``tree``, through that checkout's own ``chip_smoke`` setups and
    package: per MD path, and for the exact and the typed path at 100k,
    the profile of a stride cycle after ``warm_steps`` (the exact path has
    left its full-cap fallback by then), of a deposition round on each
    route, and the Threefry kernels' (``time_threefry``); with ``group``
    "threefry" only the last, with "cells" only the 10k paths and the
    100k exact cell (the force kernels' forms of k <= 64).  Prints one
    JSON line."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    import importlib

    smoke = importlib.import_module("chip_smoke")
    from edm_tpu_torch.models.driver import pattern_segment

    device = torch.device("cuda", 0)
    out, launches, rates = {}, {}, {}
    if group in ("all", "cells"):
        runs = [(path, path, None) for path in smoke.PATHS]
        runs += [("100k", "interp", BIG_N)]
        if group == "all":
            runs += [("100k typed", "typed", BIG_N)]
        for label, path, n_atoms in runs:
            _, state, steps = smoke.bench_setup(torch, 0.8, device, path, n_atoms=n_atoms)
            state, _ = pattern_segment(smoke.pattern(steps), warm_steps)(state)
            _, _, ms = cycle_device_ms(torch, pattern_segment(smoke.pattern(steps), 10), state)
            out.update({f"{label} {name}": v for name, v in ms.items()})
            del state, steps
    if group == "all":
        k4, k5, c, h = smoke.deposit_grids(torch, device, carried=True)
        for what, gg in (("K4 round", k4), ("K5 round", k5)):
            _, per, _, _ = device_time_us(torch, lambda: gg.add_value(c, h), 20)
            out[what] = funcs_ms(per, DEPOSIT_FUNCS)
    if group != "cells":
        time_threefry(torch, smoke, device, out, launches, rates)
    print(json.dumps({"tree": tree, "device_ms": out, "launches": launches, "rates": rates}))


def ab_runs(flag, other, rounds=2, extra=()):
    """``python3 chip_smoke.py FLAG TREE [EXTRA]`` for another checkout (e.g.
    the parent commit, unpacked by ``git archive``) and this one in turns,
    one process each: other, this, this, other, ``rounds`` times.  Prints
    every run's JSON lines and returns them parsed, {tree: [line, ...]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    other = os.path.abspath(other)
    lines = {other: [], here: []}
    for tree in [other, here, here, other] * rounds:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), flag, tree, *extra],
                             capture_output=True, text=True, timeout=900, cwd=here)
        if out.returncode != 0:
            raise RuntimeError(f"{flag} {tree} failed:\n{out.stdout}\n{out.stderr}")
        for line in out.stdout.splitlines():
            if line.startswith('{"tree"'):
                print(line, flush=True)
                lines[tree].append(json.loads(line))
    return lines


def spread(vals) -> str:
    return (f"median {float(np.median(vals))!r} over {len(vals)} runs "
            f"(min {min(vals)!r}, max {max(vals)!r})")


def ab_slice(other):
    """``time_slice`` of both checkouts in turns; the median steps/s and
    hills/s of each."""
    for tree, runs in ab_runs("--time-slice", other).items():
        for key, unit in (("steps_per_s", "steps/s"), ("steps_per_s_100k", "steps/s, 100k cell"),
                          ("hills_per_s", "hills/s"),
                          ("hill_step_launches", "device launches of a 10k hill step"),
                          ("plain_step_launches", "device launches of a 10k plain step")):
            print(f"{tree}: {unit} {spread([r[key] for r in runs if key in r])}")


def ab_kernels(other, group="all"):
    """``time_kernels`` of both checkouts in turns; per entry the median
    device ms per launch of each, and the launch counts."""
    for tree, runs in ab_runs("--time-kernels", other, extra=(group,)).items():
        for key in runs[0]["device_ms"]:
            print(f"{tree}: {key}: device ms {spread([r['device_ms'][key] for r in runs])}")
        for key in runs[0]["launches"]:
            print(f"{tree}: {key}: device launches {spread([r['launches'][key] for r in runs])}")
        for key in runs[0]["rates"]:
            print(f"{tree}: {key} {spread([r['rates'][key] for r in runs])}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    modes = {"--time-slice": lambda tree: time_slice(torch, tree), "--ab-slice": ab_slice,
             "--time-kernels": lambda tree, group="all": time_kernels(torch, tree, group),
             "--ab-kernels": ab_kernels}
    if len(sys.argv) in (3, 4) and sys.argv[1] in modes:
        torch.backends.cuda.matmul.allow_tf32 = False
        print(f"card: {card_line()}")
        modes[sys.argv[1]](*sys.argv[2:])
        return 0
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from edm_tpu_torch import _build

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    _build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {_build.build_seconds:.2f} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip())
    if sys.argv[1:2] == ["--ranks"]:
        return ranks_main(torch, *sys.argv[2:])

    rows = {}
    for what, phase in (("K1/K2 Hermite", lambda: kernel_phase(torch, device, "interp")),
                        ("K1/K2 Chebyshev", lambda: kernel_phase(torch, device, "chebyshev")),
                        ("K6, typed K1, K7", lambda: legacy_kernel_phase(torch, device)),
                        ("K4/K5", lambda: deposit_kernel_phase(torch, device))):
        t_phase = time.perf_counter()
        rows.update(phase())
        print(f"kernel checks, {what}: {time.perf_counter() - t_phase:.1f} s")
    launches, device_ms = {}, {}
    for path in PATHS:
        t_phase = time.perf_counter()
        slice_zero_temperature(torch, device, path)
        run = slice_run(torch, device, path)
        launches[path], device_ms[path] = run["launches"], run["device_ms"]
        print(f"{path} slice: {time.perf_counter() - t_phase:.1f} s")
        if path == "interp":
            t_phase = time.perf_counter()
            rows.update(hash_kernel_phase(torch, device, run["state"], run["steps"]))
            print(f"kernel checks, counter hash and pass 1: {time.perf_counter() - t_phase:.1f} s")
            t_phase = time.perf_counter()
            gofr_phase(torch, device)
            print(f"10k g(r): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    big = big_cell_phase(torch, device)
    rows.update(big["rows"])
    launches["100k"], device_ms["100k"] = big["launches"], big["device_ms"]
    launches["100k typed"], device_ms["100k typed"] = big["typed_launches"], big["typed_device_ms"]
    print(f"100k exact cell: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    liquid = dense_liquid_phase(torch, device)
    rows.update(liquid["rows"])
    for run, res in liquid["runs"].items():
        launches[f"liquid {run}"], device_ms[f"liquid {run}"] = res["launches"], res["device_ms"]
    print(f"32k dense liquid: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    _, dep, dep_ms = deposition_run(torch, device)
    print(f"deposition: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows.update(threefry_kernel_phase(torch, device))
    coord_zero_temperature(torch, device)
    _, n_tf, tf_ms = coord_run(torch, device)
    print(f"2-D slice: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    coord_zero_temperature(torch, device, periodic=False)
    mcgdp_deposit_phase(torch, device)
    _, n_tf_m, _ = coord_run(torch, device, periodic=False)
    n_tf += n_tf_m
    print(f"McGDP slice: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows.update(threefry_rows_phase(torch, device))
    pair_zero_temperature(torch, device, "blocked")
    # the blocked host, the slowest path a step, runs 20 steps after 10, the
    # XLA pass 50 after 20 (the single-device others 300 after 100), to hold
    # the whole run near 600 s with the multi-device phases and the examples
    _, blk_launches, blk_ms = pair_run(torch, device, "blocked", warm_steps=10, timed_steps=20)
    print(f"blocked host: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    xla_zero_temperature(torch, device)
    slice_run(torch, device, "xla", warm_steps=20, timed_steps=50)
    print(f"xla slice: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    pair_zero_temperature(torch, device, "dense")
    _, dense_launches, _ = pair_run(torch, device, "dense")
    n_tf += blk_launches["threefry_bits"] + dense_launches["threefry_bits"]
    print(f"dense host: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    rows.update(brick_box_kernel_phase(torch, device))
    print(f"kernel checks, K1 brick row box: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    cheb_rows, cheb_box_ms = row_box_cheb_kernel_phase(torch, device)
    rows.update(cheb_rows)
    print(f"kernel checks, K1 row box with the Chebyshev table: "
          f"{time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    multi = multi_rank_phases()
    rows.update(multi[2]["rows"])
    n_tf += sum(r.get("threefry_bits", 0) for n in (2, 4) for r in multi[n]["runs"].values())
    print(f"multi-device phases: {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    from edm_tpu_torch.parallel.dryrun import dryrun_multichip

    dryrun_multichip(8, timeout=300)
    print(f"dry run (dryrun_multichip(8)): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    api_phase(torch, device)
    rs_launches = production_zero_temperature(torch, device)
    _, rs_launches_warm = production_run(torch, device)
    checkpoint_phase(torch, device)
    native_io_phase(torch, device)
    print(f"entry points (API, run_simulation, checkpoint, native I/O): "
          f"{time.perf_counter() - t_phase:.1f} s; K1 / K2 launches on the run_simulation path: "
          f"kT=0 {rs_launches['cell_force_newton']} / {rs_launches['overflow_force']}, kT=0.8 "
          f"{rs_launches_warm['cell_force_newton']} / {rs_launches_warm['overflow_force']}")

    t_phase = time.perf_counter()
    examples = examples_phase(torch, device)
    ranks = {n: multi[n]["examples"]["seconds"] for n in (2, 4, 8)}
    print(f"example scripts: {time.perf_counter() - t_phase:.1f} s in this process "
          f"({', '.join(f'{k} {v:.1f}' for k, v in examples['seconds'].items())}); on the "
          f"ranks (rank 0, s): {ranks}")

    cf = "edm_tpu_torch/csrc/cellforce.cu"
    dp = "edm_tpu_torch/csrc/deposit.cu"
    hr = "edm_tpu_torch/csrc/hashrng.cu"
    k1, k2, k6, k7 = FORCE_KERNELS
    entries = [  # name, source, the TPU kernel, (path, wrapper) or deposition route, rows' prefix
        ("cell_force_newton", cf, "cellforce_pallas.py:684", ("interp", k1),
         "cell_force_newton hermite"),
        ("overflow_force", cf, "cellforce_pallas.py:870", ("interp", k2), "overflow_force hermite"),
        # the same two on the 100k exact cell
        ("cell_force_newton[100k]", cf, "cellforce_pallas.py:684", ("100k", k1),
         "cell_force_newton[100k]"),
        ("overflow_force[100k]", cf, "cellforce_pallas.py:870", ("100k", k2),
         "overflow_force[100k]"),
        ("cell_force_newton[chebyshev]", cf, "cellforce_pallas.py:67", ("chebyshev", k1),
         "cell_force_newton cheb"),
        ("overflow_force[chebyshev]", cf, "cellforce_pallas.py:67", ("chebyshev", k2),
         "overflow_force cheb"),
        ("deposit_windowed_1d", dp, "deposit_pallas.py:138", "K4", "deposit_windowed_1d"),
        ("deposit_dense_1d_kernel", dp, "deposit_pallas.py:236", "K5", "deposit_dense_1d_kernel"),
        ("cell_force_newton_planar", cf, "cellforce_pallas.py:933", ("newton", k6),
         "cell_force_newton_planar"),
        ("cell_force_full", cf, "cellforce_pallas.py:1002", ("full", k7), "cell_force_full"),
        ("cell_force_newton[typed]", cf, "cellforce_pallas.py:291", ("typed", k1),
         "cell_force_newton[typed]"),
        # K1's owned-row form (row_box), the slab host's force pass
        ("cell_force_newton[row_box]", cf, "cellforce_pallas.py:684", "slab",
         "cell_force_newton[row_box]"),
        # the same over a brick box (rows remapped on all three axes), the
        # brick host's force pass
        ("cell_force_newton[brick row_box]", cf, "cellforce_pallas.py:684", "brick",
         "cell_force_newton[brick row_box]"),
        # the owned-row form with the Chebyshev table (K3), the weak-scaling
        # example's slab ranks
        ("cell_force_newton[row_box cheb]", cf, "cellforce_pallas.py:67", "examples",
         "cell_force_newton[row_box cheb]"),
        # no Pallas kernel: the jax.random Threefry draws that XLA computes
        ("threefry_bits", "edm_tpu_torch/csrc/threefry.cu", "../models/langevin.py:51",
         "2-D", "threefry_bits"),
        # no Pallas kernel: the per-row fold_in + uniform draws XLA computes
        ("threefry_rows", "edm_tpu_torch/csrc/threefry.cu", "../models/pair_edm_blocked.py:115",
         "blocked", "threefry_rows"),
        # no Pallas kernel: the counter hash and pass 1 of the hill
        # collections, which XLA fuses
        ("hash_rows[uniform]", hr, "hashrng.py:53", ("interp", "uniform_rows_cols"),
         "uniform_rows_cols pass 2"),
        ("hash_rows[normal]", hr, "hashrng.py:33", ("interp", "normal_rows_cols"),
         "normal_rows_cols thermostat"),
        ("p1_count_half", hr, "../models/pair_edm_cells.py:1886", ("interp", "p1_counts_half"),
         "p1_counts_half "),
        ("p1_count_typed", hr, "../models/pair_edm_cells.py:2073", ("typed", "p1_counts_typed"),
         "p1_counts_typed "),
        ("hash_rows[uniform][100k]", hr, "hashrng.py:53", ("100k", "uniform_rows_cols"),
         "uniform_rows_cols[100k]"),
        ("hash_rows[normal][100k]", hr, "hashrng.py:33", ("100k", "normal_rows_cols"),
         "normal_rows_cols[100k]"),
        ("p1_count_half[100k]", hr, "../models/pair_edm_cells.py:1886",
         ("100k", "p1_counts_half"), "p1_counts_half[100k]"),
        ("p1_count_typed[100k]", hr, "../models/pair_edm_cells.py:2073",
         ("100k typed", "p1_counts_typed"), "p1_counts_typed[100k]"),
        # the dense 32k liquid at cap 96: K1 at full cap (the pieces form),
        # K2 with 384 tail rows (the rows in tiles), and both with the
        # 16-panel Chebyshev table
        ("cell_force_newton[cap 96]", cf, "cellforce_pallas.py:684", ("liquid a", k1),
         "cell_force_newton[cap 96]"),
        ("overflow_force[384 tail rows]", cf, "cellforce_pallas.py:870", ("liquid b", k2),
         "overflow_force[384 tail rows]"),
        ("cell_force_newton[cheb 16x16]", cf, "cellforce_pallas.py:67", ("liquid c", k1),
         "cell_force_newton[cheb 16x16]"),
        ("overflow_force[cheb 16x16]", cf, "cellforce_pallas.py:67", ("liquid c", k2),
         "overflow_force[cheb 16x16]"),
    ]
    records = []
    for name, source, replaces, where, prefix in entries:
        if isinstance(where, tuple):
            path, wrapper = where
            n, dev = launches[path][wrapper], device_ms[path].get(wrapper)
        elif where == "2-D":
            n, dev = n_tf, tf_ms
        elif where == "blocked":
            n, dev = blk_launches["threefry_rows"], blk_ms["threefry_rows"]
        elif where in ("slab", "brick"):
            run = multi[2]["runs"]["slab"] if where == "slab" else multi[4]["runs"]["brick 2x2"]
            n, dev = run["launches"]["row_box"], run["device_ms"].get("cell_force_newton")
        elif where == "examples":
            n, dev = multi[2]["examples"]["launches"]["weak scaling"]["row_box"], cheb_box_ms
        else:
            n, dev = dep[prefix], dep_ms[where]
        records.append(kernel_entry(name, source, os.path.normpath("edm_tpu/ops/" + replaces),
                                    n, dev, rows, prefix))
    print(json.dumps({"kernels": records}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
