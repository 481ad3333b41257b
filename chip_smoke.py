"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path — the 10,000-atom pairwise-EDM cell-list MD
step of ``bench.py:bench_pairwise`` (well-tempered, RDF-targeted bias on a
151-point grid, exact Hermite lookup, kernel_cap 24, overflow_cap 32,
energy stride 10, the hills / 8 plain / rebuild stride cycle) — through
its two CUDA kernels, and checks it against the kernels' plain PyTorch
versions on the same card:

  1. the card (nvidia-smi name and power limit) and the software versions;
  2. the kernel build from ``edm_tpu_torch/csrc`` (nvcc, sm_90a);
  3. each kernel against its plain version on the 10k bench state's
     inputs: K1 at k = 24 and 32, energy on and off, and K2;
  4. the slice: 20 steps at kT = 0 through the kernels, step for step
     against the same run through the plain versions; then the bench's
     kT = 0.8 run with the launch counters reset, its rate, host syncs
     and end-state checks.

Usage: ``python3 chip_smoke.py`` from the repository root (one GPU).  The
last line is ``{"ok": true, "device": {...}}``; any failed check raises,
and the script exits non-zero without that line.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

N_ATOMS = 10000  # the bench's 10k cell
FORCE_REL = 2e-5  # kernel vs plain: |df| <= 2e-5 * max(1, max|f|)
ENERGY_RTOL = 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def bench_setup(torch, kT: float, device):
    """The bench_pairwise configuration, built through the port's entry
    points: bias.subdivide -> pair_edm.init_state -> CellSpec.create ->
    init_cell_state, and the three static phase steps."""
    from edm_tpu_torch import bias as B
    from edm_tpu_torch.grid import Grid, GridSpec
    from edm_tpu_torch.models import pair_edm
    from edm_tpu_torch.models.cells import CellSpec
    from edm_tpu_torch.models.langevin import LangevinParams
    from edm_tpu_torch.models.lj import LJParams
    from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
    from edm_tpu_torch.ops.prng import PRNGKey
    from edm_tpu_torch.utils.config import parse_edm_text

    cfg = parse_edm_text(
        "tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
        "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\n"
        "bias_spacing 0.02\nbias_sigma 0.1\n"
    )
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    r_pts = np.arange(tspec.nbins[0]) * tspec.dx[0] + tspec.min[0]
    target = Grid(values=torch.tensor(-2.0 * np.log(np.maximum(r_pts, 0.5)),
                                      dtype=torch.float32, device=device),
                  derivs=None, spec=tspec, interpolate=False)
    params, bias_state = B.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False],
                                     [0], dtype=torch.float32, device=device,
                                     target=target)
    side = int(np.ceil(N_ATOMS ** (1 / 3)))
    a = 1.26
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
           .reshape(-1, 3)[:N_ATOMS] * a + 0.5 * a)
    box = [side * a] * 3
    lp = LangevinParams(dt=0.002, friction=1.0, kT=kT)
    lj = LJParams(epsilon=1.0, sigma=1.0, rcut=2.5)
    core = pair_edm.init_state(bias_state, torch.tensor(pts, dtype=torch.float32,
                                                        device=device),
                               PRNGKey(0), n_est=N_ATOMS * 40)
    spec = CellSpec.create(box, cutoff=3.05, n_atoms=N_ATOMS)
    state = init_cell_state(spec, core, kernel_cap=24, overflow_cap=32)
    kw = dict(hill_capacity=2048, energy_stride=10, kernel_cap=24, overflow_cap=32)
    steps = [
        make_cell_step(params, lp, lj, spec, static_do_hills=h, static_do_energy=e,
                       static_do_rebuild=r, **kw)
        for h, e, r in ((True, True, False), (False, False, False), (False, False, True))
    ]
    return spec, state, steps


def pattern(steps):
    return [(steps[0], 1), (steps[1], 8), (steps[2], 1)]


@contextlib.contextmanager
def plain_versions():
    """Route the host's force pass through the kernels' plain versions."""
    from edm_tpu_torch.models import pair_edm_cells as PC
    from edm_tpu_torch.ops import cellforce as CF

    saved = PC.cell_force_newton, PC.overflow_force
    PC.cell_force_newton, PC.overflow_force = CF.cell_force_newton_ref, CF.overflow_force_ref
    try:
        yield
    finally:
        PC.cell_force_newton, PC.overflow_force = saved


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


def kernel_phase(torch, device):
    """Phase 3: K1/K2 against their plain versions on the 10k bench state."""
    from edm_tpu_torch.ops import cellforce as CF

    spec, state, steps = bench_setup(torch, 0.8, device)
    step = steps[0]
    # a state with real forces and a live bias table: one hill step
    state, _ = step(state)
    tbl = CF.hermite_pair_table(state.core.bias.bias)
    xs, mc = state.xs, state.mc
    rows = {}
    k1_err = 0.0
    for k in (24, 32):
        for energy in (False, True):
            kw = dict(k=k, ncells=spec.ncells, box=spec.box, lj=step.lj, energy=energy)
            f, eb = CF.cell_force_newton(xs, mc, tbl, **kw)
            f_ref, eb_ref = CF.cell_force_newton_ref(xs, mc, tbl, **kw)
            torch.cuda.synchronize()
            err = check_forces(f"K1 k={k} energy={energy}", f, f_ref)
            check_energy(f"K1 k={k} energy={energy}", eb.sum(), eb_ref.sum())
            k1_err = max(k1_err, err)
            ms = cuda_ms(torch, lambda: CF.cell_force_newton(xs, mc, tbl, **kw))
            plain = cuda_ms(torch, lambda: CF.cell_force_newton_ref(xs, mc, tbl, **kw), reps=10)
            rows[f"cell_force_newton k={k} energy={int(energy)}"] = (err, ms, plain)
    xo, xp = step._overflow_inputs(state, xs)
    n_tail = int((xo[3] > 0.5).sum())
    if n_tail == 0:
        raise AssertionError("K2 check needs a real tail: the bench state has none")
    k2_err = 0.0
    for energy in (False, True):
        kw = dict(box=spec.box, lj=step.lj, energy=energy)
        fo, fp = CF.overflow_force(xo, xp, tbl, **kw)
        fo_ref, fp_ref = CF.overflow_force_ref(xo, xp, tbl, **kw)
        torch.cuda.synchronize()
        err = max(check_forces(f"K2 fo energy={energy}", fo[:3], fo_ref[:3]),
                  check_forces(f"K2 fp energy={energy}", fp, fp_ref))
        check_energy(f"K2 energy={energy}", fo[3].sum(), fo_ref[3].sum())
        k2_err = max(k2_err, err)
        ms = cuda_ms(torch, lambda: CF.overflow_force(xo, xp, tbl, **kw))
        plain = cuda_ms(torch, lambda: CF.overflow_force_ref(xo, xp, tbl, **kw), reps=10)
        rows[f"overflow_force tail={n_tail} energy={int(energy)}"] = (err, ms, plain)
    print("kernel vs plain version (CUDA events, ms per call):")
    for name, (err, ms, plain) in rows.items():
        print(f"  {name:40s} max_abs_err {err:.3e}  kernel {ms:.4f} ms  plain {plain:.4f} ms")
    return rows, k1_err, k2_err


def states_match(ks, ps, i):
    """Step-for-step check of a kernel-run state against the plain run."""
    for name in ("aid", "ovl", "tail_count", "tail_ovf", "tail_fallbacks", "table_overflow"):
        a, b = getattr(ks, name), getattr(ps, name)
        if not bool((a == b).all()):
            raise AssertionError(f"step {i}: {name} differs from the plain run")
    for name in ("step", "last_calls", "hills_truncated"):
        if not bool((getattr(ks.core, name) == getattr(ps.core, name)).all()):
            raise AssertionError(f"step {i}: core.{name} differs from the plain run")
    if ks.tail_ovf_host != ps.tail_ovf_host:
        raise AssertionError(f"step {i}: tail_ovf_host differs")
    for name in ("xs", "vs", "fs"):
        check_forces(f"step {i} {name}", getattr(ks, name), getattr(ps, name))
    check_energy(f"step {i} energy", ks.core.energy, ps.core.energy)
    kb, pb = ks.core.bias, ps.core.bias
    if not abs(float(kb.cum_bias) - float(pb.cum_bias)) <= 1e-6 * abs(float(pb.cum_bias)):
        raise AssertionError(f"step {i}: cum_bias {float(kb.cum_bias)} vs {float(pb.cum_bias)}")
    gv, pv = kb.bias.grid.values, pb.bias.grid.values
    if not max_err(gv, pv) <= 1e-5 * max(1.0, float(pv.abs().max())):
        raise AssertionError(f"step {i}: bias grid differs from the plain run")


def slice_zero_temperature(torch, device, n_steps=20):
    """Phase 4a: 20 steps at kT = 0 through the kernels; each step is also
    taken through the plain versions from the same input state and the two
    results are held to each other.  (Two free-running f32 trajectories
    part after ~15 steps at 10k atoms: a 1-ulp position difference can move
    a pair distance across a Hermite table node, where the derivative
    jumps by ~1e-4.)"""
    _, state, steps = bench_setup(torch, 0.0, device)
    for i in range(n_steps):
        step = steps[0 if i % 10 == 0 else 2 if i % 10 == 9 else 1]
        with plain_versions():
            plain, _ = step(state)
        state, _ = step(state)
        states_match(state, plain, i)
    print(f"kT=0: {n_steps} steps through the kernels match the plain versions "
          "step for step (same input state each step)")


def sync_census(torch, steps, state):
    """One stride cycle under PyTorch's CUDA sync-debug mode: the number of
    operations that synchronized the host with the device, per phase
    (explicit flag reads and any implicit ones)."""
    import warnings

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


def slice_run(torch, device, warm_steps=100, timed_steps=300):
    """Phase 4b: the bench's kT = 0.8 run through the kernels."""
    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.ops import cellforce as CF

    spec, state, steps = bench_setup(torch, 0.8, device)
    CF.cell_force_newton.launches = 0
    CF.overflow_force.launches = 0
    for s in steps:
        s.host_syncs = 0
    state, e_warm = pattern_segment(pattern(steps), warm_steps)(state)
    torch.cuda.synchronize()
    syncs0 = sum(s.host_syncs for s in steps)
    t0 = time.perf_counter()
    state, e = pattern_segment(pattern(steps), timed_steps)(state)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"cell_force_newton": CF.cell_force_newton.launches,
                "overflow_force": CF.overflow_force.launches}
    syncs = sum(s.host_syncs for s in steps) - syncs0
    state, census = sync_census(torch, steps, state)
    core = state.core
    finite = all(bool(torch.isfinite(t).all()) for t in (state.xs, state.vs, state.fs, e))
    checks = {
        "finite": finite,
        "no table_overflow": not bool(state.table_overflow),
        "no hills_truncated": not bool(core.hills_truncated),
        "cum_bias > 0": float(core.bias.cum_bias) > 0,
        "K1 launched": launches["cell_force_newton"] > 0,
        "K2 launched": launches["overflow_force"] > 0,
        "no sync on plain steps": census["plain"] == 0,
    }
    print(f"host syncs in one stride cycle (CUDA sync-debug mode): {census}")
    print(f"kT=0.8: {timed_steps} steps after {warm_steps} warm-up: "
          f"{timed_steps / dt:.2f} steps/s, {syncs / (timed_steps / 10):.2f} host syncs "
          f"per stride cycle, launches {launches}, tail {int(state.tail_count)} "
          f"(fallback periods {int(state.tail_fallbacks)}), cum_bias "
          f"{float(core.bias.cum_bias):.6g}, last energy {float(e[-1]):.6g}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kT=0.8 run failed: {failed}")
    return timed_steps / dt, launches, syncs / (timed_steps / 10)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
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

    rows, k1_err, k2_err = kernel_phase(torch, device)
    slice_zero_temperature(torch, device)
    rate, launches, syncs = slice_run(torch, device)

    k1 = rows["cell_force_newton k=24 energy=0"]
    k2 = [v for k, v in rows.items() if k.startswith("overflow_force") and k.endswith("=0")][0]
    print(json.dumps({"kernels": [
        {"name": "cell_force_newton", "route": "cuda",
         "source": "edm_tpu_torch/csrc/cellforce.cu",
         "replaces": "edm_tpu/ops/cellforce_pallas.py:684",
         "launches": launches["cell_force_newton"], "max_abs_err": k1_err,
         "ms": k1[1], "plain_ms": k1[2]},
        {"name": "overflow_force", "route": "cuda",
         "source": "edm_tpu_torch/csrc/cellforce.cu",
         "replaces": "edm_tpu/ops/cellforce_pallas.py:870",
         "launches": launches["overflow_force"], "max_abs_err": k2_err,
         "ms": k2[1], "plain_ms": k2[2]},
    ]}))
    print(f"card: {card_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
