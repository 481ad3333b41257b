#!/usr/bin/env python3
"""The benchmark of ``edm_tpu_torch`` on one card or several.

    python3 edmbench/run.py --workload inlj.4m --seed 7 --seconds 10 --trace 0

From the root of a checkout: reads ``BENCHMARK.json``, builds the cell's
configuration (``edmbench/configs/<config>.json``) at its mix's size
(``edmbench/mixes/<traffic>.json``) through the configuration's kind
(``edmbench/kinds/<kind>``: the system it runs, its stride cycle, its
checks and its work count), warms up whole stride cycles, then drives
``pattern_segment`` over one stride cycle at a time for ``--seconds``, a
CUDA event after each.  ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer ones (``edmbench/metrics/<name>.py``,
from the same window under ``torch.profiler`` with a span around each
phase step).  Either run then judges one stride cycle of the window
against the kind's plain reference (``check.py``) and prints one JSON line
last on standard output.

A mix with ``ranks`` above 1 runs a sharded host (the kind's
``make_mesh``) in that many ranks of ``parallel.launch``, a card each over
NCCL: the library is built here first, every rank builds the same
replicated state and warms up, rank 0 fixes the window's cycle count from
the warm-up's pace and broadcasts it, and every rank runs that many
cycles.  Rank 0's window gives the metrics and its profile the per-layer
ones; the kept steps are rank 0's, judged a step a rank.

Exits non-zero with no result without enough CUDA cards, without the
port, or when JAX or the JAX package is loaded once the window has
closed, here or in a rank.  Build and kernel caches stay inside the
checkout."""

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, ".bench_cache")  # every build and kernel cache
FORBIDDEN = ("jax", "jaxlib", "flax", "edm_tpu")  # top-level module names


def load(path):
    with open(path) as f:
        return json.load(f)


def cell_of(bench: dict, name: str):
    """(workload, configuration, mix) of the cell ``name``."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    cfg = load(os.path.join(ROOT, conf["file"]))
    mix = load(os.path.join(HERE, "mixes", wl["traffic"] + ".json"))
    return wl, cfg, mix


def metrics_for(bench: dict, kind: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that cell ``cell``
    reports."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def set_cache_env():
    """Fixed cache directories inside the checkout, whatever the caller set."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def checked_steps(pattern, seed: int, n_cycles: int) -> tuple:
    """The steps that the check judges, drawn from the seed: ({position in
    the stride cycle: phase}, one step of each phase of ``pattern``, the
    position of a phase of more than one step drawn in the pattern's
    order; the cycle of the window's first ``n_cycles`` they are kept
    from)."""
    import numpy as np

    rng = np.random.default_rng(abs(int(seed)))
    keep, pos = {}, 0
    for phase, n in pattern:
        keep[pos if n == 1 else int(rng.integers(pos, pos + n))] = phase
        pos += n
    return keep, int(rng.integers(0, n_cycles))


def wrap_steps(steps: dict, call) -> dict:
    """The phase steps, each called through ``call(phase, step, state)``
    (the benchmark's spans and its capture of the checked cycle); the
    wrappers keep each step's ``check_phase``."""
    def wrapped(phase, step):
        def fn(state, _=None):
            return call(phase, step, state)
        if hasattr(step, "check_phase"):
            fn.check_phase = step.check_phase
        return fn
    return {p: wrapped(p, s) for p, s in steps.items()}


def run_cell(cell: str, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", fault=None, control_dtype=None, mesh=None,
             t_start: float = None) -> dict:
    """Set up, warm up, run the window, judge the checked cycle, all
    through the configuration's kind (``edmbench/kinds``).  Returns
    {"setup_s", "window_s", "cycles", "cycle_ms", "memory_peak_bytes",
    "record", "checks", "reference_s", "notes"}.
    ``fault(phase, state_in, (state_out, y)) -> (state_out, y)``, for the
    harness's own tests, breaks every step of the window underneath;
    ``control_dtype`` also judges the control (the reference in that
    precision in the program's place) under ``"control"``
    (``control.py``).

    With ``mesh`` (this rank's, in ``rank_main``) the window runs the
    cycle count that rank 0 broadcasts, and the result has the judged
    numbers of this rank's share of the kept steps under ``"values"``
    instead of ``"checks"``, and ``"rank_differs"``: 1 where the final
    state differs bitwise from rank 0's.  ``setup_s`` counts from
    ``t_start`` (default: this module's import).

    A configuration with ``"port_trace": true`` also turns the port's own
    spans and counters on in a traced run (``edm_tpu_torch.utils.trace``):
    on before the warm-up, reset after it, and their report under
    ``record["port"]`` once the profiler has closed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from edm_tpu_torch.models.driver import pattern_segment
    from edm_tpu_torch.utils import trace as port_trace

    from edmbench import check, kinds, peaks, trace as T

    K = kinds.load(cfg)
    lim = check.limits(cfg["name"])
    if set(lim) != set(K.NUMBERS):
        raise ValueError(f"limits/{cfg['name']}.json holds {sorted(lim)}, its kind's NUMBERS "
                         f"{sorted(K.NUMBERS)}")
    cycle = sum(n for _, n in K.PATTERN)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    sysm = K.build(cfg, mix, seed, device, mesh)
    port = trace and bool(cfg.get("port_trace"))
    if port:
        port_trace.enable()
    if mesh is None:
        keep, check_cycle = checked_steps(K.PATTERN, seed, max(1, int(2 * seconds)))

    state = sysm.state
    seg_raw = pattern_segment([(sysm.steps[p], n) for p, n in K.PATTERN], cycle)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    n_cycles = None  # one card: cycles until ``seconds`` have passed
    if mesh is None:
        for _ in range(int(mix["warmup_cycles"])):
            state, _ = seg_raw(state)
        sync()
    else:
        state, n_cycles = warm_up_ranks(seg_raw, state, int(mix["warmup_cycles"]), seconds,
                                        mesh, sync)
        keep, check_cycle = checked_steps(K.PATTERN, seed, n_cycles)
    if port:
        port_trace.reset()

    taken, spans = {}, {p: [] for p, _ in K.PATTERN}
    pos, capture = [0], [False]

    def call(phase, step, st):
        p = pos[0]
        pos[0] += 1
        if trace:
            with record_function(T.SPAN + phase):
                t = time.perf_counter()
                out = step(st)
                spans[phase].append(time.perf_counter() - t)
        else:
            out = step(st)
        if fault is not None:
            out = fault(phase, st, out)
        if capture[0] and p in keep:
            taken[p] = (keep[p], st, out[0])
        return out

    wrapped = wrap_steps(sysm.steps, call)
    seg_wrap = pattern_segment([(wrapped[p], n) for p, n in K.PATTERN], cycle)
    sysm.state = state
    counters0 = K.counters(sysm)
    gc.collect()
    gc.freeze()  # set-up's objects stay out of the window's full collections
    prof = None
    if trace:
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof = profile(activities=acts)
        prof.__enter__()
    window_span = record_function(T.WINDOW) if trace else None
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - (T0 if t_start is None else t_start)
    if window_span is not None:
        window_span.__enter__()
    marks = []

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    mark()
    cycles = 0
    while True:
        if trace or fault is not None or cycles == check_cycle:
            pos[0], capture[0] = 0, cycles == check_cycle
            state, _ = seg_wrap(state)
            capture[0] = False
        else:
            state, _ = seg_raw(state)
        mark()
        cycles += 1
        if n_cycles is None:
            if cycles > check_cycle and time.perf_counter() - t0 >= seconds:
                break
        elif cycles == n_cycles:
            break
    sync()
    t1 = time.perf_counter()
    gc.unfreeze()
    if window_span is not None:
        window_span.__exit__(None, None, None)
    if prof is not None:
        prof.__exit__(None, None, None)
    if on_card:
        cycle_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
        peak = torch.cuda.max_memory_allocated()
    else:
        cycle_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
        peak = 0
    if port:
        record_port = port_trace.report()
        port_trace.enable(False)
    sysm.state = state
    c1 = K.counters(sysm)
    out = dict(setup_s=setup_s, window_s=t1 - t0, cycles=cycles, cycle_ms=cycle_ms,
               memory_peak_bytes=peak)
    record = dict(cycles=cycles, steps=cycles * cycle, window_s=t1 - t0, spans=spans,
                  ranks=1 if mesh is None else mesh.size)
    record.update({k: v - counters0.get(k, 0) for k, v in c1.items()})
    if port:
        record["port"] = record_port
    geom = K.geometry(sysm)
    steps = [(phase, K.snapshot(a), K.snapshot(b)) for _, (phase, a, b) in sorted(taken.items())]
    mine = steps
    if mesh is not None:
        out["rank_differs"] = differs_from_rank0(K.replicated(state), mesh)
        share_rank0(steps, mesh)
        mine = steps[mesh.rank::mesh.size]
    del state, sysm, seg_raw, seg_wrap, wrapped, taken, marks
    if trace:
        record["trace"] = T.reduce(prof) if on_card else None
        del prof
        plain = next((s1 for phase, _, s1 in steps if phase == "plain"), None)
        w = None if plain is None else K.work(cfg, plain, geom)
        if w is not None:
            w["least_s"] = peaks.least_seconds(w)
        record["work"] = w
    del steps
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    values, out["notes"] = K.judge(cfg, geom, mine)
    out["reference_s"] = time.perf_counter() - t_ref
    if mesh is None:
        out["checks"] = check.verdict(values, lim)
    else:
        out["values"] = values
    if control_dtype is not None:
        out["control"] = K.judge(cfg, geom, mine, control_dtype)[0]
    out["record"] = record
    if mesh is not None:
        wait_for_ranks(mesh)
    return out


def warm_up_ranks(seg, state, warmup: int, seconds: float, mesh, sync):
    """``warmup`` stride cycles on every rank; rank 0 times the later half
    and fixes the window's cycle count (enough for ``seconds`` at that
    pace), broadcast once: every rank runs the same count, or a psum would
    wait for ever.  Returns (state, cycle count)."""
    import torch
    import torch.distributed as dist

    half = warmup // 2
    for i in range(warmup):
        if i == half:
            sync()
            t = time.perf_counter()
        state, _ = seg(state)
    sync()
    pace = (time.perf_counter() - t) / (warmup - half)
    n = torch.tensor([max(1, math.ceil(seconds / pace))], dtype=torch.int64, device=mesh.device)
    dist.broadcast(n, src=0, group=mesh.group)
    return state, int(n.item())  # the read waits for every rank to reach the broadcast


def _bits(t):
    """``t`` flat and contiguous, as integers of its width (a bitwise view)."""
    import torch

    width = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}
    return t.contiguous().reshape(-1).view(width[t.element_size()])


def differs_from_rank0(leaves, mesh) -> int:
    """1 where any of this rank's ``leaves`` differs bitwise from rank 0's
    (each broadcast from rank 0 once the window has closed), else 0."""
    import torch
    import torch.distributed as dist

    differ = False
    for t in leaves:
        mine = _bits(t)
        theirs = mine.clone()
        dist.broadcast(theirs, src=0, group=mesh.group)
        differ |= not torch.equal(mine, theirs)
    return int(differ)


def share_rank0(steps, mesh):
    """Overwrite every rank's snapshots of the kept steps with rank 0's
    (broadcast leaf by leaf), so that each rank can judge its share of
    rank 0's steps."""
    import numpy as np
    import torch
    import torch.distributed as dist

    for _, s0, s1 in steps:
        for snap in (s0, s1):
            for k, v in snap.items():
                if isinstance(v, np.ndarray):
                    t = torch.as_tensor(v.astype(np.int64), device=mesh.device)
                    dist.broadcast(t, src=0, group=mesh.group)
                    snap[k] = t.cpu().numpy().astype(v.dtype)
                elif torch.is_tensor(v):  # received in place: the states are done with
                    t = v.to(mesh.device).contiguous()
                    dist.broadcast(_bits(t), src=0, group=mesh.group)
                    snap[k] = t.to(v.device)


def wait_for_ranks(mesh):
    """One small collective that every rank enters once its share is
    judged, so that the ranks leave their process group together."""
    import torch
    import torch.distributed as dist

    one = torch.ones(1, device=mesh.device)
    dist.all_reduce(one, group=mesh.group)
    one.item()


def rank_main(cell, cfg, mix, seed, seconds, trace, fault, fault_ranks, control_dtype,
              t_start):
    """A rank of ``run_ranks``: this rank's mesh of the mix's host, then
    ``run_cell`` on it (traced on rank 0 only; ``fault`` on the ranks in
    ``fault_ranks``).  Adds the modules of JAX or the JAX package loaded
    here and the card's name."""
    import torch

    from edmbench import kinds

    mesh = kinds.load(cfg).make_mesh(mix)
    res = run_cell(cell, cfg, mix, seed, seconds, trace and mesh.rank == 0, device=mesh.device,
                   fault=fault if mesh.rank in fault_ranks else None,
                   control_dtype=control_dtype, mesh=mesh, t_start=t_start)
    res["forbidden"] = loaded_forbidden()
    res["card"] = (torch.cuda.get_device_name(mesh.device) if mesh.device.type == "cuda"
                   else "cpu")
    return res


def run_ranks(cell: str, cfg: dict, mix: dict, seed: int, seconds: float, trace: bool,
              device: str = "cuda", fault=None, fault_ranks=None, control_dtype=None,
              backend=None) -> dict:
    """``run_cell`` of a sharded host in ``mix["ranks"]`` ranks
    (``parallel.launch``; NCCL with a card a rank, or ``backend``), the
    library built here first.  Returns rank 0's result with the largest
    peak memory of the ranks, the checks over every rank's share of the
    kept steps plus ``rank_mismatch`` (the ranks whose final state differs
    bitwise from rank 0's), the notes summed over the ranks,
    ``rank_cycles``, ``forbidden`` (what any rank loaded of JAX) and
    ``card`` (rank 0's card's name).  ``fault`` breaks the
    window's steps on the ranks in ``fault_ranks`` (default: all)."""
    import tempfile

    from edm_tpu_torch.parallel import launch

    from edmbench import check

    n = int(mix["ranks"])
    if device == "cuda":
        from edm_tpu_torch import _build

        _build.load_library()  # once, before the ranks start: they load it and never build
    fault_ranks = tuple(range(n) if fault_ranks is None else fault_ranks)
    with tempfile.TemporaryDirectory() as d:
        parts = launch(rank_main, n, cell, cfg, mix, seed, seconds, trace, fault, fault_ranks,
                       control_dtype, T0, backend=backend, device=device,
                       init_file=os.path.join(d, "store"), timeout=300.0)
    values = check.worst_of(p.pop("values") for p in parts)
    values["rank_mismatch"] = float(sum(p.pop("rank_differs") for p in parts))
    out = dict(parts[0])
    out.update(memory_peak_bytes=max(p["memory_peak_bytes"] for p in parts),
               notes={k: sum(p["notes"][k] for p in parts) for k in parts[0]["notes"]},
               reference_s=max(p["reference_s"] for p in parts),
               rank_cycles=[p["cycles"] for p in parts],
               forbidden=sorted({m for p in parts for m in p["forbidden"]}),
               checks=check.verdict(values, check.limits(cfg["name"])))
    if control_dtype is not None:
        out["control"] = check.worst_of(p["control"] for p in parts)
    return out


def percentile(xs, q):
    import numpy as np
    return float(np.percentile(np.asarray(xs, dtype=float), q))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_env()
    bench = load(os.path.join(ROOT, "BENCHMARK.json"))
    wl, cfg, mix = cell_of(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"edmbench: {args.workload} needs {wl['chips']} CUDA card(s), found {n}",
              file=sys.stderr)
        return 2
    ranks = int(mix.get("ranks", 1))
    if ranks > wl["chips"]:
        print(f"edmbench: {args.workload}'s mix has {ranks} ranks for {wl['chips']} card(s)",
              file=sys.stderr)
        return 2
    if ranks > 1:
        res = run_ranks(args.workload, cfg, mix, args.seed, args.seconds, bool(args.trace))
        card = res["card"]
    else:
        res = run_cell(args.workload, cfg, mix, args.seed, args.seconds, bool(args.trace))
        card = torch.cuda.get_device_name(0)
    correct, failed, rows = res["checks"]
    device = dict(platform="gpu", kind=card, count=wl["chips"],
                  memory_peak_bytes=int(res["memory_peak_bytes"]))
    result = dict(correct=correct, attempted=len(rows), failed=len(failed))
    if not args.trace:
        e2e = dict(steps_per_s=res["record"]["steps"] / res["window_s"],
                   cycle_p95_ms=percentile(res["cycle_ms"], 95), setup_s=res["setup_s"])
        result["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                             for m in metrics_for(bench, "end_to_end", args.workload)}
    else:
        rec = res["record"]
        tr = rec["trace"]
        device.update(busy_s=tr["busy_ns"] / 1e9, window_s=tr["window_ns"] / 1e9)
        vals = {}
        for m in metrics_for(bench, "per_layer", args.workload):
            v = importlib.import_module(f"edmbench.metrics.{m['name']}").read(rec)
            if v is not None:
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = vals
        result["breakdown"] = dict(device_ops=tr["device_ops"], idle_gaps=tr["idle_gaps"])
    result["device"] = device
    bad = loaded_forbidden()
    if bad or res.get("forbidden"):
        print(f"edmbench: forbidden modules loaded in the benchmark's process: {bad}, in its "
              f"ranks: {res.get('forbidden', [])}", file=sys.stderr)
        return 3
    cms = sorted(res["cycle_ms"])
    print(f"edmbench: cycle ms median {percentile(cms, 50)!r}, max {cms[-1]!r}, over twice "
          f"the median {sum(c > 2 * percentile(cms, 50) for c in cms)}", file=sys.stderr)
    if ranks > 1:
        print(f"edmbench: {ranks} ranks, cycles run by each {res['rank_cycles']}",
              file=sys.stderr)
    print(f"edmbench: window {res['window_s']:.3f} s, {res['cycles']} cycles, reference "
          f"check {res['reference_s']:.3f} s", file=sys.stderr)
    for k, v in res["notes"].items():
        print(f"note {k}: {v!r}", file=sys.stderr)
    result["checks"] = {k: [r["value"], r["limit"]] for k, r in rows.items()}
    for k, r in rows.items():
        print(f"check {k}: {r['value']!r} (limit {r['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
