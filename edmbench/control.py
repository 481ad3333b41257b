#!/usr/bin/env python3
"""The readings that each limit of ``limits/<configuration>.json`` is set from, on the
card at a cell's own size: for each seed, a short window of the cell (a
sharded cell in its ranks, launched anew a seed), the checked cycle judged
against the reference (the program's gaps: the lower readings) and the
control judged the same way (the reference computed in bfloat16, the
precision below the configuration's float32, in the program's place: the
upper readings).  One process for all the seeds.

    python3 edmbench/control.py --workload inlj.4m --seconds 2 --seeds 11 12 13

Prints one JSON line a seed: {"seed", "program": {...}, "cycles", the
kind's notes, "reference_s", "control": {...}}.  The benchmark's runs do
not run this."""

import argparse
import gc
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from edmbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true", help="the program's gaps only")
    args = ap.parse_args(argv)
    run.set_cache_env()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load(os.path.join(run.ROOT, "BENCHMARK.json"))
    _, cfg, mix = run.cell_of(bench, args.workload)
    runner = run.run_ranks if int(mix.get("ranks", 1)) > 1 else run.run_cell
    for seed in args.seeds:
        res = runner(args.workload, cfg, mix, seed, args.seconds, False,
                     control_dtype=None if args.no_control else torch.bfloat16)
        line = dict(seed=seed, program={k: r["value"] for k, r in res["checks"][2].items()},
                    cycles=res["cycles"], **res["notes"], reference_s=res["reference_s"])
        if "control" in res:
            line["control"] = res["control"]
        print(json.dumps(line), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
