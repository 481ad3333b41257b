"""Boundary-sweep demo on the PyTorch port (``edm_tpu_torch``), the
counterpart of ``examples/boundary_sweep.py``: seven single-hill deposits
walking x = 2..8 across a NON-PERIODIC [2, 8] box with sigma 0.5, so that
the first and last hills sit exactly ON the McGovern-De Pablo boundary and
the rest straddle it to varying degrees (gaussian_grid.h:504-541).

It drives ``edm_tpu_torch.api.EDMBias`` in float64 the way an external MD
engine would: a fresh bias per iteration, one pre/add/post hill cycle, a
grid write.  The 601-point walled grid deposits through the plain dense
route (no CUDA kernel on this path).  The grids are pinned against the
compiled reference (``tests/oracles/boundary_sweep.txt``) by
``tests/test_torch_examples.py``.

Run: python examples/torch_boundary_sweep.py [outdir] [--device cpu|cuda]
(``cuda``, the default, raises when no card is present.)
"""

import argparse
import pathlib
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from edm_tpu_torch import checked_device  # noqa: E402
from edm_tpu_torch.api import EDMBias  # noqa: E402

TEST_EDM = (
    # test.edm from the reference demo, verbatim keys
    "tempering 0\nbias_per_step 1000.0\nhill_prefactor 1.0\ndimension 1\n"
    "box_low 2\nbox_high 8\nbias_spacing 0.01\nbias_sigma 0.5\n"
)


def read_oracle(path):
    """The compiled reference's sweep (``tests/oracles/boundary_sweep.txt``):
    [(x, cum_bias, [(q, value, derivative), ...])], one entry a hill."""
    lines = pathlib.Path(path).read_text().splitlines()
    runs, i = [], 0
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] == "HILL":
            npr = int(lines[i + 2].split()[1])
            probes = [tuple(float(v) for v in lines[i + 3 + j].split()[1:4]) for j in range(npr)]
            runs.append((float(tok[1]), float(lines[i + 1].split()[1]), probes))
            i += 3 + npr
        else:
            i += 1
    return runs


def sweep(outdir, device="cuda"):
    """The seven deposits; returns [(x, EDMBias)] and writes
    ``grid_<i>.dat`` (i = 1..7) into ``outdir``."""
    device = checked_device(device)
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    cfg = outdir / "test.edm"
    cfg.write_text(TEST_EDM)

    grids = []
    for i in range(7):
        x = 2.0 + i  # the demo's displace_atoms walk
        b = EDMBias(str(cfg), 1.0, 1.0, dtype=torch.float64, log_hills=False, device=device)
        b.set_box([2.0], [8.0], [False])
        # one pre/add/post cycle per iteration = `run 0` with hill stride 1
        b.pre_add_hill(1)
        b.add_hill_r([x], 0.5)
        b.post_add_hill()
        path = outdir / f"grid_{i + 1}.dat"
        b.write_bias(str(path))
        grids.append((x, b))
        peak = b.bias_value([min(max(x, 2.0), 8.0)])
        print(f"hill at x={x:.1f}: cum_bias={b.cum_bias:.6f} peak={peak:.6f}"
              f" -> {path}")
    return grids


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    outdir = args.outdir or tempfile.mkdtemp(prefix="bsweep_")
    grids = sweep(outdir, args.device)
    # boundary effect summary: a bulk hill integrates to ~prefactor; the
    # boundary-corrected ones conserve the integral while flattening the
    # force at the wall
    for x, b in grids:
        qs = np.linspace(2.0, 8.0, 601)[:, None]
        vals = np.array([b.bias_value(q) for q in qs])
        print(f"x={x:.1f}: grid integral ~ {np.trapezoid(vals, dx=0.01):.4f},"
              f" wall values v(2)={vals[0]:.4f} v(8)={vals[-1]:.4f}")
    return grids


if __name__ == "__main__":
    main()
