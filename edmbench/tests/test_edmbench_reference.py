"""The plain reference against the port's plain path at tiny sizes, and
the comparison that decides ``correct`` shown to fail: under the control
(the reference in bfloat16 in the program's place) and under each fault
of the timed path that a cell can have."""

import dataclasses

import pytest
import torch

from edmbench import check, run
from edmbench.kinds import pair_cells
from edmbench.tests.conftest import tiny

SEED = 2**31 + 17


@pytest.mark.parametrize("name", ["inlj", "pairbench"])
@pytest.mark.parametrize("kT", [0.0, 0.8])
def test_reference_matches_port(name, kT):
    cfg, mix = tiny(name, kT)
    res = run.run_cell(name, cfg, mix, SEED, 0.5, False, device="cpu")
    correct, failed, rows = res["checks"]
    assert correct, rows
    assert set(rows) == set(pair_cells.NUMBERS) - {"rank_mismatch"}  # a sharded host's alone


def test_reference_over_cycles_kT0():
    """At kT = 0 the reference follows the port over whole stride cycles:
    every cycle the window runs, checked from the port's state."""
    cfg, mix = tiny("pairbench", 0.0)
    for seed in (3, 4, 5):
        res = run.run_cell("pairbench", cfg, mix, seed, 0.3, False, device="cpu")
        assert res["checks"][0], res["checks"][2]


@pytest.mark.parametrize("name", ["inlj", "pairbench"])
def test_control_fails(name):
    cfg, mix = tiny(name)
    res = run.run_cell(name, cfg, mix, SEED, 0.3, False, device="cpu",
                       control_dtype=torch.bfloat16)
    correct, _, _ = check.verdict(res["control"], check.limits(cfg["name"]))
    assert not correct, res["control"]


def unchanged(phase, st, out):
    """A step that returns its state unchanged."""
    return st, out[1]


def half_batch(phase, st, out):
    """Half of the atoms' forces left out where the step produces them."""
    new, y = out
    fs = new.fs.clone()
    fs[: fs.shape[0] // 2] = 0.0
    return dataclasses.replace(new, fs=fs), y


def altered(phase, st, out):
    """One answer altered where it is produced: the hill round's bias grid
    on hill steps, one atom's force on the others."""
    new, y = out
    if phase == "hill":
        bias = new.core.bias
        grid = bias.bias.grid
        g = dataclasses.replace(grid, values=grid.values * 1.01)
        b = dataclasses.replace(bias, bias=dataclasses.replace(bias.bias, grid=g))
        return dataclasses.replace(new, core=dataclasses.replace(new.core, bias=b)), y
    fs = new.fs.clone()
    occ = torch.nonzero(new.mc.reshape(-1) > 0.5)[0, 0]
    fs.view(-1, 3)[occ] += 0.1 * (1.0 + fs.abs().max())
    return dataclasses.replace(new, fs=fs), y


@pytest.mark.parametrize("fault", [unchanged, half_batch, altered])
@pytest.mark.parametrize("name", ["inlj", "pairbench"])
def test_faults_fail(name, fault):
    cfg, mix = tiny(name)
    res = run.run_cell(name, cfg, mix, SEED, 0.3, False, device="cpu", fault=fault)
    correct, failed, rows = res["checks"]
    assert not correct, rows


@pytest.mark.gpu
def test_cell_on_card():
    """One short run of each cell on a card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys
    for cell in ("inlj.4m", "pairbench.6859k"):
        p = subprocess.run([sys.executable, "edmbench/run.py", "--workload", cell, "--seed",
                            str(SEED), "--seconds", "2", "--trace", "0"], cwd=run.ROOT,
                           capture_output=True, text=True, timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]


def test_target_bin_edge_allowance():
    """A hill on a target bin's edge may read either bin in float32: the
    grid and the bias added from the other bin lie within the allowance,
    and a hill off the edges gets none."""
    from edmbench.kinds.pair_cells import reference as R
    from edmbench.tests.conftest import config
    b = config("pairbench")["bias"]
    bias = R.Bias(b, torch.float64, "cpu")
    v = torch.zeros(bias.G, dtype=torch.float64)
    d = torch.zeros(bias.G, dtype=torch.float64)
    edge = 63 * bias.dx
    on = torch.tensor([1.0, edge], dtype=torch.float64)
    below = torch.tensor([1.0, edge - 1e-9], dtype=torch.float64)
    a = R.hill_round(bias, v, d, 0.0, ([], []), on, 1e6, [True, True])
    z = R.hill_round(bias, v, d, 0.0, ([], []), below, 1e6, [True, True])
    assert a[4][2] > 0
    # the centre moved by 1e-9; the support's edge (a grid point here) is
    # left out
    inner = torch.abs(z[0]) > 1e-3 * float(torch.abs(z[0]).max())
    slack = 1e-6 * float(torch.abs(a[0]).max())
    diff = torch.abs(a[0] - z[0])[inner]
    assert float(diff.max()) > 10 * slack
    assert torch.all(diff <= a[4][0][inner] + slack)
    assert abs(a[2] - z[2]) <= a[4][2] * (1 + 1e-6)
    off = torch.tensor([1.01, edge + 0.3 * bias.dx], dtype=torch.float64)
    assert R.hill_round(bias, v, d, 0.0, ([], []), off, 1e6, [True, True])[4][2] == 0.0


def test_nan_gap_fails():
    """A gap that reads NaN (a force, an energy or a bias added that is
    not a number) fails its limit, and the worst over the checked steps
    keeps it."""
    from edmbench import check
    nan = float("nan")
    assert check._excess(nan) != check._excess(nan)
    assert check._excess(-1.0) == 0.0
    correct, failed, _ = check.verdict({"force_gap": nan, "position_gap": 0.0},
                                       {"force_gap": 1e-3, "position_gap": 1e-2})
    assert not correct and failed == ["force_gap"]
