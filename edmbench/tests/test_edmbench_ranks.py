"""The multi-rank path of the harness (``run.run_ranks``) on CPU ranks
over gloo at tiny sizes: the slab host on 2 and 4 ranks and the brick
host on 2 x 2 run the same cycle count on every rank, keep every rank's
state bitwise rank 0's, and report what a one-card run reports; a fault
on one rank fails ``rank_mismatch``."""

import pytest

from edmbench import check, run
from edmbench.tests.conftest import tiny
from edmbench.tests.test_edmbench_reference import SEED, altered

ONE_CARD = {"setup_s", "window_s", "cycles", "cycle_ms", "memory_peak_bytes", "record",
            "checks", "reference_s", "notes"}


def sharded(name, host, ranks):
    cfg, mix = tiny(name)
    mix.update(host=host, ranks=ranks)
    if host == "brick":
        mix["mesh"] = [2, 2]
    if name == "inlj":
        mix["replicate"] = [2, 1, 1]  # 6 x 3 x 3 cells: a slab column or more a rank
    return cfg, mix


@pytest.mark.parametrize("name,host,ranks,trace", [
    ("inlj", "slab", 2, True),
    ("inlj", "slab", 4, False),
    ("pairbench", "brick", 4, False),
])
def test_ranks_run_alike(name, host, ranks, trace):
    cfg, mix = sharded(name, host, ranks)
    single = run.run_cell(name, cfg, dict(mix, host="single", ranks=1), SEED, 0.3, trace,
                          device="cpu")
    res = run.run_ranks(name, cfg, mix, SEED, 0.3, trace, device="cpu", backend="gloo")
    assert len(res["rank_cycles"]) == ranks and len(set(res["rank_cycles"])) == 1
    assert res["cycles"] == res["rank_cycles"][0] == len(res["cycle_ms"])
    assert set(res) >= ONE_CARD
    assert set(res["record"]) == set(single["record"]) and res["record"]["ranks"] == ranks
    correct, failed, rows = res["checks"]
    assert correct, rows
    assert set(rows) == set(single["checks"][2]) | {"rank_mismatch"}
    assert "rank_mismatch" not in single["checks"][2]
    assert rows["rank_mismatch"]["value"] == 0.0
    assert res["forbidden"] == []


def test_fault_on_one_rank_fails():
    """Rank 1's steps altered where they are produced: the ranks' final
    states differ."""
    cfg, mix = sharded("inlj", "slab", 2)
    res = run.run_ranks("inlj", cfg, mix, SEED, 0.3, False, device="cpu", backend="gloo",
                        fault=altered, fault_ranks=(1,))
    correct, failed, rows = res["checks"]
    assert "rank_mismatch" in failed, rows
    assert rows["rank_mismatch"]["value"] == 1.0


def test_control_fails_on_ranks():
    """The control, judged over the ranks' shares of the kept steps."""
    import torch

    cfg, mix = sharded("pairbench", "slab", 2)
    res = run.run_ranks("pairbench", cfg, mix, SEED, 0.3, False, device="cpu", backend="gloo",
                        control_dtype=torch.bfloat16)
    correct, _, _ = check.verdict(res["control"], check.limits(cfg["name"]))
    assert not correct, res["control"]


@pytest.mark.gpu
def test_sharded_cell_on_cards():
    """One short run of the four-card cell (skips below four cards)."""
    import json
    import subprocess
    import sys

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    p = subprocess.run([sys.executable, "edmbench/run.py", "--workload", "inlj.16m.slab4",
                        "--seed", str(SEED), "--seconds", "2", "--trace", "0"], cwd=run.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
