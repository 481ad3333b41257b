"""A kind is found by the configuration's name for it: a test-only kind on
the port's coordinate host runs through the same window, spans, checks and
port tracing as the pair kind; and the pair kind keeps the steps that it
checks where the harness before kinds kept them, for every seed."""

import json
import sys

import numpy as np
import pytest

from edmbench import check, kinds, run
from edmbench.kinds import pair_cells
from edmbench.tests import coord_kind

NAME = "coord_test"


@pytest.fixture
def coord(monkeypatch, tmp_path):
    """The coordinate kind under ``edmbench.kinds``, its limits in a
    directory of the test's own, and a configuration and mix that name it."""
    monkeypatch.setitem(sys.modules, f"{kinds.__name__}.{NAME}", coord_kind)
    (tmp_path / f"{NAME}.json").write_text(json.dumps(dict.fromkeys(coord_kind.NUMBERS, 0)))
    monkeypatch.setattr(check, "LIMITS", str(tmp_path))
    return ({"name": NAME, "kind": NAME, "port_trace": True},
            {"n_particles": 300, "ranks": 1, "warmup_cycles": 1})


@pytest.mark.parametrize("trace", [False, True])
def test_kind_found_by_name(coord, trace):
    cfg, mix = coord
    assert kinds.load(cfg) is coord_kind
    res = run.run_cell(NAME, cfg, mix, 2**31 + 3, 0.3, trace, device="cpu")
    rec = res["record"]
    assert rec["steps"] == res["cycles"] * 10
    assert set(rec["spans"]) == {"hill", "plain"}
    correct, failed, rows = res["checks"]
    assert correct, rows
    assert list(rows) == list(coord_kind.NUMBERS)
    assert set(res["notes"]) == {"largest_move"} and res["notes"]["largest_move"] > 0
    if not trace:
        assert "port" not in rec and all(not t for t in rec["spans"].values())
        return
    assert len(rec["spans"]["hill"]) == res["cycles"]
    assert len(rec["spans"]["plain"]) == 9 * res["cycles"]
    counters = rec["port"]["counters"]
    assert counters["rounds"] == len(rec["spans"]["hill"])
    assert {"hills.deferred", "rounds.skipped", "limiter.passes"} <= set(counters)
    assert rec["work"]["least_s"] > 0


def test_limits_must_hold_the_kinds_numbers(coord, tmp_path):
    cfg, mix = coord
    (tmp_path / f"{NAME}.json").write_text(json.dumps({"step_mismatch": 0}))
    with pytest.raises(ValueError, match="NUMBERS"):
        run.run_cell(NAME, cfg, mix, 5, 0.1, False, device="cpu")


@pytest.mark.parametrize("seconds,ranks_cycles", [(30, None), (2, None), (30, 75)])
def test_pair_kind_checks_the_parents_steps(seconds, ranks_cycles):
    """The pair kind's checked plain step and cycle, for seeds 1 to 50,
    as the harness drew them before kinds: the plain step's place from
    ``integers(1, 9)``, then the cycle (one card: of the first 2 x
    ``seconds``; a sharded host: of the broadcast count)."""
    for seed in range(1, 51):
        rng = np.random.default_rng(abs(seed))
        plain_pos = int(rng.integers(1, 9))
        n = max(1, int(2 * seconds)) if ranks_cycles is None else ranks_cycles
        check_cycle = int(rng.integers(0, n))
        keep, cycle = run.checked_steps(pair_cells.PATTERN, seed, n)
        assert keep == {0: "hill", plain_pos: "plain", 9: "rebuild"}
        assert cycle == check_cycle
