"""The benchmark's own tests: ``python -m pytest edmbench/tests -q`` from
the root of the repository (the tier-1 run, ``pytest tests/``, does not
collect them).  They run the port's plain versions on the CPU at tiny
sizes; a test marked ``gpu`` runs the harness on a card and skips here."""

import copy
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "edmbench", "configs", name + ".json")) as f:
        return json.load(f)


def tiny(name: str, kT=None):
    """A configuration and mix at a size the CPU runs in seconds: three or
    four cells a side."""
    cfg = copy.deepcopy(config(name))
    # at kT = 0 a perfect lattice puts every pair distance on a lattice
    # distance, some exactly on a grid point; the jitter moves them off
    mix = {"host": "single", "warmup_cycles": 2, "jitter": 0.05 if kT == 0.0 else 0.0}
    if kT is not None:
        cfg["langevin"]["kT"] = kT
    if name == "inlj":
        cfg["lattice"]["unit_cells"] = 8  # 2,048 atoms, 3^3 cells of 4.48
        return cfg, dict(mix, replicate=[1, 1, 1])
    return cfg, dict(mix, n_atoms=1000)  # 4^3 cells


@pytest.fixture(autouse=True)
def _threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
