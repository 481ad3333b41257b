"""Each configuration builds its published sizes through the port."""

import pytest
import torch

from edmbench import lattice
from edmbench.kinds import pair_cells as S
from edmbench.tests.conftest import config


@pytest.mark.parametrize("name,mix,atoms,cells,cap,box", [
    ("inlj", {"replicate": [5, 5, 5]}, 4000000, (41, 41, 41), 96, 167.960),
    ("pairbench", {"n_atoms": 6859000}, 6859000, (78, 78, 78), 32, 239.4),
])
def test_published_sizes(name, mix, atoms, cells, cap, box):
    cfg = config(name)
    sysm = S.build(cfg, dict(mix, host="single"), 1, "cpu")
    assert sysm.n_atoms == atoms
    assert tuple(sysm.spec.ncells) == cells
    assert sysm.spec.cap == cap
    assert all(abs(b - box) < 1e-3 for b in sysm.box)
    if cfg["cells"]["kernel_cap"] is not None:
        assert sysm.state.kernel_cap == cfg["cells"]["kernel_cap"]
        assert sysm.state.ovl.shape[0] == cfg["cells"]["overflow_cap"]


def test_slab_size_arithmetic():
    """in.lj at x = 20, y = z = 5, the four-card cell ``inlj.16m.slab4``:
    16,000,000 atoms on 165 x 41 x 41 cells of the automatic cap 96 (each
    card's x-columns hold ``inlj.4m``'s liquid)."""
    from edm_tpu_torch.models.cells import CellSpec

    cfg = config("inlj")
    x, box = lattice.positions(cfg, {"replicate": [20, 5, 5]}, "cpu")
    assert x.shape[0] == 16000000
    assert abs(box[0] - 671.84) < 0.01 and all(abs(b - 167.96) < 0.01 for b in box[1:])
    spec = CellSpec.create(box, cutoff=cfg["cells"]["cutoff"], n_atoms=x.shape[0],
                           cap=cfg["cells"]["cap"])
    assert tuple(spec.ncells) == (165, 41, 41)
    assert spec.cap == 96


def test_mixes_name_their_hosts():
    """Every cell's mix names a host the harness builds, and a sharded one
    as many ranks as the cell has cards (a brick its mesh of them)."""
    import json
    import math
    import os

    from edmbench.tests.conftest import ROOT

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for wl in bench["workloads"]:
        with open(os.path.join(ROOT, "edmbench", "mixes", wl["traffic"] + ".json")) as f:
            mix = json.load(f)
        assert mix["host"] in ("single", "slab", "brick"), wl["name"]
        assert mix["ranks"] == (1 if mix["host"] == "single" else wl["chips"]), wl["name"]
        if mix["host"] == "brick":
            assert math.prod(mix["mesh"]) == mix["ranks"], wl["name"]


def test_seed_changes_no_work():
    """Every seed starts from the same positions: only the noise differs."""
    cfg = config("pairbench")
    a = S.build(cfg, {"n_atoms": 1000, "host": "single"}, 1, "cpu")
    b = S.build(cfg, {"n_atoms": 1000, "host": "single"}, 2**31 + 5, "cpu")
    assert torch.equal(a.state.xs, b.state.xs)
    assert not (a.state.core.key == b.state.core.key).all()
