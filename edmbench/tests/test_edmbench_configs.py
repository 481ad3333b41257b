"""Each configuration builds its published sizes through the port."""

import pytest
import torch

from edmbench import lattice, system as S
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
    """in.lj at x = 12, y = z = 3, the four-card weak-scaling size listed
    for a later cell: 3,456,000 atoms on 99 x 24 x 24 cells."""
    cfg = config("inlj")
    x, box = lattice.positions(cfg, {"replicate": [12, 3, 3]}, "cpu")
    assert x.shape[0] == 3456000
    assert tuple(int(b // cfg["cells"]["cutoff"]) for b in box) == (99, 24, 24)
    assert abs(box[0] - 403.10) < 0.01


def test_seed_changes_no_work():
    """Every seed starts from the same positions: only the noise differs."""
    cfg = config("pairbench")
    a = S.build(cfg, {"n_atoms": 1000, "host": "single"}, 1, "cpu")
    b = S.build(cfg, {"n_atoms": 1000, "host": "single"}, 2**31 + 5, "cpu")
    assert torch.equal(a.state.xs, b.state.xs)
    assert not (a.state.core.key == b.state.core.key).all()
