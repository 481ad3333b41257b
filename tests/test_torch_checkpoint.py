"""PyTorch port: exact checkpoint and resume (``utils/checkpoint``).

A run checkpointed part way, restored into a freshly built template and
continued equals the uninterrupted run bitwise, every leaf: the deferred
hill buffer (non-empty at the checkpoint), cum_bias, the host-side
Threefry key, and on the cell host with ``kernel_cap`` the tail list and
``tail_ovf_host``, which the fresh template holds at another value (the
checkpoint falls after the rebuild that left the full-cap period).  A
checkpoint loaded into a template of another structure raises ``EDMError``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from _torch_parity import assert_tree, clustered_points
from edm_tpu_torch import EDMError
from edm_tpu_torch import bias as TB
from edm_tpu_torch.models import coord_edm as tce
from edm_tpu_torch.models import pair_edm as tpe
from edm_tpu_torch.models.cells import CellSpec
from edm_tpu_torch.models.driver import pattern_segment
from edm_tpu_torch.models.langevin import LangevinParams
from edm_tpu_torch.models.lj import LJParams
from edm_tpu_torch.models.pair_edm_cells import init_cell_state, make_cell_step
from edm_tpu_torch.ops.prng import PRNGKey
from edm_tpu_torch.utils.checkpoint import load_state, save_state
from edm_tpu_torch.utils.config import parse_edm_text


def _coord():
    cfg = parse_edm_text("tempering 0\nhill_prefactor 0.5\nbias_per_step 0.4\nhill_density -1\n"
                         "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
                         "bias_sigma 0.1\n")
    params, bs = TB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=torch.float64, device="cpu")
    x0 = torch.as_tensor(np.random.default_rng(0).uniform(0.5, 2.5, (8, 1)))
    lp = LangevinParams(dt=0.002, friction=1.0, kT=0.5)
    step = tce.make_step(params, lp, hill_stride=2)
    return step, tce.init_state(params, bs, x0, PRNGKey(1), lp)


def _leaves_equal(a, b, what):
    assert_tree(a, b, 0.0, what)


def test_coord_host_resume_bitwise(tmp_path):
    step, state = _coord()
    full, _ = tce.run_segment(step, state, 12)
    mid, _ = tce.run_segment(step, state, 6)
    assert int(mid.bias.buf_right) > int(mid.bias.buf_left), "no deferred hills at the checkpoint"
    save_state(mid, str(tmp_path / "c.npz"))
    _, fresh = _coord()
    resumed = load_state(fresh, str(tmp_path / "c.npz"))
    assert isinstance(resumed.key, np.ndarray) and resumed.key.dtype == np.uint32
    cont, _ = tce.run_segment(step, resumed, 6)
    _leaves_equal(cont, full, "resumed vs uninterrupted")
    np.testing.assert_array_equal(cont.key, full.key)


N, KCAP, OCAP = 600, 24, 48


def _cells(kernel_cap=KCAP):
    cfg = parse_edm_text("tempering 1\nbias_factor 10\nhill_prefactor 2.0\nbias_per_step 0.2\n"
                         "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\n"
                         "bias_spacing 0.02\nbias_sigma 0.1\n")
    params, bs = TB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                              dtype=torch.float32, device="cpu")
    core = tpe.init_state(bs, torch.as_tensor(clustered_points(N)), PRNGKey(0), n_est=N * 300)
    core = dataclasses.replace(core, v=torch.zeros_like(core.x).index_fill_(
        1, torch.tensor([1]), 5.0))
    spec = CellSpec.create([6.0] * 3, cutoff=2.0, n_atoms=N, cap=56)
    state = init_cell_state(spec, core, kernel_cap=kernel_cap, overflow_cap=OCAP)
    kw = dict(hill_stride=10, rebuild_stride=10, hill_capacity=512, energy_stride=10,
              use_pallas=True, kernel_cap=kernel_cap, overflow_cap=OCAP)
    lp, lj = LangevinParams(dt=0.002, friction=1.0, kT=0.8), LJParams(sigma=0.3, rcut=0.75)
    steps = [make_cell_step(params, lp, lj, spec, static_do_hills=h, static_do_energy=e,
                            static_do_rebuild=r, **kw)
             for h, e, r in ((True, True, False), (False, False, False), (False, False, True))]
    return steps, state


def test_cell_host_resume_bitwise(tmp_path):
    steps, state = _cells()
    assert state.tail_ovf_host  # the fresh template starts in the full-cap period
    seg = pattern_segment([(steps[0], 1), (steps[1], 8), (steps[2], 1)], 10)
    full = seg(seg(seg(state)[0])[0])[0]
    mid = seg(seg(state)[0])[0]
    assert not mid.tail_ovf_host and int(mid.tail_fallbacks) == 1
    assert int(mid.core.bias.buf_right) > 0, "no deferred hills at the checkpoint"
    save_state(mid, str(tmp_path / "cells.npz"))
    _, fresh = _cells()
    resumed = load_state(fresh, str(tmp_path / "cells.npz"))
    assert resumed.tail_ovf_host is False and resumed.kernel_cap == KCAP
    cont = seg(resumed)[0]
    _leaves_equal(cont, full, "resumed vs uninterrupted")
    assert cont.tail_ovf_host == full.tail_ovf_host
    np.testing.assert_array_equal(cont.core.key, full.core.key)


def test_mismatched_template_rejected(tmp_path):
    step, state = _coord()
    save_state(state.bias, str(tmp_path / "b.npz"))  # the engine state alone
    with pytest.raises(EDMError, match="does not match"):
        load_state(state, str(tmp_path / "b.npz"))
    _, cells = _cells()
    save_state(cells, str(tmp_path / "k.npz"))
    _, other = _cells(kernel_cap=32)  # another kernel_cap: another build
    with pytest.raises(EDMError, match="does not match"):
        load_state(other, str(tmp_path / "k.npz"))
