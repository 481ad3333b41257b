"""PyTorch port: ``EDMBias``, the binding surface, against the JAX package
and the compiled reference.

  - The same config and hill rounds (numpy inputs from a seed) through both
    packages' ``EDMBias`` (float64): the grid's values and derivatives,
    cum_bias, the deferred buffer and the histogram to 1e-12, integer
    leaves exactly, after every round; ``get_force``, ``update_force(s)``
    (with a mask) and ``bias_value`` to 1e-12; the written bias, histogram,
    HILLS and ``.ltab`` files line for line, their numbers within the text's
    last digit (``test_torch_gridio.py`` and ``test_torch_run.py`` hold the
    writers byte for byte on the same grid and records).  Cases: 1-D and 2-D, ``add_hills``
    with masks, the pre/add/post cycle, ``add_hill``, ``hill_passes`` 2 and
    "live".
  - The stall warning.
  - ``tests/oracles/workload.txt`` (500 pairs x 2 hills x 6 rounds under
    heavy capping) replayed at 1e-9 against the compiled reference's
    cum_bias per round and 31 probes; the seven-hill boundary sweep
    (``tests/oracles/boundary_sweep.txt``) at 1e-9 for values and
    derivatives.
  - A restart from ``initial_bias_filename``, and a ``target_filename`` run
    against JAX at 1e-12.
"""

import pathlib
import random
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_f64, assert_tree
from edm_tpu.api import EDMBias as JEDMBias
from edm_tpu_torch import EDMError
from edm_tpu_torch.api import EDMBias
from edm_tpu_torch.grid import Grid, GridSpec
from edm_tpu_torch.utils.gridio import write_grid

ORACLES = pathlib.Path(__file__).parent / "oracles"

CFG_1D = ("tempering 1\nbias_factor 8\nhill_prefactor 0.8\nbias_per_step 1.2\n"
          "hill_density 6\ndimension 1\nbox_low 0\nbox_high 10\nbias_spacing 0.0097\n"
          "bias_sigma 0.25\n")
CFG_2D = ("tempering 0\nhill_prefactor 0.5\nbias_per_step 0.3\nhill_density -1\n"
          "dimension 2\nbox_low 0 0\nbox_high 4 4\nbias_spacing 0.09 0.11\n"
          "bias_sigma 0.3 0.25\n")
CASES = {
    "1d": (CFG_1D, [False], dict()),
    "1d-passes2": (CFG_1D, [True], dict(hill_passes=2)),
    "1d-live": (CFG_1D, [True], dict(hill_passes="live")),
    "2d": (CFG_2D, [True, True], dict()),
    "2d-walled": (CFG_2D, [False, False], dict()),
}


def _pair(tmp_path, text, periodic, **kw):
    """(JAX EDMBias, port EDMBias) from the same .edm text, each logging to
    its own HILLS file, histogram file beside it."""
    out = []
    for tag, cls, extra in (("J", JEDMBias, dict(dtype=jnp.float64)),
                            ("T", EDMBias, dict(device="cpu"))):
        p = tmp_path / f"{tag}.edm"
        p.write_text(text + f"hills_filename {tmp_path}/{tag}_HILLS\n"
                     f"histogram_filename {tmp_path}/{tag}_HIST\n")
        b = cls(str(p), 1.0, 1.0, **extra, **kw)
        D = b.dim
        b.set_box([0.0] * D, [10.0 if D == 1 else 4.0] * D, periodic)
        out.append(b)
    return out


def same_text(got, want):
    """Two text files line for line: the same tokens, numbers within 2e-8
    (the grids agree to ~1e-16, which can move an 8-decimal rounding, or the
    sign of a zero, by one step)."""
    g, w = got.read_text().splitlines(), want.read_text().splitlines()
    assert len(g) == len(w), got.name
    for a, b in zip(g, w):
        ta, tb = a.split(), b.split()
        assert len(ta) == len(tb), (got.name, a, b)
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                assert x == y, (got.name, a, b)
                continue
            assert abs(fx - fy) <= 2e-8, (got.name, a, b)


def _same(tb, jb, what):
    assert_tree(tb.state, jb.state, 1e-12, what)
    assert tb.cum_bias == pytest.approx(jb.cum_bias, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("case", list(CASES))
def test_api_matches_jax(tmp_path, case):
    text, periodic, kw = CASES[case]
    jb, tb = _pair(tmp_path, text, periodic, **kw)
    D = tb.dim
    hi = 10.0 if D == 1 else 4.0
    rng = np.random.default_rng(21)
    mask = rng.integers(0, 4, 40)
    for b in (jb, tb):
        b.set_mask(mask)
    for r in range(4):
        pos = rng.uniform(-0.5, hi + 0.5, (int(rng.integers(5, 40)), D))
        uni = rng.uniform(0, 1, len(pos))
        for b in (jb, tb):
            b.add_hills(pos, uni, apply_mask=1 if r % 2 else None)
        _same(tb, jb, f"add_hills round {r}")
    # the binding's pre / add / post cycle, then add_hill
    for r in range(2):
        pos = rng.uniform(0, hi, (7, D))
        uni = rng.uniform(0, 1, 7)
        for b in (jb, tb):
            b.pre_add_hill(9)
            for p, u in zip(pos, uni):
                b.add_hill_r(p, u)
            b.post_add_hill()
        _same(tb, jb, f"pre/add/post round {r}")
    x = rng.uniform(0, hi, D)
    for b in (jb, tb):
        random.seed(5)
        b.add_hill(x)
    _same(tb, jb, "add_hill")
    assert int(tb.state.steps) == 7 and tb.cum_bias > 0
    # forces: get_force is the gradient; update_force(s) subtract it
    pts = rng.uniform(0, hi, (40, D + 1))
    for q in pts[:5, :D]:
        (tv, td), (jv, jd) = tb.get_force(q), jb.get_force(q)
        assert_f64(np.array([tv] + td), np.array([jv] + jd), "get_force")
        assert_f64(tb.bias_value(q), jb.bias_value(q), "bias_value")
    ft, fj = np.ones((40, D + 1)), np.ones((40, D + 1))
    assert_f64(tb.update_forces(pts, ft, apply_mask=2), jb.update_forces(pts, fj, apply_mask=2),
               "update_forces energy")
    assert_f64(ft, fj, "update_forces")
    assert ft[:, D].tolist() == [1.0] * 40  # only the CV components move
    gt, gj = np.zeros(D + 1), np.zeros(D + 1)
    assert_f64(tb.update_force(pts[0], gt), jb.update_force(pts[0], gj), "update_force")
    assert_f64(gt, gj, "update_force forces")
    # the files
    for b, tag in ((jb, "J"), (tb, "T")):
        b.write_bias(str(tmp_path / f"{tag}_BIAS"))
        b.write_histogram()
        if D == 1:
            b.write_lammps_table(str(tmp_path / f"{tag}.ltab"))
        b.hills_log.close()
    names = ["BIAS", "HIST", "HILLS_0"] + (["ltab"] if D == 1 else [])
    for name in names:
        sep = "." if name == "ltab" else "_"
        same_text(tmp_path / f"T{sep}{name}", tmp_path / f"J{sep}{name}")
    for b in (jb, tb):
        b.clear_histogram()
    _same(tb, jb, "clear_histogram")
    assert float(tb.state.cv_hist.values.abs().sum()) == 0
    # set_box again is a no-op (subdivide is idempotent)
    before = tb.state
    tb.set_box([0.0] * D, [hi] * D, periodic)
    assert tb.state is before
    assert tb.bias_grid is tb.state.bias


def test_options_and_errors(tmp_path):
    (tmp_path / "a.edm").write_text(CFG_1D)
    with pytest.raises(EDMError, match="power of two"):
        EDMBias(str(tmp_path / "a.edm"), 1.0, 1.0, hill_passes=3, device="cpu")
    b = EDMBias(str(tmp_path / "a.edm"), device="cpu", log_hills=False)
    with pytest.raises(EDMError, match="setup"):
        b.set_box([0], [10], [True])
    b.setup(1.0, 1.0)
    with pytest.raises(EDMError, match="set_box"):
        b.add_hills(np.zeros((1, 1)), np.ones(1))
    b.set_box([0], [10], [True])
    assert b.hills_log is None and b.state.cum_bias.device.type == "cpu"
    assert b.state.bias.dtype == torch.float64
    # the entry point's default device is the card
    import inspect

    assert inspect.signature(EDMBias).parameters["device"].default == "cuda"


def test_stall_warning(tmp_path):
    """A single hill whose integral exceeds bias_per_step is deposited and
    undone every round: the port warns once, as the JAX package does."""
    (tmp_path / "s.edm").write_text(
        "tempering 0\nhill_prefactor 1.0\ndimension 1\nbox_low 0.0\nbox_high 1.0\n"
        "bias_spacing 0.01\nbias_sigma 0.5\n")
    b = EDMBias(str(tmp_path / "s.edm"), 1.0, 1.0, log_hills=False, device="cpu")
    b.set_box([0], [1], [True])
    with pytest.warns(UserWarning, match="bias_per_step"):
        b.add_hills(np.array([[0.25]]), np.ones(1))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        b.add_hills(np.array([[0.25]]), np.ones(1))  # once only
    # nothing deposited, the hill deferred (reference parity)
    assert b.cum_bias == 0.0 and b.bias_value([0.25]) == 0.0
    assert int(b.state.buf_right) == 1


def test_workload_replay_matches_reference(tmp_path):
    """tests/oracles/workload.txt through the port's EDMBias (float64):
    cum_bias after each round and the 31 probes within 1e-9 of the compiled
    reference; deferred hills remain at the end."""
    lines = (ORACLES / "workload.txt").read_text().strip().splitlines()
    r = np.array([float(v) for v in lines[0].split()[1:]])
    rounds, probes, i = [], None, 1
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] == "U":
            rounds.append((np.array([float(v) for v in tok[1:]]), float(lines[i + 1].split()[1])))
            i += 2
        else:
            if tok[0] == "PROBES":
                probes = np.array([float(v) for v in tok[1:]])
            i += 1
    p = tmp_path / "wl.edm"
    p.write_text("tempering 0\nhill_prefactor 10.0\nbias_per_step 1.0\nhill_density 250\n"
                 "dimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\nbias_sigma 0.1\n")
    b = EDMBias(str(p), 1.0, 1.0, log_hills=False, device="cpu")
    b.set_box([0], [3.0], [False])
    assert len(rounds) == 6 and len(probes) == 31
    for us, want_cum in rounds:
        b.pre_add_hill(len(r) * 2)
        for k, rk in enumerate(r):
            b.add_hill_r([rk], us[2 * k])
            b.add_hill_r([rk], us[2 * k + 1])
        b.post_add_hill()
        assert abs(b.cum_bias - want_cum) < 1e-9, (b.cum_bias, want_cum)
    got = np.array([b.bias_value([0.05 + k * 0.095]) for k in range(31)])
    np.testing.assert_allclose(got, probes, atol=1e-9, rtol=0)
    assert int(b.state.buf_right) - int(b.state.buf_left) > 0


def _sweep_fixture():
    lines = (ORACLES / "boundary_sweep.txt").read_text().splitlines()
    runs, i = [], 0
    while i < len(lines):
        tok = lines[i].split()
        if tok[0] == "HILL":
            cum = float(lines[i + 1].split()[1])
            npr = int(lines[i + 2].split()[1])
            probes = np.array([[float(v) for v in lines[i + 3 + j].split()[1:4]]
                               for j in range(npr)])
            runs.append((float(tok[1]), cum, probes))
            i += 3 + npr
        else:
            i += 1
    return runs


def test_boundary_sweep_matches_reference(tmp_path):
    """The reference's hill_design demo: seven single hills walking x = 2..8
    across a non-periodic [2, 8] box (sigma 0.5), each on a fresh bias, as
    an outside MD engine drives the API; cum_bias, the values and the
    derivatives at the probes within 1e-9 of the compiled reference, near
    both McGovern-De Pablo walls."""
    (tmp_path / "test.edm").write_text(
        "tempering 0\nbias_per_step 1000.0\nhill_prefactor 1.0\ndimension 1\n"
        "box_low 2\nbox_high 8\nbias_spacing 0.01\nbias_sigma 0.5\n")
    runs = _sweep_fixture()
    assert len(runs) == 7
    for i, (x, cum, probes) in enumerate(runs):
        b = EDMBias(str(tmp_path / "test.edm"), 1.0, 1.0, log_hills=False, device="cpu")
        b.set_box([2.0], [8.0], [False])
        b.pre_add_hill(1)
        b.add_hill_r([x], 0.5)
        b.post_add_hill()
        assert abs(x - (2.0 + i)) < 1e-12
        assert abs(b.cum_bias - cum) < 1e-9, (x, b.cum_bias, cum)
        for q, v_ref, d_ref in probes:
            v, (d,) = b.get_force([q])
            assert abs(v - v_ref) < 1e-9, (x, q, v, v_ref)
            assert abs(d - d_ref) < 1e-9, (x, q, d, d_ref)
        b.write_bias(str(tmp_path / f"grid_{i + 1}.dat"))
        assert (tmp_path / f"grid_{i + 1}.dat").exists()


def test_restart_from_initial_bias(tmp_path):
    """Write a bias, restart with ``initial_bias_filename``: the restarted
    surface reproduces the written one (an interpolated re-read), new hills
    add on top, and cum_bias counts only the new ones (the reference keeps
    no cum_bias across a restart).  The restarted grid equals JAX's to
    1e-12."""
    base = ("tempering 0\nhill_prefactor 0.5\nbias_per_step 10\ndimension 1\n"
            "box_low 0\nbox_high 10\nbias_spacing 0.02\nbias_sigma 0.2\n")
    (tmp_path / "run1.edm").write_text(base)
    b1 = EDMBias(str(tmp_path / "run1.edm"), 1, 1, log_hills=False, device="cpu")
    b1.subdivide([0], [10], [0], [10], [True], [0])
    b1.add_hills(np.array([[3.0], [7.0]]), np.ones(2))
    biasfile = tmp_path / "BIAS1"
    b1.write_bias(str(biasfile))
    v3 = b1.bias_value([3.0])

    (tmp_path / "run2.edm").write_text(base + f"initial_bias_filename {biasfile}\n")
    b2 = EDMBias(str(tmp_path / "run2.edm"), 1, 1, log_hills=False, device="cpu")
    b2.subdivide([0], [10], [0], [10], [True], [0])
    j2 = JEDMBias(str(tmp_path / "run2.edm"), 1, 1, log_hills=False, dtype=jnp.float64)
    j2.subdivide([0], [10], [0], [10], [True], [0])
    assert_tree(b2.state, j2.state, 1e-12, "restarted state")
    assert abs(b2.bias_value([3.0]) - v3) < 1e-5
    b2.add_hills(np.array([[3.0]]), np.ones(1))
    assert b2.bias_value([3.0]) > v3 + 0.5
    assert b2.cum_bias < 1.5


def test_target_file_run_matches_jax(tmp_path):
    """An experiment-directed run: a target grid written to a file
    (``target_filename``, read without interpolation) steers the heights;
    port and JAX agree at 1e-12 over four capped, tempered rounds."""
    tspec = GridSpec.create([0.0], [3.0], [0.02], [False])
    tv = -2.0 * np.log(np.maximum(tspec.axis_points(0), 0.5))
    write_grid(Grid(values=torch.as_tensor(tv), derivs=None, spec=tspec), str(tmp_path / "T"))
    text = ("tempering 1\nbias_factor 10\nhill_prefactor 20\nbias_per_step 0.4\n"
            "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\nbias_spacing 0.02\n"
            f"bias_sigma 0.1\ntarget_filename {tmp_path / 'T'}\n")
    jb, tb = _pair(tmp_path, text, [False], log_hills=False)
    assert tb.target is not None and not tb.target.interpolate
    assert_f64(tb.params.expected_target, jb.params.expected_target, "expected_target")
    rng = np.random.default_rng(9)
    for r in range(4):
        pos = rng.uniform(0.3, 3.0, (300, 1))
        uni = rng.uniform(0, 1, 300)
        for b in (jb, tb):
            b.pre_add_hill(1200)
            for p, u in zip(pos, uni):
                b.add_hill_r(p, u)
            b.post_add_hill()
        _same(tb, jb, f"targeted round {r}")
    assert tb.cum_bias > 0 and int(tb.state.buf_right) > 0
