"""PyTorch port: the example scripts ``examples/torch_*.py`` against the
JAX examples (or the fixture that pins them), on the CPU.  The rank-spawning
scripts are in ``test_torch_examples_ranks.py``.

  - Importing every ``examples/torch_*.py`` leaves ``jax`` and ``edm_tpu``
    out of ``sys.modules`` (a subprocess); each script's entry point
    defaults to ``cuda`` and raises without a card.
  - ``torch_boundary_sweep``: the seven deposits' cum_bias, values and
    derivatives within 1e-9 of the compiled reference
    (``tests/oracles/boundary_sweep.txt``), the grid files written.  JAX's
    own sweep is ``slow``-marked and not run here.
  - ``torch_single_particle``: the host path's U and dU/dx after one hill
    and after 20 more within 1e-12 of the same ``edm_tpu.EDMBias`` calls
    (float64); the 2,000-step float32 MD run against
    ``single_particle.main``'s: cum_bias and the CV visits exactly, the
    BIAS file's values within 4e-4 * max|v| and derivatives within 2e-3 *
    max|d| (measured on this CPU: 8.6e-4 of 9.86 and 1.3e-2 of 31.9; the
    two float32 trajectories drift apart by rounding over 2,000 kT = 1
    steps).
  - ``torch_pairwise_rdf`` against ``pairwise_rdf.main(10)`` (both run one
    100-step segment, ``write_stride = max(100, n // 4)``): E[target], the
    printed cum_bias, the same files (BIAS, BIAS.ltab, HIST, target.grid;
    neither writes a HILLS file, though both name one), the histogram
    exactly, the bias and the table's energies and forces within 2e-5 of
    their column's max|.| (measured: 1.8e-5 of 9.83 and 2.4e-4 of 49.0,
    1.8e-6 and 4.9e-6 relative); at 400 steps the port's own verdict,
    the bias in the target well below the bias outside it.
  - ``torch_occupancy_diag`` at 1,000 atoms: its first ``cell_diag`` line
    equals JAX's ``cell_diag`` on JAX's state of the same lattice exactly;
    after a 10-step segment the histogram sums to the cells, the
    occupancies to the atoms, no cell overflowed and no hill was dropped.
"""

import json
import os
import pathlib
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread a worker)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
sys.path.insert(0, str(EXAMPLES))

import torch_boundary_sweep  # noqa: E402
import torch_occupancy_diag  # noqa: E402
import torch_pairwise_rdf  # noqa: E402
import torch_single_particle  # noqa: E402

SCRIPTS = sorted(p.stem for p in EXAMPLES.glob("torch_*.py"))


def imports_without_jax():
    """Import every ``examples/torch_*.py`` in a fresh interpreter; return
    the names of ``jax`` / ``edm_tpu`` modules it then holds."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(EXAMPLES)!r})\n"
            f"for name in {SCRIPTS!r}:\n"
            "    __import__(name)\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'edm_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def test_scripts_import_without_jax():
    assert SCRIPTS == ["torch_boundary_sweep", "torch_occupancy_diag", "torch_pairwise_rdf",
                       "torch_single_particle", "torch_spatial_sharded", "torch_weak_scaling"]
    assert imports_without_jax() == "[]"
    for name in SCRIPTS:
        src = (EXAMPLES / f"{name}.py").read_text()
        assert "import jax" not in src and "from jax" not in src, name
        assert "import edm_tpu\n" not in src and "from edm_tpu " not in src, name
        assert "from edm_tpu." not in src, name


@pytest.mark.parametrize("call", ["boundary_sweep", "single_particle", "pairwise_rdf",
                                  "occupancy_diag"])
def test_default_device_is_cuda(call, tmp_path, monkeypatch):
    """With no card, the default device raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.chdir(tmp_path)
    entry = {"boundary_sweep": lambda: torch_boundary_sweep.main([str(tmp_path / "out")]),
             "single_particle": torch_single_particle.main,
             "pairwise_rdf": torch_pairwise_rdf.main,
             "occupancy_diag": lambda: torch_occupancy_diag.main([])}[call]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    assert os.getcwd() == str(tmp_path) and not (tmp_path / "out").exists()


# ------------------------------------------------------------ boundary sweep


def test_boundary_sweep_matches_reference(tmp_path, capsys):
    runs = torch_boundary_sweep.read_oracle(ROOT / "tests" / "oracles" / "boundary_sweep.txt")
    assert len(runs) == 7
    grids = torch_boundary_sweep.main([str(tmp_path), "--device", "cpu"])
    assert len(grids) == 7
    for (x_ref, cum_ref, probes), (x, b) in zip(runs, grids):
        assert abs(x_ref - x) < 1e-12
        assert b.dtype == torch.float64 and b.device.type == "cpu"
        assert abs(b.cum_bias - cum_ref) < 1e-9, (x, b.cum_bias, cum_ref)
        for q, v_ref, d_ref in probes:
            v, (d,) = b.get_force([q])
            assert abs(v - v_ref) < 1e-9, (x, q, v, v_ref)
            assert abs(d - d_ref) < 1e-9, (x, q, d, d_ref)
    for i in range(7):
        assert (tmp_path / f"grid_{i + 1}.dat").exists()
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 14 and out[0].startswith("hill at x=2.0: cum_bias=1.147849")
    assert out[7].startswith("x=2.0: grid integral ~ ")


# ------------------------------------------------------------ single particle


def _grid_file(path):
    return np.loadtxt(path, comments="#", ndmin=2)


def _run_in(tmp_path, monkeypatch, sub, fn):
    """``fn()`` with new temporary directories made under ``tmp_path/sub``
    (the scripts chdir into one; the cwd is restored at teardown)."""
    d = tmp_path / sub
    d.mkdir()
    monkeypatch.setattr("tempfile.tempdir", str(d))
    random.seed(0)
    out = fn()
    (workdir,) = [p for p in d.iterdir() if p.is_dir()]
    return out, workdir


def test_single_particle_matches_jax(tmp_path, monkeypatch, capsys):
    import single_particle
    from edm_tpu.api import EDMBias as JEDMBias

    monkeypatch.chdir(tmp_path)
    port, pdir = _run_in(tmp_path, monkeypatch, "port",
                         lambda: torch_single_particle.main("cpu"))
    port_out = capsys.readouterr().out.splitlines()
    _, jdir = _run_in(tmp_path, monkeypatch, "jax", single_particle.main)
    jax_out = capsys.readouterr().out.splitlines()

    # the host path against the same EDMBias calls
    random.seed(0)
    jb = JEDMBias(str(pdir / "input.edm"), temperature=1.0, boltzmann_constant=1.0)
    jb.set_box([0], [1], [True])
    jb.add_hill([0.25])
    e1, g1 = jb.get_force([0.24])
    for _ in range(20):
        jb.add_hill([0.25])
    e2, g2 = jb.get_force([0.24])
    for got, ref in ((port["u"], e1), (port["du"], g1[0]), (port["u20"], e2),
                     (port["du20"], g2[0])):
        assert abs(got - ref) <= 1e-12 * max(1.0, abs(ref)), (got, ref)
    assert port_out[0] == jax_out[0]

    # the MD run: the counters exactly, the bias file within the drift
    st = port["state"]
    visits = st.bias.cv_hist.values.sum().item()
    assert int(st.step) == 2000 and visits == 200
    assert port_out[2] == jax_out[2] == ("2000 biased MD steps: cum_bias=50.00, "
                                         "CV visits recorded=200, bias file -> BIAS")
    assert torch.isfinite(port["energies"]).all() and port["energies"].shape == (2000,)
    got, ref = _grid_file(pdir / "BIAS"), _grid_file(jdir / "BIAS")
    assert got.shape == ref.shape == (1031, 3)
    np.testing.assert_array_equal(got[:, 0], ref[:, 0])
    assert np.abs(got[:, 1] - ref[:, 1]).max() <= 4e-4 * np.abs(ref[:, 1]).max()
    assert np.abs(got[:, 2] - ref[:, 2]).max() <= 2e-3 * np.abs(ref[:, 2]).max()


# ------------------------------------------------------------ pairwise RDF


def _ltab_rows(path):
    rows = [ln.split() for ln in path.read_text().splitlines()]
    return np.array([[float(v) for v in r] for r in rows if len(r) == 4 and r[0].isdigit()])


def _numbers(line):
    return [float(t.split("=")[-1]) for t in line.split() if "=" in t and t.split("=")[-1]]


def test_pairwise_rdf_matches_jax(tmp_path, monkeypatch, capsys):
    import pairwise_rdf

    monkeypatch.chdir(tmp_path)
    port, pdir = _run_in(tmp_path, monkeypatch, "port",
                         lambda: torch_pairwise_rdf.main(10, "cpu"))
    port_out = capsys.readouterr().out.splitlines()
    _, jdir = _run_in(tmp_path, monkeypatch, "jax", lambda: pairwise_rdf.main(10))
    jax_out = capsys.readouterr().out.splitlines()

    assert len(port_out) == len(jax_out) == 4
    assert port_out[0] == jax_out[0]  # E[target] = 1.0742
    assert abs(port["expected_target"] - float(jax_out[0].split()[-1])) <= 5e-5
    assert port_out[1].startswith("step 100: cum_bias=") and jax_out[1].startswith(
        "step 100: cum_bias=")
    (pc, pe), (jc, je) = _numbers(port_out[1]), _numbers(jax_out[1])
    assert abs(pc - jc) <= 1e-3 and abs(pe - je) <= 1e-5 * abs(je)
    assert int(port["state"].step) == 100
    files = sorted(p.name for p in pdir.iterdir())
    assert files == sorted(p.name for p in jdir.iterdir()) == [
        "BIAS", "BIAS.ltab", "HIST", "target.grid"]
    assert (pdir / "HIST").read_text() == (jdir / "HIST").read_text()
    np.testing.assert_array_equal(_grid_file(pdir / "target.grid"),
                                  _grid_file(jdir / "target.grid"))
    for got, ref in ((_grid_file(pdir / "BIAS"), _grid_file(jdir / "BIAS")),
                     (_ltab_rows(pdir / "BIAS.ltab"), _ltab_rows(jdir / "BIAS.ltab"))):
        assert got.shape == ref.shape and len(ref) >= 150
        np.testing.assert_array_equal(got[:, :-2], ref[:, :-2])  # indices, r
        for c in (-2, -1):
            assert np.abs(got[:, c] - ref[:, c]).max() <= 2e-5 * np.abs(ref[:, c]).max()
    # the verdict line: the two means, printed with 3 decimals
    jwell, jout = (float(t) for t in jax_out[2].split() if t[0].isdigit())
    assert abs(port["well"] - jwell) <= 1e-3 and abs(port["outside"] - jout) <= 1e-3
    assert port_out[2].split(":")[0] == jax_out[2].split(":")[0]


def test_pairwise_rdf_verdict(tmp_path, monkeypatch, capsys):
    """The full 400-step run: four writes, finite, the well below the
    outside (the script's own verdict)."""
    monkeypatch.chdir(tmp_path)
    port, pdir = _run_in(tmp_path, monkeypatch, "port", lambda: torch_pairwise_rdf.main(400,
                                                                                        "cpu"))
    out = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in out[1:5]] == [f"step {k}" for k in (100, 200, 300, 400)]
    st = port["state"]
    # the configuration's rounds outgrow hill_capacity 2048 (~12k candidates
    # a round), and JAX's run sets hills_truncated too: not checked
    assert int(st.step) == 400
    assert torch.isfinite(st.x).all() and torch.isfinite(st.bias.bias.grid.values).all()
    assert float(st.bias.cum_bias) > 0
    assert port["well"] < port["outside"], (port["well"], port["outside"])
    assert sorted(p.name for p in pdir.iterdir()) == ["BIAS", "BIAS.ltab", "HIST",
                                                      "target.grid"]


# ------------------------------------------------------------ occupancy


def _jax_lattice_diag(n, kcaps):
    """The JAX script's lattice state at ``n`` atoms (its construction,
    bench_pairwise's) and JAX's ``cell_diag`` of it."""
    import jax
    import jax.numpy as jnp

    from edm_tpu import bias as JB
    from edm_tpu.models import pair_edm
    from edm_tpu.models.cells import CellSpec
    from edm_tpu.models.pair_edm_cells import cell_diag, init_cell_state
    from edm_tpu.utils.config import parse_edm_text

    cfg = parse_edm_text("tempering 1\nbias_factor 10\nhill_prefactor 0.1\nbias_per_step 1.0\n"
                         "hill_density 250\ndimension 1\nbox_low 0\nbox_high 3.0\n"
                         "bias_spacing 0.02\nbias_sigma 0.1\n")
    _, bias_state = JB.subdivide(cfg, 1.0, 1.0, [0], [3.0], [0], [3.0], [False], [0],
                                 dtype=jnp.float32)
    side = int(np.ceil(n ** (1 / 3)))
    pts = (np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1)
           .reshape(-1, 3)[:n] * 1.26 + 0.63)
    core = pair_edm.init_state(bias_state, jnp.asarray(pts, jnp.float32),
                               jax.random.PRNGKey(0), n_est=n * 40, pair_lookup="interp")
    spec = CellSpec.create([side * 1.26] * 3, cutoff=3.05, n_atoms=n)
    return cell_diag(spec, init_cell_state(spec, core, with_ids=False), kernel_caps=kcaps)


def test_occupancy_diag_matches_jax(capsys):
    n = 1000
    lines, state = torch_occupancy_diag.main(["--n", str(n), "--segments", "1", "--steps",
                                              "10", "--device", "cpu"])
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
           if ln.startswith("{")]
    assert out == json.loads(json.dumps(lines)) and len(lines) == 2
    first = dict(lines[0])
    assert first.pop("at") == "init (step 0, lattice)"
    assert first == _jax_lattice_diag(n, (16, 24, 28))
    last = lines[-1]
    assert last["at"] == "step 10" and int(state.core.step) == 10
    hist = np.asarray(last["occ_hist"])
    assert hist.sum() == last["n_cells"] == 64
    assert (hist * np.arange(len(hist))).sum() == n
    assert not last["cell_overflow"] and not bool(state.core.hills_truncated)
    assert int(state.core.bias.steps) == 1  # the cycle's one hill step
