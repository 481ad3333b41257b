"""PyTorch port: the example scripts that spawn ranks
(``examples/torch_spatial_sharded.py``, ``examples/torch_weak_scaling.py``)
against the JAX examples, on gloo ranks on the CPU.

  - Importing every ``examples/torch_*.py`` leaves ``jax`` and ``edm_tpu``
    out of ``sys.modules`` (a subprocess).
  - ``torch_spatial_sharded`` on its 8 ranks against
    ``spatial_sharded.main`` on conftest's 8-device mesh: the two runs
    agree, so they are held to stated tolerances.  Every rank's cum_bias
    and round count equal rank 0's; the four segment lines' energy and
    cum_bias within the JAX script's printed 4 decimals (and 1e-5
    relative); ``BIAS_GLOBAL`` (800 points) with the values within 5e-6 *
    max|v| and the derivatives within 1e-5 * max|d| (measured: 3.6e-6 of
    6.66 and 2.7e-5 of 15.1); the eight ``HILLS_<r>`` with the same rows,
    step, type and counter exactly, every number within 1e-6 * max(1,
    |x|) (measured: the eighth decimal).
  - ``torch_weak_scaling.main`` on 1, 2 and 2 x 2 ranks: each row has the
    JAX script's keys (read from the JAX source), ``cells_per_dev_xyz``
    equals the JAX script's divmod over JAX's ``CellSpec`` of the same
    lattice, and the overhead lines follow; ``run`` itself raises on an
    overflowed cell table, a dropped hill or a non-finite position.
"""

import ast
import sys

import numpy as np
import pytest

import _torch_parity  # noqa: F401  (one torch thread a worker)
from test_torch_examples import EXAMPLES, _grid_file, imports_without_jax

sys.path.insert(0, str(EXAMPLES))

import torch_spatial_sharded  # noqa: E402
import torch_weak_scaling  # noqa: E402


def test_scripts_import_without_jax():
    assert imports_without_jax() == "[]"


def test_default_device_is_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for entry in (torch_spatial_sharded.main, torch_weak_scaling.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry()


def _hills_rows(path):
    return [ln.split() for ln in path.read_text().splitlines()]


def test_spatial_sharded_matches_jax(tmp_path, monkeypatch, capsys):
    import spatial_sharded

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))  # the ranks' store file
    res = torch_spatial_sharded.main("cpu")
    monkeypatch.chdir(tmp_path / "jax")
    assert spatial_sharded.N_DEV == torch_spatial_sharded.N_DEV == 8
    spatial_sharded.main()
    jax_out = capsys.readouterr().out.splitlines()

    assert [r["rank"] for r in res] == list(range(8))
    r0 = res[0]
    for r in res[1:]:
        assert r["segments"] == r0["segments"] and r["cum"] == r0["cum"]
        assert r["rounds"] == r0["rounds"]
        np.testing.assert_array_equal(r["vg"], r0["vg"])
    assert r0["rounds"] == 20 and not any(r["truncated"] for r in res)
    assert sum(int(r["valid"].sum()) for r in res) == 64
    seg_lines = [ln for ln in jax_out if ln.startswith("segment ")]
    assert len(seg_lines) == len(r0["segments"]) == 4
    for ln, (e, cum) in zip(seg_lines, r0["segments"]):
        je, jcum = float(ln.split()[3]), float(ln.split()[5])
        assert abs(e - je) <= 5e-5 + 1e-5 * abs(je), (e, je)
        assert abs(cum - jcum) <= 5e-5 + 1e-5 * abs(jcum), (cum, jcum)

    port, ref = (_grid_file(tmp_path / d / "BIAS_GLOBAL") for d in ("port", "jax"))
    assert port.shape == ref.shape == (800, 3)
    np.testing.assert_array_equal(port[:, 0], ref[:, 0])
    assert np.abs(port[:, 1] - ref[:, 1]).max() <= 5e-6 * np.abs(ref[:, 1]).max()
    assert np.abs(port[:, 2] - ref[:, 2]).max() <= 1e-5 * np.abs(ref[:, 2]).max()
    np.testing.assert_allclose(port[:, 1], r0["vg"], rtol=0, atol=1e-6 * r0["vg"].max())
    for d in range(8):
        got, want = (_hills_rows(tmp_path / s / f"HILLS_{d}") for s in ("port", "jax"))
        assert len(got) == len(want) > 0, d
        for g, w in zip(got, want):
            assert g[:3] == w[:3] and len(g) == len(w), (d, g, w)
            a, b = np.array(g[3:], float), np.array(w[3:], float)
            assert (np.abs(a - b) <= 1e-6 * np.maximum(1.0, np.abs(b))).all(), (d, g, w)


def _jax_run_keys():
    """The keys of the dict the JAX script's ``run`` returns, from its
    source (running it would compile the sharded steps)."""
    src = (EXAMPLES / "weak_scaling_cpu_mesh.py").read_text()
    (fn,) = [n for n in ast.parse(src).body if isinstance(n, ast.FunctionDef) and n.name == "run"]
    (ret,) = [n for n in ast.walk(fn) if isinstance(n, ast.Return)]
    return [k.value for k in ret.value.keys]


def test_weak_scaling_runs(tmp_path, monkeypatch, capsys):
    import json

    from edm_tpu.models.cells import CellSpec

    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    configs = ((1, None), (2, None), (4, (2, 2)))
    rows = torch_weak_scaling.main("cpu", configs=configs)
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    keys = _jax_run_keys()
    assert keys == ["mode", "n_dev", "atoms", "cells_per_dev_xyz", "steps_per_sec",
                    "sec_per_step"]
    assert [r["mode"] for r in rows] == ["slab", "slab", "brick 2x2"]
    for (n, grid), row, line in zip(configs, rows, out):
        assert list(line) == keys and line == {k: row[k] for k in keys}
        px, py, pz = (tuple(grid) + (1,))[:3] if grid else (n, 1, 1)
        side = torch_weak_scaling.SIDE_PER_DEV
        nx, ny, nz = side * px, side * py, side * pz
        a = torch_weak_scaling.A
        spec = CellSpec.create([nx * a, ny * a, nz * a], cutoff=3.05, n_atoms=nx * ny * nz)
        want = []
        for n_ax, p_ax in zip(spec.ncells, (px, py, pz)):  # the JAX script's divmod
            q, rem = divmod(n_ax, p_ax)
            want.append([q + (d < rem) for d in range(p_ax)])
        assert row["n_dev"] == n and row["atoms"] == nx * ny * nz
        assert row["cells_per_dev_xyz"] == want, (row, want)
        assert row["steps_per_sec"] > 0 and row["sec_per_step"] > 0
    assert [list(ln) for ln in out[3:]] == [["mode", "n_dev", "agg_overhead"]] * 2
    assert [ln["agg_overhead"] for ln in out[3:]] == [r["agg_overhead"] for r in rows[1:]]
