"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole), and the reference loads nothing of the
port."""

import ast
import os
import subprocess
import sys

from edmbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "edmbench")
REFERENCE_SIDE = ("kinds/pair_cells/reference.py", "kinds/pair_cells/check.py",
                  "kinds/pair_cells/work_count.py", "check.py", "peaks.py", "trace.py",
                  "lattice.py")


def imported(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_sources_import_no_jax():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                mods = imported(os.path.join(dirpath, f))
                assert not mods & {"jax", "jaxlib", "flax", "edm_tpu", "bench", "chip_smoke"}, f


def test_reference_side_imports_no_port():
    for f in REFERENCE_SIDE:
        assert "edm_tpu_torch" not in imported(os.path.join(BENCH, f)), f


CODE = r"""
import sys, json
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from edmbench import run
from edmbench.tests.conftest import tiny
cfg, mix = tiny("pairbench")
res = run.run_cell("pairbench", cfg, mix, 9, 0.2, True, device="cpu")
assert res["checks"][0], res["checks"][2]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_run_loads_no_jax():
    p = subprocess.run([sys.executable, "-c", CODE.format(root=ROOT)], capture_output=True,
                       text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    import json
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not top & {"jax", "jaxlib", "flax", "edm_tpu"}
    assert "edm_tpu_torch" in top


def test_reference_loads_no_port():
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import edmbench.kinds.pair_cells.reference, edmbench.kinds.pair_cells.check, "
            "edmbench.kinds.pair_cells.work_count, edmbench.check, edmbench.trace; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=300)
    assert p.returncode == 0, p.stderr
    assert "edm_tpu_torch" not in p.stdout and "'jax'" not in p.stdout
