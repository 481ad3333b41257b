"""PyTorch port: every public name of the JAX package has its counterpart.

For each module of ``edm_tpu`` (found by its file, so that a module that
fails to import fails its case) except the two Pallas modules, whose
kernels the port carries in ``ops/cellforce.py``, ``ops/deposit.py`` and
``csrc/``: the port's module of the same path imports, exports every name
of the JAX module's ``__all__`` in an ``__all__`` of its own, and has every
public function and class that the JAX module defines (not those it only
imports).  A package's ``__init__`` counts as its module, so that
``from edm_tpu_torch.utils import save_state`` works as it does for JAX.
"""

import importlib
import inspect
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PALLAS = {"edm_tpu.ops.cellforce_pallas", "edm_tpu.ops.deposit_pallas"}


def _jax_modules():
    names = []
    for path in sorted((ROOT / "edm_tpu").rglob("*.py")):
        parts = path.relative_to(ROOT).with_suffix("").parts
        if parts[-1] == "__init__":
            parts = parts[:-1]
        name = ".".join(parts)
        if name not in PALLAS:
            names.append(name)
    return names


MODULES = _jax_modules()


def test_the_walk_sees_the_package():
    assert len(MODULES) >= 30
    assert {"edm_tpu", "edm_tpu.grid", "edm_tpu.ops", "edm_tpu.utils",
            "edm_tpu.parallel.spatial"} <= set(MODULES)


@pytest.mark.parametrize("name", MODULES)
def test_public_names_have_counterparts(name):
    jmod = importlib.import_module(name)
    tmod = importlib.import_module("edm_tpu_torch" + name[len("edm_tpu"):])
    exported = list(getattr(jmod, "__all__", ()))
    if exported:
        assert hasattr(tmod, "__all__"), f"{tmod.__name__} has no __all__"
        missing = [n for n in exported if n not in tmod.__all__]
        assert not missing, f"{tmod.__name__}.__all__ lacks {missing}"
    defined = [n for n, v in vars(jmod).items()
               if not n.startswith("_") and (inspect.isfunction(v) or inspect.isclass(v))
               and v.__module__ == name]
    missing = [n for n in exported + defined if not hasattr(tmod, n)]
    assert not missing, f"{tmod.__name__} lacks {missing}"


def test_repaired_names_behave():
    import numpy as np
    import torch

    import edm_tpu.grid as jgrid
    from edm_tpu_torch.grid import int_floor
    from edm_tpu_torch.ops import grid_value_deriv
    from edm_tpu_torch.ops.interp import grid_value_deriv as gvd
    from edm_tpu_torch.utils import EDMError, edm_error, load_state, save_state
    from edm_tpu_torch.utils.checkpoint import load_state as ls, save_state as ss
    from edm_tpu_torch.utils.errors import EDMError as E

    x = np.array([-2.5, -1.0, -0.25, -0.0, 0.0, 0.75, 3.0, 1e6 + 0.5])
    got = int_floor(torch.as_tensor(x))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgrid.int_floor(x)))
    assert grid_value_deriv is gvd and load_state is ls and save_state is ss and EDMError is E
    with pytest.raises(EDMError, match=r"\[EDM:here\] bad"):
        edm_error("bad", "here")
