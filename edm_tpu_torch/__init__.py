"""edm_tpu_torch — the PyTorch/CUDA port of ``edm_tpu`` for NVIDIA Hopper.

Module for module the counterpart of the JAX package (``grid``, ``gauss``,
``bias``, ``api``, ``ops/…``, ``models/…``, ``utils/…``).  Plain tensor
code is PyTorch; each Pallas TPU kernel on a ported path is a hand-written
CUDA kernel in ``csrc/``, built at first use by ``_build.py``, with a plain
PyTorch version beside it that runs on CPU tensors.  The text formats'
host-side formatters are C++ in ``native/``, also built at first use.  The
package imports torch and numpy, never jax; importing it builds nothing.
"""

from .grid import Grid, GridSpec, grid_points
from .gauss import GaussGrid, GaussSpec
from .utils.errors import EDMError, edm_error
from .api import EDMBias

__all__ = [
    "Grid",
    "GridSpec",
    "GaussGrid",
    "GaussSpec",
    "grid_points",
    "EDMBias",
    "EDMError",
    "edm_error",
]
