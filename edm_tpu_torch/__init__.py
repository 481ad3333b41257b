"""edm_tpu_torch — the PyTorch/CUDA port of ``edm_tpu`` for NVIDIA Hopper.

Module for module the counterpart of the JAX package (``grid``, ``gauss``,
``bias``, ``api``, ``ops/…``, ``models/…``, ``utils/…``).  Plain tensor
code is PyTorch; each Pallas TPU kernel on a ported path is a hand-written
CUDA kernel in ``csrc/``, built at first use by ``_build.py``, with a plain
PyTorch version beside it that runs on CPU tensors.  The text formats'
host-side formatters are C++ in ``native/``, also built at first use.  The
package imports torch and numpy, never jax; importing it builds nothing.
"""

import torch

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
    "checked_device",
]


def checked_device(device) -> torch.device:
    """``device`` as a torch.device; "cuda" with no card raises, so that a
    run asked of the card does not carry on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return device
