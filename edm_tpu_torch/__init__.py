"""edm_tpu_torch — the PyTorch/CUDA port of ``edm_tpu`` for NVIDIA Hopper.

Module for module the counterpart of the JAX package (``grid``, ``gauss``,
``bias``, ``ops/…``, ``models/…``, ``utils/…``).  Plain tensor code is
PyTorch; each Pallas TPU kernel on a ported path is a hand-written CUDA
kernel in ``csrc/``, built at first use by ``_build.py``, with a plain
PyTorch version beside it that runs on CPU tensors.  The package imports
torch and numpy, never jax.
"""
