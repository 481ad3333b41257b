"""What every CUDA wrapper of ``ops/`` does around its launch: pick the
kernel or the plain version by device, load the kernel library, check the
tensors it hands over, pack float32 constants, and raise on a launch
error."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .._build import limits, load_library


def library():
    """The kernel library, built at first use, and its compiled limits."""
    return load_library(), limits


def on_card(device, what: str) -> bool:
    """True on a CUDA device (the wrapper launches its kernel), False on the
    CPU (it runs its plain version); any other device raises."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {device}")
    return device.type == "cuda"


def check(t: torch.Tensor, name: str, shape, device, dtype=torch.float32):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {str(dtype).removeprefix('torch.')}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def f32(vals):
    return (ctypes.c_float * len(vals))(*[float(np.float32(v)) for v in vals])


def raise_on(lib, code: int, what: str):
    if code != 0:
        raise RuntimeError(f"{what} launch failed: {lib.edm_error_string(code).decode()}")
