"""Counter-based uniform hashing for hill acceptance and thermostat noise,
bitwise the JAX package's ``edm_tpu/ops/hashrng.py``.

Each (row, column) draw is a murmur3-finalizer hash of the two uint32
round seeds, the row and the column: deterministic in (seeds, row, col),
so a row range can be redrawn exactly (count pass and extract pass).

``uniform_rows_cols`` and ``normal_rows_cols`` launch the CUDA kernel
``hash_rows`` (``csrc/hashrng.cu``) on a CUDA device: the hash in native
uint32 arithmetic, a warp a row for wide rows and a thread a row or an
element for narrow ones, one launch a call, the seeds passed as launch
arguments.  On the CPU they run their plain versions, ``*_ref``: PyTorch
has no uint32 arithmetic, so there the hash runs in int64 with every
product split into 16-bit halves (each below 2^48) and masked to 32 bits.
Each wrapper's ``launches`` counts its kernel launches.
"""

from __future__ import annotations

import torch

from .kernel_args import library, on_card, raise_on
from .prng import random_bits

_GOLD = 0x9E3779B9
_MUR1 = 0x85EBCA6B
_MUR2 = 0xC2B2AE35
_M32 = 0xFFFFFFFF


def seeds_from_key(key):
    """Two uint32 seeds (Python ints) from a Threefry key, as
    ``jax.random.bits(key, (2,), uint32)`` draws them."""
    b = random_bits(key, 2)
    return int(b[0]), int(b[1])


def _mulmod(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for 0 <= h < 2^32 without int64 overflow."""
    lo = (h * (m & 0xFFFF)) & _M32
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def uniform_rows_cols_ref(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """Plain version of ``uniform_rows_cols``: the hash in int64."""
    s0, s1 = (int(s) & _M32 for s in seeds)
    r = rows.to(torch.int64)[:, None]
    c = torch.arange(n_cols, dtype=torch.int64, device=rows.device)[None, :]
    h = (s0 + _mulmod(r & _M32, _GOLD) + _mulmod(c, _MUR1)) & _M32
    h = h ^ s1
    h = h ^ (h >> 16)
    h = _mulmod(h, _MUR1)
    h = h ^ (h >> 13)
    h = _mulmod(h, _MUR2)
    h = h ^ (h >> 16)
    return h.to(dtype) * 2.3283064365386963e-10


def normal_rows_cols_ref(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """Plain version of ``normal_rows_cols``."""
    u = uniform_rows_cols_ref(seeds, rows, 2 * n_cols, dtype)
    u1 = u[:, :n_cols] + 2.0**-33
    u2 = u[:, n_cols:]
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * 3.14159265358979323846) * u2)


def _hash_rows(seeds, rows: torch.Tensor, n_cols: int, dtype, normal: bool, what: str):
    """``hash_rows`` on ``rows``' CUDA device: (the draws, whether the
    kernel was launched; an empty result launches nothing)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} draws float32 or float64 on the card, not {dtype}")
    if rows.dim() != 1:
        raise ValueError(f"{what}: rows must be 1-D, got shape {tuple(rows.shape)}")
    out = torch.empty((rows.shape[0], n_cols), dtype=dtype, device=rows.device)
    if out.numel() == 0:
        return out, False
    lib, _ = library()
    r = rows.to(torch.int64).contiguous()
    s0, s1 = (int(s) & _M32 for s in seeds)
    code = lib.hash_rows_launch(s0, s1, r.data_ptr(), r.shape[0], n_cols, int(normal),
                                int(dtype == torch.float64), out.data_ptr(),
                                torch.cuda.current_stream(rows.device).cuda_stream)
    raise_on(lib, code, what)
    return out, True


def uniform_rows_cols(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """(R,) row ids (taken mod 2^32) -> (R, n_cols) uniforms in [0, 1),
    bitwise the JAX stream for the same seeds, rows and columns: the
    ``hash_rows`` kernel on a CUDA device, the plain version on the CPU."""
    if not on_card(rows.device, "uniform_rows_cols"):
        return uniform_rows_cols_ref(seeds, rows, n_cols, dtype)
    out, launched = _hash_rows(seeds, rows, n_cols, dtype, False, "uniform_rows_cols")
    uniform_rows_cols.launches += launched
    return out


def normal_rows_cols(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """(R,) row ids -> (R, n_cols) standard normals by Box-Muller from two
    column streams; u1 is offset by 2^-33 so log(u1) stays finite.  The
    uniforms are bitwise the JAX ones; log/sqrt/cos agree to f32 rounding,
    not bitwise.  The ``hash_rows`` kernel on a CUDA device (the same libm
    calls as PyTorch's elementwise kernels), the plain version on the CPU."""
    if not on_card(rows.device, "normal_rows_cols"):
        return normal_rows_cols_ref(seeds, rows, n_cols, dtype)
    out, launched = _hash_rows(seeds, rows, n_cols, dtype, True, "normal_rows_cols")
    normal_rows_cols.launches += launched
    return out


uniform_rows_cols.launches = 0
normal_rows_cols.launches = 0
