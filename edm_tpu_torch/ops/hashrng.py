"""Counter-based uniform hashing for hill acceptance and thermostat noise,
bitwise the JAX package's ``edm_tpu/ops/hashrng.py``.

Each (row, column) draw is a murmur3-finalizer hash of the two uint32
round seeds, the row and the column: deterministic in (seeds, row, col),
so a row range can be redrawn exactly (count pass and extract pass).
PyTorch has no uint32 arithmetic, so the hash runs in int64 with every
product split into 16-bit halves (each below 2^48) and masked to 32 bits.
"""

from __future__ import annotations

import torch

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


def uniform_rows_cols(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """(R,) row ids -> (R, n_cols) uniforms in [0, 1), bitwise the JAX
    stream for the same seeds, rows and columns."""
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


def normal_rows_cols(seeds, rows: torch.Tensor, n_cols: int, dtype) -> torch.Tensor:
    """(R,) row ids -> (R, n_cols) standard normals by Box-Muller from two
    column streams; u1 is offset by 2^-33 so log(u1) stays finite.  The
    uniforms are bitwise the JAX ones; log/sqrt/cos agree to f32 rounding,
    not bitwise."""
    u = uniform_rows_cols(seeds, rows, 2 * n_cols, dtype)
    u1 = u[:, :n_cols] + 2.0**-33
    u2 = u[:, n_cols:]
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos((2.0 * 3.14159265358979323846) * u2)
