"""Threefry-2x32 keys on the host, and ``jax.random`` draws on the card,
as JAX 0.9 computes them.

The JAX hosts thread a ``jax.random`` key through the step: one split per
step for the thermostat, one per hill round for acceptance, and each
subkey becomes two uint32 seeds of the counter hash (``ops/hashrng``).
Reproducing ``PRNGKey``, ``split`` and ``bits`` bitwise gives the port the
same key chain, so a run from ``PRNGKey(0)`` draws the same noise and the
same acceptance uniforms as the JAX host.  The key is a (2,) uint32 numpy
array on the host; it reaches the device only as the two seeds, so it
costs no device sync.

JAX 0.9 defaults to ``jax_threefry_partitionable``: ``split(key, n)[i]``
and ``bits(key, (n,))[i]`` both hash the 64-bit counter ``i`` (high word,
low word) under ``key``; ``split`` keeps both output words, 32-bit
``bits`` returns their xor, 64-bit bits the first word over the second.

``fold_in(key, i)`` hashes the counter (0, i) under ``key`` and keeps both
words, as ``jax.random.fold_in`` does for a 32-bit ``i``.  ``threefry_rows``
draws one ``uniform(fold_in(key, row), (n,))`` per entry of a device tensor
of row ids, in one launch of a CUDA kernel (``csrc/threefry.cu``) that folds
each row in itself: the blocked pair host's per-row acceptance streams
(``models/pair_edm_blocked``), whose pass-2 rows are computed on the card.

``uniform`` and ``normal`` draw as ``jax.random.uniform`` and
``jax.random.normal`` do for float32 and float64: the bits of every element
come from ``threefry_bits``, a CUDA kernel (``csrc/threefry.cu``) on a CUDA
device and this module's numpy chain (its plain version) on the CPU; only
the key's two words reach the kernel, as arguments, so a draw costs no copy
and no sync.  A uniform is the mantissa trick, ``bits >> 9`` (float32) or
``>> 12`` (float64) under the exponent of 1.0, minus 1: bitwise JAX's.  A
normal is ``sqrt(2) erfinv(u)`` with ``u`` uniform on
``[nextafter(-1, 0), 1)``: ``u`` is bitwise JAX's, and ``erfinv`` is
PyTorch's, not XLA's polynomial, so the normals differ from JAX's by a few
ulps (``tests/test_torch_coord.py`` holds the bound).
"""

from __future__ import annotations

import numpy as np
import torch

from ..grid import device_const

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays; the
    key's two words may be arrays that broadcast against the counters."""
    with np.errstate(over="ignore"):
        k0, k1 = (np.asarray(k, np.uint32) for k in (key[0], key[1]))
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
        x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """Raw (2,) uint32 key of an integer seed (``jax.random.PRNGKey``)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    i = np.arange(n, dtype=np.uint64)
    return (i >> np.uint64(32)).astype(np.uint32), (i & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) uint32 subkeys (``jax.random.split``)."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """(2,) uint32 key of ``jax.random.fold_in(key, data)`` for a 32-bit
    ``data``: the block of the counter (0, data) under ``key``."""
    b0, b1 = threefry2x32(key, np.uint32(0), np.uint32(int(data) & 0xFFFFFFFF))
    return np.array([b0, b1], np.uint32)


def random_bits(key, n: int) -> np.ndarray:
    """(n,) uint32 random bits (``jax.random.bits(key, (n,), uint32)``)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def _bits_ref(key, n: int, wide: bool) -> torch.Tensor:
    """Plain version of ``threefry_bits``: the numpy chain, as int32 bit
    patterns (wide: (n, 2), the first word, then the second)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    out = np.stack([b0, b1], axis=1) if wide else b0 ^ b1
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int32))


def threefry_bits(key, n: int, device, wide: bool = False) -> torch.Tensor:
    """The Threefry-2x32 blocks of counters 0..n-1 under ``key`` on
    ``device``, as int32 bit patterns: their xor (n,) (``random_bits``) or,
    ``wide``, both words (n, 2).  The CUDA kernel on a CUDA device, the
    numpy chain on the CPU.  ``launches`` counts kernel launches."""
    device = torch.device(device)
    if device.type == "cpu":
        return _bits_ref(key, n, wide)
    if device.type != "cuda":
        raise ValueError(f"no Threefry kernel for device {device}")
    from .kernel_args import library, raise_on

    lib, _ = library()
    out = torch.empty((n, 2) if wide else (n,), dtype=torch.int32, device=device)
    code = lib.threefry_bits_launch(int(key[0]), int(key[1]), n, int(wide), out.data_ptr(),
                                    torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, code, "threefry_bits")
    threefry_bits.launches += 1
    return out


threefry_bits.launches = 0


def _mantissa_uniform(b0, b1, f64: bool) -> np.ndarray:
    """The uniforms of Threefry blocks (b0, b1), the mantissa trick in
    numpy: the xor's top 23 bits (float32) or the 64-bit word's top 52
    (float64) under the exponent of 1.0, minus 1."""
    if f64:
        w = (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
        m = (w >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return m.view(np.float64) - 1.0
    m = ((b0 ^ b1) >> np.uint32(9)) | np.uint32(0x3F800000)
    return m.view(np.float32) - np.float32(1.0)


def _rows_ref(key, row_ids, n: int, dtype) -> torch.Tensor:
    """Plain version of ``threefry_rows``: the numpy chain, on the CPU."""
    rows = np.asarray(row_ids.cpu() if isinstance(row_ids, torch.Tensor) else row_ids,
                      np.int64).astype(np.uint32)
    rk0, rk1 = threefry2x32(key, np.zeros_like(rows), rows)  # fold_in, per row
    hi, lo = _counters(n)
    b0, b1 = threefry2x32((rk0[:, None], rk1[:, None]), hi[None, :], lo[None, :])
    return torch.from_numpy(_mantissa_uniform(b0, b1, dtype == torch.float64))


def threefry_rows(key, row_ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(R, n) uniforms: row ``r`` is ``jax.random.uniform(fold_in(key,
    row_ids[r]), (n,), dtype)``, bitwise, in float32 or float64, on
    ``row_ids``' device.  ``row_ids`` (R,) int32 or int64 row ids (0 <= id <
    2**32).  The CUDA kernel on a CUDA device, in one launch; the numpy
    chain on the CPU.  ``launches`` counts kernel launches."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"threefry_rows draws float32 or float64, not {dtype}")
    device = row_ids.device
    if device.type == "cpu":
        return _rows_ref(key, row_ids, n, dtype)
    if device.type != "cuda":
        raise ValueError(f"no Threefry kernel for device {device}")
    from .kernel_args import library, raise_on

    if row_ids.dim() != 1:
        raise ValueError(f"row_ids must be 1-D, got shape {tuple(row_ids.shape)}")
    lib, _ = library()
    rows = row_ids.to(torch.int32).contiguous()
    out = torch.empty((rows.shape[0], n), dtype=dtype, device=device)
    code = lib.threefry_rows_launch(int(key[0]), int(key[1]), rows.data_ptr(), rows.shape[0], n,
                                    int(dtype == torch.float64), out.data_ptr(),
                                    torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, code, "threefry_rows")
    threefry_rows.launches += 1
    return out


threefry_rows.launches = 0


def uniform(key, shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1), bitwise: the
    mantissa trick on each element's bits."""
    n = int(np.prod(shape))
    if dtype == torch.float32:
        b = threefry_bits(key, n, device)
        m = torch.bitwise_and(torch.bitwise_right_shift(b, 9), 0x7FFFFF)
        f = torch.bitwise_or(m, 0x3F800000).view(torch.float32) - 1.0
    elif dtype == torch.float64:
        w = threefry_bits(key, n, device, wide=True).to(torch.int64)
        hi, lo = w[:, 0] & 0xFFFFFFFF, w[:, 1] & 0xFFFFFFFF
        m = torch.bitwise_or(torch.bitwise_left_shift(hi, 20), torch.bitwise_right_shift(lo, 12))
        f = torch.bitwise_or(m, 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    return f.reshape(tuple(shape))


def normal(key, shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv(u), u on
    [nextafter(-1, 0), 1) from the same bits (JAX's ``_normal_real``)."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(npd(-1.0), npd(0.0))
    f = uniform(key, shape, dtype, device)
    lo_t = device_const(float(lo), f.device, dtype)
    span = device_const(float(npd(1.0) - lo), f.device, dtype)  # rounded in dtype, as JAX
    u = torch.maximum(lo_t, f * span + lo_t)
    return float(npd(np.sqrt(2))) * torch.erfinv(u)
