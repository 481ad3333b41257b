"""Threefry-2x32 keys on the host, as JAX 0.9 computes them.

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
``bits`` returns their xor.
"""

from __future__ import annotations

import numpy as np

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block function (20 rounds) on uint32 arrays."""
    with np.errstate(over="ignore"):
        k0, k1 = np.uint32(key[0]), np.uint32(key[1])
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


def random_bits(key, n: int) -> np.ndarray:
    """(n,) uint32 random bits (``jax.random.bits(key, (n,), uint32)``)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1
