"""PyTorch port: Threefry keys and the counter-hash streams, bitwise.

``edm_tpu_torch.ops.prng`` reproduces ``jax.random.PRNGKey`` / ``split`` /
``bits`` (threefry2x32, partitionable) on the host; ``ops.hashrng`` the
murmur counter hash in int64 arithmetic.  Uniforms are bitwise; normals
agree to float32 rounding (log/cos differ between XLA and PyTorch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread)
from edm_tpu.ops import hashrng as jh
from edm_tpu_torch.ops import hashrng as th
from edm_tpu_torch.ops import prng


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**33 + 5])
def test_threefry_key_chain_bitwise(seed):
    k, kp = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(k), kp)
    for _ in range(4):  # the host's chain: split -> (carry, sub)
        for n in (2, 3):
            np.testing.assert_array_equal(np.asarray(jax.random.split(k, n)), prng.split(kp, n))
            np.testing.assert_array_equal(
                np.asarray(jax.random.bits(k, (n,), jnp.uint32)), prng.random_bits(kp, n)
            )
        assert th.seeds_from_key(kp) == tuple(int(s) for s in jh.seeds_from_key(k))
        k, _ = jax.random.split(k)
        kp, _ = prng.split(kp)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_uniform_rows_cols_bitwise(dtype):
    rng = np.random.default_rng(3)
    rows = np.concatenate([np.arange(64), rng.integers(0, 2**31 - 1, 200)]).astype(np.int32)
    for seeds in ((0, 0), (0xFFFFFFFF, 0x9E3779B9), tuple(rng.integers(0, 2**32, 2))):
        ref = jh.uniform_rows_cols(jnp.asarray(seeds, jnp.uint32), jnp.asarray(rows), 37, dtype)
        out = th.uniform_rows_cols(seeds, torch.as_tensor(rows), 37,
                                   torch.float32 if dtype == jnp.float32 else torch.float64)
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_normal_rows_cols_f32():
    rows = np.arange(0, 3000, 7, dtype=np.int32)
    seeds = (123456789, 987654321)
    ref = np.asarray(jh.normal_rows_cols(jnp.asarray(seeds, jnp.uint32), jnp.asarray(rows), 3,
                                         jnp.float32))
    out = th.normal_rows_cols(seeds, torch.as_tensor(rows), 3, torch.float32).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-6)
