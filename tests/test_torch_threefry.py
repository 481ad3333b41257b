"""PyTorch port: the Threefry kernels' launch plans and plain versions.

The two kernels of ``csrc/threefry.cu`` run only on the card
(``tests/test_torch_gpu.py``).  What they rest on is held here on the CPU:

  - the launch plans ``prng.rows_plan`` / ``rows_slot`` (``tf_rows``) and
    ``prng.draw_plan`` / ``draw_slot`` (``tf_bits``): every (block, thread,
    row-tile iteration) of a plan's grid is enumerated as the kernel walks
    it, and every element of the output is found written exactly once, each
    16-byte store on a 16-byte boundary and wholly inside its row;
  - the plain versions against ``jax.random``: ``_rows_ref`` (int64 row
    ids up to 2^32 - 1, narrowed as ``fold_in`` takes them, and repeated
    ids as pass 2's padding rows) bitwise, and ``uniform`` / ``normal`` on
    the CPU at the draw shapes ``test_torch_coord.py`` does not cover:
    uniforms bitwise, normals within 1e-5 (float32) and 2e-12 (float64)
    relative, as there (PyTorch's erfinv is not XLA's polynomial);
  - PyTorch's CPU erfinv, which the plain normals call, within 1 ulp of the
    exact value (mpmath) at the arguments a Threefry normal takes, the
    extremes included: with CUDA's documented 2 (erfinvf) and 5 (erfinv)
    ulps and the product by sqrt(2) it sets the card's bound,
    ``chip_smoke.TF_NORMAL_ULPS``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from edm_tpu_torch.ops import prng

ROWS = [(R, n) for R in (1, 3, 500, 2048) for n in (1, 3, 5, 448, 864, 10000, 10001)]
ROWS += [(70000, n) for n in (1, 3, 5)]


def _rows_cover(R: int, n: int, f64: bool):
    """Every element of an (R, n) ``threefry_rows`` output written once by
    the threads of ``rows_plan``: the blocks' row tiles as the kernel's
    strided y loop visits them, every slot of the x grid; checks the plan's
    shape and each store's alignment."""
    plan = prng.rows_plan(R, n, f64)
    (gx, gy), (tx, tr), vec = plan.grid, plan.block, plan.vec
    assert tx * tr == prng.THREADS and 4 <= tx <= prng.THREADS and tr <= prng.THREADS // 4
    assert 1 <= gy <= prng.ROWS_MAX_TILES and gx * tx >= plan.slots == n // vec + 2
    assert vec * (8 if f64 else 4) == 16
    r0 = np.concatenate([np.arange(by * tr, R, gy * tr) for by in range(gy)])
    rows = (r0[:, None] + np.arange(tr)[None, :]).ravel()
    rows = rows[rows < R]
    assert np.array_equal(np.sort(rows), np.arange(R))  # each row in one block, once
    slots = np.arange(gx * tx)
    counts = np.zeros(R * n, np.int64)
    for c in range(0, R, 256):
        r = rows[c:c + 256, None]
        start, count, body = prng.rows_slot(r, slots[None, :], n, vec)
        assert ((count >= 0) & (count <= vec)).all() and not (count[:, plan.slots:] > 0).any()
        assert (count[body] == vec).all() and ((r * n + start)[body] % vec == 0).all()
        assert ((start + count <= n) | (count == 0)).all()
        for k in range(vec):
            hit = count > k
            counts += np.bincount((r * n + start + k)[hit], minlength=R * n)
    assert (counts == 1).all()


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
@pytest.mark.parametrize("R,n", ROWS)
def test_rows_plan_writes_each_element_once(R, n, f64):
    _rows_cover(R, n, f64)


@pytest.mark.parametrize("R,n", [(500, 5), (700, 10001), (300, 1), (2048, 448)])
def test_rows_plan_strided_tiles(monkeypatch, R, n):
    """The grid's y extent cut to 3 row tiles: the kernel's strided loop
    over its row tiles still writes every element once."""
    monkeypatch.setattr(prng, "ROWS_MAX_TILES", 3)
    assert prng.rows_plan(R, n, False).grid[1] == 3
    for f64 in (False, True):
        _rows_cover(R, n, f64)


def test_rows_plan_tiles():
    """The tile shapes the main paths get: a long row spans whole blocks of
    256 slots, the work-sharded host's rows take one block of 128 or 256
    threads, short rows share a block; past 65,535 row tiles y strides."""
    assert prng.rows_plan(500, 10000, False) == ((10, 500), (256, 1), 4, 2502)
    assert prng.rows_plan(2048, 10000, False) == ((10, 2048), (256, 1), 4, 2502)
    assert prng.rows_plan(1024, 448, False) == ((1, 512), (128, 2), 4, 114)
    assert prng.rows_plan(1024, 864, False) == ((1, 1024), (256, 1), 4, 218)
    assert prng.rows_plan(1024, 448, True) == ((1, 1024), (256, 1), 2, 226)
    assert prng.rows_plan(70000, 1, False) == ((1, 1094), (4, 64), 4, 2)
    assert prng.rows_plan(70000, 1000, False).grid == (1, 65535)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("n", [1, 31, 257, 20001, prng.DRAW_VEC_MIN - 1, prng.DRAW_VEC_MIN + 3,
                               10**6])
def test_draw_plan_writes_each_element_once(n, width):
    """Every element of a draw of n elements of ``width`` bytes written
    once by the threads of ``draw_plan``: a thread an element below
    ``DRAW_VEC_MIN``, 16 bytes a thread (the last slot cut at n, in scalar
    stores) from there."""
    plan = prng.draw_plan(n, width)
    assert plan.vec == (1 if n < prng.DRAW_VEC_MIN else 16 // width)
    q = np.arange(plan.blocks * prng.THREADS)
    start, count, vector = prng.draw_slot(q, n, plan.vec)
    assert (count[vector] == plan.vec).all() and (start[vector] * width % 16 == 0).all()
    assert vector.any() == (plan.vec > 1 and n >= plan.vec)
    counts = np.zeros(n, np.int64)
    for k in range(plan.vec):
        counts += np.bincount((start + k)[count > k], minlength=n)
    assert (counts == 1).all()
    assert plan.blocks == -(-n // (prng.THREADS * plan.vec))  # no block without work


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_rows_ref_matches_jax(dtype):
    """The plain version of ``threefry_rows`` at the work-sharded host's n
    = 448 on int64 row ids up to 2^32 - 1 (narrowed to 32 bits, as
    ``fold_in`` takes them) with repeats: bitwise
    ``jax.random.uniform(jax.random.fold_in(key, id), (448,))``."""
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 2**32, 40)
    ids[:4] = (2**32 - 1, 2**31, 2**31 - 1, 0)
    ids[30:] = ids[5]
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7)
    want = np.asarray(jax.vmap(lambda d: jax.random.uniform(jax.random.fold_in(key, d), (448,),
                                                            dtype))(ids.astype(np.uint32)))
    td = torch.float32 if dtype == jnp.float32 else torch.float64
    got = prng.threefry_rows(np.asarray(key, np.uint32), torch.as_tensor(ids), 448, td).numpy()
    assert got.dtype == want.dtype and got.shape == (40, 448)
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
    low = ids % 2**31  # int32 ids draw as the same ids in int64
    k32 = np.asarray(key, np.uint32)
    assert torch.equal(prng.threefry_rows(k32, torch.as_tensor(low, dtype=torch.int32), 448, td),
                       prng.threefry_rows(k32, torch.as_tensor(low), 448, td))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("n", [31, 257, 20001, 10**6])
def test_draws_match_jax(n, dtype):
    """``prng.uniform`` and ``prng.normal`` on the CPU (the plain versions
    of the draw kernel) against ``jax.random`` at odd and large n (the
    dense host's N^2 = 10^6 uniforms)."""
    td = torch.float32 if dtype == jnp.float32 else torch.float64
    for seed in (1, 2**33 + 5):
        k, kp = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        u = np.asarray(jax.random.uniform(k, (n,), dtype))
        up = prng.uniform(kp, (n,), td, "cpu").numpy()
        assert up.dtype == u.dtype and up.shape == u.shape
        np.testing.assert_array_equal(up.view(np.uint8), u.view(np.uint8))
        z = np.asarray(jax.random.normal(k, (n,), dtype))
        zp = prng.normal(kp, (n,), td, "cpu").numpy()
        assert zp.dtype == z.dtype
        np.testing.assert_allclose(zp, z, rtol=1e-5 if dtype == jnp.float32 else 2e-12, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_plain_erfinv_within_an_ulp(dtype):
    """PyTorch's CPU erfinv at 2,000 arguments u = max(lo, f span + lo) of
    uniforms f (the 3 smallest and largest uniforms of the type included)
    against mpmath's erfinv at 40 digits: within 1 ulp."""
    mpmath = pytest.importorskip("mpmath")
    mpmath.mp.dps = 40
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo, span, _ = prng._normal_consts(dtype)
    f = prng.uniform_ref(prng.PRNGKey(21), (2000,), dtype).numpy()
    eps = np.finfo(npd).eps
    f[:6] = (0, eps, 2 * eps, 1 - eps, 1 - 2 * eps, 1 - 3 * eps)  # the uniforms are k eps
    u = np.maximum(npd(lo), f.astype(npd) * npd(span) + npd(lo))
    z = torch.erfinv(torch.from_numpy(u)).numpy()
    exact = np.array([float(mpmath.erfinv(mpmath.mpf(float(x)))) for x in u])
    err = np.abs(z - exact) / np.spacing(np.abs(exact).astype(npd))
    assert err.max() <= 1.0, (err.max(), u[err.argmax()])
