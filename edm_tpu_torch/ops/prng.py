"""Threefry-2x32 keys on the host, and ``jax.random`` draws on the card,
as JAX 0.9 computes them.

The JAX hosts thread a ``jax.random`` key through the step: one split per
step for the thermostat, one per hill round for acceptance, and each
subkey becomes two uint32 seeds of the counter hash (``ops/hashrng``).
Reproducing ``PRNGKey``, ``split`` and ``bits`` bitwise gives the port the
same key chain, so a run from ``PRNGKey(0)`` draws the same noise and the
same acceptance uniforms as the JAX host.  The key is a (2,) uint32 numpy
array on the host; it reaches the device only as the two words of a
kernel launch, so a draw costs no copy and no device sync.

JAX 0.9 defaults to ``jax_threefry_partitionable``: ``split(key, n)[i]``
and ``bits(key, (n,))[i]`` both hash the 64-bit counter ``i`` (high word,
low word) under ``key``; ``split`` keeps both output words, 32-bit
``bits`` returns their xor, 64-bit bits the first word over the second.
``fold_in(key, i)`` hashes the counter (0, i) under ``key`` and keeps both
words, as ``jax.random.fold_in`` does for a 32-bit ``i``.

What runs on a CUDA device (``csrc/threefry.cu``), one launch a call:

- ``uniform``, ``normal`` and ``threefry_bits`` launch the draw kernel
  ``tf_bits``, which writes the finished numbers: the bits, a uniform (the
  mantissa trick, ``bits >> 9`` (float32) or ``>> 12`` (float64) under
  the exponent of 1.0, minus 1: bitwise JAX's) or a normal (JAX's
  ``_normal_real``: ``sqrt(2) erfinv(u)`` with ``u`` uniform on
  ``[nextafter(-1, 0), 1)``, CUDA's ``erfinv``).  ``threefry_bits.launches``
  counts its launches, whichever of the three called it.
- ``threefry_rows`` draws one ``uniform(fold_in(key, row), (n,))`` per entry
  of a device tensor of int32 or int64 row ids, deriving each row's key on
  the card (the blocked pair host's per-row acceptance streams, whose
  pass-2 rows are computed on the card); ``threefry_rows.launches`` counts
  it.

On the CPU each of them runs its plain version, which is the kernels'
oracle: the numpy chain of this module (``_bits_ref``, ``_rows_ref``) and,
for ``uniform_ref`` and ``normal_ref``, the PyTorch ops that turn its bits
into the number (``_uniform_chain``, ``_normal_chain``).  The uniforms
are bitwise JAX's; ``erfinv`` is PyTorch's, not XLA's polynomial, so the
normals differ from JAX's by a few ulps (``tests/test_torch_coord.py`` holds
the bound), and the card's from the CPU's by CUDA's ``erfinv`` against
PyTorch's CPU one.

The kernels' launch shapes are the plain functions ``draw_plan`` and
``rows_plan`` (with ``draw_slot`` and ``rows_slot``, the elements a thread
writes), which the CPU tests enumerate.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..grid import device_const
from .kernel_args import library, on_card, raise_on

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


# ------------------------------------------------------------ launch plans

THREADS = 256  # threads a block, both kernels
# from this many elements a draw's thread writes 16 bytes with one store;
# below, one element (the thermostat's 20,000 or 30,000 normals)
DRAW_VEC_MIN = 1 << 17
ROWS_MAX_TILES = 65535  # the grid's y extent; row tiles past it are strided


class DrawPlan(NamedTuple):
    blocks: int  # of THREADS threads
    vec: int  # elements a thread: 1, or 16 bytes' worth


def draw_plan(n: int, width: int) -> DrawPlan:
    """The launch of a draw of ``n`` elements of ``width`` bytes (4: the
    bits' xor, float32; 8: both words, float64)."""
    vec = 1 if n < DRAW_VEC_MIN else 16 // width
    return DrawPlan(-(-n // (THREADS * vec)), vec)


def draw_slot(q, n: int, vec: int):
    """The elements [start, start + count) that thread ``q`` of a draw
    writes, and whether with one 16-byte store (numpy arrays or ints)."""
    start = np.asarray(q, np.int64) * vec
    count = np.clip(n - start, 0, vec)
    return start, count, (vec > 1) & (count == vec)


class RowsPlan(NamedTuple):
    grid: tuple  # (slot tiles, row tiles): x along a row, y over the rows
    block: tuple  # (tx slots, tr rows), tx tr = THREADS
    vec: int  # elements a 16-byte store
    slots: int  # a row's slots: n // vec + 2


def rows_plan(R: int, n: int, f64: bool) -> RowsPlan:
    """The launch of ``threefry_rows`` for R rows of n: tx the power of two
    (4 to 256) that covers a row's slots, so a block holds whole short
    rows and a long row spans whole blocks."""
    vec = 2 if f64 else 4
    slots = n // vec + 2
    tx = min(THREADS, max(4, 1 << (slots - 1).bit_length()))
    tr = THREADS // tx
    return RowsPlan((-(-slots // tx), max(1, min(-(-R // tr), ROWS_MAX_TILES))), (tx, tr), vec,
                    slots)


def rows_slot(r, s, n: int, vec: int):
    """The columns [start, start + count) of row ``r`` that its slot ``s``
    writes, and whether with one 16-byte store (numpy arrays that
    broadcast): slot 0 the columns before the row's first 16-byte boundary
    in the (R, n) output, slots 1..nb a vector each, slot nb + 1 the
    rest."""
    r, s = np.asarray(r, np.int64), np.asarray(s, np.int64)
    head = np.minimum(-(r * n) % vec, n)
    nb = (n - head) // vec
    body = (s >= 1) & (s <= nb)
    start = np.select([s == 0, body], [0, head + (s - 1) * vec], head + nb * vec)
    count = np.select([s == 0, body, s == nb + 1], [head, vec, n - head - nb * vec], 0)
    return start, count, body


# ------------------------------------------------------------ the draws

_BITS, _WIDE, _UNIFORM, _NORMAL = range(4)  # what tf_bits writes


def _check_float(dtype, what: str):
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} draws float32 or float64, not {dtype}")


def _draw(key, kind: int, out: torch.Tensor, consts=(0.0, 0.0, 0.0)) -> torch.Tensor:
    """One launch of ``tf_bits`` writing ``out`` (n elements, or (n, 2)
    words): the kind's numbers of counters 0..n-1 under ``key``; an empty
    draw launches nothing."""
    n = out.shape[0]
    if n == 0:
        return out
    plan = draw_plan(n, out[0].numel() * out.element_size())
    lib, _ = library()
    code = lib.threefry_bits_launch(int(key[0]), int(key[1]), n, kind,
                                    int(out.dtype == torch.float64), *consts, plan.blocks,
                                    plan.vec, out.data_ptr(),
                                    torch.cuda.current_stream(out.device).cuda_stream)
    raise_on(lib, code, "threefry_bits")
    threefry_bits.launches += 1
    return out


def _bits_ref(key, n: int, wide: bool) -> torch.Tensor:
    """Plain version of ``threefry_bits``: the numpy chain, as int32 bit
    patterns (wide: (n, 2), the first word, then the second)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    out = np.stack([b0, b1], axis=1) if wide else b0 ^ b1
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int32))


def threefry_bits(key, n: int, device, wide: bool = False) -> torch.Tensor:
    """The Threefry-2x32 blocks of counters 0..n-1 under ``key`` on
    ``device``, as int32 bit patterns: their xor (n,) (``random_bits``) or,
    ``wide``, both words (n, 2).  On a CUDA device one launch of the draw
    kernel ``tf_bits``, counted by ``threefry_bits.launches`` (as are the
    launches ``uniform`` and ``normal`` make); on the CPU its plain version,
    ``_bits_ref``."""
    device = torch.device(device)
    if not on_card(device, "threefry_bits"):
        return _bits_ref(key, n, wide)
    out = torch.empty((n, 2) if wide else (n,), dtype=torch.int32, device=device)
    return _draw(key, _WIDE if wide else _BITS, out)


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
    """Plain version of ``threefry_rows``: the numpy chain, on the CPU; the
    ids narrowed to 32 bits as ``fold_in`` takes them."""
    rows = np.asarray(row_ids.cpu() if isinstance(row_ids, torch.Tensor) else row_ids,
                      np.int64).astype(np.uint32)
    rk0, rk1 = threefry2x32(key, np.zeros_like(rows), rows)  # fold_in, per row
    hi, lo = _counters(n)
    b0, b1 = threefry2x32((rk0[:, None], rk1[:, None]), hi[None, :], lo[None, :])
    return torch.from_numpy(_mantissa_uniform(b0, b1, dtype == torch.float64))


def threefry_rows(key, row_ids: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """(R, n) uniforms: row ``r`` is ``jax.random.uniform(fold_in(key,
    row_ids[r]), (n,), dtype)``, bitwise, in float32 or float64, on
    ``row_ids``' device.  ``row_ids`` (R,) int32 or int64 row ids, taken
    mod 2**32 (any other integer type is widened to int64 first).  On a
    CUDA device one launch of ``tf_rows`` (``rows_plan``), which reads the
    ids as they are and derives each row's key once a block, counted by
    ``threefry_rows.launches``; on the CPU its plain version,
    ``_rows_ref``."""
    _check_float(dtype, "threefry_rows")
    device = row_ids.device
    if not on_card(device, "threefry_rows"):
        return _rows_ref(key, row_ids, n, dtype)
    if row_ids.dim() != 1:
        raise ValueError(f"row_ids must be 1-D, got shape {tuple(row_ids.shape)}")
    rows = row_ids if row_ids.dtype in (torch.int32, torch.int64) else row_ids.to(torch.int64)
    rows = rows.contiguous()
    R, f64 = rows.shape[0], dtype == torch.float64
    out = torch.empty((R, n), dtype=dtype, device=device)
    if out.numel() == 0:
        return out
    plan = rows_plan(R, n, f64)
    lib, _ = library()
    code = lib.threefry_rows_launch(int(key[0]), int(key[1]), rows.data_ptr(),
                                    int(rows.dtype == torch.int64), R, n, int(f64), *plan.grid,
                                    *plan.block, out.data_ptr(),
                                    torch.cuda.current_stream(device).cuda_stream)
    raise_on(lib, code, "threefry_rows")
    threefry_rows.launches += 1
    return out


threefry_rows.launches = 0


def _uniform_chain(b: torch.Tensor, dtype) -> torch.Tensor:
    """The mantissa trick in PyTorch ops on bits from ``threefry_bits``
    (wide in float64), on their device: the plain version of a uniform
    draw past its bits."""
    if dtype == torch.float32:
        m = torch.bitwise_and(torch.bitwise_right_shift(b, 9), 0x7FFFFF)
        return torch.bitwise_or(m, 0x3F800000).view(torch.float32) - 1.0
    w = b.to(torch.int64)
    hi, lo = w[:, 0] & 0xFFFFFFFF, w[:, 1] & 0xFFFFFFFF
    m = torch.bitwise_or(torch.bitwise_left_shift(hi, 20), torch.bitwise_right_shift(lo, 12))
    return torch.bitwise_or(m, 0x3FF0000000000000).view(torch.float64) - 1.0


def _normal_consts(dtype):
    """lo = nextafter(-1, 0), span = 1 - lo and sqrt(2), each rounded to
    the type in numpy, as JAX's ``_normal_real`` rounds them."""
    npd = np.float32 if dtype == torch.float32 else np.float64
    lo = np.nextafter(npd(-1.0), npd(0.0))
    return float(lo), float(npd(1.0) - lo), float(npd(np.sqrt(2)))


def _normal_chain(f: torch.Tensor, dtype) -> torch.Tensor:
    """``sqrt(2) erfinv(max(lo, f span + lo))`` in PyTorch ops on uniforms
    ``f``, on their device: the plain version of a normal draw past its
    uniforms."""
    lo, span, s2 = _normal_consts(dtype)
    lo_t = device_const(lo, f.device, dtype)
    u = torch.maximum(lo_t, f * device_const(span, f.device, dtype) + lo_t)
    return s2 * torch.erfinv(u)


def uniform_ref(key, shape, dtype=torch.float32) -> torch.Tensor:
    """Plain version of ``uniform``, on the CPU."""
    _check_float(dtype, "uniform")
    b = _bits_ref(key, int(np.prod(shape)), dtype == torch.float64)
    return _uniform_chain(b, dtype).reshape(tuple(shape))


def normal_ref(key, shape, dtype=torch.float32) -> torch.Tensor:
    """Plain version of ``normal``, on the CPU."""
    return _normal_chain(uniform_ref(key, shape, dtype), dtype)


def uniform(key, shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1), bitwise: the
    mantissa trick on each element's bits.  On a CUDA device one launch of
    ``tf_bits`` (counted by ``threefry_bits.launches``); on the CPU
    ``uniform_ref``."""
    _check_float(dtype, "uniform")
    device = torch.device(device)
    if not on_card(device, "threefry_bits"):
        return uniform_ref(key, shape, dtype)
    out = torch.empty(int(np.prod(shape)), dtype=dtype, device=device)
    return _draw(key, _UNIFORM, out).reshape(tuple(shape))


def normal(key, shape, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv(u), u on
    [nextafter(-1, 0), 1) from the same bits (JAX's ``_normal_real``).  On
    a CUDA device one launch of ``tf_bits`` (counted by
    ``threefry_bits.launches``), within 2 ulps of ``normal_ref``, the plain
    version, which runs on the CPU."""
    _check_float(dtype, "normal")
    device = torch.device(device)
    if not on_card(device, "threefry_bits"):
        return normal_ref(key, shape, dtype)
    out = torch.empty(int(np.prod(shape)), dtype=dtype, device=device)
    return _draw(key, _NORMAL, out, _normal_consts(dtype)).reshape(tuple(shape))
