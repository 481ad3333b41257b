"""The HILLS log: the reference's per-rank hill event trace (output_hill,
lib/edm_bias.cpp:586-599).

Counterpart of ``edm_tpu/utils/hills_log.py``.  Line format (8-decimal
fixed):
  ``step type_char hills_added x... height bias_added cum_bias/volume``
with event types 'h' add, 'u' add-undo, 'b' buffered add, 'v' buffer-undo
(edm_bias.h:20-25; the reference never emits 'n', and 'z' only in debug
builds).

A round's ``RoundRecords`` hold per-hill effective and deferred heights
and integral weights; ``log_round`` rebuilds the reference's sequential
event stream from them on the host, in the reference's order: the drained
buffer first ('b', then 'v' for a straddler's partial undo), then the new
hills ('h', then 'u'); a capped-out hill is logged at zero height without
bumping the counter.  The C++ formatter of ``native/`` writes the lines
when it loads, else the Python code below, which defines the bytes both
must write.  Records held in tensors come to the host in one copy
(``to_host``).
"""

from __future__ import annotations

import ctypes
import io

import numpy as np
import torch

from .. import native
from ..bias import ADD_HILL, ADD_UNDO_HILL, BUFF_HILL, BUFF_UNDO_HILL


def _leaves(tree, out):
    if isinstance(tree, tuple):
        for t in tree:
            _leaves(t, out)
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    return out


def to_host(tree):
    """A tuple / NamedTuple tree of tensors -> the same tree of numpy
    arrays, in one device-to-host copy (every leaf travels as float64, which
    holds the bool, integer and float32 leaves of the records exactly, and
    comes back in its own dtype)."""
    leaves = _leaves(tree, [])
    if not leaves:
        return tree
    flat = torch.cat([t.detach().reshape(-1).to(torch.float64) for t in leaves]).cpu().numpy()
    it, pos = iter(leaves), [0]

    def rebuild(t):
        if isinstance(t, tuple):
            vals = [rebuild(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        if not isinstance(t, torch.Tensor):
            return t
        leaf = next(it)
        n = leaf.numel()
        a = flat[pos[0]:pos[0] + n].reshape(tuple(leaf.shape))
        pos[0] += n
        return a.astype(torch.empty((), dtype=leaf.dtype).numpy().dtype)

    return rebuild(tree)


def _f64(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.float64)


def _u8(a):
    return np.ascontiguousarray(np.asarray(a), dtype=np.uint8)


class HillsLog:
    def __init__(self, filename: str, dim: int, total_volume: float):
        self.filename = filename
        self.dim = dim
        self.total_volume = total_volume
        self._f = open(filename, "w") if filename else None

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def _line(self, buf, step, type_char, counter, pos, height, bias_added, cum_over_vol):
        buf.write(f"{step} {type_char} {counter} ")
        for d in range(self.dim):
            buf.write(f"{pos[d]:.8f} ")
        buf.write(f"{height:.8f} {bias_added:.8f} {cum_over_vol:.8f}\n")

    def log_round(self, step: int, cum_bias_before: float, rec, positions=None) -> None:
        """Append the event stream of one hill round.  ``rec``: its
        ``RoundRecords`` (tensors or numpy arrays); ``positions``: the
        (H, D) new-hill centres passed to the round."""
        if self._f is None:
            return
        rec, positions = to_host((rec, positions))
        n_hills = len(np.asarray(rec.hill_h))
        pos = np.zeros((n_hills, self.dim)) if positions is None else positions
        cols = dict(
            drain_pos=_f64(rec.drain_pos), drain_h=_f64(rec.drain_h),
            drain_dep=_f64(rec.drain_dep_h), drain_s=_f64(rec.drain_s),
            drain_processed=_u8(rec.drain_processed), drain_straddled=_u8(rec.drain_straddled),
            hill_pos=_f64(pos), hill_h=_f64(rec.hill_h), hill_dep=_f64(rec.hill_dep_h),
            hill_s=_f64(rec.hill_s), called=_u8(rec.hill_called),
            deposited=_u8(rec.hill_deposited), straddled=_u8(rec.hill_straddled),
        )
        cum = float(cum_bias_before / self.total_volume)
        lib = native.load_hillslog()
        text = (self._format_native(lib, step, cum, cols) if lib is not None
                else self._format(step, cum, cols))
        self._f.write(text)
        self._f.flush()

    def _format(self, step, cum, c) -> str:
        buf = io.StringIO()
        counter = 0
        for i in np.nonzero(c["drain_processed"])[0]:
            h, s, p = c["drain_h"][i], c["drain_s"][i], c["drain_pos"][i]
            counter += 1
            self._line(buf, step, BUFF_HILL, counter, p, h, h * s, cum)
            if c["drain_straddled"][i]:
                undo = c["drain_dep"][i] - h  # a negative partial
                counter += 1
                self._line(buf, step, BUFF_UNDO_HILL, counter, p, undo, undo * s, cum)
        for i in np.nonzero(c["called"])[0]:
            h, s, p = c["hill_h"][i], c["hill_s"][i], c["hill_pos"][i]
            if c["deposited"][i]:
                counter += 1
                self._line(buf, step, ADD_HILL, counter, p, h, h * s, cum)
                if c["straddled"][i]:
                    undo = c["hill_dep"][i] - h
                    counter += 1
                    self._line(buf, step, ADD_UNDO_HILL, counter, p, undo, undo * s, cum)
            else:  # capped out: zero height, the counter not bumped
                self._line(buf, step, ADD_HILL, counter, p, 0.0, 0.0, cum)
        return buf.getvalue()

    def _format_native(self, lib, step, cum, c) -> str:
        dp = ctypes.POINTER(ctypes.c_double)
        u8 = ctypes.POINTER(ctypes.c_uint8)

        def d(name):
            return c[name].ctypes.data_as(dp)

        def b(name):
            return c[name].ctypes.data_as(u8)

        n_drain, n_hills = len(c["drain_h"]), len(c["hill_h"])
        cap = 2 * (n_drain + n_hills + 2) * (64 + 24 * self.dim)  # ~2 lines a slot at most
        out = ctypes.create_string_buffer(cap)
        nb = lib.edm_format_round(
            out, cap, int(step), int(self.dim), cum,
            n_drain, d("drain_pos"), d("drain_h"), d("drain_dep"), d("drain_s"),
            b("drain_processed"), b("drain_straddled"),
            n_hills, d("hill_pos"), d("hill_h"), d("hill_dep"), d("hill_s"),
            b("called"), b("deposited"), b("straddled"),
        )
        if nb < 0:
            raise RuntimeError("hills-log formatter: line longer than its buffer")
        return out.raw[:nb].decode("ascii")
