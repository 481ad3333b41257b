"""Pass 1 of the cell host's hill collections: accepted candidates per
slot row, and the round's candidate count.

Counterpart of ``p1_chunk`` in ``edm_tpu/models/pair_edm_cells.py``
(``collect_hills_half``, :1886-1909; the typed ``collect_hills``,
:2073-2090), which XLA fuses into one pass a chunk that writes no draw to
memory.  ``p1_counts_half`` and ``p1_counts_typed`` launch the CUDA kernels
``p1_count_half`` / ``p1_count_typed`` (``csrc/hashrng.cu``) on a CUDA
device, one launch a call and no temporaries: both read the slot lattice
itself (each block stages its cell's candidate cells into shared memory,
in pieces where they do not fit at once, so any cap is taken), the
counter hash and the per-row sums stay on the chip, and the acceptance
threshold is read from its device scalar, so nothing synchronizes.  On
the CPU they run their plain versions, ``*_ref``: the candidate planes
(``half_planes``, ``stencil_tile``), the r^2 tile and the draws
(``hashrng.uniform_rows_cols_ref``) of whole cells at a time, in chunks
whose draws stay within ``P1_DRAWS`` values (268 MB an int64 temporary of
the hash): the 10k lattice's 729 cells are one chunk, the 100k lattice's
6,859 cells six.  The draws are keyed by global slot row and column, so
the chunking changes no value.  Each wrapper's ``launches`` counts its
kernel launches.
"""

from __future__ import annotations

import torch

from .cellforce import type_pair_mask
from .hashrng import _M32, uniform_rows_cols_ref
from .kernel_args import check, library, on_card, raise_on

P1_DRAWS = 1 << 25


def _p1_ranges(n_cells: int, draws_per_cell: int):
    """The plain pass 1's chunks: (first, end) cell ranges of at most
    ``P1_DRAWS // draws_per_cell`` whole cells (at least one) covering
    ``n_cells``."""
    step = max(1, P1_DRAWS // draws_per_cell)
    return [(c0, min(c0 + step, n_cells)) for c0 in range(0, n_cells, step)]


def _p1_join(counts, calls, like):
    """The per-chunk row counts and candidate counts -> (row_counts,
    candidates), int64 like ``like``; a single chunk's are returned as they
    are, so an unchunked pass launches nothing more."""
    if not counts:  # a rank that owns no cell
        return like.new_zeros(0), like.new_zeros(())
    return (counts[0] if len(counts) == 1 else torch.cat(counts)), sum(calls[1:], calls[0])


def stencil_tile(xs, aid2, tslot, nbr, box, n: int, type_pair, xi, ai, ti, cells):
    """The typed collection's tile: r^2, the validity and the CV type mask
    of rows (xi (..., 3), ai, ti) against the 27-stencil candidates of
    ``cells`` (each row's cell) on the slot lattice ``xs`` (Cg, cap, 3),
    ``aid2`` and ``tslot`` (Cg, cap)."""
    W = nbr.shape[1] * xs.shape[1]
    xw = xs[nbr[cells]].reshape(cells.shape + (W, 3))
    aw = aid2[nbr[cells]].reshape(cells.shape + (W,))
    tw = tslot[nbr[cells]].reshape(cells.shape + (W,))
    r2 = 0.0
    for c in range(3):
        dd = xi[..., c, None] - xw[..., c]
        dd = dd - torch.round(dd / box[c]) * box[c]
        r2 = r2 + dd * dd
    valid = (ai[..., None] < n) & (aw < n) & (ai[..., None] != aw)
    return r2, valid, type_pair_mask(ti[..., None], tw, type_pair)


def half_planes(plane, nbr, cells):
    """(Cg, cap[, ...]) per-slot plane -> (B, 14 cap[, ...]) candidate planes
    of the row cells ``cells`` (a slice or a tensor of global cell ids): the
    cell's own slots, then those of its 13 neighbours ``nbr`` (C, 13)
    (``half_neighbors``) in order."""
    own, nb = plane[cells], plane[nbr[cells]]
    return torch.cat([own, nb.reshape((own.shape[0], nbr.shape[1] * plane.shape[1])
                                      + plane.shape[2:])], 1)


def p1_counts_half_ref(xs, mc, cells, nbr, box, bmax2: float, thresh, seeds):
    """Plain version of ``p1_counts_half``, chunked by ``P1_DRAWS``: each
    chunk builds its cells' candidate planes."""
    cap = xs.shape[1]
    W = (1 + nbr.shape[1]) * cap
    dev = xs.device
    ci = torch.arange(W, device=dev)
    ri = torch.arange(cap, device=dev)
    upper = (ci >= cap) | (ci > ri[None, :, None])  # the self block strictly upper
    counts, calls = [], []
    for c0, c1 in _p1_ranges(cells.shape[0], 2 * W * cap):
        cc = cells[c0:c1]
        r2 = 0.0
        for c in range(3):
            pl = half_planes(xs[..., c], nbr, cc)
            dd = pl[:, :cap, None] - pl[:, None, :]
            dd = dd - torch.round(dd / box[c]) * box[c]
            r2 = r2 + dd * dd
        m = half_planes(mc, nbr, cc) > 0.5
        ok = m[:, :cap, None] & m[:, None, :] & upper & (r2 < bmax2)
        acc = ok[..., None].expand(ok.shape + (2,))
        if thresh is not None:
            gids = (cc[:, None] * cap + ri).reshape(-1)
            u = uniform_rows_cols_ref(seeds, gids, 2 * W, xs.dtype)
            acc = acc & (u.reshape(c1 - c0, cap, W, 2) < thresh)
        counts.append(acc.sum((2, 3)).reshape(-1))
        calls.append(torch.sum(ok.to(torch.int64)))
    row_counts, ncalls = _p1_join(counts, calls, cells)
    return row_counts, 2 * ncalls


def p1_counts_typed_ref(xs, aid, tslot, nbr, box, bmax2: float, thresh, seeds, n: int,
                        type_pair):
    """Plain version of ``p1_counts_typed``, chunked by ``P1_DRAWS``."""
    C, cap = nbr.shape[0], xs.shape[1]
    W = nbr.shape[1] * cap
    aid2 = aid.reshape(-1, cap)
    counts, calls = [], []
    for c0, c1 in _p1_ranges(C, W * cap):
        cells = torch.arange(c0, c1, device=xs.device)
        r2, valid, cv = stencil_tile(xs, aid2, tslot, nbr, box, n, type_pair, xs[c0:c1],
                                     aid2[c0:c1], tslot[c0:c1], cells[:, None])
        cand = valid & cv & (r2 < bmax2)
        acc = cand
        if thresh is not None:
            rows = torch.arange(c0 * cap, c1 * cap, device=xs.device)
            u = uniform_rows_cols_ref(seeds, rows, W, xs.dtype).reshape(c1 - c0, cap, W)
            acc = cand & (u < thresh)
        counts.append(acc.sum(2).reshape(-1))
        calls.append(torch.sum(cand.to(torch.int64)))
    return _p1_join(counts, calls, aid)


def _launch_args(box, thresh, dtype, device):
    """Checks the arguments pass 1's kernels share; returns the library, the
    stream and the threshold's pointer (None: accept every candidate)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pass 1 runs in float32 or float64 on the card, not {dtype}")
    check(box, "box", (3,), device, dtype)
    if thresh is not None:
        check(thresh.reshape(()), "thresh", (), device, dtype)
    lib, _ = library()
    return (lib, torch.cuda.current_stream(device).cuda_stream,
            None if thresh is None else thresh.data_ptr())


def p1_counts_half(xs, mc, cells, nbr, box, bmax2: float, thresh, seeds):
    """Pass 1 of the half-stencil collection over B row cells.

    ``xs`` (Cg, cap, 3) and ``mc`` (Cg, cap) the slot lattice (positions
    and occupancy, one type), ``cells`` (B,) int64 the row cells' global ids
    (any order, each below C; row r of cell c is global slot row c cap + r,
    the draws' key), ``nbr`` (C, 13) int64 ``half_neighbors``, ``box``
    (3,) on the device, ``bmax2`` the CV's squared upper edge, ``thresh``
    the acceptance threshold (a device scalar, or None: accept every
    candidate), ``seeds`` the round's two uint32 seeds.  Candidate column w
    of a row is its cell's slot w (w < cap), else slot w % cap of neighbour
    w // cap - 1.  Each pair (row, w) with both slots occupied, above the
    self block's diagonal and within bmax draws columns 2w and 2w + 1.
    Returns (row_counts (B cap,) int64: the accepted draws of each row,
    ncalls () int64: twice the pairs)."""
    device = xs.device
    if not on_card(device, "p1_counts_half"):
        return p1_counts_half_ref(xs, mc, cells, nbr, box, bmax2, thresh, seeds)
    Cg, cap, _ = xs.shape
    B_ = cells.shape[0]
    dtype = xs.dtype
    lib, stream, tptr = _launch_args(box, thresh, dtype, device)
    check(xs, "xs", (Cg, cap, 3), device, dtype)
    check(mc, "mc", (Cg, cap), device, dtype)
    check(cells, "cells", (B_,), device, torch.int64)
    check(nbr, "nbr", (nbr.shape[0], 13), device, torch.int64)
    if nbr.shape[0] > Cg:
        raise ValueError(f"nbr has {nbr.shape[0]} cells, the lattice {Cg}")
    row_counts = torch.empty(B_ * cap, dtype=torch.int64, device=device)
    ncalls = torch.empty((), dtype=torch.int64, device=device)
    s0, s1 = (int(s) & _M32 for s in seeds)
    code = lib.p1_count_half_launch(xs.data_ptr(), mc.data_ptr(), cells.data_ptr(),
                                    nbr.data_ptr(), box.data_ptr(), float(bmax2), tptr, s0, s1,
                                    B_, cap, int(dtype == torch.float64), row_counts.data_ptr(),
                                    ncalls.data_ptr(), stream)
    raise_on(lib, code, "p1_counts_half")
    p1_counts_half.launches += B_ > 0
    return row_counts, ncalls


def p1_counts_typed(xs, aid, tslot, nbr, box, bmax2: float, thresh, seeds, n: int, type_pair):
    """Pass 1 of the typed 27-stencil collection over every cell.

    ``xs`` (Cg, cap, 3) slot positions, ``aid`` (Cg cap,) int64 slot atom
    ids (``n`` = empty), ``tslot`` (Cg, cap) slot types as floats, ``nbr``
    (C, 27) int64 ``stencil_neighbors``, ``type_pair`` the CV's (ti, tj);
    ``box``, ``bmax2``, ``thresh`` and ``seeds`` as ``p1_counts_half``.
    Each ordered candidate of two distinct real atoms of the type pair
    within bmax draws one uniform (row c cap + r, column w).  Returns
    (row_counts (C cap,) int64, ncalls () int64: the candidates)."""
    device = xs.device
    if not on_card(device, "p1_counts_typed"):
        return p1_counts_typed_ref(xs, aid, tslot, nbr, box, bmax2, thresh, seeds, n, type_pair)
    Cg, cap, _ = xs.shape
    C = nbr.shape[0]
    dtype = xs.dtype
    lib, stream, tptr = _launch_args(box, thresh, dtype, device)
    check(xs, "xs", (Cg, cap, 3), device, dtype)
    check(aid, "aid", (Cg * cap,), device, torch.int64)
    check(tslot, "tslot", (Cg, cap), device, dtype)
    check(nbr, "nbr", (C, 27), device, torch.int64)
    row_counts = torch.empty(C * cap, dtype=torch.int64, device=device)
    ncalls = torch.empty((), dtype=torch.int64, device=device)
    s0, s1 = (int(s) & _M32 for s in seeds)
    t0, t1 = (float(t) for t in type_pair)
    code = lib.p1_count_typed_launch(xs.data_ptr(), aid.data_ptr(), tslot.data_ptr(),
                                     nbr.data_ptr(), box.data_ptr(), float(bmax2), tptr, t0, t1,
                                     n, s0, s1, C, cap, int(dtype == torch.float64),
                                     row_counts.data_ptr(), ncalls.data_ptr(), stream)
    raise_on(lib, code, "p1_counts_typed")
    p1_counts_typed.launches += C > 0
    return row_counts, ncalls


p1_counts_half.launches = 0
p1_counts_typed.launches = 0
