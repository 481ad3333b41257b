"""Memory-blocked pairwise EDM for large N — same physics as
``pair_edm.make_step`` with the O(N^2) pair pass in row blocks, so peak
memory is O(block * N) instead of O(N^2).

Counterpart of ``edm_tpu/models/pair_edm_blocked.py``, the single-device
path for 1e4-1e5 atoms (and ``bench.py:bench_pairwise``'s host when the box
holds fewer than 3 cells a side):

- force pass: per block of ``block_size`` rows, the minimum-image
  displacements against all atoms, LJ plus the bias-CV term (exact Hermite
  lookup or the carried Chebyshev table), row-summed forces;
- hill collection, two passes over per-row acceptance streams
  (``prng.threefry_rows``: row i draws ``uniform(fold_in(key, i), (N,))``,
  all rows of a block in one launch of the Threefry kernel on the card):
  pass 1 takes each row's accepted count and the global candidate count
  block by block; the rows with an accept are compacted to ``ROW_CAP =
  min(N, max(256, hill_capacity))``; pass 2 recomputes those rows and
  redraws the same uniforms (padding rows draw row N-1's stream and are
  masked); each row's first ``M_PER_ROW = 32`` accepts, ascending j, are
  compacted into ``hill_capacity`` rows.  ``hills_truncated`` flags more
  than ``hill_capacity`` hills, more than ``ROW_CAP`` rows, or a row with
  more than ``M_PER_ROW`` accepts.

The JAX host extracts each row's accepts by 32 rounds of argmax; here the
same entries in the same order come from a prefix count along the row, as
the cell host's pass 2 does (``pair_edm_cells.CellStep._compact``).  No
host read outside the round's capping loop (``ops/prefix_cap``), counted in
``step.host_syncs``.  The state is the dense host's ``PairEDMState``.
``axis_name`` sums each round's bias over the ranks of a mesh
(``bias.add_hills_round``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import bias as B
from ..ops import prng
from .cells import _scatter_drop
from .langevin import LangevinParams
from .lj import LJParams, lj_pair_terms, minimum_image
from .pair_edm import PairEDMState, PairStepBase, bias_pair_terms, compact_hills

M_PER_ROW = 32


class BlockedStep(PairStepBase):
    """One step of the blocked host (``make_step_blocked``)."""

    def __init__(self, *args, block_size: int, axis_name=None):
        super().__init__(*args, axis_name=axis_name)
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size

    def _n_log(self, n: int) -> int:
        return self.hill_capacity

    def _blocks(self, n: int) -> int:
        if n % self.block_size:
            raise ValueError(f"{n} atoms are not a whole number of blocks of "
                             f"block_size {self.block_size}")
        return n // self.block_size

    def _rows(self, x, rows):
        """Minimum-image displacements (R, N, 3) and distances (R, N) of
        atoms ``rows`` against all atoms; r = inf on the self pair."""
        disp = minimum_image(x[rows][:, None, :] - x[None, :, :], self.box)
        r2 = torch.sum(disp * disp, dim=-1)
        self_pair = rows[:, None] == torch.arange(x.shape[0], device=x.device)[None, :]
        r = torch.sqrt(torch.where(self_pair, torch.full_like(r2, float("inf")), r2))
        return disp, r

    def _block_ids(self, x, bi: int):
        b = self.block_size
        return torch.arange(bi * b, (bi + 1) * b, device=x.device)

    def _force_fn(self, state: PairEDMState):
        def force_fn(x):
            f_rows, e_b = [], []
            for bi in range(self._blocks(x.shape[0])):
                disp, r = self._rows(x, self._block_ids(x, bi))
                _, fmag = lj_pair_terms(self.lj, r)
                f = torch.sum(fmag[..., None] * disp, dim=1)
                e_pair, fb = bias_pair_terms(state, r)
                f_rows.append(f + torch.sum(fb[..., None] * disp, dim=1))
                e_b.append(torch.sum(e_pair))
            return 0.5 * torch.sum(torch.stack(e_b)), torch.cat(f_rows)

        return force_fn

    def _collect(self, x, key, last_calls):
        n, dtype, dev = x.shape[0], x.dtype, x.device
        bmax = self.params.cfg.box_high[0]
        thresh = self._accept_threshold(last_calls, dtype)
        row_cap = min(n, max(256, self.hill_capacity))

        def accepted(r, rows):
            """(candidates, accepts, uniforms) of rows ``rows`` at distances
            ``r``: the rows' streams are drawn even when every candidate is
            accepted, as the JAX host draws them."""
            cand = torch.isfinite(r) & (r < bmax)
            u = prng.threefry_rows(key, rows, n, dtype)
            return cand, cand if thresh is None else cand & (u < thresh), u

        # pass 1: per-row accepted counts and the global candidate count
        counts, ncalls = [], 0
        for bi in range(self._blocks(n)):
            rows = self._block_ids(x, bi)
            cand, acc, _ = accepted(self._rows(x, rows)[1], rows)
            counts.append(torch.sum(acc.to(torch.int64), 1))
            ncalls = ncalls + torch.sum(cand.to(torch.int64))
        row_counts = torch.cat(counts)

        # rows with an accept, compacted in row order (sentinel n)
        has = row_counts > 0
        rranks = torch.cumsum(has.to(torch.int64), 0) - 1
        rtgt = torch.where(has & (rranks < row_cap), rranks, torch.full_like(rranks, row_cap))
        rows_sel = _scatter_drop(row_cap, n, rtgt, torch.arange(n, device=dev))
        n_rows = torch.sum(has.to(torch.int64))

        # pass 2 on the selected rows; padding rows take row n-1's stream
        rows_c = torch.clamp(rows_sel, 0, n - 1)
        _, r = self._rows(x, rows_c)
        r = torch.where((rows_sel < n)[:, None], r, torch.full_like(r, float("inf")))
        _, acc, u = accepted(r, rows_c)
        # each row's first M_PER_ROW accepts, ascending j, in row order
        sel = acc & (torch.cumsum(acc.to(torch.int64), 1) <= M_PER_ROW)
        hills, runifs, active, count = compact_hills(sel.reshape(-1), r.reshape(-1),
                                                     u.reshape(-1), self.hill_capacity)
        truncated = ((count > self.hill_capacity) | (n_rows > row_cap)
                     | torch.any(row_counts > M_PER_ROW))
        return hills, runifs, active, ncalls, truncated


def make_step_blocked(
    params: B.BiasParams,
    lp: LangevinParams,
    lj: LJParams,
    box,
    hill_stride: int,
    hill_capacity: int = 2048,
    block_size: int = 512,
    axis_name: Optional[str] = None,
    cheb_deg: int = 64,
    collect_records: bool = False,
    static_do_hills: Optional[bool] = None,
) -> BlockedStep:
    """Build a step of the blocked host, with the JAX signature.  The atom
    count must be a whole number of ``block_size`` blocks (a step raises
    ``ValueError`` otherwise; the JAX host fails to trace).  The Chebyshev
    table, ``static_do_hills``, ``collect_records`` and ``axis_name`` as in
    ``pair_edm.make_step``."""
    do_hills = None if static_do_hills is None else bool(static_do_hills)
    return BlockedStep(params, lp, lj, box, hill_stride, hill_capacity, do_hills,
                       collect_records, block_size=block_size, axis_name=axis_name)
