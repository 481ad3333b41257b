"""Pairwise-distance EDM state (LAMMPS ``fix edm_pair``, reference
lammps/fix_edm_pair.cpp): biases the pair-distance CV of an LJ fluid.

Counterpart of ``edm_tpu/models/pair_edm.py``: ``PairEDMState`` and
``init_state`` with either pair lookup: the exact cubic-Hermite table
(``pair_lookup="interp"``) or the panelized Chebyshev fit
(``"chebyshev"``, carried in ``cheb`` and refit after every hill round).
The key is a host-side Threefry key (``ops/prng``).  Not ported yet: the
dense all-pairs ``make_step`` (ROADMAP Queue 1, item 4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import bias as B
from ..ops.chebyshev import ChebTable, fit_gauss_grid


@dataclasses.dataclass(frozen=True)
class PairEDMState:
    x: torch.Tensor  # (N, 3)
    v: torch.Tensor
    f: torch.Tensor
    key: np.ndarray  # (2,) uint32 Threefry key, on the host
    bias: B.BiasState
    step: torch.Tensor  # int64 scalar
    last_calls: torch.Tensor  # est_hill_count for the next round
    energy: torch.Tensor  # bias energy of the last energy step
    hills_truncated: torch.Tensor  # bool: accepted hills exceeded capacity
    cheb: Optional[ChebTable] = None  # pair_lookup="chebyshev": the fitted table


def init_state(bias_state: B.BiasState, x0: torch.Tensor, key,
               n_est: Optional[int] = None, pair_lookup: str = "interp",
               cheb_deg: int = 64, cheb_panels: int = 1) -> PairEDMState:
    """``n_est``: initial est_hill_count, the reference's conservative
    atom->nmax guess (fix_edm_pair.cpp:105).  ``key``: a (2,) uint32 key
    (``ops.prng.PRNGKey``).  ``pair_lookup``: "interp" (the exact Hermite
    lookup) or "chebyshev" (a (cheb_panels, cheb_deg + 1) fit of the bias
    grid, refit after every hill round)."""
    if pair_lookup not in ("interp", "chebyshev"):
        raise ValueError(f"pair_lookup must be 'interp' or 'chebyshev', got {pair_lookup!r}")
    cheb = (fit_gauss_grid(bias_state.bias, cheb_deg, cheb_panels)
            if pair_lookup == "chebyshev" else None)
    n = x0.shape[0] if n_est is None else n_est
    dev = x0.device
    return PairEDMState(
        x=x0,
        v=torch.zeros_like(x0),
        f=torch.zeros_like(x0),
        key=np.asarray(key, np.uint32),
        bias=bias_state,
        step=torch.zeros((), dtype=torch.int64, device=dev),
        last_calls=torch.tensor(n, dtype=torch.int64, device=dev),
        energy=torch.zeros((), dtype=x0.dtype, device=dev),
        hills_truncated=torch.zeros((), dtype=torch.bool, device=dev),
        cheb=cheb,
    )
