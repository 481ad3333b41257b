"""Pairwise-distance EDM state (LAMMPS ``fix edm_pair``, reference
lammps/fix_edm_pair.cpp): biases the pair-distance CV of an LJ fluid.

Counterpart of ``edm_tpu/models/pair_edm.py``: ``PairEDMState`` and
``init_state`` with the exact cubic-Hermite lookup (``pair_lookup="interp"``;
the JAX state's ``cheb`` table has no field here).  The key is a host-side
Threefry key (``ops/prng``).  Not ported yet: the
Chebyshev lookup (ROADMAP Queue 1, item 7) and the dense all-pairs
``make_step`` (item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import bias as B


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


def init_state(bias_state: B.BiasState, x0: torch.Tensor, key,
               n_est: Optional[int] = None, pair_lookup: str = "interp"
               ) -> PairEDMState:
    """``n_est``: initial est_hill_count, the reference's conservative
    atom->nmax guess (fix_edm_pair.cpp:105).  ``key``: a (2,) uint32 key
    (``ops.prng.PRNGKey``)."""
    if pair_lookup != "interp":
        raise NotImplementedError(
            "pair_lookup='chebyshev' is not ported yet (ROADMAP Queue 1, item 7)"
        )
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
    )
