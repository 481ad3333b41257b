"""Simulation driver: run a host's static stride phases in their cycle.

Counterpart of ``edm_tpu/models/driver.py``'s ``pattern_segment``.  JAX
scans the phase steps inside one compiled program; here the segment is a
Python loop over the phase steps, each of which launches its own kernels
(capturing a cycle as a CUDA graph is later work, ROADMAP Queue 1, item 6).
``strided_segment`` and ``run_simulation`` (file output) are not ported
yet (items 6 and 10).
"""

from __future__ import annotations

import torch


def pattern_segment(pattern, length: int):
    """``pattern``: a list of ``(step_fn, count)`` entries, one cycle of
    static phase steps in order; ``length`` a whole number of cycles.
    Returns ``seg(state) -> (final_state, energies (length,))``.  The
    state's step counter must sit at the start of the cycle on entry."""
    round_len = sum(c for _, c in pattern)
    rounds, rem = divmod(length, round_len)
    if rem:
        raise ValueError(
            f"segment length {length} not a multiple of the {round_len}-step cycle"
        )
    if any(c < 1 for _, c in pattern):
        raise ValueError("pattern counts must be >= 1")

    def seg(state):
        ys = []
        for _ in range(rounds):
            for fn, cnt in pattern:
                for _ in range(cnt):
                    state, y = fn(state, None)
                    ys.append(y)
        return state, torch.stack(ys)

    return seg
