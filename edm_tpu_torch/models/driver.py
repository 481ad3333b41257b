"""Simulation driver: run a host's static stride phases in their cycle.

Counterpart of ``edm_tpu/models/driver.py``'s ``pattern_segment`` and
``strided_segment``.  JAX scans the phase steps inside one compiled
program; here the segment is a Python loop over the phase steps, each of
which launches its own kernels (capturing a cycle as a CUDA graph is later
work, ROADMAP Queue 1, item 2).  A step object with a ``check_phase``
method is checked against its place in the cycle before the first step.
``run_simulation`` (file output) is not ported yet (item 5).
"""

from __future__ import annotations

import torch


def pattern_segment(pattern, length: int, unroll: int = 2):
    """``pattern``: a list of ``(step_fn, count)`` entries, one cycle of
    static phase steps in order; ``length`` a whole number of cycles.
    Returns ``seg(state) -> (final_state, energies (length,))``.  The
    state's step counter must sit at the start of the cycle on entry.
    ``unroll`` is accepted for the JAX signature and has no effect: an
    eager loop has no scan to unroll."""
    round_len = sum(c for _, c in pattern)
    rounds, rem = divmod(length, round_len)
    if rem:
        raise ValueError(
            f"segment length {length} not a multiple of the {round_len}-step cycle"
        )
    if any(c < 1 for _, c in pattern):
        raise ValueError("pattern counts must be >= 1")
    pos = 0
    for fn, cnt in pattern:  # each phase where its host's strides put it
        check = getattr(fn, "check_phase", None)
        for _ in range(cnt):
            if check is not None:
                check(pos, round_len)
            pos += 1

    def seg(state):
        ys = []
        for _ in range(rounds):
            for fn, cnt in pattern:
                for _ in range(cnt):
                    state, y = fn(state, None)
                    ys.append(y)
        return state, torch.stack(ys)

    return seg


def strided_segment(step_hill, step_plain, hill_stride: int, length: int,
                    unroll: int = 2):
    """``pattern_segment`` for the hills-only cycle: one
    ``static_do_hills=True`` step, then ``hill_stride - 1`` plain steps
    (``unroll``: as in ``pattern_segment``)."""
    if hill_stride > 1:
        pattern = [(step_hill, 1), (step_plain, hill_stride - 1)]
    else:
        pattern = [(step_hill, 1)]
    return pattern_segment(pattern, length, unroll=unroll)
