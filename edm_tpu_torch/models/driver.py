"""Simulation driver — the ``fix edm`` / ``fix edm_pair`` host loop
(reference lammps/fix_edm.cpp:134-162, fix_edm_pair.cpp:139-256): run MD
in segments of ``write_stride`` steps, and after each write the bias grid,
the CV histogram (then reset it: "The histogram is reset every time the
bias file is rewritten", reference README.md:139-141), the LAMMPS table
``.ltab`` of 1-D pairwise runs, and the HILLS event stream.

Counterpart of ``edm_tpu/models/driver.py``.  JAX scans the steps of a
segment inside one compiled program; here a segment is a Python loop over
the steps, each of which launches its own kernels (capturing a cycle as a
CUDA graph is later work, ROADMAP Queue 1, item 2).  A step object with a
``check_phase`` method is checked against its place in the cycle before
the first step.  A segment's outputs stay on the device until it ends.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..utils import trace
from ..utils.gridio import write_grid, write_lammps_table
from ..utils.hills_log import to_host


def stack_outputs(ys):
    """Per-step outputs -> one output with a leading step axis: tensors
    stacked, tuples (and NamedTuples such as ``bias.HillRoundLog``) field
    by field."""
    y0 = ys[0]
    if isinstance(y0, torch.Tensor):
        return torch.stack(ys)
    fields = [stack_outputs(list(f)) for f in zip(*ys)]
    return type(y0)(*fields) if hasattr(y0, "_fields") else type(y0)(fields)


def pattern_segment(pattern, length: int, unroll: int = 2):
    """``pattern``: a list of ``(step_fn, count)`` entries, one cycle of
    static phase steps in order; ``length`` a whole number of cycles.
    Returns ``seg(state) -> (final_state, ys)``, the steps' outputs stacked
    (``stack_outputs``: energies (length,), or with ``collect_records``
    (energies, records)).  The
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
        with trace.span(trace.SEGMENT):
            ys = []
            for _ in range(rounds):
                for fn, cnt in pattern:
                    for _ in range(cnt):
                        state, y = fn(state, None)
                        ys.append(y)
            return state, stack_outputs(ys)

    return seg


def check_hill_phase(do_hills, hill_stride: int, pos: int, cycle: int):
    """Raise unless a step whose static hill phase is ``do_hills`` sits at
    step ``pos`` of a ``cycle``-step cycle where the JAX host's
    ``step % hill_stride == 0`` puts that phase (the ``check_phase`` of the
    coordinate and the all-pairs hosts); a dynamic step (None) fits every
    place."""
    if do_hills is None:
        return
    if cycle % hill_stride:
        raise ValueError(f"a {cycle}-step cycle is not a whole number of "
                         f"hill_stride {hill_stride}")
    if (pos % hill_stride == 0) != do_hills:
        raise ValueError(f"step {pos} of the cycle is {'not ' * do_hills}a hill "
                         f"step under hill_stride {hill_stride}")


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


def _bias_of(state):
    core = state.core if hasattr(state, "core") else state
    return core.bias


def _with_bias(state, new_bias):
    if hasattr(state, "core"):
        return dataclasses.replace(state, core=dataclasses.replace(state.core, bias=new_bias))
    return dataclasses.replace(state, bias=new_bias)


def run_simulation(
    step_fn: Callable,
    state,
    n_steps: int,
    write_stride: int,
    bias_file: Optional[str] = None,
    histogram_file: Optional[str] = None,
    lammps_table: Optional[str] = None,
    box_low=None,
    box_high=None,
    progress: Optional[Callable] = None,
    hills_log=None,
    step_hill: Optional[Callable] = None,
    hill_stride: Optional[int] = None,
):
    """Drive ``step_fn`` (``(state, None) -> (state, energy)``, any host's
    step) for ``n_steps`` in segments of ``write_stride`` steps, writing the
    outputs after each; returns the final state and the last segment's
    per-step energies.  Works on ``CoordEDMState``, ``PairEDMState`` (the
    dense and the blocked pair hosts) and ``CellPairState`` (the bias state
    is found through ``.core`` where there is one).

    ``hills_log`` (``utils.hills_log.HillsLog``): ``step_fn`` must have been
    built with ``collect_records=True``.  A segment's records stay on the
    device; after the segment they come to the host in one copy and are
    replayed into the reference-format HILLS stream (output_hill,
    edm_bias.cpp:586-599), the step column counting hill rounds
    (edm_bias.cpp:582).

    ``step_hill`` + ``hill_stride``: when ``write_stride`` is a whole number
    of hill strides, the segments run through ``strided_segment(step_hill,
    step_fn, ...)``: ``step_hill`` is then the ``static_do_hills=True``
    step and ``step_fn`` the ``False`` one.  ``progress(done, state,
    energies)`` is called after each write; the histogram is cleared at
    every write, as in the reference."""
    if step_hill is not None and hill_stride and write_stride % hill_stride == 0:
        seg = strided_segment(step_hill, step_fn, hill_stride, write_stride)
    else:
        def seg(s):
            ys = []
            for _ in range(write_stride):
                s, y = step_fn(s, None)
                ys.append(y)
            return s, stack_outputs(ys)

    if hills_log is not None:
        bs = _bias_of(state)
        counters = to_host((bs.steps, bs.cum_bias))
        round_counter, cum_run = int(counters[0]), float(counters[1])

    energies = None
    done = 0
    while done < n_steps:
        state, out = seg(state)
        if hills_log is not None:
            energies, logs = out
            logs = to_host(logs)  # the segment's records, one copy
            for i in np.nonzero(logs.happened)[0]:
                rec_i = type(logs.rec)(*(a[i] for a in logs.rec))
                hills_log.log_round(round_counter, cum_run, rec_i, logs.positions[i])
                cum_run += float(rec_i.round_bias)
                round_counter += 1
        else:
            energies = out
        done += write_stride

        bs = _bias_of(state)
        if bias_file:
            write_grid(bs.bias.grid, bias_file)
        if lammps_table and box_low is not None:
            write_lammps_table(bs.bias.grid, lammps_table, box_low, box_high)
        if histogram_file:
            write_grid(bs.cv_hist, histogram_file)
            state = _with_bias(state, dataclasses.replace(bs, cv_hist=bs.cv_hist.clear()))
        if progress is not None:
            progress(done, state, energies)

    return state, energies
