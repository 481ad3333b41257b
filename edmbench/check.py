"""How ``correct`` is decided, whatever the kind: the kind's ``judge``
gives each number it compares (``NUMBERS``) over the steps that the run
kept, each judged against the kind's plain reference, and each number has
its limit in ``limits/<configuration>.json``, which holds exactly the
kind's ``NUMBERS``; ``PERF.md`` gives the readings each was set from.

One number is the harness's own, on a sharded host: ``rank_mismatch``,
the ranks whose final state (the kind's ``replicated`` leaves) differs
bitwise from rank 0's, whose state every rank replicates.  It is compared
where the kind lists it among its ``NUMBERS``.
"""

from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
LIMITS = os.path.join(HERE, "limits")


def limits(config: str) -> dict:
    with open(os.path.join(LIMITS, config + ".json")) as f:
        return json.load(f)


def _excess(x: float) -> float:
    """``x`` above 0, or 0; a NaN stays NaN, so that it fails."""
    return x if x != x else max(0.0, x)


def _fold(worst: dict, values: dict):
    for k, v in values.items():
        worst[k] = v if v != v else max(worst.get(k, 0.0), v)  # a NaN stays


def worst_of(parts) -> dict:
    """Each number's worst over ``parts`` (the kept steps, or the ranks'
    shares of them); a NaN stays."""
    worst = {}
    for p in parts:
        _fold(worst, p)
    return worst


def verdict(values: dict, lim: dict) -> tuple:
    """(correct, failed names, {name: {"value", "limit"}}), in the limits'
    order; a number that is not a finite value fails."""
    rows, failed = {}, []
    for k in lim:
        if k not in values:
            continue
        v = values[k]
        rows[k] = {"value": v, "limit": lim[k]}
        if not (v == v and v <= lim[k]):
            failed.append(k)
    return not failed, failed, rows
