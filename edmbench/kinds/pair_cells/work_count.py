"""The pair kind's work count: the operations and bytes a plain step
needs, whatever implements it (``edmbench/peaks.py`` turns them into the
least time on an H100).

A plain step needs, for each unordered pair of atoms within the reach of
its interactions (the larger of the LJ cutoff and the CV's box_high), the
pair arithmetic once (forces are antisymmetric), and the bias lookup for
each pair inside the CV's domain; for each atom the BAOAB stages and three
thermostat normals from the counter hash.  Its bytes are each atom's
position, velocity, force and mask read once and its position, velocity
and force written once, and the bias table read once.  The operation
counts per pair are those frozen from ``chip_smoke.py`` (counted from
``csrc/cellforce.cu`` and ``csrc/hashrng.cu``)."""

from __future__ import annotations

import torch

from . import reference as R

# operations per pair within reach (r^2, r, LJ, the force and its row and
# credit sums) and per lookup of the exact Hermite table
PAIR_FLOPS, HERMITE_FLOPS = 48, 16
# per atom: BAOAB's two kicks, two drifts and the O update, 11 operations
# a component; a normal: two hashes of 12 integer operations (at half the
# float32 rate), two uniforms of 2 and Box-Muller's 7
BAOAB_FLOPS = 33
NORMAL_FLOPS = 2 * (2 * 12 + 2) + 7
BYTES_PER_ATOM = 4 * (3 + 3 + 3 + 1) + 4 * (3 + 3 + 3)


def pair_counts(x, box, reach: float, cv_reach: float) -> tuple:
    """(unordered pairs within ``reach``, those within ``cv_reach``) of
    positions ``x``."""
    near, cv = 0, 0
    for _, _, _, r2, ok in R.Pairs(x, box, reach).tiles():
        near += int((ok & (r2 <= reach * reach)).sum())
        cv += int((ok & (r2 < cv_reach * cv_reach)).sum())
    return near, cv


def plain_step(cfg: dict, x, box) -> dict:
    """A plain step's operations and bytes at positions ``x``."""
    bh = float(cfg["bias"]["box_high"])
    reach = max(float(cfg["lj"]["rcut"]), bh)
    near, cv = pair_counts(x, box, reach, bh)
    n = x.shape[0]
    g = int(round(bh / float(cfg["bias"]["bias_spacing"]))) + 1
    flops = near * PAIR_FLOPS + cv * HERMITE_FLOPS + n * (BAOAB_FLOPS + 3 * NORMAL_FLOPS)
    nbytes = n * BYTES_PER_ATOM + 4 * 4 * g
    return dict(flops=float(flops), bytes=float(nbytes), pairs=near, cv_pairs=cv)


def positions_of(snap: dict, n: int) -> torch.Tensor:
    """A snapshot's positions in atom order."""
    x, _ = R.atoms_of(snap["aid"], snap["xs"].reshape(-1, 3), n)
    return x


def work(cfg: dict, snap: dict, geom: dict) -> dict:
    """The plain step's work at the positions of its snapshot ``snap``."""
    return plain_step(cfg, positions_of(snap, geom["n_atoms"]), geom["box"])
