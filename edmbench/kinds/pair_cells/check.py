"""How the pair kind's steps are judged: the steps of one stride cycle
that the window ran (its hill step, one plain step and its rebuild step,
the cycle and the plain step drawn from the seed), each against the plain
reference (``reference.predict``) from the program's own state before it.

A gap is the worst over atoms, grid points or the checked steps:

- ``force_gap``: the largest difference of an atom's force from the
  reference's, less the force of its pairs that lie within float32
  rounding of a cut-off, over the forces' scale (the largest sum over an
  atom of its pair forces' sizes, which float32 rounds);
- ``position_gap``: the largest difference of a position, over the
  largest distance an atom moved in the step plus the float32 spacing of
  the largest coordinate;
- ``velocity_gap``: the largest difference of a velocity, over the
  largest velocity;
- ``energy_gap``: the hill step's bias energy against the reference's;
- ``grid_gap``: the hill round's change of the bias grid (values and
  derivatives) against the reference's, less what the hills that lie
  within float32 rounding of a target bin's edge would change in the
  other bin, over its largest change;
- ``cum_bias_gap``: the round's bias added against the reference's, less
  the same allowance;
- ``calls_gap``: the round's candidate count against the reference's;
- ``table_mismatch``: slots whose atom differs from the reference's
  rebuild, and the tail and fallback counts where the cell has a kernel
  cap;
- ``state_mismatch``: the Threefry key, the step counter, atoms the slot
  table holds other than once, the deferred-hill count, and the
  truncation and overflow flags;
- ``rank_mismatch`` (sharded hosts only): the harness's own
  (``edmbench/check.py``).
"""

from __future__ import annotations

import torch

from ...check import _excess, _fold

from . import reference as R

F32_EPS = 2.0 ** -23
NUMBERS = ("force_gap", "position_gap", "velocity_gap", "energy_gap", "grid_gap",
           "cum_bias_gap", "calls_gap", "table_mismatch", "state_mismatch", "rank_mismatch")


def _rel(a, b, tiny=1e-300):
    d = float(torch.abs(a - b).max())
    s = float(torch.abs(b).max())
    return 0.0 if d == 0 else d / max(s, tiny)


def _grid_gap(cand, pred, before, allow):
    """The round's change of a grid against the reference's, less the
    allowance of its hills on a target bin's edge, over its largest
    change."""
    before = before.double()
    d = torch.clamp(torch.abs((cand - before) - (pred - before)) - allow, min=0.0)
    return float(d.max()) / max(float(torch.abs(pred - before).max()), 1e-300)


def candidate(geom: dict, s0: dict, s1: dict) -> dict:
    """The program's step output in the reference's terms: atom-order
    float64 arrays and plain numbers."""
    n, S = geom["n_atoms"], geom["cells_padded"] * geom["cap"]
    out = {}
    for k, name in (("x", "xs"), ("v", "vs"), ("f", "fs")):
        out[k], miss = R.atoms_of(s1["aid"], s1[name].reshape(S, 3).double(), n)
    out.update(table_misses=miss, key=s1["key"], step=int(s1["step"]),
               energy=float(s1["energy"]), grid_values=s1["grid_values"].double(),
               grid_derivs=s1["grid_derivs"].double(), cum_bias=float(s1["cum_bias"]),
               last_calls=int(s1["last_calls"]), aid=s1["aid"],
               deferred=int(s1["buf_right"]) - int(s1["buf_left"]),
               truncated=bool(s1["hills_truncated"]) and not bool(s0["hills_truncated"]),
               overflow=bool(s1["table_overflow"]))
    if "tail_count" in s1:
        out.update(tail_count=int(s1["tail_count"]), tail_fallbacks=int(s1["tail_fallbacks"]))
    return out


def gaps(phase: str, s0: dict, pred: dict, cand: dict) -> dict:
    """The numbers of one step: ``cand`` (the program's, or the control's)
    against ``pred`` (the reference's)."""
    g = {}
    scale = float(torch.abs(pred["x"] - pred["x_start"]).max()) + F32_EPS * float(
        torch.abs(pred["x"]).max())
    g["position_gap"] = float(torch.abs(cand["x"] - pred["x"]).max()) / scale
    g["velocity_gap"] = _rel(cand["v"], pred["v"])
    df = torch.abs(cand["f"] - pred["f"]).amax(1) - pred["f_allow"]
    g["force_gap"] = _excess(float(df.max())) / max(pred["f_scale"], 1e-300)
    bad = int(cand["table_misses"]) + int(pred["table_misses"])
    bad += int(any(int(a) != int(b) for a, b in zip(cand["key"], pred["key"])))
    bad += int(cand["step"] != pred["step"]) + int(cand.get("overflow", False))
    if phase == "hill":
        de = abs(cand["energy"] - pred["energy"]) - pred["energy_allow"]
        g["energy_gap"] = _excess(de) / max(abs(pred["energy"]), 1e-300)
        av, ad, ac = pred["grid_allow"]
        g["grid_gap"] = max(_grid_gap(cand["grid_values"], pred["grid_values"],
                                      s0["grid_values"], av),
                            _grid_gap(cand["grid_derivs"], pred["grid_derivs"],
                                      s0["grid_derivs"], ad))
        dc_r = pred["cum_bias"] - float(s0["cum_bias"])
        dc_p = cand["cum_bias"] - float(s0["cum_bias"])
        g["cum_bias_gap"] = _excess(abs(dc_p - dc_r) - ac) / max(abs(dc_r), 1e-300)
        g["calls_gap"] = abs(cand["last_calls"] - pred["last_calls"]) / max(pred["last_calls"], 1)
        bad += int(cand["deferred"] != pred["deferred"])
        bad += int(cand["truncated"] != pred["truncated"])
    if phase == "rebuild":
        t = int((cand["aid"] != pred["aid"]).sum())
        if "tail_count" in pred:
            t += int(cand["tail_count"] != pred["tail_count"])
            t += int(cand["tail_fallbacks"] != pred["tail_fallbacks"])
        g["table_mismatch"] = float(t)
    g["state_mismatch"] = float(bad)
    return g


def control_candidate(pred_lo: dict) -> dict:
    """The control in the program's place: the reference computed in a
    lower precision, its outputs read as the program's would be."""
    out = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
           for k, v in pred_lo.items()}
    out["table_misses"] = 0
    return out


def judge(cfg: dict, geom: dict, steps, dtype=None) -> tuple:
    """``steps``: [(phase, s0, s1)] of the checked cycle.  Returns (each
    number's worst value over the steps: the program's, or with ``dtype``
    the control's, the reference computed in that precision in the
    program's place; the notes: ``missed_pairs``, the pairs within reach
    that the slot table did not list, never compared)."""
    worst, missed = {}, 0
    for phase, s0, s1 in steps:
        pred = R.predict(cfg, geom, s0, s1, phase)
        missed += pred["missed_pairs"]
        if dtype is None:
            cand = candidate(geom, s0, s1)
        else:
            cand = control_candidate(R.predict(cfg, geom, s0, s1, phase, dtype=dtype))
        _fold(worst, gaps(phase, s0, pred, cand))
        del pred, cand
    return worst, {"missed_pairs": missed}
