""".edm input-file parsing (reference lib/edm_bias.cpp:986-1095).  A copy of
``edm_tpu/utils/config.py``, which cannot be imported without jax.

Format: whitespace-separated ``key value...`` lines; the first token of a
line is the key and the rest of the line the value (istream>>pair,
edm_bias.cpp:19-31).  Reference quirks replicated deliberately:

* duplicate keys: *first* occurrence wins (std::map insert_iterator
  semantics, edm_bias.cpp:999-1004);
* unknown keys are silently ignored (``//`` comment lines work only
  because of this);
* double-valued keys that parse to exactly 0.0 are rejected as invalid
  (extract_double, edm_bias.cpp:937-940) — required keys error, optional
  keys fall back to their defaults;
* ``bias_per_step`` defaults to ``hill_prefactor`` (edm_bias.cpp:1022-1023);
* ``dimension`` must be 1..3 (edm_bias.cpp:1031-1034).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .errors import edm_error


@dataclasses.dataclass(frozen=True)
class EDMConfig:
    dim: int
    b_tempering: bool
    bias_factor: float
    global_tempering: float
    hill_prefactor: float
    bias_per_step: float
    hill_density: float
    bias_dx: Tuple[float, ...]
    bias_sigma: Tuple[float, ...]
    box_low: Tuple[float, ...]
    box_high: Tuple[float, ...]
    target_filename: Optional[str]
    initial_bias_filename: Optional[str]
    hills_filename: str
    histogram_filename: str


def _parse_pairs(text: str) -> dict:
    pairs = {}
    for line in text.splitlines():
        parts = line.split(None, 1)
        if not parts:
            continue
        key = parts[0]
        value = parts[1] if len(parts) > 1 else ""
        if key not in pairs:  # first occurrence wins
            pairs[key] = value
    return pairs


def _extract_double(key, pairs, required):
    if key in pairs:
        try:
            v = float(pairs[key].split()[0])
        except (ValueError, IndexError):
            v = 0.0
        if v == 0.0:
            if required:
                edm_error(f"Invalid value found for {key}", "config:extract_double")
            return None
        return v
    if required:
        edm_error(f"Could not find key {key}", "config:extract_double")
    return None


def _extract_int(key, pairs, required):
    if key in pairs:
        tok = pairs[key].split()
        try:
            return int(float(tok[0])) if tok else 0
        except ValueError:
            return 0
    if required:
        edm_error(f"Could not find key {key}", "config:extract_int")
    return None


def _extract_array(key, pairs, required, length):
    if key in pairs:
        toks = pairs[key].split()
        if len(toks) < length:
            edm_error(f"Not enough values for {key}", "config:extract_array")
        return tuple(float(t) for t in toks[:length])
    if required:
        edm_error(f"Could not find key {key}", "config:extract_array")
    return None


def parse_edm_text(text: str) -> EDMConfig:
    pairs = _parse_pairs(text)

    b_tempering = _extract_int("tempering", pairs, required=True)
    bias_factor = 0.0
    global_tempering = 0.0
    if b_tempering:
        bias_factor = _extract_double("bias_factor", pairs, required=True)
        gt = _extract_double("global_tempering", pairs, required=False)
        global_tempering = gt if gt is not None else 0.0

    hill_prefactor = _extract_double("hill_prefactor", pairs, required=True)
    bps = _extract_double("bias_per_step", pairs, required=False)
    bias_per_step = bps if bps is not None else hill_prefactor
    hd = _extract_double("hill_density", pairs, required=False)
    hill_density = hd if hd is not None else -1.0

    dim = _extract_int("dimension", pairs, required=True)
    if dim == 0 or dim > 3:
        edm_error(f"Invalid dimension {dim}", "config:parse")

    bias_dx = _extract_array("bias_spacing", pairs, required=True, length=dim)
    bias_sigma = _extract_array("bias_sigma", pairs, required=True, length=dim)
    box_low = _extract_array("box_low", pairs, required=True, length=dim)
    box_high = _extract_array("box_high", pairs, required=True, length=dim)

    def clean(key, default=None):
        if key in pairs:
            return pairs[key].strip()
        return default

    return EDMConfig(
        dim=dim,
        b_tempering=bool(b_tempering),
        bias_factor=bias_factor,
        global_tempering=global_tempering,
        hill_prefactor=hill_prefactor,
        bias_per_step=bias_per_step,
        hill_density=hill_density,
        bias_dx=bias_dx,
        bias_sigma=bias_sigma,
        box_low=box_low,
        box_high=box_high,
        target_filename=clean("target_filename"),
        initial_bias_filename=clean("initial_bias_filename"),
        hills_filename=clean("hills_filename", "HILLS"),
        histogram_filename=clean("histogram_filename", "HIST"),
    )


def parse_edm_file(path: str) -> EDMConfig:
    with open(path) as f:
        return parse_edm_text(f.read())
