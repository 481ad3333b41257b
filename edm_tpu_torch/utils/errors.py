"""Error base (reference lib/edm.cpp:4-7 prints ``[EDM:location] msg`` and
aborts).  A copy of ``edm_tpu/utils/errors.py``: importing it from
``edm_tpu`` would pull in jax through ``edm_tpu/__init__.py``.

Host-side configuration errors raise ``EDMError``; device-side invariants
use flags that the host checks.
"""

from __future__ import annotations


class EDMError(RuntimeError):
    def __init__(self, msg: str, location: str = ""):
        super().__init__(f"[EDM:{location}] {msg}" if location else f"[EDM] {msg}")
        self.location = location


def edm_error(msg: str, location: str = "") -> None:
    raise EDMError(msg, location)
