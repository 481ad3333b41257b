"""The kinds of system a configuration can run, one module (or package)
each, found by the configuration's ``kind`` (default ``pair_cells``):
``edmbench.kinds.<kind>``.  What a kind provides is listed in
``edmbench/README.md``; ``run.py`` drives any kind through it."""

from __future__ import annotations

import importlib

DEFAULT = "pair_cells"


def load(cfg: dict):
    """The kind module of configuration ``cfg``."""
    return importlib.import_module(f"{__name__}.{cfg.get('kind', DEFAULT)}")
