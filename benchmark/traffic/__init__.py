"""Traffic generators, one module per kind.

A workload file's ``traffic`` object names its ``kind``; ``generate``
imports ``benchmark.traffic.<kind>`` and calls its ``generate(params,
seed, cfg)``.  A new mix of an existing kind is a new workload file; a new
kind is a new module here.
"""

from __future__ import annotations

import importlib


def generate(params: dict, seed: int, cfg):
    module = importlib.import_module(f"{__name__}.{params['kind']}")
    return module.generate(params, seed, cfg)
