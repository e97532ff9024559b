"""``BENCHMARK.json`` and the files it names, found by name.

A cell is ``workloads/<cell>.json``, a configuration
``configs/<config>.json``, a per-layer metric ``metrics/<metric>.py``
(a module with ``read(ctx)``; metric names hold dots, so the file is
loaded by its path).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os

from .harness import HERE, ROOT


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def path_of(kind: str, name: str) -> str:
    ext = {"workloads": ".json", "configs": ".json", "metrics": ".py"}[kind]
    return os.path.join(HERE, kind, name + ext)


@functools.lru_cache(maxsize=None)
def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name}", path_of("metrics", name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layer_metrics(cell: str) -> list:
    """Names of the per-layer metrics this cell reports."""
    return [m["name"] for m in benchmark()["per_layer"]
            if cell in m.get("workloads", [cell])]
