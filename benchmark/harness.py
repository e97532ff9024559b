"""What every mode shares: the cell's files, the program's configuration,
the seeded weights, host spans, the traced window, the reference's
verdict and the result line.

A cell (``Cell``) is one workload file, ``workloads/<name>.json``: its
configuration (``configs/<config>.json``), ``mode`` (a module of
``modes/``), ``precision``, ``traffic`` (read by ``traffic/<kind>.py``)
and ``limits``.  The mode module's ``run(cell)`` sets up, measures, checks
and returns a ``Outcome``; ``result_line`` turns it into the JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import json
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import judge
from .reference.config import Config

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def read_json(*parts) -> dict:
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config_file: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float                       # the process's clock at start
    ref_cfg: Config = None
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)

    @staticmethod
    def load(name: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, config_override: Optional[dict] = None,
             traffic_override: Optional[dict] = None) -> "Cell":
        """``config_override`` / ``traffic_override`` replace keys of the
        configuration and the traffic (the CPU tests' small sizes)."""
        workload = read_json("workloads", f"{name}.json")
        config_file = read_json("configs", f"{workload['config']}.json")
        if config_override:
            config_file = {**config_file,
                           "config": {**config_file["config"],
                                      **config_override}}
        if traffic_override:
            workload = {**workload, "traffic": {**workload["traffic"],
                                                **traffic_override}}
        cell = Cell(name, workload, config_file, int(seed), float(seconds),
                    bool(trace), torch.device(device), t_start)
        cell.ref_cfg = Config.from_dict(config_file["config"])
        return cell

    @property
    def mode(self) -> str:
        return self.workload["mode"]

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def port_config(self):
        """The program's ``DSVTConfig``: the configuration file's keys, at
        the cell's precision."""
        from dsvt_ai_trt_tpu_torch.config import DSVTConfig

        cfg = DSVTConfig.from_json(json.dumps(self.config_file["config"]))
        return dataclasses.replace(cfg, precision=self.workload["precision"])

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        """Time a harness span on the host clock (kept per name), and label
        it for the profiler."""
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.setdefault(name, []).append(
                    time.perf_counter() - t0)

    def free(self) -> None:
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: Dict[str, float]            # end-to-end, by name
    numbers: Dict[str, float]            # the judged gaps
    layer: Dict[str, object] = dataclasses.field(default_factory=dict)
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None
    memory_peak_bytes: int = 0


def run_mode(cell: Cell) -> Outcome:
    module = importlib.import_module(f"{__package__}.modes.{cell.mode}")
    return module.run(cell)


def peak_memory(cell: Cell) -> int:
    return int(torch.cuda.max_memory_allocated(cell.device)) \
        if cell.on_card else 0


def wait_until(t: float) -> None:
    """Sleep until the host clock reads ``t`` (the last millisecond spun)."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 2e-3:
            time.sleep(left - 1e-3)


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile (the smallest value with at
    least q % of the values at or below it)."""
    v = np.sort(np.asarray(values, np.float64))
    rank = int(np.ceil(q / 100.0 * len(v)))
    return float(v[max(rank, 1) - 1])


def read_layer_metrics(cell: Cell, ctx: dict, names: List[str]) -> dict:
    """Run each per-layer metric's reader (``metrics/<name>.py``) on
    ``ctx``; a reader that finds nothing returns None and is left out."""
    from .manifest import metric_reader

    out = {}
    for name in names:
        value = metric_reader(name).read(ctx)
        if value is not None:
            out[name] = value
    return out


def result_line(cell: Cell, outcome: Outcome, correct: bool, rows,
                bench: dict) -> dict:
    """The JSON object of the run (the benchmark contract's keys)."""
    units = {m["name"]: m["unit"] for m in
             bench["end_to_end"] + bench["per_layer"]}
    source = outcome.layer if cell.trace else outcome.metrics
    metrics = {k: {"value": float(v), "unit": units[k]}
               for k, v in source.items() if k in units}
    device = {"platform": "gpu" if cell.on_card else "cpu",
              "kind": (torch.cuda.get_device_name(cell.device)
                       if cell.on_card else "cpu"),
              "count": 1, "memory_peak_bytes": outcome.memory_peak_bytes}
    if cell.trace:
        device["busy_s"] = outcome.busy_s
        device["window_s"] = outcome.window_s
    line = {"correct": bool(correct), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": device}
    if cell.trace and outcome.breakdown:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in rows}
    return line


def verdict(cell: Cell, numbers: Dict[str, float]):
    return judge.verdict(numbers, cell.workload["limits"])
