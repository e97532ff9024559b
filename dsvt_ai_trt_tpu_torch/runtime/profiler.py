"""Per-stage timing and FLOP counts (port of the JAX package's
runtime/profiler.py).

* ``stage_scope(name)`` is what ``model/detector.py:forward`` runs each of
  its stages (``STAGES``) under: a ``record_function`` label, so a profiler
  trace splits a frame by stage (runtime/trace.py reads them), plus the
  hooks ``count_flops`` and ``profile_stages`` set while they run.
* ``count_flops(fn, *args)`` counts the FLOPs of one call, in total and per
  stage: ``torch.utils.flop_counter.FlopCounterMode`` over the call (it
  counts matmuls and convolutions), plus the FLOPs of every hand-written
  kernel launched during it, from the formula beside each wrapper
  (``kernels.count``): the counter sees nothing inside a ``ctypes`` launch.
  The formulas count what the counter counts for the plain versions (the
  products of B1 and B2) and the compares of B3 and B4, so an MFU means
  nearly the same work whichever version ran (B1's formula counts live
  sets only; B3's and B4's compares are a few MFLOP of a frame).
* ``device_peak_flops`` reads the card's name; ``StageTimer`` times stages
  on the host clock, synchronising the card around each.

``profile_stages`` is a debugging aid: it syncs the card around every stage,
so its stage times carry each sync's latency and no overlap; for per-stage
device time use ``runtime/trace.capture``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, ContextManager, Dict, List, NamedTuple

import torch
from torch.profiler import record_function
from torch.utils.flop_counter import FlopCounterMode

from .. import kernels

# stage hooks of the count_flops / profile_stages calls running now: each
# takes a stage name and gives a context manager to run the stage in
_scopes: List[Callable[[str], ContextManager]] = []


@contextlib.contextmanager
def stage_scope(name: str):
    """Run one detector stage: a profiler label, plus the active hooks."""
    with record_function(name):
        if not _scopes:
            yield
            return
        with contextlib.ExitStack() as stack:
            for scope in list(_scopes):
                stack.enter_context(scope(name))
            yield


@contextlib.contextmanager
def _hooked(scope: Callable[[str], ContextManager]):
    _scopes.append(scope)
    try:
        yield
    finally:
        _scopes.remove(scope)


class FlopCount(NamedTuple):
    """FLOPs of one call: ``total``; per kernel name, the hand-written
    kernels' share (``kernels``); per stage label, kernels included
    (``stages``)."""

    total: float
    kernels: Dict[str, float]
    stages: Dict[str, float]


def count_flops(fn, *args) -> FlopCount:
    """Run ``fn(*args)`` once and count its FLOPs (module docstring)."""
    stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def per_stage(name):
        with kernels.flop_tally() as tally, FlopCounterMode(display=False) as fc:
            yield
        stages[name] = (stages.get(name, 0.0) + fc.get_total_flops()
                        + sum(tally.values()))

    with _hooked(per_stage), kernels.flop_tally() as tally, \
            FlopCounterMode(display=False) as fc:
        fn(*args)
    return FlopCount(float(fc.get_total_flops() + sum(tally.values())),
                     dict(tally), stages)


def program_flops(fn, *args) -> float:
    """Total FLOPs of one call of ``fn(*args)`` (``count_flops``)."""
    return count_flops(fn, *args).total


# Dense peak FLOP/s by card name and precision, from NVIDIA's data sheets
# (SXM and PCIe parts): "bf16" and "mixed" run their products on the bf16
# tensor cores, "fp32" on the f32 units with TF32 off (ops/common.py).
_PEAKS = (
    ("H100 PCIe", {"bf16": 756e12, "mixed": 756e12, "fp32": 51e12}),
    ("H100", {"bf16": 989e12, "mixed": 989e12, "fp32": 67e12}),
)


def device_peak_flops(precision: str = "bf16", device=None) -> float:
    """Peak FLOP/s of the card at ``precision`` (0.0 for a card not in the
    table, or without a card)."""
    if not torch.cuda.is_available():
        return 0.0
    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS:
        if key in name:
            return peaks[precision]
    return 0.0


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageTimer:
    """Accumulates per-stage host-clock times, synchronising the card
    (when ``device`` is one) before and after each stage."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self.flops: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, device=None):
        _sync(device)
        t0 = time.perf_counter()
        yield
        _sync(device)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {name: {"mean_ms": sum(v) / len(v) * 1e3,
                       "min_ms": min(v) * 1e3, "max_ms": max(v) * 1e3,
                       "calls": len(v)}
                for name, v in self.times.items()}

    def report(self) -> str:
        lines = [f"{'stage':<28}{'mean ms':>10}{'min ms':>10}{'max ms':>10}"
                 f"{'calls':>7}"]
        for name, s in self.summary().items():
            lines.append(f"{name:<28}{s['mean_ms']:>10.2f}{s['min_ms']:>10.2f}"
                         f"{s['max_ms']:>10.2f}{s['calls']:>7}")
        return "\n".join(lines)


@contextlib.contextmanager
def torch_trace(log_dir: str):
    """A ``torch.profiler`` trace (host, and the card when there is one)
    written under ``log_dir`` for TensorBoard (the JAX ``xla_trace``)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield log_dir


def profile_stages(params, points, num_points, cfg, iters: int = 10,
                   device="cuda") -> StageTimer:
    """Host-clock time of each stage of ``forward`` with the card synced
    around every stage, over ``iters`` warm frames; ``timer.flops`` holds
    each stage's FLOPs (``count_flops``).  A debugging aid (see the module
    docstring)."""
    from ..model.detector import forward

    def run():
        return forward(params, points, num_points, cfg, with_nms=True,
                       device=device)

    run()
    timer = StageTimer()
    with _hooked(lambda name: timer.stage(name, device)):
        for _ in range(iters):
            run()
    timer.flops = count_flops(run).stages
    return timer
