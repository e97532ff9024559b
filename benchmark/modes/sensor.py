"""Sensor-rate serving: an open loop at the LiDAR's rate.

Sweep ``i`` is due at ``t0 + i / rate_hz``; the host waits for that
moment, hands the sweep to the engine from pageable host memory (the
engine copies it in), and copies the boxes, count and occupancy back and
waits for them.  A sweep due while the one before it still runs starts
when that one is done, and the wait counts in its latency.  Every sweep
due in the window is served; ``latency_p95_ms`` is the nearest-rank 95th
percentile of (boxes on the host - due time) over all of them.  The warm
pass in set-up serves every sweep once; it is judged with the window's
sweeps, so every sweep is judged however short the window.  A traced
run then traces ``traced_frames`` more sweeps of the same loop, each
under a ``frame`` span.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..harness import Cell, Outcome, percentile, wait_until
from .serving import Setup, finish

HOST_SPANS = ("enqueue", "readback", "data")
LEAD_S = 0.05          # the first sweep is due this long after the start


def loop(cell: Cell, setup: Setup, count: int, start: int = 0,
         label=None):
    rate = cell.workload["traffic"]["rate_hz"]
    n = len(setup.frames)
    t0 = time.perf_counter() + LEAD_S
    out, lateness = [], []
    for k in range(count):
        due = t0 + k / rate
        with cell.span("data"):
            wait_until(due)
        i = (start + k) % n
        with (torch.profiler.record_function(label) if label
              else contextlib.nullcontext()):
            with cell.span("enqueue"):
                dets = setup.engine(*setup.frames[i])
            with cell.span("readback"):
                host = [t.cpu() for t in (dets.boxes, dets.count,
                                          dets.occupancy)]
        lateness.append(time.perf_counter() - due)
        out.append((i, host[0].numpy(), int(host[1]), host[2].numpy()))
    return out, lateness


def run(cell: Cell) -> Outcome:
    setup = Setup(cell)
    rate = cell.workload["traffic"]["rate_hz"]
    warm, _ = loop(cell, setup, len(setup.frames))        # warm pass
    cell.sync()
    cell.spans.clear()
    setup_s = time.perf_counter() - cell.t_start

    due = int(round(cell.seconds * rate))
    outputs, latency = loop(cell, setup, due)
    metrics = {"setup_s": setup_s,
               "latency_p95_ms": percentile(latency, 95) * 1e3}

    trace = None
    traced = []
    if cell.trace:
        from ..trace import capture

        spans = {k: list(v) for k, v in cell.spans.items()}
        (more, _), trace = capture(lambda: loop(
            cell, setup, cell.workload["traced_frames"],
            start=due % len(setup.frames), label="frame"), cell.device)
        outputs += more
        traced = [o[0] for o in more]
        cell.spans = spans
    return finish(cell, setup, warm + outputs, metrics, trace, traced, None,
                  HOST_SPANS)
