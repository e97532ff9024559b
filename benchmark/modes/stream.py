"""Streamed frames: the cell's sweeps cycled back to back through the
engine, ``in_flight`` frames in flight, every frame's boxes, count and
occupancy copied to the host and waited for (the port's
``runtime/infer.run_frames`` loop, over page-locked frames).

``frame_ms`` is the window's wall time over the frames it finished: the
loop dispatches while the window is open, then drains, and the window
closes when the last frame is on the host.  One warm pass over every
sweep runs first, in set-up; its frames are judged with the window's, so
every sweep is judged however short the window.  A traced run then traces
``traced_frames`` more frames of the same loop, each under a ``frame``
span, and the eager forward on a few sweeps for the stage split.
"""

from __future__ import annotations

import contextlib
import time

import torch

from ..harness import Cell, Outcome
from .serving import InFlight, Setup, eager_stages, finish

HOST_SPANS = ("enqueue", "readback", "wait")


def loop(cell: Cell, setup: Setup, frames, count=None, seconds=None,
         start=0, label=None):
    """Serve sweeps from ``start`` on, cycling, until ``count`` frames or
    ``seconds`` of dispatching; returns [(sweep, boxes, count, occ)]."""
    depth = cell.workload["traffic"]["in_flight"]
    n = len(frames)
    out, queue = [], []
    t_end = None if seconds is None else time.perf_counter() + seconds
    k = 0

    def done():
        i, inflight = queue.pop(0)
        with cell.span("wait"):
            out.append((i, *inflight.wait()))

    while (count is None or k < count) and (
            t_end is None or time.perf_counter() < t_end):
        i = (start + k) % n
        with (torch.profiler.record_function(label) if label
              else contextlib.nullcontext()):
            with cell.span("enqueue"):
                dets = setup.engine(*frames[i])
            with cell.span("readback"):
                queue.append((i, InFlight(dets, cell.on_card)))
            if len(queue) > depth:
                done()
        k += 1
    while queue:
        done()
    return out


def staged(cell: Cell, setup: Setup):
    """The sweeps in page-locked host memory (on the card), as the loop
    hands them to the engine."""
    return [(torch.from_numpy(p).pin_memory() if cell.on_card
             else torch.from_numpy(p), n) for p, n in setup.frames]


def run(cell: Cell) -> Outcome:
    setup = Setup(cell)
    frames = staged(cell, setup)
    warm = loop(cell, setup, frames, count=len(frames))   # warm pass
    cell.sync()
    cell.spans.clear()
    setup_s = time.perf_counter() - cell.t_start

    t0 = time.perf_counter()
    outputs = loop(cell, setup, frames, seconds=cell.seconds)
    window = time.perf_counter() - t0
    metrics = {"setup_s": setup_s, "frame_ms": window / len(outputs) * 1e3}

    trace = stages = None
    traced = []
    if cell.trace:
        from ..trace import capture

        spans = {k: list(v) for k, v in cell.spans.items()}
        start = len(outputs) % len(frames)
        n_traced = cell.workload["traced_frames"]
        more, trace = capture(lambda: loop(
            cell, setup, frames, count=n_traced, start=start,
            label="frame"), cell.device)
        outputs += more
        traced = [o[0] for o in more]
        stages = eager_stages(cell, setup)
        cell.spans = spans
    return finish(cell, setup, warm + outputs, metrics, trace, traced, stages,
                  HOST_SPANS)
