"""What the serving modes share: the cell's sweeps and weights, the engine,
a frame's readback, the reference's verdict on the served frames, and the
traced window's per-layer context.

Set-up: the sweeps from the seed (``traffic``), their occupancy counted
by the reference (a sweep at a cap fails the run), the raw checkpoint made
on the card from the seed, its heatmap bias calibrated by the reference's
own forward pass over every sweep (``weights.calibrate_heatmap``), then
the program: ``prepare_params`` of
the raw checkpoint and one ``Engine(params, cfg, with_nms=True)``, warmed
(its kernels built or loaded from ``build/kernels/<digest>/``, its CUDA
graph captured).  The device's peak memory is counted from the engine on.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import judge, traffic, work
from ..harness import Cell, Outcome, peak_memory, read_layer_metrics
from ..manifest import layer_metrics
from ..reference import counts, detector
from ..reference import weights as ref_weights
from ..reference.precision import matmul_flags, rounding
from ..trace import capture, stage_ms

SPARSE = ("voxelize", "vfe", "partition", "backbone3d")
BEV = ("backbone2d", "head")
EAGER_FRAMES = 8       # frames of the eager trace that splits stages


class Setup:
    def __init__(self, cell: Cell):
        cfg, dev = cell.ref_cfg, cell.device
        self.frames = traffic.generate(cell.workload["traffic"], cell.seed,
                                       cfg)
        self.occ = [counts.occupancy(p, n, cfg) for p, n in self.frames]
        cap = counts.caps(cfg)
        for i, o in enumerate(self.occ):
            if np.any(o >= cap):
                raise ValueError(f"sweep {i}: occupancy {o.tolist()} reaches "
                                 f"a cap {cap.tolist()}")
        self.raw = ref_weights.seeded_raw(cfg, cell.seed, dev)
        params = ref_weights.fold(self.raw, cfg)
        with matmul_flags("fp32"):
            maps = [detector.heatmap(params, torch.from_numpy(p).to(dev), n,
                                     cfg) for p, n in self.frames]
        ref_weights.calibrate_heatmap(self.raw, maps,
                                      cell.workload["confident_boxes"],
                                      cfg.top_k)
        del params, maps
        cell.free()
        if cell.on_card:
            torch.cuda.reset_peak_memory_stats(dev)

        from dsvt_ai_trt_tpu_torch.runtime.compile import Engine
        from dsvt_ai_trt_tpu_torch.weights import prepare_params

        self.port_cfg = cell.port_config()
        self.engine = Engine(prepare_params(ref_weights.to_numpy(self.raw),
                                            self.port_cfg),
                             self.port_cfg, device=dev, with_nms=True)
        self.engine.warmup()


class InFlight:
    """One frame's boxes, count and occupancy on their way to the host:
    copies into page-locked buffers and an event behind them (the port's
    ``runtime/infer.run_frames`` readback)."""

    def __init__(self, dets, on_card: bool):
        self.host = []
        for t in (dets.boxes, dets.count, dets.occupancy):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=on_card)
            buf.copy_(t, non_blocking=on_card)
            self.host.append(buf)
        self.event = None
        if on_card:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
        boxes, count, occ = (t.numpy() for t in self.host)
        return boxes.copy(), int(count), occ.copy()


def reference(cell: Cell, setup: Setup, sweeps, precision="fp32"):
    """The reference's ``Detection`` of each sweep in ``sweeps``, at
    ``precision`` (the control's: reference/precision.py)."""
    cfg, dev = cell.ref_cfg, cell.device
    params = ref_weights.fold(setup.raw, cfg)
    out = {}
    with matmul_flags(precision):
        for i in sweeps:
            pts, n = setup.frames[i]
            out[i] = detector.detect(params, torch.from_numpy(pts).to(dev), n,
                                     cfg, rounding(precision))
    return out


def reference_verdict(cell: Cell, setup: Setup, outputs):
    """(the numbers over every served frame, frames over a limit): the
    reference runs each sweep that was served once, after the program is
    freed."""
    refs = reference(cell, setup, sorted({o[0] for o in outputs}))
    frames = judge.serving_numbers(outputs, refs, cell.ref_cfg)
    limits = {k: v for k, v in cell.workload["limits"].items()
              if k in frames[0]}
    bad = sum(not judge.verdict(f, limits)[0] for f in frames)
    return judge.combine(frames), bad


def served_flops(cell: Cell, setup: Setup, sweeps: List[int]) -> float:
    return sum(work.frame_flops(cell.ref_cfg, setup.occ[i]) for i in sweeps)


def eager_stages(cell: Cell, setup: Setup) -> dict:
    """Device ms a frame by the port's stage labels, in a trace of
    ``Engine.eager`` on the cell's first sweeps (the labels do not fire
    inside a graph replay)."""
    n = min(EAGER_FRAMES, len(setup.frames))
    dev = cell.device
    staged = [(torch.from_numpy(p).to(dev), c) for p, c in setup.frames[:n]]

    def run():
        for pts, c in staged:
            setup.engine.eager(pts, c).count.cpu()
    run()
    _, trace = capture(run, dev)
    return stage_ms(trace, SPARSE + BEV, n)


def layer_context(cell: Cell, setup: Setup, trace, traced_sweeps, stages):
    """What the per-layer readers read (benchmark/metrics/)."""
    cfg = cell.ref_cfg
    return {"cell": cell.name, "mode": cell.mode, "spans": cell.spans,
            "trace": trace, "stages": stages, "traced_frames": traced_sweeps,
            "flops": served_flops(cell, setup, traced_sweeps),
            "peak_flops": work.PEAK_FLOPS[cell.workload["precision"]],
            "set_attention_s": sum(work.set_attention_seconds(
                cfg, setup.occ[i], 2) for i in traced_sweeps),
            "encoder_epilogue_s": sum(work.encoder_epilogue_seconds(
                cfg, setup.occ[i], 2) for i in traced_sweeps)}


def finish(cell: Cell, setup: Setup, outputs, metrics, trace, traced_sweeps,
           stages, host_names) -> Outcome:
    """Read the peak, free the program, judge the outputs; read the
    per-layer metrics of a traced run."""
    peak = peak_memory(cell)
    layer, breakdown = {}, None
    if cell.trace:
        ctx = layer_context(cell, setup, trace, traced_sweeps, stages)
        layer = read_layer_metrics(cell, ctx, layer_metrics(cell.name))
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps(host_names)}
    setup.engine = None
    cell.free()
    numbers, failed = reference_verdict(cell, setup, outputs)
    return Outcome(attempted=len(outputs), failed=failed, metrics=metrics,
                   numbers=numbers, layer=layer,
                   busy_s=trace.busy_s() if trace else None,
                   window_s=trace.window_s() if trace else None,
                   breakdown=breakdown, memory_peak_bytes=peak)
