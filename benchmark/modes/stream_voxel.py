"""Streamed frames of the voxel model (upstream DSVT-V): ``stream.py``'s
loop and page-locked sweeps, unchanged, around an engine of the
configuration's stages, judged against the plain voxel reference
(``reference/voxel.py``).

Before it builds anything, the mode refuses a program whose
``DSVTConfig`` does not declare every key of the configuration file: a
program without the staged backbone would drop the stages and serve the
pillar model under this cell's name.  Set-up is ``serving.Setup``'s with
the voxel model's traffic (``traffic/sweeps_voxel.py``), counts, seeded
checkpoint and calibration; the per-layer context says ``"mode":
"stream"``, so the stream cells' readers read it, and adds the pooling's
least time (``stage_pool_s``) and the ``pool`` label's device ms.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import judge, traffic, work, work_voxel
from ..harness import Cell, Outcome, peak_memory, read_layer_metrics
from ..manifest import layer_metrics
from ..reference import voxel, voxel_counts
from ..reference import weights as ref_weights
from ..reference.precision import matmul_flags, rounding
from ..trace import capture, stage_ms
from .serving import BEV, EAGER_FRAMES, SPARSE
from .stream import HOST_SPANS, loop, staged


def check_program(cell: Cell) -> None:
    """Refuse a program that cannot express the configuration file."""
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig

    known = {f.name for f in dataclasses.fields(DSVTConfig)}
    missing = sorted(set(cell.config_file["config"]) - known)
    if missing:
        raise ValueError(f"{cell.name}: the program's DSVTConfig does not "
                         f"declare {missing} of configuration "
                         f"{cell.workload['config']}; it cannot run this "
                         "model")


class Setup:
    def __init__(self, cell: Cell):
        check_program(cell)
        self.cfg = cfg = voxel.VoxelConfig.from_dict(
            cell.config_file["config"])
        dev = cell.device
        self.frames = traffic.generate(cell.workload["traffic"], cell.seed,
                                       cfg)
        self.occ = [voxel_counts.occupancy(p, n, cfg) for p, n in self.frames]
        cap = voxel_counts.caps(cfg)
        for i, o in enumerate(self.occ):
            if np.any(o >= cap):
                raise ValueError(f"sweep {i}: occupancy {o.tolist()} reaches "
                                 f"a cap {cap.tolist()}")
        self.raw = voxel.seeded_raw(cfg, cell.seed, dev)
        params = voxel.fold(self.raw, cfg)
        with matmul_flags("fp32"):
            maps = [voxel.heatmap(params, torch.from_numpy(p).to(dev), n, cfg)
                    for p, n in self.frames]
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
        self.port_cfg.validate()
        self.engine = Engine(prepare_params(ref_weights.to_numpy(self.raw),
                                            self.port_cfg),
                             self.port_cfg, device=dev, with_nms=True)
        self.engine.warmup()


def reference(cell: Cell, setup: Setup, sweeps, precision="fp32"):
    """The voxel reference's ``Detection`` of each sweep, at
    ``precision``."""
    cfg, dev = setup.cfg, cell.device
    params = voxel.fold(setup.raw, cfg)
    out = {}
    with matmul_flags(precision):
        for i in sweeps:
            pts, n = setup.frames[i]
            out[i] = voxel.detect(params, torch.from_numpy(pts).to(dev), n,
                                  cfg, rounding(precision))
    return out


def reference_verdict(cell: Cell, setup: Setup, outputs):
    refs = reference(cell, setup, sorted({o[0] for o in outputs}))
    frames = judge.serving_numbers(outputs, refs, setup.cfg)
    limits = {k: v for k, v in cell.workload["limits"].items()
              if k in frames[0]}
    bad = sum(not judge.verdict(f, limits)[0] for f in frames)
    return judge.combine(frames), bad


def eager_stages(cell: Cell, setup: Setup) -> dict:
    """Device ms a frame by the port's stage labels, the ``pool`` label
    among them, in a trace of ``Engine.eager`` on the first sweeps."""
    n = min(EAGER_FRAMES, len(setup.frames))
    dev = cell.device
    sweeps = [(torch.from_numpy(p).to(dev), c) for p, c in setup.frames[:n]]

    def run():
        for pts, c in sweeps:
            setup.engine.eager(pts, c).count.cpu()
    run()
    _, trace = capture(run, dev)
    return stage_ms(trace, SPARSE + BEV + ("pool",), n)


def layer_context(cell: Cell, setup: Setup, trace, traced_sweeps, stages):
    cfg = setup.cfg
    occ = [setup.occ[i] for i in traced_sweeps]
    return {"cell": cell.name, "mode": "stream", "spans": cell.spans,
            "trace": trace, "stages": stages, "traced_frames": traced_sweeps,
            "flops": sum(work_voxel.frame_flops(cfg, o) for o in occ),
            "peak_flops": work.PEAK_FLOPS[cell.workload["precision"]],
            "set_attention_s": sum(work_voxel.set_attention_seconds(cfg, o)
                                   for o in occ),
            "encoder_epilogue_s": sum(
                work_voxel.encoder_epilogue_seconds(cfg, o) for o in occ),
            "stage_pool_s": sum(work_voxel.stage_pool_seconds(cfg, o)
                                for o in occ)}


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
        spans = {k: list(v) for k, v in cell.spans.items()}
        start = len(outputs) % len(frames)
        more, trace = capture(lambda: loop(
            cell, setup, frames, count=cell.workload["traced_frames"],
            start=start, label="frame"), cell.device)
        outputs += more
        traced = [o[0] for o in more]
        stages = eager_stages(cell, setup)
        cell.spans = spans

    peak = peak_memory(cell)
    layer, breakdown = {}, None
    if cell.trace:
        ctx = layer_context(cell, setup, trace, traced, stages)
        layer = read_layer_metrics(cell, ctx, layer_metrics(cell.name))
        breakdown = {"device_ops": trace.top_ops(),
                     "idle_gaps": trace.idle_gaps(HOST_SPANS)}
    setup.engine = None
    cell.free()
    numbers, failed = reference_verdict(cell, setup, warm + outputs)
    return Outcome(attempted=len(warm + outputs), failed=failed,
                   metrics=metrics, numbers=numbers, layer=layer,
                   busy_s=trace.busy_s() if trace else None,
                   window_s=trace.window_s() if trace else None,
                   breakdown=breakdown, memory_peak_bytes=peak)
