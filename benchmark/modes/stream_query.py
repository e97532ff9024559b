"""Streamed frames of upstream DSVT's nuScenes model, DSVT-P with the
TransFusion-L head: ``stream.py``'s loop and page-locked sweeps,
unchanged, around an engine of the configuration, judged against the
plain reference (``reference/transfusion.py``) by ``judge_query.py``.

Before it builds anything, the mode refuses a program whose
``DSVTConfig`` does not declare every key of the configuration file
(``stream_voxel.check_program``): a program without the head would drop
its keys and serve the CenterHead under this cell's name.  Set-up: the
sweeps from the seed (``traffic``, the kind ``sweeps``), their occupancy
counted by the reference (a sweep at a cap fails the run), the raw
checkpoint made on the card from the seed (no calibration: the head keeps
every query over its 0.0 threshold), then ``prepare_params`` of it and one
``Engine``, warmed.  The device's peak memory is counted from the engine
on.  The per-layer context says ``"mode": "stream"``, so the stream
cells' readers read it; its operations are ``work_query.py``'s, and it
adds the cross-attention's least time (``query_attention_s``) and the
``query`` label's device ms.  The reference judges one sweep at a time,
after the program is freed.
"""

from __future__ import annotations

import time
from collections import defaultdict

import numpy as np
import torch

from .. import judge, judge_query, traffic, work, work_query
from ..harness import Cell, Outcome, peak_memory, read_layer_metrics
from ..manifest import layer_metrics
from ..reference import counts, transfusion
from ..reference import weights as ref_weights
from ..reference.precision import matmul_flags, rounding
from ..trace import capture, stage_ms
from .serving import BEV, EAGER_FRAMES, SPARSE
from .stream import HOST_SPANS, loop, staged
from .stream_voxel import check_program


class Setup:
    def __init__(self, cell: Cell):
        check_program(cell)
        self.cfg = cfg = transfusion.QueryConfig.from_dict(
            cell.config_file["config"])
        dev = cell.device
        self.frames = traffic.generate(cell.workload["traffic"], cell.seed,
                                       cfg)
        self.occ = [counts.occupancy(p, n, cfg) for p, n in self.frames]
        cap = counts.caps(cfg)
        for i, o in enumerate(self.occ):
            if np.any(o >= cap):
                raise ValueError(f"sweep {i}: occupancy {o.tolist()} reaches "
                                 f"a cap {cap.tolist()}")
        self.raw = transfusion.seeded_raw(cfg, cell.seed, dev)
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
    """Yield (sweep, the reference's ``Frame`` of it, the folded head) at
    ``precision``, one sweep at a time."""
    cfg, dev = setup.cfg, cell.device
    params = transfusion.fold(setup.raw, cfg)
    with matmul_flags(precision):
        for i in sweeps:
            pts, n = setup.frames[i]
            yield i, transfusion.detect(params, torch.from_numpy(pts).to(dev),
                                        n, cfg, rounding(precision)), \
                params["head"]


def judged(cell: Cell, setup: Setup, outputs):
    """Every served frame's numbers, in the order of ``outputs``."""
    by_sweep = defaultdict(list)
    for k, o in enumerate(outputs):
        by_sweep[o[0]].append((k, o))
    numbers = [None] * len(outputs)
    with matmul_flags("fp32"):
        for i, ref, head in reference(cell, setup, sorted(by_sweep)):
            frames = judge_query.sweep_numbers([o for _, o in by_sweep[i]],
                                               ref, head, setup.cfg)
            for (k, _), f in zip(by_sweep[i], frames):
                numbers[k] = f
    return numbers


def reference_verdict(cell: Cell, setup: Setup, outputs):
    frames = judged(cell, setup, outputs)
    limits = {k: v for k, v in cell.workload["limits"].items()
              if k in frames[0]}
    bad = sum(not judge.verdict(f, limits)[0] for f in frames)
    return judge.combine(frames), bad


def eager_stages(cell: Cell, setup: Setup) -> dict:
    """Device ms a frame by the port's stage labels, the nested ``query``
    label among them, in a trace of ``Engine.eager`` on the first sweeps."""
    n = min(EAGER_FRAMES, len(setup.frames))
    dev = cell.device
    sweeps = [(torch.from_numpy(p).to(dev), c) for p, c in setup.frames[:n]]

    def run():
        for pts, c in sweeps:
            setup.engine.eager(pts, c).count.cpu()
    run()
    _, trace = capture(run, dev)
    return stage_ms(trace, SPARSE + BEV + ("query",), n)


def layer_context(cell: Cell, setup: Setup, trace, traced_sweeps, stages):
    cfg = setup.cfg
    occ = [setup.occ[i] for i in traced_sweeps]
    return {"cell": cell.name, "mode": "stream", "spans": cell.spans,
            "trace": trace, "stages": stages, "traced_frames": traced_sweeps,
            "flops": sum(work_query.frame_flops(cfg, o) for o in occ),
            "peak_flops": work.PEAK_FLOPS[cell.workload["precision"]],
            "set_attention_s": sum(work.set_attention_seconds(cfg, o, 2)
                                   for o in occ),
            "encoder_epilogue_s": sum(work.encoder_epilogue_seconds(cfg, o, 2)
                                      for o in occ),
            "query_attention_s": len(occ)
            * work_query.query_attention_seconds(cfg)}


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
