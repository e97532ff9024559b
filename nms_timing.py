#!/usr/bin/env python3
"""Time NMS on one NVIDIA card, for the tree this file sits in.

    python3 nms_timing.py [--label NAME]

To compare two trees on one card, copy this file into the other tree (for
example a ``git archive`` of the parent commit unpacked under ``build/``)
and run the two in turns in one command: A, B, B, A.  It uses only the
port's functions that both sides of the NMS redesign share
(``ops/nms.py:nms``, ``Engine``, ``runtime/trace.capture``,
``bench.synthetic_frames``, ``chip_smoke.chain_boxes`` and ``_graph_ms``).

At ``DEFAULT_CONFIG`` bf16 with seeded random weights (seed 0) it records
the (boxes, count) that the dense synthetic frame (``dense_seed0``) gives
NMS in one eager forward, and builds a 500-box suppression chain (each
box overlapping the next: 250 peeling rounds).  On each it times the NMS
stage, ``ops/nms.py:nms(..., use_kernels=True)`` (kernel B4 and what
follows it):

- device ms a call from torch.profiler's device events: all of them, those
  of kernel nms_peel (names containing ``nms_peel``) and those of B4
  (``rotated_overlap``), and the device events a call with their names;
- ms a call of 20 calls captured in one CUDA graph and replayed, by CUDA
  events (``chip_smoke._graph_ms``): the stage as the engine's graph runs
  it, gaps included.

Then the frame: device ms a frame of the engine's graph replays and the
eager frame's NMS stage device ms (``runtime/trace.capture``).  Prints the
card line and one JSON line.  Needs a card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

REPS = 20


def profiled(fn, reps=REPS):
    """Device ms a call of fn() by torch.profiler's device events: in all,
    of nms_peel's and of B4's kernels, and the events a call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a window now and then reports no device event
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break

    def ms(match=None):
        return sum(e.time_range.elapsed_us() for e in events
                   if match is None or match in e.name) / 1e3 / reps
    names = sorted({e.name[:80] for e in events})
    return {"device_ms": ms(), "nms_peel_device_ms": ms("nms_peel"),
            "rotated_overlap_device_ms": ms("rotated_overlap"),
            "device_events_a_call": len(events) / reps,
            "device_event_names": names}


def stage(boxes, count, thr):
    from chip_smoke import _graph_ms
    from dsvt_ai_trt_tpu_torch.ops import nms as nms_ops

    def fn():
        return nms_ops.nms(boxes, count, thr, use_kernels=True)
    out = profiled(fn)
    out["graph_ms"] = _graph_ms(fn, REPS) / REPS
    out["kept"] = int(fn()[1])
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("nms_timing: CUDA is not available", file=sys.stderr)
        return 2
    from chip_smoke import chain_boxes
    from dsvt_ai_trt_tpu_torch import bench, kernels, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.ops import nms as nms_ops
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture

    kernels.build_all()
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    with torch.inference_mode():
        engine = Engine(weights.random_params(cfg, 0), cfg)
        pts, n = bench.synthetic_frames(cfg)["dense_seed0"]
        pts = torch.from_numpy(pts).cuda()
        n = torch.tensor(int(n), device="cuda")
        engine.warmup()
        seen = []
        orig = nms_ops.nms

        def record(boxes, count, thr, **kw):
            seen.append((boxes.clone(), count.clone(), thr))
            return orig(boxes, count, thr, **kw)
        nms_ops.nms = record
        try:
            engine.eager(pts, n)
        finally:
            nms_ops.nms = orig
        boxes, count, thr = seen[0]
        chain = torch.from_numpy(chain_boxes(cfg.top_k)).cuda()
        line = {"label": args.label,
                "frame_nms": {"K": boxes.shape[0], "count": int(count),
                              **stage(boxes, count, thr)},
                "chain_nms": {"K": cfg.top_k, "count": cfg.top_k,
                              **stage(chain, torch.tensor(
                                  cfg.top_k, device="cuda"), thr)}}
        replays = capture(engine, (pts, n), iters=10)
        eager = capture(engine.eager, (pts, n), iters=5)
        line["frame"] = {"graph_device_ms": replays.device_ms_per_iter,
                         "graph_idle_share": replays.idle_share,
                         "eager_device_ms": eager.device_ms_per_iter,
                         "eager_nms_stage_device_ms":
                             eager.stage_ms().get("nms")}
    print(bench.card_line(), flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
