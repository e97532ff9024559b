#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the ten CUDA kernels (the five of the pillar model's main
     path, the voxelizer's segment work, the BEV laterals' epilogue, the
     staged model's pooling, TransFusion-L's cross-attention and the
     tracer's stage mark) from ``dsvt_ai_trt_tpu_torch/csrc`` (one
     ``nvcc`` each, all at once) and print the build seconds;
  2. print the card's name and power limit;
  3. run ``Engine`` at ``DEFAULT_CONFIG`` width with ``precision="bf16"`` and
     seeded random weights on three synthetic frames
     (``bench.synthetic_frames``: 20 000 points that fill the 800 sets, a
     sparse 4 000-point frame with fewer live sets, a second 20 000-point
     seed): each frame is one replay of the CUDA graph the engine captured
     at warm-up; print boxes, occupancy and ms per frame (CUDA events,
     after warm-up);
  4. check the launch counters rose by exactly 2 / 8 / 8 / 1 / 1 / 3 / 2
     per frame (segment_max / set_attention / encoder_epilogue /
     rotated_overlap / nms_peel / bev_epilogue / voxel_segments; a replay
     counts what its capture recorded);
  5. run the same frames through the eager forward (``Engine.eager``):
     its outputs equal the replays' bit for bit, and it records the
     kernels' inputs (a replay calls no Python); profile one frame's
     graph replay by stage, through a second engine warmed with the
     tracer on (its stage marks split the replay); hold each kernel against its plain PyTorch version on those
     inputs (B3 and B4 on all three frames, with B4's NMS kept
     set and its count of 64-slot reruns; nms_peel, the IoU, the rounds
     and the keep-first compaction in one launch, bit-equal in boxes and
     count on all three frames' recorded (overlap, boxes, count,
     threshold) and on a constructed 500-box suppression chain, 250
     rounds, where the whole NMS on the card also equals the CPU's; its
     bound and one launch's own device time beside it, and the profiled
     frame's NMS stage device ms), and time kernel, plain version
     and, where one exists, the PyTorch library call computing the same
     function: by CUDA events around back-to-back calls (host dispatch
     included), and for the kernel and the library call also device-only
     (``device_ms``); for B3 and B4 also every device kernel of one wrapper
     call (``wrapper_device_ms``); B3 also on a seeded stream of 1..48-row
     segments (real clouds' pillars), B2 also at 1, 132 and 264 tiles of 64
     rows; bev_epilogue bit-equal on the first frame's three laterals;
  5a. voxelize (``check_voxelize``): kernel ``voxel_segments`` at the
     three served configurations' caps (``dsvt-nuscenes`` on the dense
     frame, ``dsvt-waymo`` and ``dsvt-voxel-waymo`` on phase 11's
     180 000-point frame, read from the benchmark's configuration files):
     both launches bit-equal to their plain steps (``cap_keys_plain``,
     ``pillars_plain``) and the whole voxelize bit-equal both ways; the two
     launches timed (CUDA events, device-only) against their bound (bytes
     at 3.35 TB/s), the plain steps they replace, and ``torch.cummax``
     over the same rows (the full stream and twice the compacted one, the
     plain version's three scans) as the library's yardstick; and the
     whole voxelize's device ms both ways;
  5b. graph (``check_graph``): one eager kernel-path frame under
     ``torch.cuda.set_sync_debug_mode("error")`` (no synchronisation);
     engines with and without NMS at ``DEFAULT_CONFIG`` and at
     ``WAYMO_CONFIG`` (the densified Waymo frame): the capture holds
     2/8/8/1/1 launches (no B4 or nms_peel without NMS), and replays equal
     the eager forward bit for bit (boxes, count, occupancy); two engines'
     replays interleaved with no wait keep their own results; the scan
     graph (``Engine(..., batch=10)``, ``run_frames_scan``'s and the
     bench's ``batch``) on the three frames cycled to 10: its capture and
     one replay count 10 x 2/8/8/1/1 (counts set to 0 just before the
     replay, read just after), and each of its frames equals the engine's
     per-frame replay bit for bit; ms a frame through it, through the
     per-frame graph and through eager ``forward_batch`` (medians of 5
     alternated samples); capture seconds and the graph pool's MB; sync and
     stream ms a frame, eager against graph (medians of 5 alternated
     samples), the host's ms to enqueue one frame, and a traced frame of
     each (device ms, span, idle share, host ms in launch calls and
     waiting);
  6. golden: the tiny configuration's fp32 boxes on the card against
     ``tests/goldens/tiny_seed0.json``;
  7. parity_suite: ``parity.run_suite``, the four rows {bf16, mixed} x
     {nuScenes, Waymo density} against fp32 on checkpoints calibrated on
     each frame, each gated (``parity.py``); then ``eval.parity_ok`` after
     NMS on the three frames, printed, not gated (``check_parity_suite``);
  8. mixed: ``Engine`` at ``DEFAULT_CONFIG`` with ``precision="mixed"`` on
     the three frames: launch counts 2/8/8/1/1 per frame, finite boxes, ms
     per frame (CUDA events) and device ms per frame and stage
     (``trace.capture``), and each kernel held against its plain version
     and timed on the inputs mixed gave it, as in phase 5 (B3 on float32
     rows);
  9. native: the port's C++ host library (``io/host_nms.py``) is built
     from ``dsvt_ai_trt_tpu_torch/native/dsvt_host.cpp`` and loads; on each
     frame's boxes before NMS its NMS keeps the NumPy route's set (host ms
     of both: median, min and max of ``NMS_REPS`` calls); its .bin loader
     and .wts parser give the Python readers' buffer and values;
     ``run_frames(..., host_nms=True)`` on an engine
     built without NMS goes through it (the NumPy route is made to fail)
     and gives NMS-on-the-card's boxes;
 10. runtime: the three frames written as .bin files, ``cli build
     --engine`` then ``cli infer --engine --pipeline-depth 2``: rows equal
     the direct ``Engine`` call's at 1e-4 and the launch counts rise
     2/8/8/1/1 per frame (the engine's warm-up included: its eager frames
     and its first replay); ``--host-nms`` keeps
     the same count and rows as NMS on the card, and ``--scan-batch 2``
     equals the stream;
 11. waymo: ``WAYMO_CONFIG`` at full width on a seeded frame densified to
     180 000 points (``bench.waymo_base_frame``): launch counts 2/8/8/1/1
     of a replay, finite boxes, occupancy under every cap; B1 and B3 held
     against their plain versions on the inputs that frame's eager pass
     gave them, and timed with bounds;
 11b. voxel (``check_voxel``): ``dsvt-voxel-waymo`` (upstream DSVT-V, read
     from ``benchmark/configs/dsvt-voxel-waymo.json``) at bf16 on the same
     frame, under every cap of that configuration: one replay's launch
     counts (counts set to 0 just before it) 5/8/8/1/1 and ``stage_pool``
     3, the replay bit-equal to the eager forward; ``stage_pool`` held
     against its plain version on each of the three poolings' inputs from
     the eager pass (atol 2e-2, rtol 1e-2 on live parents, zeros past the
     count) and timed with bounds (the ``kernels`` line's ``stage_pool``
     row: the three launches of a frame together);
 11c. query (``check_query``): ``dsvt-transfusion-nuscenes`` (upstream
     DSVT's nuScenes model, the TransFusion-L head, read from
     ``benchmark/configs/dsvt-transfusion-nuscenes.json``) at bf16 on the
     dense frame: one replay's launch counts 2/8/8 with no NMS kernel and
     ``query_attention`` 1, the replay bit-equal to the eager forward;
     ``query_attention`` held against its plain version on the inputs of
     the eager pass (atol and rtol 2e-2) and timed with its bound and
     PyTorch's ``scaled_dot_product_attention`` on the same keys and values
     (projected outside it) as the library's yardstick;
 12. training (``check_training``), outside inference mode:
     ``DEFAULT_CONFIG`` at fp32 and full width on a fixed seeded batch of 2
     planted scenes (``data.synthetic_batch``): one step's loss and
     gradients with and without ``remat`` (the JAX per-leaf gate), 6
     default AdamW steps (every loss finite, the last below the first, no
     kernel launched: training runs the plain paths), ms per step by CUDA
     events and peak memory with and without ``remat``, one step traced
     (``runtime/trace.capture``: device ms, idle share, FLOPs, MFU at 67
     TFLOP/s fp32); the compiled step (``check_compiled_step``,
     ``CompiledTrainStep``: the whole step as one CUDA graph): an eager
     step under ``set_sync_debug_mode("error")`` (no synchronisation), 6
     replays against 6 eager steps from the same weights (loss within 1e-5
     relative, every leaf under ``step_gate``, no kernel launched), ms a
     step eager against graph (alternated), a traced step of each (device
     ms, span, idle share, the index backward's ms), the capture's seconds
     and pool; then the trained weights, refolded, through the bf16
     ``Engine`` on the three frames (launch counts 2/8/8/1/1 per frame, every
     top-k box equal at 1e-4 to those of the weights exported as .wts and
     reloaded);
     ``cli train`` for 1 + 1 steps with ``--resume`` and ``--export-wts``
     and ``train_run.main`` for 3 steps with 2 eval scenes (reloaded
     recall equals trained recall), each step a replay of a captured
     step (``graph_steps`` records them);
 13. multi (``check_multi``): the card's compute mode is printed, and an
     exclusive mode fails the phase; ``parallel/dryrun.py:card_modes`` runs
     in two spawned processes joined in a gloo group on cuda:0 (gloo
     carries the collectives through host copies; NCCL refuses two ranks
     on one card), at ``DEFAULT_CONFIG`` full caps with the main path's
     seeded weights, and is held here against this process's runs: dp=2
     (the two dense frames, one a rank, through ``make_dp_engine``) equal
     to the ``Engine`` at 1e-4 (max |d| printed); mp=2 at bf16 (the three
     frames; B1 at 4 heads, B2 whole on the gathered heads) and sp=2 at
     bf16 (B1 on a rank's 400 sets, B2 on its 5 000 pillar rows), on
     ``parity.py``'s checkpoint (``parity_params``: its top-k waterline
     lies below the confident boxes on every frame), pass ``parity.py``'s
     gate against the unsharded bf16 boxes before NMS;
     sp=2 at fp32 equals the unsharded fp32 boxes at 1e-4, with the 117-row
     level split 58 / 59.  Every forward mode runs eager and through its
     compiled ``Engine`` in each rank (dp: ``make_dp_engine``'s graph;
     mp and sp: graphs captured in segments, ``capture_segments``, with
     gloo's collectives run between them): each rank's graph Detections
     equal its eager ones bit for bit, its launches over each pass are
     2/8/8/1/1 a frame (sp fp32: B3, B4 and nms_peel only) and its
     segments a replay 1 + ``dryrun.breaks_per_frame`` (the count the CPU
     tests pin); dp=2 and mp=2 training steps (fp32, batch 2, ``remat``)
     replay ``CompiledTrainStep`` 6 times each against eager steps from
     the same state (``dryrun.held_steps``): the loss at 1e-5 relative,
     every leaf under ``step_gate``, no kernel launched, segments a replay
     1 + ``dryrun.breaks_per_step`` (dp: 2; mp: 146, one graph closed at
     each of Megatron's all-reduces, those autograd's thread reaches in
     the backward and its recomputation included, and at the mp average
     of the replicated leaves' gradients), the ranks' losses bit-equal at
     every replay; each rank
     (``multi_rank``) records
     the inputs of B1 and B2's first call in each mode, and once the ranks
     have exited they are held against the plain versions and timed here,
     as phase 5 holds the main path's (``check_set_attention``,
     ``check_encoder_epilogue``); an mp=2 training step (fp32, batch 2)
     gives the single-process loss at 1e-4 and its leaves (``step_gate``),
     beside two more single-process steps: a repeat (the gradients'
     run-to-run spread) and one with every encoder leaf moved one ulp at
     random (``nudge_``: how far a change of the size another summation
     order makes moves the gradients).  Per mode and rank, eager and
     graph: ms a frame (a step; medians of 5 alternated samples), the
     CUDA-event span, device busy ms and idle share (a trace of the pass),
     host ms, calls and MB in collectives; segments, pool MB and capture
     seconds: two processes sharing one card, not a multi-GPU speed;
 13b. dryrun (``check_dryrun``): ``parallel/dryrun.py:dryrun`` in a world
     of 4 gloo processes on cuda:0, the counterpart of the JAX package's
     ``__graft_entry__.dryrun_multichip`` at 4 devices: the train step at
     the flagship widths through ``CompiledTrainStep`` under dp=2 x mp=2
     and mp=4 (75 and 146 segments), each held against its eager step
     (loss 1e-5 relative, ``step_gate``, no kernel launched), mp=4's loss
     within 1e-3 of dp=2 x mp=2's, and the three spatial modes (sp=4)
     equal to the unsharded boxes at 1e-4;
 14. bench: ``python -m dsvt_ai_trt_tpu_torch.bench`` in this process on
     the three frames (Waymo pass on the Waymo base frame), few
     iterations, both parity gates passed (given the suite's rows of phase
     7, see ``run_bench``); its JSON line is printed;
 15. print the card line, the ``kernels`` JSON line (second to last), and
     last the result line ``{"ok": true, "device": {...}}``.  Phases 6-14
     print their seconds.

The independent torch oracle (tools/torch_oracle.py) is not run here:
this script imports nothing outside the port.  Its anchor of the fp32
path is the card test ``python -m pytest tests/test_torch_oracle.py
--noconftest -m slow``.

The profile of phase 5 is ``runtime/trace.capture``'s: per stage (between
the stage marks) span and busy ms on the device timeline, per kernel
device ms, the device's idle share of the frame's span, and the tracer's
clock calibration.

Needs one CUDA card; exits non-zero without one, and without the package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import tempfile
import time
import types

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
PER_FRAME = {"segment_max": 2, "set_attention": 8, "encoder_epilogue": 8,
             "rotated_overlap": 1, "nms_peel": 1}
# what a bf16 frame launches with the tracer off: the graph holds no stage
# mark, a pillar model pools nothing between stages, the three laterals
# of the BEV ResNet take bev_epilogue (fp32, mixed and sp take none), and
# voxelize takes voxel_segments twice (every serving path; training none)
LAUNCHES = {**PER_FRAME, "stage_mark": 0, "stage_pool": 0, "bev_epilogue": 3,
            "query_attention": 0, "voxel_segments": 2}
# a dsvt-voxel-waymo frame: four stages of one block (8 encoders), B3 in
# the VFE (2) and in each of the 3 poolings' max, stage_pool in each
VOXEL_LAUNCHES = {**LAUNCHES, "segment_max": 2 + 3, "stage_pool": 3}
# a dsvt-transfusion-nuscenes frame: the pillar model's kernels, no NMS, one
# cross-attention of the TransFusion-L decoder
QUERY_LAUNCHES = {**LAUNCHES, "rotated_overlap": 0, "nms_peel": 0,
                  "query_attention": 1}
NMS_KERNELS = ("rotated_overlap", "nms_peel")   # none without NMS
SCAN_BATCH = 10                    # frames in one scan graph (bench.BATCH)
TRAIN_STEPS = 6                    # graph replays held against eager steps
SYMBOLS = {                        # the __global__ function(s) of each kernel
    "segment_max": "segment_max_kernel",
    "set_attention": "set_attention_kernel",
    "encoder_epilogue": "encoder_epilogue_kernel",
    "rotated_overlap": "rotated_overlap_kernel",
    "nms_peel": "nms_peel_kernel",
    "bev_epilogue": "bev_epilogue_kernel",
    # the attention and the combine of its partials
    "query_attention": "query_attention",
    "voxel_segments": "voxel_",     # voxel_cap_kernel, voxel_pillars_kernel
}
REPLACES = {
    "segment_max": "dsvt_ai_trt_tpu/ops/segment_pallas.py:125",
    "set_attention": "dsvt_ai_trt_tpu/ops/attention_pallas.py:183",
    "encoder_epilogue": "dsvt_ai_trt_tpu/ops/encoder_pallas.py:64",
    "rotated_overlap": "dsvt_ai_trt_tpu/ops/nms_pallas.py:116",
    "nms_peel": "dsvt_ai_trt_tpu/ops/nms.py:298",   # XLA's lax.while_loop
    "stage_pool": None,   # the JAX package has no staged backbone
    "bev_epilogue": None,  # XLA fused the laterals' bias, ReLU and concat
    "query_attention": None,  # the JAX package has no TransFusion head
    "voxel_segments": None,   # XLA's scans in dsvt_ai_trt_tpu/ops/voxelize.py
}
NMS_REPS = (200, 20)               # host NMS timings: native, NumPy route
GOLDEN_TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens", "tiny_seed0.json")
# upstream DSVT-V's configuration, as the benchmark's cell runs it (data)
VOXEL_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmark", "configs", "dsvt-voxel-waymo.json")
QUERY_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "benchmark", "configs",
                            "dsvt-transfusion-nuscenes.json")
# the served configurations whose caps phase 5a times voxelize at
VOXELIZE_CONFIGS = {name: os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "benchmark", "configs",
    name + ".json") for name in ("dsvt-nuscenes", "dsvt-waymo",
                                 "dsvt-voxel-waymo")}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(obj):
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


# --------------------------------------------------------------------------
# frames and configurations
# --------------------------------------------------------------------------


def tiny_config():
    """The reduced configuration of the test suite (tests/conftest.py)."""
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig, WindowSpec
    return DSVTConfig(
        max_points=2048, max_kept_points=1536, max_pillars=512,
        max_points_per_pillar=8, voxel_size=(0.32, 0.32, 8.0),
        pc_range_min=(-7.68, -7.68, -5.0), pc_range_max=(7.68, 7.68, 3.0),
        grid_size=(48, 48, 1), pfn_channels=(16, 32), sparse_shape=(48, 48, 1),
        window_specs=(WindowSpec((12, 12, 1), (0, 0, 0)),
                      WindowSpec((24, 24, 1), (6, 6, 0))),
        max_voxels_per_window=576, max_sets=128, set_size=12, num_blocks=2,
        num_heads=4, d_model=32, ffn_dim=64, num_classes=3, top_k=64)


def tiny_cloud(cfg, n=1500, seed=1234):
    """tests/conftest.py:make_cloud with the golden's seed."""
    rng = np.random.default_rng(seed)
    lo = np.array(cfg.pc_range_min, np.float32)
    hi = np.array(cfg.pc_range_max, np.float32)
    pts = rng.uniform(lo - 0.5, hi + 0.5, size=(n, 3)).astype(np.float32)
    intensity = rng.uniform(0, 1, size=(n, 1)).astype(np.float32)
    buf = np.zeros((cfg.max_points, 4), np.float32)
    buf[:n] = np.concatenate([pts, intensity], axis=1)
    return buf, np.int32(n)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------


def cuda_ms(fn, reps=20, warmup=3):
    """Mean device ms of fn() over `reps` calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _profiled_ms(fn, match, reps):
    """Summed device time of reps calls of fn() from torch.profiler's
    device events (only kernels whose name contains `match`, if given), or
    None when the profiler reported no such event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and (match is None or match in e.name)]
    if len(on_dev) < reps:
        return None
    return sum(e.time_range.elapsed_us() for e in on_dev) / 1e3


def _graph_ms(fn, reps, replays=5):
    """Device ms of reps calls of fn() captured in one CUDA graph, replayed
    `replays` times between CUDA events: no host work between launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # capture wants a warm side stream
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / replays


def device_ms(fn, match=None, reps=20, warmup=3):
    """Device-only ms per call of fn(), without the host's dispatch (wrapper
    checks, allocation, the ctypes call): from torch.profiler's device
    events (with `match`, only the kernels whose name contains it), tried
    three times because a profiling window now and then reports no device
    event at all; else from a CUDA graph of `reps` captured calls, which
    also counts any small kernels the wrapper launches around the kernel.
    Returns (ms, "profiler" or "cuda_graph")."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        total = _profiled_ms(fn, match, reps)
        if total is not None:
            return total / reps, "profiler"
    return _graph_ms(fn, reps) / reps, "cuda_graph"


def bound_ms(nbytes, ops, peak):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


class Recorder:
    """Wraps the kernel wrappers the main path calls (or those of
    ``names``), keeping the inputs of each call (with ``first_only``, of
    the first call a frame) so the kernels can be held against their plain
    versions on exactly those tensors.  The wrapped call is the original
    wrapper (which counts its own launch).  A CUDA graph replay calls no
    wrapper, so it records an eager pass (``Engine.eager``), whose outputs
    ``run_main_path`` holds equal to the replays' bit for bit."""

    def __init__(self, names=(*PER_FRAME, "bev_epilogue"), first_only=False):
        from dsvt_ai_trt_tpu_torch.model import (backbone2d, backbone3d,
                                                 transfusion)
        from dsvt_ai_trt_tpu_torch.ops import (attention_kernel, encoder_kernel,
                                               nms, segment)
        self.calls = {name: [] for name in names}
        self.frame = None
        self.first_only = first_only
        self._patches = [p for p in (
            (segment, "segmented_max", "segment_max"),
            (attention_kernel, "set_attention_fused_flat", "set_attention"),
            (encoder_kernel, "encoder_epilogue", "encoder_epilogue"),
            (nms, "pairwise_overlap", "rotated_overlap"),
            (nms, "nms_peel", "nms_peel"),
            (backbone3d, "stage_pool", "stage_pool"),
            (backbone2d, "bev_epilogue", "bev_epilogue"),
            (transfusion, "query_attention", "query_attention"),
        ) if p[2] in names]
        self._orig = []

    def __enter__(self):
        for mod, attr, name in self._patches:
            orig = getattr(mod, attr)
            self._orig.append((mod, attr, orig))

            def wrapped(*args, _orig=orig, _name=name, **kw):
                calls = self.calls[_name]
                if not (self.first_only
                        and any(fr == self.frame for fr, _a, _k in calls)):
                    calls.append((self.frame, args, kw))
                return _orig(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)


def on_card(frames):
    """The frames with points and count as tensors on the card (the eager
    forward then copies nothing from the host)."""
    import torch
    return {name: (torch.from_numpy(pts).cuda(),
                   torch.tensor(int(n), device="cuda"))
            for name, (pts, n) in frames.items()}


def same_dets(a, b):
    """Bit-equal boxes, count and occupancy."""
    import torch
    return all(torch.equal(x, y) for x, y in zip(a, b))


def run_main_path(engine, frames):
    """Warm up (the engine captures its CUDA graph), then ONE counted pass
    over the frames through the engine, with the launch counters set to 0
    just before and read just after; then an eager pass over the same
    frames under the Recorder (the kernels' inputs), each frame's outputs
    bit-equal to the replay's; then time each frame.  Returns (per-frame
    records, counts, recorder)."""
    import torch
    from dsvt_ai_trt_tpu_torch import kernels

    engine.warmup()
    for pts, n in frames.values():
        engine(pts, n)
    torch.cuda.synchronize()

    records, replays = {}, {}
    kernels.reset_counts()
    for name, (pts, n) in frames.items():
        replays[name] = dets = engine(pts, n)
        records[name] = {
            "frame": name, "points": int(n), "boxes": int(dets.count),
            "occupancy": dets.occupancy.cpu().tolist(),
            "finite": bool(torch.isfinite(dets.boxes).all()),
            "shape": list(dets.boxes.shape)}
    torch.cuda.synchronize()
    counts = kernels.counts()

    recorder = Recorder()
    with recorder:
        for name, (pts, n) in on_card(frames).items():
            recorder.frame = name
            check(same_dets(engine.eager(pts, n), replays[name]),
                  f"{name}: the graph replay differs from the eager forward")
    for name, (pts, n) in frames.items():
        records[name]["ms"] = cuda_ms(lambda: engine(pts, n), reps=5, warmup=1)
    return records, counts, recorder


def profile_frame(engine, cfg, pts, n, iters=2):
    """Warm replays of ``engine``, warmed with the tracer on (its graph's
    stage marks split each replay by stage), under torch.profiler, by
    ``runtime/trace.capture``, per frame: the host ms of the call
    (``wall_ms``), the frame's span on the
    device timeline, device busy ms (kernels, copies and memsets), the
    device's idle share of the span, the host ms spent waiting for the card
    and in launch calls, and per forward stage (model.detector.STAGES
    labels) its host ms (0: a replay runs no Python), the span and busy ms
    on the device of the work between its marks and its four costliest
    kernels, its GFLOP (counted on ``engine.eager``) and MFU; plus each
    hand-written kernel's device ms and the top device kernels."""
    from dsvt_ai_trt_tpu_torch.runtime.profiler import device_peak_flops
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    prof = capture(engine, (pts, n), iters=iters)
    table = prof.stage_table(device_peak_flops(cfg.precision))
    stages = {name: {"host_ms": v["host_ms"], "device_span_ms": v["span_ms"],
                     "device_busy_ms": v["busy_ms"],
                     "gflop": table.get(name, {}).get("gflop", 0.0),
                     "mfu": table.get(name, {}).get("mfu"),
                     "kernels": [{"name": r["name"][:120], "ms": r["ms"]}
                                 for r in prof.stage_ops(name, 4)]}
              for name, v in prof.stage_spans().items()}
    rows = prof.top_ops(len(prof.ops))
    ours = {name: {"ms": sum(r["ms"] for r in rows if sym in r["name"]),
                   "calls": sum(r["calls"] for r in rows if sym in r["name"])}
            for name, sym in SYMBOLS.items()}
    return {"iters": iters, "wall_ms": prof.host_ms_per_iter,
            "device_span_ms": prof.window_ms_per_iter,
            "device_busy_ms": prof.device_ms_per_iter,
            "device_idle_share": prof.idle_share,
            "host_wait_ms": prof.host_wait_ms_per_iter,
            "host_launch_ms": prof.host_launch_ms_per_iter,
            "gflop": prof.flops.total / 1e9, "stages": stages,
            "kernels": ours,
            "top_device": [{"name": r["name"][:90], "ms": r["ms"],
                            "calls": r["calls"]} for r in rows[:15]]}


def first_call(recorder, kernel, frame):
    for fr, args, kw in recorder.calls[kernel]:
        if fr == frame:
            return args, kw
    raise SmokeFailure(f"no {kernel} call recorded for frame {frame}")


def _segment_max_checked(feats, is_start, cap, starts_only, what):
    """B3 and its plain version on one input, bit-exact on the defined rows
    (rows of segments no longer than the cap; start rows only for
    starts_only).  Returns (segment ids, segment lengths, defined rows,
    rows written, contract bytes): one read of the defined rows, one write
    of each defined row (full) or of each defined segment's first row
    (starts_only), and the N flag bytes."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import segment
    got = segment.segmented_max_cuda(feats, is_start, cap, starts_only)
    ref = segment.segmented_max_plain(feats, is_start, cap, starts_only)
    seg = torch.cumsum(is_start.long(), 0) - 1
    lengths = torch.bincount(seg)
    defined = lengths[seg] <= cap
    n_rows = int(defined.sum())
    if starts_only:
        defined &= is_start
    check(torch.equal(got[defined], ref[defined]),
          f"segment_max (starts_only={starts_only}) differs from plain on "
          f"{what}")
    n_out = int(defined.sum())
    N, C = feats.shape
    nbytes = (n_rows + n_out) * C * feats.element_size() + N
    return seg, lengths, n_rows, n_out, nbytes


def ragged_flags(n, cap, seed, tail=100):
    """is_start of a stream of segments of 1..cap rows (uniform, seeded), as
    the pillars of a real cloud hold up to cap points, then an over-cap
    tail of `tail` rows."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, cap + 1, n)
    starts = np.cumsum(lengths) - lengths
    flags = np.zeros(n, bool)
    flags[starts[starts < n - tail]] = True
    flags[n - tail] = True
    return flags


def time_segment_max_ragged(cap, n=30000):
    """B3 device-only on a seeded 1..cap-row stream at the main path's two
    shapes (C = 96 full, C = 192 starts_only, bf16), bit-exact against
    plain, with each call's bound on its contract bytes."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import segment
    is_start = torch.from_numpy(ragged_flags(n, cap, seed=0)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = []
    for C, starts_only in ((96, False), (192, True)):
        feats = torch.randn(n, C, device="cuda", generator=gen).bfloat16()
        _seg, lengths, n_rows, n_out, nbytes = _segment_max_checked(
            feats, is_start, cap, starts_only, "the ragged stream")
        t_d, how = device_ms(lambda: segment.segmented_max_cuda(
            feats, is_start, cap, starts_only), SYMBOLS["segment_max"])
        b, by = bound_ms(nbytes, segment.flops(n_rows, C), F32_FLOPS)
        res.append({"N": n, "C": C, "starts_only": starts_only,
                    "segments": int(lengths.numel()),
                    "mean_rows": n_rows / int((lengths <= cap).sum()),
                    "defined_rows": n_rows, "rows_written": n_out,
                    "bytes": nbytes, "device_ms": t_d, "device_ms_by": how,
                    "bound_ms": b, "bound_by": by, "bound_share": b / t_d})
    return res


def check_segment_max(recorder, frames_to_check, ragged=True):
    """Kernel B3 vs plain on both calls of each frame (bit-exact on the
    defined rows); timed on the first frame, and on a 1..cap-row stream.

    Bounds: `bound_ms` counts the bytes this run's data needs under the
    contract (`_segment_max_checked`); the kernel touches no row of an
    over-cap segment.  `bound_ms_all_rows` reads and writes every row as if
    all were defined (read N*C, write N*C or starts*C, N flags), the
    yardstick of earlier kernels that computed every row."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import segment
    out = {"ms": 0.0, "device_ms": 0.0, "wrapper_device_ms": 0.0,
           "plain_ms": 0.0, "library_ms": 0.0, "library_device_ms": 0.0,
           "bound_ms": 0.0, "bound_ms_all_rows": 0.0, "max_abs_err": 0.0,
           "calls": []}
    need = {"bytes": 0, "ops": 0}
    every = {"bytes": 0, "ops": 0}
    for frame in frames_to_check:
        calls = [c for c in recorder.calls["segment_max"] if c[0] == frame]
        check(len(calls) == 2, f"segment_max: {len(calls)} calls for {frame}")
        for _fr, args, kw in calls:
            feats, is_start, cap = args[:3]
            starts_only = kw.get("starts_only",
                                 args[3] if len(args) > 3 else False)
            seg, lengths, n_rows, n_out, nbytes = _segment_max_checked(
                feats, is_start, cap, starts_only, frame)
            if frame != frames_to_check[0]:
                continue
            N, C = feats.shape
            esz = feats.element_size()
            n_starts = int(is_start.sum())
            nbytes_all = (N + (n_starts if starts_only else N)) * C * esz + N
            need["bytes"] += nbytes
            need["ops"] += segment.flops(n_rows, C)
            every["bytes"] += nbytes_all
            every["ops"] += segment.flops(N, C)
            # library yardsticks: one scatter_reduce("amax") into the
            # segment table (same reduction, table output, no broadcast
            # back), and torch.segment_reduce("max") over the same
            # segments' lengths (the starts_only form, compacted)
            idx = seg[:, None].expand(-1, C).contiguous()
            table = torch.empty((N, C), dtype=feats.dtype, device=feats.device)

            def lib_call():
                table.fill_(float("-inf"))
                table.scatter_reduce_(0, idx, feats, reduce="amax")

            def kernel_call():
                return segment.segmented_max_cuda(feats, is_start, cap,
                                                  starts_only)
            t_sr, how_sr = device_ms(lambda: torch.segment_reduce(
                feats, "max", lengths=lengths, unsafe=True))
            t_k = cuda_ms(kernel_call)
            t_p = cuda_ms(lambda: segment.segmented_max_plain(
                feats, is_start, cap, starts_only))
            t_l = cuda_ms(lib_call)
            t_d, how = device_ms(kernel_call, SYMBOLS["segment_max"])
            t_w, how_w = device_ms(kernel_call)
            t_ld, how_l = device_ms(lib_call)
            b, _by = bound_ms(nbytes, segment.flops(n_rows, C), F32_FLOPS)
            b_all, _ = bound_ms(nbytes_all, segment.flops(N, C), F32_FLOPS)
            out["calls"].append({
                "N": N, "C": C, "dtype": str(feats.dtype),
                "starts_only": bool(starts_only), "defined_rows": n_rows,
                "rows_written": n_out, "starts": n_starts, "ms": t_k,
                "device_ms": t_d, "device_ms_by": how,
                "wrapper_device_ms": t_w, "wrapper_device_ms_by": how_w,
                "plain_ms": t_p, "library_ms": t_l, "library_device_ms": t_ld,
                "library_device_ms_by": how_l,
                "segment_reduce_device_ms": t_sr,
                "segment_reduce_device_ms_by": how_sr,
                "bound_ms": b, "bound_ms_all_rows": b_all, "bytes": nbytes,
                "bytes_all_rows": nbytes_all})
            for key, val in (("ms", t_k), ("device_ms", t_d),
                             ("wrapper_device_ms", t_w), ("plain_ms", t_p),
                             ("library_ms", t_l), ("library_device_ms", t_ld)):
                out[key] += val
    out["bound_ms"], out["bound_by"] = bound_ms(need["bytes"], need["ops"],
                                                F32_FLOPS)
    out["bound_ms_all_rows"], _ = bound_ms(every["bytes"], every["ops"],
                                           F32_FLOPS)
    out["frames_checked"] = list(frames_to_check)
    if ragged:
        out["ragged_stream"] = time_segment_max_ragged(cap)
    return out


def check_set_attention(recorder, frames_to_check):
    """Kernel B1 vs plain: live query slots at the bf16 tolerance
    (atol 5e-3, rtol 2e-2), dead sets exact zeros; timed on the first."""
    import torch
    import torch.nn.functional as F
    from dsvt_ai_trt_tpu_torch.ops import attention_kernel as ak
    res = None
    max_err = 0.0
    for frame in frames_to_check:
        args, kw = first_call(recorder, "set_attention", frame)
        qkv, mask, H = args[:3]
        count = kw.get("set_count")
        got = ak.set_attention_cuda(qkv, mask, H, count)
        ref = ak.set_attention_plain(qkv, mask, H, count)
        S, K = mask.shape
        C = qkv.shape[1] // 3
        live_q = (mask >= 0).reshape(-1)
        torch.testing.assert_close(got[live_q].float(), ref[live_q].float(),
                                   atol=5e-3, rtol=2e-2)
        n_live = int(count)
        check(torch.all(got.view(S, K, C)[n_live:] == 0),
              f"set_attention: sets >= set_count ({n_live}) not zero")
        max_err = max(max_err, float((got[live_q].float()
                                      - ref[live_q].float()).abs().max()))
        if res is not None:
            res["set_count_sparse"] = n_live
            continue
        # library yardstick: SDPA over [S, H, K, D] with a boolean key mask
        D = C // H
        q, k, v = (qkv.view(S, K, 3, H, D)[:, :, i].transpose(1, 2)
                   for i in range(3))
        bmask = (mask >= 0)[:, None, None, :]
        t_k = cuda_ms(lambda: ak.set_attention_cuda(qkv, mask, H, count))
        t_p = cuda_ms(lambda: ak.set_attention_plain(qkv, mask, H, count))
        t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bmask))
        t_d, how = device_ms(
            lambda: ak.set_attention_cuda(qkv, mask, H, count),
            SYMBOLS["set_attention"])
        t_ld, how_l = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bmask))
        nbytes = (n_live * K * 3 * C * 2 + S * K * 4 + S * K * C * 2)
        ops = ak.flops(n_live, K, C)
        b, by = bound_ms(nbytes, ops, BF16_FLOPS)
        res = {"ms": t_k, "device_ms": t_d, "device_ms_by": how,
               "plain_ms": t_p, "library_ms": t_l, "library_device_ms": t_ld,
               "library_device_ms_by": how_l, "bound_ms": b,
               "bound_by": by, "bytes": nbytes, "ops": ops, "S": S, "K": K,
               "C": C, "H": H, "set_count": n_live}
    res["max_abs_err"] = max_err
    return res


def check_encoder_epilogue(recorder, frame):
    """Kernel B2 vs the unfused plain epilogue: atol 2e-2 after the LNs
    (bf16 matmul inputs; a bf16 rounding flip of x1 or of the GELU output
    moves a product by ~2^-8 of its size)."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import encoder_kernel as ek
    args, kw = first_call(recorder, "encoder_epilogue", frame)
    x, a, enc = args[:3]
    eps = args[3] if len(args) > 3 else kw.get("eps", 1e-5)
    got = ek.encoder_epilogue_cuda(x, a, enc, eps)
    ref = ek.encoder_epilogue_plain(x, a, enc, eps)
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=0.0)
    P, C = x.shape
    Fd = enc["ffn_w1"].shape[1]
    t_k = cuda_ms(lambda: ek.encoder_epilogue_cuda(x, a, enc, eps))
    t_p = cuda_ms(lambda: ek.encoder_epilogue_plain(x, a, enc, eps))
    t_d, how = device_ms(lambda: ek.encoder_epilogue_cuda(x, a, enc, eps),
                         SYMBOLS["encoder_epilogue"])
    nbytes = P * C * (4 + 2 + 4) + (C * C + 2 * C * Fd) * 2
    ops = ek.flops(P, C, Fd)
    b, by = bound_ms(nbytes, ops, BF16_FLOPS)
    # device ms against the number of 64-row tiles (one, one per SM, two per
    # SM) on seeded rows of the same widths: flat means a tile's own latency
    # bounds the call, proportional means the SMs' throughput does
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    scaling = {}
    for rows in (64, 64 * sms, 128 * sms):
        xs = torch.randn(rows, C, device="cuda", generator=gen)
        as_ = torch.randn(rows, C, device="cuda", generator=gen).bfloat16()
        scaling[rows] = device_ms(
            lambda: ek.encoder_epilogue_cuda(xs, as_, enc, eps),
            SYMBOLS["encoder_epilogue"])[0]
    return {"ms": t_k, "device_ms": t_d, "device_ms_by": how,
            "plain_ms": t_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "bytes": nbytes, "ops": ops,
            "device_ms_by_rows": scaling, "P": P, "C": C, "F": Fd,
            "max_abs_err": float((got - ref).abs().max())}


def check_bev_epilogue(recorder, frame):
    """Kernel bev_epilogue vs its plain version on the three laterals of
    ``frame``: bit-equal (f32 sum, one rounding, the ReLU); timed as the
    frame's three launches together."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import bev_epilogue as be
    calls = [(args, kw) for fr, args, kw in recorder.calls["bev_epilogue"]
             if fr == frame][:3]
    check(len(calls) == 3, f"bev_epilogue: {len(calls)} calls recorded on "
          f"{frame}, expected 3")
    pairs = []
    for args, _kw in calls:
        y, bias, out = args[:3]
        _n, c, h, w = y.shape
        maps = [torch.empty((1, out.stride(3), h, w), dtype=y.dtype,
                            device=y.device,
                            memory_format=torch.channels_last)
                for _ in range(2)]
        got = be.bev_epilogue_cuda(y, bias, maps[0][:, :c])
        ref = be.bev_epilogue_plain(y, bias, maps[1][:, :c])
        check(torch.equal(got, ref), f"bev_epilogue differs from its plain "
              f"version on {frame}, lateral {tuple(y.shape)}")
        pairs.append((y, bias, maps[0][:, :c], maps[1][:, :c]))

    def run(fn, which):
        for p in pairs:
            fn(p[0], p[1], p[which])

    t_k = cuda_ms(lambda: run(be.bev_epilogue_cuda, 2))
    t_p = cuda_ms(lambda: run(be.bev_epilogue_plain, 3))
    t_d, how = device_ms(lambda: run(be.bev_epilogue_cuda, 2),
                         SYMBOLS["bev_epilogue"])
    elems = sum(p[0].numel() for p in pairs)
    nbytes = 2 * elems * 2            # y read and the slice written, bf16
    b, by = bound_ms(nbytes, 2 * elems, F32_FLOPS)
    return {"ms": t_k, "device_ms": t_d, "device_ms_by": how,
            "plain_ms": t_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "bytes": nbytes, "ops": 2 * elems,
            "laterals": [list(p[0].shape) for p in pairs],
            "max_abs_err": 0.0}


def check_voxelize(frames):
    """Phase 5a (module docstring): kernel voxel_segments at the caps of
    the three served configurations, on the dense frame (nuScenes) and
    phase 11's densified frame (Waymo): equal to the plain steps, timed
    against its bound, the plain steps and torch.cummax."""
    import torch
    from dsvt_ai_trt_tpu_torch import bench
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig
    from dsvt_ai_trt_tpu_torch.ops import voxelize as vox
    from dsvt_ai_trt_tpu_torch.ops import voxelize_kernel as vk
    waymo = None
    out = {}
    for name, path in VOXELIZE_CONFIGS.items():
        with open(path) as f:
            raw = json.load(f)["config"]
        cfg = DSVTConfig.from_json(json.dumps({**raw, "precision": "bf16"}))
        if name == "dsvt-nuscenes":
            pts, n = frames["dense_seed0"]
        else:
            waymo = waymo or bench.densify([bench.waymo_base_frame()],
                                           bench.WAYMO_POINTS,
                                           cfg.max_points)[0]
            pts, n = waymo
        check(pts.shape[0] == cfg.max_points, f"voxelize {name}: the frame "
              f"holds {pts.shape[0]} rows, not max_points")
        points = torch.from_numpy(pts).cuda()
        num = torch.tensor(int(n), device="cuda")
        s_cell, perm = vox.sort_cells(points, num, cfg)
        key = vk.cap_keys_cuda(s_cell, cfg)
        check(torch.equal(key, vox.cap_keys_plain(s_cell, cfg)),
              f"voxelize {name}: the cap's keys differ from the plain ones")
        comp = vox.compact(key, cfg)
        s_c, perm2, _, pop = comp
        got = vk.pillars_cuda(s_c, pop, points, perm, perm2, cfg)
        want = vox.pillars_plain(*comp, points[perm], cfg)
        whole = (vox.voxelize(points, num, cfg, use_kernels=True),
                 vox.voxelize(points, num, cfg, use_kernels=False))
        for field, a, b in zip(want._fields, got, want):
            check(torch.equal(a, b), f"voxelize {name}: {field} of the "
                  f"second launch differs from pillars_plain's")
        for field in want._fields:
            check(torch.equal(getattr(whole[0], field),
                              getattr(whole[1], field)),
                  f"voxelize {name}: {field} differs from the plain version")

        def kernel():
            vk.cap_keys_cuda(s_cell, cfg)
            vk.pillars_cuda(s_c, pop, points, perm, perm2, cfg)

        def plain():
            vox.cap_keys_plain(s_cell, cfg)
            vox.pillars_plain(*comp, points[perm], cfg)

        N, P1 = s_cell.shape[0], s_c.shape[0]
        pos_n = torch.arange(N, device="cuda")
        pos_p = torch.arange(P1, device="cuda")

        def library():          # the plain version's three scans
            torch.cummax(pos_n, 0)
            torch.cummax(pos_p, 0)
            torch.cummax(pos_p, 0)

        kept = int(got[2].sum())
        # each input byte read once, each output written once: the cap's
        # cells and keys; every compacted row's cell and pillar read and
        # its features, pillar and flag written; a kept row's two orders
        # and point read; the registry written
        nbytes = (N * 16 + P1 * (16 + 4 * vk.FEATS + 9) + kept * 32
                  + cfg.max_pillars * (9 + 8 * got[3].shape[1]) + 8)
        t_b, by = bound_ms(nbytes, 0, BF16_FLOPS)
        t_d, how = device_ms(kernel, SYMBOLS["voxel_segments"])
        out[name] = {
            "rows": [N, P1], "kept_points": kept,
            "pillars": int(got[6]), "bytes": nbytes,
            "ms": cuda_ms(kernel), "device_ms": t_d, "device_ms_by": how,
            "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
            "library_device_ms": device_ms(library, "scan")[0],
            "library": "torch.cummax over N + 2 x P1 rows",
            "bound_ms": t_b, "bound_by": by, "max_abs_err": 0.0,
            "voxelize_device_ms": {
                "kernel": device_ms(lambda: vox.voxelize(
                    points, num, cfg, use_kernels=True))[0],
                "plain": device_ms(lambda: vox.voxelize(
                    points, num, cfg, use_kernels=False))[0]}}
        out[name]["bound_share"] = t_b / t_d
    return {"configs": out}


def check_rotated_overlap(recorder, frames_to_check):
    """Kernel B4 vs the plain clip on the strict upper triangle (atol and
    rtol 1e-4; expected equal, and max |err| is reported), an identical NMS
    kept set with either overlap, and the count of pairs that took the
    kernel's 64-slot rerun, on each frame; timed on the first."""
    import torch
    from dsvt_ai_trt_tpu_torch import kernels
    from dsvt_ai_trt_tpu_torch.ops import nms as nms_ops
    from dsvt_ai_trt_tpu_torch.ops import nms_kernel as nk
    res = {"max_abs_err": 0.0, "per_frame": {}}
    for frame in frames_to_check:
        args, _kw = first_call(recorder, "rotated_overlap", frame)
        boxes = args[0]
        got = nk.pairwise_overlap_cuda(boxes)
        ref = nk.pairwise_overlap_clip(boxes)
        n = boxes.shape[0]
        iu = torch.triu_indices(n, n, 1, device=boxes.device)
        torch.testing.assert_close(got[iu[0], iu[1]], ref[iu[0], iu[1]],
                                   atol=1e-4, rtol=1e-4)
        check(torch.all(torch.tril(got) == 0),
              f"rotated_overlap: a >= b not zero on {frame}")
        count = int((boxes[:, 8] > 0).sum())
        kb, kc = nms_ops.nms(boxes, count, 0.01, use_kernels=True)
        pb, pc = nms_ops.nms(boxes, count, 0.01, use_kernels=False)
        check(int(kc) == int(pc) and torch.equal(kb, pb),
              f"nms kept set differs on {frame}: kernel {int(kc)} vs plain "
              f"{int(pc)}")
        slow = torch.zeros(1, dtype=torch.int32, device=boxes.device)
        scratch = torch.empty_like(got)
        kernels.launch("rotated_overlap", boxes.data_ptr(), boxes.stride(0),
                       scratch.data_ptr(), n, slow.data_ptr())
        check(torch.equal(scratch, got), "rotated_overlap: counted launch "
              "differs from the wrapper's")
        err = float((got[iu[0], iu[1]] - ref[iu[0], iu[1]]).abs().max())
        res["max_abs_err"] = max(res["max_abs_err"], err)
        res["per_frame"][frame] = {
            "N": n, "boxes_in": count, "nms_kept": int(kc),
            "overlapping_pairs": int((got[iu[0], iu[1]] > 0).sum()),
            "slow_pairs": int(slow), "max_abs_err": err}
        if frame != frames_to_check[0]:
            continue
        t_k = cuda_ms(lambda: nk.pairwise_overlap_cuda(boxes))
        t_p = cuda_ms(lambda: nk.pairwise_overlap_clip(boxes), reps=3,
                      warmup=1)
        t_d, how = device_ms(lambda: nk.pairwise_overlap_cuda(boxes),
                             SYMBOLS["rotated_overlap"])
        t_w, how_w = device_ms(lambda: nk.pairwise_overlap_cuda(boxes))
        one = torch.empty(1, device=boxes.device)
        t_floor, _ = device_ms(one.zero_)   # one launch's own device time
        # operations this frame's boxes need (nms_kernel.flops)
        ops = nk.flops(n, res["per_frame"][frame]["overlapping_pairs"])
        nbytes = n * 9 * 4 + n * n * 4
        b, by = bound_ms(nbytes, ops, F32_FLOPS)
        res.update({"ms": t_k, "device_ms": t_d, "device_ms_by": how,
                    "wrapper_device_ms": t_w, "wrapper_device_ms_by": how_w,
                    "one_launch_floor_device_ms": t_floor,
                    "plain_ms": t_p, "library_ms": None, "bound_ms": b,
                    "bound_by": by, "bytes": nbytes, "ops": ops, "N": n})
    return res


def peel_rounds(sup, count):
    """The rounds the peeling loop takes on this mask: the plain loop,
    counted (the kernel's work depends on them)."""
    import torch
    undecided = torch.arange(sup.shape[0], device=sup.device) < count
    rounds = 0
    while bool(undecided.any()):
        promote = undecided & ~(sup & undecided[:, None]).any(dim=0)
        suppressed = (sup & promote[:, None]).any(dim=0)
        undecided = undecided & ~promote & ~suppressed
        rounds += 1
    return rounds


def chain_boxes(n, spacing=0.9, length=4.0):
    """Score-sorted boxes in a row along x, each overlapping the next by
    (1 - spacing) of its length and no other: a suppression chain of n / 2
    peeling rounds at IoU 0.01."""
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = np.arange(n) * spacing * length
    boxes[:, 3], boxes[:, 4], boxes[:, 5] = 2.0, length, 1.5
    boxes[:, 8] = np.linspace(0.99, 0.3, n)
    return boxes


IOU_OPS = 5   # f32 operations a pair: add, subtract, clamp, divide, compare


def check_nms_peel(recorder, frames_to_check, top_k, stage_ms=None):
    """Kernel nms_peel vs its plain version, bit-equal (boxes out and kept
    count), on each frame's recorded (overlap, boxes, count, threshold) and
    on a constructed chain of top_k boxes, each overlapping the next
    (top_k / 2 rounds), with B4's overlap; there also the whole NMS on the
    card (B4 + nms_peel) against the CPU's plain NMS.  Timed on the first
    frame and on the chain, beside one launch's own device time (the floor
    of any one-launch design).  The work depends on the data: the bound
    counts the overlap's upper triangle in the rows below the count, read
    once, the boxes read and written once, the count and kept count, and
    IOU_OPS operations a pair read plus rounds * 2 * K * ceil(K/32) 32-bit
    ANDs, at the f32 vector rate; no PyTorch call computes it (library_ms
    null).  ``stage_ms``: the profiled frame's NMS stage device ms
    (B4 + nms_peel), reported beside."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import nms as nms_ops
    from dsvt_ai_trt_tpu_torch.ops import nms_peel as npl

    def held(args, what):
        got = npl.nms_peel_cuda(*args)
        ref = npl.nms_peel_plain(*args)
        check(torch.equal(got[0].view(torch.int32), ref[0].view(torch.int32))
              and torch.equal(got[1], ref[1]),
              f"nms_peel differs from its plain version on {what}: "
              f"{int(got[1])} vs {int(ref[1])} kept")
        return int(got[1])

    def timed(args):
        _overlap, boxes, count, _thr = args
        K = boxes.shape[0]
        rounds = peel_rounds(npl.suppression_plain(*args), count)
        rows = max(0, min(int(count), K))
        pairs = rows * (K - 1) - rows * (rows - 1) // 2   # i < rows, i < j
        ops = IOU_OPS * pairs + rounds * 2 * K * ((K + 31) // 32)
        nbytes = 4 * pairs + 2 * K * 9 * 4 + 8 + 8
        b, by = bound_ms(nbytes, ops, F32_FLOPS)
        t_d, how = device_ms(lambda: npl.nms_peel_cuda(*args),
                             SYMBOLS["nms_peel"])
        one = torch.empty(1, device=boxes.device)
        t_floor, _ = device_ms(one.zero_)   # one launch's own device time
        return {"K": K, "count": rows, "rounds": rounds, "pairs": pairs,
                "bytes": nbytes, "ops": ops,
                "ms": cuda_ms(lambda: npl.nms_peel_cuda(*args)),
                "device_ms": t_d, "device_ms_by": how,
                "one_launch_floor_device_ms": t_floor,
                "plain_ms": cuda_ms(lambda: npl.nms_peel_plain(*args),
                                    reps=5, warmup=1),
                "library_ms": None, "bound_ms": b, "bound_by": by}

    res = {"max_abs_err": 0.0, "per_frame": {},
           "nms_stage_device_busy_ms": stage_ms}
    for frame in frames_to_check:
        args, _kw = first_call(recorder, "nms_peel", frame)
        args = args[:4]
        res["per_frame"][frame] = {
            "kept": held(args, frame),
            "rounds": peel_rounds(npl.suppression_plain(*args), args[2])}
        if frame == frames_to_check[0]:
            res.update(timed(args))
    boxes = torch.from_numpy(chain_boxes(top_k))
    card, count = boxes.cuda(), torch.tensor(top_k, device="cuda")
    got = nms_ops.nms(card, count, 0.01, use_kernels=True)
    ref = nms_ops.nms(boxes, top_k, 0.01, use_kernels=False)
    check(int(got[1]) == int(ref[1]) == (top_k + 1) // 2
          and torch.equal(got[0].cpu(), ref[0]),
          f"nms on the chain: {int(got[1])} kept on the card, "
          f"{int(ref[1])} on the CPU, {(top_k + 1) // 2} expected")
    args = (nms_ops.pairwise_overlap(card), card, count, 0.01)
    held(args, "the chain")
    res["chain"] = timed(args)
    return res


def check_graph(engine, frames):
    """The graph phase (module docstring): the engine's CUDA graph against
    the eager forward, and what it does to the frame's time."""
    import statistics
    import torch
    from dsvt_ai_trt_tpu_torch import bench, weights
    from dsvt_ai_trt_tpu_torch.config import WAYMO_CONFIG
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    dev = on_card(frames)
    out = {}

    # one eager kernel-path frame may not synchronise with the host
    pts, n = dev["dense_seed0"]
    engine.eager(pts, n)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        engine.eager(pts, n)
    except RuntimeError as exc:
        raise SmokeFailure(f"graph: the eager forward synchronises: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["eager_syncs"] = 0

    # replays against the eager forward, with and without NMS, at the
    # nuScenes density and the Waymo density
    wcfg = dataclasses.replace(WAYMO_CONFIG, precision="bf16")
    (wpts, wn), = bench.densify([bench.waymo_base_frame()],
                                bench.WAYMO_POINTS, wcfg.max_points)
    wparams = weights.from_jax_params(weights.random_params(wcfg, 0), "cuda")
    engines = {"default_nms": (engine, dev),
               "default_no_nms": (Engine(engine.params, engine.cfg,
                                         with_nms=False), dev),
               "waymo_nms": (Engine(wparams, wcfg), on_card(
                   {"waymo": (wpts, wn)})),
               "waymo_no_nms": (Engine(wparams, wcfg, with_nms=False),
                                on_card({"waymo": (wpts, wn)}))}
    out["engines"] = {}
    for tag, (eng, fr) in engines.items():
        eng.warmup()
        want = {k: (0 if k in NMS_KERNELS and not eng.with_nms else v)
                for k, v in LAUNCHES.items()}
        check(eng.graph_launches == want, f"graph {tag}: the capture holds "
              f"{eng.graph_launches}, expected {want}")
        row = {"capture_seconds": eng.capture_seconds,
               "graph_pool_mb": eng.graph_pool_bytes / 2**20,
               "launches_a_replay": eng.graph_launches, "frames": {}}
        for name, (p, c) in fr.items():
            got = eng(p, c)
            check(same_dets(got, eng.eager(p, c)),
                  f"graph {tag}: replay differs from eager on {name}")
            row["frames"][name] = int(got.count)
        out["engines"][tag] = row

    # the copy-out rule: two engines' replays interleaved, nothing waited
    # for in between, each result still its own frame's
    other = engines["default_no_nms"][0]
    names = list(dev)
    calls = []
    for i, name in enumerate(names):
        calls.append((engine, name, engine(*dev[name])))
        nxt = names[(i + 1) % len(names)]
        calls.append((other, nxt, other(*dev[nxt])))
    torch.cuda.synchronize()
    for eng, name, got in calls:
        check(same_dets(got, eng.eager(*dev[name])), f"graph: an interleaved "
              f"replay's result on {name} was changed by a later replay")
    check(not torch.equal(calls[0][2].boxes, calls[2][2].boxes),
          "graph: two frames gave the same boxes")
    out["interleaved_replays"] = len(calls)

    # the scan graph (run_frames_scan, the bench's batch): SCAN_BATCH frames
    # in one capture, each bit-equal to the engine's per-frame replay; a
    # replay counts SCAN_BATCH x 2/8/8/1/1, with the counts set to 0 just
    # before and read just after
    from dsvt_ai_trt_tpu_torch import kernels
    from dsvt_ai_trt_tpu_torch.model.detector import forward_batch
    group = [names[i % len(names)] for i in range(SCAN_BATCH)]
    points = torch.stack([dev[g][0] for g in group])
    nums = torch.stack([dev[g][1] for g in group])
    scan = Engine(engine.params, engine.cfg, batch=SCAN_BATCH).warmup()
    want = {k: SCAN_BATCH * v for k, v in LAUNCHES.items()}
    check(scan.graph_launches == want, f"scan graph: the capture holds "
          f"{scan.graph_launches}, expected {want}")
    kernels.reset_counts()
    got = scan(points, nums)
    torch.cuda.synchronize()
    counts = kernels.counts()
    check(counts == want, f"scan graph: a replay counted {counts}, "
          f"expected {want}")
    for i, g in enumerate(group):
        check(all(torch.equal(a[i], b) for a, b in zip(got, engine(*dev[g]))),
              f"scan graph: frame {i} ({g}) differs from the engine's replay")

    # ms a frame: SCAN_BATCH frames through the scan graph, through the
    # per-frame graph back to back, and through eager forward_batch
    # (medians of 5 alternated samples of 2 groups, read back at the end)
    def scan_ms(mode):
        t0 = time.perf_counter()
        if mode == "scan_graph":
            outs = [scan(points, nums) for _ in range(2)]
        elif mode == "frame_graph":
            outs = [engine(points[i], nums[i]) for _ in range(2)
                    for i in range(SCAN_BATCH)]
        else:
            outs = [forward_batch(engine.params, points, nums, engine.cfg,
                                  True) for _ in range(2)]
        for d in outs:
            d.count.cpu()
        return (time.perf_counter() - t0) / (2 * SCAN_BATCH) * 1e3

    modes = ("scan_graph", "frame_graph", "eager_batch")
    samples = {m: [] for m in modes}
    for rep in range(5):
        for m in (modes if rep % 2 == 0 else modes[::-1]):
            samples[m].append(scan_ms(m))
    out["scan"] = {"batch": SCAN_BATCH, "frames": group,
                   "capture_seconds": scan.capture_seconds,
                   "graph_pool_mb": scan.graph_pool_bytes / 2**20,
                   "launches_a_replay": counts,
                   **{f"ms_a_frame_{m}": statistics.median(v)
                      for m, v in samples.items()},
                   "samples": samples}
    del scan

    # host-clock ms a frame, eager against graph, alternated in one process
    # (medians of 5 samples each of 2 passes over the frames)
    def sync_ms(fn, fr):
        t0 = time.perf_counter()
        for _ in range(2):
            for p, c in fr:
                fn(p, c).count.cpu()
        return (time.perf_counter() - t0) / (2 * len(fr)) * 1e3

    def stream_ms(fn, fr):
        t0 = time.perf_counter()
        outs = [fn(p, c) for _ in range(2) for p, c in fr]
        for d in outs:
            d.count.cpu()
        return (time.perf_counter() - t0) / (2 * len(fr)) * 1e3

    out["times"] = {}
    for tag in ("default_nms", "waymo_nms"):
        eng, fr = engines[tag]
        fr = list(fr.values())
        samples = {(m, mode): [] for m in ("sync", "stream")
                   for mode in ("eager", "graph")}
        for rep in range(5):
            order = ("eager", "graph") if rep % 2 == 0 else ("graph", "eager")
            for mode in order:
                fn = eng.eager if mode == "eager" else eng
                samples[("sync", mode)].append(sync_ms(fn, fr))
                samples[("stream", mode)].append(stream_ms(fn, fr))
        row = {f"{m}_ms_{mode}": statistics.median(v)
               for (m, mode), v in samples.items()}
        row["samples"] = {f"{m}_{mode}": v for (m, mode), v in samples.items()}
        # the host's time to enqueue one frame, the card idle beforehand
        enq = {}
        for mode in ("eager", "graph"):
            fn = eng.eager if mode == "eager" else eng
            ts = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(*fr[0])
                ts.append((time.perf_counter() - t0) * 1e3)
            enq[mode] = statistics.median(ts)
        torch.cuda.synchronize()
        row["enqueue_ms_eager"], row["enqueue_ms_graph"] = enq["eager"], \
            enq["graph"]
        # a traced frame of each: device ms, span, idle share, host ms in
        # launch calls and waiting
        for mode in ("eager", "graph"):
            fn = eng.eager if mode == "eager" else eng
            prof = capture(fn, fr[0], iters=4)
            row[f"trace_{mode}"] = {
                "device_ms": prof.device_ms_per_iter,
                "span_ms": prof.window_ms_per_iter,
                "idle_share": prof.idle_share,
                "host_ms": prof.host_ms_per_iter,
                "host_launch_ms": prof.host_launch_ms_per_iter,
                "host_wait_ms": prof.host_wait_ms_per_iter,
                "device_events": len(prof.ops) / 4}
        out["times"][tag] = row
    return out


def check_tiny_golden():
    """The tiny configuration at fp32 on the card (kernels B3 and B4 on the
    path) reproduces the fp32 golden boxes at the golden's tolerance."""
    import torch
    from dsvt_ai_trt_tpu_torch import weights
    from dsvt_ai_trt_tpu_torch.model.detector import forward
    cfg = tiny_config()
    params = weights.from_jax_params(weights.random_params(cfg, 0), "cuda")
    pts, n = tiny_cloud(cfg)
    dets = forward(params, pts, n, cfg, with_nms=True, device="cuda")
    with open(GOLDEN_TINY) as f:
        ref = json.load(f)
    count = int(dets.count)
    check(count == ref["count"], f"tiny golden: {count} boxes vs {ref['count']}")
    got = dets.boxes[:count].cpu().numpy()
    want = np.asarray(ref["boxes"], np.float32)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    return {"tiny_golden_boxes": count,
            "tiny_golden_max_abs_err": float(np.abs(got - want).max())}


def check_parity_suite(frames):
    """Phase 7 (module docstring): ``parity.run_suite`` on the card, every
    row gated by ``parity.py``'s exact-top-k gate; returns the suite.

    Printed after it, not gated: for each of the three frames, on the
    checkpoint the ``bf16_nuscenes`` row calibrated on it, eval.parity_ok
    (a one-to-one match of every box, recall and precision >= 0.95) of
    bf16 against fp32 after NMS, for the kernel path and for the plain
    bf16 path (``use_pallas=False``: no kernel, the PyTorch versions the
    CPU tests hold against JAX bf16).  Both miss on some frames, so the
    kernels do not cause the miss (ROADMAP queue C1)."""
    from dsvt_ai_trt_tpu_torch import parity, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.eval import match_boxes
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    suite = parity.run_suite(device="cuda")
    for tag, row in suite["gates"].items():
        log({"phase": "parity_suite", "row": tag,
             **{k: row[k] for k in ("precision_mode", "density", "worst",
                                    "n_confident", "pass_recall",
                                    "parity_ok", "seconds", "frames")}})
    failed = [tag for tag, row in suite["gates"].items()
              if not row["parity_ok"]]
    check(not failed, f"parity suite rows failed: {failed}")

    cfg32 = dataclasses.replace(DEFAULT_CONFIG, precision="fp32")
    cfg16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")

    def kept(params, cfg, pts, n):
        dets = Engine(params, cfg)(pts, n)
        return dets.boxes[:int(dets.count)].cpu().numpy()

    def summary(m):
        return {"boxes": [m["n_pred"], m["n_ref"]], "recall": m["recall"],
                "precision": m["precision"]}

    for name, (pts, n) in frames.items():
        raw = weights.calibrated_raw(cfg32, pts, n, seed=0, n_boxes=40,
                                     device="cuda")
        params = weights.from_jax_params(weights.prepare_params(raw, cfg32),
                                         "cuda")
        ref = kept(params, cfg32, pts, n)
        log({"phase": "parity_after_nms", "frame": name,
             "kernels": summary(match_boxes(kept(params, cfg16, pts, n), ref)),
             "plain_bf16": summary(match_boxes(kept(
                 params, dataclasses.replace(cfg16, use_pallas=False),
                 pts, n), ref))})
    return suite


def check_runtime(engine, frames, tmp):
    """Phase 10: the CLI path on the three frames (module docstring)."""
    from dsvt_ai_trt_tpu_torch import cli, kernels
    from dsvt_ai_trt_tpu_torch.io.output import load_txt
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine
    data = os.path.join(tmp, "frames")
    os.makedirs(data)
    names = {}
    for i, (name, (pts, n)) in enumerate(frames.items()):
        names[f"{i:06d}"] = name
        pts[: int(n)].tofile(os.path.join(data, f"{i:06d}.bin"))
    common = ["--precision", engine.cfg.precision, "--weights", ""]

    def infer(out, *extra):
        cli.main(["infer", *common, "--data", data, "--out",
                  os.path.join(tmp, out), *extra])
        return {f: load_txt(os.path.join(tmp, out, f + ".txt"))[1]
                for f in names}

    t0 = time.perf_counter()
    for tag, extra in (("", []), ("_host_nms", ["--host-nms"])):
        cli.main(["build", *common, *extra, "--engine",
                  os.path.join(tmp, f"dsvt{tag}.engine")])
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    stream = infer("stream", "--engine", os.path.join(tmp, "dsvt.engine"),
                   "--pipeline-depth", "2")
    counts = kernels.counts()
    warm = Engine.WARM_RUNS + 1      # eager warm frames, the first replay
    want = {k: v * (len(frames) + warm) for k, v in LAUNCHES.items()}
    check(counts == want, f"cli infer launch counts {counts} != {want} "
          f"({len(frames)} frames and {warm} warm-up frames)")
    out = {"build_seconds": build_s, "launches": counts, "frames": {}}
    for f, name in names.items():
        dets = engine(*frames[name])
        ref = dets.boxes[: int(dets.count)].cpu().numpy()
        check(stream[f].shape == ref.shape,
              f"cli infer {name}: {len(stream[f])} rows vs {len(ref)}")
        np.testing.assert_allclose(stream[f], ref, atol=1e-4, rtol=1e-4)
        out["frames"][name] = {"rows": len(ref), "max_abs_err_vs_engine":
                               float(np.abs(stream[f] - ref).max())}
    for mode, extra in (("host_nms", ["--host-nms", "--engine",
                                      os.path.join(tmp, "dsvt_host_nms.engine")]),
                        ("scan_batch_2", ["--scan-batch", "2"])):
        got = infer(mode, *extra)
        for f, name in names.items():
            check(got[f].shape == stream[f].shape,
                  f"cli infer {mode} {name}: {len(got[f])} rows vs "
                  f"{len(stream[f])} with NMS on the card")
            np.testing.assert_allclose(got[f], stream[f], atol=1e-4, rtol=1e-4)
            out["frames"][name][f"{mode}_max_abs_err"] = float(
                np.abs(got[f] - stream[f]).max())
    return out


def check_waymo(tmp):
    """Phase 11: WAYMO_CONFIG at full width on the densified seeded frame
    (module docstring); ``cli stats`` prints the frame's occupancy."""
    import torch
    from dsvt_ai_trt_tpu_torch import bench, cli, kernels, weights
    from dsvt_ai_trt_tpu_torch.config import WAYMO_CONFIG
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine, cap_table
    cfg = dataclasses.replace(WAYMO_CONFIG, precision="bf16")
    (pts, n), = bench.densify([bench.waymo_base_frame()],
                              bench.WAYMO_POINTS, cfg.max_points)
    data = os.path.join(tmp, "waymo_dense")
    os.makedirs(data)
    pts[: int(n)].tofile(os.path.join(data, "000000.bin"))
    cfg_path = os.path.join(tmp, "waymo.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    cli.main(["stats", "--config", cfg_path, "--data", data])

    engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
    engine(pts, n)
    torch.cuda.synchronize()
    kernels.reset_counts()
    dets = engine(pts, n)
    torch.cuda.synchronize()
    counts = kernels.counts()
    check(counts == LAUNCHES, f"waymo launch counts {counts} != {LAUNCHES}")
    recorder = Recorder()            # the kernels' inputs, from eager
    with recorder:
        recorder.frame = "waymo"
        check(same_dets(engine.eager(*on_card({"w": (pts, n)})["w"]), dets),
              "waymo: the graph replay differs from the eager forward")
    occ = dets.occupancy.cpu().tolist()
    caps = cap_table(cfg)[1].tolist()
    check(all(o < c for o, c in zip(occ, caps)),
          f"waymo occupancy {occ} reaches a cap of {caps}")
    check(bool(torch.isfinite(dets.boxes).all())
          and list(dets.boxes.shape) == [cfg.top_k, 9], "waymo: bad boxes")
    res = {"points": int(n), "occupancy": occ, "caps": caps,
           "boxes": int(dets.count), "launches": counts,
           "ms": cuda_ms(lambda: engine(pts, n), reps=5, warmup=1)}
    for name, fn in (("set_attention", check_set_attention),
                     ("segment_max", lambda r, f: check_segment_max(
                         r, f, ragged=False))):
        k = fn(recorder, ["waymo"])
        res[name] = {key: k[key] for key in (
            "ms", "device_ms", "device_ms_by", "plain_ms", "library_ms",
            "bound_ms", "bound_by", "max_abs_err") if key in k}
        res[name]["bound_share"] = k["bound_ms"] / k["device_ms"]
        res[name]["shapes"] = ({key: k[key] for key in ("S", "K", "C", "H",
                                                        "set_count")}
                               if name == "set_attention" else
                               [{key: c[key] for key in (
                                   "N", "C", "starts_only", "defined_rows",
                                   "device_ms")} for c in k["calls"]])
    return res


def check_voxel():
    """Phase 11b: ``dsvt-voxel-waymo`` (upstream DSVT-V, four stages of
    3-D windows and three attention poolings, read from the benchmark's
    configuration file) at bf16 with seeded random weights on phase 11's
    180 000-point frame, whose voxels and sets fit every cap of that
    configuration: the launch counts of one replay (counts set to 0 just
    before it), the replay bit-equal to the eager forward, occupancy under
    every cap; kernel ``stage_pool`` held against its plain version on
    each of the three poolings' inputs from that eager pass (live parents
    at atol 2e-2, rtol 1e-2 as the card test; zeros past the count), and
    on each its device ms against its bound."""
    import torch
    from dsvt_ai_trt_tpu_torch import bench, kernels, weights
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig, occupancy_caps
    from dsvt_ai_trt_tpu_torch.ops import pool_kernel as pk
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    with open(VOXEL_CONFIG) as f:
        raw = json.load(f)["config"]
    cfg = DSVTConfig.from_json(json.dumps({**raw, "precision": "bf16"}))
    cfg.validate()
    (pts, n), = bench.densify([bench.waymo_base_frame()],
                              bench.WAYMO_POINTS, cfg.max_points)
    engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
    engine(pts, n)
    torch.cuda.synchronize()
    kernels.reset_counts()
    dets = engine(pts, n)
    torch.cuda.synchronize()
    counts = kernels.counts()
    check(counts == VOXEL_LAUNCHES,
          f"voxel launch counts {counts} != {VOXEL_LAUNCHES}")
    recorder = Recorder(names=("stage_pool",))
    with recorder:
        recorder.frame = "voxel"
        check(same_dets(engine.eager(*on_card({"v": (pts, n)})["v"]), dets),
              "voxel: the graph replay differs from the eager forward")
    occ = dets.occupancy.cpu().tolist()
    caps = list(occupancy_caps(cfg)[1])
    check(all(o < c for o, c in zip(occ, caps)),
          f"voxel occupancy {occ} reaches a cap of {caps}")
    check(bool(torch.isfinite(dets.boxes).all())
          and list(dets.boxes.shape) == [cfg.top_k, 9], "voxel: bad boxes")
    calls = recorder.calls["stage_pool"]
    check(len(calls) == 3, f"voxel: {len(calls)} poolings recorded, not 3")
    rows, max_err = [], 0.0
    for _frame, args, _kw in calls:
        q, kv, child, _kb, _vb, count, _heads = args
        got, want = pk.stage_pool_cuda(*args), pk.stage_pool_plain(*args)
        live = int(count)
        torch.testing.assert_close(got[:live].float(), want[:live].float(),
                                   atol=2e-2, rtol=1e-2)
        check(torch.all(got[live:] == 0),
              f"stage_pool: parents >= count ({live}) not zero")
        max_err = max(max_err, float((got[:live].float()
                                      - want[:live].float()).abs().max()))
        (N1, V), N0, C = child.shape, kv.shape[0], q.shape[1]
        children = int((child[:live] < N0).sum())
        # the children's k | v rows, the parents' query and output rows
        nbytes = (children * 2 * C + 2 * live * C) * 2
        ops = pk.flops(live, V, C)
        b, by = bound_ms(nbytes, ops, BF16_FLOPS)
        t_d, how = device_ms(lambda: pk.stage_pool_cuda(*args),
                             "stage_pool_kernel")
        rows.append({"children": children, "parents": live, "N0": N0,
                     "N1": N1, "V": V, "C": C, "device_ms": t_d,
                     "device_ms_by": how, "bound_ms": b, "bound_by": by,
                     "bound_share": b / t_d})
    sums = {key: sum(r[key] for r in rows)
            for key in ("device_ms", "bound_ms")}
    pool = {"ms": sum(cuda_ms(lambda a=a: pk.stage_pool_cuda(*a[1]))
                      for a in calls),
            "plain_ms": sum(cuda_ms(lambda a=a: pk.stage_pool_plain(*a[1]))
                            for a in calls),
            **sums, "device_ms_by": rows[0]["device_ms_by"],
            "bound_by": rows[0]["bound_by"],
            "bound_share": sums["bound_ms"] / sums["device_ms"],
            "max_abs_err": max_err, "calls": rows,
            "library_ms": None}
    return {"config": "dsvt-voxel-waymo", "points": int(n), "occupancy": occ,
            "caps": caps, "boxes": int(dets.count), "launches": counts,
            "ms": cuda_ms(lambda: engine(pts, n), reps=5, warmup=1),
            "stage_pool": pool}


def check_query(frames):
    """Phase 11c: ``dsvt-transfusion-nuscenes`` (upstream DSVT's nuScenes
    model: the TransFusion-L head on the pillar model, read from the
    benchmark's configuration file) at bf16 with seeded random weights on
    the dense frame: the launch counts of one replay (counts set to 0 just
    before it: ``query_attention`` 1, no NMS kernel), the replay bit-equal
    to the eager forward, 200 finite boxes of 13 columns; kernel
    ``query_attention`` held against its plain version on the inputs of
    that eager pass (atol and rtol 2e-2, as the card test) and timed: its
    device ms against its bound (the k | v projections of L + Pk and
    Q.K^T and P.V at 989 TFLOP/s, or L and Pk read once), the plain
    version, and PyTorch's ``scaled_dot_product_attention`` over the same
    keys and values, projected outside it (the library's yardstick)."""
    import torch
    import torch.nn.functional as F
    from dsvt_ai_trt_tpu_torch import kernels, weights
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig
    from dsvt_ai_trt_tpu_torch.ops import query_attention_kernel as qa
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    with open(QUERY_CONFIG) as f:
        raw = json.load(f)["config"]
    cfg = DSVTConfig.from_json(json.dumps({**raw, "precision": "bf16"}))
    cfg.validate()
    pts, n = frames["dense_seed0"]
    engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
    engine(pts, n)
    torch.cuda.synchronize()
    kernels.reset_counts()
    dets = engine(pts, n)
    torch.cuda.synchronize()
    counts = kernels.counts()
    check(counts == QUERY_LAUNCHES,
          f"query launch counts {counts} != {QUERY_LAUNCHES}")
    recorder = Recorder(names=("query_attention",))
    with recorder:
        recorder.frame = "query"
        check(same_dets(engine.eager(*on_card({"q": (pts, n)})["q"]), dets),
              "query: the graph replay differs from the eager forward")
    check(bool(torch.isfinite(dets.boxes).all())
          and list(dets.boxes.shape) == [cfg.num_proposals, 13]
          and 0 < int(dets.count) <= cfg.num_proposals, "query: bad boxes")
    calls = recorder.calls["query_attention"]
    check(len(calls) == 1, f"query: {len(calls)} cross-attentions recorded")
    args = calls[0][1]
    got, want = qa.query_attention_cuda(*args), qa.query_attention_plain(*args)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    q, feats, pos, w_kv, b_kv, heads = args
    (Nq, C), HW = q.shape, feats.shape[0]
    nbytes = (2 * HW * C + 2 * Nq * C + 2 * C * C) * 2 + 2 * C * 4
    b, by = bound_ms(nbytes, qa.flops(Nq, HW, C), BF16_FLOPS)
    t_d, how = device_ms(lambda: qa.query_attention_cuda(*args),
                         SYMBOLS["query_attention"])
    kv = (feats + pos) @ w_kv.t() + b_kv.to(w_kv.dtype)
    D = C // heads

    def heads_of(t):
        return t.reshape(1, -1, heads, D).transpose(1, 2)
    k4, v4, q4 = heads_of(kv[:, :C]), heads_of(kv[:, C:]), heads_of(q)
    return {"config": "dsvt-transfusion-nuscenes", "points": int(n),
            "boxes": int(dets.count), "launches": counts,
            "ms": cuda_ms(lambda: engine(pts, n), reps=5, warmup=1),
            "query_attention": {
                "ms": cuda_ms(lambda: qa.query_attention_cuda(*args)),
                "device_ms": t_d, "device_ms_by": how,
                "plain_ms": cuda_ms(lambda: qa.query_attention_plain(*args),
                                    reps=3, warmup=1),
                "bound_ms": b, "bound_by": by, "bound_share": b / t_d,
                "max_abs_err": float((got.float() - want.float()).abs().max()),
                "queries": Nq, "keys": HW,
                "library_ms": cuda_ms(
                    lambda: F.scaled_dot_product_attention(q4, k4, v4))}}


def grad_gate(name, got, ref):
    """The JAX package's per-leaf gradient gate (tests/test_training.py):
    max |d| <= max(5e-3 * leaf max, 5e-4).  Returns |d| / the gate."""
    d = float((got.double() - ref.double()).abs().max())
    tol = max(5e-3 * float(ref.abs().max()), 5e-4)
    check(d <= tol, f"training: gradient of {name} differs by {d:.3e} with "
          f"and without remat (gate {tol:.3e})")
    return d / tol


def check_training(frames, tmp):
    """Phase 12 (module docstring): training at DEFAULT_CONFIG fp32, full
    width, batch 2."""
    import io
    import torch
    from dsvt_ai_trt_tpu_torch import cli, kernels, train_run, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.data import synthetic_batch
    from dsvt_ai_trt_tpu_torch.parallel.training import (batched_loss,
                                                         make_train_step)
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    from dsvt_ai_trt_tpu_torch.runtime.profiler import count_flops
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="fp32")
    batch = synthetic_batch(np.random.default_rng(0), cfg, 2)
    out = {"config": "DEFAULT_CONFIG", "precision": cfg.precision,
           "batch": 2, "points": [int(n) for n in batch[1].cpu()]}

    def fresh():
        return weights.from_jax_params(weights.random_params(cfg, 0), "cuda")

    # one step's loss and gradients, remat off then on
    params = fresh()
    leaves = weights.named_leaves(params)
    for _, t in leaves:
        t.requires_grad_(True)
    grads, losses = {}, {}
    for remat in (False, True):
        loss = batched_loss(params, *batch, cfg, remat=remat)
        g = torch.autograd.grad(loss, [t for _, t in leaves],
                                allow_unused=True)
        grads[remat], losses[remat] = g, loss.item()
    check(abs(losses[True] - losses[False]) <= 1e-5 * abs(losses[False]),
          f"training: loss {losses[True]} with remat, {losses[False]} "
          "without")
    worst = 0.0
    for (path, _), a, b in zip(leaves, grads[False], grads[True]):
        check((a is None) == (b is None), f"training: {path} unused once")
        if a is not None:
            worst = max(worst, grad_gate(weights.keystr(path), b, a))
    out["remat_loss"] = losses
    out["remat_worst_gate_share"] = worst
    del grads, params, leaves

    # 6 default steps on the fixed batch (remat on: the card's default)
    params = fresh()
    _, step = make_train_step(cfg, params)
    kernels.reset_counts()
    curve = [float(step(*batch)) for _ in range(6)]
    torch.cuda.synchronize()
    launched = kernels.counts()
    check(all(np.isfinite(curve)) and curve[-1] < curve[0],
          f"training: loss did not fall over 6 steps: {curve}")
    check(not any(launched.values()),
          f"training launched kernels {launched}: it runs the plain paths")
    out["loss_curve"] = curve

    # ms per step and peak memory, remat on (these weights) and off
    other = fresh()
    _, step_plain = make_train_step(cfg, other, remat=False)
    out["step"] = {}
    for name, fn in (("remat", step), ("no_remat", step_plain)):
        fn(*batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        ms = cuda_ms(lambda: fn(*batch), reps=3, warmup=0)
        out["step"][name] = {
            "ms": ms, "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "resident_before_gb": resident / 1e9,
            "gflop": count_flops(fn, *batch).total / 1e9}
    del other, step_plain

    # one traced step (remat on)
    prof = capture(step, batch, iters=2)
    flops = prof.flops.total
    out["trace"] = {
        "iters": 2, "host_ms": prof.host_ms_per_iter,
        "device_span_ms": prof.window_ms_per_iter,
        "device_busy_ms": prof.device_ms_per_iter,
        "device_idle_share": prof.idle_share, "gflop": flops / 1e9,
        "mfu_device_fp32": flops / (prof.device_ms_per_iter / 1e3) / F32_FLOPS,
        "host_wait_ms": prof.host_wait_ms_per_iter,
        "host_launch_ms": prof.host_launch_ms_per_iter,
        "top_device": [{"name": r["name"][:90], "ms": r["ms"],
                        "calls": r["calls"]} for r in prof.top_ops(8)]}

    out["compiled"] = check_compiled_step(cfg, batch, fresh)

    # the trained weights through the bf16 kernel path, against the same
    # weights exported as .wts and reloaded; every top-k box is decoded
    # (score threshold 0), since a few steps may leave no score above 0.3
    cfg16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16",
                                score_threshold=0.0)
    wts = os.path.join(tmp, "trained.wts")
    weights.save_wts(weights.unfold_params(params, cfg), wts)
    reloaded = weights.from_jax_params(
        weights.prepare_params(weights.load_wts(wts), cfg), "cuda")
    trained = Engine(params, cfg16).warmup()
    again = Engine(reloaded, cfg16).warmup()
    with torch.inference_mode():
        kernels.reset_counts()
        got = {name: trained(pts, n) for name, (pts, n) in frames.items()}
        torch.cuda.synchronize()
        counts = kernels.counts()
        want_counts = {k: v * len(frames) for k, v in LAUNCHES.items()}
        check(counts == want_counts, f"training: trained-weight launch "
              f"counts {counts} != {want_counts}")
        out["engine"] = {"launches": counts, "frames": {}}
        for name, (pts, n) in frames.items():
            a, b = got[name], again(pts, n)
            ca, cb = int(a.count), int(b.count)
            check(ca == cb, f"training: {ca} boxes with the trained weights, "
                  f"{cb} with the reloaded .wts on {name}")
            a, b = a.boxes[:ca].cpu().numpy(), b.boxes[:cb].cpu().numpy()
            np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
            out["engine"]["frames"][name] = {
                "boxes": ca, "max_abs_err_vs_reloaded":
                    float(np.abs(a - b).max()) if ca else 0.0}

    # cli train: 1 step with a checkpoint, then 1 resumed step + export,
    # each through a captured step (the steps a graph ran are recorded)
    ckpt, cli_wts = os.path.join(tmp, "state.npz"), os.path.join(tmp, "cli.wts")
    lines = []
    for extra in (["--ckpt-every", "1"],
                  ["--resume", ckpt, "--export-wts", cli_wts]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), graph_steps() as seen:
            cli.main(["train", "--steps", "1", "--weights", "", "--ckpt",
                      ckpt, *extra])
        check([s.replays for s in seen] == [1], f"cli train {extra}: graph "
              f"replays {[s.replays for s in seen]}, expected [1]")
        lines.append(json.loads(buf.getvalue().strip().splitlines()[-1]))
    state = np.load(ckpt)
    check(int(state["step"]) == 2 and int(state["o:[0].count"]) == 2,
          "cli train: the resumed checkpoint is not at step 2")
    check(all(np.isfinite(line["loss_last"]) for line in lines),
          f"cli train: {lines}")
    folded = weights.prepare_params(weights.load_wts(cli_wts), cfg)
    last = cfg.num_blocks - 1
    for key, leaf in (("['head']['hm']['w1']", folded["head"]["hm"]["w1"]),
                      (f"['blocks'][{last}]['enc'][1]['wq']",
                       folded["blocks"][last]["enc"][1]["wq"])):
        check(np.array_equal(leaf, state["p:" + key]),
              f"cli train: exported {key} differs from the checkpoint's")
    out["cli_train"] = lines

    # train_run: 3 steps (3 replays of one captured step), 2 held-out
    # scenes, export, reload, re-eval
    with graph_steps() as seen:
        res = train_run.main(["--steps", "3", "--eval-scenes", "2",
                              "--log-every", "1",
                              "--out", os.path.join(tmp, "train_run.json"),
                              "--wts", os.path.join(tmp, "train_run.wts")])
    check([s.replays for s in seen] == [3], f"train_run: graph replays "
          f"{[s.replays for s in seen]}, expected [3]")
    check(res["wts_roundtrip"]["matches_trained"],
          f"train_run: reloaded recall {res['wts_roundtrip']['recall']} != "
          f"trained {res['eval']['recall']}")
    out["train_run"] = {k: res[k] for k in ("train_seconds", "loss_curve",
                                            "wts_roundtrip")}
    out["train_run"]["eval"] = {k: res["eval"][k] for k in
                                ("recall", "precision", "n_gt", "n_pred")}
    return out


@contextlib.contextmanager
def graph_steps():
    """The ``CompiledTrainStep``s that capture a graph inside the block, as
    a list (each keeps its count of replays)."""
    from dsvt_ai_trt_tpu_torch.parallel.training import CompiledTrainStep
    seen, orig = [], CompiledTrainStep.warmup

    def recording(self):
        if self._graph is None:
            seen.append(self)
        return orig(self)
    CompiledTrainStep.warmup = recording
    try:
        yield seen
    finally:
        CompiledTrainStep.warmup = orig
    check(all(s._graph is not None for s in seen), "a training step "
          "object warmed up without capturing its graph")


def check_compiled_step(cfg, batch, fresh):
    """The compiled training step (``CompiledTrainStep``, the port of
    ``jax.jit(train_step)``) at the training phase's configuration and
    batch: one eager step under ``set_sync_debug_mode("error")``; then
    TRAIN_STEPS graph replays against as many eager steps, each pair from
    the same weights (the graph's state is set in place to the eager's
    before each replay): the loss within 1e-5 relative, every leaf under
    ``step_gate``, no kernel launched; then ms a step eager against graph
    (medians of 5 alternated samples of 2 steps, host clock to a
    synchronise), a traced step of each (device ms, span, idle share, the
    index backward's device ms), the capture's seconds and its pool."""
    import statistics
    import torch
    from dsvt_ai_trt_tpu_torch import kernels, weights
    from dsvt_ai_trt_tpu_torch.parallel.training import (CompiledTrainStep,
                                                         make_train_step)
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    out = {}

    # an eager step (warm) may not synchronise with the host
    _, step = make_train_step(cfg, fresh())
    step(*batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step(*batch)
    except RuntimeError as exc:
        raise SmokeFailure(f"training: an eager step synchronises: {exc}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out["eager_step_syncs"] = 0
    del step

    ref_p, graph_p = fresh(), fresh()
    opt, eager = make_train_step(cfg, ref_p)
    compiled = CompiledTrainStep(cfg, graph_p, len(batch[0]))
    ref_leaves = weights.named_leaves(ref_p)
    leaves = weights.named_leaves(graph_p)
    kernels.reset_counts()
    compiled.warmup()
    rows = []
    for k in range(TRAIN_STEPS):
        if k:
            with torch.no_grad():
                for (_, r), (_, t) in zip(ref_leaves, leaves):
                    t.copy_(r)
                    for key in ("exp_avg", "exp_avg_sq"):
                        compiled.optimizer.state[t][key].copy_(
                            opt.state[r][key])
                compiled.optimizer.count.copy_(opt.count)
            weights.refold(graph_p)
        want = float(eager(*batch))
        got = float(compiled(*batch))
        check(abs(got - want) <= 1e-5 * abs(want), f"training: replay {k} "
              f"loss {got} against the eager step's {want}")
        names = [weights.keystr(path) for path, _ in ref_leaves]
        diffs = np.array([step_gate(
            name, t.detach().cpu().numpy(), r.detach().cpu().numpy(),
            t.grad.cpu().numpy(), r.grad.cpu().numpy(),
            what=f"training: replay {k}")
            for name, (_, r), (_, t) in zip(names, ref_leaves, leaves)])
        # per leaf, max |d| over the leaf's largest: median and worst; the
        # worst gradient's leaf with its largest |g| and its max |d|
        worst = int(diffs[:, 0].argmax())
        ref_g = ref_leaves[worst][1].grad
        rows.append({"loss_eager": want, "loss_graph": got,
                     "grad_rel_diff_median": float(np.median(diffs[:, 0])),
                     "grad_rel_diff_max": float(diffs[worst, 0]),
                     "grad_rel_diff_max_leaf": names[worst],
                     "grad_rel_diff_max_leaf_grad_max": float(
                         ref_g.abs().max()),
                     "grad_rel_diff_max_leaf_abs_diff": float(
                         (leaves[worst][1].grad - ref_g).abs().max()),
                     "leaf_rel_diff_median": float(np.median(diffs[:, 1])),
                     "leaf_rel_diff_max": float(diffs[:, 1].max())})
    torch.cuda.synchronize()
    launched = kernels.counts()
    check(not any(launched.values()) and not any(
        compiled.graph_launches.values()), f"training: the compiled step "
          f"launched {launched} ({compiled.graph_launches} a replay)")
    check(compiled.replays == TRAIN_STEPS and int(compiled.optimizer.count)
          == TRAIN_STEPS, "training: the compiled step's count is "
          f"{int(compiled.optimizer.count)} after {compiled.replays} replays")
    out["steps"] = rows
    out["capture_seconds"] = compiled.capture_seconds
    out["graph_pool_mb"] = compiled.graph_pool_bytes / 2**20
    out["reserved_gb"] = torch.cuda.memory_reserved() / 1e9

    def step_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn(*batch)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 2 * 1e3

    fns = {"eager": eager, "graph": compiled}
    samples = {m: [] for m in fns}
    for rep in range(5):
        for m in (("eager", "graph") if rep % 2 == 0 else ("graph", "eager")):
            samples[m].append(step_ms(fns[m]))
    out["ms_a_step"] = {m: statistics.median(v) for m, v in samples.items()}
    out["ms_samples"] = samples
    for m, fn in fns.items():
        prof = capture(fn, batch, iters=2)
        ops = prof.top_ops(len(prof.ops))
        out[f"trace_{m}"] = {
            "device_ms": prof.device_ms_per_iter,
            "span_ms": prof.window_ms_per_iter,
            "idle_share": prof.idle_share,
            "host_ms": prof.host_ms_per_iter,
            "host_launch_ms": prof.host_launch_ms_per_iter,
            "indexing_backward_ms": sum(
                r["ms"] for r in ops if "indexing_backward" in r["name"]),
            "indexing_backward_calls": sum(
                r["calls"] for r in ops if "indexing_backward" in r["name"]),
            "device_events": len(prof.ops) / 2}
    return out


def compute_mode():
    """The card's compute mode as nvidia-smi reads it; an exclusive mode
    lets one process at a time hold the card, so the multi phase's two
    processes cannot share it, and that fails the phase."""
    import subprocess
    out = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    mode = out.stdout.strip().splitlines()[0]
    check("exclusive" not in mode.lower(), f"multi: the card is in compute "
          f"mode {mode}; two processes cannot share it")
    return mode


def step_gate(key, new, ref_new, grad, ref_grad, lr=1e-4,
              what="multi: mp=2"):
    """One AdamW step, sharded against single-process, or a graph replay
    against an eager step: ``parallel/dryrun.py:step_gate`` (the gradient
    at 5e-3 of its largest, as the JAX package's per-leaf ``grad_gate``:
    at full width a one-ulp change of the encoder weights alone moves the
    gradients about as far as the sharded summation order does,
    ``nudge_``; the updated leaf at 1e-4 of its largest where the gradient
    is clear of its own difference, else at 2 lr + 1e-6), a failure a
    ``SmokeFailure``.  Returns (the gradient's max |d| over its largest,
    the updated leaf's max |d| over its largest)."""
    from dsvt_ai_trt_tpu_torch.parallel import dryrun
    try:
        return dryrun.step_gate(key, new, ref_new, grad, ref_grad, lr, what)
    except AssertionError as exc:
        raise SmokeFailure(str(exc)) from None


def multi_rank(rank, world, device, frames, batch, parity_raw):
    """One spawned rank of the multi phase: ``dryrun.card_modes`` with B1
    and B2's first call of each mode recorded (an eager warm run of the
    mode's engine).  Returns its results and the recorded calls (CUDA
    tensors; ``torch.save`` carries them to the parent, which holds and
    times them once the ranks have exited)."""
    from dsvt_ai_trt_tpu_torch.parallel import dryrun
    recorder = Recorder(("set_attention", "encoder_epilogue"),
                        first_only=True)
    with recorder:
        res = dryrun.card_modes(rank, world, device, frames, batch,
                                lambda mode: setattr(recorder, "frame",
                                                     mode), parity_raw)
    return res, recorder.calls


def parity_params(frames):
    """parity.py's checkpoint as one set of weights for several frames:
    ``weights.calibrated_raw`` on each frame (fp32, seed 0, the suite's
    count of boxes), keeping the one whose heatmap bias lies lowest.  The
    calibrations differ in that bias alone, shifted alike for every class,
    so on every frame at most that many cells clear the score threshold
    and the top-k waterline lies below the confident boxes.  Returns the
    nested NumPy dict (``prepare_params``)."""
    from dsvt_ai_trt_tpu_torch import weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    cfg = DEFAULT_CONFIG
    bias = "module.dense_head.heads_list.0.hm.1.bias"
    raws = [weights.calibrated_raw(cfg, pts, n, seed=0,
                                   n_boxes=min(40, cfg.top_k // 5),
                                   device="cuda")
            for pts, n in frames.values()]
    return weights.prepare_params(min(raws, key=lambda r: float(r[bias][0])),
                                  cfg)


def nudge_(params, seed=1):
    """Every encoder leaf (``blocks``) of torch params moved one ulp up or
    down at random, in place, and the derived weights refolded."""
    import torch
    from dsvt_ai_trt_tpu_torch import weights
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for path, t in weights.named_leaves(params):
            if path[0] == "blocks":
                up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
                t.copy_(torch.nextafter(t, torch.where(
                    up, torch.inf, -torch.inf).to(t.dtype)))
    weights.refold(params)


def check_multi(engine, frames):
    """The multi phase (module docstring): parallel/dryrun.py's
    ``card_modes`` in two gloo processes sharing cuda:0, held here against
    this process's single-process runs."""
    import torch
    from dsvt_ai_trt_tpu_torch import parity, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.data import synthetic_batch
    from dsvt_ai_trt_tpu_torch.model.detector import forward
    from dsvt_ai_trt_tpu_torch.parallel import dryrun
    from dsvt_ai_trt_tpu_torch.parallel.training import make_train_step
    log({"phase": "multi", "compute_mode": compute_mode()})
    cfg32 = DEFAULT_CONFIG
    cfg16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    with torch.inference_mode(False):       # the reference step's batch
        batch = synthetic_batch(np.random.default_rng(0), cfg32, 2)
    batch_np = (batch[0].cpu().numpy(), batch[1].cpu().numpy(),
                [t.cpu().numpy() for t in batch[2]])
    parity_raw = parity_params(frames)
    t0 = time.perf_counter()
    spawned = dryrun.spawn(multi_rank, 2, "cuda",
                           (frames, batch_np, parity_raw))
    seconds = time.perf_counter() - t0
    ranks = [res for res, _calls in spawned]
    names = list(frames)
    out = {"world": 2, "transport": "gloo, host copies", "seconds": seconds,
           "note": "two processes sharing one card, not a multi-GPU speed"}

    def want(frames_per_rank,
             kernels_on=(*PER_FRAME, "bev_epilogue", "voxel_segments")):
        return {k: (v * frames_per_rank if k in kernels_on else 0)
                for k, v in LAUNCHES.items()}

    # per rank: 2/8/8/1/1 a frame, eager and graph, voxel_segments 2, and
    # the laterals' bev_epilogue 3 where the BEV stack is whole; sp at fp32
    # takes B3, B4, nms_peel and voxel_segments only (B1 and B2 are the
    # bf16/mixed path's), sp at bf16 no bev_epilogue (its rows carry
    # halos); the train steps launch none
    expect = {"dp": want(1), "mp_bf16": want(3),
              "sp_fp32": want(1, ("segment_max", "voxel_segments")
                              + NMS_KERNELS),
              "sp_bf16": want(3, (*PER_FRAME, "voxel_segments")),
              "dp_train": want(0), "mp_train": want(0)}
    # segments a replay: 1 + the breaks a frame (a step) the CPU tests pin
    # (the per-frame engines replay one frame; dp's batch engine at mp = 1
    # breaks at no collective; the steps take batch 2 with remat: dp at
    # its gradients' all-reduce, mp at Megatron's every collective)
    segments = {"dp": 1 + dryrun.breaks_per_frame(cfg16, "dp"),
                "mp_bf16": 1 + dryrun.breaks_per_frame(cfg16, "mp"),
                "sp_fp32": 1 + dryrun.breaks_per_frame(cfg32, "sp"),
                "sp_bf16": 1 + dryrun.breaks_per_frame(cfg16, "sp"),
                "dp_train": 1 + dryrun.breaks_per_step(cfg32, 2, 1, 2, True,
                                                       False),
                "mp_train": 1 + dryrun.breaks_per_step(cfg32, 1, 2, 2, True,
                                                       False)}
    times = ("span_ms_per_frame", "device_busy_ms_per_frame",
             "device_idle_share", "collective_host_ms_per_frame",
             "collective_calls_per_frame", "collective_mbytes_per_frame")
    for mode, counts in expect.items():
        for r, res in enumerate(ranks):
            got = res[mode]
            check(got["launches"] == counts, f"multi {mode}: rank {r} "
                  f"launched {got['launches']}, expected {counts}")
            if "eager_launches" in got:
                check(got["eager_launches"] == counts, f"multi {mode}: rank "
                      f"{r} launched {got['eager_launches']} eagerly, "
                      f"expected {counts}")
                check(got["graph_equals_eager"], f"multi {mode}: rank {r}'s "
                      "graph Detections differ from its eager ones")
            if mode in segments:
                check(got["segments"] == segments[mode], f"multi {mode}: rank "
                      f"{r} replays {got['segments']} segments, expected "
                      f"{segments[mode]}")
        rows = {k: [res[mode].get(k) for res in ranks]
                for k in ("seconds",) + times}
        out[mode] = {"launches_per_rank": counts, **rows}
        if mode in segments:
            out[mode].update({k: [res[mode][k] for res in ranks] for k in (
                "segments", "graph_pool_mb", "capture_seconds")})
            out[mode]["ms_per_frame"] = {
                m: [res[mode]["ms_per_frame"][m]["median"] for res in ranks]
                for m in ("eager", "graph")}
            out[mode]["eager"] = {k: [res[mode]["eager"][k] for res in ranks]
                                  for k in times}
    # the ranks' losses bit-equal at every replay: dp's gradients and loss
    # go through one all-reduce; mp's ranks average the replicated leaves'
    # gradients, so their copies of those leaves stay one array
    for mode in ("dp_train", "mp_train"):
        steps = out[mode]["steps"] = [res[mode]["steps"] for res in ranks]
        check(all(len(s) == TRAIN_STEPS for s in steps)
              and all(res[mode]["replays"] == TRAIN_STEPS for res in ranks),
              f"multi {mode}: not every replay was held")
        same = [all(a[k] == b[k] for k in ("loss_eager", "loss_graph"))
                for a, b in zip(*steps)]
        check(all(same), f"multi {mode}: the ranks' losses differ at "
              f"replays {[k for k, ok in enumerate(same) if not ok]}")

    t0 = time.perf_counter()
    # dp=2: each rank's frame equals the single-process Engine's
    got = ranks[0]["dp"]
    worst = 0.0
    for i, name in enumerate(("dense_seed0", "dense_seed2")):
        ref = engine(*frames[name])
        n = int(ref.count)
        check(int(got["count"][i]) == n, f"multi dp: {int(got['count'][i])} "
              f"boxes on {name}, the Engine {n}")
        a, b = got["boxes"][i][:n], ref.boxes[:n].cpu().numpy()
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
        worst = max(worst, float(np.abs(a - b).max()) if n else 0.0)
    out["dp"]["max_abs_err_vs_engine"] = worst

    # mp=2 and sp=2 at bf16, on parity.py's checkpoint: parity.py's gate
    # against the unsharded bf16 boxes before NMS; sp=2 at fp32: equal to
    # the unsharded fp32 at 1e-4
    params = weights.from_jax_params(parity_raw, "cuda")
    min_score = cfg16.score_threshold + parity.SCORE_MARGIN
    for mode in ("mp_bf16", "sp_bf16"):
        stats = []
        for i, name in enumerate(names):
            ref = forward(params, *frames[name], cfg16, False, "cuda")
            ref = ref.boxes[:int(ref.count)].cpu().numpy()
            sh = ranks[0][mode]["before_nms"][i]
            stats.append({"frame": name, **parity.compare(
                ref, sh["boxes"][:int(sh["count"])], min_score)})
        g = parity.gate(stats)
        check(g["parity_ok"], f"multi {mode}: parity gate failed: {g}")
        out[mode]["parity"] = g
    del params
    p32 = weights.from_jax_params(weights.random_params(cfg32, 0), "cuda")
    ref = forward(p32, *frames[names[0]], cfg32, True, "cuda")
    n = int(ref.count)
    sh = ranks[0]["sp_fp32"]["with_nms"][0]
    check(int(sh["count"]) == n, f"multi sp_fp32: {int(sh['count'])} boxes, "
          f"unsharded {n}")
    a, b = sh["boxes"][:n], ref.boxes[:n].cpu().numpy()
    np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)
    out["sp_fp32"]["max_abs_err_vs_unsharded"] = float(np.abs(a - b).max())
    out["sp_fp32"]["coarse_rows_per_rank"] = [
        res["sp_fp32"]["coarse_rows"] for res in ranks]
    check([tuple(r) for r in out["sp_fp32"]["coarse_rows_per_rank"]]
          == [(0, 58), (58, 117)], "multi: the 117-row level must split "
          "58 / 59")
    del p32

    # B1 and B2 at the sharded shapes: each rank's recorded inputs, held
    # and timed here as the main path's are
    kernel_rows = []
    for mode in ("mp_bf16", "sp_bf16"):
        for r, (_res, calls) in enumerate(spawned):
            rec = types.SimpleNamespace(calls=calls)
            for name, row in (
                    ("set_attention", check_set_attention(rec, [mode])),
                    ("encoder_epilogue", check_encoder_epilogue(rec, mode))):
                kernel_rows.append({"mode": mode, "rank": r, "name": name,
                                    **row, "bound_share":
                                    row["bound_ms"] / row["device_ms"]})
    out["kernels"] = kernel_rows
    del spawned

    # mp=2 train step against the single-process step, beside two more
    # single-process steps: a repeat (the gradients' run-to-run spread:
    # cuDNN's float32 weight gradients sum with atomics) and one with every
    # encoder leaf moved one ulp at random (``nudge_``: the step's own
    # sensitivity to a change of the size another summation order makes)
    mt = ranks[0]["mp_train"]
    steps = []
    with torch.inference_mode(False):
        for nudged in (False, False, True):
            ref_p = weights.from_jax_params(weights.random_params(cfg32, 0),
                                            "cuda")
            if nudged:
                nudge_(ref_p)
            _, step = make_train_step(cfg32, ref_p)
            steps.append((float(step(*batch)), {
                weights.keystr(p): (t.detach().cpu().numpy(),
                                    t.grad.cpu().numpy())
                for p, t in weights.named_leaves(ref_p)}))
            del ref_p, step
    loss = steps[0][0]
    ref_leaves = {k: v[0] for k, v in steps[0][1].items()}
    ref_grads = {k: v[1] for k, v in steps[0][1].items()}
    again, nudged = ([float(np.abs(steps[i][1][k][1] - g).max())
                      / max(float(np.abs(g).max()), 1e-30)
                      for k, g in ref_grads.items()] for i in (1, 2))
    check(abs(mt["loss"] - loss) <= 1e-4 * abs(loss),
          f"multi mp_train: loss {mt['loss']} vs single-process {loss}")
    check(ranks[1]["mp_train"]["loss"] == mt["loss"],
          "multi mp_train: the ranks' losses differ")
    errs = [step_gate(k, mt["leaves"][k], ref_leaves[k], mt["grads"][k],
                      ref_grads[k]) for k in ref_leaves]
    out["mp_train"].update({
        "loss": mt["loss"], "single_process_loss": loss,
        "loss_rel_err": abs(mt["loss"] - loss) / abs(loss),
        "grad_rel_err": max(e[0] for e in errs),
        "grad_rel_err_median": float(np.median([e[0] for e in errs])),
        "grad_leaves_over_1e-4": sum(e[0] > 1e-4 for e in errs),
        "repeat_grad_rel_err": max(again),
        "repeat_grad_rel_err_median": float(np.median(again)),
        "repeat_grad_leaves_over_1e-4": sum(e > 1e-4 for e in again),
        "nudged_grad_rel_err": max(nudged),
        "nudged_grad_rel_err_median": float(np.median(nudged)),
        "nudged_grad_leaves_over_1e-4": sum(e > 1e-4 for e in nudged),
        "nudged_loss": steps[2][0],
        "leaves": len(errs),
        "repeat_loss": steps[1][0],
        "leaf_rel_err": max(e[1] for e in errs),
        "step_seconds": [res["mp_train"]["step_seconds"] for res in ranks]})
    out["check_seconds"] = time.perf_counter() - t0
    return out


def check_dryrun():
    """The port's dry run in a world of 4 on the card
    (``parallel/dryrun.py:dryrun``), the counterpart of
    ``__graft_entry__.dryrun_multichip`` at 4 devices: four gloo processes
    sharing cuda:0 at ``dryrun.flagship_config``.  Modes 1 (dp=2 x mp=2,
    one frame a dp rank) and 3 (mp=4, both frames) train one step through
    ``CompiledTrainStep``, captured in segments (1 + ``dryrun.
    breaks_per_step``), held against the eager step (loss 1e-5 relative,
    every leaf under ``step_gate``); mode 3's loss equals mode 1's within
    1e-3; the spatial modes equal the unsharded boxes at 1e-4.  Each gate
    raises in the ranks; here the ranks' losses must agree."""
    from dsvt_ai_trt_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    ranks = dryrun.spawn(dryrun.dryrun, 4, "cuda")
    seconds = time.perf_counter() - t0
    for key in ("loss", "loss_mp4"):
        check(all(r[key] == ranks[0][key] for r in ranks),
              f"dryrun: the ranks' {key} differ: {[r[key] for r in ranks]}")
    modes = list(ranks[0]["compiled"])
    check(modes == ["dp2_mp2", "dp1_mp4"], f"dryrun: compiled modes {modes}")
    launched = [r["compiled"][m]["launches"] for r in ranks for m in modes]
    check(not any(n for c in launched for n in c.values()),
          f"dryrun: a compiled train step launched kernels: {launched}")
    return {"world": 4, "seconds": seconds, "loss": ranks[0]["loss"],
            "loss_mp4": ranks[0]["loss_mp4"],
            "compiled": {mode: {
                **{k: [r["compiled"][mode][k] for r in ranks]
                   for k in ("segments", "graph_pool_mb", "capture_seconds",
                             "launches")},
                "steps": ranks[0]["compiled"][mode]["steps"]}
                for mode in modes},
            "note": "four processes sharing one card, not a multi-GPU speed"}


def check_mixed(frames):
    """Phase 8 (module docstring): DEFAULT_CONFIG at precision="mixed"."""
    from dsvt_ai_trt_tpu_torch import weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="mixed")
    engine = Engine(weights.random_params(cfg, 0), cfg)
    records, counts, recorder = run_main_path(engine, frames)
    # mixed runs the BEV epilogues in f32 PyTorch ops: no bev_epilogue
    want = {k: v * len(frames) for k, v in LAUNCHES.items()}
    want["bev_epilogue"] = 0
    check(counts == want, f"mixed launch counts {counts} != {want}")
    for rec in records.values():
        check(rec["finite"] and rec["shape"] == [cfg.top_k, 9],
              f"mixed: bad boxes on {rec['frame']}: {rec}")
    for name, (pts, n) in on_card(frames).items():
        prof = capture(engine, (pts, n), iters=3)        # graph replays
        stages = capture(engine.eager, (pts, n), iters=3)
        records[name].update({
            "device_ms": prof.device_ms_per_iter,
            "device_idle_share": prof.idle_share,
            "host_ms_traced": prof.host_ms_per_iter,
            "eager_device_ms": stages.device_ms_per_iter,
            "stages_device_ms": stages.stage_ms()})
    # the kernel phase's checks and timings on the inputs mixed gave them
    held = {
        "segment_max": check_segment_max(recorder, list(frames), ragged=False),
        "set_attention": check_set_attention(recorder,
                                             ["dense_seed0", "sparse_seed1"]),
        "encoder_epilogue": check_encoder_epilogue(recorder, "dense_seed0"),
        "rotated_overlap": check_rotated_overlap(recorder, list(frames)),
        "nms_peel": check_nms_peel(recorder, list(frames), cfg.top_k)}
    dtypes = {name: sorted({str(args[0].dtype)
                            for _f, args, _kw in recorder.calls[name]})
              for name in PER_FRAME}
    return {"launches": counts, "frames": records, "kernels": {
        name: {"dtypes": dtypes[name], **{k: res[k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err") if k in res}}
        for name, res in held.items()}}


def check_native(frames, tmp):
    """Phase 9 (module docstring): the port's native host library."""
    from dsvt_ai_trt_tpu_torch import weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.io import host_nms, pointcloud
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine, run_frames
    so = host_nms.library_path()
    built = not os.path.exists(so)
    t0 = time.perf_counter()
    lib = host_nms._load_native()
    out = {"library": so, "built_now": built,
           "load_seconds": time.perf_counter() - t0}
    check(lib is not None, "native: the host library did not load")
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    params = weights.random_params(cfg, 0)
    pre = Engine(params, cfg, with_nms=False).warmup()
    full = Engine(params, cfg).warmup()
    data = os.path.join(tmp, "native_frames")
    os.makedirs(data)
    paths, out["frames"] = [], {}
    thr = cfg.nms_threshold
    for i, (name, (pts, n)) in enumerate(frames.items()):
        dets = pre(pts, n)
        boxes, count = dets.boxes.cpu().numpy(), int(dets.count)
        ms, kept = {}, {}
        for route, fn, reps in zip(("native", "numpy"), (
                host_nms.nms_host, host_nms._nms_numpy), NMS_REPS):
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                kept[route] = fn(boxes, count, thr)
                times.append((time.perf_counter() - t0) * 1e3)
            ms[route] = {"median": float(np.median(times)),
                         "min": min(times), "max": max(times), "reps": reps}
        (a, ka), (b, kb) = kept["native"], kept["numpy"]
        check(ka == kb and np.array_equal(a, b),
              f"native NMS keeps {ka} boxes on {name}, NumPy {kb}")
        path = os.path.join(data, f"{i:06d}.bin")
        pts[: int(n)].tofile(path)
        paths.append(path)
        buf_c, n_c = host_nms.load_bin_native(path, cfg.max_points)
        buf_p, n_p = pointcloud.load_bin(path, cfg.max_points)
        check(int(n_c) == int(n_p) == int(n)
              and np.array_equal(buf_c, buf_p), f"native .bin loader on {name}")
        out["frames"][name] = {"boxes_in": count, "kept": ka,
                               "host_ms_native": ms["native"],
                               "host_ms_numpy": ms["numpy"]}

    # the .wts parser on a slice of the checkpoint (the VFE and block 0)
    raw = {k: v for k, v in weights.random_raw(cfg, 0).items()
           if (".vfe." in k or ".stage_0.0." in k) and ".in_proj_" not in k}
    wts = os.path.join(tmp, "slice.wts")
    weights.save_wts(raw, wts)
    blob, index = os.path.join(tmp, "slice.bin"), os.path.join(tmp, "slice.idx")
    check(host_nms.wts_to_blob_native(wts, blob, index) == len(raw),
          "native .wts parser: wrong tensor count")
    values = np.fromfile(blob, np.float32)
    reread = weights.load_wts(wts)
    with open(index) as f:
        for line in f:
            key, off, size = line.split()
            got = values[int(off): int(off) + int(size)]
            check(np.array_equal(got, reread[key].ravel())
                  and np.array_equal(got, raw[key].ravel()),
                  f"native .wts parser differs on {key}")
    out["wts_tensors"] = len(raw)

    # run_frames' host NMS goes through the library: the NumPy route fails
    numpy_route = host_nms._nms_numpy

    def refuse(*_a, **_k):
        raise SmokeFailure("run_frames(host_nms=True) took the NumPy route")
    host_nms._nms_numpy = refuse
    try:
        results = run_frames(pre, paths, None, host_nms=True)
    finally:
        host_nms._nms_numpy = numpy_route
    for res, (name, (pts, n)) in zip(results, frames.items()):
        dets = full(pts, n)
        ref = dets.boxes[: int(dets.count)].cpu().numpy()
        check(res["count"] == len(ref), f"native run_frames {name}: "
              f"{res['count']} boxes vs {len(ref)} with NMS on the card")
        np.testing.assert_allclose(res["boxes"], ref, atol=1e-4, rtol=1e-4)
    return out


def run_bench(frames, suite):
    """Phase 13: the package bench in this process on its default frames
    (the three frames, and the Waymo base frame for its Waymo pass); few
    iterations.  Its parity gates call ``parity.run_parity`` with the
    arguments of two of the suite's rows, so they are given those rows of
    this run instead of computing them again.  A parity gate that ran and
    failed exits the bench, and this script, with 1; one that could not
    run (a row the suite did not compute) fails the check below."""
    from dsvt_ai_trt_tpu_torch import bench, parity
    rows = {(row["precision_mode"], row["density"]): row
            for row in suite["gates"].values()}
    run_parity = parity.run_parity

    def suite_row(fast, density, **kwargs):
        check(set(kwargs) <= {"device"}, f"bench parity gate: {kwargs}")
        return rows[(fast, density)]
    parity.run_parity = suite_row
    try:
        res = bench.main(["--iters", "2", "--trace-iters", "4"])
    finally:
        parity.run_parity = run_parity
    for key in ("device_ms_per_frame", "stages_device_ms", "flops_g", "mfu",
                "waymo_ms", "waymo_device_ms"):
        check(res.get(key) is not None, f"bench: {key} is null")
    check(res["ok"], f"bench parity gates: {res['parity']}, "
          f"{res['parity_waymo']}")
    check(list(res)[-3:] == ["metric", "value", "unit"],
          "bench: the headline keys are not last")
    check(res["frames"] == len(frames), "bench: wrong frame count")
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    with torch.inference_mode():
        return _main(torch)


def _main(torch) -> int:
    from dsvt_ai_trt_tpu_torch import bench, kernels, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine

    t0 = t_script = time.perf_counter()
    per_kernel = kernels.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "per_kernel_seconds": per_kernel})
    card = bench.card_line()
    log({"phase": "card", "nvidia_smi": card,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    engine = Engine(weights.random_params(cfg, 0), cfg)
    frames = bench.synthetic_frames(cfg)
    records, counts, recorder = run_main_path(engine, frames)
    for rec in records.values():
        log({"phase": "frame", **rec})
        check(rec["finite"] and rec["shape"] == [cfg.top_k, 9],
              f"bad boxes on {rec['frame']}: {rec}")
    check(records["sparse_seed1"]["occupancy"][2] < cfg.max_sets,
          "the sparse frame must leave sets unused")
    want = {k: v * len(frames) for k, v in LAUNCHES.items()}
    log({"phase": "launches", "counts": counts, "expected": want})
    check(counts == want, f"launch counts {counts} != {want}")

    from dsvt_ai_trt_tpu_torch.runtime import profiler
    profiler.enable_spans()       # a second engine, its graph with marks
    traced = Engine(engine.params, cfg).warmup()
    prof = profile_frame(traced, cfg, *on_card(frames)["dense_seed0"])
    prof["clock"] = profiler.calibration()
    profiler.disable_spans()
    del traced
    log({"phase": "profile", "frame": "dense_seed0",
         "forward": "graph replay", **prof})

    results = {
        "segment_max": check_segment_max(recorder, list(frames)),
        "set_attention": check_set_attention(recorder,
                                             ["dense_seed0", "sparse_seed1"]),
        "encoder_epilogue": check_encoder_epilogue(recorder, "dense_seed0"),
        "rotated_overlap": check_rotated_overlap(recorder, list(frames)),
        "nms_peel": check_nms_peel(
            recorder, list(frames), cfg.top_k,
            prof["stages"].get("nms", {}).get("device_busy_ms")),
        "bev_epilogue": check_bev_epilogue(recorder, "dense_seed0"),
    }
    for name, res in results.items():
        # the same kernels' device ms in the profiled frame, per launch
        # there (B3: its two calls together, as in "ms" and "device_ms")
        seen = prof["kernels"][name]
        in_frame = (seen["ms"] if name in ("segment_max", "bev_epilogue")
                    else seen["ms"] / max(seen["calls"], 1))
        log({"phase": "kernel", "name": name, "kernel_ms": res["ms"],
             "frame_profile_ms": in_frame,
             "bound_share": res["bound_ms"] / res["device_ms"], **res})

    def timed(phase, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log({"phase": phase, **out, "phase_seconds": time.perf_counter() - t})
        return out

    voxelized = timed("voxelize", check_voxelize, frames)
    timed("graph", check_graph, engine, frames)
    timed("golden", check_tiny_golden)
    t = time.perf_counter()
    suite = check_parity_suite(frames)
    log({"phase": "parity_seconds", "seconds": time.perf_counter() - t})
    timed("mixed", check_mixed, frames)

    with tempfile.TemporaryDirectory() as tmp:
        timed("native", check_native, frames, tmp)
        timed("runtime", check_runtime, engine, frames, tmp)
        timed("waymo", check_waymo, tmp)
        voxel = timed("voxel", check_voxel)
        query = timed("query", check_query, frames)
        with torch.inference_mode(False):
            timed("training", check_training, frames, tmp)
    timed("multi", check_multi, engine, frames)
    timed("dryrun", check_dryrun)
    t = time.perf_counter()
    run_bench(frames, suite)        # prints its own line
    log({"phase": "bench_seconds", "seconds": time.perf_counter() - t,
         "script_seconds": time.perf_counter() - t_script})

    # the pooling kernel of the staged path, per frame of phase 11b (its
    # three launches together)
    results["stage_pool"] = voxel["stage_pool"]
    counts = {**counts, "stage_pool": voxel["launches"]["stage_pool"]}
    # and the TransFusion-L head's cross-attention, per frame of phase 11c
    results["query_attention"] = query["query_attention"]
    counts["query_attention"] = query["launches"]["query_attention"]
    # and the voxelizer's two launches at dsvt-waymo's caps (phase 5a)
    results["voxel_segments"] = voxelized["configs"]["dsvt-waymo"]
    named = (*PER_FRAME, "stage_pool", "bev_epilogue", "query_attention",
             "voxel_segments")
    sources = {name: "dsvt_ai_trt_tpu_torch/csrc/" + kernels.SPECS[name][0]
               for name in named}
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": sources[name],
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"], "device_ms": results[name]["device_ms"],
        "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"],
        "bound_by": results[name]["bound_by"],
        "library_ms": results[name]["library_ms"]} for name in named]}
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
