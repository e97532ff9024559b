#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the four CUDA kernels from ``dsvt_ai_trt_tpu_torch/csrc`` (one
     ``nvcc`` each, all at once) and print the build seconds;
  2. print the card's name and power limit;
  3. run ``Engine`` at ``DEFAULT_CONFIG`` width with ``precision="bf16"`` and
     seeded random weights on three synthetic frames
     (``bench.synthetic_frames``: 20 000 points that fill the 800 sets, a
     sparse 4 000-point frame with fewer live sets, a second 20 000-point
     seed); print boxes, occupancy and ms per frame (CUDA events, after
     warm-up);
  4. check the launch counters rose by exactly 2 / 8 / 8 / 1 per frame
     (segment_max / set_attention / encoder_epilogue / rotated_overlap);
  5. hold each kernel against its plain PyTorch version on the inputs the
     main path gave it (B3 and B4 on all three frames, with B4's NMS kept
     set and its count of 64-slot reruns), and time kernel, plain version
     and, where one exists, the PyTorch library call computing the same
     function: by CUDA events around back-to-back calls (host dispatch
     included), and for the kernel and the library call also device-only
     (``device_ms``); for B3 and B4 also every device kernel of one wrapper
     call (``wrapper_device_ms``); B3 also on a seeded stream of 1..48-row
     segments (real clouds' pillars), B2 also at 1, 132 and 264 tiles of 64
     rows;
  6. end-to-end checks: the tiny configuration's fp32 boxes on the card
     against ``tests/goldens/tiny_seed0.json``, and box parity of the bf16
     kernel path against fp32, both on the card, on checkpoints calibrated
     on each of the three frames (``check_parity`` says what is gated);
  7. runtime: the three frames written as .bin files, ``cli build
     --engine`` then ``cli infer --engine --pipeline-depth 2``: rows equal
     the direct ``Engine`` call's at 1e-4 and the launch counts rise 2/8/8/1
     per frame (the engine's warm-up frame included); ``--host-nms`` keeps
     the same count and rows as NMS on the card, and ``--scan-batch 2``
     equals the stream;
  8. waymo: ``WAYMO_CONFIG`` at full width on a seeded frame densified to
     180 000 points (``bench.waymo_base_frame``): launch counts 2/8/8/1,
     finite boxes, occupancy under every cap; B1 and B3 held against their
     plain versions on the inputs that frame gave them, and timed with
     bounds;
  9. training (``check_training``), outside inference mode:
     ``DEFAULT_CONFIG`` at fp32 and full width on a fixed seeded batch of 2
     planted scenes (``data.synthetic_batch``): one step's loss and
     gradients with and without ``remat`` (the JAX per-leaf gate), 6
     default AdamW steps (every loss finite, the last below the first, no
     kernel launched: training runs the plain paths), ms per step by CUDA
     events and peak memory with and without ``remat``, one step traced
     (``runtime/trace.capture``: device ms, idle share, FLOPs, MFU at 67
     TFLOP/s fp32); then the trained weights, refolded, through the bf16
     ``Engine`` on the three frames (launch counts 2/8/8/1 per frame, every
     top-k box equal at 1e-4 to those of the weights exported as .wts and
     reloaded);
     ``cli train`` for 1 + 1 steps with ``--resume`` and ``--export-wts``;
     ``train_run.main`` for 3 steps with 2 eval scenes (reloaded recall
     equals trained recall);
 10. bench: ``python -m dsvt_ai_trt_tpu_torch.bench`` in this process on
     the three frames (Waymo pass on the Waymo base frame), few
     iterations; its JSON line is printed;
 11. print the card line, the ``kernels`` JSON line (second to last), and
     last the result line ``{"ok": true, "device": {...}}``.

The profile of phase 5 is ``runtime/trace.capture``'s: per stage host ms,
span and busy ms on the device timeline, per kernel device ms, and the
device's idle share of the frame's span.

Needs one CUDA card; exits non-zero without one, and without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
PER_FRAME = {"segment_max": 2, "set_attention": 8, "encoder_epilogue": 8,
             "rotated_overlap": 1}
SYMBOLS = {                        # the __global__ function of each kernel
    "segment_max": "segment_max_kernel",
    "set_attention": "set_attention_kernel",
    "encoder_epilogue": "encoder_epilogue_kernel",
    "rotated_overlap": "rotated_overlap_kernel",
}
REPLACES = {
    "segment_max": "dsvt_ai_trt_tpu/ops/segment_pallas.py:125",
    "set_attention": "dsvt_ai_trt_tpu/ops/attention_pallas.py:183",
    "encoder_epilogue": "dsvt_ai_trt_tpu/ops/encoder_pallas.py:64",
    "rotated_overlap": "dsvt_ai_trt_tpu/ops/nms_pallas.py:116",
}
PARITY_MIN_SCORE = 0.3 + 0.05     # tools/parity_check.py: threshold + margin
PARITY_MIN_COVERAGE = 0.99        # its gate with exact top-k
GOLDEN_TINY = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "goldens", "tiny_seed0.json")


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
    """Wraps the kernel wrappers the main path calls, keeping the inputs of
    each call so the kernels can be held against their plain versions on
    exactly those tensors.  The wrapped call is the original wrapper (which
    counts its own launch)."""

    def __init__(self):
        from dsvt_ai_trt_tpu_torch.ops import (attention_kernel, encoder_kernel,
                                               nms, segment)
        self.calls = {name: [] for name in PER_FRAME}
        self.frame = None
        self._patches = [
            (segment, "segmented_max", "segment_max"),
            (attention_kernel, "set_attention_fused_flat", "set_attention"),
            (encoder_kernel, "encoder_epilogue", "encoder_epilogue"),
            (nms, "pairwise_overlap", "rotated_overlap"),
        ]
        self._orig = []

    def __enter__(self):
        for mod, attr, name in self._patches:
            orig = getattr(mod, attr)
            self._orig.append((mod, attr, orig))

            def wrapped(*args, _orig=orig, _name=name, **kw):
                self.calls[_name].append((self.frame, args, kw))
                return _orig(*args, **kw)
            setattr(mod, attr, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self._orig:
            setattr(mod, attr, orig)


def run_main_path(engine, frames):
    """Warm up, then ONE counted pass over the frames with the launch
    counters set to 0 just before and read just after; then time each
    frame.  Returns (per-frame records, counts, recorder)."""
    import torch
    from dsvt_ai_trt_tpu_torch import kernels

    for pts, n in frames.values():
        engine(pts, n)
    torch.cuda.synchronize()

    recorder = Recorder()
    records = {}
    with recorder:
        kernels.reset_counts()
        for name, (pts, n) in frames.items():
            recorder.frame = name
            dets = engine(pts, n)
            records[name] = {
                "frame": name, "points": int(n), "boxes": int(dets.count),
                "occupancy": dets.occupancy.cpu().tolist(),
                "finite": bool(torch.isfinite(dets.boxes).all()),
                "shape": list(dets.boxes.shape)}
        torch.cuda.synchronize()
        counts = kernels.counts()

    for name, (pts, n) in frames.items():
        records[name]["ms"] = cuda_ms(lambda: engine(pts, n), reps=5, warmup=1)
    return records, counts, recorder


def profile_frame(engine, pts, n, iters=2):
    """Warm frames under torch.profiler, by ``runtime/trace.capture``, per
    frame: the host ms of the call (``wall_ms``), the frame's span on the
    device timeline, device busy ms (kernels, copies and memsets), the
    device's idle share of the span, the host ms spent waiting for the card
    and in launch calls, and per forward stage (model.detector.STAGES
    labels) its host ms, the span and busy ms on the device of the work it
    launched and its four costliest kernels, its GFLOP and MFU; plus each
    hand-written kernel's device ms and the top device kernels."""
    from dsvt_ai_trt_tpu_torch.runtime.profiler import device_peak_flops
    from dsvt_ai_trt_tpu_torch.runtime.trace import capture
    prof = capture(engine, (pts, n), iters=iters)
    table = prof.stage_table(device_peak_flops(engine.cfg.precision))
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


def check_parity(frames):
    """bf16 with the kernels vs fp32, both on the card, on every smoke
    frame, each with a checkpoint calibrated on that frame (this package's
    calibrated_raw at fp32: the 40th-highest heatmap cell sits at 0.38).

    Gate, the JAX package's tools/parity_check.py with exact top-k (the
    port's only top-k), on the boxes before NMS: every box of score >=
    PARITY_MIN_SCORE on either side exists among the other side's boxes
    (same class, BEV IoU >= 0.5) for >= PARITY_MIN_COVERAGE of them both
    ways, with matched scores within 0.03 and centres within 0.3 m.

    Printed, not gated: eval.parity_ok (a one-to-one match of every box,
    recall and precision >= 0.95) before and after NMS.  It misses on some
    frames here, and on seeded random weights the JAX package misses it
    between its own bf16 and fp32 paths too (``python
    tests/test_torch_parity.py`` prints both)."""
    from dsvt_ai_trt_tpu_torch import weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.eval import coverage, match_boxes
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    cfg32 = dataclasses.replace(DEFAULT_CONFIG, precision="fp32")
    cfg16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")

    def boxes(dets):
        return dets.boxes[:int(dets.count)].cpu().numpy()

    failed = []
    for name, (pts, n) in frames.items():
        raw = weights.calibrated_raw(cfg32, pts, n, seed=0, device="cuda")
        params = weights.from_jax_params(weights.prepare_params(raw, cfg32),
                                         "cuda")
        p32 = boxes(Engine(params, cfg32, with_nms=False)(pts, n))
        p16 = boxes(Engine(params, cfg16, with_nms=False)(pts, n))
        recall = coverage(p32[p32[:, 8] >= PARITY_MIN_SCORE], p16)
        precision = coverage(p16[p16[:, 8] >= PARITY_MIN_SCORE], p32)
        score_err = max(recall["max_score_err"], precision["max_score_err"])
        center_err = max(recall["max_center_err"],
                         precision["max_center_err"])
        pre = match_boxes(p16, p32)
        post = match_boxes(boxes(Engine(params, cfg16)(pts, n)),
                           boxes(Engine(params, cfg32)(pts, n)))
        ok = (recall["n"] >= 10 and precision["n"] >= 10
              and recall["coverage"] >= PARITY_MIN_COVERAGE
              and precision["coverage"] >= PARITY_MIN_COVERAGE
              and score_err <= 0.03 and center_err <= 0.3)
        log({"phase": "parity", "frame": name, "ok": ok,
             "confident_fp32": recall["n"], "confident_bf16": precision["n"],
             "recall": recall["coverage"], "precision": precision["coverage"],
             "max_score_err": score_err, "max_center_err": center_err,
             "parity_ok_before_nms": {
                 "boxes": [pre["n_pred"], pre["n_ref"]],
                 "recall": pre["recall"], "precision": pre["precision"]},
             "parity_ok_after_nms": {
                 "boxes": [post["n_pred"], post["n_ref"]],
                 "recall": post["recall"], "precision": post["precision"]}})
        if not ok:
            failed.append(name)
    check(not failed, f"bf16 vs fp32 parity failed on {failed}")


def check_runtime(engine, frames, tmp):
    """Phase 7: the CLI path on the three frames (module docstring)."""
    from dsvt_ai_trt_tpu_torch import cli, kernels
    from dsvt_ai_trt_tpu_torch.io.output import load_txt
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
    want = {k: v * (len(frames) + 1) for k, v in PER_FRAME.items()}
    check(counts == want, f"cli infer launch counts {counts} != {want} "
          f"({len(frames)} frames and the warm-up frame)")
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
    """Phase 8: WAYMO_CONFIG at full width on the densified seeded frame
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
    recorder = Recorder()
    with recorder:
        kernels.reset_counts()
        recorder.frame = "waymo"
        dets = engine(pts, n)
        torch.cuda.synchronize()
        counts = kernels.counts()
    check(counts == PER_FRAME, f"waymo launch counts {counts} != {PER_FRAME}")
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


def grad_gate(name, got, ref):
    """The JAX package's per-leaf gradient gate (tests/test_training.py):
    max |d| <= max(5e-3 * leaf max, 5e-4).  Returns |d| / the gate."""
    d = float((got.double() - ref.double()).abs().max())
    tol = max(5e-3 * float(ref.abs().max()), 5e-4)
    check(d <= tol, f"training: gradient of {name} differs by {d:.3e} with "
          f"and without remat (gate {tol:.3e})")
    return d / tol


def check_training(frames, tmp):
    """Phase 9 (module docstring): training at DEFAULT_CONFIG fp32, full
    width, batch 2."""
    import contextlib
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
        want_counts = {k: v * len(frames) for k, v in PER_FRAME.items()}
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

    # cli train: 1 step with a checkpoint, then 1 resumed step + export
    ckpt, cli_wts = os.path.join(tmp, "state.npz"), os.path.join(tmp, "cli.wts")
    lines = []
    for extra in (["--ckpt-every", "1"],
                  ["--resume", ckpt, "--export-wts", cli_wts]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(["train", "--steps", "1", "--weights", "", "--ckpt",
                      ckpt, *extra])
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

    # train_run: 3 steps, 2 held-out scenes, export, reload, re-eval
    res = train_run.main(["--steps", "3", "--eval-scenes", "2",
                          "--log-every", "1",
                          "--out", os.path.join(tmp, "train_run.json"),
                          "--wts", os.path.join(tmp, "train_run.wts")])
    check(res["wts_roundtrip"]["matches_trained"],
          f"train_run: reloaded recall {res['wts_roundtrip']['recall']} != "
          f"trained {res['eval']['recall']}")
    out["train_run"] = {k: res[k] for k in ("train_seconds", "loss_curve",
                                            "wts_roundtrip")}
    out["train_run"]["eval"] = {k: res["eval"][k] for k in
                                ("recall", "precision", "n_gt", "n_pred")}
    return out


def run_bench(frames):
    """Phase 10: the package bench in this process on its default frames
    (the three frames, and the Waymo base frame for its Waymo pass); few
    iterations."""
    from dsvt_ai_trt_tpu_torch import bench
    res = bench.main(["--iters", "2", "--trace-iters", "4"])
    for key in ("device_ms_per_frame", "stages_device_ms", "flops_g", "mfu",
                "waymo_ms", "waymo_device_ms"):
        check(res.get(key) is not None, f"bench: {key} is null")
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

    t0 = time.perf_counter()
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
    want = {k: v * len(frames) for k, v in PER_FRAME.items()}
    log({"phase": "launches", "counts": counts, "expected": want})
    check(counts == want, f"launch counts {counts} != {want}")

    prof = profile_frame(engine, *frames["dense_seed0"])
    log({"phase": "profile", "frame": "dense_seed0", **prof})

    results = {
        "segment_max": check_segment_max(recorder, list(frames)),
        "set_attention": check_set_attention(recorder,
                                             ["dense_seed0", "sparse_seed1"]),
        "encoder_epilogue": check_encoder_epilogue(recorder, "dense_seed0"),
        "rotated_overlap": check_rotated_overlap(recorder, list(frames)),
    }
    for name, res in results.items():
        # the same kernels' device ms in the profiled frame, per launch
        # there (B3: its two calls together, as in "ms" and "device_ms")
        seen = prof["kernels"][name]
        in_frame = seen["ms"] / max(seen["calls"], 1) * (
            2 if name == "segment_max" else 1)
        log({"phase": "kernel", "name": name, "kernel_ms": res["ms"],
             "frame_profile_ms": in_frame,
             "bound_share": res["bound_ms"] / res["device_ms"], **res})

    log({"phase": "golden", **check_tiny_golden()})
    check_parity(frames)

    with tempfile.TemporaryDirectory() as tmp:
        log({"phase": "runtime", **check_runtime(engine, frames, tmp)})
        log({"phase": "waymo", **check_waymo(tmp)})
        with torch.inference_mode(False):
            log({"phase": "training", **check_training(frames, tmp)})
    run_bench(frames)               # prints its own line

    sources = {name: "dsvt_ai_trt_tpu_torch/csrc/" + kernels.SPECS[name][0]
               for name in PER_FRAME}
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": sources[name],
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"], "device_ms": results[name]["device_ms"],
        "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"],
        "bound_by": results[name]["bound_by"],
        "library_ms": results[name]["library_ms"]} for name in PER_FRAME]}
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
