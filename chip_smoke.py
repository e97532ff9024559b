#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. build the four CUDA kernels from ``dsvt_ai_trt_tpu_torch/csrc`` (one
     ``nvcc`` each, all at once) and print the build seconds;
  2. print the card's name and power limit;
  3. run ``Engine`` at ``DEFAULT_CONFIG`` width with ``precision="bf16"`` and
     seeded random weights on three synthetic frames (20 000 points that
     fill the 800 sets, a sparse 4 000-point frame with fewer live sets, a
     second 20 000-point seed); print boxes, occupancy and ms per frame
     (CUDA events, after warm-up);
  4. check the launch counters rose by exactly 2 / 8 / 8 / 1 per frame
     (segment_max / set_attention / encoder_epilogue / rotated_overlap);
  5. hold each kernel against its plain PyTorch version on the inputs the
     main path gave it, and time kernel, plain version and, where one
     exists, the PyTorch library call computing the same function;
  6. end-to-end checks: the tiny configuration's fp32 boxes on the card
     against ``tests/goldens/tiny_seed0.json``, and box parity of the bf16
     kernel path against fp32, both on the card, on checkpoints calibrated
     on each of the three frames (``check_parity`` says what is gated);
  7. print the ``kernels`` JSON line, the card line, and last the result
     line ``{"ok": true, "device": {...}}``.

Needs one CUDA card; exits non-zero without one, and without the package.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12                # dense tensor-core bf16
F32_FLOPS = 67e12                  # f32 outside the tensor cores
PER_FRAME = {"segment_max": 2, "set_attention": 8, "encoder_epilogue": 8,
             "rotated_overlap": 1}
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


def entry_frame(cfg, n, seed, half_extent=60.0):
    """A synthetic cloud as the JAX package's __graft_entry__.entry builds
    it: x, y uniform in +-half_extent, z in [-3, 2], intensity in [0, 1]."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((cfg.max_points, 4), np.float32)
    pts[:n, :2] = rng.uniform(-half_extent, half_extent, (n, 2))
    pts[:n, 2] = rng.uniform(-3, 2, n)
    pts[:n, 3] = rng.uniform(0, 1, n)
    return pts, np.int32(n)


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


def bound_ms(nbytes, ops, peak):
    """Least time for the work: the larger of bytes over the memory rate
    and operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


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


def profile_frame(engine, pts, n):
    """One warm frame under torch.profiler: host wall ms, device busy ms
    (kernels, copies and memsets on the device timeline), the device's idle
    share, and per forward stage (model.detector.STAGES labels) its host
    ms, its span on the device timeline and the device ms of the kernels
    that started inside that span; plus the top device kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from dsvt_ai_trt_tpu_torch.model.detector import STAGES
    engine(pts, n)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine(pts, n)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [e for e in on_dev if e.name in STAGES]
    kern = [e for e in on_dev if e.name not in STAGES]
    stages = {name: {"host_ms": 0.0, "device_span_ms": 0.0,
                     "device_busy_ms": 0.0, "kernels": {}} for name in STAGES}
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in STAGES:
            stages[e.name]["host_ms"] += e.time_range.elapsed_us() / 1e3
    for sp in spans:
        stages[sp.name]["device_span_ms"] += sp.time_range.elapsed_us() / 1e3
    by_name = {}
    for k in kern:
        ms = k.time_range.elapsed_us() / 1e3
        by_name.setdefault(k.name, [0.0, 0])
        by_name[k.name][0] += ms
        by_name[k.name][1] += 1
        for sp in spans:
            if sp.time_range.start <= k.time_range.start < sp.time_range.end:
                st = stages[sp.name]
                st["device_busy_ms"] += ms
                st["kernels"][k.name[:60]] = st["kernels"].get(k.name[:60],
                                                                0.0) + ms
                break
    for st in stages.values():   # keep each stage's four costliest kernels
        st["kernels"] = dict(sorted(st["kernels"].items(),
                                    key=lambda kv: -kv[1])[:4])
    busy = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall, "stages": stages,
            "top_device": [{"name": k[:90], "ms": v[0], "calls": v[1]}
                           for k, v in top]}


def first_call(recorder, kernel, frame):
    for fr, args, kw in recorder.calls[kernel]:
        if fr == frame:
            return args, kw
    raise SmokeFailure(f"no {kernel} call recorded for frame {frame}")


def check_segment_max(recorder, frame):
    """Kernel B3 vs plain on both calls of one frame: bit-exact on the
    defined rows (rows of segments no longer than the cap; start rows only
    for starts_only)."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import segment
    calls = [c for c in recorder.calls["segment_max"] if c[0] == frame]
    check(len(calls) == 2, f"segment_max: {len(calls)} calls for {frame}")
    out = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0,
           "max_abs_err": 0.0, "calls": []}
    ops_total = bytes_total = 0
    for _fr, args, kw in calls:
        feats, is_start, cap = args[:3]
        starts_only = kw.get("starts_only", args[3] if len(args) > 3 else False)
        got = segment.segmented_max_cuda(feats, is_start, cap, starts_only)
        ref = segment.segmented_max_plain(feats, is_start, cap, starts_only)
        seg = torch.cumsum(is_start.long(), 0) - 1
        seg_len = torch.bincount(seg)[seg]
        defined = seg_len <= cap
        if starts_only:
            defined &= is_start
        check(torch.equal(got[defined], ref[defined]),
              f"segment_max (starts_only={starts_only}) differs from plain")
        N, C = feats.shape
        # library yardstick: one scatter_reduce("amax") into the segment
        # table (same reduction, table output, no broadcast back)
        idx = seg[:, None].expand(-1, C).contiguous()
        table = torch.empty((N, C), dtype=feats.dtype, device=feats.device)

        def lib_call():
            table.fill_(float("-inf"))
            table.scatter_reduce_(0, idx, feats, reduce="amax")
        t_k = cuda_ms(lambda: segment.segmented_max_cuda(feats, is_start, cap,
                                                         starts_only))
        t_p = cuda_ms(lambda: segment.segmented_max_plain(feats, is_start, cap,
                                                          starts_only))
        t_l = cuda_ms(lib_call)
        nbytes = 2 * N * C * feats.element_size() + N
        ops = N * C * (1 if starts_only else 2)
        b, _by = bound_ms(nbytes, ops, F32_FLOPS)
        out["calls"].append({"N": N, "C": C, "dtype": str(feats.dtype),
                             "starts_only": bool(starts_only), "ms": t_k,
                             "plain_ms": t_p, "library_ms": t_l,
                             "bound_ms": b, "bytes": nbytes})
        out["ms"] += t_k
        out["plain_ms"] += t_p
        out["library_ms"] += t_l
        bytes_total += nbytes
        ops_total += ops
    out["bound_ms"], out["bound_by"] = bound_ms(bytes_total, ops_total,
                                                F32_FLOPS)
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
        nbytes = (n_live * K * 3 * C * 2 + S * K * 4 + S * K * C * 2)
        ops = n_live * H * 4 * K * K * D
        b, by = bound_ms(nbytes, ops, BF16_FLOPS)
        res = {"ms": t_k, "plain_ms": t_p, "library_ms": t_l, "bound_ms": b,
               "bound_by": by, "S": S, "K": K, "C": C, "H": H,
               "set_count": n_live}
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
    nbytes = P * C * (4 + 2 + 4) + (C * C + 2 * C * Fd) * 2
    ops = 2 * P * (C * C + 2 * C * Fd)
    b, by = bound_ms(nbytes, ops, BF16_FLOPS)
    return {"ms": t_k, "plain_ms": t_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "P": P, "C": C, "F": Fd,
            "max_abs_err": float((got - ref).abs().max())}


def check_rotated_overlap(recorder, frame):
    """Kernel B4 vs the plain clip on the strict upper triangle (atol and
    rtol 1e-4), and an identical NMS kept set with either overlap."""
    import torch
    from dsvt_ai_trt_tpu_torch.ops import nms as nms_ops
    from dsvt_ai_trt_tpu_torch.ops import nms_kernel as nk
    args, _kw = first_call(recorder, "rotated_overlap", frame)
    boxes = args[0]
    got = nk.pairwise_overlap_cuda(boxes)
    ref = nk.pairwise_overlap_clip(boxes)
    n = boxes.shape[0]
    iu = torch.triu_indices(n, n, 1, device=boxes.device)
    torch.testing.assert_close(got[iu[0], iu[1]], ref[iu[0], iu[1]],
                               atol=1e-4, rtol=1e-4)
    check(torch.all(torch.tril(got) == 0), "rotated_overlap: a >= b not zero")
    count = int((boxes[:, 8] > 0).sum())
    kb, kc = nms_ops.nms(boxes, count, 0.01, use_kernels=True)
    pb, pc = nms_ops.nms(boxes, count, 0.01, use_kernels=False)
    check(int(kc) == int(pc) and torch.equal(kb, pb),
          f"nms kept set differs: kernel {int(kc)} vs plain {int(pc)}")
    t_k = cuda_ms(lambda: nk.pairwise_overlap_cuda(boxes))
    t_p = cuda_ms(lambda: nk.pairwise_overlap_clip(boxes), reps=3, warmup=1)
    pairs = n * (n - 1) // 2
    # ~300 f32 operations per upper pair: 4 clip passes over <= 8 vertices
    # (two cross products, a compare, an interpolation each) + the shoelace
    nbytes = n * 9 * 4 + n * n * 4
    b, by = bound_ms(nbytes, pairs * 300, F32_FLOPS)
    return {"ms": t_k, "plain_ms": t_p, "library_ms": None, "bound_ms": b,
            "bound_by": by, "N": n, "boxes_in": count, "nms_kept": int(kc),
            "max_abs_err": float((got[iu[0], iu[1]]
                                  - ref[iu[0], iu[1]]).abs().max())}


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    with torch.inference_mode():
        return _main(torch)


def _main(torch) -> int:
    from dsvt_ai_trt_tpu_torch import kernels, weights
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine

    t0 = time.perf_counter()
    per_kernel = kernels.build_all()
    log({"phase": "build", "seconds": time.perf_counter() - t0,
         "per_kernel_seconds": per_kernel})
    card = card_line()
    log({"phase": "card", "nvidia_smi": card,
         "torch": torch.__version__, "cuda": torch.version.cuda})

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    engine = Engine(weights.random_params(cfg, 0), cfg)
    frames = {
        "dense_seed0": entry_frame(cfg, 20000, 0),
        "sparse_seed1": entry_frame(cfg, 4000, 1, half_extent=20.0),
        "dense_seed2": entry_frame(cfg, 20000, 2),
    }
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

    log({"phase": "profile", "frame": "dense_seed0",
         **profile_frame(engine, *frames["dense_seed0"])})

    results = {
        "segment_max": check_segment_max(recorder, "dense_seed0"),
        "set_attention": check_set_attention(recorder,
                                             ["dense_seed0", "sparse_seed1"]),
        "encoder_epilogue": check_encoder_epilogue(recorder, "dense_seed0"),
        "rotated_overlap": check_rotated_overlap(recorder, "dense_seed0"),
    }
    for name, res in results.items():
        log({"phase": "kernel", "name": name, "kernel_ms": res["ms"], **res})

    log({"phase": "golden", **check_tiny_golden()})
    check_parity(frames)

    sources = {name: "dsvt_ai_trt_tpu_torch/csrc/" + kernels.SPECS[name][0]
               for name in PER_FRAME}
    line = {"kernels": [{
        "name": name, "route": "cuda", "source": sources[name],
        "replaces": REPLACES[name], "launches": counts[name],
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
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
