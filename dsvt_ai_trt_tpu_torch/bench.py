"""End-to-end benchmark of the port on one CUDA card (port of the JAX
package's bench.py).

    python -m dsvt_ai_trt_tpu_torch.bench [--data DIR]

Prints ONE JSON line whose last keys are the headline ``metric``,
``value`` (ms per frame of the stream loop) and ``unit``.
Measured after a warm pass over the .bin frames of ``--data`` (without
it, three seeded synthetic frames: ``synthetic_frames``) at
``DEFAULT_CONFIG`` (``--precision``, bf16 by default), NMS on the card.
The ``Engine`` serves each frame by replaying one CUDA graph of the whole
forward (runtime/compile.py); ``capture_seconds`` and ``graph_pool_mb``
say what its warm-up took.

  * host clock, ms per frame: ``sync`` (each frame's boxes and count read
    back before the next), ``latency`` (``run_frames``' loop, two frames in
    flight, outputs copied back without blocking), ``stream`` (all frames
    back to back, one readback at the end; the headline) and ``batch``
    (``forward_scan`` groups of 10, back to back, eager: no graph).
    ``batch`` is kept as a side key and not folded into the headline (the
    minimum of two noisy samples is biased low);
  * the card, from a ``torch.profiler`` trace of the engine on frame 0
    (``runtime/trace.capture``): device ms per frame, the device's idle
    share of the frame's span, the host ms a frame spends waiting for the
    card and in launch calls (both under the profiler, which slows the
    host), and the top device ops.  The per-stage device ms and the
    per-stage table of ms, GFLOP and MFU come from a trace of the eager
    forward (``Engine.eager``) on the same frame: the stage labels do not
    fire inside a graph replay;
  * ``flops_g`` (``runtime/profiler.count_flops`` of the eager forward on
    frame 0, the hand-written kernels by their formulas), ``mfu`` against
    the host-clock headline (stream) and ``mfu_device`` against the device
    ms, both at the card's peak for the precision (``device_peak_flops``);
  * a Waymo-density pass on ``WAYMO_CONFIG`` (random weights, seed 0):
    the frames of ``--data`` (else the seeded ``waymo_base_frame``)
    densified to 180 000 points by jittered
    replication, stream ms, device ms and stage table, and each frame's
    occupancy against the caps;
  * parity gates (the JAX bench's block): ``parity`` and ``parity_waymo``,
    each a row of ``parity.run_parity`` (the bench's precision, bf16 for an
    fp32 bench, against fp32 on the calibrated checkpoint, three frames at
    nuScenes density, the densified frame at Waymo density); its worst
    numbers and ``ok``.  A gate that cannot run records ``{"skipped":
    reason, "ok": false}``; the top-level ``ok`` holds when both gates ran
    and passed, and a gate that ran and failed makes the exit code 1.

``device`` is the card's name and power limit as ``nvidia-smi`` reads
them.  Without a card the bench exits non-zero: it measures nothing on the
CPU.  There is no ``vs_baseline`` (the reference's 0.7 s per frame was
taken on another card).  A trace that cannot be captured fails the run.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import subprocess
import time
from typing import List, Tuple

import numpy as np
import torch

WAYMO_POINTS = 180000   # Waymo-scale frame density (BASELINE config 5)
BATCH = 10              # frames per forward_scan group


def densify(frames, target: int, max_points: int, seed: int = 0):
    """Frames replicated with N(0, 0.15) jitter until each holds ``target``
    points (at most ``max_points``): the JAX bench's Waymo-density frames.
    frames: (buffer [>= n, 4], n) pairs; returns (buffer [max_points, 4],
    n) pairs."""
    rng = np.random.default_rng(seed)
    dense = []
    for buf, n in frames:
        pts = buf[: int(n)]
        reps = [pts]
        while sum(len(r) for r in reps) < target:
            reps.append(pts + rng.normal(0, 0.15, pts.shape).astype(np.float32))
        big = np.concatenate(reps)[:max_points]
        out = np.zeros((max_points, 4), np.float32)
        out[: len(big)] = big
        dense.append((out, np.int32(len(big))))
    return dense


def entry_frame(cfg, n: int, seed: int, half_extent: float = 60.0):
    """A synthetic cloud as the JAX package's __graft_entry__.entry builds
    it: x, y uniform in +-half_extent, z in [-3, 2], intensity in [0, 1]."""
    rng = np.random.default_rng(seed)
    pts = np.zeros((cfg.max_points, 4), np.float32)
    pts[:n, :2] = rng.uniform(-half_extent, half_extent, (n, 2))
    pts[:n, 2] = rng.uniform(-3, 2, n)
    pts[:n, 3] = rng.uniform(0, 1, n)
    return pts, np.int32(n)


def synthetic_frames(cfg):
    """The seeded frames used without ``--data``: 20 000 points in +-60 m
    (they fill ``DEFAULT_CONFIG``'s 10 000 pillars), a sparse 4 000-point
    frame in +-20 m (fewer live sets), and a second 20 000-point seed.  A
    smaller configuration (the tests') gets them shrunk to it: at most
    ``cfg.max_points`` points, the extents scaled by its x range against
    74.88 m (a factor of exactly 1 at ``DEFAULT_CONFIG`` and
    ``WAYMO_CONFIG``)."""
    scale = cfg.pc_range_max[0] / 74.88

    def frame(n, seed, half_extent):
        return entry_frame(cfg, min(n, cfg.max_points), seed,
                           half_extent=half_extent * scale)
    return {"dense_seed0": frame(20000, 0, 60.0),
            "sparse_seed1": frame(4000, 1, 20.0),
            "dense_seed2": frame(20000, 2, 60.0)}


def waymo_base_frame(seed: int = 0, n_in: int = 1600,
                     half_extent: float = 45.0, n_out: int = 800):
    """The base of the Waymo-density frame used without ``--data``:
    ``n_in`` points uniform in +-half_extent m, and ``n_out`` beyond the x
    range (80-95 m), which the voxelizer drops, as a real sweep's far
    points.  Densified to 180 000 points (``densify``), ``cli stats``
    counts 119 641 kept points, 11 769 pillars and 626 / 396 sets, under
    every ``WAYMO_CONFIG`` cap, where the real Waymo-density frames held
    about 118 000, 11 400 and 600 (config.py)."""
    rng = np.random.default_rng(seed)
    n = n_in + n_out
    pts = np.zeros((n, 4), np.float32)
    pts[:n_in, :2] = rng.uniform(-half_extent, half_extent, (n_in, 2))
    pts[n_in:, 0] = rng.choice([-1.0, 1.0], n_out) * rng.uniform(80, 95, n_out)
    pts[n_in:, 1] = rng.uniform(-95, 95, n_out)
    pts[:, 2] = rng.uniform(-3, 2, n)
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts, np.int32(n)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def parity_gates(precision: str, device="cuda") -> dict:
    """The bench's parity block (module docstring): {"parity": gate,
    "parity_waymo": gate, "ok": both ran and passed}."""
    from . import parity

    fast = precision if precision != "fp32" else "bf16"

    def gate(density):
        try:
            row = parity.run_parity(fast, density, device=device)
        except Exception as exc:   # recorded: a gate that cannot run
            logging.getLogger("dsvt_torch.bench").warning(
                "parity gate (%s) could not run: %s", density, exc)
            return {"skipped": f"{type(exc).__name__}: {exc}", "ok": False}
        return {"mode": fast, "approx_topk": False, **row["worst"],
                "n_confident": row["n_confident"],
                "pass_recall": row["pass_recall"], "ok": row["parity_ok"],
                "seconds": row["seconds"]}

    gates = {"parity": gate("nuscenes"), "parity_waymo": gate("waymo")}
    return {**gates, "ok": all(g["ok"] for g in gates.values())}


def gate_failed(result: dict) -> bool:
    """Whether a parity gate of a bench result ran and failed."""
    return any("skipped" not in result[k] and not result[k]["ok"]
               for k in ("parity", "parity_waymo"))


def _on_card(frames) -> List[Tuple[torch.Tensor, np.int32]]:
    return [(torch.from_numpy(p).cuda(), n) for p, n in frames]


def _read(dets):
    return dets.boxes.cpu(), dets.count.cpu()


def sync_ms(engine, frames, iters: int) -> float:
    t0 = time.perf_counter()
    for _ in range(iters):
        for pts, n in frames:
            _read(engine(pts, n))
    return (time.perf_counter() - t0) / (iters * len(frames)) * 1e3


def stream_ms(engine, frames, iters: int) -> float:
    """All frames back to back, every output read back at the end."""
    t0 = time.perf_counter()
    outs = [engine(pts, n) for _ in range(iters) for pts, n in frames]
    for d in outs:
        _read(d)
    return (time.perf_counter() - t0) / (iters * len(frames)) * 1e3


def batch_ms(engine, frames, bsz: int, reps: int) -> float:
    """``forward_scan`` over groups of ``bsz`` frames, ``reps`` groups back
    to back, read back at the end."""
    from .model.detector import forward_scan
    pool = (frames * -(-bsz // len(frames)))[:bsz]
    points = torch.stack([p for p, _ in pool])
    nums = [n for _, n in pool]

    def run():
        return forward_scan(engine.params, points, nums, engine.cfg, True,
                            device=engine.device)
    _read(run())
    t0 = time.perf_counter()
    outs = [run() for _ in range(reps)]
    for d in outs:
        _read(d)
    return (time.perf_counter() - t0) / (reps * bsz) * 1e3


def _warm(engine, frames) -> List[list]:
    """Warm the engine on every frame; returns each frame's occupancy."""
    engine.warmup()
    return [engine(pts, n).occupancy.cpu().tolist() for pts, n in frames]


def run(args) -> dict:
    from . import weights
    from .config import DEFAULT_CONFIG, WAYMO_CONFIG
    from .io.pointcloud import frame_paths, load_bin
    from .runtime.infer import Engine, cap_table, pipelined_ms
    from .runtime.profiler import device_peak_flops
    from .runtime.trace import capture

    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card; the bench measures the card "
                         "and nothing else")
    device = card_line()
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision=args.precision)
    if args.weights and os.path.exists(args.weights):
        params = weights.prepare_params(weights.load_checkpoint(args.weights),
                                        cfg)
    else:
        params = weights.random_params(cfg, seed=0)
    if args.data:
        frames = [load_bin(p, cfg.max_points) for p in frame_paths(args.data)]
        if not frames:
            raise SystemExit(f"bench: no .bin frames in {args.data}")
    else:
        frames = list(synthetic_frames(cfg).values())
    engine = Engine(params, cfg, with_nms=True)
    frames = _on_card(frames)
    occupancy = _warm(engine, frames)
    iters = args.iters

    sync = sync_ms(engine, frames, iters)
    latency = pipelined_ms(engine, frames, iters, pipeline_depth=2)
    stream = stream_ms(engine, frames, iters)
    batch = batch_ms(engine, frames, BATCH, 2 * iters)

    peak = device_peak_flops(cfg.precision)
    prof = capture(engine, frames[0], iters=args.trace_iters,
                   device=engine.device)
    stages = capture(engine.eager, frames[0], iters=args.trace_iters,
                     device=engine.device)
    total = stages.flops.total
    device_ms = prof.device_ms_per_iter

    wcfg = dataclasses.replace(WAYMO_CONFIG, precision=cfg.precision)
    wengine = Engine(weights.random_params(wcfg, seed=0), wcfg, with_nms=True)
    wbase = ([load_bin(p, wcfg.max_points) for p in frame_paths(args.data)]
             if args.data else [waymo_base_frame()])
    wframes = _on_card(densify(wbase, WAYMO_POINTS, wcfg.max_points))
    woccupancy = _warm(wengine, wframes)
    waymo = stream_ms(wengine, wframes, max(iters // 2, 2))
    wprof = capture(wengine, wframes[0], iters=max(args.trace_iters // 2, 2),
                    device=wengine.device)
    wstages = capture(wengine.eager, wframes[0],
                      iters=max(args.trace_iters // 2, 2),
                      device=wengine.device)

    gates = parity_gates(cfg.precision, engine.device)

    def mfu(ms):
        return total / (ms / 1e3) / peak if peak else None

    return {
        "precision": cfg.precision,
        "frames": len(frames),
        "occupancy": occupancy,
        "sync_ms_per_frame": sync,
        "latency_ms_per_frame": latency,
        "stream_ms_per_frame": stream,
        "batch_ms_per_frame": batch,
        "batch_size": BATCH,
        "iters": iters,
        "device_ms_per_frame": device_ms,
        "trace_frames_busy_ms": prof.window_busy_ms(),
        "device_idle_share": prof.idle_share,
        "host_wait_ms_per_frame": prof.host_wait_ms_per_iter,
        "host_launch_ms_per_frame": prof.host_launch_ms_per_iter,
        "stages_device_ms": stages.stage_ms(),
        "stage_mfu": stages.stage_table(peak),
        "top_ops_device_ms": [{"name": r["name"][:160], "ms": r["ms"],
                               "calls": r["calls"]} for r in prof.top_ops(5)],
        "flops_g": total / 1e9,
        "kernel_flops_g": {k: v / 1e9 for k, v in stages.flops.kernels.items()},
        "peak_flops": peak,
        "mfu": mfu(stream),
        "mfu_device": mfu(device_ms),
        "waymo_points": [int(n) for _, n in wframes],
        "waymo_occupancy": woccupancy,
        "waymo_caps": cap_table(wcfg)[1].tolist(),
        "waymo_ms": waymo,
        "waymo_device_ms": wprof.device_ms_per_iter,
        "waymo_device_idle_share": wprof.idle_share,
        "waymo_trace_frames_busy_ms": wprof.window_busy_ms(),
        "waymo_stages": wstages.stage_table(peak),
        "capture_seconds": engine.capture_seconds,
        "graph_pool_mb": engine.graph_pool_bytes / 2**20,
        **gates,
        "device": device,
        "metric": "ms/frame end-to-end",
        "value": stream,
        "unit": "ms",
    }


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsvt-torch-bench")
    ap.add_argument("--data", default=None,
                    help="directory of .bin frames (default: the seeded "
                         "synthetic frames, synthetic_frames)")
    ap.add_argument("--weights", default=None,
                    help=".wts/.npz/torch checkpoint (default: random, seed 0)")
    ap.add_argument("--precision", choices=["fp32", "mixed", "bf16"],
                    default="bf16")
    ap.add_argument("--iters", type=int, default=5,
                    help="passes over the frames per timing")
    ap.add_argument("--trace-iters", type=int, default=8,
                    help="frames traced by the profiler")
    return ap


def main(argv=None) -> dict:
    """Run the bench and print its line; exit 1 (after printing) when a
    parity gate ran and failed."""
    result = run(build_parser().parse_args(argv))
    print(json.dumps(result), flush=True)
    if gate_failed(result):
        raise SystemExit(1)
    return result


if __name__ == "__main__":
    main()
