"""Multi-process runs of the multi-device layer: the counterpart of the JAX
package's ``__graft_entry__.dryrun_multichip``.

    python -m dsvt_ai_trt_tpu_torch.parallel.dryrun --devices 4 --device cpu
    python -m dsvt_ai_trt_tpu_torch.parallel.dryrun --devices 2 --device cuda

``spawn`` starts N processes (``torch.multiprocessing``, ``spawn``, one
thread each), joins them in a gloo group (``file://`` init in a temporary
directory), runs a function of this module in each and returns every
rank's result.  The ranks may share one device: with ``cuda`` every rank
runs on ``cuda:0`` and gloo carries the collectives through host copies
(parallel/collectives.py), so the sharded path and its kernels run on one
card.  Those are two processes sharing a card, not a multi-GPU speed.  The
functions the children run live here, not in a test file, so a child
imports the port and nothing of JAX.

``dryrun`` runs the JAX dry run's five modes at its configurations (rank
0 prints one line each, and a failed gate raises):

  1. a train step at the flagship widths (d_model 192, 8 heads, 4 blocks,
     FFN 384, PFN 96/192, 10 classes, 36-slot sets) with the grid and the
     caps cut for the CPU (``flagship_config``), on a dp x mp=2 mesh (mp=1
     for an odd N), one frame per dp rank;
  3. (N a multiple of 4) mp=4 at the same global batch: the loss equals
     mode 1's within 1e-3 relative;
  2. sp=N over one dense frame at reduced caps: count and boxes equal the
     unsharded run at 1e-4;
  4. sp=N over a 52-row grid (uneven at every level for N = 3 or 4);
  5. sp=N at ``DEFAULT_CONFIG``'s 468-row grid with reduced caps.

``card_modes`` is chip_smoke.py's ``multi`` phase (world 2 on ``cuda:0``,
``DEFAULT_CONFIG`` full caps): dp=2, mp=2 at bf16, sp=2 at fp32 and bf16
and an mp=2 training step, each rank's kernel launches counted over its
run (the smoke script records B1 and B2's inputs through ``mark`` and
holds them against their plain versions).  The other functions are the
tasks the CPU tests spawn.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels, weights
from ..config import DEFAULT_CONFIG, DSVTConfig, WindowSpec
from ..model.detector import forward, forward_spatial
from . import collectives, spatial
from .collectives import init_group
from .mesh import gather_params, make_dp_engine, make_mesh, rank_params
from .training import Targets, make_train_step, random_targets


# --------------------------------------------------------------------------
# processes
# --------------------------------------------------------------------------


def _worker(rank: int, world: int, tmp: str, device: str, fn: Callable,
            args: tuple) -> None:
    torch.set_num_threads(1)
    init_group("gloo", world, rank, os.path.join(tmp, "init"))
    try:
        result = fn(rank, world, device, *args)
        torch.save(result, os.path.join(tmp, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device: str = "cpu",
          args: tuple = ()) -> list:
    """``fn(rank, world, device, *args)`` in ``world`` spawned processes of
    one gloo group; returns each rank's result, in rank order.  A child's
    exception fails the call (``torch.multiprocessing`` re-raises it)."""
    if device == "cuda":
        device = "cuda:0"
    with tempfile.TemporaryDirectory() as tmp:
        torch.multiprocessing.start_processes(
            _worker, args=(world, tmp, device, fn, args), nprocs=world,
            join=True, start_method="spawn")
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _dets(dets) -> dict:
    return {"boxes": dets.boxes.cpu().numpy(),
            "count": np.asarray(dets.count.cpu()),
            "occupancy": dets.occupancy.cpu().numpy()}


# --------------------------------------------------------------------------
# tasks of the CPU tests
# --------------------------------------------------------------------------


def run_tasks(rank, world, device, tasks) -> dict:
    """Each ``(fn, args)`` of ``tasks`` in turn, as ``fn(rank, world,
    device, *args)``; their results, and the modules of JAX or of the JAX
    package that this process has imported (there must be none)."""
    import sys
    results = [fn(rank, world, device, *args) for fn, args in tasks]
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "dsvt_ai_trt_tpu"))
    return {"results": results, "foreign_modules": foreign}


def whole_task(rank, world, device, cfg: DSVTConfig, params, points,
               nums, with_nms: bool = True) -> dict:
    """The unsharded ``forward`` of each frame in this process (the
    reference the sharded runs are held to)."""
    p = weights.from_jax_params(params, device)
    out = [_dets(forward(p, points[b], nums[b], cfg, with_nms, device))
           for b in range(len(points))]
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


def forward_task(rank, world, device, cfg: DSVTConfig, params, points, nums,
                 dp: int = 1, mp: int = 1, sp: bool = False,
                 with_nms: bool = True) -> dict:
    """Frames ``points [B]`` through a dp x mp engine (``make_dp_engine``,
    gathered), or with ``sp`` each frame through ``forward_spatial`` over
    the whole group; the stacked Detections as NumPy, and this rank's
    kernel launches."""
    kernels.reset_counts()
    if sp:
        p = weights.from_jax_params(params, device)
        out = [_dets(forward_spatial(p, points[b], nums[b], cfg, with_nms,
                                     device)) for b in range(len(points))]
        res = {k: np.stack([o[k] for o in out]) for k in out[0]}
    else:
        run = make_dp_engine(params, cfg, make_mesh(dp, mp), with_nms, device)
        res = _dets(run(points, nums, gather=True))
    res["launches"] = kernels.counts()
    return res


def train_task(rank, world, device, cfg: DSVTConfig, params, points, nums,
               targets, dp: int = 1, mp: int = 1,
               max_grad_norm: Optional[float] = None,
               remat: bool = False) -> dict:
    """One train step of the dp x mp mesh (1 x 1: no mesh, the unsharded
    step) on the global batch (NumPy targets), gradients clipped to
    ``max_grad_norm`` when given, with or without ``remat``: the loss,
    and every leaf after the step and its gradient, whole."""
    mesh = make_mesh(dp, mp) if dp * mp > 1 else None
    p = (rank_params(params, mesh, device) if mesh is not None
         else weights.from_jax_params(params, device))
    _opt, step = make_train_step(cfg, p, mesh=mesh, device=device,
                                 remat=remat, max_grad_norm=max_grad_norm)
    tg = Targets(*(torch.as_tensor(t, device=device) for t in targets))
    loss = float(step(torch.as_tensor(points, device=device),
                      torch.as_tensor(nums, device=device), tg))
    return {"loss": loss, **{
        key: {k: v.cpu().numpy()
              for k, v in gather_params(p, mesh, grads).items()}
        for key, grads in (("leaves", False), ("grads", True))}}


def megatron_mlp_task(rank, world, device, x, w1, b1, w2) -> dict:
    """A column-sharded then row-sharded MLP, relu(x @ w1 + b1) @ w2, under
    mp = world with ``copy_to_tp`` / ``reduce_from_tp``: the output and
    the whole gradients of x, w1, b1 and w2 (shards all-gathered)."""
    group = dist.group.WORLD
    cols = w1.shape[1] // world
    own = slice(rank * cols, (rank + 1) * cols)
    xt = torch.tensor(x, requires_grad=True)
    w1t = torch.tensor(w1[:, own], requires_grad=True)
    b1t = torch.tensor(b1[own], requires_grad=True)
    w2t = torch.tensor(w2[own], requires_grad=True)
    h = torch.relu(collectives.copy_to_tp(xt, group) @ w1t + b1t)
    y = collectives.reduce_from_tp(h @ w2t, group)
    (y * y).sum().backward()
    whole = [cols] * world
    return {"y": y.detach().numpy(), "dx": xt.grad.numpy(),
            "dw1": collectives.all_gather_rows(w1t.grad, whole, group,
                                               dim=1).numpy(),
            "db1": collectives.all_gather_rows(b1t.grad, whole, group).numpy(),
            "dw2": collectives.all_gather_rows(w2t.grad, whole, group).numpy()}


def conv_rows_task(rank, world, device, x, w, b, stride: int, scale: int,
                   transpose: bool) -> np.ndarray:
    """A conv of ``stride`` (``conv2d_rows``) or a deblock of kernel =
    stride (``conv_transpose_rows``) on this rank's rows of x [1, C, H, W],
    a BEV level whose rows are ``scale`` times the full map's stride
    (``bev_range``); the output all-gathered whole."""
    with spatial.spatial_sharding():
        lo, hi = spatial.bev_range(x.shape[2], scale)
        xt = torch.tensor(x[:, :, lo:hi]).contiguous(
            memory_format=torch.channels_last)
        wt, bt = torch.tensor(w), torch.tensor(b)
        if transpose:
            y = spatial.conv_transpose_rows(xt, wt, bt, stride)
        else:
            y = spatial.conv2d_rows(xt, wt, bt, stride)
        if transpose:
            rows, scale = x.shape[2] * stride, scale // stride
        else:
            rows, scale = x.shape[2] // stride, scale * stride
        return spatial.gather_rows(y, rows, scale, dim=2).numpy()


# --------------------------------------------------------------------------
# the JAX dry run's five modes
# --------------------------------------------------------------------------


def flagship_config() -> DSVTConfig:
    """``__graft_entry__.dryrun_multichip``'s configuration: the flagship
    widths, the grid and the occupancy caps cut for the CPU."""
    cfg = DSVTConfig(
        max_points=512, max_kept_points=384, max_pillars=128,
        max_points_per_pillar=8,
        pc_range_min=(-7.68, -7.68, -5.0), pc_range_max=(7.68, 7.68, 3.0),
        grid_size=(48, 48, 1), sparse_shape=(48, 48, 1),
        pfn_channels=(96, 192), d_model=192, ffn_dim=384, num_heads=8,
        num_blocks=4, max_sets=32, set_size=36, num_classes=10, top_k=16,
        window_specs=(WindowSpec((12, 12, 1), (0, 0, 0)),
                      WindowSpec((24, 24, 1), (6, 6, 0))))
    cfg.validate()
    return cfg


def _dense(rng, cfg, n, xy, z=(-3.0, 2.0), xyz_first=False):
    pts = np.zeros((cfg.max_points, 4), np.float32)
    if xyz_first:
        pts[:n, :3] = rng.uniform(-xy, xy, (n, 3)).astype(np.float32)
    else:
        pts[:n, :2] = rng.uniform(-xy, xy, (n, 2)).astype(np.float32)
    pts[:n, 2] = rng.uniform(*z, n).astype(np.float32)
    pts[:n, 3] = rng.uniform(0, 1, n).astype(np.float32)
    return pts


def _spatial_mode(rank, device, cfg, seed, pts, n) -> dict:
    """Sharded against unsharded boxes on one frame (the unsharded run on
    rank 0 only)."""
    params = weights.from_jax_params(weights.random_params(cfg, seed), device)
    got = forward_spatial(params, pts, n, cfg, True, device)
    out = {"sharded": _dets(got)}
    if rank == 0:
        out["whole"] = _dets(forward(params, pts, n, cfg, True, device))
    return out


def _same_boxes(mode: str, sharded: dict, whole: dict) -> str:
    n = int(whole["count"])
    if int(sharded["count"]) != n:
        raise AssertionError(f"{mode}: {int(sharded['count'])} boxes "
                             f"sharded, {n} unsharded")
    np.testing.assert_allclose(sharded["boxes"][:n], whole["boxes"][:n],
                               rtol=1e-4, atol=1e-4, err_msg=mode)
    d = float(np.abs(sharded["boxes"][:n] - whole["boxes"][:n]).max()) \
        if n else 0.0
    return f"boxes={n} == unsharded (max |d| {d:.2e})"


def dryrun(rank, world, device) -> dict:
    """The five modes (module docstring); rank 0 prints and checks."""
    def say(line):
        if rank == 0:
            print(f"dryrun ok: {line}", flush=True)

    cfg = flagship_config()
    mp = 2 if world % 2 == 0 else 1
    dp = world // mp
    raw = weights.random_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    batch = dp
    points = np.zeros((batch, cfg.max_points, 4), np.float32)
    points[:, :256, :3] = rng.uniform(-7, 7, (batch, 256, 3)).astype(np.float32)
    points[:, :256, 3] = rng.uniform(0, 1, (batch, 256)).astype(np.float32)
    nums = np.full((batch,), 256, np.int32)
    targets = [t.cpu().numpy() for t in random_targets(rng, cfg, batch, "cpu")]

    res = {"loss": train_task(rank, world, device, cfg, raw, points, nums,
                              targets, dp, mp)["loss"]}
    say(f"mesh dp={dp} mp={mp}, loss={res['loss']:.4f}")
    if world % 4 == 0:
        loss4 = train_task(rank, world, device, cfg, raw, points, nums,
                           targets, world // 4, 4)["loss"]
        gap = abs(loss4 - res["loss"])
        if gap >= 1e-3 * max(1.0, abs(res["loss"])):
            raise AssertionError(f"mp=4 loss {loss4} != mp=2 loss "
                                 f"{res['loss']}")
        res["loss_mp4"] = loss4
        say(f"mesh dp={world // 4} mp=4, loss={loss4:.4f} == mp=2 loss "
            f"(|d|={gap:.2e})")

    n_dense = 3500
    sp_cfg = dataclasses.replace(cfg, max_points=4096, max_kept_points=3072,
                                 max_pillars=1024, max_sets=256, top_k=64)
    dense = _dense(rng, sp_cfg, n_dense, 7.5, xyz_first=True)
    un_cfg = dataclasses.replace(
        sp_cfg, grid_size=(52, 52, 1), sparse_shape=(52, 52, 1),
        pc_range_min=(-8.32, -8.32, -5.0), pc_range_max=(8.32, 8.32, 3.0))
    dense2 = _dense(rng, un_cfg, n_dense, 8.2, xyz_first=True)
    fl_cfg = dataclasses.replace(DEFAULT_CONFIG, max_points=4096,
                                 max_kept_points=3072, max_pillars=1024,
                                 max_sets=256, top_k=64)
    dense3 = _dense(rng, fl_cfg, n_dense, 74.0)
    for tag, c, seed, pts in (
            (f"spatial sp={world} dense inference", sp_cfg, 0, dense),
            (f"spatial sp={world} over 52 uneven rows", un_cfg, 1, dense2),
            (f"spatial sp={world} at the flagship 468-row grid", fl_cfg, 2,
             dense3)):
        c.validate()
        out = _spatial_mode(rank, device, c, seed, pts, n_dense)
        if rank == 0:
            say(f"{tag}, {_same_boxes(tag, out['sharded'], out['whole'])}")
        res[tag] = out["sharded"]
    return res


# --------------------------------------------------------------------------
# the card's multi phase (chip_smoke.py)
# --------------------------------------------------------------------------


def _measured(fn, n_frames: int):
    """One counted, timed pass of ``fn()`` over ``n_frames`` frames (the
    caller warms up first): the launch counters and the collective
    statistics set to 0 just before and read just after, the CUDA-event
    span, and from a trace of the pass (``runtime/trace.parse_trace``, the
    pass as one ``frame``) the device's busy ms and idle share.  Returns
    (fn's result, launches, times per frame)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from ..runtime.trace import parse_trace
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    kernels.reset_counts()
    collectives.reset_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start.record()
        with record_function("frame"):
            out = fn()
        stop.record()
        torch.cuda.synchronize()
    counts, comm = kernels.counts(), collectives.stats()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        trace = parse_trace(path, 1)
    return out, counts, {
        "span_ms_per_frame": start.elapsed_time(stop) / n_frames,
        "device_busy_ms_per_frame": trace.device_ms_per_iter / n_frames,
        "device_idle_share": trace.idle_share,
        "collective_host_ms_per_frame": comm["seconds"] * 1e3 / n_frames,
        "collective_calls_per_frame": comm["calls"] / n_frames,
        "collective_mbytes_per_frame": comm["bytes"] / 1e6 / n_frames}


def card_modes(rank, world, device, frames: Dict[str, tuple], batch,
               mark: Optional[Callable[[str], None]] = None) -> dict:
    """chip_smoke.py's multi phase on a world of 2 sharing one card, at
    ``DEFAULT_CONFIG`` full caps and the seeded weights of its main path
    (``random_params(cfg, 0)``).  ``frames``: the three bench frames;
    ``batch``: (points, nums, targets) of the training step, NumPy;
    ``mark``, if given, is called with each mode's name as the mode
    starts.  Per mode, this rank's results for the parent to hold against
    its single-process runs."""
    mark = mark or (lambda _mode: None)
    if world != 2:
        raise ValueError("card_modes runs on a world of 2")
    names = list(frames)
    pts = np.stack([frames[k][0] for k in names])
    nums = np.asarray([frames[k][1] for k in names], np.int32)
    raw = weights.random_params(DEFAULT_CONFIG, 0)
    bf16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    fp32 = DEFAULT_CONFIG
    res = {}
    t0 = time.perf_counter()

    # dp=2: the two dense frames, one per rank, through make_dp_engine
    mark("dp")
    dense = [names.index("dense_seed0"), names.index("dense_seed2")]
    run = make_dp_engine(raw, bf16, make_mesh(2, 1), True, device)
    run(pts[dense], nums[dense])
    dets, counts, times = _measured(
        lambda: run(pts[dense], nums[dense], gather=True), 1)
    res["dp"] = {**_dets(dets), "launches": counts, "frames_per_rank": 1,
                 **times, "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()

    # mp=2, bf16: the gather route; B1 on H/2 heads, B2 on gathered heads
    mark("mp_bf16")
    mesh = make_mesh(1, 2)
    p = rank_params(raw, mesh, device)
    one = lambda b, nms: forward(p, pts[b], nums[b], bf16, nms,   # noqa: E731
                                 device, tp=mesh.mp_group)
    one(0, True)
    every = range(len(names))
    got, counts, times = _measured(
        lambda: [_dets(one(b, True)) for b in every], len(names))
    res["mp_bf16"] = {
        "launches": counts, "frames_per_rank": len(names), **times,
        "before_nms": [_dets(one(b, False)) for b in every],
        "with_nms": got, "seconds": time.perf_counter() - t0}
    del p

    # sp=2 at fp32 (B3 and B4 on the path) and at bf16 (all four)
    for tag, cfg in (("sp_fp32", fp32), ("sp_bf16", bf16)):
        mark(tag)
        t0 = time.perf_counter()
        params = weights.from_jax_params(raw, device)
        sp_one = lambda b, nms: forward_spatial(  # noqa: E731
            params, pts[b], nums[b], cfg, nms, device)
        run_frames = [0] if tag == "sp_fp32" else list(every)
        sp_one(0, True)
        got, counts, times = _measured(
            lambda: [_dets(sp_one(b, True)) for b in run_frames],
            len(run_frames))
        with spatial.spatial_sharding():
            coarse = spatial.my_rows(fp32.grid_size[1] // spatial.BEV_STRIDE)
        res[tag] = {"launches": counts, "frames_per_rank": len(run_frames),
                    "with_nms": got, "coarse_rows": coarse, **times}
        if tag == "sp_bf16":
            res[tag]["before_nms"] = [_dets(sp_one(b, False))
                                      for b in run_frames]
        res[tag]["seconds"] = time.perf_counter() - t0
        del params

    # mp=2 training step at fp32, batch 2 (Megatron route; no kernel)
    mark("mp_train")
    mesh = make_mesh(1, 2)
    with torch.inference_mode(False):
        p = rank_params(raw, mesh, device)
        _opt, step = make_train_step(fp32, p, mesh=mesh, device=device)
        b_pts, b_nums, b_tg = batch
        torch.cuda.synchronize()
        kernels.reset_counts()
        t0 = time.perf_counter()
        loss = float(step(
            torch.as_tensor(b_pts, device=device),
            torch.as_tensor(b_nums, device=device),
            Targets(*(torch.as_tensor(t, device=device) for t in b_tg))))
        seconds = time.perf_counter() - t0
        counts = kernels.counts()
        res["mp_train"] = {"loss": loss, "launches": counts,
                           "step_seconds": seconds}
        for key, grads in (("leaves", False), ("grads", True)):
            whole = gather_params(p, mesh, grads)
            res["mp_train"][key] = ({k: v.cpu().numpy()
                                     for k, v in whole.items()}
                                    if rank == 0 else None)
    return res


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4,
                    help="processes in the gloo group (default 4)")
    ap.add_argument("--device", default="cuda",
                    help="cpu, or cuda (every rank on cuda:0)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("dryrun: CUDA is not available; pass --device cpu")
    spawn(dryrun, args.devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
