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
     for an odd N), one frame per dp rank, through ``CompiledTrainStep``
     (the JAX dry run jits the step) held against the eager step
     (``held_steps``; on the card its graph is captured in segments, 1 +
     ``breaks_per_step`` of them);
  3. (N a multiple of 4) mp=4 at the same global batch, the same way: the
     loss equals mode 1's within 1e-3 relative;
  2. sp=N over one dense frame at reduced caps: count and boxes equal the
     unsharded run at 1e-4;
  4. sp=N over a 52-row grid (uneven at every level for N = 3 or 4);
  5. sp=N at ``DEFAULT_CONFIG``'s 468-row grid with reduced caps.

``card_modes`` is chip_smoke.py's ``multi`` phase (world 2 on ``cuda:0``,
``DEFAULT_CONFIG`` full caps): dp=2, mp=2 at bf16 and sp=2 at fp32 and
bf16, each eager and through its compiled ``Engine`` (captured in segments
where a collective lies inside), and dp=2 and mp=2 training steps compiled
(``CompiledTrainStep``) against eager, each rank's kernel launches counted
over its run (the smoke script records B1 and B2's inputs through ``mark``
and holds them against their plain versions).  The other functions are the
tasks the CPU tests spawn (``graph_task`` and ``compiled_step_task`` run
the compiled programs' eager counterparts under a ``SyncGuard`` and a
``BreakRecorder``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels, weights
from ..config import (BACKBONE2D_STAGES, DEFAULT_CONFIG, DSVTConfig,
                      WindowSpec)
from ..model.detector import forward, forward_spatial
from ..runtime.compile import Engine, SyncGuard
from . import collectives, spatial
from .collectives import init_group
from .mesh import (COL, COL_BIAS, ROW, gather_params, make_dp_engine,
                   make_mesh, rank_params)
from .training import (CompiledTrainStep, Targets, make_train_step,
                       random_targets)

TRAIN_REPLAYS = 6    # card_modes: each train mode's replays held to eager


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


def breaks_per_frame(cfg: DSVTConfig, mode: str) -> int:
    """The collectives that one frame's forward reaches on each rank, so the
    graph breaks of its segmented capture (``runtime.compile.
    capture_segments``): "dp" (mp = 1) none; "mp" the heads' all-gather of
    every encoder at bf16/mixed, two ``reduce_from_tp`` of every encoder at
    fp32; "sp" five all-gathers a block (each encoder's q/k/v table and set
    slots, the block's output), a halo exchange for each 3x3 conv of the
    BEV backbone (two a residual unit) and of the lazy head (three), and
    the head's two maps gathered whole.  tests/test_torch_mesh_graph.py
    counts them on the CPU."""
    encoders = 2 * cfg.num_blocks
    units = sum(n for n, _c, _s in BACKBONE2D_STAGES)
    return {"dp": 0,
            "mp": encoders * (1 if cfg.precision in ("bf16", "mixed") else 2),
            "sp": 5 * cfg.num_blocks + 2 * units + 3 + 2}[mode]


def breaks_per_step(cfg: DSVTConfig, dp: int, mp: int, frames: int,
                    remat: bool, clip: bool) -> int:
    """The collectives one step of ``CompiledTrainStep`` under a dp x mp
    mesh reaches on each rank, on a global batch of ``frames``: the graph
    breaks of its segmented capture.  Under mp > 1, for each of the rank's
    frames / dp frames, Megatron's route (training runs it at every
    precision): two ``reduce_from_tp`` an encoder in the forward and again
    in ``remat``'s recomputation, and five ``copy_to_tp`` an encoder in the
    backward (x_q, the position MLP's hidden h1, its w2 and b2 folded into
    the q/k columns, the FFN's input x1); with dp > 1 the one all-reduce of
    the gradients and the loss; under mp > 1 the one all-reduce that
    averages the replicated leaves' gradients, and with a clip the one of
    the sharded gradients' squares.  ``DEFAULT_CONFIG``: 72 a frame with
    ``remat``, 56 without.  tests/test_torch_mesh_graph.py and
    tests/test_torch_parallel.py count them on the CPU."""
    per_frame = 0
    if mp > 1:
        per_frame = 2 * cfg.num_blocks * (2 + 5 + (2 if remat else 0))
    return (frames // dp * per_frame + (dp > 1)
            + (mp > 1) * (1 + bool(clip)))


class BreakRecorder:
    """A ``collectives.intercepted`` hook that runs each collective now
    (``collectives.transport``), paused in ``guard`` if one is given, and
    records per break its kind with the shapes and dtypes of the static
    buffers a segmented capture would make (``collectives.outputs``) and of
    what the transport returned."""

    def __init__(self, guard=None):
        self.guard = guard
        self.breaks = []

    def __call__(self, kind, x, group):
        paused = (self.guard.exempt() if self.guard is not None
                  else contextlib.nullcontext())
        with paused:
            static = collectives.outputs(kind, x, group)
            got = collectives.transport(kind, x, group)
        parts = [got] if kind == "all_reduce" else got
        self.breaks.append({
            "kind": kind,
            "static": [(tuple(t.shape), str(t.dtype)) for t in static],
            "eager": [(tuple(t.shape), str(t.dtype)) for t in parts]})
        return got


def graph_task(rank, world, device, cfg: DSVTConfig, params, points, nums,
               mode: str) -> dict:
    """Frames through the compiled counterpart of ``mode`` over the whole
    group: "dp" ``make_dp_engine`` (dp = world, mp = 1), "mp" ``Engine(...,
    tp=)`` (dp = 1, mp = world), "sp" ``Engine(..., spatial=)``, each
    frame's run inside a ``SyncGuard`` (the kernels' plain versions and the
    transports exempt) with a ``BreakRecorder``.  On the CPU the engines
    run their eager forwards, the program a card captures.  Returns the
    Detections (dp: gathered, after the guarded share), this rank's guard
    hits and breaks, and the breaks a frame."""
    pts = torch.as_tensor(points, device=device)
    num = torch.as_tensor(nums, device=device)
    if mode == "dp":
        mesh = make_mesh(world, 1)
        run = make_dp_engine(params, cfg, mesh, True, device)
        frames = [lambda: run(pts, num)]
        share = len(points) // world
    elif mode == "mp":
        mesh = make_mesh(1, world)
        engine = Engine(rank_params(params, mesh, device), cfg, device,
                        True, tp=mesh.mp_group)
        frames = [lambda b=b: engine(pts[b], num[b])
                  for b in range(len(points))]
        share = 1
    else:
        engine = Engine(weights.from_jax_params(params, device), cfg, device,
                        True, spatial=dist.group.WORLD)
        frames = [lambda b=b: engine(pts[b], num[b])
                  for b in range(len(points))]
        share = 1
    guard, breaks, out = SyncGuard(), [], []
    for frame in frames:
        recorder = BreakRecorder(guard)
        with guard.plain_versions_exempt(), guard, \
                collectives.intercepted(recorder):
            out.append(_dets(frame()))
        breaks.append(recorder.breaks)
    if mode == "dp":
        res = _dets(run(pts, num, gather=True))
    else:
        res = {k: np.stack([o[k] for o in out]) for k in out[0]}
    return {**res, "hits": guard.hits, "breaks": breaks[0],
            "breaks_per_frame": [len(b) / share for b in breaks]}


def compiled_step_task(rank, world, device, cfg: DSVTConfig, params, points,
                       nums, targets, steps: int = 3, mp: int = 1,
                       remat: bool = False,
                       max_grad_norm: Optional[float] = None) -> dict:
    """``held_steps`` under a dp x mp mesh (dp = world / mp), ``steps``
    replays of the global batch, with or without ``remat`` and the clip,
    the first compiled step inside a ``SyncGuard`` with a
    ``BreakRecorder``.  Returns both losses a step (compiled, eager),
    whether every leaf and gradient was bit-equal at every step, the
    guard's hits, the breaks of a step, and the compiled step's leaves and
    gradients whole after its first step (``train_task``'s keys)."""
    guard = SyncGuard()
    recorder = BreakRecorder(guard)

    @contextlib.contextmanager
    def watched():
        with guard, collectives.intercepted(recorder):
            yield

    batch = (torch.as_tensor(points, device=device),
             torch.as_tensor(nums, device=device),
             Targets(*(torch.as_tensor(t, device=device) for t in targets)))
    rec, _eager, _graph = held_steps(
        cfg, params, make_mesh(world // mp, mp), batch, device, steps,
        f"rank {rank}", remat, max_grad_norm, watched())
    return {"losses": [(r["loss_graph"], r["loss_eager"])
                       for r in rec["steps"]],
            "bit_equal": all(r["bit_equal"] for r in rec["steps"]),
            "hits": guard.hits, "breaks": recorder.breaks,
            "leaves": rec["leaves"], "grads": rec["grads"]}


def replicated_moments_task(rank, world, device, cfg: DSVTConfig, params,
                            points, nums, targets) -> dict:
    """One eager step under an mp = world mesh after each rank has moved
    its copy of every replicated leaf one ulp up or down at random (seeded
    by the rank), so that the ranks' gradients of those leaves differ, as
    the card's atomics make them differ: this rank's copies of the
    replicated leaves and their AdamW moments after the step, by path."""
    mesh = make_mesh(1, world)
    p = rank_params(params, mesh, device)
    gen = torch.Generator(device=device).manual_seed(rank + 1)
    replicated = [(weights.keystr(path), t)
                  for path, t in weights.named_leaves(p)
                  if not (path[0] == "blocks"
                          and path[-1] in COL + COL_BIAS + ROW)]
    with torch.no_grad():
        for _, t in replicated:
            up = torch.rand(t.shape, generator=gen, device=t.device) < 0.5
            t.copy_(torch.nextafter(t, torch.where(
                up, torch.inf, -torch.inf).to(t.dtype)))
    weights.refold(p)
    opt, step = make_train_step(cfg, p, mesh=mesh, device=device)
    step(torch.as_tensor(points, device=device),
         torch.as_tensor(nums, device=device),
         Targets(*(torch.as_tensor(t, device=device) for t in targets)))
    return {name: {"leaf": t.detach().cpu().numpy(), **{
        key: opt.state[t][key].cpu().numpy()
        for key in ("exp_avg", "exp_avg_sq")}} for name, t in replicated}


# --------------------------------------------------------------------------
# compiled train steps held against eager ones (the dry run, the card)
# --------------------------------------------------------------------------


def step_gate(key, new, ref_new, grad, ref_grad, lr=1e-4,
              what="step") -> tuple:
    """One AdamW step against another (sharded against single-process, or
    a graph replay against an eager step), on a leaf ``key``: the
    gradient within 5e-3 of its largest or 5e-4 (at full width a one-ulp
    change of the encoder weights alone moves the gradients about as far
    as the sharded summation order does, beyond 1e-4 of their largest on
    most leaves: chip_smoke.py's ``nudge_``); the updated leaf within 1e-4
    of its largest wherever the gradient exceeds its own difference by
    1e-6 (100 AdamW eps), elsewhere, where the first step's lr * g / (|g| +
    eps), about lr * sign(g), may flip, within 2 lr + 1e-6.  Raises
    AssertionError naming ``what``; returns (the gradient's max |d| over
    its largest, the updated leaf's max |d| over its largest)."""
    gdiff = np.abs(grad - ref_grad)
    gmax = float(np.abs(ref_grad).max())
    if float(gdiff.max()) > max(5e-3 * gmax, 5e-4):
        raise AssertionError(f"{what} gradient of {key} differs by "
                             f"{float(gdiff.max()):.3e} (largest "
                             f"{gmax:.3e})")
    d = np.abs(new - ref_new)
    scale = float(np.abs(ref_new).max())
    big = np.abs(ref_grad) > gdiff + 1e-6
    if not (float(d[big].max(initial=0)) <= 1e-4 * scale
            and float(d.max(initial=0)) <= 2 * lr + 1e-6):
        raise AssertionError(f"{what} step of {key} differs by "
                             f"{float(d.max()):.3e}")
    return (float(gdiff.max()) / max(gmax, 1e-30),
            float(d[big].max(initial=0)) / max(scale, 1e-30))


def held_steps(cfg: DSVTConfig, params, mesh, batch: tuple, device,
               replays: int, what: str = "", remat: Optional[bool] = None,
               max_grad_norm: Optional[float] = None,
               watch=None) -> tuple:
    """``CompiledTrainStep`` under ``mesh`` against ``make_train_step(...,
    mesh=)``'s eager step, each on its own ``rank_params(params)``, on the
    global ``batch`` (points, nums, ``Targets``, on ``device``), with
    ``remat`` (default: on the card) and the clip as given: the compiled
    step warms up and captures with the launch counters at 0, then
    ``replays`` times the eager step and a replay from the same state
    (before every replay but the first, the eager step's leaves, moments
    and count are written into the compiled step's in place): each
    replay's loss within 1e-5 relative of the eager step's, and this
    rank's every leaf and gradient under ``step_gate``.  The first replay
    runs inside the context manager ``watch`` if one is given (the CPU
    tests' guard).  Every rank of the mesh calls it in step.  Returns (the
    record: the launches over all of it, a row per replay, replays,
    segments, pool MB and capture seconds (None on the CPU), and the
    compiled step's leaves and gradients whole after its first replay,
    keyed as ``gather_params``; the eager step and the compiled one as
    functions of no argument)."""
    p_eager = rank_params(params, mesh, device)
    p_graph = rank_params(params, mesh, device)
    kw = dict(mesh=mesh, device=device, remat=remat,
              max_grad_norm=max_grad_norm)
    opt, eager = make_train_step(cfg, p_eager, **kw)
    compiled = CompiledTrainStep(cfg, p_graph, len(batch[0]), **kw)
    ref_leaves = weights.named_leaves(p_eager)
    leaves = weights.named_leaves(p_graph)
    kernels.reset_counts()
    compiled.warmup()
    rows = []
    for k in range(replays):
        if k:                             # the eager step's state, in place
            with torch.no_grad():
                for (_, r), (_, t) in zip(ref_leaves, leaves):
                    t.copy_(r)
                    for key in ("exp_avg", "exp_avg_sq"):
                        compiled.optimizer.state[t][key].copy_(
                            opt.state[r][key])
                compiled.optimizer.count.copy_(opt.count)
            weights.refold(p_graph)
        t0 = time.perf_counter()
        want = float(eager(*batch))
        seconds = time.perf_counter() - t0
        with (watch if k == 0 and watch is not None
              else contextlib.nullcontext()):
            got = compiled(*batch)
        got = float(got)
        if k == 0:
            whole = {key: {name: t.cpu().numpy() for name, t in
                           gather_params(p_graph, mesh, grads).items()}
                     for key, grads in (("leaves", False), ("grads", True))}
        if abs(got - want) > 1e-5 * abs(want):
            raise AssertionError(f"{what}: replay {k} loss {got}, the eager "
                                 f"step's {want}")
        names = [weights.keystr(path) for path, _ in ref_leaves]
        diffs = [step_gate(name, t.detach().cpu().numpy(),
                           r.detach().cpu().numpy(), t.grad.cpu().numpy(),
                           r.grad.cpu().numpy(), what=f"{what}: replay {k}")
                 for name, (_, r), (_, t) in zip(names, ref_leaves, leaves)]
        worst = max(range(len(diffs)), key=lambda i: diffs[i][0])
        rows.append({"loss_eager": want, "loss_graph": got,
                     "bit_equal": all(
                         torch.equal(t, r) and torch.equal(t.grad, r.grad)
                         for (_, r), (_, t) in zip(ref_leaves, leaves)),
                     "eager_seconds": seconds,
                     "grad_rel_diff_max": diffs[worst][0],
                     "grad_rel_diff_max_leaf": names[worst],
                     "grad_rel_diff_median": float(np.median(
                         [d[0] for d in diffs])),
                     "leaf_rel_diff_max": max(d[1] for d in diffs)})
    pool = compiled.graph_pool_bytes
    record = {"launches": kernels.counts(), "steps": rows,
              "replays": compiled.replays, "segments": compiled.segments,
              "graph_pool_mb": None if pool is None else pool / 2**20,
              "capture_seconds": compiled.capture_seconds, **whole}
    return (record, lambda: eager(*batch), lambda: compiled(*batch))


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
    """The five modes (module docstring); rank 0 prints and checks.  The
    train steps run through ``CompiledTrainStep``, each held against its
    eager step (``held_steps``, one replay); on the card,
    where ``remat`` is on, a replay runs 1 + ``breaks_per_step``
    segments."""
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
    targets = random_targets(rng, cfg, batch, device)
    step_batch = (torch.as_tensor(points, device=device),
                  torch.as_tensor(nums, device=device), targets)

    def held(dp, mp):
        rec, _eager, _graph = held_steps(cfg, raw, make_mesh(dp, mp),
                                         step_batch, device, 1,
                                         f"dryrun dp={dp} mp={mp}")
        del rec["leaves"], rec["grads"]
        want = 1 + breaks_per_step(cfg, dp, mp, batch, remat=True,
                                   clip=False)
        if rec["segments"] not in (None, want):
            raise AssertionError(f"dryrun dp={dp} mp={mp}: {rec['segments']}"
                                 f" segments a replay, expected {want}")
        res["compiled"][f"dp{dp}_mp{mp}"] = rec
        row, = rec["steps"]
        segments = "" if rec["segments"] is None \
            else f", {rec['segments']} segments"
        return row["loss_graph"], (
            f"compiled == eager (loss |d| "
            f"{abs(row['loss_graph'] - row['loss_eager']):.1e}{segments})")

    res = {"compiled": {}}
    with torch.inference_mode(False):
        res["loss"], how = held(dp, mp)
        say(f"mesh dp={dp} mp={mp}, loss={res['loss']:.4f}, {how}")
        if world % 4 == 0:
            loss4, how = held(world // 4, 4)
            gap = abs(loss4 - res["loss"])
            if gap >= 1e-3 * max(1.0, abs(res["loss"])):
                raise AssertionError(f"mp=4 loss {loss4} != mp=2 loss "
                                     f"{res['loss']}")
            res["loss_mp4"] = loss4
            say(f"mesh dp={world // 4} mp=4, loss={loss4:.4f} == mp=2 loss "
                f"(|d|={gap:.2e}), {how}")

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


def _alternated_ms(fns: Dict[str, Callable], n_frames: int,
                   samples: int = 5) -> dict:
    """ms a frame of each of ``fns`` (one pass of ``n_frames`` frames a
    sample, host clock to a synchronise), as the median of ``samples``
    samples taken in alternating order; every rank runs the same order."""
    names = list(fns)
    ms = {m: [] for m in names}
    for rep in range(samples):
        for m in (names if rep % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns[m]()
            torch.cuda.synchronize()
            ms[m].append((time.perf_counter() - t0) * 1e3 / n_frames)
    return {m: {"median": statistics.median(v), "samples": v}
            for m, v in ms.items()}


def _same(a, b) -> bool:
    """Bit-equal Detections (or lists of them)."""
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _eager_and_graph(eager, graph, engine, n_frames: int) -> tuple:
    """A forward mode through its eager path and its graph: an eager pass
    (the first calls of the mode's kernels run on real frames), the
    graph's first call, which captures it (``Engine.warmup``), then one
    measured pass of each (``_measured``), each rank's graph Detections
    held bit-equal to its eager ones there, and ms a frame of each
    (``_alternated_ms``).  Returns the graph pass's Detections and the
    mode's record."""
    eager()
    graph()
    eager_out, eager_counts, eager_times = _measured(eager, n_frames)
    graph_out, counts, graph_times = _measured(graph, n_frames)
    return graph_out, {
        "launches": counts, "eager_launches": eager_counts,
        "frames_per_rank": n_frames,
        "graph_equals_eager": _same(graph_out, eager_out),
        "segments": engine.segments,
        "graph_pool_mb": engine.graph_pool_bytes / 2**20,
        "capture_seconds": engine.capture_seconds,
        "ms_per_frame": _alternated_ms({"eager": eager, "graph": graph},
                                       n_frames),
        "eager": eager_times, **graph_times}


def card_modes(rank, world, device, frames: Dict[str, tuple], batch,
               mark: Optional[Callable[[str], None]] = None,
               parity_raw: Optional[dict] = None) -> dict:
    """chip_smoke.py's multi phase on a world of 2 sharing one card, at
    ``DEFAULT_CONFIG`` full caps and the seeded weights of its main path
    (``random_params(cfg, 0)``).  ``frames``: the three bench frames;
    ``batch``: (points, nums, targets) of the training steps, NumPy;
    ``mark``, if given, is called with each mode's name as the mode
    starts; ``parity_raw`` (nested NumPy, default the seeded weights) are
    the weights of the two bf16 modes, whose boxes the smoke script holds
    to ``parity.py``'s gate.

    Each forward mode runs its eager path and its compiled one, an
    ``Engine`` whose graph is captured in segments where the mode has a
    collective inside (``_eager_and_graph``): dp=2 (``make_dp_engine``,
    one frame a rank, mp = 1: one graph), mp=2 at bf16 (``Engine(...,
    tp=)``), sp=2 at fp32 and bf16 (``Engine(..., spatial=)``).  dp_train
    and mp_train replay ``CompiledTrainStep`` under the dp=2 and the mp=2
    mesh (fp32, batch 2) against the eager step, from the same state each
    step (``held_steps``); mp_train's graph breaks at every collective of
    its forward, backward and recomputation, and it returns its first
    eager step's loss and its first replay's leaves and gradients whole
    (rank 0).  Per mode,
    this rank's results for the parent to hold against its single-process
    runs."""
    mark = mark or (lambda _mode: None)
    if world != 2:
        raise ValueError("card_modes runs on a world of 2")
    names = list(frames)
    pts = torch.as_tensor(np.stack([frames[k][0] for k in names]),
                          device=device)
    nums = torch.as_tensor([frames[k][1] for k in names], dtype=torch.int32,
                           device=device)
    raw = weights.random_params(DEFAULT_CONFIG, 0)
    raw16 = raw if parity_raw is None else parity_raw
    bf16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    fp32 = DEFAULT_CONFIG
    every = range(len(names))
    dp_mesh, mp_mesh = make_mesh(2, 1), make_mesh(1, 2)
    res = {}

    # dp=2: the two dense frames, one a rank, through make_dp_engine
    mark("dp")
    t0 = time.perf_counter()
    dense = [names.index("dense_seed0"), names.index("dense_seed2")]
    run = make_dp_engine(raw, bf16, dp_mesh, True, device)
    mine = [dense[rank]]
    eager = lambda: run.engines[1].eager(pts[mine], nums[mine])  # noqa: E731
    graph = lambda: run(pts[dense], nums[dense])                 # noqa: E731
    run(pts[dense], nums[dense])                  # makes the engine
    _out, res["dp"] = _eager_and_graph(eager, graph, run.engines[1], 1)
    res["dp"].update(_dets(run(pts[dense], nums[dense], gather=True)))
    res["dp"]["seconds"] = time.perf_counter() - t0
    del run, eager, graph

    # mp=2, bf16: the gather route; B1 on H/2 heads, B2 on gathered heads
    mark("mp_bf16")
    t0 = time.perf_counter()
    engine = Engine(rank_params(raw16, mp_mesh, device), bf16, device, True,
                    tp=mp_mesh.mp_group)
    got, res["mp_bf16"] = _eager_and_graph(
        lambda: [engine.eager(pts[b], nums[b]) for b in every],
        lambda: [engine(pts[b], nums[b]) for b in every], engine, len(names))
    res["mp_bf16"].update(
        with_nms=[_dets(d) for d in got],
        before_nms=[_dets(forward(engine.params, pts[b], nums[b], bf16,
                                  False, device, tp=mp_mesh.mp_group))
                    for b in every],
        seconds=time.perf_counter() - t0)
    del engine

    # sp=2 at fp32 (B3 and B4 on the path) and at bf16 (all four)
    for tag, cfg in (("sp_fp32", fp32), ("sp_bf16", bf16)):
        mark(tag)
        t0 = time.perf_counter()
        engine = Engine(weights.from_jax_params(
            raw16 if tag == "sp_bf16" else raw, device), cfg, device, True,
            spatial=dist.group.WORLD)
        run_frames = [0] if tag == "sp_fp32" else list(every)
        got, res[tag] = _eager_and_graph(
            lambda: [engine.eager(pts[b], nums[b]) for b in run_frames],
            lambda: [engine(pts[b], nums[b]) for b in run_frames], engine,
            len(run_frames))
        with spatial.spatial_sharding():
            coarse = spatial.my_rows(fp32.grid_size[1] // spatial.BEV_STRIDE)
        res[tag].update(with_nms=[_dets(d) for d in got],
                        coarse_rows=coarse)
        if tag == "sp_bf16":
            res[tag]["before_nms"] = [_dets(forward_spatial(
                engine.params, pts[b], nums[b], cfg, False, device))
                for b in run_frames]
        res[tag]["seconds"] = time.perf_counter() - t0
        del engine

    b_pts, b_nums, b_tg = (torch.as_tensor(batch[0], device=device),
                           torch.as_tensor(batch[1], device=device),
                           Targets(*(torch.as_tensor(t, device=device)
                                     for t in batch[2])))
    step_args = (b_pts, b_nums, b_tg)
    with torch.inference_mode(False):
        # the training steps at fp32, batch 2: replays of CompiledTrainStep
        # against eager steps from the same state (``held_steps``); dp=2
        # one frame a rank, mp=2 both frames a rank (Megatron's route: the
        # collectives inside the backward and its recomputation break the
        # graph), whose first replay's leaves go whole to the parent
        for mode, mesh in (("dp_train", dp_mesh), ("mp_train", mp_mesh)):
            mark(mode)
            t0 = time.perf_counter()
            record, eager_fn, graph_fn = held_steps(
                fp32, raw, mesh, step_args, device, TRAIN_REPLAYS,
                f"multi {mode} rank {rank}")
            whole = {key: record.pop(key) for key in ("leaves", "grads")}
            if mesh.mp == 1 or rank:
                whole = {}
            _o, _c, eager_times = _measured(eager_fn, 1)
            _o, _c, graph_times = _measured(graph_fn, 1)
            res[mode] = {**record, **whole,
                         "ms_per_frame": _alternated_ms({"eager": eager_fn,
                                                         "graph": graph_fn},
                                                        1),
                         "eager": eager_times, **graph_times,
                         "seconds": time.perf_counter() - t0}
            if mesh.mp > 1:
                res[mode].update(
                    loss=record["steps"][0]["loss_eager"],
                    step_seconds=record["steps"][0]["eager_seconds"])
            del eager_fn, graph_fn
            torch.cuda.empty_cache()
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
