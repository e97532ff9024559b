"""Heading-direction diagnostics (port of the JAX package's
tools/heading_probe.py).

1. ``probe``: does the wedge-roof cue (``data._box_surface_points``)
   survive per-pillar max-z pooling at the 0.32 m pillar grid, i.e. is
   heading DIRECTION identifiable from what the VFE's segment max sees?  A
   probe that knows the box axis fits a line to (along-axis pillar
   coordinate, pillar max-z) and predicts the direction from the slope's
   sign.  High accuracy means the cue carries signal, and a failure to
   learn it is a loss or optimisation problem, not a data problem.  NumPy
   only: no device.

2. ``ab``: a tiny-configuration training A/B over the direction-loss
   weight (``parallel/training.py`` ``head_loss`` ``dir_weight``): the
   double-angle aux term has a local minimum at the pi-flipped rot vector,
   and the 1 - cos direction term turns that mode into a saddle; this
   measures whether training escapes it.

    python -m dsvt_ai_trt_tpu_torch.heading_probe probe [--boxes 300]
    python -m dsvt_ai_trt_tpu_torch.heading_probe ab [--steps 500] \\
        [--wdirs 0.0,0.5] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .config import DEFAULT_CONFIG, DSVTConfig, WindowSpec
from .data import _box_surface_points


def probe_cue(cfg: DSVTConfig, n_boxes: int = 300, pts_per_obj: int = 150,
              seed: int = 0) -> dict:
    """Linear-probe accuracy of heading DIRECTION from per-pillar max-z.

    For each planted box: sample its surface points exactly as the training
    data does, pool max-z per pillar (the z statistic the VFE's segment max
    forwards), project occupied pillar centres onto the KNOWN box axis, and
    predict direction = sign of the (along, max_z) slope.  The wedge roof
    rises toward +x of the box, so a positive slope means the heading
    points along +axis."""
    rng = np.random.default_rng(seed)
    vx, vy = cfg.voxel_size[0], cfg.voxel_size[1]
    correct = 0
    slopes = []
    pillars_per_box = []
    for _ in range(n_boxes):
        cls = int(rng.integers(0, cfg.num_classes))
        base_l = 2.6 * 1.17 ** cls
        base = np.array([base_l * 0.42, base_l, 1.35 * 1.05 ** cls])
        dims = base * rng.uniform(0.93, 1.07, 3)
        heading = float(rng.uniform(-np.pi, np.pi))
        box = np.array([0.0, 0.0, -1.0, dims[1], dims[0], dims[2],
                        heading, cls], np.float32)
        pts = _box_surface_points(rng, box, pts_per_obj)
        # pillar max-z pooling on the real grid pitch
        ix = np.floor(pts[:, 0] / vx).astype(np.int64)
        iy = np.floor(pts[:, 1] / vy).astype(np.int64)
        key = (ix - ix.min()) * 100000 + (iy - iy.min())
        order = np.argsort(key, kind="stable")
        key_s, z_s = key[order], pts[order, 2]
        heads = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        seg = np.cumsum(heads) - 1
        maxz = np.full(seg[-1] + 1, -np.inf, np.float32)
        np.maximum.at(maxz, seg, z_s)
        # occupied pillar centres, projected on the box AXIS (the mod-pi
        # knowledge the network has; the direction is the unknown)
        cx = (ix[order][heads] + 0.5) * vx
        cy = (iy[order][heads] + 0.5) * vy
        axis = heading % np.pi
        ux, uy = np.cos(axis), np.sin(axis)
        along = cx * ux + cy * uy
        slope = float(np.polyfit(along, maxz, 1)[0]) if len(along) > 2 else 0.0
        # the heading points along +axis iff cos(heading - axis) > 0
        true_sign = 1.0 if np.cos(heading - axis) > 0 else -1.0
        correct += (np.sign(slope) == true_sign)
        slopes.append(abs(slope))
        pillars_per_box.append(len(along))
    return {"n_boxes": n_boxes, "pts_per_obj": pts_per_obj,
            "accuracy": round(correct / n_boxes, 4),
            "median_abs_slope_m_per_m": round(float(np.median(slopes)), 4),
            "median_pillars_per_box": int(np.median(pillars_per_box))}


def tiny_cfg() -> DSVTConfig:
    """The test suite's tiny configuration: full structure, tiny widths."""
    return DSVTConfig(
        max_points=2048, max_kept_points=1536, max_pillars=512,
        max_points_per_pillar=8, voxel_size=(0.32, 0.32, 8.0),
        pc_range_min=(-7.68, -7.68, -5.0), pc_range_max=(7.68, 7.68, 3.0),
        grid_size=(48, 48, 1), pfn_channels=(16, 32), sparse_shape=(48, 48, 1),
        window_specs=(WindowSpec(shape=(12, 12, 1), shift=(0, 0, 0)),
                      WindowSpec(shape=(24, 24, 1), shift=(6, 6, 0))),
        max_voxels_per_window=576, max_sets=128, set_size=12, num_blocks=2,
        num_heads=4, d_model=32, ffn_dim=64, num_classes=3, top_k=64)


def run_ab(steps: int, wdirs, seed: int = 0, eval_scenes: int = 12,
           device="cuda") -> dict:
    """Train ``tiny_cfg`` from random weights (seed ``seed``) for ``steps``
    steps of 2 planted scenes at each direction weight in ``wdirs``
    (global-norm clip 10, ``optax.adamw`` with a warmup-cosine lr peaking
    at 3e-4), then evaluate planted-box recovery; returns, per weight, the
    last loss, seconds, recall and the heading-error summaries."""
    import torch

    from . import weights
    from .data import synthetic_batch
    from .ops.common import resolve_device
    from .parallel.training import make_train_step, warmup_cosine
    from .train_run import eval_recovery

    device = resolve_device(device)
    cfg = tiny_cfg()
    lr = 3e-4
    out = {}
    for w in wdirs:
        params = weights.from_jax_params(weights.random_params(cfg, seed=seed),
                                         device)
        optimizer = torch.optim.AdamW(weights.trainable(params), lr=lr,
                                      betas=(0.9, 0.999), eps=1e-8,
                                      weight_decay=1e-4)
        _, train_step = make_train_step(cfg, params, optimizer, dir_weight=w,
                                        max_grad_norm=10.0, device=device)
        sched = warmup_cosine(lr, min(50, steps // 4), steps)
        lr_sched = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda count: sched(count) / lr)
        rng = np.random.default_rng(seed + 1)
        t0 = time.perf_counter()
        loss = None
        for _ in range(steps):
            pts, ns, targets = synthetic_batch(rng, cfg, 2, device=device,
                                               n_objects=3, n_ground=500,
                                               pts_per_obj=80)
            loss = train_step(pts, ns, targets)
            lr_sched.step()
        ev = eval_recovery(params, cfg, eval_scenes, seed=4242,
                           min_score=0.2, device=device, n_objects=3,
                           n_ground=500, pts_per_obj=80)
        out[f"wdir_{w}"] = {
            "loss_last": None if loss is None else round(float(loss), 4),
            "seconds": round(time.perf_counter() - t0, 1),
            "recall": ev["recall"],
            "heading_err_deg_median": ev["heading_err_deg_median"],
            "heading_frac_lt_15deg": ev["heading_frac_lt_15deg"],
            "heading_modpi_deg_median": ev["heading_modpi_deg_median"],
            "heading_modpi_frac_lt_15deg": ev["heading_modpi_frac_lt_15deg"]}
        print(f"w_dir={w}: {json.dumps(out[f'wdir_{w}'])}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="dsvt-torch-heading-probe")
    ap.add_argument("mode", choices=["probe", "ab"])
    ap.add_argument("--boxes", type=int, default=300)
    ap.add_argument("--pts", type=int, default=150)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--wdirs", default="0.0,0.5")
    ap.add_argument("--device", default="cuda",
                    help="ab mode: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.mode == "probe":
        result = probe_cue(DEFAULT_CONFIG, args.boxes, args.pts)
    else:
        result = run_ab(args.steps, [float(w) for w in args.wdirs.split(",")],
                        device=args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
