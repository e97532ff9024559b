"""Command line driver (port of the JAX package's cli.py).

The reference exposes ``./dsvt-ai-trt -s`` (build and serialize an engine)
and ``./dsvt-ai-trt -d`` (deserialize and infer); here:

  python -m dsvt_ai_trt_tpu_torch.cli build   --engine dsvt.engine
  python -m dsvt_ai_trt_tpu_torch.cli infer   --weights dsvt.wts --data DIR --out outputs/
  python -m dsvt_ai_trt_tpu_torch.cli bench   --weights dsvt.wts --data DIR
  python -m dsvt_ai_trt_tpu_torch.cli convert --checkpoint ckpt.pth --out dsvt.npz
  python -m dsvt_ai_trt_tpu_torch.cli stats   --data DIR    (occupancy vs the caps)
  python -m dsvt_ai_trt_tpu_torch.cli eval    --pred DIR --ref DIR
  python -m dsvt_ai_trt_tpu_torch.cli train   --steps 20 --ckpt train_state.npz
                                              [--resume F] [--export-wts F]

Everything runs on the card (``--device cuda``, the default) unless
``--device cpu`` asks for the plain PyTorch versions on the CPU.  Without
``--weights`` (or when the file is missing) the weights are random from
seed 0.  ``train`` takes AdamW steps on seeded planted scenes
(``data.synthetic_batch``), checkpoints in the JAX package's train-state
format and exports the trained weights as a ``.wts``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os

import torch

from .config import DEFAULT_CONFIG, DSVTConfig


def _load_cfg(args) -> DSVTConfig:
    cfg = DEFAULT_CONFIG
    if getattr(args, "config", None):
        with open(args.config) as f:
            cfg = DSVTConfig.from_json(f.read())
    overrides = {}
    if getattr(args, "precision", None):
        overrides["precision"] = args.precision
    if getattr(args, "parity_atan", False):
        overrides["parity_atan"] = True
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    cfg.validate()
    return cfg


def _load_params(args, cfg: DSVTConfig):
    from . import weights
    if args.weights and os.path.exists(args.weights):
        return weights.prepare_params(weights.load_checkpoint(args.weights),
                                      cfg)
    logging.warning("weights %r not found: using random weights (seed 0)",
                    args.weights)
    return weights.random_params(cfg, seed=0)


def _paths(args):
    from .io.pointcloud import frame_paths
    paths = frame_paths(args.data)
    return paths[: args.frames] if args.frames else paths


def _device_name(device: str) -> str:
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(torch.device(device))
    return "cpu"


def cmd_build(args):
    from .runtime.compile import build_engine
    cfg = _load_cfg(args)
    blob = build_engine(cfg, args.engine, with_nms=not args.host_nms,
                        device=args.device)
    print(f"engine written to {args.engine} ({len(blob)} bytes)")


def _spans_on(args):
    """``--spans PATH``: the tracer on before any engine or step warms up."""
    if args.spans:
        from .runtime import profiler
        profiler.enable_spans()


def _write_spans(args):
    if args.spans:
        from .runtime import profiler
        print(f"spans -> {profiler.write_spans(args.spans)}")
        profiler.disable_spans()


def cmd_infer(args):
    from .runtime.infer import Engine, run_frames, run_frames_scan
    _spans_on(args)
    cfg = _load_cfg(args)
    params = _load_params(args, cfg)
    paths = _paths(args)
    if args.scan_batch:
        run_frames_scan(params, cfg, paths, args.out, batch=args.scan_batch,
                        host_nms=args.host_nms, device=args.device)
    else:
        engine = Engine(params, cfg, device=args.device,
                        with_nms=not args.host_nms,
                        engine_path=args.engine).warmup()
        run_frames(engine, paths, args.out, host_nms=args.host_nms,
                   pipeline_depth=args.pipeline_depth)
    _write_spans(args)


def cmd_bench(args):
    from .runtime.infer import Engine, benchmark
    cfg = _load_cfg(args)
    engine = Engine(_load_params(args, cfg), cfg, device=args.device,
                    with_nms=not args.host_nms, engine_path=args.engine)
    result = benchmark(engine, _paths(args), iters=args.iters,
                       pipeline_depth=args.pipeline_depth)
    print(json.dumps({**result, "device": _device_name(args.device)}))


def cmd_convert(args):
    from . import weights
    raw = weights.load_checkpoint(args.checkpoint)
    if args.out.endswith(".wts"):
        weights.save_wts(raw, args.out)
    else:
        weights.save_npz(raw, args.out)
    print(f"wrote {len(raw)} tensors to {args.out}")


def cmd_stats(args):
    """Occupancy against the static caps per frame, plus suggested caps:
    every set and pillar op costs time in proportion to its cap, so an
    oversized cap is waste and an undersized one drops points."""
    from .io.pointcloud import load_bin
    from .ops.common import resolve_device
    from .ops.voxelize import voxelize
    from .ops.windows import partition
    cfg = _load_cfg(args)
    device = resolve_device(args.device)
    peak = {"points": 0, "kept_points": 0, "pillars": 0, "sets": 0}
    for path in _paths(args):
        pts, n = load_bin(path, cfg.max_points)
        with torch.inference_mode():
            vox = voxelize(torch.from_numpy(pts).to(device),
                           torch.as_tensor(n).to(device), cfg)
            counts = {"points": int(n), "kept_points": int(vox.point_count),
                      "pillars": int(vox.pillar_count)}
            for i, spec in enumerate(cfg.window_specs):
                _wp, sp = partition(vox.coords, vox.pillar_valid, spec, cfg)
                counts[f"sets_{i}"] = int(sp.set_count)
                peak["sets"] = max(peak["sets"], int(sp.set_count))
        for k in ("points", "kept_points", "pillars"):
            peak[k] = max(peak[k], counts[k])
        caps = {"points": cfg.max_points, "kept_points": cfg.max_kept_points,
                "pillars": cfg.max_pillars,
                **{f"sets_{i}": cfg.max_sets_for(s)
                   for i, s in enumerate(cfg.window_specs)}}
        print(os.path.basename(path),
              json.dumps({k: f"{counts[k]}/{caps[k]}" for k in counts}))

    def rounded(v, headroom=1.3, mult=256):
        return max(mult, int(-(-v * headroom // mult)) * mult)

    suggestion = {
        "max_points": rounded(peak["points"], 1.1, 1024),
        "max_kept_points": rounded(peak["kept_points"], 1.2, 1024),
        "max_pillars": rounded(peak["pillars"]),
        "max_sets": rounded(peak["sets"]),
    }
    print("suggested_caps (peak x headroom, static-shape cost scales with "
          "caps):", json.dumps(suggestion))


def cmd_eval(args):
    """Compare two output directories box by box (order-insensitive)."""
    from .eval import match_boxes, parity_ok
    from .io.output import load_txt
    ref_files = {os.path.basename(p): p
                 for p in glob.glob(os.path.join(args.ref, "*.txt"))}
    agg = {"frames": 0, "matched": 0, "pred": 0, "ref": 0}
    all_ok = True
    for pred_path in sorted(glob.glob(os.path.join(args.pred, "*.txt"))):
        name = os.path.basename(pred_path)
        if name not in ref_files:
            continue
        _, pred = load_txt(pred_path)
        _, ref = load_txt(ref_files[name])
        # txt rows are (x, y, z, l, w, h, rt, id, score) == the box layout
        stats = match_boxes(pred, ref, iou_threshold=args.iou)
        stats["frame"] = name
        if args.gate is not None:
            stats["parity_ok"] = parity_ok(pred, ref, args.iou, args.gate,
                                           args.gate)
            all_ok = all_ok and stats["parity_ok"]
        print(json.dumps(stats))
        agg["frames"] += 1
        agg["matched"] += stats["n_match"]
        agg["pred"] += stats["n_pred"]
        agg["ref"] += stats["n_ref"]
    agg["precision"] = agg["matched"] / max(agg["pred"], 1)
    agg["recall"] = agg["matched"] / max(agg["ref"], 1)
    print(json.dumps(agg))
    if args.gate is not None and not all_ok:
        raise SystemExit(1)


def cmd_train(args):
    """Train on synthetic planted-object scenes, as the JAX ``cli train``:
    the same flags and closing JSON line, plus ``--device``.  On the card
    each step replays one CUDA graph (``CompiledTrainStep``), as the JAX
    CLI runs ``jax.jit(train_step)``; ``--resume`` loads into its state."""
    import numpy as np
    from . import weights
    from .data import synthetic_batch
    from .ops.common import resolve_device
    from .parallel.training import (CompiledTrainStep, load_train_state,
                                    save_train_state)
    _spans_on(args)
    cfg = _load_cfg(args)
    device = resolve_device(args.device)
    params = weights.from_jax_params(_load_params(args, cfg), device)
    train_step = CompiledTrainStep(cfg, params, args.batch, device=device)
    optimizer = train_step.optimizer
    step0 = 0
    if args.resume:
        resume = args.resume
        if not os.path.exists(resume) and os.path.exists(resume + ".npz"):
            resume = resume + ".npz"
        if not os.path.exists(resume):
            raise SystemExit(f"--resume {args.resume}: checkpoint not found")
        step0 = load_train_state(resume, params, optimizer)
        logging.info("resumed from %s at step %d", resume, step0)

    rng = np.random.default_rng(args.seed)
    first = last = None
    for step in range(step0, step0 + args.steps):
        pts, ns, targets = synthetic_batch(rng, cfg, args.batch, device=device)
        loss = float(train_step(pts, ns, targets))
        first = loss if first is None else first
        last = loss
        logging.info("step %d loss %.4f", step, loss)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save_train_state(args.ckpt, params, optimizer, step + 1)
    if args.ckpt:
        written = save_train_state(args.ckpt, params, optimizer,
                                   step0 + args.steps)
        print(f"checkpoint -> {written}")
    if args.export_wts:
        weights.save_wts(weights.unfold_params(params, cfg), args.export_wts)
        print(f"trained weights -> {args.export_wts}")
    _write_spans(args)
    print(json.dumps({"steps": args.steps, "loss_first": first,
                      "loss_last": last}))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="dsvt-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, data=False):
        p.add_argument("--weights", default="dsvt.wts")
        p.add_argument("--config", default=None, help="DSVTConfig json")
        p.add_argument("--precision", choices=["fp32", "mixed", "bf16"],
                       default=None)
        p.add_argument("--parity-atan", action="store_true")
        p.add_argument("--engine", default=None)
        p.add_argument("--host-nms", action="store_true",
                       help="run NMS on the host (reference deployment shape)")
        p.add_argument("--device", default="cuda",
                       help="cuda (default) or cpu (the plain versions)")
        if data:
            p.add_argument("--data", required=True,
                           help="directory of .bin frames")
            p.add_argument("--frames", type=int, default=0)

    p = sub.add_parser("build", help="build the kernels into an engine (-s)")
    common(p)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("infer", help="run frames, write result txts (-d)")
    common(p, data=True)
    p.add_argument("--out", default="outputs")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="frames in flight before each readback (0 = fully "
                        "synchronous)")
    p.add_argument("--scan-batch", type=int, default=0,
                   help="throughput mode: N frames per group, one graph "
                        "replay a group (0 = per-frame stream)")
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="trace the run's host and device spans and write "
                        "them to PATH as a Chrome trace")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("bench", help="steady-state ms/frame")
    common(p, data=True)
    p.add_argument("--iters", type=int, default=5)
    p.add_argument("--pipeline-depth", type=int, default=2)
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("convert", help="torch/.wts/.npz checkpoint -> .npz/.wts")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_convert)

    p = sub.add_parser("stats", help="per-frame occupancy vs static caps")
    common(p, data=True)
    p.set_defaults(fn=cmd_stats)

    p = sub.add_parser("train", help="train on synthetic planted scenes")
    common(p)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt", default="train_state.npz")
    p.add_argument("--ckpt-every", type=int, default=10)
    p.add_argument("--resume", default=None)
    p.add_argument("--export-wts", default=None)
    p.add_argument("--spans", default=None, metavar="PATH",
                   help="trace the steps' host and device spans and write "
                        "them to PATH as a Chrome trace")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("eval", help="order-insensitive box comparison of two "
                                    "output dirs")
    p.add_argument("--pred", required=True)
    p.add_argument("--ref", required=True)
    p.add_argument("--iou", type=float, default=0.5)
    p.add_argument("--gate", type=float, default=None, metavar="MIN",
                   help="exit 1 unless every frame reaches this recall AND "
                        "precision (a parity gate)")
    p.set_defaults(fn=cmd_eval)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
