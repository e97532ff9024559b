"""Cross-precision box parity: the port's bf16 and mixed paths against its
own fp32 path (port of the JAX package's tools/parity_check.py
``run_parity`` and ``boxes_for``, and of tools/parity_suite.py's matrix).

    python -m dsvt_ai_trt_tpu_torch.parity [--out parity.json] [--frames 3]
    python -m dsvt_ai_trt_tpu_torch.parity --device cpu --config tiny.json

The matrix is {bf16, mixed} x {nuScenes: ``DEFAULT_CONFIG`` on
``bench.synthetic_frames``; Waymo density: ``WAYMO_CONFIG`` on
``bench.waymo_base_frame`` densified to 180 000 points}.  With
``--config`` the two precisions run on that configuration and its
``synthetic_frames`` only.  The port has exact top-k only
(``ops/postprocess.py``), so each row is gated at the JAX tool's
single-call bound for exact top-k.

Checkpoint: ``weights.calibrated_raw`` (seed 0, 40 boxes; a fifth of
``top_k`` at a configuration whose top-k is under 200) at fp32 on each
frame: only a few times that many heatmap cells clear the score
threshold, so the top-k waterline never truncates and every confident box
sits far from it.  The same weights run both precisions.  (The JAX tool
calibrates once, on the first of its real frames, which share a density;
weights calibrated on a dense synthetic frame put every one of the sparse
frame's 500 top-k cells above the threshold, where membership churns at
the waterline: 0.954 on the H100.)

Gate, on the boxes before NMS (the reference engine's output binding is
the filtered box set, filterBoxByScore.cu:266-309; which member of a
cluster survives greedy NMS at IoU 0.01 flips with any change of score
order, which is order noise, not numeric drift): every box of score >=
0.3 + 0.05 on either side exists among the other side's boxes (same
class, BEV IoU >= 0.5, ``eval.coverage``) for >= 0.99 of them both ways,
with matched scores within 0.03 and centres within 0.3 m.  Beyond the JAX
tool, each side must hold at least 10 such boxes over the row's frames, so
that no row passes empty.

Writes one JSON file (rows under ``gates``: the worst recall, precision,
score and centre error over the frames, each frame's numbers,
``pass_recall``, ``parity_ok`` and seconds; plus ``device`` and
``nvidia_smi``, the card's name and power limit) and exits 1 when a row
fails.  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from . import bench, weights
from .config import DEFAULT_CONFIG, WAYMO_CONFIG, DSVTConfig
from .eval import coverage
from .model.detector import forward
from .ops.common import resolve_device

SCORE_MARGIN = 0.05       # confident = score threshold + this margin
PASS_RECALL = 0.99        # the exact-top-k single-call bound
MAX_SCORE_ERR = 0.03
MAX_CENTER_ERR = 0.3      # metres
MIN_CONFIDENT = 10        # confident boxes per side over a row's frames
MATRIX = (("bf16_nuscenes", "bf16", "nuscenes"),
          ("mixed_nuscenes", "mixed", "nuscenes"),
          ("bf16_waymo", "bf16", "waymo"),
          ("mixed_waymo", "mixed", "waymo"))


def boxes_for(params, cfg: DSVTConfig, pts, n, device) -> np.ndarray:
    """The boxes before NMS (module docstring)."""
    dets = forward(params, pts, n, cfg, with_nms=False, device=device)
    return dets.boxes[: int(dets.count)].cpu().numpy()


def frames_for(cfg: DSVTConfig, density: str) -> Dict[str, tuple]:
    """The seeded frames of a row: (points [max_points, 4], count) by name."""
    if density == "waymo":
        (pts, n), = bench.densify([bench.waymo_base_frame()],
                                  bench.WAYMO_POINTS, cfg.max_points)
        return {"waymo_dense": (pts, n)}
    return bench.synthetic_frames(cfg)


def run_parity(fast: str = "bf16", density: str = "nuscenes",
               n_frames: int = 3, cfg: Optional[DSVTConfig] = None,
               device="cuda", verbose: bool = False) -> dict:
    """One row of the matrix: ``fast`` precision against fp32 on
    ``cfg`` (default: ``DEFAULT_CONFIG``, or ``WAYMO_CONFIG`` for the
    Waymo density); returns the JSON-ready row (module docstring)."""
    device = resolve_device(device)
    base = cfg or (WAYMO_CONFIG if density == "waymo" else DEFAULT_CONFIG)
    cfg32 = dataclasses.replace(base, precision="fp32")
    cfg_fast = dataclasses.replace(base, precision=fast)
    frames = list(frames_for(cfg32, density).items())[:n_frames]
    t0 = time.perf_counter()
    min_score = cfg32.score_threshold + SCORE_MARGIN
    frame_stats = []
    for name, (pts, n) in frames:
        raw = weights.calibrated_raw(cfg32, pts, n, seed=0,
                                     n_boxes=min(40, cfg32.top_k // 5),
                                     device=device)
        params = weights.from_jax_params(weights.prepare_params(raw, cfg32),
                                         device)
        stats = {"frame": name, "points": int(n),
                 **compare(boxes_for(params, cfg32, pts, n, device),
                           boxes_for(params, cfg_fast, pts, n, device),
                           min_score)}
        if verbose:
            print(json.dumps(stats), flush=True)
        frame_stats.append(stats)
    return {"precision_mode": fast, "density": density, "ckpt": "calibrated",
            "approx_topk": False, "frames": frame_stats,
            **gate(frame_stats), "pass_recall": PASS_RECALL,
            "seconds": time.perf_counter() - t0}


def compare(ref_all: np.ndarray, got_all: np.ndarray,
            min_score: float) -> dict:
    """One frame's boxes before NMS, reference against fast: the coverage
    of each side's confident boxes (score >= ``min_score``) among all of
    the other side's (module docstring), and the worst matched score and
    centre errors."""
    ref_conf = ref_all[ref_all[:, 8] >= min_score]
    got_conf = got_all[got_all[:, 8] >= min_score]
    # asymmetric coverage: each confident box on one side must exist on
    # the other at all (score >= the threshold); filtering both sides at
    # the margin would make churn at the margin a miss
    r = coverage(ref_conf, got_all, iou_threshold=0.5)
    p = coverage(got_conf, ref_all, iou_threshold=0.5)
    return {"n_conf_ref": len(ref_conf), "n_conf_fast": len(got_conf),
            "recall": r["coverage"], "precision": p["coverage"],
            "max_score_err": max(r["max_score_err"], p["max_score_err"]),
            "max_center_err": max(r["max_center_err"], p["max_center_err"])}


def gate(frame_stats: list) -> dict:
    """The gate over a row's frames (``compare``'s results): the worst
    recall, precision and errors, the confident boxes of each side, and
    ``parity_ok``."""
    worst = {"recall": min(f["recall"] for f in frame_stats),
             "precision": min(f["precision"] for f in frame_stats),
             "score_err": max(f["max_score_err"] for f in frame_stats),
             "center_err": max(f["max_center_err"] for f in frame_stats)}
    n_conf = {"ref": sum(f["n_conf_ref"] for f in frame_stats),
              "fast": sum(f["n_conf_fast"] for f in frame_stats)}
    ok = (worst["recall"] >= PASS_RECALL and worst["precision"] >= PASS_RECALL
          and worst["score_err"] <= MAX_SCORE_ERR
          and worst["center_err"] <= MAX_CENTER_ERR
          and min(n_conf.values()) >= MIN_CONFIDENT)
    return {"worst": worst, "n_confident": n_conf, "parity_ok": bool(ok)}


def run_suite(n_frames: int = 3, cfg: Optional[DSVTConfig] = None,
              device="cuda") -> dict:
    """Every row of the matrix (with ``cfg``: its two precisions on that
    configuration); returns {"gates": {tag: row}, "all_ok": bool}."""
    rows = (MATRIX if cfg is None else
            [(f"{fast}_config", fast, "nuscenes") for fast in ("bf16", "mixed")])
    gates = {}
    for tag, fast, density in rows:
        gates[tag] = run_parity(fast, density, n_frames, cfg, device)
        print(f"{tag}: ok={gates[tag]['parity_ok']} "
              f"worst={gates[tag]['worst']}", flush=True)
    return {"gates": gates, "all_ok": all(g["parity_ok"]
                                          for g in gates.values())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="dsvt-torch-parity")
    ap.add_argument("--out", default="parity.json")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--config", default=None,
                    help="DSVTConfig json (default: the matrix above)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = None
    if args.config:
        with open(args.config) as f:
            cfg = DSVTConfig.from_json(f.read())
    result = run_suite(args.frames, cfg, device)
    on_card = device.type == "cuda"
    result = {"device": torch.cuda.get_device_name(device) if on_card
              else "cpu",
              "nvidia_smi": bench.card_line() if on_card else None,
              **result}
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"-> {args.out}  all_ok={result['all_ok']}", flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main()["all_ok"] else 1)
