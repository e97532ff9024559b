"""Engine and frame loop: the reference's -d mode, in PyTorch.

``Engine(params, cfg, device="cuda")`` keeps the weights resident on the
device and answers ``engine(points, n) -> Detections``.  ``run_frames``
iterates .bin frames, writes one reference-format result txt per frame
(first line = seconds) and warns when a frame's occupancy reaches a static
cap (points, pillars or sets were then silently dropped, as the reference
does).  Port of the JAX package's runtime/compile.py:Engine and
runtime/infer.py:run_frames; the jax.export build/load, the scan mode and
the benchmark are not ported yet.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import DSVTConfig
from ..io.output import save_txt
from ..io.pointcloud import load_bin
from ..model.detector import forward
from ..ops.common import resolve_device
from ..ops.postprocess import Detections
from ..weights import from_jax_params

log = logging.getLogger("dsvt_torch.infer")


class Engine:
    """Callable wrapper: ``dets = engine(points, num_points)``.

    params: the nested NumPy dict of ``weights.random_params`` /
    ``prepare_params`` (either package's), or one already carried to torch
    by ``from_jax_params``.  Raises when ``device`` is "cuda" and no card
    is present.
    """

    def __init__(self, params, cfg: DSVTConfig, device="cuda",
                 with_nms: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        leaf = params["vfe"]["l0"]["w"]
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameters are on {leaf.device}, the "
                                 f"engine runs on {self.device}")
            self.params = params
        else:
            self.params = from_jax_params(params, self.device)
        self.with_nms = with_nms

    def __call__(self, points, num_points) -> Detections:
        return forward(self.params, points, num_points, self.cfg,
                       self.with_nms, device=self.device)


def _cap_table(cfg: DSVTConfig):
    names = ["max_kept_points", "max_pillars"] + [
        f"max_sets[{i}]" for i in range(len(cfg.window_specs))]
    caps = np.array([cfg.max_kept_points, cfg.max_pillars]
                    + [cfg.max_sets_for(s) for s in cfg.window_specs])
    return names, caps


def run_frames(engine: Engine, paths: List[str],
               out_dir: Optional[str] = None) -> List[dict]:
    """Run inference over .bin frames; returns per-frame dicts with
    boxes/count/seconds/saturated.  A frame that cannot be read is skipped
    and reported (the reference exits instead)."""
    cfg = engine.cfg
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    cap_names, caps = _cap_table(cfg)
    results = []
    for path in paths:
        name = os.path.splitext(os.path.basename(path))[0]
        try:
            pts, n = load_bin(path, cfg.max_points)
        except (IOError, ValueError) as exc:
            log.error("skipping bad frame %s: %s", path, exc)
            results.append({"frame": name, "error": str(exc)})
            continue
        t0 = time.perf_counter()
        dets = engine(pts, n)
        boxes = dets.boxes.cpu().numpy()      # the copy waits for the device
        count = int(dets.count)
        occ = dets.occupancy.cpu().numpy()
        seconds = time.perf_counter() - t0
        saturated = [cap_names[i] for i in range(len(caps)) if occ[i] >= caps[i]]
        if saturated:
            log.warning("%s: occupancy hit static cap(s) %s (occupancy %s vs "
                        "caps %s); points/pillars/sets were silently dropped",
                        os.path.basename(path), saturated, occ.tolist(),
                        caps.tolist())
        if out_dir:
            save_txt(boxes, count, seconds, os.path.join(out_dir, name + ".txt"))
        log.info("%s: %d boxes, %.1f ms", name, count, seconds * 1e3)
        results.append({"frame": name, "boxes": boxes[:count], "count": count,
                        "seconds": seconds, "saturated": saturated})
    return results
