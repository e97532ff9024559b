"""``sweeps``' seeded spinning-LiDAR sweeps for the voxel model: the same
draws (``sweeps.sweep``), each sweep held below every cap of the voxel
model's occupancy (``reference/voxel_counts.py``: kept points, each
stage's voxels, the live sets of each set partition a stage reads) by
``headroom``, else drawn again at the same size.  With the same
parameters and seed it gives ``sweeps``' sweeps wherever neither kind
draws again."""

from __future__ import annotations

import numpy as np

from ..reference.voxel_counts import caps, occupancy
from .sweeps import sweep


def generate(params: dict, seed: int, cfg, tries: int = 20):
    """``cfg``: a ``reference.voxel.VoxelConfig``."""
    rng = np.random.default_rng(seed)
    lo, hi = params["points"]
    sizes = np.round(np.linspace(lo, hi, params["frames"])).astype(int)
    limit = caps(cfg) * params["headroom"]
    frames = []
    for n in rng.permutation(sizes):
        if n > cfg.max_points:
            raise ValueError(f"a sweep of {n} points exceeds max_points "
                             f"{cfg.max_points}")
        for _ in range(tries):
            buf = np.zeros((cfg.max_points, 4), np.float32)
            buf[:n] = sweep(rng, params, int(n), cfg)
            if np.all(occupancy(buf, n, cfg) < limit):
                break
        else:
            raise ValueError(f"no sweep of {n} points within {limit} in "
                             f"{tries} draws")
        frames.append((buf, int(n)))
    return frames
