"""Occupancy of a frame in NumPy: kept points, pillars and live sets per
window spec, as the detector's voxelizer and partitions count them.

Set-up counts every frame of a cell with this before the run: it fails a
frame that reaches a cap (the detector would drop points, pillars or sets
without a word), and the work formulas (benchmark/work.py) read the
counts.  The same rules as reference/detector.py, without the features.
"""

from __future__ import annotations

import numpy as np

from .config import Config


def _cells(v: np.ndarray, vmin: float, vsize: float, n: int) -> np.ndarray:
    edges = (np.arange(n + 1, dtype=np.float64) * float(vsize)
             + float(vmin)).astype(np.float32)
    return np.clip(np.searchsorted(edges, v, side="right") - 1, 0, n - 1)


def occupancy(points: np.ndarray, num_points: int, cfg: Config) -> np.ndarray:
    """[2 + n_specs] int64: kept points, pillars, live sets per spec."""
    pts = np.asarray(points[:num_points], np.float32)
    lo, hi = cfg.pc_range_min, cfg.pc_range_max
    ok = np.ones(len(pts), bool)
    for a in range(3):
        ok &= (pts[:, a] >= np.float32(lo[a])) & (pts[:, a] < np.float32(hi[a]))
    pts = pts[ok]
    gx, gy, _ = cfg.grid_size
    cell = (_cells(pts[:, 1], lo[1], cfg.voxel_size[1], gy) * gx
            + _cells(pts[:, 0], lo[0], cfg.voxel_size[0], gx))
    uniq, per_cell = np.unique(cell, return_counts=True)      # ascending
    rows = np.minimum(per_cell, cfg.max_points_per_pillar)
    first_row = np.concatenate([[0], np.cumsum(rows)[:-1]])
    # the capped stream is cut at max_kept_points rows, then at max_pillars
    in_stream = first_row < cfg.max_kept_points
    n_pillars = min(int(in_stream.sum()), cfg.max_pillars)
    kept_rows = np.minimum(rows, np.maximum(cfg.max_kept_points - first_row, 0))
    kept = int(kept_rows[:n_pillars].sum())
    cells = uniq[:n_pillars]
    iy, ix = cells // gx, cells % gx
    sets = []
    for (wx, wy, _wz), (sx, sy, _sz) in cfg.window_specs:
        nwx, _nwy = cfg.num_windows((wx, wy, _wz))
        win = ((iy + sy) // wy) * nwx + (ix + sx) // wx
        _, size = np.unique(win, return_counts=True)
        sets.append(min(int(((size + cfg.set_size - 1) // cfg.set_size).sum()),
                        cfg.max_sets))
    return np.array([kept, n_pillars] + sets, np.int64)


def caps(cfg: Config) -> np.ndarray:
    """The caps in ``occupancy`` order."""
    return np.array([cfg.max_kept_points, cfg.max_pillars]
                    + [cfg.max_sets] * len(cfg.window_specs), np.int64)
