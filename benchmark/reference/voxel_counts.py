"""Occupancy of a frame for the voxel model (``voxel.py``) in NumPy: kept
points, each stage's voxels, and the live sets of each set partition a
stage reads, as the voxel detector counts them.

Set-up counts every sweep of the cell with this before the run (a sweep at
a cap fails it), the cell's traffic redraws a sweep that comes near a cap,
and the work formulas (``benchmark/work_voxel.py``) read the counts.  The
same rules as ``voxel.py``, without the features.
"""

from __future__ import annotations

import numpy as np

from .counts import _cells
from .voxel import VoxelConfig, window_counts


def occupancy(points: np.ndarray, num_points: int, cfg: VoxelConfig
              ) -> np.ndarray:
    pts = np.asarray(points[:num_points], np.float32)
    lo, hi = cfg.pc_range_min, cfg.pc_range_max
    ok = np.ones(len(pts), bool)
    for a in range(3):
        ok &= (pts[:, a] >= np.float32(lo[a])) & (pts[:, a] < np.float32(hi[a]))
    pts = pts[ok]
    gx, gy, gz = cfg.grid_size
    cell = ((_cells(pts[:, 2], lo[2], cfg.voxel_size[2], gz) * gy
             + _cells(pts[:, 1], lo[1], cfg.voxel_size[1], gy)) * gx
            + _cells(pts[:, 0], lo[0], cfg.voxel_size[0], gx))
    uniq, per_cell = np.unique(cell, return_counts=True)      # ascending
    rows = np.minimum(per_cell, cfg.max_points_per_pillar)
    first_row = np.concatenate([[0], np.cumsum(rows)[:-1]])
    in_stream = first_row < cfg.max_kept_points
    n_vox = min(int(in_stream.sum()), cfg.max_pillars)
    kept_rows = np.minimum(rows, np.maximum(cfg.max_kept_points - first_row, 0))
    kept = int(kept_rows[:n_vox].sum())
    cells = uniq[:n_vox]
    z, y, x = cells // (gx * gy), (cells // gx) % gy, cells % gx
    voxels, sets = [], []
    for s, st in enumerate(cfg.stages):
        voxels.append(len(x))
        for i in cfg.used(s):
            spec = st.windows[i]
            (wx, wy, wz), (sx, sy, sz) = spec
            nwx, nwy, nwz = window_counts(spec, st.sparse_shape)
            zz = z + (sz if nwz > 1 else 0)
            win = (((zz // wz) * nwy + (y + sy) // wy) * nwx + (x + sx) // wx)
            _, size = np.unique(win, return_counts=True)
            sets.append(min(int(((size + st.set_size - 1)
                                 // st.set_size).sum()), st.max_sets))
        if s + 1 < len(cfg.stages):
            (kx, ky, kz), nxt = st.stride, cfg.stages[s + 1]
            ngx, ngy, _ = nxt.sparse_shape
            parent = np.unique(((z // kz) * ngy + y // ky) * ngx + x // kx)
            parent = parent[:nxt.max_voxels]
            z, y, x = (parent // (ngx * ngy), (parent // ngx) % ngy,
                       parent % ngx)
    return np.array([kept] + voxels + sets, np.int64)


def caps(cfg: VoxelConfig) -> np.ndarray:
    """The caps in ``occupancy`` order."""
    return np.array([cfg.max_kept_points] + [st.max_voxels for st in cfg.stages]
                    + [st.max_sets for s, st in enumerate(cfg.stages)
                       for _ in cfg.used(s)], np.int64)
