"""The voxelizer's segment work on the card: kernel ``voxel_segments``.

``ops/voxelize.py:voxelize`` with ``use_kernels`` on a CUDA tensor calls
these two wrappers in place of its plain steps, one launch each a frame:

* ``cap_keys_cuda`` on the full cell-sorted stream: the key of the second
  sort, a row's cell where the row lies fewer than the cap rows after its
  pillar's first row, else the sentinel (plain version:
  ``ops/voxelize.py:cap_keys_plain``, a ``torch.cummax`` scan);
* ``pillars_cuda`` on the compacted stream, with each row's pillar (the
  cumsum of the pillar heads) and the two sorts' orders: every field of
  ``Pillars`` but ``point_count``, in place of the plain version's two
  scans, segmented sums, pointer jumping and head sort.

Both give the plain version's bits (``csrc/voxel_segments.cu`` says how).
The kernel takes a cap of at most 64 rows (B3's limit).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .. import kernels
from ..config import DSVTConfig

MAX_CAP = 64
TILE = 192     # csrc/voxel_segments.cu's TILE (rows whose pillars one block
#                owns), for the tests' tile-edge streams; change both
FEATS = 10


def _check_cap(cfg: DSVTConfig) -> int:
    cap = cfg.max_points_per_pillar
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"voxel_segments: max_points_per_pillar must be in "
                         f"[1, {MAX_CAP}], got {cap}")
    return cap


def _check_rows(name: str, t: torch.Tensor, rows: int = None) -> None:
    if t.dim() != 1 or t.dtype != torch.int64 or (
            rows is not None and t.shape[0] != rows):
        want = "[N]" if rows is None else f"[{rows}]"
        raise ValueError(f"voxel_segments: {name} must be int64 {want}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _launch(phase: int, cell: torch.Tensor, cap: int, cfg: DSVTConfig,
            inputs=(None,) * 4, outputs=(None,) * 8) -> None:
    gx, gy, gz = cfg.grid_size
    f32 = [float(np.float32(v)) for v in (*cfg.voxel_size, *cfg.pc_range_min)]
    ptr = [None if t is None else t.data_ptr() for t in (*inputs, *outputs)]
    kernels.launch("voxel_segments", phase, cell.data_ptr(), cell.shape[0],
                   cap, *ptr[:4], gx, gy, gz, cfg.max_pillars, *f32, *ptr[4:])
    kernels.count("voxel_segments")


def cap_keys_cuda(s_cell: torch.Tensor, cfg: DSVTConfig) -> torch.Tensor:
    """Launch phase 0 of ``csrc/voxel_segments.cu`` on the current stream:
    ``s_cell`` [N] int64, sorted, ``gx * gy * gz`` on invalid rows."""
    _check_rows("s_cell", s_cell)
    cap = _check_cap(cfg)
    kernels.require_cuda("voxel_segments", s_cell)
    key = torch.empty_like(s_cell)
    _launch(0, s_cell, cap, cfg, outputs=(key,) + (None,) * 7)
    return key


def pillars_cuda(s_cell: torch.Tensor, pillar_of_point: torch.Tensor,
                 points: torch.Tensor, perm: torch.Tensor, perm2: torch.Tensor,
                 cfg: DSVTConfig) -> Tuple[torch.Tensor, ...]:
    """Launch phase 1 of ``csrc/voxel_segments.cu`` on the current stream.

    ``s_cell`` [R] int64: the compacted stream (no pillar longer than the
    cap); ``pillar_of_point`` [R] int64; ``points`` [M, 4] f32; ``perm`` and
    ``perm2`` [M] int64, the two sorts' orders (row i's point is
    ``points[perm[perm2[i]]]``).  Returns (point_feats, point_pillar,
    point_valid, coords, num_points, pillar_valid, pillar_count)."""
    rows = s_cell.shape[0]
    _check_rows("s_cell", s_cell)
    _check_rows("pillar_of_point", pillar_of_point, rows)
    if points.dim() != 2 or points.shape[1] != 4 or \
            points.dtype != torch.float32:
        raise ValueError(f"voxel_segments: points must be f32 [M, 4], got "
                         f"{points.dtype} {tuple(points.shape)}")
    _check_rows("perm", perm, points.shape[0])
    _check_rows("perm2", perm2, points.shape[0])
    cap = _check_cap(cfg)
    kernels.require_cuda("voxel_segments", s_cell, pillar_of_point, points,
                         perm, perm2)
    dev, P = s_cell.device, cfg.max_pillars
    D = 3 if cfg.grid_size[2] > 1 else 2
    feats = torch.empty(rows, FEATS, device=dev)
    point_pillar = torch.empty(rows, dtype=torch.int64, device=dev)
    kept = torch.empty(rows, dtype=torch.bool, device=dev)
    counts = torch.empty(P, dtype=torch.int64, device=dev)
    coords = torch.empty(P, D, dtype=torch.int64, device=dev)
    pillar_valid = torch.empty(P, dtype=torch.bool, device=dev)
    pillar_count = torch.empty((), dtype=torch.int64, device=dev)
    _launch(1, s_cell, cap, cfg,
            inputs=(pillar_of_point, points, perm, perm2),
            outputs=(None, feats, point_pillar, kept, counts, coords,
                     pillar_valid, pillar_count))
    return (feats, point_pillar, kept, coords, counts, pillar_valid,
            pillar_count)
