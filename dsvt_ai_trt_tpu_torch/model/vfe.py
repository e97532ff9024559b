"""Dynamic Pillar VFE (PillarNet-style PFN), port of the JAX model/vfe.py.

linear(10->96)+BN1d(folded)+ReLU, segment max, concat(point, pillar max)
-> linear(192->192)+BN1d(folded)+ReLU, segment max -> [pillars, 192].

With ``use_kernels`` (the main path, ``cfg.use_pallas``) the two segment
reductions run as kernel B3 (ops/segment.py) over segments of at most
``cfg.max_points_per_pillar`` rows: the full segmented max, then the
``starts_only`` form gathered at each pillar's first row.  On the bf16
path the point stream is bf16 (max commutes with monotone rounding).
Without it (``forward_debug``) the float32 ``scatter_max`` reference runs
instead.
"""

from __future__ import annotations

import torch

from ..config import DSVTConfig
from ..ops import segment as seg_ops
from ..ops.common import dense, matmul_dtype
from ..ops.scatter import scatter_max
from ..ops.voxelize import Pillars


def _dense_relu(x, w, b, precision, out_dt=torch.float32):
    y = dense(x, w, b, matmul_dtype(precision))
    return torch.clamp(y, min=0.0).to(out_dt)


def vfe_forward(pillars: Pillars, params: dict, cfg: DSVTConfig, *,
                use_kernels: bool) -> torch.Tensor:
    """Returns [cfg.max_pillars, 192] pillar features (zero on invalid
    rows), at ``cfg.precision``."""
    pid = pillars.point_pillar
    valid = pillars.point_valid[:, None]
    precision = cfg.precision
    cap = cfg.max_points_per_pillar
    sdt = (torch.bfloat16 if (use_kernels and precision == "bf16")
           else torch.float32)

    x = _dense_relu(pillars.point_feats, params["l0"]["w"], params["l0"]["b"],
                    precision, sdt)
    x = torch.where(valid, x, torch.zeros_like(x))
    if use_kernels:
        is_start = torch.cat([pid.new_ones((1,), dtype=torch.bool),
                              pid[1:] != pid[:-1]])
        x_max = seg_ops.segmented_max(x, is_start, cap)
        x_max = torch.where(valid, x_max, torch.zeros_like(x_max))
    else:
        x_max, _ = scatter_max(x, pid, pillars.point_valid, cfg.max_pillars)
    x = torch.cat([x, x_max], dim=-1)
    x = _dense_relu(x, params["l1"]["w"], params["l1"]["b"], precision, sdt)
    x = torch.where(valid, x, torch.zeros_like(x))
    if use_kernels:
        # per-pillar table = the scan value at each pillar's first row;
        # invalid pillars read row 0 and are zeroed below
        starts = torch.cumsum(pillars.num_points, 0) - pillars.num_points
        starts = torch.where(pillars.pillar_valid, starts,
                             torch.zeros_like(starts))
        pillar_feats = seg_ops.segmented_max(x, is_start, cap,
                                             starts_only=True)[starts]
    else:
        _, pillar_feats = scatter_max(x, pid, pillars.point_valid,
                                      cfg.max_pillars)
    return torch.where(pillars.pillar_valid[:, None], pillar_feats,
                       torch.zeros_like(pillar_feats))
