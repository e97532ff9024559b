"""Sparse pillar -> dense BEV canvas scatter (port of the JAX ops/bev.py)."""

from __future__ import annotations

import torch

from ..parallel import spatial


def map_to_bev(pillar_feats: torch.Tensor, coords: torch.Tensor,
               pillar_valid: torch.Tensor, grid_hw) -> torch.Tensor:
    """pillar_feats: [P, C]; coords: [P, 2] (iy, ix).  Returns [H, W, C].

    Invalid pillars are dropped by a mask.  The canvas is one contiguous
    [H*W, C] block, so the [H, W, C] result viewed as [1, C, H, W] is
    already in the ``channels_last`` layout the conv stack runs in
    (model/backbone2d.py): no transpose copy at the boundary.

    Inside ``parallel.spatial.spatial_sharding`` the canvas is this rank's
    rows [lo, hi) only (``spatial.bev_range``): [hi - lo, W, C], written
    from the pillars whose row it owns.
    """
    H, W = grid_hw
    P, C = pillar_feats.shape
    lo, hi = spatial.bev_range(H) if spatial.active() else (0, H)
    lin = coords[:, 0] * W + coords[:, 1]
    keep = pillar_valid
    if (lo, hi) != (0, H):
        keep = keep & (coords[:, 0] >= lo) & (coords[:, 0] < hi)
        lin = lin - lo * W
    canvas = pillar_feats.new_zeros(((hi - lo) * W, C))
    canvas[lin[keep]] = pillar_feats[keep]
    return canvas.view(hi - lo, W, C)
