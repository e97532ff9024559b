"""Sparse pillar -> dense BEV canvas scatter (port of the JAX ops/bev.py)."""

from __future__ import annotations

import torch


def map_to_bev(pillar_feats: torch.Tensor, coords: torch.Tensor,
               pillar_valid: torch.Tensor, grid_hw) -> torch.Tensor:
    """pillar_feats: [P, C]; coords: [P, 2] (iy, ix).  Returns [H, W, C].

    Invalid pillars are dropped by a mask.  The canvas is one contiguous
    [H*W, C] block, so the [H, W, C] result viewed as [1, C, H, W] is
    already in the ``channels_last`` layout the conv stack runs in
    (model/backbone2d.py): no transpose copy at the boundary.
    """
    H, W = grid_hw
    P, C = pillar_feats.shape
    lin = coords[:, 0] * W + coords[:, 1]
    canvas = pillar_feats.new_zeros((H * W, C))
    canvas[lin[pillar_valid]] = pillar_feats[pillar_valid]
    return canvas.view(H, W, C)
