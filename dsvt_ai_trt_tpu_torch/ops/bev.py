"""Sparse pillar -> dense BEV canvas scatter (port of the JAX ops/bev.py)."""

from __future__ import annotations

import torch

from ..parallel import spatial


def map_to_bev(pillar_feats: torch.Tensor, coords: torch.Tensor,
               pillar_valid: torch.Tensor, grid_hw) -> torch.Tensor:
    """pillar_feats: [P, C]; coords: [P, 2] (iy, ix).  Returns [H, W, C].

    The JAX package's drop-mode scatter (``ops/bev.py:map_to_bev`` there),
    with a shape that does not depend on the data: invalid pillars write a
    dump row past the map, in a [H*W + 1, C] buffer, by one ``index_copy_``,
    and the result is the buffer's first H*W rows.  No boolean index, so no
    host read, and a CUDA graph can capture it.  The map's rows are one
    contiguous [H*W, C] block, so the [H, W, C] result viewed by
    ``ops.layout.to_nchw`` is a [1, C, H, W] tensor with ``channels_last``
    strides, the layout the bf16 convs run in (model/backbone2d.py): the
    bf16 and mixed stacks take it with no data moved; the fp32 stack
    copies it once to NCHW.

    Inside ``parallel.spatial.spatial_sharding`` the map is this rank's
    rows [lo, hi) only (``spatial.bev_range``): [hi - lo, W, C], written
    from the pillars whose row it owns; the others go to the dump row.
    """
    H, W = grid_hw
    P, C = pillar_feats.shape
    lo, hi = spatial.bev_range(H) if spatial.active() else (0, H)
    cells = (hi - lo) * W
    keep = pillar_valid
    if (lo, hi) != (0, H):
        keep = keep & (coords[:, 0] >= lo) & (coords[:, 0] < hi)
    lin = torch.where(keep, (coords[:, 0] - lo) * W + coords[:, 1], cells)
    canvas = pillar_feats.new_zeros((cells + 1, C))
    canvas.index_copy_(0, lin, pillar_feats)
    return canvas[:cells].view(hi - lo, W, C)
