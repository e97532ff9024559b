"""Pillar scatter-max: port of the JAX package's ops/scatter.py.

The float32 reference path of the VFE (``forward_debug`` and
``use_pallas=False`` run it), via ``scatter_reduce("amax")``.
"""

from __future__ import annotations

import torch

_NEG = -1.0e6   # the reference's init value (torchScatterMax.cu:214)


def scatter_max(point_feats: torch.Tensor, point_pillar: torch.Tensor,
                point_valid: torch.Tensor, num_pillars: int):
    """Channelwise max over each pillar's points, plus per-point broadcast.

    point_feats: [P1, C]; point_pillar: [P1] (== num_pillars for invalid).
    Returns (max_point_feats [P1, C], max_pillar_feats [num_pillars, C]).
    Invalid rows take the -1e6 init value, so empty pillars stay at it and
    are zero-filled, as are invalid rows of the broadcast.
    """
    C = point_feats.shape[1]
    guarded = torch.where(point_valid[:, None], point_feats, _NEG)
    table = torch.full((num_pillars + 1, C), _NEG, dtype=point_feats.dtype,
                       device=point_feats.device)
    table = table.scatter_reduce(0, point_pillar[:, None].expand(-1, C),
                                 guarded, reduce="amax", include_self=True)
    table = torch.where(table > _NEG, table, torch.zeros_like(table))
    point_max = torch.where(point_valid[:, None], table[point_pillar],
                            torch.zeros_like(point_feats))
    return point_max, table[:num_pillars]
