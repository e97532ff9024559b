"""Pillar scatter-max: port of the JAX package's ops/scatter.py.

The float32 reference path of the VFE (``forward_debug``, training and
``use_pallas=False`` run it), via ``scatter_reduce("amax")``.
"""

from __future__ import annotations

import torch

from .gather import take_rows

_NEG = -1.0e6   # the reference's init value (torchScatterMax.cu:214)


def pillar_max(point_feats: torch.Tensor, point_pillar: torch.Tensor,
               point_valid: torch.Tensor, num_pillars: int) -> torch.Tensor:
    """Channelwise max over each pillar's points: [num_pillars + 1, C], the
    last row the dump of invalid points (point_pillar == num_pillars).
    Invalid rows take the -1e6 init value, so empty pillars (and the dump
    row) stay at it and are zero-filled."""
    C = point_feats.shape[1]
    guarded = torch.where(point_valid[:, None], point_feats, _NEG)
    table = torch.full((num_pillars + 1, C), _NEG, dtype=point_feats.dtype,
                       device=point_feats.device)
    table = table.scatter_reduce(0, point_pillar[:, None].expand(-1, C),
                                 guarded, reduce="amax", include_self=True)
    return torch.where(table > _NEG, table, torch.zeros_like(table))


def scatter_max(point_feats: torch.Tensor, point_pillar: torch.Tensor,
                point_valid: torch.Tensor, num_pillars: int):
    """``pillar_max`` plus its per-point broadcast.

    point_feats: [P1, C]; point_pillar: [P1] (== num_pillars for invalid).
    Returns (max_point_feats [P1, C], max_pillar_feats [num_pillars, C]),
    invalid rows of the broadcast zero-filled.
    """
    table = pillar_max(point_feats, point_pillar, point_valid, num_pillars)
    point_max = torch.where(point_valid[:, None],
                            take_rows(table, point_pillar),
                            torch.zeros_like(point_feats))
    return point_max, table[:num_pillars]
