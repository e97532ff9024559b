"""The maps of the pooling between two stages of a staged sparse backbone
(upstream DSVT-V's ``get_pooling_index`` and ``subm_pooling``), at static
shapes, with no host read.

A voxel of stage s at (z, y, x) pools into the parent cell (z // sz,
y // sy, x // sx) of stage s + 1, in the slot (x % sx) * sy * sz +
(y % sy) * sz + z % sz of that parent's V = sx * sy * sz (upstream's
``index_in_win``, so slot v reads ``pos_embedding[v]``).  The parents are
the distinct parent cells in ascending cell id ((z * gy + y) * gx + x over
the next stage's grid, the order ``ops/voxelize.py`` gives voxel ids), at
most the next stage's ``max_voxels`` of them.  One stable sort of the
children by (parent cell, slot) gives everything: the parents' count,
order and coordinates, and the child of every (parent, slot).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import StageSpec
from .segment import head_positions


class PoolMap(NamedTuple):
    """child [N1, V] the child voxel of each (parent, slot), N0 where the
    slot is empty or the parent dead; order [N0] the children sorted by
    (parent, slot), dead voxels last; is_start [N0] where a parent's
    children begin in ``order`` (and where the dead tail begins); first
    [N1] the position in ``order`` of each parent's first child (0 for a
    dead parent); full [N1] whether every slot of the parent holds a
    child; coords [N1, 3] (iz, iy, ix) of the parents on the next stage's
    grid; valid [N1]; count [] parents."""

    child: torch.Tensor
    order: torch.Tensor
    is_start: torch.Tensor
    first: torch.Tensor
    full: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def pool_map(coords: torch.Tensor, valid: torch.Tensor, stage: StageSpec,
             nxt: StageSpec) -> PoolMap:
    """coords [N0, 3] (iz, iy, ix) and valid [N0] of stage ``stage``'s
    voxels -> the map to ``nxt``'s voxels."""
    dev = coords.device
    N0, N1 = coords.shape[0], nxt.max_voxels
    sx, sy, sz = stage.stride
    V = stage.pool_volume
    gx, gy, gz = nxt.sparse_shape
    z, y, x = coords.unbind(-1)
    slot = (x % sx) * (sy * sz) + (y % sy) * sz + z % sz
    sentinel = gx * gy * gz
    cell = torch.where(valid, ((z // sz) * gy + y // sy) * gx + x // sx,
                       torch.full_like(x, sentinel))
    s_key, order = torch.sort(cell * V + slot, stable=True)
    s_cell = s_key // V
    s_valid = s_cell < sentinel
    prev = torch.cat([s_cell.new_full((1,), -1), s_cell[:-1]])
    is_start = s_cell != prev
    new = s_valid & is_start
    parent = torch.cumsum(new.long(), 0) - 1                         # [N0]
    count = torch.clamp(new.long().sum(), max=N1)
    live = s_valid & (parent < N1)

    heads = head_positions(new, N1)
    pvalid = torch.arange(N1, device=dev) < count
    first = torch.where(pvalid, heads, torch.zeros_like(heads))
    pcell = torch.where(pvalid, s_cell[first], torch.zeros_like(first))
    nxt_coords = torch.stack([pcell // (gx * gy), (pcell // gx) % gy,
                              pcell % gx], dim=-1)

    flat = torch.where(live, parent * V + s_key % V,
                       torch.full_like(parent, N1 * V))
    child = torch.full((N1 * V + 1,), N0, dtype=torch.long, device=dev)
    child = child.scatter(0, flat, order)[:N1 * V].view(N1, V)
    return PoolMap(child=child, order=order, is_start=is_start, first=first,
                   full=(child < N0).all(dim=1), coords=nxt_coords,
                   valid=pvalid, count=count)
