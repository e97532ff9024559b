"""Window partition + DSVT rotated-set partition in PyTorch.

Port of the JAX package's ops/windows.py: one stable sort over a composite
(window, in-window) key per axis, a cumsum for set allocation, and dense
gathers for the DSVT Eq.(3) local-index spreading.  Every output is integer
(or an exact small float) and equals the JAX one exactly.

  * sort keys: sortY = cy*wx*wz + cx*wz + cz; sortX = cx*wy*wz + cy*wz + cz.
  * Eq.(3): local[j,k] = ((j*S+k) * N) // (S * n_sets) with S = set_size.
  * the duplicate mask depends only on local-index repeats, so it is the
    same for both axes.
  * invalid sets (>= set_count) carry ALL-dead key masks and the dump index
    (== max_pillars); kernel B1's zero output for them rests on this.
  * scatter-back goes through each pillar's canonical slot
    m = ceil(rank * S*n_sets / N), the first slot Eq.(3) maps onto it.

3-D voxels (``coords`` [P, 3], iz first) take the same steps with their
in-window z in the sort keys, windows along z where a window is lower than
the grid (``window_grid``), and the in-window (x, y, z) minus half the
window as the position-embedding input where the grid has more than one z
cell (upstream DSVT-V).  ``cfg`` is a ``DSVTConfig`` or one stage of it
(``config.StageSpec``): the partitions read its ``sparse_shape``,
``set_size`` and ``max_sets``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import DSVTConfig, WindowSpec
from .segment import head_positions

NEG_MASK = torch.finfo(torch.float32).min   # -3.4028235e38, exact in f32


class WindowPartition(NamedTuple):
    """win_id [P] (sentinel for invalid pillars), inwin_xyz [P, 3] (x, y, z
    in-window coords), xy_centered [P, 2] float in-window (x, y) minus
    window/2 (the pos-embed input); [P, 3] (x, y, z) on a grid with more
    than one z cell."""

    win_id: torch.Tensor
    inwin_xyz: torch.Tensor
    xy_centered: torch.Tensor


class SetPartition(NamedTuple):
    """inds [2, S, K] pillar index per (axis, set, slot), dump row
    (== max_pillars) on invalid sets; key_mask [S, K] additive mask,
    -3.4e38 on duplicate slots and on every slot of invalid sets;
    set_count [] number of valid sets; canon [2, P] flat canonical slot
    (set*K + slot) of each pillar per axis, S*K (dump) for invalid pillars."""

    inds: torch.Tensor
    key_mask: torch.Tensor
    set_count: torch.Tensor
    canon: torch.Tensor


def window_grid(spec: WindowSpec, sparse_shape) -> Tuple[int, int, int]:
    """Windows along (x, y, z): ``spec.num_windows``, with one window along
    z where the window spans the grid's z (upstream then drops the z
    shift)."""
    nwx, nwy, nwz = spec.num_windows(sparse_shape)
    return nwx, nwy, (1 if spec.shape[2] >= sparse_shape[2] else nwz)


def window_partition(coords: torch.Tensor, pillar_valid: torch.Tensor,
                     spec: WindowSpec, cfg: DSVTConfig) -> WindowPartition:
    """coords: [P, 2] (iy, ix), or [P, 3] (iz, iy, ix)."""
    wx, wy, wz = spec.shape
    sx, sy, sz = spec.shift
    nwx, nwy, nwz = window_grid(spec, cfg.sparse_shape)

    shifted_x = coords[:, -1] + sx
    shifted_y = coords[:, -2] + sy
    wcx = shifted_x // wx
    wcy = shifted_y // wy
    win = wcy * nwx + wcx
    if coords.shape[1] == 3:
        shifted_z = coords[:, 0] + (sz if nwz > 1 else 0)
        win = (shifted_z // wz) * (nwx * nwy) + win
        cz = shifted_z % wz
    else:
        cz = torch.zeros_like(shifted_x)
    win_id = torch.where(pillar_valid, win,
                         torch.full_like(wcx, nwx * nwy * nwz))
    cx = shifted_x % wx
    cy = shifted_y % wy
    inwin = torch.stack([cx, cy, cz], dim=-1)
    centred = [cx.float() - wx / 2.0, cy.float() - wy / 2.0]
    if cfg.sparse_shape[2] > 1:
        centred.append(cz.float() - wz / 2.0)
    return WindowPartition(win_id=win_id, inwin_xyz=inwin,
                           xy_centered=torch.stack(centred, dim=-1))


def set_partition(part: WindowPartition, pillar_valid: torch.Tensor,
                  spec: WindowSpec, cfg: DSVTConfig) -> SetPartition:
    """Build the [2, S, K] set index tensors."""
    dev = part.win_id.device
    P = part.win_id.shape[0]
    K = cfg.set_size
    S = cfg.max_sets
    wx, wy, wz = spec.shape
    cx, cy, cz = part.inwin_xyz.unbind(-1)

    key_y = cy * (wx * wz) + cx * wz + cz
    key_x = cx * (wy * wz) + cy * wz + cz
    inwin_cap = max(wx * wy * wz, wx * wz * wy) + 1
    big = P * inwin_cap + inwin_cap
    pos = torch.arange(P, device=dev)

    def axis_order(axis_key):
        composite = torch.where(pillar_valid, part.win_id * inwin_cap + axis_key,
                                torch.full_like(axis_key, big))
        return torch.sort(composite, stable=True)

    s_comp_y, order_y = axis_order(key_y)
    _, order_x = axis_order(key_x)

    # window segmentation over the sorted stream (same for both axes)
    s_valid = s_comp_y < big
    s_win = torch.where(s_valid, s_comp_y // inwin_cap,
                        torch.full_like(s_comp_y, -1))
    prev = torch.cat([s_win.new_full((1,), -2), s_win[:-1]])
    new_win = s_valid & (s_win != prev)
    win_rank = torch.cumsum(new_win.long(), 0) - 1                    # [P]
    win_count = new_win.long().sum()

    nw = window_grid(spec, cfg.sparse_shape)
    W = min(P, nw[0] * nw[1] * nw[2])
    win_rank_safe = torch.where(s_valid & (win_rank < W), win_rank,
                                torch.full_like(win_rank, W))
    # (start, size) from segment extents: heads in window-rank order, with
    # two trailing sentinels because the slices reach starts_w[W + 1]
    starts_w = head_positions(new_win, P + 2)                         # [P + 2]
    n_valid_rows = s_valid.long().sum()
    win_start = starts_w[:W + 1]
    nxt_start = starts_w[1:W + 2]
    win_size = torch.clamp(torch.minimum(nxt_start, n_valid_rows) - win_start,
                           min=0)

    # set allocation: ceil(N/K) sets per window, window-major
    sets_per_win = (win_size[:W] + (K - 1)) // K
    set_base = torch.cat([pos.new_zeros((1,)), torch.cumsum(sets_per_win, 0)])
    # a one-element index: a 0-dim tensor index would be read on the host
    set_count = torch.clamp(
        set_base[torch.clamp(win_count, max=W).reshape(1)][0], max=S)

    # window rank of each set: +1 at every window's base, then cumsum.  The
    # index is clamped to S, inside the [S + 1] buffer, so nothing drops.
    set_ids = torch.arange(S, device=dev)
    bump = pos.new_zeros((S + 1,)).index_add_(
        0, torch.clamp(set_base[1:W + 1], max=S), (sets_per_win > 0).long())
    win_of_set = torch.cumsum(bump[:S], 0)                            # [S]
    set_valid = set_ids < set_count
    wos = torch.clamp(win_of_set, max=W - 1)

    n_of_set = win_size[wos]
    nsets_of_set = torch.clamp(sets_per_win[wos], min=1)
    j = set_ids - set_base[wos]

    # Eq.(3) local index spreading
    k = torch.arange(K, device=dev)[None, :]
    m = j[:, None] * K + k                                            # [S, K]
    local = (m * n_of_set[:, None]) // (K * nsets_of_set[:, None])
    local = torch.minimum(local, torch.clamp(n_of_set[:, None] - 1, min=0))

    src_pos = win_start[wos][:, None] + local                         # [S, K]
    src_pos = torch.where(set_valid[:, None], src_pos,
                          torch.full_like(src_pos, P - 1))
    dump = torch.full_like(src_pos, P)
    inds = torch.stack([
        torch.where(set_valid[:, None], order_y[src_pos], dump),
        torch.where(set_valid[:, None], order_x[src_pos], dump),
    ])                                                                # [2, S, K]

    # duplicate-slot mask; invalid sets are all dead
    dup = torch.cat([torch.zeros((S, 1), dtype=torch.bool, device=dev),
                     local[:, 1:] == local[:, :-1]], dim=1)
    key_mask = torch.zeros((S, K), device=dev).masked_fill(
        dup | ~set_valid[:, None], NEG_MASK)

    # canonical inverse: pillar with in-window rank r maps to flat slot
    # ceil(r * K*n_sets / N)
    win_tbl = torch.stack([
        win_start[:W + 1],
        torch.clamp(win_size[:W + 1], min=1),
        K * torch.clamp(torch.nn.functional.pad(sets_per_win, (0, 1)), min=1),
        torch.nn.functional.pad(set_base[:W], (0, 1)),
    ], dim=1)                                                         # [W+1, 4]

    def canon_for(order):
        # inverse permutation (order is a permutation of 0..P-1)
        inv_rank = torch.empty_like(order)
        inv_rank[order] = pos
        wr = torch.empty_like(order)
        wr[order] = win_rank_safe
        row = win_tbl[wr]                                             # [P, 4]
        r = inv_rank - row[:, 0]
        mflat = (r * row[:, 2] + row[:, 1] - 1) // row[:, 1]
        flat = row[:, 3] * K + mflat
        return torch.where(pillar_valid & (flat < S * K), flat,
                           torch.full_like(flat, S * K))

    canon = torch.stack([canon_for(order_y), canon_for(order_x)])
    return SetPartition(inds=inds, key_mask=key_mask, set_count=set_count,
                        canon=canon)


def partition(coords: torch.Tensor, pillar_valid: torch.Tensor,
              spec: WindowSpec, cfg: DSVTConfig):
    wp = window_partition(coords, pillar_valid, spec, cfg)
    sp = set_partition(wp, pillar_valid, spec, cfg)
    return wp, sp
