"""Dynamic-pillar voxelization in PyTorch.

Port of the JAX package's ops/voxelize.py, step for step, so that every
integer output is bit-exact and the float features are too:

  * cells are binned against a float64-derived fp32 edge table
    (``cell_edges``), with the floor quotient corrected by one exact
    comparison against the two adjacent edges (``_edge_bin``);
  * the multi-operand stable ``lax.sort`` becomes ``torch.sort(stable=True)``
    on the key plus gathers of the payload;
  * the 48-point per-pillar cap is applied on the FULL stream, before the
    compaction to ``max_kept_points`` (over-cap points never use the
    compacted budget);
  * the per-pillar sums run as the same segmented Hillis-Steele scan and
    pointer-jumping broadcast, in the same order, so the cluster means round
    as the JAX ones do.

Pillar ids follow ascending BEV cell index; points keep file order within a
pillar, and the first ``max_points_per_pillar`` of them are kept.

On the card with ``use_kernels`` (the serving path) the cap and everything
after the compaction's cumsum run as kernel ``voxel_segments``
(ops/voxelize_kernel.py, two launches): no cummax scan, shift ladder or
head sort, and the same bits.  The binning and both sorts are shared.

With ``grid_size[2] > 1`` (a voxel model, upstream DSVT-V) the cells are 3-D:
the cell id is ``(iz * gy + iy) * gx + ix``, voxel ids follow it, ``coords``
are [P, 3] (iz, iy, ix), and a point's centre offset takes its voxel's own z
cell.  With one z cell every step is the pillar model's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DSVTConfig
from . import voxelize_kernel
from .segment import head_positions


def cell_edges(vmin: float, vsize: float, n: int, device) -> torch.Tensor:
    """fp32 cell-edge table on ``device``: edge[i] is the i-th grid line
    vmin + i * vsize, its product and sum in float64 (each rounded once, as
    the JAX package's NumPy table), rounded to fp32.  Made by factories on
    the device, so no host data is copied and a CUDA graph can capture
    it."""
    grid = torch.arange(n + 1, dtype=torch.float64, device=device)
    return (grid * float(vsize) + float(vmin)).float()


def _edge_bin(v: torch.Tensor, edges: torch.Tensor, vmin: float, vsize: float,
              n: int) -> torch.Tensor:
    """Exact edge-table binning: the fp32 floor quotient lands within +-1 of
    the true bin; one comparison against the adjacent edges settles it.
    Equivalent to searchsorted(edges, v, 'right') - 1 on in-range values.
    The quotient is clamped before the integer cast, so out-of-range rows
    (masked by every caller) cannot overflow it."""
    q = torch.floor((v - vmin) / vsize).clamp(0, n - 1).to(torch.int64)
    lo = edges[q]
    hi = edges[q + 1]
    q = torch.where(v < lo, q - 1, torch.where(v >= hi, q + 1, q))
    return q.clamp(0, n - 1)


class Pillars(NamedTuple):
    """Static-shaped pillar decomposition of one frame (the JAX layout).

    point_feats:  [P1, 10] per-point features [x,y,z,i, dcluster_xyz,
                  dcenter_xyz]; zero on invalid rows.
    point_pillar: [P1] pillar id per point (== max_pillars for invalid).
    point_valid:  [P1] bool.
    coords:       [P, 2] (iy, ix) integer BEV cell per pillar; [P, 3]
                  (iz, iy, ix) for 3-D voxels.
    num_points:   [P] points per pillar (capped).
    pillar_valid: [P] bool.
    pillar_count: [] number of valid pillars.
    point_count:  [] number of valid (kept) points.
    Integer fields are int64 (torch's index type).
    """

    point_feats: torch.Tensor
    point_pillar: torch.Tensor
    point_valid: torch.Tensor
    coords: torch.Tensor
    num_points: torch.Tensor
    pillar_valid: torch.Tensor
    pillar_count: torch.Tensor
    point_count: torch.Tensor


def _shift_down(v: torch.Tensor, s: int) -> torch.Tensor:
    """v[i - s] with zeros shifted in (``concat([zeros(s), v[:-s]])``)."""
    return torch.cat([v.new_zeros((s,)), v[:-s]])


def _shift_up(v: torch.Tensor, s: int) -> torch.Tensor:
    """v[i + s] with zeros shifted in (``concat([v[s:], zeros(s)])``)."""
    return torch.cat([v[s:], v.new_zeros((s,))])


def sentinel_cell(cfg: DSVTConfig) -> int:
    """The cell id of rows out of range or past the count: one past the
    last cell."""
    gx, gy, gz = cfg.grid_size
    return gx * gy * gz


def sort_cells(points: torch.Tensor, num_points, cfg: DSVTConfig):
    """The points binned into cells and stably sorted by cell: (s_cell [N],
    perm [N]), int64, the cell ``gx * gy * gz`` on rows out of range or past
    ``num_points``.  ``points`` [N, 4] f32."""
    dev = points.device
    N = points.shape[0]
    gx, gy, gz = cfg.grid_size
    xmin, ymin, zmin = cfg.pc_range_min
    xmax, ymax, zmax = cfg.pc_range_max
    vx, vy, vz = cfg.voxel_size

    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    idx = torch.arange(N, device=dev)
    # range filter: [min, max) on every axis
    in_range = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax)
                & (z >= zmin) & (z < zmax))
    if not isinstance(num_points, torch.Tensor):
        num_points = int(num_points)
    valid = in_range & (idx < num_points)

    edges_x = cell_edges(xmin, vx, gx, dev)
    edges_y = cell_edges(ymin, vy, gy, dev)
    ix = _edge_bin(x, edges_x, xmin, vx, gx)
    iy = _edge_bin(y, edges_y, ymin, vy, gy)
    if gz > 1:
        iy = _edge_bin(z, cell_edges(zmin, vz, gz, dev), zmin, vz, gz) * gy + iy
    cell = torch.where(valid, iy * gx + ix,
                       torch.full_like(ix, sentinel_cell(cfg)))

    # group points by pillar: stable sort on the cell id keeps file order
    # within each pillar; the payload rides as gathers
    return torch.sort(cell, stable=True)


def cap_keys_plain(s_cell: torch.Tensor, cfg: DSVTConfig) -> torch.Tensor:
    """The key of the compaction's sort: a row's cell where its rank within
    its pillar is under the cap, else the sentinel.  The cap applies to the
    FULL stream, before the compaction."""
    N = s_cell.shape[0]
    sentinel = sentinel_cell(cfg)
    s_valid = s_cell != sentinel
    prev_full = torch.cat([s_cell.new_full((1,), -1), s_cell[:-1]])
    first_of_pillar = s_valid & (s_cell != prev_full)
    pos_full = torch.arange(N, device=s_cell.device)
    start_of = torch.cummax(torch.where(first_of_pillar, pos_full, 0), 0).values
    rank_full = pos_full - start_of
    capped = s_valid & (rank_full < cfg.max_points_per_pillar)
    return torch.where(capped, s_cell, torch.full_like(s_cell, sentinel))


def compact(key2: torch.Tensor, cfg: DSVTConfig):
    """The capped points compacted to the front (stable) and the stream cut
    or padded to ``max_kept_points``: (s_cell, perm2, new_pillar,
    pillar_of_point); perm2 stays [N]."""
    P1 = cfg.max_kept_points
    sentinel = sentinel_cell(cfg)
    key2, perm2 = torch.sort(key2, stable=True)
    s_cell = key2[:P1]
    if s_cell.shape[0] < P1:   # fewer input rows than the compacted cap
        s_cell = torch.cat([s_cell, s_cell.new_full((P1 - s_cell.shape[0],),
                                                    sentinel)])
    prev = torch.cat([s_cell.new_full((1,), -1), s_cell[:-1]])
    new_pillar = (s_cell != sentinel) & (s_cell != prev)
    pillar_of_point = torch.cumsum(new_pillar.long(), 0) - 1          # [P1]
    return s_cell, perm2, new_pillar, pillar_of_point


def voxelize(points: torch.Tensor, num_points, cfg: DSVTConfig,
             use_kernels: bool = False) -> Pillars:
    """points: [max_points, 4] float32 (zero padded); num_points: int or []
    tensor on the device of ``points``, which it runs on.  Nothing is read
    back to the host and nothing is copied from it.  With ``use_kernels``
    a CUDA tensor takes kernel ``voxel_segments`` (ops/voxelize_kernel.py)
    for the cap and the pillars, two launches with the same bits; a CPU
    tensor, or ``use_kernels`` off, the plain version below."""
    points = points.float()
    s_cell, perm = sort_cells(points, num_points, cfg)
    if use_kernels and points.is_cuda:
        s_cell, perm2, _, pillar_of_point = compact(
            voxelize_kernel.cap_keys_cuda(s_cell, cfg), cfg)
        fields = voxelize_kernel.pillars_cuda(
            s_cell, pillar_of_point, points.contiguous(), perm, perm2, cfg)
        return Pillars(*fields, point_count=fields[2].sum())
    pay = points[perm]                                   # [N, 4] x,y,z,w
    compacted = compact(cap_keys_plain(s_cell, cfg), cfg)
    return pillars_plain(*compacted, pay, cfg)


def pillars_plain(s_cell: torch.Tensor, perm2: torch.Tensor,
                  new_pillar: torch.Tensor, pillar_of_point: torch.Tensor,
                  pay: torch.Tensor, cfg: DSVTConfig) -> Pillars:
    """The pillars of the compacted stream (``compact``'s four tensors),
    ``pay`` [N, 4] the points in the first sort's order: the plain version
    of kernel voxel_segments' second launch."""
    dev = s_cell.device
    P1 = cfg.max_kept_points
    P = cfg.max_pillars
    gx, gy, gz = cfg.grid_size
    xmin, ymin, zmin = cfg.pc_range_min
    vx, vy, vz = cfg.voxel_size
    sentinel = sentinel_cell(cfg)
    pay = pay[perm2[:P1]]
    if pay.shape[0] < P1:
        pay = torch.cat([pay, pay.new_zeros((P1 - pay.shape[0], 4))])
    sx, sy, sz, sw = pay[:, 0], pay[:, 1], pay[:, 2], pay[:, 3]
    sbx = s_cell % gx
    sby = s_cell // gx
    if gz > 1:
        sbz, sby = sby // gy, sby % gy
    else:
        sbz = _edge_bin(sz, cell_edges(zmin, vz, gz, dev), zmin, vz, gz)
    s_valid = s_cell != sentinel
    kept = s_valid & (pillar_of_point < P)
    point_pillar = torch.where(kept, pillar_of_point,
                               torch.full_like(pillar_of_point, P))
    pos = torch.arange(P1, device=dev)

    pillar_count = torch.clamp(new_pillar.long().sum(), max=P)
    pillar_ids = torch.arange(P, device=dev)
    pillar_valid = pillar_ids < pillar_count

    # segmented Hillis-Steele inclusive sums (segments <= CAP <= 64 rows)
    rank_c = pos - torch.cummax(torch.where(new_pillar, pos, 0), 0).values
    zero = sx.new_zeros(())
    streams = [torch.where(kept, sx, zero), torch.where(kept, sy, zero),
               torch.where(kept, sz, zero)]
    for s in (1, 2, 4, 8, 16, 32):
        take = rank_c >= s
        streams = [v + torch.where(take, _shift_down(v, s), zero)
                   for v in streams]
    # propagate each segment's total (at its last row) to every row by
    # pointer jumping over the distance-to-end
    nxt_cell = torch.cat([s_cell[1:], s_cell.new_full((1,), -1)])
    last_of = s_valid & (s_cell != nxt_cell)
    rank_rev = (pos - torch.cummax(
        torch.where(torch.flip(last_of, (0,)), pos, 0), 0).values).flip(0)
    dist = rank_rev
    for s in (32, 16, 8, 4, 2, 1):
        take = dist >= s
        streams = [torch.where(take, _shift_up(v, s), v) for v in streams]
        dist = dist - s * take.long()
    cnt_row = (rank_c + rank_rev + 1).float()
    m = torch.stack(streams, dim=-1) / torch.clamp(cnt_row[:, None], min=1.0)

    # pillar registry: head positions in pillar order; counts are segment
    # extents
    starts_all = head_positions(new_pillar, P + 1)
    n_rows = s_valid.long().sum()
    starts_c = starts_all[:P].clamp(0, P1 - 1)
    ends_c = (torch.minimum(starts_all[1:P + 1], n_rows) - 1).clamp(0, P1 - 1)
    counts = torch.where(pillar_valid, ends_c - starts_c + 1,
                         torch.zeros_like(ends_c))
    coords_flat = torch.where(pillar_valid, s_cell[starts_c],
                              torch.zeros_like(starts_c))
    coords = torch.stack([coords_flat // gx, coords_flat % gx], dim=-1)
    if gz > 1:
        coords = torch.cat([coords[:, :1] // gy, coords[:, :1] % gy,
                            coords[:, 1:]], dim=-1)
    coords = torch.where(pillar_valid[:, None], coords, torch.zeros_like(coords))

    # 10-dim features; the cell index is re-derived from the point.  The
    # cell centre is (i + 0.5) * size + min with ONE rounding, as XLA
    # contracts it into a fused multiply-add: the f32 operands' product is
    # exact in float64, so the sum rounds once to f32 there.
    def centre(i, size, vmin):
        return ((i.double() + 0.5) * float(np.float32(size))
                + float(np.float32(vmin))).float()

    cx = centre(sbx, vx, xmin)
    cy = centre(sby, vy, ymin)
    cz = centre(sbz, vz, zmin)
    feats = torch.stack([
        sx, sy, sz, sw,
        sx - m[:, 0], sy - m[:, 1], sz - m[:, 2],
        sx - cx, sy - cy, sz - cz,
    ], dim=-1)
    feats = torch.where(kept[:, None], feats, torch.zeros_like(feats))

    return Pillars(
        point_feats=feats,
        point_pillar=point_pillar,
        point_valid=kept,
        coords=coords,
        num_points=counts,
        pillar_valid=pillar_valid,
        pillar_count=pillar_count,
        point_count=kept.long().sum(),
    )
