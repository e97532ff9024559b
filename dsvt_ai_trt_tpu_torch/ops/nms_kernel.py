"""Pairwise rotated-rectangle overlap: kernel B4 and its plain version.

Replaces the JAX package's Pallas kernel ``ops/nms_pallas.py:
pairwise_overlap_pallas`` (bodies ``_overlap_kernel``, ``_overlap_tile``):
the exact intersection area of every pair of rotated BEV rectangles by
Sutherland-Hodgman clipping of box a by box b, for score-sorted boxes
``[N, 9]`` -> ``[N, N]``.  Only the strict upper triangle (a < b) is
defined; greedy NMS reads nothing else.

The plain version is the port of ``ops/nms.py:pairwise_overlap_clip`` (the
64-slot validity-masked clip), with corners from ``box_corners``.  The CUDA
kernel is ``csrc/rotated_overlap.cu``: it takes the boxes themselves and
builds each tile's corners in shared memory with ``box_corners``' rounding,
so the wrapper only checks, allocates and launches.  It writes 0 at once
for a pair that an axis separates by more than the clip's rounding could
bridge, clips the others with 16 lanes a pair, and reruns a pair on 64
slots where a pass would emit more than 16 vertices; it agrees with the
plain version bit for bit.  A tensor on the card launches it; a tensor on
the CPU takes the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels


def box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """boxes: [N, >=7] rows (x, y, z, dx, dy, dz, heading, ...) -> [N, 4, 2]
    BEV corners, (-,-), (+,-), (+,+), (-,+) then rotated.  The half-extent
    along local x is dim1/2 and along local y dim0/2 (the reference's
    box convention)."""
    cx, cy = boxes[:, 0], boxes[:, 1]
    half_x = boxes[:, 4] / 2.0
    half_y = boxes[:, 3] / 2.0
    ang = boxes[:, 6]
    ox = torch.stack([-half_x, half_x, half_x, -half_x], dim=1)
    oy = torch.stack([-half_y, -half_y, half_y, half_y], dim=1)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x = ox * cos - oy * sin + cx[:, None]
    y = ox * sin + oy * cos + cy[:, None]
    return torch.stack([x, y], dim=-1)


def _next_valid(px, py, flags):
    """(x, y) of the next valid slot after each slot, cyclic: a backward
    fill over the slot list."""
    V = len(px)
    fx, fy, ff = [None] * V, [None] * V, [None] * V
    fx[-1], fy[-1], ff[-1] = px[-1], py[-1], flags[-1]
    for i in range(V - 2, -1, -1):
        fx[i] = torch.where(flags[i], px[i], fx[i + 1])
        fy[i] = torch.where(flags[i], py[i], fy[i + 1])
        ff[i] = flags[i] | ff[i + 1]
    nx = [torch.where(ff[i + 1], fx[i + 1], fx[0]) for i in range(V - 1)]
    ny = [torch.where(ff[i + 1], fy[i + 1], fy[0]) for i in range(V - 1)]
    return nx + [fx[0]], ny + [fy[0]]


def pairwise_overlap_clip(boxes: torch.Tensor) -> torch.Tensor:
    """Exact pairwise intersection areas [N, N] by validity-masked
    Sutherland-Hodgman: the vertex list doubles each clip pass (4 -> 64
    slots); slot i emits itself (if inside) and its edge's intersection (if
    the edge crosses) at fixed positions 2i, 2i+1, so traversal order holds
    without compaction.  Defined everywhere (both triangles)."""
    n = boxes.shape[0]
    corners = box_corners(boxes)                             # [N, 4, 2]
    ax = [corners[:, e, 0][:, None].expand(n, n) for e in range(4)]
    ay = [corners[:, e, 1][:, None].expand(n, n) for e in range(4)]
    bx = [corners[:, e, 0][None, :] for e in range(4)]        # clip: box b
    by = [corners[:, e, 1][None, :] for e in range(4)]
    poly_x, poly_y = ax, ay
    valid = [torch.ones((n, n), dtype=torch.bool, device=boxes.device)] * 4
    one = torch.ones((), device=boxes.device)
    for e in range(4):
        cax, cay = bx[e], by[e]
        ex = bx[(e + 1) % 4] - cax
        ey = by[(e + 1) % 4] - cay
        nxt_x, nxt_y = _next_valid(poly_x, poly_y, valid)
        new_x, new_y, new_f = [], [], []
        for i in range(len(poly_x)):
            d_cur = ex * (poly_y[i] - cay) - ey * (poly_x[i] - cax)
            d_nxt = ex * (nxt_y[i] - cay) - ey * (nxt_x[i] - cax)
            inside = (d_cur >= 0) & valid[i]
            crossing = ((d_cur >= 0) != (d_nxt >= 0)) & valid[i]
            t = d_cur / torch.where(crossing, d_cur - d_nxt, one)
            new_x += [poly_x[i], poly_x[i] + t * (nxt_x[i] - poly_x[i])]
            new_y += [poly_y[i], poly_y[i] + t * (nxt_y[i] - poly_y[i])]
            new_f += [inside, crossing]
        poly_x, poly_y, valid = new_x, new_y, new_f

    nxt_x, nxt_y = _next_valid(poly_x, poly_y, valid)
    area = torch.zeros((n, n), device=boxes.device)
    cnt = torch.zeros((n, n), dtype=torch.int32, device=boxes.device)
    for i in range(len(poly_x)):
        term = poly_x[i] * nxt_y[i] - nxt_x[i] * poly_y[i]
        area = area + torch.where(valid[i], term, torch.zeros_like(term))
        cnt = cnt + valid[i].int()
    area = torch.abs(area) * 0.5
    return torch.where(cnt >= 3, area, torch.zeros_like(area))


def pairwise_overlap_cuda(boxes: torch.Tensor) -> torch.Tensor:
    """Launch kernel B4 (``csrc/rotated_overlap.cu``) on the current
    stream: upper triangle exact, a >= b written as 0.  The kernel reads
    the boxes' rows in place (any row stride, unit column stride) and
    builds the corners itself."""
    if boxes.dim() != 2 or boxes.shape[1] < 7 or boxes.dtype != torch.float32:
        raise ValueError(f"pairwise_overlap: f32 boxes [N, >=7], got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if not boxes.is_cuda or boxes.stride(1) != 1:
        raise ValueError(f"pairwise_overlap: boxes on a CUDA device with "
                         f"unit column stride, got {boxes.device} strides "
                         f"{boxes.stride()}")
    n = boxes.shape[0]
    out = torch.empty((n, n), dtype=torch.float32, device=boxes.device)
    if n == 0:
        return out
    kernels.launch("rotated_overlap", boxes.data_ptr(), boxes.stride(0),
                   out.data_ptr(), n, None)
    kernels.count("rotated_overlap")
    return out


def pairwise_overlap(boxes: torch.Tensor) -> torch.Tensor:
    """Kernel B4 on a CUDA tensor, the plain version on a CPU tensor."""
    if boxes.is_cuda:
        return pairwise_overlap_cuda(boxes)
    return pairwise_overlap_clip(boxes)
