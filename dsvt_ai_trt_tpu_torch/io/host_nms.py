"""Host-side rotated NMS in NumPy (port of the JAX package's io/host_nms.py).

The default pipeline runs NMS on the device (ops/nms.py, kernel B4); this
is the host alternative of the reference's deployment shape (helper.h:
257-283 runs NMS on the CPU after the engine): ``run_frames(...,
host_nms=True)`` with an engine built ``with_nms=False``.  The JAX module
also has a native C++ path (``native/dsvt_host.cpp``); the port's copy of
it is queued work (ROADMAP), so NumPy is the only path here.

The box geometry (``_corners``, ``_clip_area``) is also what ``eval.py``
matches boxes with.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _corners(boxes: np.ndarray) -> np.ndarray:
    cx, cy = boxes[:, 0], boxes[:, 1]
    hx, hy = boxes[:, 4] / 2, boxes[:, 3] / 2
    ang = boxes[:, 6]
    ox = np.stack([-hx, hx, hx, -hx], 1)
    oy = np.stack([-hy, -hy, hy, hy], 1)
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([ox * c - oy * s + cx[:, None],
                     ox * s + oy * c + cy[:, None]], -1)


def _clip_area(pa: np.ndarray, pb: np.ndarray) -> float:
    """Sutherland–Hodgman intersection area of two convex quads."""
    poly = list(pa)
    for e in range(4):
        a, b = pb[e], pb[(e + 1) % 4]
        ex, ey = b[0] - a[0], b[1] - a[1]
        out = []
        n = len(poly)
        if n < 3:
            return 0.0
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            dc = ex * (cur[1] - a[1]) - ey * (cur[0] - a[0])
            dn = ex * (nxt[1] - a[1]) - ey * (nxt[0] - a[0])
            if dc >= 0:
                out.append(cur)
            if (dc >= 0) != (dn >= 0):
                t = dc / (dc - dn)
                out.append((cur[0] + t * (nxt[0] - cur[0]),
                            cur[1] + t * (nxt[1] - cur[1])))
        poly = out
    if len(poly) < 3:
        return 0.0
    area = 0.0
    for i in range(len(poly)):
        j = (i + 1) % len(poly)
        area += poly[i][0] * poly[j][1] - poly[j][0] * poly[i][1]
    return abs(area) / 2


def nms_host(boxes: np.ndarray, count: int,
             iou_threshold: float) -> Tuple[np.ndarray, int]:
    """Greedy NMS on score-sorted boxes [K, 9]; returns compacted (boxes, n).
    A pair whose circumcircles lie apart (with a 1 mm margin) cannot
    overlap, so its IoU of 0 is not computed when the threshold is above 0:
    the kept set is the one every pair's clip would give."""
    boxes = np.ascontiguousarray(boxes, np.float32)
    count = int(count)
    suppressed = np.zeros(count, bool)
    corners = _corners(boxes[:count])
    areas = boxes[:count, 3] * boxes[:count, 4]
    near = np.ones((count, count), bool)
    if iou_threshold > 0:
        radius = 0.5 * np.hypot(boxes[:count, 3], boxes[:count, 4])
        dist = np.hypot(boxes[:count, 0, None] - boxes[None, :count, 0],
                        boxes[:count, 1, None] - boxes[None, :count, 1])
        near = dist <= radius[:, None] + radius[None, :] + 1e-3
    sel = []
    for i in range(count):
        if suppressed[i]:
            continue
        sel.append(i)
        for j in np.flatnonzero(near[i, i + 1:]) + i + 1:
            if suppressed[j]:
                continue
            ov = _clip_area(corners[i], corners[j])
            iou = ov / max(areas[i] + areas[j] - ov, 1e-8)
            if iou >= iou_threshold:
                suppressed[j] = True
    out = np.zeros_like(boxes)
    out[:len(sel)] = boxes[sel]
    return out, len(sel)
