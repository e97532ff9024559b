"""Greedy rotated NMS in NumPy, float64.

Boxes in score order: each box is kept unless a kept box before it
overlaps it at BEV IoU >= the threshold.  The overlap of two rotated
rectangles is the area of their intersection polygon: one rectangle
clipped by the four edges of the other (Sutherland-Hodgman), its area by
the shoelace formula.  Box convention as the reference engine's: the
half-extent along the box's local x is dy / 2 and along local y dx / 2,
turned by +heading.  The union is clamped at 1e-8 as the reference does.
"""

from __future__ import annotations

import numpy as np

UNION_FLOOR = 1e-8


def corners(boxes: np.ndarray) -> np.ndarray:
    """[n, 4, 2] BEV corners, counter-clockwise."""
    hx, hy = boxes[:, 4] / 2.0, boxes[:, 3] / 2.0
    ox = np.stack([-hx, hx, hx, -hx], 1)
    oy = np.stack([-hy, -hy, hy, hy], 1)
    c, s = np.cos(boxes[:, 6])[:, None], np.sin(boxes[:, 6])[:, None]
    return np.stack([ox * c - oy * s + boxes[:, :1],
                     ox * s + oy * c + boxes[:, 1:2]], -1)


def _clip(poly, a, b):
    """The part of polygon ``poly`` left of the edge a -> b."""
    out = []
    n = len(poly)
    ex, ey = b[0] - a[0], b[1] - a[1]
    for i in range(n):
        p, q = poly[i], poly[(i + 1) % n]
        dp = ex * (p[1] - a[1]) - ey * (p[0] - a[0])
        dq = ex * (q[1] - a[1]) - ey * (q[0] - a[0])
        if dp >= 0:
            out.append(p)
        if (dp >= 0) != (dq >= 0):
            t = dp / (dp - dq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def overlap(ca: np.ndarray, cb: np.ndarray) -> float:
    """Intersection area of two convex quadrilaterals (corners [4, 2])."""
    poly = [tuple(p) for p in ca]
    for e in range(4):
        poly = _clip(poly, cb[e], cb[(e + 1) % 4])
        if len(poly) < 3:
            return 0.0
    x = np.array([p[0] for p in poly])
    y = np.array([p[1] for p in poly])
    return abs(float(np.dot(x, np.roll(y, -1)) - np.dot(np.roll(x, -1), y))) / 2


def greedy_nms(boxes: np.ndarray, threshold: float) -> np.ndarray:
    """Indices of the kept boxes (boxes [n, >=7] in score order)."""
    n = len(boxes)
    if n == 0:
        return np.zeros(0, np.int64)
    cs = corners(boxes.astype(np.float64))
    area = boxes[:, 3].astype(np.float64) * boxes[:, 4]
    radius = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4]).astype(np.float64)
    centre = boxes[:, :2].astype(np.float64)
    near = (np.linalg.norm(centre[:, None] - centre[None], axis=-1)
            <= radius[:, None] + radius[None])
    suppressed = np.zeros(n, bool)
    kept = []
    for i in range(n):
        if suppressed[i]:
            continue
        kept.append(i)
        for j in np.nonzero(near[i, i + 1:])[0] + i + 1:
            if suppressed[j]:
                continue
            inter = overlap(cs[i], cs[j])
            union = max(area[i] + area[j] - inter, UNION_FLOOR)
            if inter / union >= threshold:
                suppressed[j] = True
    return np.array(kept, np.int64)
