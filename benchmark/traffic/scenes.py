"""Seeded training batches: planted-object scenes and their CenterPoint
targets.

A frozen copy of the arithmetic of the port's ``data.synthetic_scene``,
``_plant_boxes``, ``_box_surface_points`` and ``assign_targets``: ground
clutter plus planted boxes of a class-size ladder with points on their
walls and wedge roof; targets are a gaussian heatmap per class and dense
regression maps (centre offset, z, log dims, cos/sin of the heading) over
each box's footprint.  Every batch has the same numbers of ground and
object points (``ground_points``, ``objects``, ``object_points``), so a
seed changes where things are and not how much work a step does.

Returns ``batches`` tuples of NumPy arrays (points [B, max_points, 4],
counts [B], heatmap [B, H, W, classes], reg [B, H, W, 8], mask [B, H, W]).
"""

from __future__ import annotations

import numpy as np

from .sweeps import _box_surface_points


def gaussian_radius(height, width, min_overlap=0.1):
    a1, b1 = 1, height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0))) / 2
    a2, b2 = 4, 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0))) / 2
    a3, b3 = 4 * min_overlap, -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))) / 2
    return min(r1, r2, r3)


def _draw_gaussian(heatmap, cx, cy, radius):
    d = 2 * radius + 1
    sigma = d / 6.0
    ys, xs = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    g = np.exp(-(xs * xs + ys * ys) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0
    H, W = heatmap.shape
    t, b = min(cy, radius), min(H - cy, radius + 1)
    left, r = min(cx, radius), min(W - cx, radius + 1)
    if t + b <= 0 or left + r <= 0:
        return
    view = heatmap[cy - t:cy + b, cx - left:cx + r]
    np.maximum(view, g[radius - t:radius + b, radius - left:radius + r],
               out=view)


def assign_targets(gt_boxes, cfg, min_overlap=0.1, min_radius=2):
    """GT boxes [M, 8] (x, y, z, dx, dy, dz, heading, class) -> heatmap
    [H, W, classes], reg [H, W, 8], mask [H, W]; every cell of a box's
    footprint is supervised, the nearest centre winning."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    vx, vy, _ = cfg.voxel_size
    xmin, ymin, _ = cfg.pc_range_min
    heatmap = np.zeros((H, W, cfg.num_classes), np.float32)
    reg = np.zeros((H, W, 8), np.float32)
    mask = np.zeros((H, W), np.float32)
    best = np.full((H, W), np.inf, np.float32)
    for box in np.asarray(gt_boxes, np.float32):
        x, y, z, dx, dy, dz, heading, cls = box[:8]
        fx, fy = (x - xmin) / vx, (y - ymin) / vy
        ix, iy = int(np.floor(fx)), int(np.floor(fy))
        if not (0 <= ix < W and 0 <= iy < H) or dx <= 0 or dy <= 0:
            continue
        radius = max(min_radius, int(gaussian_radius(dy / vy, dx / vx,
                                                     min_overlap)))
        _draw_gaussian(heatmap[:, :, int(cls)], ix, iy, radius)
        heatmap[iy, ix, int(cls)] = 1.0
        tail = (z, np.log(dx), np.log(dy), np.log(dz), np.cos(heading),
                np.sin(heading))
        rr = int(np.ceil(0.5 * np.hypot(dx, dy) / min(vx, vy))) + 1
        y0, y1 = max(iy - rr, 0), min(iy + rr + 1, H)
        x0, x1 = max(ix - rr, 0), min(ix + rr + 1, W)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        ox, oy = (xx + 0.5 - fx) * vx, (yy + 0.5 - fy) * vy
        c, s = np.cos(heading), np.sin(heading)
        rx, ry = ox * c + oy * s, -ox * s + oy * c
        d2 = ox * ox + oy * oy
        sel = ((np.abs(rx) <= 0.5 * dx) & (np.abs(ry) <= 0.5 * dy)
               & (d2 < best[y0:y1, x0:x1]))
        best[y0:y1, x0:x1][sel] = d2[sel]
        patch = reg[y0:y1, x0:x1]
        patch[sel, 0] = (fx - xx)[sel]
        patch[sel, 1] = (fy - yy)[sel]
        patch[sel, 2:] = tail
        mask[y0:y1, x0:x1][sel] = 1.0
        reg[iy, ix] = (fx - ix, fy - iy) + tail
        mask[iy, ix] = 1.0
        best[iy, ix] = 0.0
    return heatmap, reg, mask


def scene(rng, cfg, n_objects, n_ground, pts_per_obj):
    """Ground clutter and planted boxes: (points [max_points, 4], count,
    boxes [M, 8])."""
    lo = np.array(cfg.pc_range_min, np.float32)
    hi = np.array(cfg.pc_range_max, np.float32)
    span = (hi - lo) * 0.9
    ground = np.zeros((n_ground, 4), np.float32)
    ground[:, :2] = rng.uniform(lo[:2] + 0.05 * span[:2],
                                lo[:2] + 0.95 * span[:2], (n_ground, 2))
    ground[:, 2] = rng.normal(-1.6, 0.05, n_ground)
    ground[:, 3] = rng.uniform(0, 0.3, n_ground)
    boxes, clouds = [], []
    for _ in range(n_objects):
        cls = int(rng.integers(0, cfg.num_classes))
        base_l = 2.6 * 1.17 ** cls
        base = np.array([base_l * 0.42, base_l, 1.35 * 1.05 ** cls], np.float32)
        dims = base * rng.uniform(0.93, 1.07, 3)
        ctr = rng.uniform(lo[:2] * 0.5, hi[:2] * 0.5)
        box = np.array([ctr[0], ctr[1], -1.0, dims[1], dims[0], dims[2],
                        rng.uniform(-np.pi, np.pi), cls], np.float32)
        pts = _box_surface_points(rng, box, pts_per_obj)
        clouds.append(np.concatenate(
            [pts, rng.uniform(0.3, 1.0, (pts_per_obj, 1))], 1).astype(
                np.float32))
        boxes.append(box)
    cloud = np.concatenate([ground] + clouds)
    cloud = cloud[rng.permutation(len(cloud))]
    n = min(len(cloud), cfg.max_points)
    buf = np.zeros((cfg.max_points, 4), np.float32)
    buf[:n] = cloud[:n]
    return buf, n, np.stack(boxes) if boxes else np.zeros((0, 8), np.float32)


def generate(params: dict, seed: int, cfg):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(params["batches"]):
        frames = [scene(rng, cfg, params["objects"], params["ground_points"],
                        params["object_points"])
                  for _ in range(params["batch"])]
        targets = [assign_targets(gt, cfg) for _, _, gt in frames]
        out.append((np.stack([f[0] for f in frames]),
                    np.array([f[1] for f in frames], np.int32),
                    *(np.stack([t[i] for t in targets]) for i in range(3))))
    return out
