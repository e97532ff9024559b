"""Ground-truth target assignment + synthetic LiDAR scenes for training.

A copy of the JAX package's data.py (the port imports nothing of that
package).  The NumPy code is the same line for line, so one seed gives the
same scenes and targets in both packages; ``synthetic_batch`` hands them to
torch on an explicit device.

The assigner is the dataloader-side counterpart of CenterPoint's
``assign_target_of_single_head``: GT boxes -> dense heatmap / regression /
mask maps matching the head's decode conventions (ops/postprocess.py:
x = (xs + center)*vx + xmin, dim = exp(dim), heading = atan2(rot[1],
rot[0])).  It runs on the host in NumPy (data preparation, one pass per
frame, like the torch dataloader); the train step consumes the dense arrays
on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .config import DSVTConfig
from .ops.common import resolve_device

# GT box layout: (x, y, z, dx, dy, dz, heading, class_id)
GT_DIMS = 8


def gaussian_radius(height: float, width: float,
                    min_overlap: float = 0.1) -> float:
    """CornerNet/CenterPoint gaussian radius for a (h, w) feature-map box."""
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    sq1 = np.sqrt(max(b1 ** 2 - 4 * a1 * c1, 0))
    r1 = (b1 + sq1) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    sq2 = np.sqrt(max(b2 ** 2 - 4 * a2 * c2, 0))
    r2 = (b2 + sq2) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    sq3 = np.sqrt(max(b3 ** 2 - 4 * a3 * c3, 0))
    r3 = (b3 + sq3) / 2
    return min(r1, r2, r3)


def _draw_gaussian(heatmap: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """Splat a 2D gaussian peak (in place) clipped to the map bounds."""
    d = 2 * radius + 1
    sigma = d / 6.0
    ys, xs = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    g = np.exp(-(xs * xs + ys * ys) / (2 * sigma * sigma))
    g[g < np.finfo(g.dtype).eps * g.max()] = 0

    H, W = heatmap.shape
    t, b = min(cy, radius), min(H - cy, radius + 1)
    l, r = min(cx, radius), min(W - cx, radius + 1)
    if t + b <= 0 or l + r <= 0:
        return
    view = heatmap[cy - t:cy + b, cx - l:cx + r]
    np.maximum(view, g[radius - t:radius + b, radius - l:radius + r], out=view)


def assign_targets(gt_boxes: np.ndarray, cfg: DSVTConfig,
                   min_overlap: float = 0.1, min_radius: int = 2,
                   dense_reg: bool = True):
    """GT boxes [M, 8] -> (heatmap [H,W,ncls], reg [H,W,8], mask [H,W]).

    reg layout matches the head branch concat consumed by
    parallel.training.detection_loss: (center 2, center_z 1, log-dim 3,
    rot cos/sin 2).

    dense_reg supervises every BEV cell inside the rotated box FOOTPRINT
    (per-cell center offsets; nearest-box-center wins on overlap), not
    just the center cell.  With single-cell supervision a 468x468 map
    gets ~6 reg gradients per frame and heading converges hopelessly
    slowly (a round-4 2000-step run: centers/dims/classes learned, rot
    vectors shrunk toward zero, median heading error 63 deg; 6x rot
    up-weighting made it worse).  Footprint supervision is ~70x denser
    per box, teaches the smooth cell->center field the peak-cell decode
    samples (offsets beyond [0,1) at off-center cells are consistent
    with ops/postprocess.py's raw, non-sigmoid offset decode), and only
    touches cells whose features contain object points."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    vx, vy, _vz = cfg.voxel_size
    xmin, ymin, _zmin = cfg.pc_range_min

    heatmap = np.zeros((H, W, cfg.num_classes), np.float32)
    reg = np.zeros((H, W, 8), np.float32)
    mask = np.zeros((H, W), np.float32)
    best_d2 = np.full((H, W), np.inf, np.float32)

    for box in np.asarray(gt_boxes, np.float32):
        x, y, z, dx, dy, dz, heading, cls = box[:GT_DIMS]
        fx = (x - xmin) / vx
        fy = (y - ymin) / vy
        ix, iy = int(np.floor(fx)), int(np.floor(fy))
        if not (0 <= ix < W and 0 <= iy < H) or dx <= 0 or dy <= 0:
            continue
        radius = gaussian_radius(dy / vy, dx / vx, min_overlap)
        radius = max(min_radius, int(radius))
        _draw_gaussian(heatmap[:, :, int(cls)], ix, iy, radius)
        heatmap[iy, ix, int(cls)] = 1.0
        tgt_tail = (z, np.log(dx), np.log(dy), np.log(dz),
                    np.cos(heading), np.sin(heading))
        if dense_reg:
            # cells whose center lies inside the rotated footprint,
            # clipped to a bounding patch around the box center
            rr = int(np.ceil(0.5 * np.hypot(dx, dy) / min(vx, vy))) + 1
            y0, y1 = max(iy - rr, 0), min(iy + rr + 1, H)
            x0, x1 = max(ix - rr, 0), min(ix + rr + 1, W)
            yy, xx = np.mgrid[y0:y1, x0:x1]
            # membership + nearest-center tests measure from the CELL
            # CENTER (xx + 0.5), so supervision is symmetric around the
            # box; the offset target below stays (fx - xx), matching the
            # corner-based decode in ops/postprocess.py
            ox = (xx + 0.5 - fx) * vx
            oy = (yy + 0.5 - fy) * vy
            c, s = np.cos(heading), np.sin(heading)
            rx = ox * c + oy * s          # along the box's +x (length dx)
            ry = -ox * s + oy * c
            d2 = ox * ox + oy * oy
            sel = ((np.abs(rx) <= 0.5 * dx) & (np.abs(ry) <= 0.5 * dy)
                   & (d2 < best_d2[y0:y1, x0:x1]))
            bd = best_d2[y0:y1, x0:x1]
            bd[sel] = d2[sel]
            patch = reg[y0:y1, x0:x1]
            patch[sel, 0] = (fx - xx)[sel]
            patch[sel, 1] = (fy - yy)[sel]
            patch[sel, 2:] = tgt_tail
            mask[y0:y1, x0:x1][sel] = 1.0
        # the exact center cell always wins for its own box (distance ~0
        # beats any overlapping neighbor's footprint cells)
        reg[iy, ix] = (fx - ix, fy - iy) + tgt_tail
        mask[iy, ix] = 1.0
        best_d2[iy, ix] = 0.0  # pin: no overlapping footprint may overwrite
    return heatmap, reg, mask


# ---------------------------------------------------------------------------
# Synthetic planted-object scenes
# ---------------------------------------------------------------------------


def _box_surface_points(rng, box, n: int) -> np.ndarray:
    """Sample LiDAR-ish points on the vertical walls + top of a box.

    Orientation must be GEOMETRICALLY resolvable or heading is
    unlearnable: a front-back symmetric box makes theta and theta+pi
    indistinguishable, so the (cos, sin) target is bimodal across the
    dataset and L1 collapses toward zero (a round-4 2000-step run
    localized every box but decoded arbitrary headings — recall stuck at
    0.32 purely on rotated-IoU).  Density asymmetry alone (3x more front
    points) did NOT fix it: the VFE max-pools per pillar, so point counts
    are invisible downstream.  The fix is a shape cue that survives
    max-pooling — the roof is a wedge rising toward +x (back at
    mid-height, front at full height), the way real vehicles' hood/cab
    profiles resolve the same ambiguity in per-pillar max-z."""
    x, y, z, dx, dy, dz, heading = box[:7]
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    face = rng.choice(5, n, p=[0.08, 0.26, 0.19, 0.19, 0.28])
    px = np.where(face == 0, -0.5, np.where(face == 1, 0.5, u)) * dx
    # faces 0/1 (x walls) and 4 (top) spread over v in y; u would correlate
    # with px and collapse the top face onto its diagonal
    py = np.where(face == 2, -0.5, np.where(face == 3, 0.5, v)) * dy
    # wedge roof: height 0.5*dz at the front (+x) tapering to 0 (mid) at
    # the back; wall points clip under the same roof line
    roof = (0.5 * (px / dx + 0.5)) * dz
    pz = np.where(face == 4, roof,
                  np.minimum(rng.uniform(-0.5, 0.5, n) * dz, roof))
    c, s = np.cos(heading), np.sin(heading)
    gx = x + px * c - py * s
    gy = y + px * s + py * c
    gz = z + pz
    return np.stack([gx, gy, gz], axis=1).astype(np.float32)


def synthetic_scene(rng, cfg: DSVTConfig, n_objects: int = 6,
                    n_ground: int = 6000, pts_per_obj: int = 150
                    ) -> Tuple[np.ndarray, np.int32, np.ndarray]:
    """One planted scene: ground-plane clutter + boxes with surface points.

    Returns (points [max_points, 4] zero-padded, count, gt_boxes [M, 8])."""
    lo = np.array(cfg.pc_range_min, np.float32)
    hi = np.array(cfg.pc_range_max, np.float32)
    span = (hi - lo) * 0.9

    ground = np.zeros((n_ground, 4), np.float32)
    ground[:, :2] = rng.uniform(lo[:2] + 0.05 * span[:2],
                                lo[:2] + 0.95 * span[:2], (n_ground, 2))
    ground[:, 2] = rng.normal(-1.6, 0.05, n_ground)
    ground[:, 3] = rng.uniform(0, 0.3, n_ground)

    boxes, obj_clouds = _plant_boxes(rng, cfg, n_objects, pts_per_obj)
    cloud = np.concatenate([ground] + obj_clouds)
    rng.shuffle(cloud, axis=0)
    n = min(len(cloud), cfg.max_points)
    buf = np.zeros((cfg.max_points, 4), np.float32)
    buf[:n] = cloud[:n]
    return buf, np.int32(n), np.stack(boxes) if boxes else np.zeros((0, 8), np.float32)


def _plant_boxes(rng, cfg: DSVTConfig, n_objects: int, pts_per_obj: int,
                 occupied_xy: np.ndarray = None, max_tries: int = 40):
    """Sample n_objects planted boxes + their surface points.

    occupied_xy: [N, 2] existing points; candidate sites with more than a
    handful of them inside the footprint are rejected, so planted objects
    land in FREE space of a real scene instead of inside walls/cars."""
    lo = np.array(cfg.pc_range_min, np.float32)
    hi = np.array(cfg.pc_range_max, np.float32)
    boxes, clouds = [], []
    for _ in range(n_objects):
        cls = int(rng.integers(0, cfg.num_classes))
        # class-dependent size template (+-7% jitter): geometry must CARRY
        # the class signal, or classification is unlearnable by
        # construction (a round-4 trained model localized planted boxes
        # exactly but spread heatmap mass across all 10 classes, capping
        # every score at ~1/num_classes-ish and failing class-aware eval).
        # The ladder is GEOMETRIC, not arithmetic: under multiplicative
        # jitter j the adjacent-class length ranges are disjoint iff
        # (1+j)/(1-j) < ratio — 1.07/0.93 = 1.15 < 1.17 — for EVERY class,
        # whereas the former 2.6 + 0.45*cls ladder overlapped ~50% of the
        # class-8/9 ranges (measured 10/48 adjacent-class confusions =
        # 21% recall lost to Bayes error, round-4 3000-step run).  Real
        # classes (car / van / truck / bus) are also roughly constant
        # RELATIVE size steps apart.
        base_l = 2.6 * 1.17 ** cls
        base = np.array([base_l * 0.42, base_l, 1.35 * 1.05 ** cls],
                        np.float32)                       # (w, l, h)
        dims = base * rng.uniform(0.93, 1.07, 3)
        for _try in range(max_tries):
            ctr = rng.uniform(lo[:2] * 0.5, hi[:2] * 0.5)
            if occupied_xy is None or not len(occupied_xy):
                break
            r = 0.6 * float(np.hypot(dims[0], dims[1]))
            near = np.sum(np.abs(occupied_xy - ctr).max(axis=1) < r)
            if near <= 10:            # few strays inside: free enough
                break
        else:
            continue                   # no free site found: skip this object
        heading = rng.uniform(-np.pi, np.pi)
        box = np.array([ctr[0], ctr[1], -1.0, dims[1], dims[0], dims[2],
                        heading, cls], np.float32)
        pts = _box_surface_points(rng, box, pts_per_obj)
        cloud = np.concatenate(
            [pts, rng.uniform(0.3, 1.0, (pts_per_obj, 1)).astype(np.float32)],
            axis=1)
        boxes.append(box)
        clouds.append(cloud)
    return boxes, clouds


def real_background_scene(rng, cfg: DSVTConfig, base_points: np.ndarray,
                          n_objects: int = 6, pts_per_obj: int = 150
                          ) -> Tuple[np.ndarray, np.int32, np.ndarray]:
    """Planted GT boxes composited onto a REAL LiDAR frame: the detector
    must localize the plants while rejecting real-world clutter (walls,
    ground returns, parked geometry) instead of the statistically uniform
    synthetic ground plane.

    base_points: [N, >=4] the real frame's points (e.g. one of the
    reference's bundled .bin clouds); sites are chosen in free space (at
    most a few real points inside the footprint) so the planted GT is
    unambiguous.  Returns the same (points, count, gt) contract as
    synthetic_scene."""
    base = np.asarray(base_points, np.float32)[:, :4]
    boxes, clouds = _plant_boxes(rng, cfg, n_objects, pts_per_obj,
                                 occupied_xy=base[:, :2])
    cloud = np.concatenate([base] + clouds) if clouds else base
    rng.shuffle(cloud, axis=0)
    n = min(len(cloud), cfg.max_points)
    buf = np.zeros((cfg.max_points, 4), np.float32)
    buf[:n] = cloud[:n]
    gt = np.stack(boxes) if boxes else np.zeros((0, GT_DIMS), np.float32)
    return buf, np.int32(n), gt


def batch_from_scenes(scenes, cfg: DSVTConfig, device="cuda"):
    """(points [B, max_points, 4] f32, counts [B] int32, Targets) on
    ``device`` from (points, count, gt) scenes, targets assigned here."""
    from .parallel.training import Targets

    device = resolve_device(device)
    pts, ns, hms, regs, masks = [], [], [], [], []
    for buf, n, gt in scenes:
        hm, reg, mask = assign_targets(gt, cfg)
        pts.append(buf)
        ns.append(n)
        hms.append(hm)
        regs.append(reg)
        masks.append(mask)

    def dev(arrays):
        return torch.from_numpy(np.stack(arrays)).to(device)

    return (dev(pts), dev(ns),
            Targets(heatmap=dev(hms), reg=dev(regs), mask=dev(masks)))


def synthetic_batch(rng, cfg: DSVTConfig, batch: int, device="cuda", **kw):
    """Batch of planted scenes + assigned dense targets, as torch tensors on
    ``device`` (``batch_from_scenes``); the same draws as the JAX
    ``synthetic_batch``."""
    return batch_from_scenes(
        [synthetic_scene(rng, cfg, **kw) for _ in range(batch)], cfg, device)
