"""Seeded spinning-LiDAR sweeps: ground rings, building facades, bushes and
planted objects.

One sweep casts a ray per (beam, azimuth step) from a sensor ``height_m``
above flat ground, at ``sensor_z_m`` in the frame's z (0 in a sensor frame
such as nuScenes' LiDAR frame; the height in a vehicle frame such as
Waymo's, whose ground is at z = 0).  A ray that meets a facade (a vertical segment of a
given height) below its top returns there; else a ray below the horizon
returns from the ground; a return beyond ``max_range_m`` is lost.  Range
noise and a dropout take each return.  Objects are planted boxes with
points on their walls and wedge roof, bushes are small blobs of
scattered points; both come from a frozen copy of the port's
``data._plant_boxes`` / ``_box_surface_points`` arithmetic (boxes stand
on the ground here).

Every seed gives the same set of sweep sizes (``points``, evenly spaced
from its low to its high end, ``frames`` of them) in its own order, so a
seed changes the content of the work and not its amount; the content of
each sweep (facades, bushes, objects, dropout) comes from the seed.  The
points of a sweep are shuffled, as a sensor's packets interleave.
Returns ``frames`` pairs (points [max_points, 4] float32, zero-padded;
count).  ``headroom`` keeps every sweep below the caps (``generate``).
"""

from __future__ import annotations

import numpy as np

from ..reference.counts import caps, occupancy


def _uniform(rng, span, size=None):
    return rng.uniform(span[0], span[1], size)


def _box_surface_points(rng, box, n):
    """Points on the walls and the wedge roof of a box (x, y, z, dx, dy, dz,
    heading): the roof rises toward +x, so the heading is resolvable."""
    x, y, z, dx, dy, dz, heading = box[:7]
    u = rng.uniform(-0.5, 0.5, n)
    v = rng.uniform(-0.5, 0.5, n)
    face = rng.choice(5, n, p=[0.08, 0.26, 0.19, 0.19, 0.28])
    px = np.where(face == 0, -0.5, np.where(face == 1, 0.5, u)) * dx
    py = np.where(face == 2, -0.5, np.where(face == 3, 0.5, v)) * dy
    roof = (0.5 * (px / dx + 0.5)) * dz
    pz = np.where(face == 4, roof,
                  np.minimum(rng.uniform(-0.5, 0.5, n) * dz, roof))
    c, s = np.cos(heading), np.sin(heading)
    return np.stack([x + px * c - py * s, y + px * s + py * c, z + pz], 1)


def _objects(rng, p, ground_z, num_classes):
    """Planted boxes of the class-size ladder, standing on the ground, and
    their points with intensities."""
    out = []
    for _ in range(int(rng.integers(p["count"][0], p["count"][1] + 1))):
        cls = int(rng.integers(0, num_classes))
        base_l = 2.6 * 1.17 ** cls
        dims = np.array([base_l * 0.42, base_l, 1.35 * 1.05 ** cls]) \
            * rng.uniform(0.93, 1.07, 3)
        r, phi = _uniform(rng, p["range_m"]), rng.uniform(-np.pi, np.pi)
        box = np.array([r * np.cos(phi), r * np.sin(phi),
                        ground_z + 0.5 * dims[2], dims[1], dims[0], dims[2],
                        rng.uniform(-np.pi, np.pi)])
        n = int(rng.integers(p["points"][0], p["points"][1] + 1))
        pts = _box_surface_points(rng, box, n)
        out.append(np.concatenate([pts, rng.uniform(0.3, 1.0, (n, 1))], 1))
    return out


def _bushes(rng, p, ground_z):
    out = []
    for _ in range(int(rng.integers(p["count"][0], p["count"][1] + 1))):
        r, phi = _uniform(rng, p["range_m"]), rng.uniform(-np.pi, np.pi)
        rad = _uniform(rng, p["radius_m"])
        n = int(rng.integers(p["points"][0], p["points"][1] + 1))
        xyz = rng.normal(0.0, rad / 2, (n, 3))
        xyz[:, 0] += r * np.cos(phi)
        xyz[:, 1] += r * np.sin(phi)
        xyz[:, 2] = ground_z + np.abs(xyz[:, 2]) * 2
        out.append(np.concatenate([xyz, rng.uniform(0.05, 0.4, (n, 1))], 1))
    return out


def _facades(rng, p):
    """Vertical segments: (start [2], end [2], top height above ground)."""
    segs = []
    for _ in range(int(rng.integers(p["count"][0], p["count"][1] + 1))):
        r, phi = _uniform(rng, p["range_m"]), rng.uniform(-np.pi, np.pi)
        length = _uniform(rng, p["length_m"])
        turn = phi + np.pi / 2 + rng.normal(0.0, 0.3)
        mid = np.array([r * np.cos(phi), r * np.sin(phi)])
        half = 0.5 * length * np.array([np.cos(turn), np.sin(turn)])
        segs.append((mid - half, mid + half, _uniform(rng, p["height_m"])))
    return segs


def _cast(rng, lidar, segs):
    """Returns of every ray: points [n, 4] (x, y, z, intensity)."""
    h = lidar["height_m"]
    elev = np.deg2rad(np.linspace(lidar["elevation_deg"][0],
                                  lidar["elevation_deg"][1], lidar["beams"]))
    steps = lidar["azimuth_steps"]
    az = (np.arange(steps) + rng.uniform(0, 1)) * (2 * np.pi / steps)
    d = np.stack([np.cos(az), np.sin(az)], 1)                  # [A, 2]
    tan = np.tan(elev)                                         # [B]
    # ground: a ray below the horizon meets z = -h at horizontal range r
    with np.errstate(divide="ignore"):
        r_ground = np.where(tan < 0, h / -tan, np.inf)         # [B]
    r_hit = np.broadcast_to(r_ground[:, None], (len(elev), steps)).copy()
    kind = np.zeros(r_hit.shape, np.int8)                      # 0 ground
    for a, b, top in segs:
        # where the azimuth ray meets the segment: a + s (b - a) = t d
        e = b - a
        den = d[:, 0] * (-e[1]) - d[:, 1] * (-e[0])
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (a[0] * (-e[1]) - a[1] * (-e[0])) / den
            s = (d[:, 0] * a[1] - d[:, 1] * a[0]) / den
            meets = (t > 0) & (s >= 0) & (s <= 1) & np.isfinite(t)
            t = np.where(meets, t, np.inf)                     # [A]
            z_at = tan[:, None] * t[None, :]                   # above sensor
        below_top = (z_at <= top - h) & (z_at >= -h)
        closer = below_top & (t[None, :] < r_hit)
        r_hit = np.where(closer, t[None, :], r_hit)
        kind = np.where(closer, 1, kind)
    r_hit = r_hit + rng.normal(0.0, lidar["range_noise_m"], r_hit.shape)
    ok = np.isfinite(r_hit) & (r_hit > 0.5) & (r_hit <= lidar["max_range_m"])
    bi, ai = np.nonzero(ok)
    r = r_hit[bi, ai]
    xyz = np.stack([r * d[ai, 0], r * d[ai, 1], r * tan[bi]], 1)
    xyz[:, 2] = np.where(kind[bi, ai] == 0, -h, xyz[:, 2])
    inten = np.where(kind[bi, ai] == 0, rng.uniform(0.0, 0.3, len(r)),
                     rng.uniform(0.1, 0.6, len(r)))
    return np.concatenate([xyz, inten[:, None]], 1)


def sweep(rng, params, n_points: int, cfg) -> np.ndarray:
    lidar = params["lidar"]
    ground_z = -lidar["height_m"]
    returns = _cast(rng, lidar, _facades(rng, params["facades"]))
    extra = _objects(rng, params["objects"], ground_z, cfg.num_classes) \
        + _bushes(rng, params["bushes"], ground_z)
    extra = np.concatenate(extra) if extra else np.zeros((0, 4))
    need = n_points - len(extra)
    if need > len(returns) or need < 0:
        raise ValueError(f"sweep of {n_points} points: {len(returns)} ray "
                         f"returns and {len(extra)} object and bush points")
    keep = rng.permutation(len(returns))[:need]                # dropout
    cloud = np.concatenate([returns[keep], extra])
    cloud[:, 2] += lidar["sensor_z_m"]
    cloud = cloud.astype(np.float32)
    return cloud[rng.permutation(len(cloud))]


def generate(params: dict, seed: int, cfg, tries: int = 20):
    """The cell's sweeps.  A sweep whose occupancy (reference/counts.py)
    would come within ``headroom`` of a cap is drawn again at the same
    size: the detector would drop points, pillars or sets of a capped
    frame without a word."""
    rng = np.random.default_rng(seed)
    lo, hi = params["points"]
    sizes = np.round(np.linspace(lo, hi, params["frames"])).astype(int)
    limit = caps(cfg) * params["headroom"]
    frames = []
    for n in rng.permutation(sizes):
        if n > cfg.max_points:
            raise ValueError(f"a sweep of {n} points exceeds max_points "
                             f"{cfg.max_points}")
        for _ in range(tries):
            buf = np.zeros((cfg.max_points, 4), np.float32)
            buf[:n] = sweep(rng, params, int(n), cfg)
            if np.all(occupancy(buf, n, cfg) < limit):
                break
        else:
            raise ValueError(f"no sweep of {n} points within {limit} in "
                             f"{tries} draws")
        frames.append((buf, int(n)))
    return frames
