"""The port's ``eval.coverage`` against the JAX package's.

The port clips a query only against the same-class pool boxes whose BEV
circumcircles meet its own (centre distance <= the two half-diagonals +
1e-3); the JAX package clips every same-class pair.  A pair farther apart
overlaps nowhere, and an IoU of 0 never beats the threshold, so the two
must return the same dict.  Held on random and clustered boxes, and on
pairs placed corner to corner along the line of their centres, the pairs
that overlap at the largest distance: just inside the circumcircle
distance they overlap in a small square at the corners, just outside not
at all.  Thresholds 0.5 and 0.1, and 0.0, where any overlap covers.
"""

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from dsvt_ai_trt_tpu.eval import coverage as jax_coverage
from dsvt_ai_trt_tpu_torch.eval import coverage
from dsvt_ai_trt_tpu_torch.io.host_nms import _corners


def _random(rng, n, spread, classes=3):
    b = np.zeros((n, 9), np.float32)
    b[:, :2] = rng.uniform(-spread, spread, (n, 2))
    b[:, 2] = rng.uniform(-1, 1, n)
    b[:, 3:6] = rng.uniform(0.5, 5.0, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    b[:, 7] = rng.integers(0, classes, n)
    b[:, 8] = rng.uniform(0, 1, n)
    return b


def _jittered(rng, boxes, xy, heading):
    out = boxes.copy()
    out[:, :2] += rng.normal(0, xy, (len(boxes), 2))
    out[:, 6] += rng.normal(0, heading, len(boxes))
    out[:, 8] = rng.uniform(0, 1, len(boxes))
    return out


def _corner_pairs(delta, y, n=20):
    """n pairs of one class and heading, the second box 0.5-2x the first,
    placed so that the first's corner and the second's opposite corner
    lie on the line of centres at centre distance r_q + r_p - delta; the
    pairs 40 m apart along x at ``y``, so no box meets another pair's.
    Float64, so that the clip resolves the corner squares far from the
    origin."""
    rng = np.random.default_rng(5)
    queries, pool = [], []
    for i in range(n):
        dx, dy = rng.uniform(1.0, 4.0, 2)
        scale, heading = rng.uniform(0.5, 2.0), rng.uniform(-np.pi, np.pi)
        q = np.array([40.0 * i, y, 0.0, dx, dy, 1.5, heading, 1.0, 0.9],
                     np.float64)
        r_q, r_p = 0.5 * np.hypot(dx, dy), 0.5 * scale * np.hypot(dx, dy)
        corner = _corners(q[None])[0][2] - q[:2]
        p = q.copy()
        p[:2] += corner / np.linalg.norm(corner) * (r_q + r_p - delta)
        p[3:5] *= scale
        p[8] = 0.8
        queries.append(q)
        pool.append(p)
    return np.asarray(queries), np.asarray(pool)


def _case(name):
    rng = np.random.default_rng(11)
    if name == "random":
        q = _random(rng, 120, 30.0)
        return q, np.concatenate([_jittered(rng, q[:80], 0.4, 0.1),
                                  _random(rng, 60, 30.0)])
    if name == "clustered":          # near-duplicates around a few centres
        centres = _random(rng, 8, 25.0)
        q = _jittered(rng, np.repeat(centres, 15, axis=0), 0.3, 0.15)
        return q, _jittered(rng, q, 0.3, 0.15)
    delta = {"corners_inside": (0.05, 0.01),
             "corners_outside": (-0.01, -0.05)}[name]
    parts = [_corner_pairs(d, 40.0 * i) for i, d in enumerate(delta)]
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


@pytest.mark.parametrize("threshold", [0.5, 0.1, 0.0])
@pytest.mark.parametrize("case", ["random", "clustered", "corners_inside",
                                  "corners_outside"])
def test_coverage_equals_jax_all_pairs(case, threshold):
    queries, pool = _case(case)
    got = coverage(queries, pool, threshold)
    assert got == jax_coverage(queries, pool, threshold)
    if case.startswith("corners") and threshold == 0.0:
        # the corner pairs just inside overlap, those just outside do not
        inside = case == "corners_inside"
        assert got["covered"] == (len(queries) if inside else 0), got
    if case == "random":
        assert 0 < got["covered"] < got["n"], got     # the gate has work
