"""Kernel B4's plain version vs the JAX Pallas overlap, and rotated NMS.

The same score-sorted boxes go through ``nms_pallas.pairwise_overlap_pallas
(..., interpret=True)`` and the port's ``pairwise_overlap_clip`` (the plain
version of B4): equal on the strict upper triangle at atol 1e-4 (the
kernel's contract; both run the same clip in f32).  The port's clip also
equals the JAX clip on every entry, and the port's NMS keeps exactly the
JAX NMS's boxes and count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dsvt_ai_trt_tpu.ops.nms import box_corners as jax_box_corners
from dsvt_ai_trt_tpu.ops.nms import nms as jax_nms
from dsvt_ai_trt_tpu.ops.nms import pairwise_overlap_clip as jax_clip
from dsvt_ai_trt_tpu.ops.nms_pallas import pairwise_overlap_pallas
from dsvt_ai_trt_tpu_torch.ops.nms import box_corners, nms, pairwise_overlap_clip


def _random_boxes(rng, n, clusters=True):
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = rng.uniform(-20, 20, n)
    boxes[:, 1] = rng.uniform(-20, 20, n)
    boxes[:, 2] = rng.uniform(-2, 2, n)
    boxes[:, 3] = rng.uniform(0.5, 6, n)
    boxes[:, 4] = rng.uniform(0.5, 3, n)
    boxes[:, 5] = rng.uniform(0.5, 3, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 7] = rng.integers(0, 3, n)
    boxes[:, 8] = np.sort(rng.uniform(0.3, 1.0, n))[::-1]
    if clusters:
        for c in range(0, n - 4, 5):
            boxes[c + 1:c + 4, :2] = boxes[c, :2] + rng.uniform(-0.6, 0.6, (3, 2))
            boxes[c + 1, 6] = boxes[c, 6] + 0.3
    return boxes


def test_plain_overlap_matches_pallas():
    n = 24
    boxes = _random_boxes(np.random.default_rng(2), n)
    boxes[5] = boxes[4]                  # identical pair: full overlap
    ref = np.asarray(pairwise_overlap_pallas(jnp.asarray(boxes),
                                             interpret=True))
    got = pairwise_overlap_clip(torch.from_numpy(boxes)).numpy()
    iu = np.triu_indices(n, 1)
    np.testing.assert_allclose(got[iu], ref[iu], atol=1e-4, rtol=1e-4)
    assert np.count_nonzero(ref[iu] > 0) >= 10   # the clusters overlap
    area = boxes[4, 3] * boxes[4, 4]
    assert abs(got[4, 5] - area) / area < 1e-5


def test_plain_overlap_matches_jax_clip_everywhere():
    boxes = _random_boxes(np.random.default_rng(3), 32)
    ref = np.asarray(jax.jit(jax_clip)(jnp.asarray(boxes)))
    got = pairwise_overlap_clip(torch.from_numpy(boxes)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(box_corners(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jax_box_corners(jnp.asarray(boxes))),
                               atol=1e-6)


def test_nms_kept_set_matches_jax():
    rng = np.random.default_rng(4)
    n = 40
    boxes = _random_boxes(rng, n)
    count = n - 3
    boxes[count:] = 0
    ref_boxes, ref_count = jax_nms(jnp.asarray(boxes), jnp.int32(count), 0.01,
                                   use_pallas=False)
    got_boxes, got_count = nms(torch.from_numpy(boxes), count, 0.01,
                               use_kernels=True)
    assert int(got_count) == int(ref_count)
    assert int(got_count) < count          # something was suppressed
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(ref_boxes))
    # forcing the plain overlap gives the same kept set
    plain_boxes, plain_count = nms(torch.from_numpy(boxes), count, 0.01,
                                   use_kernels=False)
    assert int(plain_count) == int(got_count)
    assert torch.equal(plain_boxes, got_boxes)
