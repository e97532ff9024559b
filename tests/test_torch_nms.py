"""Kernel B4's plain version vs the JAX Pallas overlap, and rotated NMS.

The same score-sorted boxes go through ``nms_pallas.pairwise_overlap_pallas
(..., interpret=True)`` and the port's ``pairwise_overlap_clip`` (the plain
version of B4): equal on the strict upper triangle at atol 1e-4 (the
kernel's contract; both run the same clip in f32).  The port's clip also
equals the JAX clip on every entry, and the port's NMS keeps exactly the
JAX NMS's boxes and count: through kernel nms_peel's plain version (the
IoU, the rounds and the compaction after the overlap) bit for bit, on
seeded boxes and on a 300-box suppression chain, at counts 0, 7 and K.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from dsvt_ai_trt_tpu.ops.nms import box_corners as jax_box_corners
from dsvt_ai_trt_tpu.ops.nms import nms as jax_nms
from dsvt_ai_trt_tpu.ops.nms import pairwise_overlap_clip as jax_clip
from dsvt_ai_trt_tpu.ops.nms_pallas import pairwise_overlap_pallas
from dsvt_ai_trt_tpu_torch import kernels
from dsvt_ai_trt_tpu_torch.ops import nms_kernel
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


def _chain(n, spacing=0.9, length=4.0):
    """Score-sorted boxes in a row along x, each overlapping the next by
    (1 - spacing) of its length and no other: n / 2 peeling rounds."""
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = np.arange(n) * spacing * length
    boxes[:, 3], boxes[:, 4], boxes[:, 5] = 2.0, length, 1.5
    boxes[:, 8] = np.linspace(0.99, 0.3, n)
    return boxes


@pytest.mark.parametrize("count", ["0", "7", "K"])
@pytest.mark.parametrize("which", ["seeded", "chain"])
def test_nms_peel_plain_matches_jax(which, count):
    """``ops/nms.py:nms`` on the CPU (the plain overlap, then nms_peel's
    plain version) against the JAX ``nms`` (``use_pallas=False``): boxes
    bit-equal, the same count.  Rows past the count keep their values: they
    must neither be kept nor suppress."""
    boxes = (_random_boxes(np.random.default_rng(5), 64) if which == "seeded"
             else _chain(300))
    K = len(boxes)
    n = {"0": 0, "7": 7, "K": K}[count]
    ref_boxes, ref_count = jax_nms(jnp.asarray(boxes), jnp.int32(n), 0.01,
                                   use_pallas=False)
    got_boxes, got_count = nms(torch.from_numpy(boxes), torch.tensor(n),
                               0.01, use_kernels=False)
    assert got_count.dtype == torch.int64
    assert int(got_count) == int(ref_count)
    if which == "chain":
        assert int(got_count) == (n + 1) // 2
    elif n == K:
        assert 0 < int(got_count) < n           # something was suppressed
    assert (int(got_count) == 0) == (n == 0)
    np.testing.assert_array_equal(got_boxes.numpy().view(np.uint32),
                                  np.asarray(ref_boxes).view(np.uint32))


@pytest.mark.parametrize("boxes,match", [
    (torch.zeros(5, 6), r"\[N, >=7\]"),                 # too narrow
    (torch.zeros(5, 9, dtype=torch.float64), "f32"),
    (torch.zeros(5, 9), "CUDA device"),                    # on the CPU
])
def test_pairwise_overlap_cuda_checks_arguments_first(boxes, match):
    """Kernel B4's wrapper refuses what its kernel does not take with
    ValueError, before it builds or launches anything."""
    before = kernels.counts()
    with pytest.raises(ValueError, match=match):
        nms_kernel.pairwise_overlap_cuda(boxes)
    assert kernels.counts() == before
