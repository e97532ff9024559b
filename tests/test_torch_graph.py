"""The port's forward as a CUDA graph takes it, checked on the CPU at the
tiny configuration.

* sync guard: ``runtime.compile.SyncGuard``, a ``TorchDispatchMode``,
  around ``forward(..., with_nms=True)`` and ``with_nms=False`` (fp32 and
  bf16 on the kernel path, and bf16 on the plain path,
  ``use_pallas=False``, which the card runs as PyTorch ops apart from
  nms_peel) records every op that reads a value back to the
  host or has a data-dependent shape (``aten._local_scalar_dense``,
  ``aten.nonzero``, ``aten.masked_select``, a boolean index in
  ``aten.index`` / ``aten.index_put_``) and every tensor made from Python
  or NumPy data (``aten.lift_fresh``: on the card, a copy from the host),
  and there must be none.  The inputs are tensors, as the engine's static
  buffers are.  The kernels' plain versions are exempt: the card runs the
  kernels there, and the plain versions run only on the CPU;
* the voxelizer's edge table, now made by factories on the device, equals
  the JAX package's NumPy table bit for bit;
* the BEV scatter with its dump row equals the JAX package's drop-mode
  ``map_to_bev`` exactly, with invalid pillars present (their coordinates
  collide with valid cells, as the voxelizer leaves them);
* the NMS rounds (kernel nms_peel's plain version) keep exactly the JAX
  ``nms``'s boxes and count on a deep suppression chain, where each box
  overlaps the next and the greedy rounds number half the boxes, and put
  the kept boxes first;
* ``Engine(device="cpu")`` runs the eager forward: the tiny fp32 golden,
  no graph, no launch; the launch accounting of a capture and its replays.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config
from test_golden import GOLDEN_TINY, _assert_boxes

from dsvt_ai_trt_tpu import config as jax_config
from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.ops.bev import map_to_bev as jax_map_to_bev
from dsvt_ai_trt_tpu.ops.nms import nms as jax_nms
from dsvt_ai_trt_tpu.ops.voxelize import cell_edges as jax_cell_edges
from dsvt_ai_trt_tpu_torch import kernels, weights
from dsvt_ai_trt_tpu_torch.model.detector import forward
from dsvt_ai_trt_tpu_torch.ops import nms_peel
from dsvt_ai_trt_tpu_torch.ops.bev import map_to_bev
from dsvt_ai_trt_tpu_torch.ops.layout import to_nchw
from dsvt_ai_trt_tpu_torch.ops.nms import nms
from dsvt_ai_trt_tpu_torch.ops.voxelize import cell_edges
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine, SyncGuard


def _tiny(precision, use_pallas=True):
    cfg = tiny_config()
    cfg = type(cfg)(**{**cfg.__dict__, "precision": precision,
                       "use_pallas": use_pallas})
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    params = weights.from_jax_params(jax_weights.random_params(cfg, 0), "cpu")
    return cfg, params, torch.from_numpy(pts), torch.tensor(int(n),
                                                            dtype=torch.int32)


@pytest.mark.parametrize("with_nms", [True, False])
@pytest.mark.parametrize("precision,use_pallas", [
    ("fp32", True), ("bf16", True), ("bf16", False)])
def test_forward_reads_nothing_back(precision, use_pallas, with_nms):
    cfg, params, pts, n = _tiny(precision, use_pallas)
    ref = forward(params, pts, n, cfg, with_nms, device="cpu")
    guard = SyncGuard()
    with guard.plain_versions_exempt(), guard:
        got = forward(params, pts, n, cfg, with_nms, device="cpu")
    assert guard.hits == []
    assert int(got.count) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_guard_sees_what_a_graph_cannot_capture():
    """The guard flags a host read, a boolean index and host data, also
    inside inference mode (where ``forward`` runs and a read reaches the
    dispatcher as ``item`` / ``is_nonzero``), and passes its exempt
    region."""
    guard = SyncGuard()
    x = torch.arange(6.0)
    with guard:
        bool(x.sum() > 3)
        x[x > 2]
        torch.tensor([1.0, 2.0])
        with guard.exempt():
            x.max().item()
        with torch.inference_mode():
            float(x.sum())
            bool(x.sum() > 3)
    assert [h.split(" ")[0] for h in guard.hits] == [
        "aten._local_scalar_dense.default", "aten.index.Tensor",
        "aten.lift_fresh.default", "aten.item.default",
        "aten.is_nonzero.default"]


@pytest.mark.parametrize("cfg", [jax_config.DEFAULT_CONFIG,
                                 jax_config.WAYMO_CONFIG, tiny_config()],
                         ids=["default", "waymo", "tiny"])
def test_edge_table_made_on_the_device_equals_jax(cfg):
    for vmin, size, n in zip(cfg.pc_range_min, cfg.voxel_size,
                             cfg.grid_size):
        np.testing.assert_array_equal(cell_edges(vmin, size, n, "cpu").numpy(),
                                      jax_cell_edges(vmin, size, n))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bev_scatter_matches_jax_drop_mode(dtype):
    rng = np.random.default_rng(7)
    H, W, C, P, live = 24, 20, 8, 64, 41
    cells = np.sort(rng.choice(H * W, live, replace=False))
    coords = np.zeros((P, 2), np.int64)           # invalid rows: (0, 0)
    coords[:live] = np.stack([cells // W, cells % W], axis=1)
    coords[live] = coords[0]     # a valid cell that an invalid row shares
    valid = np.arange(P) < live
    feats = rng.normal(size=(P, C)).astype(np.float32)
    feats_t = torch.from_numpy(feats).to(dtype)
    ref = np.asarray(jax_map_to_bev(jnp.asarray(feats_t.float().numpy()),
                                    jnp.asarray(coords, jnp.int32),
                                    jnp.asarray(valid), (H, W)))
    got = map_to_bev(feats_t, torch.from_numpy(coords),
                     torch.from_numpy(valid), (H, W))
    assert got.shape == (H, W, C) and got.dtype == dtype
    np.testing.assert_array_equal(got.float().numpy(), ref)
    assert got.is_contiguous()
    # the strides the bf16 conv sees: channels_last, batch stride included
    # (is_contiguous(memory_format=...) skips size-1 dimensions)
    x = to_nchw(got)
    assert x.stride() == (H * W * C, 1, W * C, C)
    assert x.data_ptr() == got.data_ptr()       # a view: no copy


def _chain(n, spacing=0.9, length=4.0):
    """Score-sorted boxes in a row along x, each overlapping the next by
    (1 - spacing) of its length and no other."""
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = np.arange(n) * spacing * length
    boxes[:, 3] = 2.0                        # dim0: local y extent
    boxes[:, 4] = length                     # dim1: local x extent
    boxes[:, 5] = 1.5
    boxes[:, 8] = np.linspace(0.99, 0.3, n)
    return boxes


@pytest.mark.parametrize("count", [200, 157])
def test_nms_deep_chain_matches_jax(count):
    boxes = _chain(200)
    boxes[count:] = 0
    ref_boxes, ref_count = jax_nms(jnp.asarray(boxes), jnp.int32(count),
                                   0.01, use_pallas=False)
    got_boxes, got_count = nms(torch.from_numpy(boxes), count, 0.01,
                               use_kernels=True)
    assert int(got_count) == int(ref_count) == (count + 1) // 2
    np.testing.assert_array_equal(got_boxes.numpy(), np.asarray(ref_boxes))


def test_nms_peel_plain_rounds_on_a_chain():
    """Every other box of a chain is kept: the first promotes, suppresses
    the second, and so on, one pair a round.  The kept boxes come first in
    index order, then zero rows; the lower triangle is never read."""
    K = 300
    boxes = torch.zeros(K, 9)
    boxes[:, 0] = torch.arange(K)             # the row, to read the order
    boxes[:, 3] = boxes[:, 4] = 1.0           # unit areas
    overlap = torch.zeros(K, K)
    i = torch.arange(K - 1)
    overlap[i, i + 1] = overlap[i + 1, i] = 0.5   # IoU 1/3 with the next
    out, count = nms_peel.nms_peel(overlap, boxes, torch.tensor(K), 0.01)
    assert count.dtype == torch.int64 and int(count) == K // 2
    assert torch.equal(out[:K // 2], boxes[::2])
    assert not out[K // 2:].any()
    out, count = nms_peel.nms_peel(overlap, boxes, 7, 0.01)  # rows past the
    assert out[:int(count), 0].tolist() == [0, 2, 4, 6]      # count: dropped
    assert not out[int(count):].any()


def test_nms_peel_cuda_checks_arguments_first():
    before = kernels.counts()
    boxes, overlap = torch.zeros(4, 9), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="f32 boxes"):
        nms_peel.nms_peel_cuda(overlap, boxes.double(), 4, 0.01)
    with pytest.raises(ValueError, match="f32 overlap"):
        nms_peel.nms_peel_cuda(overlap.bool(), boxes, 4, 0.01)
    with pytest.raises(ValueError, match="K <= 1024"):
        nms_peel.nms_peel_cuda(torch.zeros(1025, 1025), torch.zeros(1025, 9),
                               4, 0.01)
    with pytest.raises(ValueError, match="CUDA"):
        nms_peel.nms_peel_cuda(overlap, boxes, 4, 0.01)
    assert kernels.counts() == before


def test_cpu_engine_runs_the_eager_forward():
    from test_torch_runtime import tiny_config as port_tiny_config
    cfg = port_tiny_config()
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    kernels.reset_counts()
    engine = Engine(jax_weights.random_params(cfg, 0), cfg,
                    device="cpu").warmup()
    dets = engine(pts, n)
    with open(GOLDEN_TINY) as f:
        ref = json.load(f)
    assert int(dets.count) == ref["count"]
    _assert_boxes(dets.boxes[:int(dets.count)].numpy(), ref["boxes"])
    eager = engine.eager(torch.from_numpy(pts), torch.tensor(int(n)))
    for a, b in zip(dets, eager):
        assert torch.equal(a, b)
    assert engine._graph is None and engine.graph_launches == {}
    assert kernels.counts() == {name: 0 for name in kernels.SPECS}


def test_capture_counts_its_launches_once_per_replay():
    kernels.reset_counts()
    kernels.count("segment_max")
    with kernels.captured() as launches:
        kernels.count("set_attention")
        kernels.count("set_attention")
        kernels.count("nms_peel")
    assert launches["set_attention"] == 2 and launches["nms_peel"] == 1
    assert kernels.counts() == {**{k: 0 for k in kernels.SPECS},
                                "segment_max": 1}
    for _ in range(3):
        kernels.replayed(launches)
    got = kernels.counts()
    assert (got["segment_max"], got["set_attention"], got["nms_peel"]) == (
        1, 6, 3)
    with pytest.raises(RuntimeError), kernels.captured():   # a failed
        kernels.count("segment_max")                        # capture
        raise RuntimeError("capture failed")
    assert kernels.counts() == got
    kernels.reset_counts()
