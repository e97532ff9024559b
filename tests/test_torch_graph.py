"""The port's forward as a CUDA graph takes it, checked on the CPU at the
tiny configuration.

* sync guard: a ``TorchDispatchMode`` around ``forward(..., with_nms=True)``
  and ``with_nms=False`` (fp32 and bf16 on the kernel path, and bf16 on
  the plain path, ``use_pallas=False``, which the card runs as PyTorch ops
  apart from nms_peel) records every op that reads a value back to the
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
* the NMS rounds (the plain loop behind kernel nms_peel) keep exactly the
  JAX ``nms``'s boxes and count on a deep suppression chain, where each box
  overlaps the next and the greedy rounds number half the boxes;
* ``Engine(device="cpu")`` runs the eager forward: the tiny fp32 golden,
  no graph, no launch; the launch accounting of a capture and its replays.
"""

import contextlib
import json
import traceback

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from conftest import make_cloud, tiny_config
from test_golden import GOLDEN_TINY, _assert_boxes

from dsvt_ai_trt_tpu import config as jax_config
from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.ops.bev import map_to_bev as jax_map_to_bev
from dsvt_ai_trt_tpu.ops.nms import nms as jax_nms
from dsvt_ai_trt_tpu.ops.voxelize import cell_edges as jax_cell_edges
from dsvt_ai_trt_tpu_torch import kernels, weights
from dsvt_ai_trt_tpu_torch.model.detector import forward
from dsvt_ai_trt_tpu_torch.ops import (attention_kernel, encoder_kernel,
                                       nms_kernel, nms_peel, segment)
from dsvt_ai_trt_tpu_torch.ops.bev import map_to_bev
from dsvt_ai_trt_tpu_torch.ops.nms import nms
from dsvt_ai_trt_tpu_torch.ops.voxelize import cell_edges
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

aten = torch.ops.aten
HOST_READS = {aten._local_scalar_dense.default: "reads a value on the host",
              aten.nonzero.default: "has a data-dependent shape",
              aten.masked_select.default: "has a data-dependent shape",
              aten.lift_fresh.default: "makes a tensor from host data",
              aten.lift_fresh_copy.default: "makes a tensor from host data"}
INDEXING = (aten.index.Tensor, aten.index_put_.default, aten.index_put.default,
            aten._index_put_impl_.default)
PLAIN_VERSIONS = ((segment, "segmented_max_plain"),
                  (attention_kernel, "set_attention_plain"),
                  (encoder_kernel, "encoder_epilogue_plain"),
                  (nms_kernel, "pairwise_overlap_clip"),
                  (nms_peel, "nms_peel_plain"))


class SyncGuard(TorchDispatchMode):
    """Records each op that a CUDA graph cannot capture (module docstring),
    with the port's frames of the Python stack, outside ``exempt``."""

    def __init__(self):
        super().__init__()
        self.hits = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        why = HOST_READS.get(func)
        if why is None and func in INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            why = "indexes by a boolean mask"
        if why and not self.paused:
            where = [line.strip() for line in traceback.format_stack()
                     if "dsvt_ai_trt_tpu_torch" in line]
            self.hits.append(f"{func} {why} at {where[-1:]}")
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def exempt(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1


def _exempt_plain_versions(monkeypatch, guard):
    for module, name in PLAIN_VERSIONS:
        plain = getattr(module, name)

        def wrapped(*args, _plain=plain, **kw):
            with guard.exempt():
                return _plain(*args, **kw)
        monkeypatch.setattr(module, name, wrapped)


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
def test_forward_reads_nothing_back(monkeypatch, precision, use_pallas,
                                    with_nms):
    cfg, params, pts, n = _tiny(precision, use_pallas)
    ref = forward(params, pts, n, cfg, with_nms, device="cpu")
    guard = SyncGuard()
    _exempt_plain_versions(monkeypatch, guard)
    with guard:
        got = forward(params, pts, n, cfg, with_nms, device="cpu")
    assert guard.hits == []
    assert int(got.count) > 0
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_guard_sees_what_a_graph_cannot_capture():
    """The guard flags a host read, a boolean index and host data, and
    passes its exempt region."""
    guard = SyncGuard()
    x = torch.arange(6.0)
    with guard:
        bool(x.sum() > 3)
        x[x > 2]
        torch.tensor([1.0, 2.0])
        with guard.exempt():
            x.max().item()
    assert [h.split(" ")[0] for h in guard.hits] == [
        "aten._local_scalar_dense.default", "aten.index.Tensor",
        "aten.lift_fresh.default"]


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
    assert got.is_contiguous()      # the channels_last conv input, no copy
    assert got.permute(2, 0, 1).unsqueeze(0).is_contiguous(
        memory_format=torch.channels_last)


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
    the second, and so on, one pair a round."""
    K = 300
    sup = torch.zeros(K, K, dtype=torch.bool)
    sup[torch.arange(K - 1), torch.arange(1, K)] = True
    kept, count = nms_peel.nms_peel(sup, torch.tensor(K))
    assert torch.equal(kept, torch.arange(K) % 2 == 0)
    assert count.dtype == torch.int64 and int(count) == K // 2
    kept, count = nms_peel.nms_peel(sup, 7)   # rows past the count: dropped
    assert kept.nonzero().flatten().tolist() == [0, 2, 4, 6]


def test_nms_peel_cuda_checks_arguments_first():
    before = kernels.counts()
    with pytest.raises(ValueError, match="bool"):
        nms_peel.nms_peel_cuda(torch.zeros(4, 4), 4)
    with pytest.raises(ValueError, match="K <= 1024"):
        nms_peel.nms_peel_cuda(torch.zeros(1025, 1025, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="CUDA"):
        nms_peel.nms_peel_cuda(torch.zeros(4, 4, dtype=torch.bool), 4)
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
