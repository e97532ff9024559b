"""The frozen reference is the port's semantics: at the tiny configuration
on the CPU its voxelize and partitions equal the port's plain path bit for
bit, and its boxes and its training loss equal the port's float32 ones to
the goldens' 1e-4.  The reference imports nothing of the port; these
tests do, to hold the copy to it."""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

from benchmark.reference import detector, train
from benchmark.reference import weights as ref_weights
from benchmark.traffic import generate

from conftest import SCENES, SWEEPS, tiny


def _port_cfg(tiny_cfg, precision="fp32", config="dsvt-nuscenes"):
    from benchmark.harness import read_json
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig

    raw = read_json("configs", f"{config}.json")["config"]
    return dataclasses.replace(
        DSVTConfig.from_json(json.dumps({**raw, **tiny(raw)})),
        precision=precision)


def _frames(cfg, seed=3):
    return generate({"kind": "sweeps", "headroom": 0.95, **SWEEPS}, seed, cfg)


@pytest.mark.parametrize("config", ["dsvt-nuscenes", "dsvt-waymo"])
@pytest.mark.parametrize("frame", range(4))
def test_voxelize_and_partition_equal_the_port(config, frame):
    from benchmark.harness import read_json
    from benchmark.reference.config import Config
    from dsvt_ai_trt_tpu_torch.ops.voxelize import voxelize
    from dsvt_ai_trt_tpu_torch.ops.windows import partition

    raw = read_json("configs", f"{config}.json")["config"]
    tiny_cfg = Config.from_dict({**raw, **tiny(raw)})
    cfg = _port_cfg(tiny_cfg, config=config)
    pts, n = _frames(tiny_cfg)[frame]
    mine = detector.voxelize(torch.from_numpy(pts), n, tiny_cfg)
    port = voxelize(torch.from_numpy(pts), n, cfg)
    for field in ("point_feats", "point_pillar", "point_valid", "coords",
                  "pillar_valid", "pillar_count", "point_count"):
        assert torch.equal(getattr(mine, field), getattr(port, field)), field
    for spec, pspec in zip(tiny_cfg.window_specs, cfg.window_specs):
        sets = detector.partition(mine.coords, mine.pillar_valid, spec,
                                  tiny_cfg)
        wp, sp = partition(port.coords, port.pillar_valid, pspec, cfg)
        assert torch.equal(sets.xy, wp.xy_centered)
        for field in ("inds", "key_mask", "set_count", "canon"):
            assert torch.equal(getattr(sets, field), getattr(sp, field)), field


def test_occupancy_counts_equal_the_reference(tiny_cfg):
    from benchmark.reference.counts import occupancy

    for pts, n in _frames(tiny_cfg, seed=4):
        pl, sets = detector.integer_stages(torch.from_numpy(pts), n, tiny_cfg)
        np.testing.assert_array_equal(occupancy(pts, n, tiny_cfg),
                                      detector.occupancy(pl, sets))


@pytest.mark.parametrize("seed", [1, 2])
def test_boxes_equal_the_port_at_fp32(tiny_cfg, seed):
    from dsvt_ai_trt_tpu_torch.model.detector import forward
    from dsvt_ai_trt_tpu_torch.weights import from_jax_params, prepare_params

    cfg = _port_cfg(tiny_cfg)
    raw = ref_weights.seeded_raw(tiny_cfg, seed, "cpu")
    frames = _frames(tiny_cfg, seed)
    folded = ref_weights.fold(raw, tiny_cfg)
    ref_weights.calibrate_heatmap(
        raw, [detector.heatmap(folded, torch.from_numpy(p), n, tiny_cfg)
              for p, n in frames], 10, tiny_cfg.top_k)
    params = ref_weights.fold(raw, tiny_cfg)
    port = from_jax_params(prepare_params(ref_weights.to_numpy(raw), cfg),
                           "cpu")
    boxes_seen = 0
    for pts, n in frames:
        mine, occ, _ = detector.detect(params, torch.from_numpy(pts), n,
                                       tiny_cfg)
        dets = forward(port, pts, n, cfg, with_nms=True, device="cpu")
        theirs = dets.boxes[:int(dets.count)].numpy()
        np.testing.assert_array_equal(occ, dets.occupancy.numpy())
        assert theirs.shape == mine.shape
        np.testing.assert_allclose(theirs, mine, atol=1e-4, rtol=1e-4)
        boxes_seen += len(mine)
    assert boxes_seen > 0


def test_training_loss_equals_the_port_at_fp32(tiny_cfg):
    from dsvt_ai_trt_tpu_torch.parallel.training import Targets, batched_loss
    from dsvt_ai_trt_tpu_torch.weights import from_jax_params, prepare_params

    cfg = _port_cfg(tiny_cfg)
    batch = generate({"kind": "scenes", "batch": 2, **SCENES}, 9,
                     tiny_cfg)[0]
    raw = ref_weights.seeded_raw(tiny_cfg, 9, "cpu")
    tensors = [torch.from_numpy(a) for a in batch]
    mine = train.batch_loss(ref_weights.fold(raw, tiny_cfg), tensors,
                            tiny_cfg, lambda t: t.float())
    port = from_jax_params(prepare_params(ref_weights.to_numpy(raw), cfg),
                           "cpu")
    theirs = batched_loss(port, tensors[0], tensors[1],
                          Targets(*tensors[2:]), cfg, remat=False,
                          device="cpu")
    np.testing.assert_allclose(float(theirs), float(mine), rtol=1e-4)


def test_nms_keeps_what_greedy_suppression_keeps():
    from benchmark.reference.nms import greedy_nms

    # three boxes in score order: 0 and 1 overlap, 2 stands alone
    boxes = np.array([[0, 0, 0, 4, 2, 1, 0, 0, .9],
                      [1, 0, 0, 4, 2, 1, 0, 0, .8],
                      [10, 0, 0, 4, 2, 1, 0, 0, .7]], np.float64)
    np.testing.assert_array_equal(greedy_nms(boxes, 0.01), [0, 2])
    # corners touching at a point only: no area, both kept
    far = boxes.copy()
    far[1, 1] = 4.0     # dx 4 along local y, half extent 2: edges meet
    np.testing.assert_array_equal(greedy_nms(far, 0.01), [0, 1, 2])
