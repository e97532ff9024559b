"""The work formulas against counts by hand, and the traffic generators:
every frame of a cell under every cap, and one seed giving the same frames
twice."""

from __future__ import annotations

import math

import numpy as np
import pytest

from benchmark import work
from benchmark.harness import read_json
from benchmark.reference.config import Config
from benchmark.reference.counts import caps, occupancy
from benchmark.traffic import generate


def test_conv_and_resnet_flops_by_hand(tiny_cfg):
    assert work.conv_flops(2, 3, 3, 4, 5) == 2 * 6 * 9 * 4 * 5
    H = W = 48
    by_hand = 0.0
    # stage 0 at 48: conv1 32->128 + 1x1 downsample + conv2, then a unit
    by_hand += 2 * H * W * 9 * 32 * 128 + 2 * H * W * 32 * 128
    by_hand += 2 * H * W * 9 * 128 * 128 * 3
    by_hand += 2 * H * W * 128 * 128                       # lateral k=1
    h = 24
    by_hand += 2 * h * h * 9 * 128 * 128 + 2 * h * h * 128 * 128
    by_hand += 2 * h * h * 9 * 128 * 128 * 5
    by_hand += 2 * H * W * 128 * 128                       # lateral k=2
    h = 12
    by_hand += 2 * h * h * 9 * 128 * 256 + 2 * h * h * 128 * 256
    by_hand += 2 * h * h * 9 * 256 * 256 * 5
    by_hand += 2 * H * W * 256 * 128                       # lateral k=4
    assert work.resnet_flops(tiny_cfg) == by_hand


def test_head_flops_by_hand(tiny_cfg):
    H = W = 48
    shared = 2 * H * W * 9 * 384 * 64
    hm = 2 * H * W * 9 * 64 * 64 + 2 * H * W * 9 * 64 * 3
    full = sum(2 * H * W * 9 * 64 * 64 + 2 * H * W * 9 * 64 * c
               for c in (2, 1, 3, 2, 1))
    lazy = sum(64 * (2 * 81 * 64 * 64 + 2 * 9 * 64 * c)
               for c in (2, 1, 3, 2, 1))
    assert work.head_flops(tiny_cfg, True) == shared + hm + full
    assert work.head_flops(tiny_cfg, False) == shared + hm + lazy


def test_frame_flops_and_the_kernels_bounds_by_hand(tiny_cfg):
    occ = [1000, 300, 40, 25]          # kept, pillars, sets per spec
    C, F, K = 32, 64, 12
    enc = 2 * 300 * (2 * C + C * C + 4 * C * C + 2 * C * F)
    attn = [4 * s * K * K * C for s in (40, 40, 25, 25)]
    vfe = 2 * 1000 * (10 * 16 + 32 * 32)
    fwd = (vfe + work.resnet_flops(tiny_cfg) + work.head_flops(tiny_cfg, False)
           + 4 * enc + sum(attn))
    assert math.isclose(work.frame_flops(tiny_cfg, occ), fwd)
    train = 3 * (fwd - work.head_flops(tiny_cfg, False)
                 + work.head_flops(tiny_cfg, True))
    assert math.isclose(work.frame_flops(tiny_cfg, occ, train=True), train)

    sa = sum(max(s * K * 4 * C * 2 / 3.35e12, 4 * s * K * K * C / 989e12)
             for s in (40, 40, 25, 25))
    assert math.isclose(work.set_attention_seconds(tiny_cfg, occ, 2), sa)
    moved = 3 * 300 * C * 2 + (C * C + 2 * C * F) * 2 + (3 * C + F + 6 * C) * 4
    ep = 4 * max(moved / 3.35e12, 2 * 300 * (C * C + 2 * C * F) / 989e12)
    assert math.isclose(work.encoder_epilogue_seconds(tiny_cfg, occ, 2), ep)


def _cell(name):
    workload = read_json("workloads", f"{name}.json")
    cfg = Config.from_dict(read_json("configs", f"{workload['config']}.json")
                           ["config"])
    return workload["traffic"], cfg


@pytest.mark.parametrize("name", ["nusc-stream", "waymo-stream",
                                  "nusc-sensor-20hz"])
@pytest.mark.parametrize("seed", [7, 4000000019])
def test_every_sweep_stays_under_every_cap(name, seed):
    params, cfg = _cell(name)
    frames = generate(params, seed, cfg)
    assert len(frames) == params["frames"]
    lo, hi = params["points"]
    assert sorted(n for _, n in frames) == sorted(
        np.round(np.linspace(lo, hi, params["frames"])).astype(int).tolist())
    cap = caps(cfg)
    for pts, n in frames:
        assert np.all(occupancy(pts, n, cfg) < cap * params["headroom"])
        assert not pts[n:].any()


@pytest.mark.parametrize("name", ["nusc-stream", "nusc-train-b2"])
def test_one_seed_gives_the_same_frames_twice(name, tiny_cfg):
    from conftest import SCENES, SWEEPS

    params, _ = _cell(name)
    small = {**params, **(SCENES if "train" in name else SWEEPS)}
    a, b = generate(small, 11, tiny_cfg), generate(small, 11, tiny_cfg)
    c = generate(small, 12, tiny_cfg)
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert any(not np.array_equal(x[0], z[0]) for x, z in zip(a, c))


def test_training_scenes_hold_the_same_amount_of_work(tiny_cfg):
    from conftest import SCENES

    params, _ = _cell("nusc-train-b2")
    small = {**params, **SCENES}
    for seed in (1, 2):
        for pts, counts, hm, reg, mask in generate(small, seed, tiny_cfg):
            assert pts.shape[0] == params["batch"]
            want = SCENES["ground_points"] + SCENES["objects"] * \
                SCENES["object_points"]
            assert counts.tolist() == [min(want, tiny_cfg.max_points)] * 2
            assert (hm == 1.0).sum() >= 1 and mask.sum() >= 1
