"""Kernel ``voxel_segments`` (the voxelizer's cap and pillars) against the
plain voxelize on the card: every field of ``Pillars`` bit-equal, and the
cap's keys equal to ``cap_keys_plain``'s.

The streams: clouds laid out pillar by pillar at each served
configuration's caps (``dsvt-nuscenes`` 50k / 30k points, ``dsvt-waymo``
200k / 140k, ``dsvt-voxel-waymo`` 200k / 200k on 3-D cells), with pillars
of exactly the cap and one over it, one cell of 500 points (an over-cap
run on the full stream), every point in one cell, single-point pillars,
no points, pillars that straddle the kernel's tile edges, and more
pillars than ``max_pillars``; then the stream cells' first sweeps, and a
``dsvt-nuscenes`` engine whose replay equals its eager frame with two
``voxel_segments`` launches a frame.

Marked ``cuda``; each test skips (from a fixture) where no card is present.
Run on a machine with a card, without the JAX-loading conftest:

    python -m pytest tests/test_torch_voxelize_cuda.py --noconftest -q

No tolerance: the kernel forms every sum, quotient and centre as the plain
version does.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsvt_ai_trt_tpu_torch import kernels, weights          # noqa: E402
from dsvt_ai_trt_tpu_torch.config import DSVTConfig         # noqa: E402
from dsvt_ai_trt_tpu_torch.ops import voxelize as vox       # noqa: E402
from dsvt_ai_trt_tpu_torch.ops import voxelize_kernel as vk  # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine    # noqa: E402

pytestmark = pytest.mark.cuda
CONFIGS = ("dsvt-nuscenes", "dsvt-waymo", "dsvt-voxel-waymo")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _config(name, precision="bf16"):
    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        raw = json.load(f)["config"]
    return raw, DSVTConfig.from_json(json.dumps({**raw,
                                                 "precision": precision}))


def _cloud(cfg, counts, seed):
    """``counts[k]`` points in the k-th of len(counts) cells drawn at random
    and taken in ascending cell order (so pillar k of the stream holds
    min(counts[k], cap) rows), the points shuffled into file order and cut
    to ``max_points``; and the points each pillar keeps under the cap."""
    rng = np.random.default_rng(seed)
    gx, gy, gz = cfg.grid_size
    cells = np.sort(rng.choice(gx * gy * gz, len(counts), replace=False))
    vsize = np.array(cfg.voxel_size)
    vmin = np.array(cfg.pc_range_min)
    idx = np.repeat(cells, counts)
    ijk = np.stack([idx % gx, (idx // gx) % gy, idx // (gx * gy)], 1)
    xyz = vmin + (ijk + rng.uniform(0.1, 0.9, (len(idx), 3))) * vsize
    cloud = np.concatenate([xyz, rng.uniform(0, 1, (len(idx), 1))], 1)
    order = rng.permutation(len(idx))[:cfg.max_points]
    buf = np.zeros((cfg.max_points, 4), np.float32)
    buf[:len(order)] = cloud[order]
    held = np.unique(idx[order], return_counts=True)[1]
    return buf, len(order), np.minimum(held, cfg.max_points_per_pillar)


def _counts(case, cfg, rng):
    cap, P = cfg.max_points_per_pillar, cfg.max_pillars
    if case == "caps":            # the full stream and the compacted cap
        return rng.integers(1, cap + 17, cfg.max_points // (cap // 2))
    if case == "cap_and_one_over":
        rows = min(cfg.max_kept_points, cfg.max_points - 1)
        return [cap, cap + 1] * (rows // (2 * cap + 1))
    if case == "cell_of_500":
        return [*rng.integers(1, cap, 300), 500, *rng.integers(1, cap, 300)]
    if case == "one_cell":
        return [cfg.max_points]
    if case == "single_points":
        return [1] * 2000
    if case == "no_points":
        return []
    if case == "tile_edges":      # heads on, before and after each edge
        return [n for shift in range(0, 2 * vk.TILE, 7)
                for n in [1] * (shift % 64) + [cap] * 4 + [cap + 1, 2]]
    if case == "over_max_pillars":
        return [1] * (P + 100) + [3] * 50
    raise KeyError(case)


CASES = ("caps", "cap_and_one_over", "cell_of_500", "one_cell",
         "single_points", "no_points", "tile_edges", "over_max_pillars")


def _same(cfg, pts, n, dev):
    """Kernel and plain voxelize on the card: every field bit-equal, two
    launches; the cap's keys equal the plain version's.  Returns the
    kernel's Pillars."""
    points = torch.from_numpy(pts).to(dev)
    num = torch.tensor(n, device=dev)
    s_cell, _ = vox.sort_cells(points, num, cfg)
    assert torch.equal(vk.cap_keys_cuda(s_cell, cfg),
                       vox.cap_keys_plain(s_cell, cfg))
    kernels.reset_counts()
    got = vox.voxelize(points, num, cfg, use_kernels=True)
    assert kernels.counts()["voxel_segments"] == 2
    want = vox.voxelize(points, num, cfg, use_kernels=False)
    assert kernels.counts()["voxel_segments"] == 2
    for field in want._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field
    return got


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name", CONFIGS)
def test_voxel_segments_equal_plain(dev, name, case):
    _, cfg = _config(name)
    counts = _counts(case, cfg, np.random.default_rng(len(case)))
    pts, n, held = _cloud(cfg, counts, seed=sum(map(ord, name + case)))
    got = _same(cfg, pts, n, dev)
    cap = cfg.max_points_per_pillar
    kept, pillars = int(got.point_count), int(got.pillar_count)
    if case == "no_points":
        assert kept == 0 and pillars == 0
    if case == "one_cell":
        assert kept == cap and pillars == 1
    if case == "cap_and_one_over":
        assert int(got.num_points.max()) == cap and kept == pillars * cap
    if case == "over_max_pillars":
        assert pillars == cfg.max_pillars and kept == cfg.max_pillars
    if case == "caps":       # the compacted cap binds where it is short
        assert kept == min(cfg.max_kept_points, held.sum())
    if case in ("cell_of_500", "single_points", "tile_edges"):
        assert kept == held.sum() and pillars == len(held)


def test_cap_keys_on_one_cell_of_500(dev):
    """Phase 0 alone on a hand-made sorted stream: a 500-row run, runs of
    the cap and one over it, and the sentinel tail."""
    _, cfg = _config("dsvt-waymo")
    cap, sentinel = cfg.max_points_per_pillar, vox.sentinel_cell(cfg)
    runs = [(3, 500), (7, cap), (9, cap + 1), (11, 1), (sentinel, 1000)]
    s_cell = torch.cat([torch.full((k,), c, dtype=torch.int64)
                        for c, k in runs]).to(dev)
    got = vk.cap_keys_cuda(s_cell, cfg)
    assert torch.equal(got, vox.cap_keys_plain(s_cell, cfg))
    assert int((got == 3).sum()) == cap and int((got == 9).sum()) == cap


def _first_sweep(cell):
    from benchmark.reference import voxel as ref_voxel
    from benchmark.reference.config import Config
    from benchmark.traffic import generate

    with open(os.path.join(ROOT, "benchmark", "workloads",
                           cell + ".json")) as f:
        workload = json.load(f)
    raw, cfg = _config(workload["config"], workload["precision"])
    ref_cls = (ref_voxel.VoxelConfig if workload["traffic"]["kind"]
               == "sweeps_voxel" else Config)
    traffic = {**workload["traffic"], "frames": 1}
    return cfg, generate(traffic, 2 ** 31 + 11, ref_cls.from_dict(raw))[0]


@pytest.mark.parametrize("cell", ["nusc-stream", "waymo-stream",
                                  "waymo-voxel-stream"])
def test_voxel_segments_on_first_sweeps(dev, cell):
    cfg, (pts, n) = _first_sweep(cell)
    got = _same(cfg, pts, n, dev)
    assert 0 < int(got.pillar_count) < cfg.max_pillars


def test_voxelize_on_the_card_is_the_kernel(dev):
    """The kernel route has no fallback: a cap over 64 raises on the card
    instead of taking the plain version."""
    _, cfg = _config("dsvt-nuscenes")
    pts, n, _ = _cloud(cfg, [5, 70, 2], seed=1)
    points = torch.from_numpy(pts).to(dev)
    with pytest.raises(ValueError, match="max_points_per_pillar"):
        vox.voxelize(points, n, dataclasses.replace(
            cfg, max_points_per_pillar=vk.MAX_CAP + 1), use_kernels=True)


def test_nuscenes_engine_replay_equals_eager(dev):
    cell_cfg, (pts, n) = _first_sweep("nusc-stream")
    engine = Engine(weights.random_params(cell_cfg, 0), cell_cfg).warmup()
    assert engine.graph_launches["voxel_segments"] == 2
    kernels.reset_counts()
    got = engine(pts, n)
    assert kernels.counts() == engine.graph_launches
    ref = engine.eager(torch.from_numpy(pts).to(dev),
                       torch.tensor(n, device=dev))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
