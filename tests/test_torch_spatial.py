"""The port's spatial sharding (parallel/spatial.py) on the CPU: one frame
sharded by pillar, set and BEV rows over gloo worlds of spawned processes,
against the port's unsharded path and the JAX package.

* sp=2 over the tiny config's 48-row grid, and sp=3 over a 52-row grid,
  whose levels 52 -> 26 -> 13 are uneven over 3 ranks at every level:
  count and boxes equal the unsharded ``forward`` at 1e-4, and JAX's
  ``forward_jit`` at tests/test_spatial.py's tolerance (atol 2e-3, rtol
  1e-3);
* each conv of the BEV stack (3x3 and 1x1, stride 1 and 2, at each level)
  and each deblock (kernel = stride 2 and 4), run on a rank's rows with
  halos and all-gathered, equals the whole conv at 1e-5 (the same
  products summed in another blocking), over 2 and 3 ranks;
* ``row_range`` and ``bev_range`` split as the module says (117 over 2:
  58 / 59; every level nested in the coarsest).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.model.detector import forward_jit
from dsvt_ai_trt_tpu_torch.config import DSVTConfig
from dsvt_ai_trt_tpu_torch.parallel import dryrun, spatial

# (name, kernel, stride, scale of the input level, transposed)
CONVS = [("3x3 s1 full map", 3, 1, 1, False),
         ("3x3 s1 coarsest", 3, 1, 4, False),
         ("3x3 s2 full -> half", 3, 2, 1, False),
         ("3x3 s2 half -> quarter", 3, 2, 2, False),
         ("1x1 s2 full -> half", 1, 2, 1, False),
         ("1x1 s1 half", 1, 1, 2, False),
         ("deblock k2 half -> full", 2, 2, 2, True),
         ("deblock k4 quarter -> full", 4, 4, 4, True)]
MAP_ROWS, MAP_W, CH = 52, 7, 5


def grid52(cfg):
    """The tiny config on a 52-row grid (0.32 m pillars over +-8.32 m)."""
    return dataclasses.replace(
        cfg, grid_size=(52, 52, 1), sparse_shape=(52, 52, 1),
        pc_range_min=(-8.32, -8.32, -5.0), pc_range_max=(8.32, 8.32, 3.0))


def port_cfg(cfg) -> DSVTConfig:
    return DSVTConfig.from_json(cfg.to_json())


def conv_case(i):
    """Seeded input, weights and the whole result of CONVS[i]."""
    _name, k, stride, scale, transpose = CONVS[i]
    rng = np.random.default_rng(i)
    rows = MAP_ROWS // scale
    x = rng.normal(0, 1, (1, CH, rows, MAP_W)).astype(np.float32)
    if transpose:
        w = rng.normal(0, 0.3, (CH, 3, k, k)).astype(np.float32)
        b = rng.normal(0, 0.1, 3).astype(np.float32)
        y = F.conv_transpose2d(torch.tensor(x), torch.tensor(w),
                               torch.tensor(b), stride=stride)
    else:
        w = rng.normal(0, 0.3, (3, CH, k, k)).astype(np.float32)
        b = rng.normal(0, 0.1, 3).astype(np.float32)
        y = F.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                     stride=stride, padding=k // 2)
    return (x, w, b, stride, scale, transpose), y.numpy()


def _frames(cfg, n_frames=2):
    rng = np.random.default_rng(1234)
    pts = np.stack([make_cloud(rng, cfg, 900 + 100 * i)[0]
                    for i in range(n_frames)])
    nums = np.array([900 + 100 * i for i in range(n_frames)], np.int32)
    return pts, nums


def _world(world, cfg, seed):
    params = jax_weights.random_params(cfg, seed=seed)
    pts, nums = _frames(cfg)
    pc = port_cfg(cfg)
    tasks = [(dryrun.forward_task, (pc, params, pts, nums, 1, 1, True)),
             (dryrun.whole_task, (pc, params, pts, nums))]
    tasks += [(dryrun.conv_rows_task, conv_case(i)[0])
              for i in range(len(CONVS))]
    out = dryrun.spawn(dryrun.run_tasks, world, "cpu", (tasks,))
    for rank in out:
        assert rank["foreign_modules"] == []
    return {"cfg": cfg, "params": params, "pts": pts, "nums": nums,
            "ranks": [rank["results"] for rank in out]}


@pytest.fixture(scope="module")
def worlds():
    cfg = tiny_config()
    return {2: _world(2, cfg, seed=5), 3: _world(3, grid52(cfg), seed=6)}


@pytest.mark.parametrize("world", [2, 3])
def test_sp_forward_equals_unsharded_and_jax(worlds, world):
    w = worlds[world]
    got, whole = w["ranks"][0][0], w["ranks"][0][1]
    for rank in w["ranks"]:                   # every rank: the same boxes
        np.testing.assert_array_equal(rank[0]["boxes"], got["boxes"])
        np.testing.assert_array_equal(rank[0]["count"], got["count"])
    for b in range(len(w["pts"])):
        n = int(whole["count"][b])
        assert int(got["count"][b]) == n and n > 0
        np.testing.assert_allclose(got["boxes"][b][:n], whole["boxes"][b][:n],
                                   atol=1e-4, rtol=1e-4)
        ref = forward_jit(w["params"], w["pts"][b], w["nums"][b], w["cfg"],
                          True)
        assert int(ref.count) == n
        np.testing.assert_allclose(got["boxes"][b], np.asarray(ref.boxes),
                                   atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("world", [2, 3])
@pytest.mark.parametrize("case", range(len(CONVS)),
                         ids=[c[0] for c in CONVS])
def test_conv_rows_equal_whole_conv(worlds, world, case):
    _args, want = conv_case(case)
    for rank in worlds[world]["ranks"]:
        got = rank[2 + case]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_row_splits():
    assert [spatial.row_range(117, r, 2) for r in range(2)] == [(0, 58),
                                                                (58, 117)]
    assert [spatial.row_range(13, r, 3) for r in range(3)] == [(0, 4), (4, 8),
                                                               (8, 13)]
    for n in (5, 13, 117):
        for world in (1, 2, 3, 4):
            parts = [spatial.row_range(n, r, world) for r in range(world)]
            assert parts[0][0] == 0 and parts[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
            assert max(b - a for a, b in parts) - min(b - a for a, b in
                                                      parts) <= 1
    # outside the context a rank owns every row
    assert spatial.bev_range(468) == (0, 468)
    assert spatial.bev_range(117, spatial.BEV_STRIDE) == (0, 117)
    x = torch.ones(3, 2)
    assert spatial.gather_rows(x, 3) is x


@pytest.mark.slow
@pytest.mark.parametrize("world", [2, 3])
def test_sp_forward_matches_jax_spatial_sharding(worlds, world):
    """The port's sharded boxes against JAX's own ``spatial_sharding`` over
    the 8 virtual devices, same frames and weights."""
    import jax
    from jax.sharding import Mesh
    from dsvt_ai_trt_tpu.model.detector import forward as jax_forward
    from dsvt_ai_trt_tpu.parallel.spatial import spatial_sharding
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of conftest.py")
    w = worlds[world]
    got = w["ranks"][0][0]
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("sp",))
    with spatial_sharding(mesh):
        fn = jax.jit(lambda p, x, m: jax_forward(p, x, m, w["cfg"], True))
        for b in range(len(w["pts"])):
            ref = fn(w["params"], w["pts"][b], w["nums"][b])
            assert int(ref.count) == int(got["count"][b])
            np.testing.assert_allclose(got["boxes"][b], np.asarray(ref.boxes),
                                       atol=2e-3, rtol=1e-3)
