"""Port voxelize + window/set partition vs the JAX package: exact equality.

Same cloud (numpy seed, tests/conftest.py:make_cloud) into both packages.
Every Pillars field and every window/set partition field must be exactly
equal, including a cloud with pillars over the per-pillar cap and one with
fewer valid sets than the set cap.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu.ops.voxelize import voxelize as jax_voxelize
from dsvt_ai_trt_tpu.ops.windows import partition as jax_partition
from dsvt_ai_trt_tpu_torch.ops.voxelize import voxelize
from dsvt_ai_trt_tpu_torch.ops.windows import partition


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _dense_cloud(rng, cfg, n_cells=40, per_cell=20):
    """Clusters of `per_cell` points inside single pillars: every cluster is
    over the tiny config's cap of 8 points."""
    buf = np.zeros((cfg.max_points, 4), np.float32)
    vx, vy, _ = cfg.voxel_size
    xs = rng.integers(2, cfg.grid_size[0] - 2, n_cells)
    ys = rng.integers(2, cfg.grid_size[1] - 2, n_cells)
    rows = []
    for cx, cy in zip(xs, ys):
        px = cfg.pc_range_min[0] + (cx + rng.uniform(0.1, 0.9, per_cell)) * vx
        py = cfg.pc_range_min[1] + (cy + rng.uniform(0.1, 0.9, per_cell)) * vy
        pz = rng.uniform(-3, 2, per_cell)
        pw = rng.uniform(0, 1, per_cell)
        rows.append(np.stack([px, py, pz, pw], 1))
    cloud = np.concatenate(rows).astype(np.float32)
    buf[:len(cloud)] = cloud
    return buf, np.int32(len(cloud))


CASES = {
    "uniform": lambda rng, cfg: make_cloud(rng, cfg, 1500),
    "over_cap": _dense_cloud,
    "sparse_sets": lambda rng, cfg: make_cloud(rng, cfg, 60),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_voxelize_and_partition_exact(case):
    cfg = tiny_config()
    rng = np.random.default_rng(7)
    pts, n = CASES[case](rng, cfg)

    ref = jax_voxelize(jnp.asarray(pts), jnp.int32(n), cfg)
    got = voxelize(torch.from_numpy(pts), int(n), cfg)
    for field in ref._fields:
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    if case == "over_cap":
        assert int(np.asarray(ref.num_points).max()) == cfg.max_points_per_pillar

    for spec in cfg.window_specs:
        rwp, rsp = jax_partition(ref.coords, ref.pillar_valid, spec, cfg)
        wp, sp = partition(got.coords, got.pillar_valid, spec, cfg)
        for field in rwp._fields:
            np.testing.assert_array_equal(_np(getattr(wp, field)),
                                          np.asarray(getattr(rwp, field)),
                                          err_msg=field)
        for field in rsp._fields:
            np.testing.assert_array_equal(_np(getattr(sp, field)),
                                          np.asarray(getattr(rsp, field)),
                                          err_msg=field)
        if case == "sparse_sets":
            assert int(sp.set_count) < cfg.max_sets
            dead = _np(sp.key_mask)[int(sp.set_count):]
            assert np.all(dead < -1e38)


def test_voxelize_point_cap_before_compaction():
    """A compacted budget smaller than the raw point count: the cap applies
    first, so over-cap points never use the budget (the JAX rule)."""
    cfg = dataclasses.replace(tiny_config(), max_kept_points=200,
                              max_pillars=100)
    rng = np.random.default_rng(3)
    pts, n = _dense_cloud(rng, cfg, n_cells=30, per_cell=12)
    ref = jax_voxelize(jnp.asarray(pts), jnp.int32(n), cfg)
    got = voxelize(torch.from_numpy(pts), int(n), cfg)
    for field in ref._fields:
        np.testing.assert_array_equal(_np(getattr(got, field)),
                                      np.asarray(getattr(ref, field)),
                                      err_msg=field)
    assert int(got.point_count) == 200
