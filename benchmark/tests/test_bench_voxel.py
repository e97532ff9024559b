"""The voxel cell (``waymo-voxel-stream``) at tiny sizes on the CPU: a sound
run is correct and a dropped box is not; a program whose configuration
does not declare the file's keys is refused before anything is built;
the traffic, the counts and the work formulas agree with the reference."""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark import work_voxel
from benchmark.harness import Cell, run_mode, verdict
from benchmark.reference import voxel, voxel_counts
from benchmark.traffic import generate
from conftest import SWEEPS

CELL = "waymo-voxel-stream"


def _w(shape, shift=(0, 0, 0)):
    return {"shape": list(shape), "shift": list(shift)}


TINY = {"max_points": 2048, "max_kept_points": 1536, "max_pillars": 1024,
        "max_points_per_pillar": 8, "voxel_size": [0.32, 0.32, 0.75],
        "pc_range_min": [-7.68, -7.68, -2.0], "pc_range_max": [7.68, 7.68, 4.0],
        "grid_size": [48, 48, 8], "pfn_channels": [16, 32],
        "sparse_shape": [48, 48, 8],
        "window_specs": [_w((12, 12, 8)), _w((24, 24, 8), (6, 6, 0))],
        "max_sets": 128, "set_size": 12, "num_blocks": 2, "num_heads": 4,
        "d_model": 32, "ffn_dim": 64, "top_k": 64,
        "stages": [
            {"sparse_shape": [48, 48, 8], "num_blocks": 1, "set_size": 12,
             "window_specs": [_w((12, 12, 8)), _w((24, 24, 8), (6, 6, 0))],
             "max_voxels": 1024, "max_sets": 128, "stride": [1, 1, 8]},
            {"sparse_shape": [48, 48, 1], "num_blocks": 1, "set_size": 12,
             "window_specs": [_w((12, 12, 1)), _w((24, 24, 1), (6, 6, 0))],
             "max_voxels": 512, "max_sets": 128, "stride": [1, 1, 1]}]}
TRAFFIC = {**SWEEPS, "kind": "sweeps_voxel",
           "lidar": {**SWEEPS["lidar"], "sensor_z_m": 2.2}}


def _cell(seed=5, precision="fp32"):
    cell = Cell.load(CELL, seed, 0.5, False, "cpu", time.perf_counter(),
                     TINY, TRAFFIC)
    cell.workload = {**cell.workload, "precision": precision}
    return cell


def test_a_sound_run_is_correct():
    cell = _cell()
    outcome = run_mode(cell)
    ok, rows = verdict(cell, outcome.numbers)
    assert ok, rows
    assert outcome.numbers["occupancy"] == 0
    assert outcome.failed == 0


def test_a_dropped_box_is_not_correct(monkeypatch):
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

    call = Engine.__call__

    def dropped(self, points, num_points):
        dets = call(self, points, num_points)
        n = int(dets.count)
        if not n:
            return dets
        top = int(torch.argmax(dets.boxes[:n, 8]))
        order = [i for i in range(len(dets.boxes)) if i != top] + [top]
        return dets._replace(boxes=dets.boxes[order], count=dets.count - 1)
    monkeypatch.setattr(Engine, "__call__", dropped)
    cell = _cell()
    ok, _ = verdict(cell, run_mode(cell).numbers)
    assert not ok


def test_a_program_without_the_stages_is_refused_first(monkeypatch):
    """The parent's program has no ``stages``: the mode raises before it
    draws traffic or builds anything."""
    from benchmark import traffic
    from benchmark.modes import stream_voxel

    def no_traffic(*_):
        raise AssertionError("traffic drawn before the check")
    monkeypatch.setattr(traffic, "generate", no_traffic)
    cell = _cell()
    cell.config_file = {**cell.config_file,
                        "config": {**cell.config_file["config"],
                                   "a_key_no_program_has": 1}}
    with pytest.raises(ValueError, match="does not declare"):
        stream_voxel.Setup(cell)


def test_traffic_counts_and_work_agree_with_the_reference():
    cell = _cell()
    cfg = voxel.VoxelConfig.from_dict(cell.config_file["config"])
    frames = generate(cell.workload["traffic"], 7, cfg)
    for pts, n in frames:
        occ = voxel_counts.occupancy(pts, n, cfg)
        pl, stages = voxel.integer_stages(torch.from_numpy(pts), n, cfg)
        np.testing.assert_array_equal(occ, voxel.occupancy(pl, stages, cfg))
        assert np.all(occ < voxel_counts.caps(cfg) * 0.95)
        # one pooling of V = 8 slots: children's k | v rows, parents' q and
        # output rows at 2 bytes
        C = cfg.d_model
        assert work_voxel.stage_pool_seconds(cfg, occ) == pytest.approx(
            (occ[1] * 2 * C + 2 * occ[2] * C) * 2 / work_voxel.PEAK_BYTES)
        assert len(list(work_voxel.passes(cfg, occ))) == 4
        assert work_voxel.frame_flops(cfg, occ) > 0
    # without a redraw, the pillar kind's sweeps
    pillar = generate({**cell.workload["traffic"], "kind": "sweeps"}, 7,
                      dataclasses.replace(cfg, max_pillars=10 ** 6))
    for (a, n), (b, m) in zip(frames, pillar):
        assert n == m and np.array_equal(a, b)
