"""Shared sizes of the benchmark's CPU tests: a configuration small enough
for the CPU (the same structure as the cells', every width cut), sweeps
and scenes to match, and a harness run of a cell at those sizes."""

from __future__ import annotations

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"max_points": 2048, "max_kept_points": 1536, "max_pillars": 512,
        "max_points_per_pillar": 8, "grid_size": [48, 48, 1],
        "pfn_channels": [16, 32], "sparse_shape": [48, 48, 1],
        "max_sets": 128, "set_size": 12, "num_blocks": 2, "num_heads": 4,
        "d_model": 32, "ffn_dim": 64, "num_classes": 3, "top_k": 64}
SWEEPS = {"frames": 4, "points": [600, 900],
          "lidar": {"beams": 8, "elevation_deg": [-30, 5],
                    "azimuth_steps": 300, "height_m": 1.84,
                    "max_range_m": 7.5, "range_noise_m": 0.02,
                    "sensor_z_m": 0.0},
          "facades": {"count": [1, 2], "range_m": [3, 6],
                      "length_m": [2, 5], "height_m": [2, 4]},
          "bushes": {"count": [2, 4], "range_m": [2, 6],
                     "radius_m": [0.2, 0.5], "points": [5, 10]},
          "objects": {"count": [1, 2], "range_m": [2, 6],
                      "points": [20, 40]}}
SCENES = {"batches": 4, "ground_points": 300, "object_points": 40,
          "objects": 2}


def tiny(config: dict) -> dict:
    """TINY over a configuration: its range cut to 48 pillars a side, its
    own z range kept."""
    return {**TINY, "pc_range_min": [-7.68, -7.68, config["pc_range_min"][2]],
            "pc_range_max": [7.68, 7.68, config["pc_range_max"][2]]}


def tiny_cell(name: str, seed: int = 5, seconds: float = 0.5,
              precision: str = None):
    """A cell of BENCHMARK.json at the tiny sizes, on the CPU;
    ``precision`` replaces the cell's."""
    from benchmark.harness import Cell, read_json

    workload = read_json("workloads", f"{name}.json")
    traffic = SCENES
    if "lidar" in workload["traffic"]:
        traffic = {**SWEEPS, "lidar": {
            **SWEEPS["lidar"],
            "sensor_z_m": workload["traffic"]["lidar"]["sensor_z_m"]}}
    config = read_json("configs", f"{workload['config']}.json")["config"]
    cell = Cell.load(name, seed, seconds, False, "cpu", time.perf_counter(),
                     tiny(config), traffic)
    if precision:
        cell.workload = {**cell.workload, "precision": precision}
    return cell


@pytest.fixture(scope="session")
def tiny_cfg():
    from benchmark.reference.config import Config
    from benchmark.harness import read_json

    raw = read_json("configs", "dsvt-nuscenes.json")["config"]
    return Config.from_dict({**raw, **tiny(raw)})


@pytest.fixture
def card():
    """Skip unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
