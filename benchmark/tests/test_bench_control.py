"""The control comes out not correct: the reference put in the program's
place one precision below the cell's fails the cell's own limits, at the
cell's own size, on three seeds.

Serving: float8 e4m3 for the bf16 cells.  Training: TF32 for the fp32
cell, and the fault "half of the batch left out".  At the CPU tests' tiny
widths the lower precision moves the numbers by other amounts than at the
cells' widths, so these run on the card (``cuda`` marker):

    python3 -m pytest benchmark/tests -m cuda -q -p no:cacheprovider
"""

from __future__ import annotations

import time

import pytest

from benchmark import control, judge
from benchmark.harness import Cell

SEEDS = [2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103]


def _cell(name, seed):
    return Cell.load(name, seed, 0.0, False, "cuda", time.perf_counter())


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["nusc-stream", "waymo-stream",
                                  "nusc-sensor-20hz"])
def test_the_fp8_control_fails_a_serving_cell(card, name, seed):
    cell = _cell(name, seed)
    readings = control.serving(cell, "fp8", with_program=False)["control"]
    ok, rows = judge.verdict(readings, cell.workload["limits"])
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_the_tf32_control_fails_the_training_cell(card, seed):
    cell = _cell("nusc-train-b2", seed)
    readings = control.training(cell, "tf32", with_program=False)
    for fault in ("control", "half_batch"):
        ok, rows = judge.verdict(readings[fault], cell.workload["limits"])
        assert not ok, (fault, rows)
