"""On the card: a short run of every cell prints the contract's line and
comes out correct; a traced run reads every per-layer metric of its cell.

    python3 -m pytest benchmark/tests -m cuda -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.manifest import benchmark, layer_metrics
from conftest import ROOT

CELLS = [w["name"] for w in benchmark()["workloads"]]


def _run(cell: str, seed: int, trace: int) -> dict:
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", cell, "--seed",
         str(seed), "--seconds", "2", "--trace", str(trace)],
        capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_is_correct_and_well_formed(card, cell):
    line = _run(cell, 2 ** 31 + 17, 0)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    ends = [m["name"] for m in benchmark()["end_to_end"]
            if cell in m.get("workloads", [cell])]
    assert sorted(line["metrics"]) == sorted(ends)
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_layer_metric(card, cell):
    line = _run(cell, 2 ** 31 + 19, 1)
    assert line["correct"], line["checks"]
    assert sorted(line["metrics"]) == sorted(layer_metrics(cell))
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 < m["value"] <= 105, (name, m)
    device = line["device"]
    assert 0 < device["busy_s"] <= device["window_s"]
    assert line["breakdown"]["device_ops"]
