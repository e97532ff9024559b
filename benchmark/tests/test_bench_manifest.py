"""``BENCHMARK.json`` against its files and the contract's rules of form,
and what the harness and the reference import."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.manifest import benchmark, path_of
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = benchmark()


def test_every_cell_config_and_metric_resolves_to_its_file():
    for w in BENCH["workloads"]:
        workload = json.load(open(path_of("workloads", w["name"])))
        assert workload["config"] == w["config"]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "modes",
                                           workload["mode"] + ".py"))
    for c in BENCH["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert json.load(open(os.path.join(ROOT, c["file"])))["name"] == \
            c["name"]
    for m in BENCH["per_layer"]:
        from benchmark.manifest import metric_reader

        assert callable(metric_reader(m["name"]).read)


def test_each_configuration_entry_agrees_with_its_file():
    for c in BENCH["configs"]:
        own = json.load(open(os.path.join(ROOT, c["file"])))
        assert (own["source"], own["reduced"]) == (c["source"], c["reduced"])


def test_names_units_and_lines_keep_to_their_characters():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for k in ("end_to_end", "per_layer") for m in BENCH[k]]
    assert all(UNIT.match(u) for u in units), units
    lines = [w["why"] for w in BENCH["workloads"] + BENCH["configs"]]
    lines += [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"]
    assert all(0 < len(s) <= 200 and "\n" not in s and "\t" not in s
               for s in lines)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_each_layer_metrics_cells_report_what_it_moves():
    reports = {}
    for m in BENCH["end_to_end"]:
        for w in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            reports.setdefault(w, set()).add(m["name"])
    for m in BENCH["per_layer"]:
        assert m["workloads"], m["name"]
        for w in m["workloads"]:
            assert m["moves"] in reports[w], (m["name"], w)
    for w in BENCH["workloads"]:
        assert "setup_s" in reports[w["name"]] and len(reports[w["name"]]) > 1
        assert any(w["name"] in m["workloads"] for m in BENCH["per_layer"])


def _loaded_after(imports: str):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); {imports}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    return set(out.stdout.split())


def test_the_harness_imports_neither_jax_nor_the_jax_package():
    loaded = _loaded_after(
        "import benchmark.run, benchmark.harness, benchmark.control, "
        "benchmark.modes.stream, benchmark.modes.sensor, "
        "benchmark.modes.train, dsvt_ai_trt_tpu_torch.runtime.compile, "
        "dsvt_ai_trt_tpu_torch.parallel.training, "
        "dsvt_ai_trt_tpu_torch.weights")
    assert not loaded & {"jax", "jaxlib", "flax", "dsvt_ai_trt_tpu"}
    assert "dsvt_ai_trt_tpu_torch" in loaded


def test_the_reference_imports_nothing_of_either_package():
    loaded = _loaded_after(
        "import benchmark.reference.detector, benchmark.reference.train, "
        "benchmark.reference.weights, benchmark.reference.counts, "
        "benchmark.judge, benchmark.work, benchmark.traffic.sweeps, "
        "benchmark.traffic.scenes")
    assert not loaded & {"jax", "jaxlib", "flax", "dsvt_ai_trt_tpu",
                         "dsvt_ai_trt_tpu_torch"}


def test_a_run_refuses_without_a_card_or_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    exits non-zero and prints no result line."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "nusc-stream",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_takes_one_chip_and_limits_what_it_judges(cell):
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert entry["chips"] == 1
    limits = json.load(open(path_of("workloads", cell)))["limits"]
    assert limits, cell
