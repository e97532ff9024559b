"""The port's JAX-free tools on the CPU at the tiny configuration.

* ``parity.run_parity``: the bf16 and mixed rows pass the exact-top-k gate
  against the port's fp32 on the tiny configuration's synthetic frames, and
  ``python -m dsvt_ai_trt_tpu_torch.parity --device cpu --config`` writes
  its JSON;
* the bench's parity block: a gate that fails sets ``ok`` false and makes
  the bench exit 1; one that cannot run is recorded as skipped and does
  not; an fp32 bench gates bf16;
* ``heading_probe.probe_cue`` equals the JAX package's
  tools/heading_probe.py on the same seed, and the A/B mode runs.
"""

import json

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import tiny_config

from dsvt_ai_trt_tpu_torch import bench, heading_probe, parity
from dsvt_ai_trt_tpu_torch.config import (DEFAULT_CONFIG, WAYMO_CONFIG,
                                          DSVTConfig)


def _tiny():
    return DSVTConfig.from_json(tiny_config().to_json())


@pytest.mark.parametrize("fast", ["bf16", "mixed"])
def test_run_parity_passes_at_the_tiny_config(fast):
    row = parity.run_parity(fast, cfg=_tiny(), device="cpu")
    assert row["parity_ok"], row
    assert row["precision_mode"] == fast and len(row["frames"]) == 3
    assert min(row["n_confident"].values()) >= parity.MIN_CONFIDENT
    assert row["worst"]["recall"] >= parity.PASS_RECALL
    assert row["worst"]["score_err"] <= parity.MAX_SCORE_ERR


def test_parity_cli_writes_its_json(tmp_path):
    cfg_path, out = tmp_path / "tiny.json", tmp_path / "parity.json"
    cfg_path.write_text(_tiny().to_json())
    res = parity.main(["--device", "cpu", "--config", str(cfg_path),
                       "--frames", "1", "--out", str(out)])
    written = json.loads(out.read_text())
    assert written == json.loads(json.dumps(res))
    assert written["device"] == "cpu" and written["nvidia_smi"] is None
    assert sorted(written["gates"]) == ["bf16_config", "mixed_config"]
    assert written["all_ok"] is True
    for row in written["gates"].values():
        assert set(row["worst"]) == {"recall", "precision", "score_err",
                                     "center_err"}
        assert row["pass_recall"] == 0.99 and row["seconds"] > 0


def test_parity_matrix_rows():
    assert [(f, d) for _, f, d in parity.MATRIX] == [
        ("bf16", "nuscenes"), ("mixed", "nuscenes"), ("bf16", "waymo"),
        ("mixed", "waymo")]
    (pts, n), = parity.frames_for(WAYMO_CONFIG, "waymo").values()
    assert int(n) == bench.WAYMO_POINTS and pts.shape[1] == 4
    frames = parity.frames_for(DEFAULT_CONFIG, "nuscenes")
    ref = bench.entry_frame(DEFAULT_CONFIG, 4000, 1, half_extent=20.0)
    np.testing.assert_array_equal(frames["sparse_seed1"][0], ref[0])


def _row(ok):
    return {"worst": {"recall": 1.0 if ok else 0.5, "precision": 1.0,
                      "score_err": 0.0, "center_err": 0.0},
            "n_confident": {"ref": 40, "fast": 40}, "pass_recall": 0.99,
            "parity_ok": ok, "seconds": 0.1}


def _bench_with(monkeypatch, run_parity, precision="bf16"):
    """bench.main with the card parts stubbed: run() returns the parity
    block's result alone."""
    monkeypatch.setattr(parity, "run_parity", run_parity)
    monkeypatch.setattr(bench, "run", lambda args: bench.parity_gates(
        args.precision, "cpu"))
    return bench.main(["--precision", precision])


def test_bench_gate_that_fails_sets_ok_false_and_exits_1(monkeypatch,
                                                          capsys):
    seen = []

    def failing(fast, density, **_kw):
        seen.append((fast, density))
        return _row(density == "nuscenes")
    with pytest.raises(SystemExit) as exc:
        _bench_with(monkeypatch, failing, precision="fp32")
    assert exc.value.code == 1
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["parity"]["ok"] is True and line["parity"]["mode"] == "bf16"
    assert line["parity_waymo"]["ok"] is False
    assert line["parity_waymo"]["recall"] == 0.5
    assert line["ok"] is False
    assert seen == [("bf16", "nuscenes"), ("bf16", "waymo")]


def test_bench_gate_that_cannot_run_is_skipped(monkeypatch):
    def raising(fast, density, **_kw):
        raise RuntimeError("no frames")
    res = _bench_with(monkeypatch, raising, precision="mixed")
    for key in ("parity", "parity_waymo"):
        assert res[key] == {"skipped": "RuntimeError: no frames", "ok": False}
    assert res["ok"] is False and not bench.gate_failed(res)


def test_bench_gates_that_pass(monkeypatch):
    res = _bench_with(monkeypatch, lambda fast, density, **_kw: _row(True),
                      precision="mixed")
    assert res["ok"] is True and res["parity"]["mode"] == "mixed"


@pytest.mark.parametrize("seed,pts", [(0, 150), (5, 60)])
def test_probe_cue_equals_jax(seed, pts):
    from dsvt_ai_trt_tpu.config import DEFAULT_CONFIG as JAX_DEFAULT
    from tools.heading_probe import probe_cue
    got = heading_probe.probe_cue(DEFAULT_CONFIG, 60, pts, seed=seed)
    assert got == probe_cue(JAX_DEFAULT, 60, pts, seed=seed)
    assert got["accuracy"] > 0.5


def test_heading_ab_runs_on_the_cpu():
    assert heading_probe.tiny_cfg() == _tiny()
    res = heading_probe.run_ab(1, [0.0, 0.5], eval_scenes=1, device="cpu")
    assert sorted(res) == ["wdir_0.0", "wdir_0.5"]
    for row in res.values():
        assert np.isfinite(row["loss_last"]) and 0.0 <= row["recall"] <= 1.0
