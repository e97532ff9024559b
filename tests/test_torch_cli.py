"""The port's command line on the CPU (``--device cpu``), at the tiny
configuration.

* ``--help`` lists build, infer, bench, convert, stats and eval;
* ``infer`` with no weights (random, seed 0) on the tiny golden's cloud
  writes rows equal to tests/goldens/tiny_seed0.json (the JAX package's
  fp32 boxes) at atol/rtol 1e-4, count exact; ``--host-nms`` and
  ``--scan-batch`` write the same rows;
* ``build`` writes a stamped engine that ``infer --engine`` loads, and
  that refuses another precision;
* ``convert`` round-trips npz and wts; ``stats`` prints occupancy against
  the caps; ``eval --gate`` passes identical outputs and fails others;
  ``bench`` prints its JSON line, naming the device it ran on;
* ``train`` takes its steps, checkpoints, resumes from the checkpoint and
  exports a .wts that folds back to the checkpoint's weights.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config
from test_golden import GOLDEN_TINY, _assert_boxes

from dsvt_ai_trt_tpu_torch import cli, weights
from dsvt_ai_trt_tpu_torch.io.output import load_txt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def golden_dir(tmp_path_factory):
    """The tiny config as JSON and the golden's cloud as a .bin frame."""
    root = tmp_path_factory.mktemp("cli")
    cfg = tiny_config()
    (root / "tiny.json").write_text(cfg.to_json())
    data = root / "data"
    data.mkdir()
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    pts[:n].tofile(data / "000000.bin")
    return root


def _infer(root, out, *extra):
    cli.main(["infer", "--device", "cpu", "--config", str(root / "tiny.json"),
              "--weights", "", "--data", str(root / "data"), "--out",
              str(out), *extra])
    return load_txt(str(out / "000000.txt"))[1]


def test_help_lists_the_subcommands():
    out = subprocess.run([sys.executable, "-m", "dsvt_ai_trt_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    for cmd in ("build", "infer", "bench", "convert", "stats", "eval",
                "train"):
        assert cmd in out.stdout


def test_infer_reproduces_the_tiny_golden(golden_dir, tmp_path):
    rows = _infer(golden_dir, tmp_path / "out")
    with open(GOLDEN_TINY) as f:
        ref = json.load(f)
    assert len(rows) == ref["count"]
    _assert_boxes(rows, ref["boxes"])


@pytest.mark.parametrize("extra", [["--host-nms"], ["--scan-batch", "2"],
                                   ["--pipeline-depth", "0"]])
def test_infer_modes_write_the_same_rows(golden_dir, tmp_path, extra):
    ref = _infer(golden_dir, tmp_path / "ref")
    got = _infer(golden_dir, tmp_path / "got", *extra)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_build_then_infer_with_the_engine(golden_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("DSVT_KERNEL_DIR", str(tmp_path / "kernels"))
    engine = str(tmp_path / "tiny.engine")
    cli.main(["build", "--device", "cpu", "--config",
              str(golden_dir / "tiny.json"), "--engine", engine])
    rows = _infer(golden_dir, tmp_path / "out", "--engine", engine)
    with open(GOLDEN_TINY) as f:
        assert len(rows) == json.load(f)["count"]
    with pytest.raises(ValueError, match=r"different config.*precision"):
        _infer(golden_dir, tmp_path / "bf16", "--engine", engine,
               "--precision", "bf16")


def test_convert_round_trips_npz_and_wts(tmp_path, capsys):
    cfg = tiny_config()
    raw = weights.random_raw(cfg, 2)
    weights.save_npz(raw, str(tmp_path / "a.npz"))
    cli.main(["convert", "--checkpoint", str(tmp_path / "a.npz"),
              "--out", str(tmp_path / "b.wts")])
    cli.main(["convert", "--checkpoint", str(tmp_path / "b.wts"),
              "--out", str(tmp_path / "c.npz")])
    assert f"wrote {len(raw)} tensors" in capsys.readouterr().out
    back = weights.load_checkpoint(str(tmp_path / "c.npz"))
    assert sorted(back) == sorted(raw)
    for k in raw:
        np.testing.assert_array_equal(back[k].ravel(), raw[k].ravel(),
                                      err_msg=k)
    # the converted checkpoint folds to the same parameters
    p0 = weights.prepare_params(raw, cfg)
    p1 = weights.prepare_params(back, cfg)
    np.testing.assert_array_equal(p0["blocks"][1]["enc"][0]["wk"],
                                  p1["blocks"][1]["enc"][0]["wk"])


def test_stats_prints_occupancy_against_the_caps(golden_dir, capsys):
    cli.main(["stats", "--device", "cpu", "--config",
              str(golden_dir / "tiny.json"), "--data",
              str(golden_dir / "data")])
    out = capsys.readouterr().out.splitlines()
    name, usage = out[0].split(" ", 1)
    assert name == "000000.bin"
    assert json.loads(usage) == {"points": "1500/2048",
                                 "kept_points": "648/1536",
                                 "pillars": "512/512", "sets_0": "49/128",
                                 "sets_1": "46/128"}
    assert out[1].startswith("suggested_caps")


def test_eval_gate(golden_dir, tmp_path, capsys):
    _infer(golden_dir, tmp_path / "a")
    _infer(golden_dir, tmp_path / "b")
    cli.main(["eval", "--pred", str(tmp_path / "a"), "--ref",
              str(tmp_path / "b"), "--gate", "0.99"])
    stats = json.loads(capsys.readouterr().out.splitlines()[0])
    assert stats["parity_ok"] and stats["recall"] == 1.0
    # drop half the rows of one side: recall falls under the gate
    path = tmp_path / "b" / "000000.txt"
    lines = path.read_text().splitlines()
    path.write_text("\n".join(lines[: 1 + (len(lines) - 1) // 2]) + "\n")
    with pytest.raises(SystemExit):
        cli.main(["eval", "--pred", str(tmp_path / "a"), "--ref",
                  str(tmp_path / "b"), "--gate", "0.99"])


def test_bench_prints_its_line(golden_dir, capsys):
    cli.main(["bench", "--device", "cpu", "--config",
              str(golden_dir / "tiny.json"), "--weights", "", "--data",
              str(golden_dir / "data"), "--iters", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["frames"] == 1 and line["ms_per_frame"] > 0
    assert line["device"] == "cpu"


def test_tiny_config_round_trips_through_json():
    cfg = tiny_config()
    from dsvt_ai_trt_tpu_torch.config import QUERY_KEYS, DSVTConfig
    back = dataclasses.asdict(DSVTConfig.from_json(cfg.to_json()))
    # the port's staged-backbone and detection-head fields, at the pillar
    # model's and the CenterHead's defaults
    assert back.pop("stages") == ()
    assert {k: back.pop(k) for k in QUERY_KEYS} == {
        k: v for k, v in dataclasses.asdict(DSVTConfig()).items()
        if k in QUERY_KEYS}
    assert back == dataclasses.asdict(cfg)


def test_train_checkpoints_resumes_and_exports(golden_dir, tmp_path, capsys):
    common = ["train", "--device", "cpu", "--config",
              str(golden_dir / "tiny.json"), "--weights", "", "--batch", "1"]
    ckpt = str(tmp_path / "state.npz")
    cli.main([*common, "--steps", "2", "--ckpt", ckpt, "--ckpt-every", "1"])
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["steps"] == 2 and np.isfinite(
        [first["loss_first"], first["loss_last"]]).all()
    assert int(np.load(ckpt)["step"]) == 2
    wts = str(tmp_path / "trained.wts")
    cli.main([*common, "--steps", "1", "--resume", ckpt, "--ckpt", ckpt,
              "--export-wts", wts])
    out = capsys.readouterr().out
    assert f"trained weights -> {wts}" in out
    assert json.loads(out.strip().splitlines()[-1])["steps"] == 1
    state = np.load(ckpt)
    assert int(state["step"]) == 3 and int(state["o:[0].count"]) == 3
    # the exported weights fold back to the checkpoint's
    folded = weights.prepare_params(weights.load_wts(wts), tiny_config())
    np.testing.assert_array_equal(
        folded["head"]["hm"]["w1"], state["p:['head']['hm']['w1']"])
    np.testing.assert_array_equal(
        folded["blocks"][1]["enc"][0]["wk"],
        state["p:['blocks'][1]['enc'][0]['wk']"])
