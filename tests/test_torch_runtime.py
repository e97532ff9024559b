"""The port's serving runtime on the CPU, at the tiny configuration.

* frame loops: ``run_frames`` at pipeline depth 0, 1 and 2 and
  ``run_frames_scan`` at batch 3 (a padded tail group) give identical boxes
  and counts on two frames;
* host NMS: the port's NumPy ``nms_host`` keeps the JAX package's
  ``io/host_nms.nms_host`` set on the same score-sorted boxes, and the same
  boxes as the port's device NMS;
* engine artifacts (as tests/test_runtime.py does for JAX's): a matching
  load passes; a ``with_nms`` or config mismatch, another kernel digest, a
  JAX artifact and a truncated one raise ValueError; the libraries of an
  artifact are installed under their digest;
* config JSON: the port's ``DSVTConfig.to_json()`` equals JAX's for the
  default, Waymo and tiny configurations (engine stamps cross-load);
* checkpoints: npz <-> wts round trips, and ``load_checkpoint`` equals
  JAX's on the same .wts, .npz and torch files.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conftest import make_cloud
from conftest import tiny_config as jax_tiny_config

from dsvt_ai_trt_tpu import config as jax_config
from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.io import host_nms as jax_host_nms
from dsvt_ai_trt_tpu.runtime.compile import _stamp as jax_stamp
from dsvt_ai_trt_tpu_torch import config, kernels, weights
from dsvt_ai_trt_tpu_torch.io.host_nms import nms_host
from dsvt_ai_trt_tpu_torch.io.output import load_txt
from dsvt_ai_trt_tpu_torch.ops.nms import nms
from dsvt_ai_trt_tpu_torch.runtime import compile as rt_compile
from dsvt_ai_trt_tpu_torch.runtime.infer import (Engine, benchmark,
                                                 run_frames, run_frames_scan)


def tiny_config():
    """tests/conftest.py's tiny configuration as the port's DSVTConfig,
    built field by field (engine stamps compare the config's class too)."""
    jt = jax_tiny_config()
    return config.DSVTConfig(
        **{f.name: getattr(jt, f.name) for f in dataclasses.fields(jt)
           if f.name != "window_specs"},
        window_specs=tuple(config.WindowSpec(w.shape, w.shift)
                           for w in jt.window_specs))


def _write_frames(tmp_path, cfg, seeds=(1234, 77)):
    paths = []
    for i, seed in enumerate(seeds):
        pts, n = make_cloud(np.random.default_rng(seed), cfg, 1500 - 300 * i)
        path = str(tmp_path / f"{i:06d}.bin")
        pts[: int(n)].tofile(path)
        paths.append(path)
    return paths


@pytest.fixture(scope="module")
def loop_setup(tmp_path_factory):
    cfg = tiny_config()
    params = weights.random_params(cfg, 0)
    paths = _write_frames(tmp_path_factory.mktemp("frames"), cfg)
    engine = Engine(params, cfg, device="cpu")
    return cfg, params, paths, engine, run_frames(engine, paths,
                                                  pipeline_depth=0)


def _loop(mode, cfg, params, paths, engine, out_dir):
    if mode == "scan3":
        return run_frames_scan(params, cfg, paths, out_dir, batch=3,
                               device="cpu")
    return run_frames(engine, paths, out_dir, pipeline_depth=int(mode[-1]))


@pytest.mark.parametrize("mode", ["depth1", "depth2", "scan3"])
def test_frame_loops_agree(loop_setup, mode, tmp_path):
    cfg, params, paths, engine, ref = loop_setup
    got = _loop(mode, cfg, params, paths, engine, str(tmp_path))
    assert [r["frame"] for r in got] == [r["frame"] for r in ref]
    for g, r in zip(got, ref):
        assert g["count"] == r["count"] > 0
        np.testing.assert_array_equal(g["boxes"], r["boxes"])
        seconds, rows = load_txt(str(tmp_path / (g["frame"] + ".txt")))
        assert seconds > 0
        np.testing.assert_allclose(rows, r["boxes"], atol=1e-5)


def test_frame_loop_reports_bad_frame(loop_setup, tmp_path):
    cfg, params, paths, engine, ref = loop_setup
    bad = tmp_path / "000009.bin"
    bad.write_bytes(b"\0" * 6)           # not a whole number of floats
    got = run_frames_scan(params, cfg, [paths[0], str(bad)], batch=2,
                          device="cpu")
    assert "error" in got[1] and got[1]["frame"] == "000009"   # input order
    np.testing.assert_array_equal(got[0]["boxes"], ref[0]["boxes"])


def test_benchmark_reports_frames(loop_setup):
    _cfg, _params, paths, engine, _ref = loop_setup
    res = benchmark(engine, paths, iters=1, pipeline_depth=2)
    assert res["frames"] == 2 and res["iters"] == 1 and res["ms_per_frame"] > 0


def test_engine_warmup_runs_an_empty_frame(loop_setup):
    engine = loop_setup[3]
    assert engine.warmup() is engine
    dets = engine(np.zeros((engine.cfg.max_points, 4), np.float32), 0)
    assert int(dets.count) == 0 and dets.occupancy.tolist()[:2] == [0, 0]


def _random_boxes(rng, n):
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, 0] = rng.uniform(-15, 15, n)
    boxes[:, 1] = rng.uniform(-15, 15, n)
    boxes[:, 3] = rng.uniform(1, 5, n)
    boxes[:, 4] = rng.uniform(1, 3, n)
    boxes[:, 6] = rng.uniform(-3, 3, n)
    boxes[:, 7] = rng.integers(0, 3, n)
    boxes[:, 8] = np.sort(rng.uniform(0.3, 1, n))[::-1]
    for c in range(0, n - 3, 4):
        boxes[c + 1:c + 3, :2] = boxes[c, :2] + rng.uniform(-0.4, 0.4, (2, 2))
    return boxes


@pytest.mark.parametrize("seed", [0, 1])
def test_host_nms_matches_jax_and_device(seed):
    rng = np.random.default_rng(seed)
    boxes = _random_boxes(rng, 40)
    count = 36                           # 4 padding rows past the count
    got, k = nms_host(boxes, count, 0.01)
    ref, k_ref = jax_host_nms.nms_host(boxes, count, 0.01)
    assert k == k_ref and 0 < k < count
    np.testing.assert_array_equal(got, ref)
    dev, k_dev = nms(torch.from_numpy(boxes), count, 0.01, use_kernels=False)
    assert int(k_dev) == k
    np.testing.assert_array_equal(dev.numpy(), got)


def test_run_frames_host_nms_matches_device(loop_setup):
    cfg, params, paths, _engine, ref = loop_setup
    host = run_frames(Engine(params, cfg, device="cpu", with_nms=False),
                      paths, host_nms=True)
    for h, r in zip(host, ref):
        assert h["count"] == r["count"]
        np.testing.assert_allclose(h["boxes"], r["boxes"], atol=1e-6)


# ---------------------------------------------------------------------------
# engine artifacts
# ---------------------------------------------------------------------------


@pytest.fixture()
def engine_file(tmp_path, monkeypatch):
    monkeypatch.setenv("DSVT_KERNEL_DIR", str(tmp_path / "kernels"))
    cfg = tiny_config()
    path = str(tmp_path / "t.engine")
    blob = rt_compile.build_engine(cfg, path, with_nms=True, device="cpu")
    return cfg, path, blob


def test_engine_stamp_matching_load(engine_file):
    cfg, path, blob = engine_file
    meta = rt_compile.load_engine(path, expect_cfg=cfg, expect_nms=True,
                                  device="cpu")
    assert meta["kernels"] == {"digest": kernels.digest(), "arch": "sm_90a"}
    assert meta["libraries"] == {}
    assert blob.startswith(b"DSVTCUDA")
    params = weights.random_params(cfg, 0)
    engine = Engine(params, cfg, device="cpu", engine_path=path)
    assert int(engine(*make_cloud(np.random.default_rng(1), cfg, 900)).count) > 0


def test_engine_stamp_rejects_nms_mismatch(engine_file):
    _cfg, path, _blob = engine_file
    with pytest.raises(ValueError, match="with_nms"):
        rt_compile.load_engine(path, expect_nms=False, device="cpu")


def test_engine_stamp_rejects_config_mismatch(engine_file):
    cfg, path, _blob = engine_file
    other = dataclasses.replace(cfg, score_threshold=0.5)
    with pytest.raises(ValueError, match=r"different config \(fields "
                                         r"\['score_threshold'\]\)"):
        rt_compile.load_engine(path, expect_cfg=other, device="cpu")
    with pytest.raises(ValueError, match="different config"):
        Engine(weights.random_params(cfg, 0), other, device="cpu",
               engine_path=path)


def test_engine_rejects_jax_artifact(tmp_path):
    cfg = tiny_config()
    jax_cfg = jax_config.DSVTConfig.from_json(cfg.to_json())
    blob = jax_stamp(jax_cfg, True) + b"serialized jax.export program"
    with pytest.raises(ValueError, match="JAX package"):
        rt_compile.load_engine(blob, expect_cfg=cfg, device="cpu")
    with pytest.raises(ValueError, match="not a DSVT engine"):
        rt_compile.load_engine(b"ELF" + blob, device="cpu")


def test_engine_rejects_other_kernel_sources(engine_file):
    cfg, _path, blob = engine_file
    n = int.from_bytes(blob[8:12], "little")
    meta = json.loads(blob[12:12 + n])
    meta["kernels"]["digest"] = "0" * 16
    text = json.dumps(meta).encode()
    forged = b"DSVTCUDA" + len(text).to_bytes(4, "little") + text
    with pytest.raises(ValueError, match="rebuild the engine"):
        rt_compile.load_engine(forged, expect_cfg=cfg, device="cpu")


def test_engine_installs_its_libraries(tmp_path, monkeypatch):
    monkeypatch.setenv("DSVT_KERNEL_DIR", str(tmp_path))
    cfg = tiny_config()
    libs = {"segment_max": b"lib-b3", "set_attention": b"lib-b1-longer"}
    blob = rt_compile._stamp(cfg, True, libs) + b"".join(libs.values())
    meta = rt_compile.load_engine(blob, expect_cfg=cfg, device="cpu")
    assert meta["libraries"] == {"segment_max": 6, "set_attention": 13}
    for name, data in libs.items():
        path = kernels.library_path(name)
        assert os.path.dirname(path) == str(tmp_path / kernels.digest())
        with open(path, "rb") as f:
            assert f.read() == data
    with pytest.raises(ValueError, match="truncated"):
        rt_compile.load_engine(blob[:-1], device="cpu")


@pytest.mark.parametrize("name", ["DEFAULT_CONFIG", "WAYMO_CONFIG", "tiny"])
def test_config_json_equals_jax(name):
    if name == "tiny":
        ours, theirs = tiny_config(), jax_tiny_config()
    else:
        ours, theirs = getattr(config, name), getattr(jax_config, name)
    assert ours.to_json() == theirs.to_json()
    stamp = rt_compile._stamp(ours, True, {})
    n = int.from_bytes(stamp[8:12], "little")
    assert json.loads(stamp[12:12 + n])["config"] == json.loads(
        theirs.to_json())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_npz_wts_round_trip(tmp_path):
    raw = weights.random_raw(tiny_config(), 3)
    weights.save_wts(raw, str(tmp_path / "a.wts"))
    back = weights.load_checkpoint(str(tmp_path / "a.wts"))
    weights.save_npz(back, str(tmp_path / "b.npz"))
    again = weights.load_checkpoint(str(tmp_path / "b.npz"))
    assert sorted(again) == sorted(raw)
    for k in raw:
        np.testing.assert_array_equal(again[k], raw[k].ravel().reshape(
            again[k].shape), err_msg=k)
        assert again[k].size == raw[k].size


def _torch_checkpoint(path, raw):
    """A torch state_dict with fused in_proj tensors and no ``module.``
    prefix, inside {"state_dict": ...} as training scripts save it."""
    state, fused = {}, {}
    for name, arr in raw.items():
        base, _, part = name.rpartition(".")
        if ".in_proj_" in name and part in ("query", "key", "value"):
            fused.setdefault(base, {})[part] = arr
        else:
            state[name[len("module."):]] = torch.from_numpy(arr)
    for base, parts in fused.items():
        state[base[len("module."):]] = torch.from_numpy(np.concatenate(
            [parts["query"], parts["key"], parts["value"]]))
    torch.save({"state_dict": state}, path)


@pytest.mark.parametrize("ext", [".wts", ".npz", ".pth"])
def test_load_checkpoint_matches_jax(tmp_path, ext):
    raw = weights.random_raw(tiny_config(), 4)
    path = str(tmp_path / ("ckpt" + ext))
    if ext == ".wts":
        jax_weights.save_wts(raw, path)
    elif ext == ".npz":
        # fused in_proj entries exercise the split on load
        fused = {k: v for k, v in raw.items() if ".in_proj_" not in k}
        for k in [k for k in raw if k.endswith(".query")]:
            base = k[: -len(".query")]
            fused[base] = np.concatenate([raw[base + "." + p]
                                          for p in ("query", "key", "value")])
        np.savez(path, **fused)
    else:
        _torch_checkpoint(path, raw)
    ours = weights.load_checkpoint(path)
    theirs = jax_weights.load_checkpoint(path)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype == np.float32, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
