"""The port end to end vs the JAX package, on the CPU.

* fp32: ``forward(..., with_nms=True)`` reproduces tests/goldens/
  tiny_seed0.json under test_golden._assert_boxes (atol/rtol 1e-4), and
  every stage of ``forward_debug`` matches the JAX ``forward_debug``
  (integer stages exactly; pillar_feats 1e-5; dsvt_feats, bev_features and
  head_out 1e-4);
* the runtime: ``Engine`` + ``run_frames`` write reference-format txts and
  flag cap saturation.
"""

import logging

import numpy as np
import pytest
import torch

from conftest import make_cloud, tiny_config
from test_golden import GOLDEN_TINY, _assert_boxes

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.model.detector import forward_debug as jax_forward_debug
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.io.output import load_txt
from dsvt_ai_trt_tpu_torch.model.detector import forward, forward_debug
from dsvt_ai_trt_tpu_torch.runtime.infer import Engine, run_frames


def _golden_inputs():
    cfg = tiny_config()
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    return cfg, pts, n, jax_weights.random_params(cfg, seed=0)


def test_tiny_golden_fp32():
    import json
    cfg, pts, n, params = _golden_inputs()
    dets = forward(weights.from_jax_params(params, "cpu"), pts, n, cfg,
                   with_nms=True, device="cpu")
    with open(GOLDEN_TINY) as f:
        ref = json.load(f)
    count = int(dets.count)
    assert count == ref["count"]
    _assert_boxes(dets.boxes[:count].numpy(), ref["boxes"])
    assert dets.occupancy.tolist()[:2] == [648, 512]


@pytest.fixture(scope="module")
def debug_pair():
    cfg, pts, n, params = _golden_inputs()
    ref = jax_forward_debug(params, pts, n, cfg)
    got = forward_debug(weights.from_jax_params(params, "cpu"), pts, n, cfg,
                        device="cpu")
    return got, ref


def test_forward_debug_integer_stages_exact(debug_pair):
    got, ref = debug_pair
    for field in ref.pillars._fields:
        np.testing.assert_array_equal(
            getattr(got.pillars, field).numpy(),
            np.asarray(getattr(ref.pillars, field)), err_msg=field)


@pytest.mark.parametrize("stage,tol", [("pillar_feats", 1e-5),
                                       ("dsvt_feats", 1e-4),
                                       ("bev_features", 1e-4)])
def test_forward_debug_float_stages(debug_pair, stage, tol):
    got, ref = debug_pair
    np.testing.assert_allclose(getattr(got, stage).numpy(),
                               np.asarray(getattr(ref, stage)),
                               atol=tol, rtol=tol)


def test_forward_debug_head_out(debug_pair):
    got, ref = debug_pair
    assert sorted(got.head_out) == sorted(ref.head_out)
    for name, val in ref.head_out.items():
        np.testing.assert_allclose(got.head_out[name].numpy(), np.asarray(val),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def test_engine_run_frames(tmp_path, caplog):
    cfg, pts, n, params = _golden_inputs()
    frame = tmp_path / "000001.bin"
    pts[:n].tofile(frame)
    bad = tmp_path / "000002.bin"
    bad.write_bytes(b"\0" * 6)           # not a whole number of floats
    engine = Engine(params, cfg, device="cpu")
    with caplog.at_level(logging.WARNING, logger="dsvt_torch.infer"):
        res = run_frames(engine, [str(frame), str(bad)],
                         out_dir=str(tmp_path / "out"))
    assert res[0]["count"] == int(engine(pts, n).count) > 0
    assert res[0]["saturated"] == ["max_pillars"]    # 512 pillars == cap
    assert "error" in res[1]
    assert "occupancy hit static cap" in caplog.text
    seconds, boxes = load_txt(str(tmp_path / "out" / "000001.txt"))
    assert seconds > 0 and boxes.shape == (res[0]["count"], 9)
    np.testing.assert_allclose(boxes, res[0]["boxes"], atol=1e-5)


def test_engine_accepts_torch_params_on_its_device():
    cfg, pts, n, params = _golden_inputs()
    tparams = weights.from_jax_params(params, "cpu")
    dets = Engine(tparams, cfg, device="cpu", with_nms=False)(
        torch.from_numpy(pts), n)
    assert dets.boxes.shape == (cfg.top_k, 9)
    assert int(dets.count) >= 25           # before NMS
