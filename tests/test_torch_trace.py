"""The port's trace parser, stage timer and FLOP counts, on the CPU.

* ``parse_trace`` on a handcrafted Chrome trace of the shape
  ``torch.profiler`` exports for the card: device events of the
  ``kernel`` / ``gpu_memcpy`` / ``gpu_memset`` categories, each given to
  the frame and stage whose host span holds its launch (by correlation id),
  frame windows from those events, busy time as a union, idle share,
  per-op aggregation and the stage table (as tests/test_trace.py pins the
  JAX parser);
* a CPU ``capture`` of the tiny forward (the host timeline) returns every
  ``model/detector.py:STAGES`` label, and ``profile_stages`` times each;
* ``program_flops`` of the plain B1 and B2 versions equals the kernels'
  FLOP formulas within 1%; a kernel launch adds its formula's FLOPs to the
  count of the stage it ran in;
* ``device_peak_flops`` reads the H100's name.
"""

import json

import numpy as np
import pytest
import torch

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu_torch import kernels, weights
from dsvt_ai_trt_tpu_torch.model.detector import STAGES, forward
from dsvt_ai_trt_tpu_torch.ops import attention_kernel, encoder_kernel
from dsvt_ai_trt_tpu_torch.runtime import profiler
from dsvt_ai_trt_tpu_torch.runtime.profiler import (FlopCount, count_flops,
                                                    program_flops, stage_scope)
from dsvt_ai_trt_tpu_torch.runtime.trace import capture, parse_trace

from conftest import make_cloud, tiny_config


def _ev(cat, name, ts, dur, tid=7, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _write(tmp_path, events):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events + [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "python"}}]}))
    return str(path)


def _device_trace():
    """Two frames (us).  Host (tid 3): frame 1 900-1100 holds voxelize
    900-950 and backbone3d 960-1090; frame 2 1800-1950 holds nms
    1800-1850.  Each device event (tid 7) is tied by its correlation id to
    the host call that launched it.  Frame 1: from voxelize, a kernel
    1000-1020 and a memcpy 1010-1025 (overlapping: busy 25, summed 35);
    from backbone3d, two launches of one kernel, 40.  Frame 2: from nms, a
    memset 2000-2010; from outside any stage, a kernel 2020-2040, then the
    host waits 20 us in a stream synchronisation.  Outside
    every frame: a kernel launched before the first (40) and one whose
    launch is not in the trace (5).  A host op is no device event."""
    u, rt = "user_annotation", "cuda_runtime"
    return [
        _ev(u, "frame", 900, 200, tid=3), _ev(u, "frame", 1800, 150, tid=3),
        _ev(u, "voxelize", 900, 50, tid=3),
        _ev(u, "backbone3d", 960, 130, tid=3),
        _ev(u, "nms", 1800, 50, tid=3),
        _ev(rt, "cudaLaunchKernel", 905, 3, tid=3, corr=1),
        _ev(rt, "cudaMemcpyAsync", 910, 3, tid=3, corr=2),
        _ev(rt, "cudaLaunchKernel", 970, 3, tid=3, corr=3),
        _ev("cuda_driver", "cuLaunchKernel", 980, 3, tid=3, corr=4),
        _ev(rt, "cudaMemsetAsync", 1810, 3, tid=3, corr=5),
        _ev(rt, "cudaLaunchKernel", 1900, 3, tid=3, corr=6),
        _ev(rt, "cudaStreamSynchronize", 1910, 20, tid=3),
        _ev(rt, "cudaLaunchKernel", 500, 3, tid=3, corr=7),
        _ev("kernel", "sort_kernel", 1000, 20, corr=1),
        _ev("gpu_memcpy", "Memcpy HtoD", 1010, 15, corr=2),
        _ev("kernel", "set_attention_kernel", 1040, 25, corr=3),
        _ev("kernel", "set_attention_kernel", 1070, 15, corr=4),
        _ev("gpu_memset", "Memset", 2000, 10, corr=5),
        _ev("kernel", "reduce_kernel", 2020, 20, corr=6),
        _ev("kernel", "warmup_kernel", 600, 40, corr=7),
        _ev("kernel", "orphan_kernel", 2100, 5, corr=99),
        _ev("cpu_op", "aten::add", 1000, 500, tid=3),
        # what torch.profiler also writes and the parser does not read
        _ev("gpu_user_annotation", "frame", 1000, 1),
    ]


def test_parse_windows_stages_and_busy(tmp_path):
    prof = parse_trace(_write(tmp_path, _device_trace()), n_iters=2)
    assert prof.timeline == "device"
    assert prof.windows == [(1000, 1085), (2000, 2040)]
    # busy: 25 (union of kernel + memcpy) + 40 + 10 + 20 = 95 us, 2 frames
    assert prof.device_ms_per_iter == pytest.approx(0.0475)
    assert prof.window_busy_ms() == pytest.approx([0.065, 0.03])
    assert prof.window_ms_per_iter == pytest.approx(0.0625)
    assert prof.host_ms_per_iter == pytest.approx(0.175)
    assert prof.idle_share == pytest.approx(1 - 95 / 125)
    # host calls waiting on the card: the copy (3) and the sync (20);
    # launch calls: four of 3 us in the frames (the one before is outside)
    assert prof.host_wait_ms_per_iter == pytest.approx(0.0115)
    assert prof.host_launch_ms_per_iter == pytest.approx(0.006)
    # per-stage: summed durations (the voxelize overlap counts twice)
    assert prof.stage_ms() == pytest.approx(
        {"backbone3d": 0.02, "voxelize": 0.0175, "other": 0.01,
         "nms": 0.005})
    spans = prof.stage_spans()
    assert set(spans) == set(STAGES)
    assert spans["voxelize"] == pytest.approx(
        {"host_ms": 0.025, "span_ms": 0.0125, "busy_ms": 0.0175})
    assert spans["partition"] == {"host_ms": 0.0, "span_ms": 0.0,
                                  "busy_ms": 0.0}


def test_parse_aggregates_ops(tmp_path):
    prof = parse_trace(_write(tmp_path, _device_trace()), n_iters=2)
    top = prof.top_ops(2)
    assert top[0] == {"name": "set_attention_kernel", "ms": 0.02,
                      "calls": 1.0}
    assert top[1]["name"] in ("sort_kernel", "reduce_kernel")
    assert [r["name"] for r in prof.stage_ops("voxelize")] == [
        "sort_kernel", "Memcpy HtoD"]
    names = {r["name"] for r in prof.top_ops(50)}
    assert not names & {"warmup_kernel", "orphan_kernel", "aten::add"}
    assert "device time: " in prof.report()
    assert "set_attention_kernel" in prof.report()


def test_stage_table_uses_counted_flops(tmp_path):
    prof = parse_trace(_write(tmp_path, _device_trace()), n_iters=2)
    prof.flops = FlopCount(3e9, {}, {"backbone3d": 2e9, "voxelize": 1e9})
    table = prof.stage_table(peak_flops=1e15)
    assert table["backbone3d"]["gflop"] == pytest.approx(2.0)
    # 2 GFLOP in 0.02 ms = 1e14 FLOP/s, a tenth of the peak
    assert table["backbone3d"]["mfu"] == pytest.approx(0.1)
    assert table["nms"]["gflop"] == 0.0
    assert "mfu" not in prof.stage_table()["backbone3d"]


def test_parse_raises_on_a_short_trace(tmp_path):
    no_frame2 = [e for e in _device_trace()
                 if e["args"].get("correlation") not in (5, 6)]
    with pytest.raises(ValueError, match="frame 1 has no device events"):
        parse_trace(_write(tmp_path, no_frame2), n_iters=2)
    with pytest.raises(ValueError, match="2 'frame' host spans for 3"):
        parse_trace(_write(tmp_path, _device_trace()), n_iters=3)


def test_parse_host_timeline_counts_outermost_ops(tmp_path):
    events = [_ev("user_annotation", "frame", 0, 100, tid=3),
              _ev("user_annotation", "vfe", 10, 50, tid=3),
              _ev("cpu_op", "aten::einsum", 10, 40, tid=3),
              _ev("cpu_op", "aten::bmm", 20, 20, tid=3),   # inside einsum
              _ev("cpu_op", "aten::add", 70, 10, tid=3)]
    prof = parse_trace(_write(tmp_path, events), n_iters=1, timeline="host")
    assert prof.timeline == "host"
    assert [r["name"] for r in prof.top_ops()] == ["aten::einsum", "aten::add"]
    assert prof.stage_ms() == pytest.approx({"vfe": 0.04, "other": 0.01})


@pytest.fixture(scope="module")
def tiny_model():
    cfg = tiny_config()
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    params = weights.from_jax_params(jax_weights.random_params(cfg, 0), "cpu")
    return cfg, params, pts, n


def test_cpu_capture_returns_every_stage(tiny_model):
    cfg, params, pts, n = tiny_model

    def fn():
        return forward(params, pts, n, cfg, with_nms=True, device="cpu")
    prof = capture(fn, (), iters=1, device="cpu")
    assert prof.timeline == "host" and len(prof.windows) == 1
    assert set(STAGES) <= set(prof.stage_ms())
    assert all(prof.stage_spans()[s]["host_ms"] > 0 for s in STAGES)
    assert set(prof.flops.stages) == set(STAGES)
    assert sum(prof.flops.stages.values()) == pytest.approx(prof.flops.total)
    assert prof.stage_table(1e12)["backbone2d"]["gflop"] > 0


def test_profile_stages_times_every_stage(tiny_model):
    cfg, params, pts, n = tiny_model
    timer = profiler.profile_stages(params, pts, n, cfg, iters=1,
                                    device="cpu")
    assert list(timer.summary()) == list(STAGES)
    assert all(s["calls"] == 1 for s in timer.summary().values())
    assert timer.flops["backbone2d"] > 0
    assert "backbone3d" in timer.report()


def test_plain_b1_flops_match_the_kernel_formula():
    S, K, C, H = 6, 12, 32, 4
    gen = torch.Generator().manual_seed(0)
    qkv = torch.randn(S * K, 3 * C, generator=gen).bfloat16()
    mask = torch.zeros(S, K)
    counted = program_flops(attention_kernel.set_attention_plain, qkv, mask, H)
    assert counted == pytest.approx(attention_kernel.flops(S, K, C), rel=0.01)


def test_plain_b2_flops_match_the_kernel_formula():
    cfg = tiny_config()
    enc = weights.from_jax_params(jax_weights.random_params(cfg, 0),
                                  "cpu")["blocks"][0]["enc"][0]
    P, C = 50, cfg.d_model
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(P, C, generator=gen)
    a = torch.randn(P, C, generator=gen).bfloat16()
    counted = program_flops(encoder_kernel.encoder_epilogue_plain, x, a, enc)
    assert counted == pytest.approx(encoder_kernel.flops(P, C, cfg.ffn_dim),
                                    rel=0.01)


def test_kernel_launch_flops_join_their_stage():
    before = kernels.counts()["set_attention"]

    def fake_frame():
        with stage_scope("voxelize"):    # a stage without launches: its
            pass                         # tally equals the call's, {}
        with stage_scope("backbone3d"):
            torch.ones(4, 8) @ torch.ones(8, 2)          # 2*4*8*2 = 128
            kernels.count("set_attention", lambda: 1000)  # a launch
        kernels.count("set_attention")                    # no formula
    got = count_flops(fake_frame)
    assert got.total == 1128 and got.kernels == {"set_attention": 1000.0}
    assert got.stages == {"voxelize": 0, "backbone3d": 1128}
    assert kernels.counts()["set_attention"] == before + 2
    kernels.count("set_attention", lambda: 1 / 0)   # no tally: not called


@pytest.mark.parametrize("name,precision,want", [
    ("NVIDIA H100 80GB HBM3", "bf16", 989e12),
    ("NVIDIA H100 80GB HBM3", "fp32", 67e12),
    ("NVIDIA H100 PCIe", "bf16", 756e12),
    ("NVIDIA A100-SXM4-80GB", "bf16", 0.0),
])
def test_device_peak_flops_reads_the_card(monkeypatch, name, precision, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda _d=None: name)
    assert profiler.device_peak_flops(precision) == want


def test_device_peak_flops_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler.device_peak_flops("bf16") == 0.0
