"""The port's tracer (``runtime/profiler.py``) on the CPU, where a stage
mark reads the host clock:

* off, it costs nothing visible: no stage hook, no record, no mark;
* on, an eager frame's record holds one device span a stage in
  ``STAGES`` order between its marks, inside its ``call``, numbered by the
  engine's calls, with the occupancy and the count of boxes before NMS the
  frame computed;
* a replay's record (the engine's capture and replay, with a stand-in
  for the CUDA graph that reruns what was captured) nests ``copy_in``,
  ``graph_launch`` and ``copy_out`` in ``call``, its stage spans in
  ``graph_launch``; while a profiler records, the same spans are its
  labels, with the tracer on and only then;
* a training step's record holds forward, backward and optimizer;
* ``write_spans`` writes a Chrome trace that ``json`` reads back;
* ``runtime/trace.parse_trace`` gives a replay's device events to the
  stage between its marks, named as the graph's owner placed them
  (``profiler.mark_names``), a staged frame's included, and refuses marks
  without their names.
"""

import json

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.data import synthetic_batch
from dsvt_ai_trt_tpu_torch.model.detector import STAGES, forward
from dsvt_ai_trt_tpu_torch.parallel.training import CompiledTrainStep
from dsvt_ai_trt_tpu_torch.runtime import compile as compile_mod
from dsvt_ai_trt_tpu_torch.runtime import profiler
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine
from dsvt_ai_trt_tpu_torch.runtime.trace import parse_trace

from conftest import make_cloud, tiny_config


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    params = weights.from_jax_params(jax_weights.random_params(cfg, 0), "cpu")
    frames = [make_cloud(np.random.default_rng(seed), cfg, n)
              for seed, n in ((1234, 1500), (7, 700))]
    return cfg, params, frames


@pytest.fixture
def tracing():
    profiler.enable_spans()
    try:
        yield
    finally:
        profiler.disable_spans()


class _Rerun:
    """A stand-in for a CUDA graph on the CPU: a replay runs the captured
    function again and writes its result into the first result's
    tensors, as a replay rewrites the graph's outputs in place."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    @torch.inference_mode()
    def replay(self):
        for static, new in zip(self.out, self.fn()):
            static.copy_(new)


def _fake_capture(fn, warm, device, warm_runs):
    for _ in range(warm_runs):
        warm()
    out = fn()
    return _Rerun(fn, out), out, {}, 0


def _captured(monkeypatch, cfg, params):
    """A CPU engine captured through ``Engine._capture`` with the stand-in
    graph: its calls go through ``_traced_call``, as a card's do."""
    monkeypatch.setattr(compile_mod, "capture_graph", _fake_capture)
    engine = Engine(params, cfg, device="cpu")
    engine._capture()
    return engine


def _fresh(cfg):
    """Weights of their own: a training step updates its weights in place."""
    return weights.from_jax_params(jax_weights.random_params(cfg, 1), "cpu")


def _inside(child, parent):
    return parent["start_ns"] <= child["start_ns"] <= child["end_ns"] \
        <= parent["end_ns"]


def test_tracer_off_records_nothing(tiny, monkeypatch):
    cfg, params, frames = tiny

    def no_mark(*_):
        raise AssertionError("a mark with the tracer off")
    monkeypatch.setattr(profiler.Marks, "mark", no_mark)
    monkeypatch.setattr(profiler.Marks, "counter", no_mark)
    assert profiler.tracer() is None and not profiler._scopes
    engine = Engine(params, cfg, device="cpu")
    engine(*frames[0])
    step = CompiledTrainStep(cfg, _fresh(cfg), 1, device="cpu")
    pts, ns, targets = synthetic_batch(np.random.default_rng(0), cfg, 1,
                                       device="cpu")
    step(pts, ns, targets)
    assert profiler.spans() == [] and profiler.calibration() is None
    assert engine.calls == step.calls == 0
    assert engine._marks is engine._eager_marks is None
    assert step._marks is step._eager_marks is None
    assert profiler.mark_names(engine) is profiler.mark_names(step) is None


@pytest.mark.parametrize("with_nms", [True, False])
def test_eager_frames_record_their_stages_and_counters(tiny, tracing,
                                                       with_nms):
    cfg, params, frames = tiny
    engine = Engine(params, cfg, device="cpu", with_nms=with_nms)
    got = [engine(pts, n) for pts, n in frames]
    records = profiler.spans()
    assert [r["id"] for r in records] == [1, 2]
    stages = STAGES if with_nms else STAGES[:-1]
    for rec, dets, (pts, n) in zip(records, got, frames):
        assert (rec["what"], rec["owner"], rec["kind"]) == (
            "frame", "Engine", "eager")
        (call,) = rec["host"]
        assert call["name"] == "call" and call["parent"] is None
        assert [s["name"] for s in rec["device"]] == list(stages)
        for a, b in zip(rec["device"], rec["device"][1:]):
            assert a["end_ns"] == b["start_ns"]
        assert all(_inside(s, call) and s["parent"] == "call"
                   for s in rec["device"])
        assert rec["counters"]["occupancy"] == [dets.occupancy.tolist()]
        before = forward(params, pts, n, cfg, with_nms=False, device="cpu")
        assert rec["counters"]["boxes_before_nms"] == [int(before.count)]
    # the names an eager call's marks open, as parse_trace takes them
    assert profiler.mark_names(engine.eager) == stages + ("end",)


def test_replays_nest_their_spans_in_call(tiny, tracing, monkeypatch):
    cfg, params, frames = tiny
    engine = _captured(monkeypatch, cfg, params)
    got = [engine._traced_call(pts, n) for pts, n in frames]
    # the names the graph's marks open, as parse_trace takes them
    assert profiler.mark_names(engine) == STAGES + ("end",)
    replays = [r for r in profiler.spans() if r["kind"] == "replay"]
    assert [r["id"] for r in replays] == [2, 3]    # 1: the first replay
    for rec, dets, (pts, n) in zip(replays, got, frames):
        host = {s["name"]: s for s in rec["host"]}
        assert [s["name"] for s in rec["host"]] == [
            "call", "copy_in", "graph_launch", "copy_out"]
        for name in ("copy_in", "graph_launch", "copy_out"):
            assert host[name]["parent"] == "call"
            assert _inside(host[name], host["call"])
        assert [s["name"] for s in rec["device"]] == list(STAGES)
        assert all(s["parent"] == "graph_launch"
                   and _inside(s, host["graph_launch"])
                   for s in rec["device"])
        assert rec["counters"]["occupancy"] == [dets.occupancy.tolist()]
        ref = engine.eager(pts, n)
        for a, b in zip(dets, ref):
            assert torch.equal(a, b)


@pytest.mark.parametrize("on", [False, True])
def test_host_spans_are_profiler_labels_while_the_tracer_is_on(
        tiny, monkeypatch, tmp_path, on):
    cfg, params, frames = tiny
    if on:
        profiler.enable_spans()
    try:
        engine = _captured(monkeypatch, cfg, params)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            engine._traced_call(*frames[0])
    finally:
        profiler.disable_spans()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    labels = [e["name"] for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    for name in ("call", "copy_in", "graph_launch", "copy_out"):
        assert labels.count(name) == int(on), (name, labels)


def test_a_training_step_records_forward_backward_optimizer(tiny, tracing):
    cfg, _, _ = tiny
    step = CompiledTrainStep(cfg, _fresh(cfg), 1, device="cpu")
    pts, ns, targets = synthetic_batch(np.random.default_rng(0), cfg, 1,
                                       device="cpu")
    loss = step(pts, ns, targets)
    (rec,) = profiler.spans()
    assert (rec["what"], rec["owner"], rec["id"], rec["kind"]) == (
        "step", "CompiledTrainStep", 1, "eager")
    assert [s["name"] for s in rec["device"]] == list(profiler.TRAIN_STAGES)
    assert rec["device"][0]["end_ns"] == rec["device"][1]["start_ns"]
    assert all(_inside(s, rec["host"][0]) for s in rec["device"])
    assert torch.isfinite(loss)


def test_write_spans_round_trip(tiny, tracing, tmp_path):
    cfg, params, frames = tiny
    engine = Engine(params, cfg, device="cpu")
    for pts, n in frames:
        engine(pts, n)
    records = profiler.spans()
    path = profiler.write_spans(str(tmp_path / "spans.json"))
    trace = json.load(open(path))
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == sum(len(r["host"]) + len(r["device"])
                             for r in records)
    assert {e["pid"] for e in spans} == {0, 1}
    calls = [e for e in spans if e["name"] == "call"]
    assert [e["args"]["id"] for e in calls] == [1, 2]
    assert calls[0]["args"]["occupancy"] == records[0]["counters"]["occupancy"]
    first = records[0]["device"][0]
    voxelize = next(e for e in spans if e["name"] == "voxelize")
    assert voxelize["ts"] == pytest.approx(first["start_ns"] / 1e3)
    assert trace["otherData"] == {"clock": None}


def _ev(cat, name, ts, dur, tid=7, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
            "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _replay_trace(names):
    """One frame (host 0-900 us): its copy-in (a memcpy), then one graph
    launch whose device events all share its correlation id: per stage a
    mark then a kernel of 10 us, 100 us apart, then the end mark and a
    copy out."""
    u, rt = "user_annotation", "cuda_runtime"
    events = [_ev(u, "frame", 0, 900, tid=3),
              _ev(rt, "cudaMemcpyAsync", 5, 2, tid=3, corr=1),
              _ev(rt, "cudaGraphLaunch", 10, 5, tid=3, corr=2),
              _ev("gpu_memcpy", "Memcpy HtoD", 20, 5, corr=1)]
    t = 100
    for name in names:
        events.append(_ev("kernel", "stage_mark_kernel(unsigned long long*,"
                          " int)", t, 1, corr=2))
        if name != "end":
            events.append(_ev("kernel", f"{name}_kernel", t + 2, 10, corr=2))
        t += 100
    events.append(_ev("gpu_memcpy", "Memcpy DtoH", t, 5, corr=2))
    return events


@pytest.mark.parametrize("names", [
    STAGES + ("end",),
    STAGES[:-1] + ("end",),
    profiler.TRAIN_STAGES + ("end",),
])
def test_parse_trace_splits_a_replay_by_its_marks(tmp_path, names):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _replay_trace(names)}))
    prof = parse_trace(str(path), 1, marks=names)
    stages = [n for n in names if n != "end"]
    assert prof.stage_ms() == pytest.approx(
        {**{n: 0.011 for n in stages}, "other": 0.011})
    assert [r["name"] for r in prof.stage_ops(stages[0])] == [
        f"{stages[0]}_kernel", "stage_mark_kernel(unsigned long long*, int)"]


def _staged_frame(pools):
    """The marks of a staged frame with NMS: each pooling marked on entry
    and back into ``backbone3d`` after it (model/backbone3d.py)."""
    cut = STAGES.index("backbone3d") + 1
    return STAGES[:cut] + ("pool", "backbone3d") * pools + STAGES[cut:] + (
        "end",)


@pytest.mark.parametrize("pools", [1, 3])
def test_parse_trace_names_a_staged_frame(tmp_path, pools):
    # three poolings: 15 marks and "end", a count five training steps fit
    names = _staged_frame(pools)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _replay_trace(names)}))
    prof = parse_trace(str(path), 1, marks=names)
    assert prof.stage_ms() == pytest.approx(
        {**{n: 0.011 for n in STAGES}, "backbone3d": 0.011 * (pools + 1),
         "pool": 0.011 * pools, "other": 0.011})


def test_parse_trace_holds_the_marks_to_their_names(tmp_path):
    # two pillar frames of one graph without NMS: 16 marks and "end", as
    # many as one staged frame of four poolings without NMS
    names = STAGES[:-1] * 2 + ("end",)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _replay_trace(names)}))
    prof = parse_trace(str(path), 1, marks=names)
    assert prof.stage_ms() == pytest.approx(
        {**{n: 0.022 for n in STAGES[:-1]}, "other": 0.011})
    with pytest.raises(ValueError, match="not calls of the 10 marks"):
        parse_trace(str(path), 1, marks=STAGES + ("end",))
    with pytest.raises(ValueError, match="no names"):
        parse_trace(str(path), 1)


def test_parse_trace_refuses_marks_it_cannot_name(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": _replay_trace(
        ("a", "b", "end"))}))
    with pytest.raises(ValueError, match="3 stage marks"):
        parse_trace(str(path), 1)
    with pytest.raises(ValueError, match="3 stage marks"):
        parse_trace(str(path), 1, marks=STAGES + ("end",))
