"""Trace-derived per-stage device timing (port of the JAX package's
runtime/trace.py).

``capture(fn, args, iters)`` runs ``fn(*args)`` ``iters`` times, each under
``record_function("frame")``, inside ``torch.profiler`` (host and card),
exports the Chrome trace and parses it (``parse_trace``):

  * device events are those of category ``kernel``, ``gpu_memcpy`` and
    ``gpu_memset``;
  * each event belongs to the frame, and to the stage (the labels of
    ``model/detector.py:STAGES``, which ``forward`` runs each stage under),
    whose host ``user_annotation`` span holds the host call that launched
    it (the ``cuda_runtime`` or ``cuda_driver`` event of the same
    ``correlation`` id), else to no frame, or to stage ``other``;
  * a CUDA graph replay's events all tie to the one graph launch, and the
    stage labels ran only during the capture; where a frame holds the
    tracer's stage marks (``stage_mark_kernel``, captured into the graph
    while ``runtime.profiler.enable_spans`` was on), each of its events
    that no label holds goes to the stage whose mark last ran before it
    (the mark itself included; the closing "end" mark and what follows it
    stay ``other``), so ``capture(engine, ...)`` splits the served graph
    (by the names its marks were placed under, ``profiler.mark_names``);
  * a frame's window on the device timeline runs from the start of its
    first event to the end of its last.

This takes the place of the JAX parser's attribution of HLO ops by source
file.  The ``gpu_user_annotation`` spans that ``torch.profiler`` also
writes are not used: on the H100 with torch 2.11 the first ``frame`` span
of a capture came out 1.4 us long, and that frame's 11.9 ms of kernels lay
outside every span.

``DeviceProfile`` gives device ms per iteration, the device's idle share of
the frame windows, per-stage ms, a per-stage table with GFLOP and MFU
(``runtime/profiler.count_flops`` under the same labels), the top device
ops, and each stage's host ms (its ``user_annotation`` spans).

On the CPU (``capture(..., device="cpu")``) the same parse reads the host
timeline instead: the outermost ``cpu_op`` events are the ops, each in the
frame and stage whose span holds its start.  Its numbers are host times,
and ``DeviceProfile.timeline`` says so ("host").  A trace whose frame spans
do not match the iterations, or a frame without events, raises.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import itertools
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..model.detector import STAGES
from .profiler import FlopCount, count_flops, mark_names

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "stage_mark_kernel"     # csrc/stage_mark.cu


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Length in ms of the union of (start, end) intervals in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def _outermost(ops: List[dict]) -> List[dict]:
    """Host ops not inside an earlier-starting op of the same thread."""
    out, end = [], {}
    for e in sorted(ops, key=lambda e: (e["tid"], e["ts"], -e["dur"])):
        if e["ts"] >= end.get(e["tid"], float("-inf")):
            out.append(e)
            end[e["tid"]] = e["ts"] + e["dur"]
    return out


class DeviceProfile:
    """Parsed result of one trace capture (all times per iteration)."""

    def __init__(self, timeline: str, n_iters: int,
                 windows: List[Tuple[float, float]], ops: List[dict],
                 span_ms: Dict[str, float], host_ms: Dict[str, float],
                 runtime_ms: Optional[Dict[str, float]] = None):
        self.timeline = timeline      # "device" or "host"
        self.n_iters = n_iters
        self.windows = windows        # (start, end) us of each frame
        self.ops = ops                # name, ts, dur, frame, stage
        self._span_ms = span_ms       # per stage, span length on timeline
        self._host_ms = host_ms       # per label (stages, "frame"), host ms
        self.runtime_ms = runtime_ms or {}   # per CUDA call name, in frames
        self.flops: Optional[FlopCount] = None   # set by capture

    def _per_iter(self, value: float) -> float:
        return value / max(self.n_iters, 1)

    @property
    def device_ms_per_iter(self) -> float:
        """Busy time of the timeline for the frames' work."""
        return self._per_iter(_union_ms(
            [(o["ts"], o["ts"] + o["dur"]) for o in self.ops]))

    def window_busy_ms(self) -> List[float]:
        """Busy ms of each frame."""
        return [_union_ms([(o["ts"], o["ts"] + o["dur"]) for o in self.ops
                           if o["frame"] == i])
                for i in range(len(self.windows))]

    @property
    def window_ms_per_iter(self) -> float:
        """Length of a frame's span on the timeline, from the start of its
        first event to the end of its last."""
        return self._per_iter(sum(e - s for s, e in self.windows) / 1e3)

    @property
    def host_ms_per_iter(self) -> float:
        """Host time of a frame's call (its ``frame`` host span)."""
        return self._per_iter(self._host_ms.get("frame", 0.0))

    def _runtime_ms(self, *words) -> float:
        return self._per_iter(sum(ms for name, ms in self.runtime_ms.items()
                                  if any(w in name for w in words)))

    @property
    def host_wait_ms_per_iter(self) -> float:
        """Host time of a frame spent in CUDA calls that wait for the card
        (synchronisations and copies)."""
        return self._runtime_ms("Synchronize", "Memcpy")

    @property
    def host_launch_ms_per_iter(self) -> float:
        """Host time of a frame spent in kernel launch calls."""
        return self._runtime_ms("Launch")

    @property
    def idle_share(self) -> float:
        """Share of the frame windows in which the timeline ran nothing."""
        window = self.window_ms_per_iter
        return 1.0 - self.device_ms_per_iter / window if window else 0.0

    def stage_ms(self) -> Dict[str, float]:
        """Per-stage busy ms (sums to about ``device_ms_per_iter``)."""
        out: Dict[str, float] = collections.defaultdict(float)
        for o in self.ops:
            out[o["stage"]] += o["dur"] / 1e3
        return {k: self._per_iter(v)
                for k, v in sorted(out.items(), key=lambda kv: -kv[1])}

    def stage_table(self, peak_flops: Optional[float] = None
                    ) -> Dict[str, dict]:
        """Per stage: device ms, GFLOP (``count_flops`` of one call, under
        the same labels) and, with ``peak_flops``, the MFU."""
        flops = self.flops.stages if self.flops else {}
        out = {}
        for stage, ms in self.stage_ms().items():
            row = {"ms": ms, "gflop": flops.get(stage, 0.0) / 1e9}
            if peak_flops and ms > 0:
                row["mfu"] = flops.get(stage, 0.0) / (ms / 1e3) / peak_flops
            out[stage] = row
        return out

    def stage_spans(self) -> Dict[str, dict]:
        """Per stage: host ms (its host spans), its span on the timeline
        and the busy ms of the ops inside."""
        busy = self.stage_ms()
        return {s: {"host_ms": self._per_iter(self._host_ms.get(s, 0.0)),
                    "span_ms": self._per_iter(self._span_ms.get(s, 0.0)),
                    "busy_ms": busy.get(s, 0.0)} for s in STAGES}

    def _rows(self, ops) -> List[dict]:
        agg: Dict[str, dict] = {}
        for o in ops:
            row = agg.setdefault(o["name"], {"name": o["name"], "ms": 0.0,
                                             "calls": 0})
            row["ms"] += o["dur"] / 1e3
            row["calls"] += 1
        return sorted(({**r, "ms": self._per_iter(r["ms"]),
                        "calls": r["calls"] / max(self.n_iters, 1)}
                       for r in agg.values()), key=lambda r: -r["ms"])

    def top_ops(self, n: int = 20) -> List[dict]:
        """The ``n`` ops of most time: name, ms and calls per iteration."""
        return self._rows(self.ops)[:n]

    def stage_ops(self, stage: str, n: int = 8) -> List[dict]:
        """The ``n`` ops of most time within one stage."""
        return self._rows([o for o in self.ops if o["stage"] == stage])[:n]

    def report(self, top: int = 20) -> str:
        lines = [f"{self.timeline} time: {self.device_ms_per_iter:.3f} ms/iter "
                 f"over {self.n_iters} iterations, idle "
                 f"{self.idle_share:.1%} of the frame windows",
                 f"{'stage':<24}{'ms/iter':>9}"]
        lines += [f"{k:<24}{v:>9.3f}" for k, v in self.stage_ms().items()]
        lines += ["", f"{'op':<64}{'ms/iter':>9}{'calls':>7}"]
        lines += [f"{r['name'][:63]:<64}{r['ms']:>9.3f}{r['calls']:>7.0f}"
                  for r in self.top_ops(top)]
        return "\n".join(lines)


def _mark_names(count: int, marks: Optional[Sequence[str]]
                ) -> Tuple[str, ...]:
    """The stages ``count`` marks of a frame open: ``marks``, the names the
    graph's owner placed (``profiler.mark_names``: one call of the graph,
    "end" last), once a call."""
    if marks is None:
        raise ValueError(f"{count} stage marks in a frame, and no names for "
                         "them: pass the names their owner placed "
                         "(profiler.mark_names)")
    calls, rest = divmod(count, len(marks))
    if calls and not rest and marks[-1] == "end":
        return tuple(marks) * calls
    raise ValueError(f"{count} stage marks in a frame are not calls of the "
                     f"{len(marks)} marks their owner placed")


def _split_by_marks(rows: List[dict], n_iters: int,
                    marks: Optional[Sequence[str]]) -> None:
    """Give each frame's events that no stage label holds to the stage
    whose mark last ran before them (module docstring)."""
    for i in range(n_iters):
        mine = sorted((r for r in rows if r["frame"] == i),
                      key=lambda r: r["ts"])
        count = sum(MARK in r["name"] for r in mine)
        if not count:
            continue
        names = _mark_names(count, marks)
        k = -1
        for r in mine:
            k += MARK in r["name"]
            if r["stage"] == "other" and k >= 0 and names[k] != "end":
                r["stage"] = names[k]


def parse_trace(path: str, n_iters: int, timeline: str = "device",
                marks: Optional[Sequence[str]] = None) -> DeviceProfile:
    """Parse a Chrome trace that ``torch.profiler`` exported (.json or
    .json.gz) of ``n_iters`` frames (see the module docstring).  A frame's
    stage marks open, in order, ``marks`` (the names the graph's owner
    placed, "end" last; ``profiler.mark_names``) once a call of the graph.
    Raises when the trace holds another number of ``frame`` host spans, a
    frame with no event on the timeline, or a frame with marks that are
    not a number of calls of ``marks`` (or with marks and no ``marks``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("cat") == "user_annotation"]
    frames = sorted((e["ts"], e["ts"] + e["dur"]) for e in host
                    if e["name"] == "frame")
    if len(frames) != n_iters:
        raise ValueError(f"{path}: {len(frames)} 'frame' host spans for "
                         f"{n_iters} iterations")
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in host
                   if e["name"] in STAGES)
    host_ms: Dict[str, float] = collections.defaultdict(float)
    for e in host:
        if e["name"] in STAGES or e["name"] == "frame":
            host_ms[e["name"]] += e["dur"] / 1e3

    def inside(ts, table):
        i = bisect.bisect_right(table, (ts, float("inf"))) - 1
        return i if i >= 0 and ts <= table[i][1] else None

    runtime_ms: Dict[str, float] = collections.defaultdict(float)
    if timeline == "device":
        runtime = [e for e in events
                   if e.get("cat") in ("cuda_runtime", "cuda_driver")]
        # the host call that launched each device event (same correlation)
        launch = {e["args"]["correlation"]: e["ts"] for e in runtime
                  if "correlation" in e.get("args", {})}
        for e in runtime:
            if inside(e["ts"], frames) is not None:
                runtime_ms[e["name"]] += e["dur"] / 1e3
        ops = [(e, launch.get(e.get("args", {}).get("correlation")))
               for e in events if e.get("cat") in DEVICE_CATS]
    else:
        ops = [(e, e["ts"]) for e in _outermost(
            [e for e in events if e.get("cat") == "cpu_op"])]
    rows = []
    for e, anchor in ops:
        frame = None if anchor is None else inside(anchor, frames)
        if frame is None:
            continue
        span = inside(anchor, spans)
        rows.append({"name": e["name"], "ts": e["ts"], "dur": e["dur"],
                     "frame": frame,
                     "stage": spans[span][2] if span is not None else "other"})
    if timeline == "device":
        _split_by_marks(rows, n_iters, marks)
    windows = []
    for i in range(n_iters):
        mine = [(r["ts"], r["ts"] + r["dur"]) for r in rows if r["frame"] == i]
        if not mine:
            raise ValueError(f"{path}: frame {i} has no {timeline} events")
        windows.append((min(s for s, _ in mine), max(e for _, e in mine)))
    span_ms: Dict[str, float] = collections.defaultdict(float)
    for (_frame, stage), group in itertools.groupby(
            sorted(rows, key=lambda r: (r["frame"], r["stage"])),
            key=lambda r: (r["frame"], r["stage"])):
        group = list(group)
        span_ms[stage] += (max(r["ts"] + r["dur"] for r in group)
                           - min(r["ts"] for r in group)) / 1e3
    return DeviceProfile(timeline, n_iters, windows, rows, dict(span_ms),
                         dict(host_ms), dict(runtime_ms))


def capture(fn: Callable, args: tuple, iters: int = 10,
            device="cuda") -> DeviceProfile:
    """Run ``fn(*args)`` ``iters`` times (after one warm call) under
    ``torch.profiler`` and parse the trace; then count one call's FLOPs by
    stage (``profile.flops``) for ``stage_table``: of ``fn.eager`` where
    ``fn`` has one (an ``Engine``, a ``CompiledTrainStep``), since the
    counter sees nothing of a graph replay."""
    from torch.profiler import ProfilerActivity, profile, record_function

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    fn(*args)
    sync()
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        for _ in range(iters):
            with record_function("frame"):
                fn(*args)
        sync()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        result = parse_trace(path, iters, "device" if on_card else "host",
                             mark_names(fn))
    result.flops = count_flops(getattr(fn, "eager", fn), *args)
    return result
