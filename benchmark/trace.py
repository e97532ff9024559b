"""The traced window: a ``torch.profiler`` trace of the card, parsed.

The parse is a copy of the arithmetic of the port's
``runtime/trace.parse_trace``: device events are the trace's ``kernel``,
``gpu_memcpy`` and ``gpu_memset`` events; each is tied to the host call
that launched it (the ``cuda_runtime`` / ``cuda_driver`` event of the
same ``correlation`` id), and so to the harness's host spans
(``record_function`` labels) and the port's stage labels around that
call; busy time is the union of the device intervals.  A graph replay's
kernels all tie to the one launch of the graph, inside the frame's
``enqueue`` span.
"""

from __future__ import annotations

import bisect
import collections
import json
import os
import tempfile
from typing import Dict, List, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_s(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length in s of the union of (start, end) intervals in us."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e6


def merged(intervals):
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device events (name, ts, dur in us, the labels around their launch)
    and host spans of one traced window."""

    def __init__(self, events: List[dict], spans: List[Tuple]):
        self.events = events          # {"name", "ts", "dur", "labels"}
        self.spans = spans            # (start, end, name), host

    def busy_s(self, events=None) -> float:
        events = self.events if events is None else events
        return union_s([(e["ts"], e["ts"] + e["dur"]) for e in events])

    def window_s(self, events=None) -> float:
        events = self.events if events is None else events
        if not events:
            return 0.0
        return (max(e["ts"] + e["dur"] for e in events)
                - min(e["ts"] for e in events)) / 1e6

    def in_span(self, label: str, index: int) -> List[dict]:
        """Events launched inside the ``index``-th span named ``label``."""
        return [e for e in self.events if (label, index) in e["labels"]]

    def n_spans(self, label: str) -> int:
        return sum(1 for s in self.spans if s[2] == label)

    def kernel_s(self, words: Sequence[str]) -> float:
        return sum(e["dur"] for e in self.events
                   if any(w in e["name"] for w in words)) / 1e6

    def label_s(self, label: str) -> float:
        """Device seconds of the events launched under any span ``label``."""
        return sum(e["dur"] for e in self.events
                   if any(lab == label for lab, _ in e["labels"])) / 1e6

    def top_ops(self, n: int = 10):
        total: Dict[str, float] = collections.defaultdict(float)
        for e in self.events:
            total[e["name"]] += e["dur"] / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, names: Sequence[str], n: int = 10):
        """Idle gaps between busy stretches of the device, summed by the
        innermost of the harness spans ``names`` the host was in when the
        gap began ("other" when in none)."""
        busy = merged([(e["ts"], e["ts"] + e["dur"]) for e in self.events])
        host = sorted(s for s in self.spans if s[2] in names)
        total: Dict[str, float] = collections.defaultdict(float)
        for (_, end), (start, _) in zip(busy, busy[1:]):
            inner = [s for s in host if s[0] <= end < s[1]]
            name = min(inner, key=lambda s: s[1] - s[0])[2] if inner \
                else "other"
            total[name] += (start - end) / 1e6
        return sorted(([k, v] for k, v in total.items()),
                      key=lambda kv: -kv[1])[:n]


def parse(path: str) -> Trace:
    with open(path) as f:
        raw = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    labels = [e for e in raw if e.get("cat") == "user_annotation"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in labels)
    # each label's spans in time order, numbered per name
    index: Dict[str, int] = collections.defaultdict(int)
    numbered = []
    for s, e, name in spans:
        numbered.append((s, e, name, index[name]))
        index[name] += 1
    starts = [s[0] for s in numbered]
    launch = {e["args"]["correlation"]: e["ts"] for e in raw
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    events = []
    for e in raw:
        if e.get("cat") not in DEVICE_CATS:
            continue
        at = launch.get(e.get("args", {}).get("correlation"))
        held = set()
        if at is not None:
            # spans are short and few overlap: look back from the launch
            i = bisect.bisect_right(starts, at) - 1
            while i >= 0 and at - numbered[i][0] < 60e6:
                s, end, name, k = numbered[i]
                if s <= at <= end:
                    held.add((name, k))
                i -= 1
        events.append({"name": e["name"], "ts": float(e["ts"]),
                       "dur": float(e["dur"]), "labels": held})
    return Trace(events, [(s, e, n) for s, e, n in spans])


def capture(fn, device) -> Tuple[object, Trace]:
    """Run ``fn()`` under the profiler (host and card), synchronise, and
    parse the trace; returns (what ``fn`` returned, the trace)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    on_card = torch.device(device).type == "cuda"
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return out, parse(path)


def stage_ms(trace: Trace, stages: Sequence[str], frames: int) -> Dict[str, float]:
    """Device ms a frame under each stage label."""
    return {s: trace.label_s(s) * 1e3 / max(frames, 1) for s in stages}

