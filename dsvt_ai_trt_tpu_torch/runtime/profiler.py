"""Per-stage FLOP counts and the port's tracer (port of the JAX package's
runtime/profiler.py).

* ``stage_scope(name)`` is what ``model/detector.py:forward`` runs each of
  its stages (``STAGES``) under: a ``record_function`` label, so a profiler
  trace of an eager frame splits it by stage (runtime/trace.py reads them),
  plus the hooks in ``_scopes``: the tracer's stage mark while the tracer
  is on, and ``count_flops``'s tally while it runs.
* ``count_flops(fn, *args)`` counts the FLOPs of one call, in total and per
  stage: ``torch.utils.flop_counter.FlopCounterMode`` over the call (it
  counts matmuls and convolutions), plus the FLOPs of every hand-written
  kernel launched during it, from the formula beside each wrapper
  (``kernels.count``): the counter sees nothing inside a ``ctypes`` launch.
  The formulas count what the counter counts for the plain versions (the
  products of B1 and B2) and the compares of B3 and B4, so an MFU means
  nearly the same work whichever version ran (B1's formula counts live
  sets only; B3's and B4's compares are a few MFLOP of a frame).  The
  counter has no formula for cuDNN's fused conv + bias (+ add) + ReLU
  (model/backbone2d.py); ``_fused_conv_flop`` gives it the conv's, so the
  fused and the plain BEV stack count the same FLOPs.
* ``device_peak_flops`` reads the card's name.

The tracer is off by default.  ``enable_spans()`` switches it on; call it
before an engine or a training step warms up, since its device marks are
captured into the graph.  It keeps one record in memory for each call of
an ``Engine`` (``what`` "frame") or a ``CompiledTrainStep`` ("step") and
for each of their warm-ups ("warmup"), with ``kind`` "replay" (a graph
replay), "eager" (the forward or step op by op) or "host" (a warm-up):

* host spans on ``time.perf_counter_ns``, each with its parent: a frame's
  ``call`` holds ``copy_in`` (``Engine._load``), ``graph_launch`` (the
  replay) and ``copy_out`` (the result's copies and the marks' copy); a
  step's ``call`` holds ``copy_in`` and ``graph_launch``; a warm-up's
  ``warmup`` holds ``kernels`` (build and load), ``warm_runs``,
  ``capture`` and, for an engine, ``first_replay``;
* device spans, one a stage, from stage marks: a one-thread kernel
  (``csrc/stage_mark.cu``) that stores the card's ``%globaltimer`` into a
  slot of the owner's ``Marks`` buffer on entry to each stage and once
  after the last ("end").  A frame marks the detector's ``STAGES``
  (10 marks with NMS; a staged backbone also each pooling; the
  TransFusion-L head its ``query`` stage inside ``head``, and no NMS:
  10 marks), a step
  ``TRAIN_STAGES`` (4 marks); ``mark_names`` gives the names a call's
  marks open, which a trace of the card needs (``runtime/trace.py``,
  which cannot read a mark's slot).  Inside a
  capture the launches are graph nodes, so every replay stamps its own
  frame.  A replay's stage spans have its ``graph_launch`` as parent, an
  eager call's its ``call``;
* counters the forward computes anyway, copied into the same buffer:
  ``occupancy`` (kept points, pillars, live sets per window spec) and
  ``boxes_before_nms``, one entry a frame; and one the host counts as the
  forward is traced or captured, written into the buffer as a constant:
  ``bev_restrides`` and ``bev_fused_convs`` (model/detector.py; the second
  a step's too, 0); a step's ``grad_gathers`` (the row gathers its forward
  ran as ``index_select``, ops/gather.py; parallel/training.py).  A
  TransFusion-L frame counts ``proposals`` (the (class, cell) scores above
  0 after the heatmap's local max, model/transfusion.py) and
  ``query_boxes`` (the boxes its decode keeps) in place of
  ``boxes_before_nms``.

Right after a replay the owner enqueues one copy of its marks buffer into
a ring of ``RING`` page-locked host slots, on the stream of the result's
copies, followed by an event, so a frame's marks reach the host with its
boxes and nothing waits for them.  ``spans()`` reads the ring with one
synchronise; a slot taken again (``RING`` calls later) is first read
after its own event, long passed.  On the CPU a mark reads the host
clock instead.

One clock: when the first marks buffer is made on a card (or the first
marks reach the ring, for an owner warmed before the tracer was switched
on again), and each time ``spans()`` reads the ring, the tracer launches a
mark into
page-locked host memory between two host clock reads ``CALIBRATION``
times (the second read when the host sees the mark arrive) and keeps the
tightest bracket: its middle is the mark's host time.  The card's clock
and the host's drift apart by tens of parts per million, so device spans
are given on the host clock by the line through the first and the latest
of these points; ``calibration()`` gives the offset, the widest kept
bracket and the drift.

With the tracer off, the program runs as it does without one: the same
graphs, with no mark node, and a call of an engine or a step makes one
check more.  With it on, while a ``torch.profiler`` records, each host
span is also a ``record_function`` label of its name, so a profiler trace
holds the program's host spans on its own clock.

``spans()`` returns the records, ``write_spans(path)`` writes them as a
Chrome trace (host and device spans on two tracks of one timeline): what
``cli infer --spans PATH`` and ``cli train --spans PATH`` do when the run
ends.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import (Callable, ContextManager, Dict, List, NamedTuple,
                    Optional, Tuple)

import torch
from torch.profiler import record_function
from torch.utils.flop_counter import (FlopCounterMode, conv_flop_count,
                                      register_flop_formula)

from .. import kernels

# stage hooks of the tracer and of the count_flops calls running now: each
# takes a stage name and gives a context manager to run the stage in
_scopes: List[Callable[[str], ContextManager]] = []


@contextlib.contextmanager
def stage_scope(name: str):
    """Run one detector stage: a profiler label, plus the active hooks."""
    with record_function(name):
        if not _scopes:
            yield
            return
        with contextlib.ExitStack() as stack:
            for scope in list(_scopes):
                stack.enter_context(scope(name))
            yield


@contextlib.contextmanager
def _hooked(scope: Callable[[str], ContextManager]):
    _scopes.append(scope)
    try:
        yield
    finally:
        _scopes.remove(scope)


@register_flop_formula([torch.ops.aten.cudnn_convolution_relu,
                        torch.ops.aten.cudnn_convolution_add_relu])
def _fused_conv_flop(x_shape, w_shape, *args, out_shape=None, **kwargs):
    """The FLOPs of the conv inside a fused cuDNN call: the epilogue, like
    every elementwise op, counts none."""
    return conv_flop_count(x_shape, w_shape, out_shape, transposed=False)


class FlopCount(NamedTuple):
    """FLOPs of one call: ``total``; per kernel name, the hand-written
    kernels' share (``kernels``); per stage label, kernels included
    (``stages``)."""

    total: float
    kernels: Dict[str, float]
    stages: Dict[str, float]


def count_flops(fn, *args) -> FlopCount:
    """Run ``fn(*args)`` once and count its FLOPs (module docstring)."""
    stages: Dict[str, float] = {}

    @contextlib.contextmanager
    def per_stage(name):
        with kernels.flop_tally() as tally, FlopCounterMode(display=False) as fc:
            yield
        stages[name] = (stages.get(name, 0.0) + fc.get_total_flops()
                        + sum(tally.values()))

    with _hooked(per_stage), kernels.flop_tally() as tally, \
            FlopCounterMode(display=False) as fc:
        fn(*args)
    return FlopCount(float(fc.get_total_flops() + sum(tally.values())),
                     dict(tally), stages)


def program_flops(fn, *args) -> float:
    """Total FLOPs of one call of ``fn(*args)`` (``count_flops``)."""
    return count_flops(fn, *args).total


# Dense peak FLOP/s by card name and precision, from NVIDIA's data sheets
# (SXM and PCIe parts): "bf16" and "mixed" run their products on the bf16
# tensor cores, "fp32" on the f32 units with TF32 off (ops/common.py).
_PEAKS = (
    ("H100 PCIe", {"bf16": 756e12, "mixed": 756e12, "fp32": 51e12}),
    ("H100", {"bf16": 989e12, "mixed": 989e12, "fp32": 67e12}),
)


def device_peak_flops(precision: str = "bf16", device=None) -> float:
    """Peak FLOP/s of the card at ``precision`` (0.0 for a card not in the
    table, or without a card)."""
    if not torch.cuda.is_available():
        return 0.0
    if device is not None and torch.device(device).type != "cuda":
        return 0.0
    name = torch.cuda.get_device_name(device)
    for key, peaks in _PEAKS:
        if key in name:
            return peaks[precision]
    return 0.0


# ---------------------------------------------------------------------------
# The tracer (module docstring)
# ---------------------------------------------------------------------------

TRAIN_STAGES = ("forward", "backward", "optimizer")
MAX_SLOTS = 512      # marks and counter values one buffer holds
RING = 256           # page-locked host slots of marks copies
CALIBRATION = 20     # host brackets of one mark
_TOP = {"frame": "call", "step": "call", "warmup": "warmup"}

_tracer: Optional["Tracer"] = None


def _launch_mark(buf: torch.Tensor, slot: int) -> None:
    """Kernel ``stage_mark``: ``buf[slot]`` = the card's clock, in stream
    order."""
    kernels.require_cuda("stage_mark", buf)
    kernels.count("stage_mark")
    kernels.launch("stage_mark", buf.data_ptr(), slot)


class Marks:
    """An owner's buffer of stage marks and counter values: ``MAX_SLOTS``
    int64 on its device, and ``entries``, what the slots written since
    ``reset`` hold: (kind "mark" or "counter", the stage the mark opens
    or the counter's name, first slot, slots)."""

    def __init__(self, device):
        self.buf = torch.zeros(MAX_SLOTS, dtype=torch.int64, device=device)
        self.entries: List[Tuple[str, str, int, int]] = []
        self.used = 0

    def reset(self) -> None:
        self.entries, self.used = [], 0

    def _take(self, kind: str, name: str, n: int) -> int:
        first = self.used
        if first + n > MAX_SLOTS:
            raise ValueError(f"stage marks: more than {MAX_SLOTS} marks and "
                             "counter values in one call")
        self.entries.append((kind, name, first, n))
        self.used += n
        return first

    def mark(self, name: str) -> None:
        slot = self._take("mark", name, 1)
        if self.buf.is_cuda:
            _launch_mark(self.buf, slot)
        else:
            self.buf[slot] = time.perf_counter_ns()

    def names(self) -> Tuple[str, ...]:
        """The stages the marks written since ``reset`` open, in order
        ("end" last)."""
        return tuple(name for kind, name, _, _ in self.entries
                     if kind == "mark")

    def counter(self, name: str, value) -> None:
        if isinstance(value, int):        # a host count: a fill, no copy
            self.buf[self._take("counter", name, 1)].fill_(value)
            return
        flat = value.reshape(-1)
        first = self._take("counter", name, flat.numel())
        self.buf[first:first + flat.numel()].copy_(flat)


class Tracer:
    """The records, the ring of host slots, the marks buffer the stage
    hooks write to now (``active``), the records being built (``open``,
    innermost last) and the calibration."""

    def __init__(self):
        self.records: List[dict] = []
        self.ring: Optional[torch.Tensor] = None
        # per ring slot: the record whose marks it holds and the event
        # after their copy
        self.held: List[Optional[Tuple[dict, torch.cuda.Event]]] = \
            [None] * RING
        self.next_slot = 0
        self.active: Optional[Marks] = None
        self.open: List[dict] = []
        self.points: List[Tuple[int, int, int]] = []   # card ns, host ns, bracket

    def calibrate(self, device) -> None:
        """Bracket marks between two host clock reads and keep the
        tightest bracket's offset and width (module docstring).  The mark
        writes the card's clock straight into page-locked host memory (the
        card reaches it at the host's address) and the host spins until it
        sees it, so a bracket holds the launch and one write over the bus,
        not a synchronisation."""
        host = torch.zeros(1, dtype=torch.int64, pin_memory=True)
        seen = host.numpy()
        entry = getattr(kernels.lib("stage_mark"), kernels.SPECS[
            "stage_mark"][1])
        best = None
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            ptr = host.data_ptr()
            for i in range(CALIBRATION + 1):   # the first loads the kernel
                seen[0] = 0
                kernels.count("stage_mark")
                t0 = time.perf_counter_ns()
                if entry(ptr, 0, stream):
                    raise RuntimeError("stage marks: the calibrating mark "
                                       "failed to launch")
                while seen[0] == 0:
                    if time.perf_counter_ns() - t0 > 10**9:
                        raise RuntimeError("stage marks: the calibrating "
                                           "mark never reached the host")
                t1 = time.perf_counter_ns()
                torch.cuda.synchronize(device)
                if i and (best is None or t1 - t0 < best[2]):
                    best = (int(seen[0]), (t0 + t1) // 2, t1 - t0)
        self.points.append(best)

    def to_host(self, stamp: int) -> int:
        """A card clock reading on the host clock (module docstring)."""
        (g0, h0, _), (g1, h1, _) = self.points[0], self.points[-1]
        rate = (h1 - h0) / (g1 - g0) if g1 > g0 else 1.0
        return h0 + round((stamp - g0) * rate)

    def take(self, rec: dict, marks: Marks) -> None:
        """Send ``marks``' slots to ``rec``: copied now on the CPU, else
        into the ring in stream order, read by ``drain``; decoded by
        ``spans``."""
        layout = list(marks.entries)
        if not marks.buf.is_cuda:
            rec["_marks"] = (layout, marks.buf[:marks.used].clone(), False)
            return
        if not self.points:
            self.calibrate(marks.buf.device)
        if self.ring is None:
            self.ring = torch.empty((RING, MAX_SLOTS), dtype=torch.int64,
                                    pin_memory=True)
        slot, self.next_slot = self.next_slot, (self.next_slot + 1) % RING
        if self.held[slot] is not None:
            self.held[slot][1].synchronize()
            self._read(slot)
        self.ring[slot, :marks.used].copy_(marks.buf[:marks.used],
                                           non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(torch.cuda.current_stream(marks.buf.device))
        rec["_marks"] = (layout, (slot, marks.used), True)
        self.held[slot] = (rec, copied)

    def _read(self, slot: int) -> None:
        """Take a slot's values out of the ring, its copy done."""
        rec = self.held[slot][0]
        layout, (_, used), on_card = rec["_marks"]
        rec["_marks"] = (layout, self.ring[slot, :used].clone(), on_card)
        self.held[slot] = None

    def drain(self) -> None:
        """Wait once for every copy in the ring and take its values out."""
        if not any(self.held):
            return
        torch.cuda.synchronize()
        for slot in range(RING):
            if self.held[slot] is not None:
                self._read(slot)

    def decode(self, rec: dict) -> None:
        """A drained record's marks as device spans on the host clock, and
        its counters."""
        layout, values, on_card = rec.pop("_marks")
        values = values.tolist()
        parent = "graph_launch" if rec["kind"] == "replay" else \
            _TOP[rec["what"]]
        marks = [(name, self.to_host(values[first]) if on_card
                  else values[first])
                 for kind, name, first, _ in layout if kind == "mark"]
        rec["device"] = [{"name": name, "start_ns": t0, "end_ns": t1,
                          "parent": parent}
                         for (name, t0), (_, t1) in zip(marks, marks[1:])]
        for kind, name, first, n in layout:
            if kind == "counter":
                value = values[first:first + n] if n > 1 else values[first]
                rec["counters"].setdefault(name, []).append(value)


def enable_spans() -> None:
    """Switch the tracer on (module docstring); on already, nothing."""
    global _tracer
    if _tracer is None:
        _tracer = Tracer()
        _scopes.append(_stage_mark)


def disable_spans() -> None:
    """Switch the tracer off and drop its records."""
    global _tracer
    if _tracer is not None:
        _tracer = None
        _scopes.remove(_stage_mark)


def tracer() -> Optional[Tracer]:
    """The tracer, or None while it is off."""
    return _tracer


def mark_names(fn) -> Optional[Tuple[str, ...]]:
    """The stages the marks of a call of ``fn`` open, in order, "end" last:
    of the graph of ``fn``, an ``Engine`` or a ``CompiledTrainStep``, or,
    for its ``eager`` method, of its last eager call; None where there are
    no marks (the tracer off, or no call yet)."""
    owner = getattr(fn, "__self__", fn)
    eager = getattr(fn, "__name__", None) == "eager"
    marks = getattr(owner, "_eager_marks" if eager else "_marks", None)
    return marks.names() if marks is not None and marks.entries else None


def new_marks(device) -> Optional[Marks]:
    """A marks buffer on ``device`` while the tracer is on (the first on a
    card calibrates the clock), else None.  Not inside a capture."""
    if _tracer is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and not _tracer.points:
        _tracer.calibrate(device)
    return Marks(device)


@contextlib.contextmanager
def marking(marks: Optional[Marks]):
    """Send the stage marks and counters of the block to ``marks``, and mark
    "end" when it ends; with ``marks`` None or the tracer off, nothing."""
    tr = _tracer
    if marks is None or tr is None:
        yield
        return
    marks.reset()
    saved, tr.active = tr.active, marks
    try:
        yield
        marks.mark("end")
    finally:
        tr.active = saved


def mark(name: str) -> None:
    """Mark the entry of stage ``name`` in the buffer of ``marking``."""
    if _tracer is not None and _tracer.active is not None:
        _tracer.active.mark(name)


def counter(name: str, value) -> None:
    """Copy ``value`` (integers on the marks' device, or a Python int) into
    the buffer of ``marking`` as counter ``name``."""
    if _tracer is not None and _tracer.active is not None:
        _tracer.active.counter(name, value)


@contextlib.contextmanager
def _stage_mark(name: str):
    mark(name)
    yield


@contextlib.contextmanager
def record(what: str, owner: str, ident: int, kind: str):
    """A record of the tracer (``what`` "frame", "step" or "warmup"; its
    top host span ``call`` or ``warmup``) that the block's host spans go
    to; yields it, or None (and records nothing) while the tracer is
    off."""
    tr = _tracer
    rec = None
    if tr is not None:
        rec = {"what": what, "owner": owner, "id": ident, "kind": kind,
               "host": [], "device": [], "counters": {}, "_stack": []}
        tr.open.append(rec)
    try:
        with span(_TOP[what]):
            yield rec
    finally:
        if rec is not None:
            tr.open.pop()              # records nest: this is the last
            del rec["_stack"]
            tr.records.append(rec)


@contextlib.contextmanager
def span(name: str):
    """A host span of the innermost open record (nothing while there is
    none), and a profiler label of the same name while a
    ``torch.profiler`` records."""
    rec = _tracer.open[-1] if _tracer is not None and _tracer.open else None
    if rec is None:
        yield
        return
    with (record_function(name) if torch.autograd._profiler_enabled()
          else contextlib.nullcontext()):
        stack = rec["_stack"]
        entry = {"name": name, "start_ns": time.perf_counter_ns(),
                 "end_ns": None, "parent": stack[-1]["name"] if stack
                 else None}
        rec["host"].append(entry)
        stack.append(entry)
        try:
            yield
        finally:
            entry["end_ns"] = time.perf_counter_ns()
            stack.pop()


def take(rec: Optional[dict], marks: Optional[Marks]) -> None:
    """Send ``marks`` to ``rec`` after the replay or eager call that wrote
    them (``Tracer.take``); nothing when either is None."""
    if rec is not None and marks is not None and _tracer is not None:
        _tracer.take(rec, marks)


def traced_eager(owner, what: str, fn: Callable):
    """Run ``fn()``, an owner's eager call, as a record of kind "eager"
    numbered by ``owner.calls``, its marks in the buffer the owner keeps
    for eager calls (``owner._eager_marks``, made on first use)."""
    owner.calls += 1
    with record(what, type(owner).__name__, owner.calls, "eager") as rec:
        if owner._eager_marks is None:
            owner._eager_marks = new_marks(owner.device)
        with marking(owner._eager_marks):
            out = fn()
        take(rec, owner._eager_marks)
    return out


def spans() -> List[dict]:
    """The tracer's records, their marks read (one synchronise for those
    still in the ring), device spans on the host clock; [] while it is
    off.  A record: ``what``, ``owner`` (the class), ``id`` (the owner's
    call number; 0 for a warm-up), ``kind``, ``host`` and ``device`` (spans:
    ``name``, ``start_ns``, ``end_ns``, ``parent``) and ``counters`` (name:
    one value, or list of values, an entry)."""
    if _tracer is None:
        return []
    _tracer.drain()
    if _tracer.points:
        _tracer.calibrate(torch.device("cuda", torch.cuda.current_device()))
    for rec in _tracer.records:
        if "_marks" in rec:
            _tracer.decode(rec)
    return [dict(r) for r in _tracer.records]


def calibration() -> Optional[Dict[str, float]]:
    """Once a marks buffer was made on a card: the first point's offset
    (host ns - card ns), the widest of the kept brackets (ns), the drift of
    the host clock against the card's between the first and the latest
    point (parts per million) and the number of points; else None."""
    if _tracer is None or not _tracer.points:
        return None
    (g0, h0, _), (g1, h1, _) = _tracer.points[0], _tracer.points[-1]
    return {"offset_ns": h0 - g0,
            "bracket_ns": max(b for _, _, b in _tracer.points),
            "drift_ppm": ((h1 - h0) / (g1 - g0) - 1) * 1e6 if g1 > g0
            else 0.0, "points": len(_tracer.points)}


def write_spans(path: str) -> str:
    """Write the records as a Chrome trace (``chrome://tracing``, Perfetto):
    one "X" event a span, in us on the host clock, host spans as process
    0, device spans as process 1, a thread per owner; each record's
    ``what``, ``id``, ``kind`` and counters in its top span's ``args``, the
    calibration under ``otherData``.  Returns ``path``."""
    records = spans()
    owners = sorted({r["owner"] for r in records})
    events = [{"ph": "M", "name": "process_name", "pid": pid,
               "args": {"name": name}}
              for pid, name in ((0, "host"), (1, "device"))]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": owner}}
               for pid in (0, 1) for tid, owner in enumerate(owners)]
    for r in records:
        tid = owners.index(r["owner"])
        ids = {"what": r["what"], "id": r["id"], "kind": r["kind"]}
        for pid, track in ((0, r["host"]), (1, r["device"])):
            for s in track:
                args = dict(ids, parent=s["parent"])
                if s["parent"] is None:
                    args.update(r["counters"])
                events.append({"ph": "X", "pid": pid, "tid": tid,
                               "name": s["name"],
                               "cat": "host" if pid == 0 else "device",
                               "ts": s["start_ns"] / 1e3,
                               "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                               "args": args})
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"clock": calibration()}}, f)
    return path
