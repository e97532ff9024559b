"""Frame loops: the reference's -d mode, in PyTorch (port of the JAX
package's runtime/infer.py).

``run_frames`` iterates .bin frames through an ``Engine`` and writes one
reference-format result txt per frame (first line = seconds), warning when
a frame's occupancy reaches a static cap (points, pillars or sets were then
dropped, as the reference does).  It is software-pipelined: frames are
staged in pageable host memory; dispatching one copies it into one of
``pipeline_depth + 1`` reusable pinned buffers, hands that buffer to the
engine, which copies it into its graph's static input buffer without
blocking and replays the graph, then starts non-blocking copies of boxes,
count and occupancy into pinned buffers and records a CUDA event;
``finish`` waits on that event.  Up to ``pipeline_depth`` frames are in
flight, so the pinned memory held does not grow with the frame count.
Nothing in a frame blocks the host: the forward reads nothing back
(runtime/compile.py), so the host runs ahead by ``pipeline_depth`` frames.

Why the reuse of buffers is safe with frames in flight: everything of a
frame is enqueued on one stream, in the order input copy, replay, copies
of the outputs, copies to the host, event.  The static input buffer is
overwritten by the next frame's copy, which the stream runs after this
frame's replay has read it; the graph's static outputs are overwritten by
the next replay, which the stream runs after this frame's copies of them
(``Engine.__call__`` returns those copies); and a pinned frame buffer is
refilled by the host only after the event recorded behind its frame's
replay has completed.

``run_frames_scan`` is the throughput mode (``model.detector.forward_scan``
over groups of ``batch`` frames, eager: no graph yet) and ``benchmark``
the steady-state ms per frame of the pipelined loop.  ``Engine`` lives in runtime/compile.py and is
re-exported here.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import DSVTConfig
from ..io.host_nms import nms_host
from ..io.output import save_txt
from ..io.pointcloud import load_bin
from ..model.detector import forward_scan
from .compile import Engine

__all__ = ["Engine", "run_frames", "run_frames_scan", "benchmark",
           "pipelined_ms", "cap_table"]

log = logging.getLogger("dsvt_torch.infer")


def cap_table(cfg: DSVTConfig):
    """Cap names and values in ``Detections.occupancy`` order."""
    names = ["max_kept_points", "max_pillars"] + [
        f"max_sets[{i}]" for i in range(len(cfg.window_specs))]
    caps = np.array([cfg.max_kept_points, cfg.max_pillars]
                    + [cfg.max_sets_for(s) for s in cfg.window_specs])
    return names, caps


def _finish(cfg: DSVTConfig, path: str, boxes: np.ndarray, count: int,
            occ: np.ndarray, seconds: float, out_dir: Optional[str],
            host_nms: bool) -> dict:
    """One frame's outputs on the host: warn about the caps its occupancy
    reached (every cap truncates silently inside the forward pass, as the
    reference's, points2Features.cu:697/751), run the host NMS if asked,
    write the result txt; returns the frame's result."""
    names, caps = cap_table(cfg)
    saturated = [names[i] for i in range(len(caps)) if occ[i] >= caps[i]]
    if saturated:
        log.warning("%s: occupancy hit static cap(s) %s (occupancy %s vs caps "
                    "%s); points/pillars/sets were silently dropped; raise "
                    "the caps (see `cli stats`)", os.path.basename(path),
                    saturated, occ.tolist(), caps.tolist())
    if host_nms:
        boxes, count = nms_host(boxes, count, cfg.nms_threshold)
    name = _name(path)
    if out_dir:
        save_txt(boxes, count, seconds, os.path.join(out_dir, name + ".txt"))
    log.info("%s: %d boxes, %.1f ms", name, count, seconds * 1e3)
    return {"frame": name, "boxes": boxes[:count], "count": count,
            "seconds": seconds, "saturated": saturated}


def _stage(paths: List[str], cfg: DSVTConfig, results: list):
    """Load every frame into pageable host memory.  ``results`` gets one
    slot per path, in order; a frame that cannot be read is skipped and
    reported in its slot (the reference exits).  Returns (slot, path,
    points, n) of the good frames."""
    staged = []
    for i, path in enumerate(paths):
        results.append(None)
        try:
            pts, n = load_bin(path, cfg.max_points)
        except (IOError, ValueError) as exc:
            log.error("skipping bad frame %s: %s", path, exc)
            results[i] = {"frame": _name(path), "error": str(exc)}
            continue
        staged.append((i, path, torch.from_numpy(pts), n))
    return staged


def _name(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


class _PinnedRing:
    """``slots`` page-locked frame buffers used in turn for the copies to
    the card.  ``fill`` refills a buffer only once the event that ``used``
    recorded after its last frame's work has completed, so a non-blocking
    copy never reads a buffer being overwritten."""

    def __init__(self, slots: int, shape):
        self.bufs = [torch.empty(shape, dtype=torch.float32, pin_memory=True)
                     for _ in range(slots)]
        self.events: List[Optional[torch.cuda.Event]] = [None] * slots
        self.next = 0

    def fill(self, pts: torch.Tensor) -> torch.Tensor:
        """The next buffer, holding ``pts``."""
        i = self.next
        if self.events[i] is not None:
            self.events[i].synchronize()
        self.bufs[i].copy_(pts)
        return self.bufs[i]

    def used(self) -> None:
        """Mark the buffer ``fill`` returned as read by the work enqueued
        so far, and move to the next."""
        i, self.next = self.next, (self.next + 1) % len(self.bufs)
        self.events[i] = torch.cuda.Event()
        self.events[i].record()


class _InFlight:
    """One dispatched frame: its outputs copied (or being copied) to host
    buffers, and on the card the event recorded after those copies."""

    def __init__(self, dets, device: torch.device):
        pin = device.type == "cuda"
        self.host = []
        for t in (dets.boxes, dets.count, dets.occupancy):
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            buf.copy_(t, non_blocking=pin)
            self.host.append(buf)
        self.event = None
        if pin:
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        """(boxes, count, occupancy) as NumPy, once the copies are done."""
        if self.event is not None:
            self.event.synchronize()
        boxes, count, occ = (t.numpy() for t in self.host)
        return boxes, int(count), occ


def run_frames(engine: Engine, paths: List[str], out_dir: Optional[str] = None,
               host_nms: bool = False, pipeline_depth: int = 2) -> List[dict]:
    """Run inference over .bin frames; returns per-frame dicts with
    boxes/count/seconds/saturated (or error).  Per-frame ``seconds`` is
    completion to completion, the streaming number; ``pipeline_depth`` 0
    reads each frame back before dispatching the next.  With ``host_nms``
    the NumPy NMS runs on each frame's boxes (use an engine built
    ``with_nms=False``)."""
    cfg = engine.cfg
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results: List[dict] = []
    staged = _stage(paths, cfg, results)
    ring = (_PinnedRing(max(pipeline_depth, 0) + 1, (cfg.max_points, 4))
            if staged and engine.device.type == "cuda" else None)
    t_prev = time.perf_counter()

    def dispatch(slot, path, pts, n):
        if ring is None:
            return slot, path, _InFlight(engine(pts, n), engine.device)
        dets = engine(ring.fill(pts), n)
        ring.used()
        return slot, path, _InFlight(dets, engine.device)

    def finish(slot, path, inflight):
        nonlocal t_prev
        boxes, count, occ = inflight.wait()
        now = time.perf_counter()
        seconds, t_prev = now - t_prev, now
        results[slot] = _finish(cfg, path, boxes, count, occ, seconds,
                                out_dir, host_nms)

    queue: List[tuple] = []
    for item in staged:
        queue.append(dispatch(*item))
        if len(queue) > max(pipeline_depth, 0):
            finish(*queue.pop(0))
    for item in queue:
        finish(*item)
    return results


def run_frames_scan(params, cfg: DSVTConfig, paths: List[str],
                    out_dir: Optional[str] = None, batch: int = 10,
                    host_nms: bool = False, device="cuda") -> List[dict]:
    """Throughput mode: frames in groups of ``batch`` through
    ``forward_scan``, one readback per group.  The tail group is padded by
    repeating its last frame and the padded outputs are discarded.  Result
    txts equal ``run_frames``'; per-frame ``seconds`` is the group's wall
    time over its size.  ``params`` as for ``Engine``."""
    engine = Engine(params, cfg, device=device, with_nms=not host_nms)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    results: List[dict] = []
    staged = _stage(paths, cfg, results)
    if not staged:
        return results
    _, _, pts0, n0 = staged[0]
    engine.eager(pts0, n0).count.cpu()   # off the clock: builds the kernels
    for lo in range(0, len(staged), batch):
        group = staged[lo:lo + batch]
        padded = group + [group[-1]] * (batch - len(group))
        t0 = time.perf_counter()
        points = torch.stack([p for _, _, p, _ in padded]).to(engine.device)
        dets = forward_scan(engine.params, points,
                            [n for _, _, _, n in padded], cfg,
                            engine.with_nms, device=engine.device)
        boxes_b, count_b, occ_b = (t.cpu().numpy() for t in
                                   (dets.boxes, dets.count, dets.occupancy))
        seconds = (time.perf_counter() - t0) / batch
        for i, (slot, path, _, _) in enumerate(group):
            results[slot] = _finish(cfg, path, boxes_b[i], int(count_b[i]),
                                    occ_b[i], seconds, out_dir, host_nms)
    return results


def benchmark(engine: Engine, paths: List[str], iters: int = 3,
              pipeline_depth: int = 2) -> dict:
    """Steady-state ms per frame of the frame set after a warm pass, in the
    deployment's loop: ``pipeline_depth`` frames in flight, outputs copied
    back without blocking and waited for by event (as ``run_frames``)."""
    cfg = engine.cfg
    staged = [load_bin(p, cfg.max_points) for p in paths]
    staged = [(torch.from_numpy(p).to(engine.device), n) for p, n in staged]
    engine.warmup()
    for pts, n in staged:
        engine(pts, n).count.cpu()
    return {"ms_per_frame": pipelined_ms(engine, staged, iters, pipeline_depth),
            "frames": len(staged), "iters": iters}


def pipelined_ms(engine: Engine, frames, iters: int,
                 pipeline_depth: int) -> float:
    """Host ms per frame of ``iters`` passes over ``frames`` ((points, n)
    pairs, points already on the engine's device) with ``pipeline_depth``
    frames in flight, every frame's outputs copied back (``run_frames``'
    loop without the files)."""
    t0 = time.perf_counter()
    for _ in range(iters):
        queue: List[_InFlight] = []
        for pts, n in frames:
            queue.append(_InFlight(engine(pts, n), engine.device))
            if len(queue) > pipeline_depth:
                queue.pop(0).wait()
        for inflight in queue:
            inflight.wait()
    return (time.perf_counter() - t0) / (iters * len(frames)) * 1e3
