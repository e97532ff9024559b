"""Engine build / load: the reference's -s / -d split, for the card.

The reference serializes a TensorRT engine and deserializes it to infer
(dsvt-ai-trt.cpp:1764-1822); the JAX package serializes its jitted forward
with ``jax.export``, stamped with its config.  Here what a build makes is
the hand-written kernels: the artifact is the stamp and the kernel
libraries ``nvcc`` built from ``csrc/``, laid out as

    b"DSVTCUDA" | stamp length (4 bytes, little-endian) | stamp JSON |
    the libraries, one after another, in the stamp's order and sizes

with the stamp ``{"config": <DSVTConfig.to_json()>, "with_nms": ...,
"kernels": {"digest": <kernels.digest()>, "arch": "sm_90a"}, "libraries":
{name: size in bytes, ...}}``.  Like the JAX artifact it carries no
weights: the engine takes them when it is made.  ``load_engine`` on a card
with no ``nvcc`` installs the libraries under their digest, so the kernels
run without a build.  A build on the CPU (``device="cpu"``) writes the
stamp alone.

The compiled program is a CUDA graph, the counterpart of the JAX
``Engine``'s jitted forward (XLA itself lowers jitted programs on GPUs to
CUDA graphs): ``Engine.warmup`` on the card captures one whole
``model.detector.forward`` over static input buffers, weights included, and
every call after it copies its frame into those buffers and replays the
graph, one launch a frame.  ``Engine(..., batch=B)`` captures
``forward_batch`` over B static frames instead, one launch a group: the
JAX package's jitted ``forward_scan`` (``run_frames_scan``).
``capture_graph`` is the capture itself, which the compiled training step
(``parallel.training.CompiledTrainStep``) shares.  ``forward`` has static
shapes and reads nothing back to the host (NMS's rounds run inside kernel
nms_peel), which is what capture requires; ``SyncGuard`` finds on the CPU
what no capture can hold.  The graph is made when the engine warms up,
never stored: a ``jax.export`` blob is compiled on its device when loaded
too.

A program with collectives in it (the tensor- and spatially-sharded
forwards, ``Engine(..., tp=)`` / ``Engine(..., spatial=)``, and the
training step under a mesh, whose tensor-parallel backward reaches its
collectives on autograd's thread) is captured in segments
(``capture_segments``): the graph closes at each collective, the
collective runs between two graph launches at replay, through its group's
own transport (gloo: a copy to the host, the exchange, a copy back), into
static buffers, and the next graph reads them.

Not here, on purpose: ``torch.export``, which cannot see inside the
``ctypes`` kernels.  Nor does the JAX package's
``enable_persistent_cache`` have a counterpart: ``kernels.py`` already
keeps each build under its digest.
"""

from __future__ import annotations

import contextlib
import gc
import json
import logging
import os
import time
import traceback
from typing import Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .. import kernels
from ..config import DSVTConfig, query_head
from ..model.detector import forward, forward_batch
from ..model.transfusion import fold_query
from ..ops import (attention_kernel, encoder_kernel, nms_kernel, nms_peel,
                   pool_kernel, query_attention_kernel, segment)
from ..ops.common import matmul_dtype, resolve_device
from ..ops.postprocess import Detections
from ..parallel import collectives
from ..parallel.spatial import spatial_sharding
from ..weights import fold_convs, from_jax_params
from . import profiler

log = logging.getLogger("dsvt_torch.compile")

ENGINE_MAGIC = b"DSVTCUDA"
JAX_ENGINE_MAGIC = b"DSVTTPU1"   # the JAX package's jax.export artifact


def _stamp(cfg: DSVTConfig, with_nms: bool, libraries: dict) -> bytes:
    meta = json.dumps({
        "config": json.loads(cfg.to_json()), "with_nms": with_nms,
        "kernels": {"digest": kernels.digest(), "arch": kernels.ARCH},
        "libraries": {name: len(data) for name, data in libraries.items()},
    }).encode()
    return ENGINE_MAGIC + len(meta).to_bytes(4, "little") + meta


def build_engine(cfg: DSVTConfig, path: Optional[str] = None,
                 with_nms: bool = True, device="cuda") -> bytes:
    """Build the kernels (on the card's machine) and write the artifact to
    ``path``; returns its bytes.  On the CPU the artifact is the stamp."""
    device = resolve_device(device)
    libraries = {}
    if device.type == "cuda":
        kernels.build_all()
        for name in kernels.SPECS:
            with open(kernels.library_path(name), "rb") as f:
                libraries[name] = f.read()
    blob = _stamp(cfg, with_nms, libraries) + b"".join(libraries.values())
    log.info("engine build: %d bytes, %d kernel libraries", len(blob),
             len(libraries))
    if path:
        with open(path, "wb") as f:
            f.write(blob)
    return blob


def _split(blob: bytes):
    if blob.startswith(JAX_ENGINE_MAGIC):
        raise ValueError(
            "this is an engine of the JAX package (a jax.export program for "
            "a TPU), not of the PyTorch/CUDA port: build one with `python -m "
            "dsvt_ai_trt_tpu_torch.cli build`")
    if not blob.startswith(ENGINE_MAGIC):
        raise ValueError(f"not a DSVT engine artifact (magic "
                         f"{blob[:8]!r}, expected {ENGINE_MAGIC!r})")
    n = int.from_bytes(blob[8:12], "little")
    return json.loads(blob[12:12 + n].decode()), blob[12 + n:]


def load_engine(path_or_blob, expect_cfg: Optional[DSVTConfig] = None,
                expect_nms: Optional[bool] = None, device="cuda") -> dict:
    """Check an artifact and install its kernel libraries; returns its
    stamp.  Raises ValueError when the stamped config or ``with_nms``
    differs from the caller's, when the kernels were built from other
    sources than this tree's, or for a JAX artifact.  On the card the
    libraries are then loaded, and one that fails to load raises."""
    blob = path_or_blob
    if isinstance(path_or_blob, str):
        with open(path_or_blob, "rb") as f:
            blob = f.read()
    meta, body = _split(blob)
    if expect_cfg is not None:
        built = DSVTConfig.from_json(json.dumps(meta["config"]))
        if built != expect_cfg:
            diffs = [f for f in built.__dataclass_fields__
                     if getattr(built, f) != getattr(expect_cfg, f)]
            raise ValueError(
                f"engine was built with a different config (fields {diffs}); "
                "rebuild it or pass the matching DSVTConfig")
    if expect_nms is not None and meta["with_nms"] != expect_nms:
        raise ValueError(f"engine was built with with_nms={meta['with_nms']}, "
                         f"caller expects {expect_nms}")
    stamped = meta["kernels"]
    if (stamped["digest"], stamped["arch"]) != (kernels.digest(), kernels.ARCH):
        raise ValueError(
            f"engine's kernels were built from other sources or for another "
            f"architecture ({stamped['digest']} for {stamped['arch']}; this "
            f"tree is {kernels.digest()} for {kernels.ARCH}): rebuild the "
            "engine")
    sizes = meta["libraries"]
    if sum(sizes.values()) != len(body):
        raise ValueError(f"engine artifact is truncated: {len(body)} bytes of "
                         f"libraries, the stamp lists {sum(sizes.values())}")
    offset = 0
    for name, size in sizes.items():
        kernels.install(name, body[offset:offset + size])
        offset += size
    if resolve_device(device).type == "cuda":
        for name in sizes:
            kernels.lib(name)
    return meta


def capture_graph(fn, warm, device, warm_runs: int):
    """Run ``warm()`` ``warm_runs`` times on a side stream (lazy
    initialisations, library handles and the allocator settle there), then
    capture ``fn()`` into one ``torch.cuda.CUDAGraph``, which records the
    work and runs none of it.  Returns (the graph, what ``fn`` returned: its
    tensors live in the graph's pool and each replay rewrites them, the
    kernel launches the capture recorded (``kernels.captured``), the device
    memory the capture reserved: the graph's private pool)."""
    with profiler.span("warm_runs"):
        before = _warm(warm, device, warm_runs)
    graph = torch.cuda.CUDAGraph()
    with profiler.span("capture"), kernels.captured() as launches, \
            torch.cuda.graph(graph):
        out = fn()
    return (graph, out, dict(launches),
            torch.cuda.memory_reserved(device) - before)


def _warm(warm, device, warm_runs: int) -> int:
    """``capture_graph``'s warm runs on a side stream, then a garbage
    collection and an empty cache; returns the device memory reserved after
    them.  The collection frees unreachable graphs now: one freed while a
    capture is open invalidates it (``torch.cuda.graph`` collects too)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warm_runs):
            warm()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved(device)


class SegmentedGraph:
    """A program captured in segments (``capture_segments``): ``graphs``,
    the CUDA graphs in capture order, all in one private pool, and
    ``steps``, the host step that runs after each graph but the last (one
    collective, through ``collectives.transport``, from the tensor the
    capture saw into static buffers the next graph reads).  ``replay()``
    runs them in that order on the current stream.  A graph may reuse a
    block of the pool that an earlier graph freed during the capture; that
    is safe only because every replay runs the graphs in capture order,
    one after another on one stream.  Each step's copy to the host waits
    for the graphs before it, so a replay of k segments waits k - 1 times:
    gloo's cost."""

    def __init__(self):
        self.graphs = []
        self.steps = []
        self.static_bytes = 0     # the steps' output buffers

    @property
    def segments(self) -> int:
        return len(self.graphs)

    def replay(self) -> None:
        for graph, step in zip(self.graphs, self.steps + [None]):
            graph.replay()
            if step is not None:
                step()


class _Segmenter:
    """The hook of a segmented capture (``collectives.intercepted``).
    Every graph is captured on ``stream``; ``mode`` is CUDA's capture mode
    ("global", or "relaxed" where a graph may end on another thread than
    the one that began it)."""

    def __init__(self, program: SegmentedGraph, stream, mode: str):
        self.program = program
        self.stream, self.mode = stream, mode
        self.pool = torch.cuda.graph_pool_handle()
        self.open = False

    def _on_stream(self, what: str) -> None:
        # autograd runs a node on its forward's stream: the capture stream
        if torch.cuda.current_stream(self.stream.device) != self.stream:
            raise RuntimeError(f"capture_segments: {what} a graph off the "
                               "capture stream")

    def begin(self) -> None:
        self._on_stream("beginning")
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode=self.mode)
        self.program.graphs.append(graph)
        self.open = True

    def end(self) -> None:
        self._on_stream("ending")
        self.open = False
        self.program.graphs[-1].capture_end()

    def __call__(self, kind, x, group):
        self.end()
        # outside any capture: the buffers live in the ordinary pool, and
        # the step holds x, so no later segment reuses its block.  Normal
        # tensors, not inference ones: a replay may run outside
        # inference mode and writes them in place
        with torch.inference_mode(False):
            out = collectives.outputs(kind, x, group)
        self.program.static_bytes += sum(t.numel() * t.element_size()
                                         for t in out)
        self.program.steps.append(
            lambda: collectives.transport(kind, x, group, out))
        self.begin()
        return out[0] if kind == "all_reduce" else out


def capture_segments(fn, warm, device, warm_runs: int,
                     across_threads: bool = False):
    """``capture_graph`` for a program with collectives in it: the same
    warm runs (they communicate, so every rank must run as many), then
    ``fn()`` captured into a ``SegmentedGraph`` whose graph closes at each
    collective this thread reaches (``collectives.intercepted``), or
    autograd's thread reaches carrying this thread's hook (``collectives.
    carried``: a tensor-parallel backward and its recomputation), and
    opens again after it, on one capture stream; any other thread's
    collective raises.  The capture runs no collective.

    ``across_threads``: the program's collectives include ones autograd's
    thread reaches, so a graph that this thread began may end on that
    thread and the reverse.  CUDA allows that only in its relaxed capture
    mode, which also stops refusing calls that are unsafe in a capture (a
    synchronisation, a copy to the host): ``SyncGuard`` on the CPU is then
    the check that none is made.  Without it, the capture mode is
    "global".

    Returns (the program, what ``fn`` returned, the kernel launches
    recorded over every segment, the device memory the capture reserved:
    the pool and the steps' static buffers).  A failed capture raises, its
    open graph ended."""
    with profiler.span("warm_runs"):
        before = _warm(warm, device, warm_runs)
    program = SegmentedGraph()
    stream = torch.cuda.Stream(device)
    seg = _Segmenter(program, stream,
                     "relaxed" if across_threads else "global")
    with profiler.span("capture"), kernels.captured() as launches, \
            torch.cuda.stream(stream), collectives.intercepted(seg):
        seg.begin()
        try:
            out = fn()
        finally:
            if seg.open:
                seg.end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return (program, out, dict(launches),
            torch.cuda.memory_reserved(device) - before)


PLAIN_VERSIONS = ((segment, "segmented_max_plain"),
                  (attention_kernel, "set_attention_plain"),
                  (encoder_kernel, "encoder_epilogue_plain"),
                  (nms_kernel, "pairwise_overlap_clip"),
                  (nms_peel, "nms_peel_plain"),
                  (pool_kernel, "stage_pool_plain"),
                  (query_attention_kernel, "query_attention_plain"))
aten = torch.ops.aten
# inside inference mode a read reaches the dispatcher as ``item`` or
# ``is_nonzero``, not decomposed to ``_local_scalar_dense``
HOST_READS = {aten._local_scalar_dense.default: "reads a value on the host",
              aten.item.default: "reads a value on the host",
              aten.is_nonzero.default: "reads a value on the host",
              aten.nonzero.default: "has a data-dependent shape",
              aten.masked_select.default: "has a data-dependent shape",
              aten.lift_fresh.default: "makes a tensor from host data",
              aten.lift_fresh_copy.default: "makes a tensor from host data"}
INDEXING = (aten.index.Tensor, aten.index_put_.default, aten.index_put.default,
            aten._index_put_impl_.default)


class SyncGuard(TorchDispatchMode):
    """Records each op that a CUDA graph cannot capture, with the port's
    frames of the Python stack, outside ``exempt``: a read back to the
    host or a data-dependent shape (``aten._local_scalar_dense``,
    ``aten.nonzero``, ``aten.masked_select``, a boolean index in
    ``aten.index`` / ``aten.index_put_``) and a tensor made from Python or
    NumPy data (``aten.lift_fresh``: on the card, a copy from the host).
    It runs on the CPU, so a test finds them before a capture would."""

    def __init__(self):
        super().__init__()
        self.hits = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        why = HOST_READS.get(func)
        if why is None and func in INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8)
                for t in args[1]):
            why = "indexes by a boolean mask"
        if why and not self.paused:
            where = [line.strip() for line in traceback.format_stack()[:-1]
                     if "dsvt_ai_trt_tpu_torch" in line]
            self.hits.append(f"{func} {why} at {where[-1:]}")
        return func(*args, **(kwargs or {}))

    @contextlib.contextmanager
    def exempt(self):
        self.paused += 1
        try:
            yield
        finally:
            self.paused -= 1

    @contextlib.contextmanager
    def plain_versions_exempt(self):
        """Exempt the kernels' plain versions (``PLAIN_VERSIONS``): the
        card runs the kernels there, and the plain versions run only on
        the CPU."""
        saved = [(module, name, getattr(module, name))
                 for module, name in PLAIN_VERSIONS]

        def exempted(plain):
            def run(*args, **kw):
                with self.exempt():
                    return plain(*args, **kw)
            return run
        try:
            for module, name, plain in saved:
                setattr(module, name, exempted(plain))
            yield self
        finally:
            for module, name, plain in saved:
                setattr(module, name, plain)


class Engine:
    """Callable wrapper: ``dets = engine(points, num_points)``.

    params: the nested NumPy dict of ``weights.random_params`` /
    ``prepare_params`` (either package's), or one already carried to torch
    by ``from_jax_params``, kept resident on ``device``.  With an existing
    ``engine_path`` the artifact is checked against ``cfg`` and
    ``with_nms`` and its kernels installed (``load_engine``); without one
    the kernels build from the sources on first use.  Raises when
    ``device`` is "cuda" and no card is present.

    On the card a call replays one CUDA graph of the whole forward (module
    docstring), captured by ``warmup``, which the first call runs if the
    caller did not.  The call copies ``points`` ([max_points, 4]: NumPy,
    pinned or on the card) and ``num_points`` (int or tensor) into the
    graph's static input buffers in stream order, replays the graph, and
    returns Detections whose tensors are copies of the graph's outputs, so
    the next replay leaves an earlier call's result as it was.  No host
    read: the copies out are enqueued after the replay.  A failed capture
    or replay raises; nothing falls back to the eager forward on the card.
    Launch counts (``kernels.counts``) rise per replay by what the capture
    recorded.  ``eager`` runs the same forward op by op, and is what runs
    on the CPU, where the caller asked for it.

    With ``batch`` B the engine runs ``forward_batch`` on groups of B
    frames: ``points`` [B, max_points, 4], ``num_points`` B ints or a [B]
    tensor, stacked Detections out; its graph holds B frames' launches.

    With a process group, ``tp`` (params of ``parallel.mesh.rank_params``)
    runs the encoders tensor parallel over it and ``spatial`` shards each
    frame over it (``forward`` inside ``spatial_sharding(spatial)``; pass
    ``torch.distributed.group.WORLD`` for the default group): the
    counterparts of the JAX package's jitted forward over a mesh.  Every
    rank of the group makes the engine and calls it in step.  The graph is
    then captured in segments (``capture_segments``): ``segments`` graphs a
    replay, one collective between two of them.

    With the tracer on (``runtime.profiler.enable_spans``, before the
    warm-up) the graph also holds the stage marks, and each call, replayed
    or eager, leaves a record of its host spans and stage marks, numbered
    by ``calls`` (``runtime/profiler.py``).
    """

    WARM_RUNS = 2   # eager frames on a side stream before the capture

    def __init__(self, params, cfg: DSVTConfig, device="cuda",
                 with_nms: bool = True, engine_path: Optional[str] = None,
                 batch: Optional[int] = None, tp=None, spatial=None):
        if tp is not None and spatial is not None:
            raise ValueError("Engine: tensor and spatial sharding do not "
                             "combine")
        self.cfg = cfg
        self.batch = batch
        self.tp, self.spatial = tp, spatial
        self.device = resolve_device(device)
        self.with_nms = with_nms
        if engine_path and os.path.exists(engine_path):
            load_engine(engine_path, expect_cfg=cfg, expect_nms=with_nms,
                        device=self.device)
            log.info("loaded engine from %s", engine_path)
        leaf = params["vfe"]["l0"]["w"]
        if isinstance(leaf, torch.Tensor):
            if leaf.device.type != self.device.type:
                raise ValueError(f"parameters are on {leaf.device}, the "
                                 f"engine runs on {self.device}")
            self.params = params
        else:
            self.params = from_jax_params(params, self.device)
        if matmul_dtype(cfg.precision) == torch.bfloat16:
            fold_convs(self.params)       # the bf16 convs' weights, once
        if query_head(cfg):
            fold_query(self.params["head"], cfg)   # Pk and the k | v weights
        self._graph = None
        self.graph_launches = {}   # kernel launches one replay makes
        self.capture_seconds = None
        self.graph_pool_bytes = None
        self.segments = None       # graphs a replay launches
        self._marks = self._eager_marks = None   # the tracer's, when on
        self.calls = 0             # calls the tracer recorded

    def eager(self, points, num_points) -> Detections:
        """The forward op by op, on this engine's weights, device and
        group; with the tracer on, a record of kind "eager"."""
        if profiler.tracer() is None:
            return self._forward(points, num_points)
        return profiler.traced_eager(
            self, "frame", lambda: self._forward(points, num_points))

    def _forward(self, points, num_points) -> Detections:
        run = forward if self.batch is None else forward_batch
        sharded = (contextlib.nullcontext() if self.spatial is None
                   else spatial_sharding(self.spatial))
        with sharded:
            return run(self.params, points, num_points, self.cfg,
                       self.with_nms, device=self.device, tp=self.tp)

    def __call__(self, points, num_points) -> Detections:
        if self.device.type != "cuda":
            return self.eager(points, num_points)
        if self._graph is None:
            self.warmup()
        if profiler.tracer() is not None:
            return self._traced_call(points, num_points)
        self._load(points, num_points)
        self._graph.replay()
        kernels.replayed(self.graph_launches)
        return self._copy_out()

    def _copy_out(self) -> Detections:
        out = self._out
        return Detections(boxes=out.boxes.clone(), count=out.count.clone(),
                          occupancy=out.occupancy.clone())

    def _traced_call(self, points, num_points) -> Detections:
        """``__call__`` with its host spans, and the frame's marks copied
        toward the host after the replay, in stream order."""
        self.calls += 1
        with profiler.record("frame", "Engine", self.calls, "replay") as rec:
            with profiler.span("copy_in"):
                self._load(points, num_points)
            with profiler.span("graph_launch"):
                self._graph.replay()
            kernels.replayed(self.graph_launches)
            with profiler.span("copy_out"):
                dets = self._copy_out()
                profiler.take(rec, self._marks)
        return dets

    def _load(self, points, num_points) -> None:
        """Copy a frame into the static input buffers, in stream order."""
        if not isinstance(points, torch.Tensor):
            points = torch.from_numpy(np.asarray(points, dtype=np.float32))
        if tuple(points.shape) != tuple(self._points.shape):
            raise ValueError(f"the engine's graph takes points "
                             f"{tuple(self._points.shape)} ([batch,] "
                             f"max_points, 4), got {tuple(points.shape)}")
        self._points.copy_(points, non_blocking=True)
        if isinstance(num_points, torch.Tensor):
            self._num.copy_(num_points.reshape(self._num.shape),
                            non_blocking=True)
        elif np.ndim(num_points) == 0:
            self._num.fill_(int(num_points))
        else:
            self._num.copy_(torch.from_numpy(np.asarray(
                num_points, np.int32).reshape(self._num.shape)),
                non_blocking=True)

    def warmup(self) -> "Engine":
        """Make the engine ready and wait for it, off the clock.  On the
        CPU: one empty frame (group).  On the card, once: build and load
        every kernel library, run ``WARM_RUNS`` eager frames on a side
        stream (lazy initialisations and the allocator settle there; the
        kernels' first-launch attribute calls run), capture ``forward``
        (``forward_batch``) over the static buffers into one CUDA graph
        (``capture_graph``; with a group, in segments: ``capture_segments``),
        and replay it on an empty frame (group).  Recorded:
        ``capture_seconds`` (all of that, after the build),
        ``graph_pool_bytes``, the device memory the capture reserved: the
        graph's private pool, which holds every intermediate of a frame
        (group), and ``segments``.  The tracer's record of it (kind "host")
        has the spans ``kernels``, ``warm_runs``, ``capture`` and
        ``first_replay``."""
        frames = () if self.batch is None else (self.batch,)
        if self.device.type != "cuda":
            self(np.zeros(frames + (self.cfg.max_points, 4), np.float32),
                 np.zeros(frames, np.int32))
            return self
        if self._graph is not None:
            return self
        with profiler.record("warmup", "Engine", 0, "host"):
            with profiler.span("kernels"):
                kernels.build_all()
                for name in kernels.SPECS:
                    kernels.lib(name)
            self._capture()
        log.info("captured the forward in %.2f s (%d segments): %d MB in the "
                 "graph's pool, launches a replay %s", self.capture_seconds,
                 self.segments, self.graph_pool_bytes >> 20,
                 self.graph_launches)
        return self

    def _capture(self) -> None:
        frames = () if self.batch is None else (self.batch,)
        t0 = time.perf_counter()
        self._points = torch.zeros(frames + (self.cfg.max_points, 4),
                                   dtype=torch.float32, device=self.device)
        self._num = torch.zeros(frames, dtype=torch.int32, device=self.device)
        self._marks = profiler.new_marks(self.device)

        def run():
            with profiler.marking(self._marks):
                return self._forward(self._points, self._num)
        grouped = self.tp is not None or self.spatial is not None
        self._graph, self._out, self.graph_launches, self.graph_pool_bytes \
            = (capture_segments if grouped else capture_graph)(
                run, run, self.device, self.WARM_RUNS)
        self.segments = self._graph.segments if grouped else 1
        with profiler.span("first_replay"):
            self(self._points, 0).count.cpu()   # an empty frame, waited for
        self.capture_seconds = time.perf_counter() - t0
