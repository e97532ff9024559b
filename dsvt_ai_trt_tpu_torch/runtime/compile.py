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
graph, one launch a frame.  ``forward`` has static shapes and reads nothing
back to the host (NMS's rounds run inside kernel nms_peel), which is what
capture requires.  The graph is made when the engine warms up, never
stored: a ``jax.export`` blob is compiled on its device when loaded too.
Not here, on purpose: ``torch.export``, which cannot see inside the
``ctypes`` kernels.  Nor does the JAX package's
``enable_persistent_cache`` have a counterpart: ``kernels.py`` already
keeps each build under its digest.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..config import DSVTConfig
from ..model.detector import forward
from ..ops.common import resolve_device
from ..ops.postprocess import Detections
from ..weights import from_jax_params

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
    """

    WARM_RUNS = 2   # eager frames on a side stream before the capture

    def __init__(self, params, cfg: DSVTConfig, device="cuda",
                 with_nms: bool = True, engine_path: Optional[str] = None):
        self.cfg = cfg
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
        self._graph = None
        self.graph_launches = {}   # kernel launches one replay makes
        self.capture_seconds = None
        self.graph_pool_bytes = None

    def eager(self, points, num_points) -> Detections:
        """The forward op by op, on this engine's weights and device."""
        return forward(self.params, points, num_points, self.cfg,
                       self.with_nms, device=self.device)

    def __call__(self, points, num_points) -> Detections:
        if self.device.type != "cuda":
            return self.eager(points, num_points)
        if self._graph is None:
            self.warmup()
        self._load(points, num_points)
        self._graph.replay()
        kernels.replayed(self.graph_launches)
        out = self._out
        return Detections(boxes=out.boxes.clone(), count=out.count.clone(),
                          occupancy=out.occupancy.clone())

    def _load(self, points, num_points) -> None:
        """Copy a frame into the static input buffers, in stream order."""
        if not isinstance(points, torch.Tensor):
            points = torch.from_numpy(np.asarray(points, dtype=np.float32))
        if tuple(points.shape) != tuple(self._points.shape):
            raise ValueError(f"the engine's graph takes points "
                             f"{tuple(self._points.shape)} (max_points, 4), "
                             f"got {tuple(points.shape)}")
        self._points.copy_(points, non_blocking=True)
        if isinstance(num_points, torch.Tensor):
            self._num.copy_(num_points.reshape(()), non_blocking=True)
        else:
            self._num.fill_(int(num_points))

    def warmup(self) -> "Engine":
        """Make the engine ready and wait for it, off the clock.  On the
        CPU: one empty frame.  On the card, once: build and load every
        kernel library, run ``WARM_RUNS`` eager frames on a side stream
        (lazy initialisations and the allocator settle there; the kernels'
        first-launch attribute calls run), capture ``forward`` over the
        static buffers into one CUDA graph, and replay it on an empty
        frame.  Recorded: ``capture_seconds`` (all of that, after the
        build) and ``graph_pool_bytes``, the device memory the capture
        reserved: the graph's private pool, which holds every intermediate
        of a frame."""
        if self.device.type != "cuda":
            self(np.zeros((self.cfg.max_points, 4), np.float32), 0)
            return self
        if self._graph is not None:
            return self
        kernels.build_all()
        for name in kernels.SPECS:
            kernels.lib(name)
        t0 = time.perf_counter()
        self._points = torch.zeros((self.cfg.max_points, 4),
                                   dtype=torch.float32, device=self.device)
        self._num = torch.zeros((), dtype=torch.int32, device=self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(self.WARM_RUNS):
                self.eager(self._points, self._num)
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        before = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with kernels.captured() as launches, torch.cuda.graph(graph):
            out = self.eager(self._points, self._num)
        self.graph_pool_bytes = torch.cuda.memory_reserved(self.device) \
            - before
        self._graph, self._out = graph, out
        self.graph_launches = dict(launches)
        self(self._points, 0).count.cpu()   # an empty frame, waited for
        self.capture_seconds = time.perf_counter() - t0
        log.info("captured the forward in %.2f s: %d MB in the graph's pool, "
                 "launches a replay %s", self.capture_seconds,
                 self.graph_pool_bytes >> 20, self.graph_launches)
        return self
