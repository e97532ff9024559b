"""Engine build / load: the reference's -s / -d split, for the card.

The reference serializes a TensorRT engine and deserializes it to infer
(dsvt-ai-trt.cpp:1764-1822); the JAX package serializes its jitted forward
with ``jax.export``, stamped with its config.  Here the forward pass is
eager PyTorch, and what a build makes is the hand-written kernels: the
artifact is the stamp and the four kernel libraries ``nvcc`` built from
``csrc/``, laid out as

    b"DSVTCUDA" | stamp length (4 bytes, little-endian) | stamp JSON |
    the libraries, one after another, in the stamp's order and sizes

with the stamp ``{"config": <DSVTConfig.to_json()>, "with_nms": ...,
"kernels": {"digest": <kernels.digest()>, "arch": "sm_90a"}, "libraries":
{name: size in bytes, ...}}``.  Like the JAX artifact it carries no
weights: the engine takes them when it is made.  ``load_engine`` on a card
with no ``nvcc`` installs the libraries under their digest, so the kernels
run without a build.  A build on the CPU (``device="cpu"``) writes the
stamp alone.

Not here, on purpose: ``torch.export`` and a captured CUDA graph.
``forward`` has data-dependent shapes and host syncs (``ops/bev.py``'s
boolean index, ``ops/nms.py``'s round test), ``torch.export`` cannot see
inside the ``ctypes`` kernels, and a graph is a performance change.  Nor
does the JAX package's ``enable_persistent_cache`` have a counterpart:
``kernels.py`` already keeps each build under its digest.
"""

from __future__ import annotations

import json
import logging
import os
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
    """

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

    def __call__(self, points, num_points) -> Detections:
        return forward(self.params, points, num_points, self.cfg,
                       self.with_nms, device=self.device)

    def warmup(self) -> "Engine":
        """One empty frame, waited for: builds or loads the kernels and
        warms the libraries off the clock."""
        dets = self(np.zeros((self.cfg.max_points, 4), np.float32), 0)
        dets.count.cpu()
        return self
