"""End-to-end DSVT detector: points -> boxes (port of model/detector.py).

voxelize -> VFE (2x segmented max, kernel B3) -> window/set partition per
window spec -> DSVT backbone (4 blocks x 2 encoders; kernels B1 + B2 on the
bf16/mixed fast paths) -> BEV scatter -> BEV ResNet -> lazy CenterHead ->
top-k decode + score filter -> rotated NMS (kernel B4).

``forward`` runs on ``device`` (default "cuda", which raises without a
card; tests pass "cpu").  The parameters must already live there
(``weights.from_jax_params(params, device)``).  Each stage runs under
``runtime.profiler.stage_scope`` (a ``torch.profiler.record_function``
label, STAGES), so a profiler trace splits a frame's time by stage and
``runtime.profiler.count_flops`` counts FLOPs by stage; outside a profiler
the labels cost a few microseconds per frame.

``forward_scan`` is the throughput form of the JAX package's ``lax.scan``
batching: the frames of a batch one after another, outputs stacked.
``forward_batch`` (the vmap form, for data parallelism over several
devices) waits for the multi-device slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..config import DSVTConfig
from ..ops import nms as nms_ops
from ..ops.bev import map_to_bev
from ..ops.common import resolve_device
from ..ops.postprocess import Detections, decode_and_filter
from ..ops.voxelize import Pillars, voxelize
from ..ops.windows import partition
from ..runtime.profiler import stage_scope
from .backbone2d import backbone2d_forward
from .backbone3d import backbone3d_forward
from .head import head_forward
from .vfe import vfe_forward


def _inputs(params: Dict, points, num_points, device):
    device = resolve_device(device)
    pdev = params["vfe"]["l0"]["w"].device
    if pdev.type != device.type:
        raise ValueError(f"parameters are on {pdev}, forward runs on {device}:"
                         " carry them with weights.from_jax_params(p, device)")
    points = torch.as_tensor(points, dtype=torch.float32).to(pdev)
    num = torch.as_tensor(num_points).to(pdev)
    return points, num


def _partitions(pillars: Pillars, cfg: DSVTConfig):
    """(window partitions, set partitions), one of each per window spec."""
    parts = [partition(pillars.coords, pillars.pillar_valid, spec, cfg)
             for spec in cfg.window_specs]
    return [w for w, _ in parts], [s for _, s in parts]


STAGES = ("voxelize", "vfe", "partition", "backbone3d", "bev_scatter",
          "backbone2d", "head", "decode", "nms")


@torch.inference_mode()
def forward(params: Dict, points, num_points, cfg: DSVTConfig,
            with_nms: bool = False, device="cuda") -> Detections:
    """points: [max_points, 4] (array or tensor); num_points: int or [].
    The hand-written kernels run where ``cfg.use_pallas`` is set."""
    points, num = _inputs(params, points, num_points, device)
    precision = cfg.precision
    use_kernels = cfg.use_pallas
    with stage_scope("voxelize"):
        pillars = voxelize(points, num, cfg)
    with stage_scope("vfe"):
        feats = vfe_forward(pillars, params["vfe"], cfg,
                            use_kernels=use_kernels)
    with stage_scope("partition"):
        wparts, sparts = _partitions(pillars, cfg)
    with stage_scope("backbone3d"):
        feats = backbone3d_forward(feats, wparts, sparts, params, cfg,
                                   use_kernels=use_kernels)
    with stage_scope("bev_scatter"):
        if precision == "bf16":
            feats = feats.to(torch.bfloat16)
        bev = map_to_bev(feats, pillars.coords, pillars.pillar_valid,
                         (cfg.grid_size[1], cfg.grid_size[0]))
    with stage_scope("backbone2d"):
        bev = backbone2d_forward(bev, params["backbone2d"], precision)
    with stage_scope("head"):
        head_out = head_forward(bev, params["head"], precision, lazy=True)
    with stage_scope("decode"):
        dets = decode_and_filter(head_out, cfg, head_params=params["head"])
    if with_nms:
        with stage_scope("nms"):
            boxes, count = nms_ops.nms(dets.boxes, dets.count,
                                       cfg.nms_threshold,
                                       use_kernels=use_kernels)
        dets = Detections(boxes=boxes, count=count)
    occupancy = torch.stack([pillars.point_count, pillars.pillar_count]
                            + [sp.set_count for sp in sparts])
    return dets._replace(occupancy=occupancy)


def forward_scan(params: Dict, points, num_points, cfg: DSVTConfig,
                 with_nms: bool = False, device="cuda") -> Detections:
    """points [B, max_points, 4], num_points [B]: each frame through
    ``forward`` in turn; returns stacked Detections (boxes [B, top_k, 9],
    count [B], occupancy [B, 2 + n_window_specs])."""
    dets = [forward(params, points[b], num_points[b], cfg, with_nms, device)
            for b in range(len(points))]
    return Detections(boxes=torch.stack([d.boxes for d in dets]),
                      count=torch.stack([d.count for d in dets]),
                      occupancy=torch.stack([d.occupancy for d in dets]))


class IntermediateOutputs(NamedTuple):
    pillars: Pillars
    pillar_feats: torch.Tensor
    dsvt_feats: torch.Tensor
    bev_features: torch.Tensor
    head_out: Dict[str, torch.Tensor]


@torch.inference_mode()
def forward_debug(params, points, num_points, cfg: DSVTConfig,
                  device="cuda") -> IntermediateOutputs:
    """Per-stage outputs for parity checks: the plain reference paths (no
    kernels), full-map head, as the JAX forward_debug."""
    points, num = _inputs(params, points, num_points, device)
    precision = cfg.precision
    pillars = voxelize(points, num, cfg)
    pfeats = vfe_forward(pillars, params["vfe"], cfg, use_kernels=False)
    wparts, sparts = _partitions(pillars, cfg)
    dfeats = backbone3d_forward(pfeats, wparts, sparts, params, cfg,
                                use_kernels=False)
    bev = map_to_bev(dfeats, pillars.coords, pillars.pillar_valid,
                     (cfg.grid_size[1], cfg.grid_size[0]))
    bev2 = backbone2d_forward(bev, params["backbone2d"], precision)
    head_out = head_forward(bev2, params["head"], precision)
    return IntermediateOutputs(pillars, pfeats, dfeats, bev2, head_out)
