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

``forward_batch`` is the per-frame stacked form that the JAX package's
vmap computes (the form data parallelism runs on each dp rank,
parallel/mesh.py:make_dp_engine) and ``forward_scan`` its throughput form
(``lax.scan`` there): in PyTorch both are the frames of a batch one after
another, outputs stacked, so they are one function.  ``tp`` (a process
group; params from ``parallel.mesh.rank_params``) runs the encoders tensor
parallel (model/backbone3d.py), and ``forward_spatial`` is ``forward``
inside ``parallel.spatial.spatial_sharding``: one frame sharded by pillar,
set and BEV rows over a group, every rank returning the same boxes.

``forward_train`` is ``forward_debug`` with autograd on, for the training
loss (parallel/training.py): the plain paths (kernels B1-B3 define no
backward, as in the JAX package), the full head, and the attention
projections packed from the live weights.  Its integer stages
(``partition_frame``: voxelize, window/set partitions) carry no gradient
and run apart from the float stages (``float_stages``), so a recomputing
backward (``torch.utils.checkpoint``) reruns only the float stages on the
same partitions.
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
from ..parallel.spatial import spatial_sharding
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
    if isinstance(num_points, torch.Tensor):
        return points, num_points.to(pdev)
    return points, int(num_points)     # a scalar operand: nothing to copy


def _partitions(pillars: Pillars, cfg: DSVTConfig):
    """(window partitions, set partitions), one of each per window spec."""
    parts = [partition(pillars.coords, pillars.pillar_valid, spec, cfg)
             for spec in cfg.window_specs]
    return [w for w, _ in parts], [s for _, s in parts]


STAGES = ("voxelize", "vfe", "partition", "backbone3d", "bev_scatter",
          "backbone2d", "head", "decode", "nms")


@torch.inference_mode()
def forward(params: Dict, points, num_points, cfg: DSVTConfig,
            with_nms: bool = False, device="cuda", tp=None) -> Detections:
    """points: [max_points, 4] (array or tensor); num_points: int or [].
    The hand-written kernels run where ``cfg.use_pallas`` is set.  ``tp``:
    the tensor-parallel group of the encoders (module docstring)."""
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
                                   use_kernels=use_kernels, tp=tp)
    with stage_scope("bev_scatter"):
        if precision == "bf16":
            feats = feats.to(torch.bfloat16)
        bev = map_to_bev(feats, pillars.coords, pillars.pillar_valid,
                         (cfg.grid_size[1], cfg.grid_size[0]))
    with stage_scope("backbone2d"):
        bev = backbone2d_forward(bev, params["backbone2d"], precision)
    with stage_scope("head"):
        head_out = head_forward(bev, params["head"], precision, cfg,
                                lazy=True)
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


def forward_batch(params: Dict, points, num_points, cfg: DSVTConfig,
                  with_nms: bool = False, device="cuda",
                  tp=None) -> Detections:
    """points [B, max_points, 4], num_points [B]: each frame through
    ``forward`` in turn; returns stacked Detections (boxes [B, top_k, 9],
    count [B], occupancy [B, 2 + n_window_specs])."""
    dets = [forward(params, points[b], num_points[b], cfg, with_nms, device,
                    tp) for b in range(len(points))]
    return Detections(boxes=torch.stack([d.boxes for d in dets]),
                      count=torch.stack([d.count for d in dets]),
                      occupancy=torch.stack([d.occupancy for d in dets]))


forward_scan = forward_batch


def forward_spatial(params: Dict, points, num_points, cfg: DSVTConfig,
                    with_nms: bool = False, device="cuda",
                    group=None) -> Detections:
    """``forward`` of one frame sharded over ``group`` (None: the default
    process group) by ``parallel.spatial``; every rank returns the same
    Detections."""
    with spatial_sharding(group):
        return forward(params, points, num_points, cfg, with_nms, device)


class IntermediateOutputs(NamedTuple):
    pillars: Pillars
    pillar_feats: torch.Tensor
    dsvt_feats: torch.Tensor
    bev_features: torch.Tensor
    head_out: Dict[str, torch.Tensor]


def partition_frame(params, points, num_points, cfg: DSVTConfig,
                    device="cuda"):
    """The integer stages of one frame, without autograd: (pillars, window
    partitions, set partitions)."""
    points, num = _inputs(params, points, num_points, device)
    with torch.no_grad():
        pillars = voxelize(points, num, cfg)
        wparts, sparts = _partitions(pillars, cfg)
    return pillars, wparts, sparts


def float_stages(params, pillars: Pillars, wparts, sparts, cfg: DSVTConfig,
                 live_weights: bool = False, tp=None) -> IntermediateOutputs:
    """VFE to the full-map head on the plain paths, from the partitions of
    ``partition_frame``; ``tp`` as in ``forward``."""
    precision = cfg.precision
    pfeats = vfe_forward(pillars, params["vfe"], cfg, use_kernels=False)
    dfeats = backbone3d_forward(pfeats, wparts, sparts, params, cfg,
                                use_kernels=False, live_weights=live_weights,
                                tp=tp)
    bev = map_to_bev(dfeats, pillars.coords, pillars.pillar_valid,
                     (cfg.grid_size[1], cfg.grid_size[0]))
    bev2 = backbone2d_forward(bev, params["backbone2d"], precision)
    head_out = head_forward(bev2, params["head"], precision)
    return IntermediateOutputs(pillars, pfeats, dfeats, bev2, head_out)


@torch.inference_mode()
def forward_debug(params, points, num_points, cfg: DSVTConfig,
                  device="cuda") -> IntermediateOutputs:
    """Per-stage outputs for parity checks: the plain reference paths (no
    kernels), full-map head, as the JAX forward_debug."""
    return float_stages(params, *partition_frame(params, points, num_points,
                                                 cfg, device), cfg)


def forward_train(params, points, num_points, cfg: DSVTConfig,
                  device="cuda", tp=None) -> IntermediateOutputs:
    """``forward_debug`` with autograd on and the projections packed from
    the live weights (module docstring)."""
    return float_stages(params, *partition_frame(params, points, num_points,
                                                 cfg, device), cfg,
                        live_weights=True, tp=tp)
