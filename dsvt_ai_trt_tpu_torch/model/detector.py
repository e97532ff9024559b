"""End-to-end DSVT detector: points -> boxes (port of model/detector.py).

voxelize (its segment work kernel ``voxel_segments``) -> VFE (2x segmented
max, kernel B3) -> window/set partition per
window spec -> DSVT backbone (4 blocks x 2 encoders; kernels B1 + B2 on the
bf16/mixed fast paths) -> BEV scatter -> BEV ResNet -> lazy CenterHead ->
top-k decode + score filter -> rotated NMS (kernel B4), or, with
``DSVTConfig.head`` "transfusion", upstream DSVT's nuScenes head
TransFusion-L (model/transfusion.py: heatmap proposals decoded by a
transformer decoder layer whose cross-attention is kernel
``query_attention``; no NMS stage, whatever ``with_nms`` says).  A staged
configuration (``DSVTConfig.stages``, upstream DSVT-V) voxelizes on a 3-D
grid and runs, per stage, its window and set partitions and its blocks,
pooling each stage's voxels into the next (``ops/pooling.py``,
``backbone3d.staged_forward``); the BEV scatter reads the last stage's
voxels.  The pillar model is one stage.

``forward`` runs on ``device`` (default "cuda", which raises without a
card; tests pass "cpu").  The parameters must already live there
(``weights.from_jax_params(params, device)``).  Each stage runs under
``runtime.profiler.stage_scope`` (a ``torch.profiler.record_function``
label, STAGES), so a profiler trace splits a frame's time by stage and
``runtime.profiler.count_flops`` counts FLOPs by stage; outside a profiler
the labels cost a few microseconds per frame.  With the port's tracer on
(``runtime.profiler.enable_spans``), each stage's entry is also a device
stage mark, and the frame's occupancy, count of boxes before NMS,
``bev_restrides`` and ``bev_fused_convs`` go to its counters.
``bev_restrides`` is the number of tensors the BEV ResNet and the head
copy into their layout on a frame (``ops.layout.laid_out``), counted on
the host as the frame is traced or captured: 0 on the bf16 and mixed
paths of an ``Engine`` (its conv weights folded, ``weights.fold_convs``),
1 at fp32 (the entry to NCHW).
``bev_fused_convs``, counted the same way, is the number of the stack's
convs that finished their bias, residual add and ReLU inside cuDNN's pass
(``backbone2d.fuses_epilogue``): 18 on a bf16 frame on the card (16 in the
residual units, the head's two hidden convs), 0 at fp32 and mixed, on the
CPU and under spatial sharding; a training step's record reads it too, 0.

``forward_batch`` is the per-frame stacked form that the JAX package's
vmap computes (the form data parallelism runs on each dp rank,
parallel/mesh.py:make_dp_engine) and its ``forward_scan`` too (``lax.scan``
there): in PyTorch both are the frames of a batch one after another,
outputs stacked, so they are one function, which ``runtime.compile.
Engine(..., batch=B)`` captures as one CUDA graph a group.  ``tp`` (a process
group; params from ``parallel.mesh.rank_params``) runs the encoders tensor
parallel (model/backbone3d.py), and ``forward_spatial`` is ``forward``
inside ``parallel.spatial.spatial_sharding``: one frame sharded by pillar,
set and BEV rows over a group, every rank returning the same boxes.

``forward_train`` is ``forward_debug`` with autograd on, for the training
loss (parallel/training.py): the plain paths (kernels B1-B3 define no
backward, as in the JAX package), the full head, and the attention
projections packed from the live weights.  Its integer stages
(``partition_frame``: voxelize, plain, window/set partitions) carry no gradient
and run apart from the float stages (``float_stages``), so a recomputing
backward (``torch.utils.checkpoint``) reruns only the float stages on the
same partitions.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch

from ..config import (DSVTConfig, query_head, stage_specs, staged,
                      used_partitions)
from ..ops import layout, nms as nms_ops
from ..ops.bev import map_to_bev
from ..ops.common import resolve_device
from ..ops.postprocess import Detections, decode_and_filter, decode_queries
from ..ops.pooling import PoolMap, pool_map
from ..ops.voxelize import Pillars, voxelize
from ..ops.windows import set_partition, window_partition
from ..parallel import spatial
from ..parallel.spatial import spatial_sharding
from ..runtime import profiler
from ..runtime.profiler import stage_scope
from .backbone2d import backbone2d_forward, fused_convs
from .backbone3d import staged_forward
from .head import head_forward
from .transfusion import head_forward as query_head_forward
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


class StageParts(NamedTuple):
    """The integer work of one backbone stage: ``windows``, a window
    partition per window spec; ``sets``, a set partition per window spec,
    None where none of the stage's blocks reads it; ``pool``, the map to
    the next stage's voxels (None at the last); and the stage's voxels:
    ``coords`` ([P, 2] (iy, ix) pillars, or [P, 3] (iz, iy, ix)),
    ``valid`` and ``count``."""

    windows: List
    sets: List
    pool: Optional[PoolMap]
    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def _partitions(pillars: Pillars, cfg: DSVTConfig) -> List[StageParts]:
    """Each stage's partitions and pooling map (the pillar model: one
    stage, a window and a set partition per window spec)."""
    specs = stage_specs(cfg)
    coords, valid, count = (pillars.coords, pillars.pillar_valid,
                            pillars.pillar_count)
    out = []
    for s, st in enumerate(specs):
        used = used_partitions(cfg, s)
        windows, sets = [], []
        for i, spec in enumerate(st.window_specs):
            windows.append(window_partition(coords, valid, spec, st))
            sets.append(set_partition(windows[-1], valid, spec, st)
                        if i in used else None)
        pm = (pool_map(coords, valid, st, specs[s + 1])
              if s + 1 < len(specs) else None)
        out.append(StageParts(windows, sets, pm, coords, valid, count))
        if pm is not None:
            coords, valid, count = pm.coords, pm.valid, pm.count
    return out


def _occupancy(pillars: Pillars, stages: List[StageParts]) -> torch.Tensor:
    """Kept points, each stage's voxels, then the live sets of each set
    partition a stage reads (the pillar model: points, pillars, sets per
    window spec)."""
    return torch.stack([pillars.point_count] + [st.count for st in stages]
                       + [sp.set_count for st in stages for sp in st.sets
                          if sp is not None])


def _bev_input(stages: List[StageParts]):
    """The last stage's (iy, ix) and valid, for the BEV scatter."""
    last = stages[-1]
    return last.coords[:, -2:], last.valid


def _unsharded(cfg: DSVTConfig, tp) -> None:
    if staged(cfg) and (tp is not None or spatial.active()):
        raise ValueError("a staged configuration (DSVTConfig.stages) runs on "
                         "one device: tensor and spatial sharding of its "
                         "stages and poolings are not written")
    if query_head(cfg) and (tp is not None or spatial.active()):
        raise ValueError("the TransFusion-L head (DSVTConfig.head) runs on "
                         "one device: tensor and spatial sharding of it are "
                         "not written")


STAGES = ("voxelize", "vfe", "partition", "backbone3d", "bev_scatter",
          "backbone2d", "head", "decode", "nms")


@torch.inference_mode()
def forward(params: Dict, points, num_points, cfg: DSVTConfig,
            with_nms: bool = False, device="cuda", tp=None) -> Detections:
    """points: [max_points, 4] (array or tensor); num_points: int or [].
    The hand-written kernels run where ``cfg.use_pallas`` is set.  ``tp``:
    the tensor-parallel group of the encoders (module docstring)."""
    _unsharded(cfg, tp)
    points, num = _inputs(params, points, num_points, device)
    precision = cfg.precision
    use_kernels = cfg.use_pallas
    with stage_scope("voxelize"):
        pillars = voxelize(points, num, cfg, use_kernels=use_kernels)
    with stage_scope("vfe"):
        feats = vfe_forward(pillars, params["vfe"], cfg,
                            use_kernels=use_kernels)
    with stage_scope("partition"):
        stages = _partitions(pillars, cfg)
    if len(stages) > 1 and profiler.tracer() is not None:
        profiler.counter("pool_parents",
                         torch.stack([st.pool.count for st in stages[:-1]]))
    with stage_scope("backbone3d"):
        feats = staged_forward(feats, stages, params, cfg,
                               use_kernels=use_kernels, tp=tp)
    with stage_scope("bev_scatter"):
        if precision == "bf16":
            feats = feats.to(torch.bfloat16)
        bev = map_to_bev(feats, *_bev_input(stages),
                         (cfg.grid_size[1], cfg.grid_size[0]))
    restrides, fused = layout.restrides(), fused_convs()
    with stage_scope("backbone2d"):
        bev = backbone2d_forward(bev, params["backbone2d"], precision)
    query = query_head(cfg)
    with stage_scope("head"):
        if query:
            head_out = query_head_forward(bev, params["head"], cfg,
                                          use_kernels)
        else:
            head_out = head_forward(bev, params["head"], precision, cfg,
                                    lazy=True)
    profiler.counter("bev_restrides", layout.restrides() - restrides)
    profiler.counter("bev_fused_convs", fused_convs() - fused)
    with stage_scope("decode"):
        dets = (decode_queries(head_out, cfg) if query else
                decode_and_filter(head_out, cfg, head_params=params["head"]))
    profiler.counter("query_boxes" if query else "boxes_before_nms",
                     dets.count)
    if with_nms and not query:
        with stage_scope("nms"):
            boxes, count = nms_ops.nms(dets.boxes, dets.count,
                                       cfg.nms_threshold,
                                       use_kernels=use_kernels)
        dets = Detections(boxes=boxes, count=count)
    occupancy = _occupancy(pillars, stages)
    profiler.counter("occupancy", occupancy)
    return dets._replace(occupancy=occupancy)


def forward_batch(params: Dict, points, num_points, cfg: DSVTConfig,
                  with_nms: bool = False, device="cuda",
                  tp=None) -> Detections:
    """points [B, max_points, 4], num_points [B]: each frame through
    ``forward`` in turn; returns stacked Detections (boxes [B, top_k, 9],
    count [B], occupancy [B, 2 + n_window_specs] for the pillar model)."""
    dets = [forward(params, points[b], num_points[b], cfg, with_nms, device,
                    tp) for b in range(len(points))]
    return Detections(boxes=torch.stack([d.boxes for d in dets]),
                      count=torch.stack([d.count for d in dets]),
                      occupancy=torch.stack([d.occupancy for d in dets]))


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
    """The integer stages of one frame, without autograd: (pillars, each
    stage's ``StageParts``)."""
    points, num = _inputs(params, points, num_points, device)
    with torch.no_grad():
        pillars = voxelize(points, num, cfg, use_kernels=False)
        stages = _partitions(pillars, cfg)
    return pillars, stages


def float_stages(params, pillars: Pillars, stages: List[StageParts],
                 cfg: DSVTConfig, live_weights: bool = False,
                 tp=None) -> IntermediateOutputs:
    """VFE to the full-map head on the plain paths, from the partitions of
    ``partition_frame``; ``tp`` as in ``forward``.  ``dsvt_feats`` are the
    last stage's.  The CenterHead only."""
    _unsharded(cfg, tp)
    if query_head(cfg):
        raise ValueError("the full-map head maps and training of the "
                         "TransFusion-L head (DSVTConfig.head) are not "
                         "written: its Hungarian assignment and losses are "
                         "not ported")
    precision = cfg.precision
    pfeats = vfe_forward(pillars, params["vfe"], cfg, use_kernels=False)
    dfeats = staged_forward(pfeats, stages, params, cfg, use_kernels=False,
                            live_weights=live_weights, tp=tp)
    bev = map_to_bev(dfeats, *_bev_input(stages),
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
    the live weights (module docstring); the pillar model only."""
    if staged(cfg):
        raise ValueError("training a staged configuration (DSVTConfig."
                         "stages) is not written: its poolings define no "
                         "backward pass here")
    return float_stages(params, *partition_frame(params, points, num_points,
                                                 cfg, device), cfg,
                        live_weights=True, tp=tp)
