"""Configuration for the PyTorch/CUDA DSVT detector.

A copy of the JAX package's config.py (the port keeps its own copy so it
imports nothing of that package); stamps written by either cross-load.

Every default mirrors the reference engine's compile-time flag header
(reference: include/params.h) so that a user of DSVT-AI-TRT finds the same
knobs here, but as one runtime dataclass instead of ~150 #defines.

Geometry / capacity defaults come from params.h:20-70, attention dims from
params.h:72-84, backbone/head channels from params.h:86-322, and the
postprocessing thresholds from params.h:326-335.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """One BEV window partition (reference: params.h:52-66).

    The reference instantiates two of these: 12x12x1 with shift (0,0,0) and
    24x24x1 with shift (6,6,0).  Shifts are *added* to the voxel coordinate
    before the integer window division (reference: windowPartition.cu:292-298).
    """

    shape: Tuple[int, int, int] = (12, 12, 1)  # (x, y, z)
    shift: Tuple[int, int, int] = (0, 0, 0)

    def num_windows(self, sparse_shape: Tuple[int, int, int]) -> Tuple[int, int, int]:
        # reference: windowPartition.cu:425-427 — integer divide, then +1.
        return tuple(s // w + 1 for s, w in zip(sparse_shape, self.shape))


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One stage of the sparse backbone (upstream DSVT's ``set_info``,
    ``window_shape`` x ``hybrid_factor``, ``shifts_list`` and
    ``downsample_stride`` entries of one stage).

    ``num_blocks`` DSVT blocks run on the stage's voxels, in windows of
    ``window_specs`` over a grid of ``sparse_shape`` (x, y, z), in sets of
    ``set_size``; at most ``max_voxels`` voxels and ``max_sets`` sets per
    partition.  ``stride`` (x, y, z) pools the stage's voxels into the
    next stage's (``ops/pooling.py``); (1, 1, 1) on the last stage.  The
    field names ``sparse_shape``, ``set_size`` and ``max_sets`` are
    ``DSVTConfig``'s, so the partitions (``ops/windows.py``) take either.
    """

    sparse_shape: Tuple[int, int, int]
    window_specs: Tuple[WindowSpec, ...]
    num_blocks: int = 1
    set_size: int = 36
    max_voxels: int = 10000
    max_sets: int = 800
    stride: Tuple[int, int, int] = (1, 1, 1)

    @property
    def pool_volume(self) -> int:
        return self.stride[0] * self.stride[1] * self.stride[2]


@dataclasses.dataclass(frozen=True)
class DSVTConfig:
    """Full pipeline configuration (defaults = reference params.h)."""

    # ---- point cloud / voxelization (params.h:24-45) ----
    max_points: int = 50000            # MAX_POINTS_NUM
    max_kept_points: int = 30000       # MAX_POINTS_NUM_1 (compacted point list)
    max_pillars: int = 10000           # MAX_PILLARS_NUM
    max_points_per_pillar: int = 48    # POINTS_NUM_PER_VOXEL
    voxel_size: Tuple[float, float, float] = (0.32, 0.32, 8.0)
    pc_range_min: Tuple[float, float, float] = (-74.88, -74.88, -5.0)
    pc_range_max: Tuple[float, float, float] = (74.88, 74.88, 3.0)
    grid_size: Tuple[int, int, int] = (468, 468, 1)  # (x, y, z)
    point_feature_num: int = 4
    pillar_feature_num: int = 10

    # ---- PFN (params.h:43-44) ----
    pfn_channels: Tuple[int, int] = (96, 192)

    # ---- DSVT input layer (params.h:47-70) ----
    sparse_shape: Tuple[int, int, int] = (468, 468, 1)
    window_specs: Tuple[WindowSpec, ...] = (
        WindowSpec(shape=(12, 12, 1), shift=(0, 0, 0)),
        WindowSpec(shape=(24, 24, 1), shift=(6, 6, 0)),
    )
    max_voxels_per_window: int = 576   # MAX_VOXEL_NUM_PER_WIN (read by none)
    max_sets: int = 800                # MAX_WIN_NUM (used as the set cap)
    set_size: int = 36                 # VOXEL_NUM_SET

    # ---- DSVT attention (params.h:72-84) ----
    num_blocks: int = 4
    num_heads: int = 8
    d_model: int = 192                 # POSEMBED_LAYBERS_OUT_FEATURES
    ffn_dim: int = 384                 # SET_ATTENTION_0_0_OUT_CHANNEL_LINEAR_1
    ln_eps: float = 1e-5               # EPS

    # ---- BatchNorm epsilons (reference: dsvt-ai-trt.cpp:191/284) ----
    bn1d_eps: float = 1e-5
    bn2d_eps: float = 1e-3

    # ---- CenterHead (params.h:237-322) ----
    num_classes: int = 10              # HM_CONV_1_OUT_CHANNEL
    head_shared_channels: int = 64
    head_conv_channels: int = 64

    # ---- postprocess (params.h:326-335) ----
    top_k: int = 500                   # HM_TOP_K
    score_threshold: float = 0.3
    nms_threshold: float = 0.01        # NMS_THRESH
    # The reference decodes heading as atan(sin/cos) (dsvt-ai-trt.cpp:1667-1669),
    # losing the quadrant.  We default to the correct atan2 (box geometry is
    # identical modulo pi, so rotated-IoU parity holds); set True for bit-level
    # heading parity with the TRT engine.
    parity_atan: bool = False

    # per-class candidate search: exact top-k (reference semantics) or the
    # TPU-native approx_max_k (recall>=approx_recall_target per class; only
    # affects candidates ranked near K whose scores are far below the 0.3
    # threshold in practice).  Exact by default.  Raising the target to
    # 0.99 was measured a pure loss (round 5): approx_top_k 0.15 -> 0.60
    # ms/frame (device 11.13 -> 11.60) and the Waymo parity gate's missing
    # box did NOT return — the gate's expectation was wrong, not the
    # search (two independently approximated sides compound to ~0.95^2
    # end-to-end recall; tools/parity_check.py gates at that bound).
    approx_topk: bool = False
    approx_recall_target: float = 0.95

    # ---- staged sparse backbone (upstream DSVT-V) ----
    # Empty: the pillar model, one stage described by the fields above
    # (``stage_specs``).  Else every stage in order; the fields above then
    # describe stage 0 (``max_pillars`` is its voxel cap, ``num_blocks``
    # the blocks of all stages; ``validate`` holds them to it).  The
    # block counter runs across stages: global block b reads set
    # partition ``b % len(window_specs)`` of its stage.
    stages: Tuple[StageSpec, ...] = ()

    # ---- detection head ----
    # "center": the reference engine's CenterHead above (top-k decode and
    # rotated NMS).  "transfusion": upstream DSVT's nuScenes head,
    # TransFusion-L (Bai et al., CVPR 2022; OpenPCDet's
    # transfusion_head.py, its DENSE_HEAD): ``num_proposals`` heatmap
    # local maxima decoded by one transformer decoder layer of
    # ``query_channels`` wide, ``query_heads`` heads and an FFN of
    # ``query_ffn_dim``, whose cross-attention reads the whole BEV map,
    # then branches of ``query_branch_channels``; no NMS.  The
    # CenterHead's widths and thresholds are then unread.
    head: str = "center"
    num_proposals: int = 200             # NUM_PROPOSALS
    query_channels: int = 128            # HIDDEN_CHANNEL
    query_heads: int = 8                 # NUM_HEADS
    query_ffn_dim: int = 256             # FFN_CHANNEL
    query_branch_channels: int = 64      # the prediction branches' hidden
    query_nms_kernel: int = 3            # NMS_KERNEL_SIZE (the local max)
    # classes whose local max is a 1x1 pool (not suppressed): nuScenes'
    # pedestrian and traffic_cone
    query_free_classes: Tuple[int, ...] = (8, 9)
    query_score_threshold: float = 0.0   # SCORE_THRESH
    post_center_range: Tuple[float, ...] = (-61.2, -61.2, -10.0,
                                            61.2, 61.2, 10.0)

    # ---- execution ----
    # "fp32" = strict parity (Precision.HIGHEST matmuls); "mixed" = fp32 data
    # with bf16-input/fp32-accum matmuls (the TPU analogue of USE_FP16,
    # params.h:332); "bf16" = bf16 activations end to end.
    precision: str = "fp32"
    # the hand-written CUDA kernels (ops/*_kernel.py, ops/segment.py) on
    # tensors that live on the card; tensors on the CPU take each kernel's
    # plain PyTorch version.  The name is kept from the JAX package so
    # config stamps cross-load.
    use_pallas: bool = True

    # ------------------------------------------------------------------
    @property
    def num_window_partitions(self) -> int:
        return len(self.window_specs)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    def max_sets_for(self, spec: WindowSpec) -> int:
        return self.max_sets

    def validate(self) -> None:
        # (no buffer is sized by max_voxels_per_window: the partitions
        # size their in-window keys from each window's own shape)
        assert self.d_model % self.num_heads == 0
        assert self.head in ("center", "transfusion"), self.head
        if self.head == "transfusion":
            self._validate_query_head()
        if not self.stages:
            assert self.grid_size[2] == 1, (
                "3-D voxels (grid_size[2] > 1) need the stages that pool "
                "them down to the BEV grid")
            return
        stages = self.stages
        first = stages[0]
        assert (tuple(first.sparse_shape) == tuple(self.sparse_shape)
                == tuple(self.grid_size)
                and first.window_specs == self.window_specs
                and first.set_size == self.set_size
                and first.max_sets == self.max_sets
                and first.max_voxels == self.max_pillars), (
            "the global sparse_shape, window_specs, set_size, max_sets and "
            "max_pillars describe stage 0")
        assert self.num_blocks == sum(st.num_blocks for st in stages), (
            "num_blocks counts the blocks of every stage")
        for s, st in enumerate(stages):
            assert st.window_specs and st.num_blocks >= 1, f"stage {s}"
            assert 1 <= st.set_size <= 64, (
                f"stage {s}: sets of at most 64 voxels (kernel B1)")
            for spec in st.window_specs:
                assert all(1 <= w <= n for w, n in
                           zip(spec.shape, st.sparse_shape)), (
                    f"stage {s}: window {spec.shape} outside the sparse "
                    f"shape {st.sparse_shape}")
            if s + 1 < len(stages):
                nxt = tuple(-(-n // k) for n, k in
                            zip(st.sparse_shape, st.stride))
                assert nxt == tuple(stages[s + 1].sparse_shape), (
                    f"stage {s + 1}: sparse shape {stages[s + 1].sparse_shape}"
                    f" is not stage {s}'s {st.sparse_shape} over its stride "
                    f"{st.stride}")
                assert 2 <= st.pool_volume <= 8, (
                    f"stage {s}: pooling volume of 2 to 8 voxels")
        last = stages[-1]
        assert tuple(last.stride) == (1, 1, 1) and last.sparse_shape[2] == 1 \
            and tuple(last.sparse_shape[:2]) == tuple(self.grid_size[:2]), (
                "the strides reach z = 1, at the BEV grid, at the last stage")

    def _validate_query_head(self) -> None:
        H, W = self.grid_size[1], self.grid_size[0]
        assert 1 <= self.num_proposals <= self.num_classes * H * W, (
            "num_proposals: at least one, at most every (class, cell)")
        assert self.query_channels % self.query_heads == 0, (
            "query_channels splits over query_heads")
        assert self.query_ffn_dim >= 1 and self.query_branch_channels >= 1
        assert self.query_nms_kernel % 2 == 1 and \
            1 <= self.query_nms_kernel <= min(H, W), (
                "query_nms_kernel: an odd pool that fits the map")
        assert all(0 <= c < self.num_classes
                   for c in self.query_free_classes), "query_free_classes"
        lo, hi = self.post_center_range[:3], self.post_center_range[3:]
        assert len(self.post_center_range) == 6 and all(
            a < b for a, b in zip(lo, hi)), "post_center_range: min, max"

    def to_json(self) -> str:
        raw = dataclasses.asdict(self)
        # a pillar model's stamp is the one it always was, and a
        # CenterHead's too
        if not self.stages:
            del raw["stages"]
        if self.head == "center":
            for key in QUERY_KEYS:
                del raw[key]
        return json.dumps(raw, indent=2)

    @staticmethod
    def from_json(text: str) -> "DSVTConfig":
        raw = json.loads(text)
        raw["window_specs"] = _window_specs(raw["window_specs"])
        raw["stages"] = tuple(
            StageSpec(tuple(st["sparse_shape"]),
                      _window_specs(st["window_specs"]), st["num_blocks"],
                      st["set_size"], st["max_voxels"], st["max_sets"],
                      tuple(st["stride"]))
            for st in raw.get("stages", ()))
        for key in ("voxel_size", "pc_range_min", "pc_range_max", "grid_size",
                    "sparse_shape", "pfn_channels", "query_free_classes",
                    "post_center_range"):
            if key in raw:
                raw[key] = tuple(raw[key])
        # drop keys from older stamps (e.g. a removed field) — loudly, since
        # a removed-but-behavioral field (an old attn_impl, say) would
        # otherwise weaken load_engine's config-mismatch guard silently
        known = {f.name for f in dataclasses.fields(DSVTConfig)}
        dropped = sorted(set(raw) - known)
        if dropped:
            import logging
            logging.getLogger(__name__).warning(
                "config stamp carries unknown fields %s (from an older/newer "
                "schema); they are ignored — verify the engine's semantics "
                "match if any were behavioral", dropped)
        raw = {k: v for k, v in raw.items() if k in known}
        return DSVTConfig(**raw)


# the keys of the TransFusion-L head, left out of a CenterHead's stamp
QUERY_KEYS = ("head", "num_proposals", "query_channels", "query_heads",
              "query_ffn_dim", "query_branch_channels", "query_nms_kernel",
              "query_free_classes", "query_score_threshold",
              "post_center_range")


def query_head(cfg) -> bool:
    """Whether ``cfg`` runs the TransFusion-L head (the JAX package's
    DSVTConfig has no head key: the CenterHead)."""
    return getattr(cfg, "head", "center") == "transfusion"


# TransFusion-L's prediction branches in upstream order, with their output
# channels (OpenPCDet's SeparateHead_Transfusion: center, height, dim, rot,
# vel, and heatmap of num_classes)
QUERY_BRANCHES = (("center", 2), ("height", 1), ("dim", 3), ("rot", 2),
                  ("vel", 2), ("heatmap", None))


def query_branches(cfg):
    return tuple((name, cfg.num_classes if c is None else c)
                 for name, c in QUERY_BRANCHES)


# The stages of a configuration.  Functions, not methods: the port's entry
# points also take the JAX package's DSVTConfig (tests and config stamps
# cross-load), which has no stages and is the pillar model.


def staged(cfg) -> bool:
    """Whether ``cfg`` describes a staged backbone (upstream DSVT-V)."""
    return bool(getattr(cfg, "stages", ()))


def stage_specs(cfg) -> Tuple[StageSpec, ...]:
    """Every stage of the sparse backbone; the pillar model is one."""
    if staged(cfg):
        return cfg.stages
    return (StageSpec(cfg.sparse_shape, cfg.window_specs, cfg.num_blocks,
                      cfg.set_size, cfg.max_pillars, cfg.max_sets),)


def stage_blocks(cfg) -> Tuple[range, ...]:
    """The global block ids of each stage (the block counter)."""
    out, b0 = [], 0
    for st in stage_specs(cfg):
        out.append(range(b0, b0 + st.num_blocks))
        b0 += st.num_blocks
    return tuple(out)


def used_partitions(cfg, s: int) -> Tuple[int, ...]:
    """The window specs of stage ``s`` whose set partitions its blocks
    read: global block b reads ``b % len(window_specs)``."""
    n = len(stage_specs(cfg)[s].window_specs)
    return tuple(sorted({b % n for b in stage_blocks(cfg)[s]}))


def occupancy_caps(cfg):
    """(names, caps) in ``Detections.occupancy`` order: kept points, the
    voxels of each stage, the live sets of each partition a stage reads
    (the pillar model: kept points, pillars, sets per window spec)."""
    if not staged(cfg):
        return (["max_kept_points", "max_pillars"]
                + [f"max_sets[{i}]" for i in range(len(cfg.window_specs))],
                [cfg.max_kept_points, cfg.max_pillars]
                + [cfg.max_sets_for(s) for s in cfg.window_specs])
    names = ["max_kept_points"] + [f"max_voxels[{s}]"
                                   for s in range(len(cfg.stages))]
    caps = [cfg.max_kept_points] + [st.max_voxels for st in cfg.stages]
    for s, st in enumerate(cfg.stages):
        for i in used_partitions(cfg, s):
            names.append(f"max_sets[{s}.{i}]")
            caps.append(st.max_sets)
    return names, caps


def _window_specs(raw) -> Tuple[WindowSpec, ...]:
    return tuple(WindowSpec(tuple(w["shape"]), tuple(w["shift"])) for w in raw)


# 2D backbone block structure (reference: params.h:86-233 and
# dsvt-ai-trt.cpp:1140-1364).  Each stage: (num_units, out_channels, stride of
# the first unit); lateral deconv heads: (kernel=stride upsampling, 128 ch).
BACKBONE2D_STAGES = (
    # (num res units, channels, first-unit stride)
    (2, 128, 1),
    (3, 128, 2),
    (3, 256, 2),
)
BACKBONE2D_DEBLOCK = (
    # (kernel, stride) per stage; out channels always 128
    (1, 1),
    (2, 2),
    (4, 4),
)
BACKBONE2D_OUT_CHANNELS = 128 * 3  # concat of the three lateral heads

# CenterHead branches in reference graph order with their output channels
# (reference: dsvt-ai-trt.cpp:1369-1468; the iou branch is computed by the
# reference but unused downstream — kept for parity).
HEAD_BRANCHES = (
    ("center", 2),
    ("center_z", 1),
    ("dim", 3),
    ("rot", 2),
    ("iou", 1),
    ("hm", 10),
)


def head_branches(cfg: "DSVTConfig"):
    """Branch list with the heatmap width tied to cfg.num_classes."""
    return tuple((name, cfg.num_classes if name == "hm" else c)
                 for name, c in HEAD_BRANCHES)


DEFAULT_CONFIG = DSVTConfig()

# Waymo-scale point density (BASELINE config 5): ~180K points/frame, same
# 0.32 m pillars and +/-74.88 m range as the upstream DSVT Waymo config.
# Cap sizing is the same engineering act as the reference's params.h picks
# for nuScenes: measured occupancy on the dense benchmark frames
# (`cli stats`) is ~118K kept points, ~11.4K pillars, ~600 sets, so the
# caps below carry 18-70% headroom; every set/pillar op costs time
# proportional to its CAP (static shapes), not its occupancy.  Use with
# spatial sharding for multi-chip frames.
WAYMO_CONFIG = dataclasses.replace(
    DSVTConfig(),
    max_points=200000,
    max_kept_points=140000,
    max_pillars=16000,
    max_sets=1024,
)
