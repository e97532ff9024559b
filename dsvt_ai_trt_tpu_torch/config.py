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
    max_voxels_per_window: int = 576   # MAX_VOXEL_NUM_PER_WIN
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
        assert self.d_model % self.num_heads == 0
        for spec in self.window_specs:
            win_cap = spec.shape[0] * spec.shape[1] * spec.shape[2]
            # windows can never overflow the per-window buffer when the
            # buffer is at least the window's area
            assert win_cap <= self.max_voxels_per_window, (
                f"window {spec.shape} larger than max_voxels_per_window")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(text: str) -> "DSVTConfig":
        raw = json.loads(text)
        raw["window_specs"] = tuple(
            WindowSpec(tuple(w["shape"]), tuple(w["shift"]))
            for w in raw["window_specs"])
        for key in ("voxel_size", "pc_range_min", "pc_range_max", "grid_size",
                    "sparse_shape", "pfn_channels"):
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
