"""The reference's view of a configuration file's ``config`` object.

The same keys as the port's ``DSVTConfig`` (the file is read by both
sides), held in a plain frozen dataclass; the fixed BEV ResNet and
CenterHead structure of the reference engine (params.h:86-322) as
constants.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# (units, channels, stride of the first unit) per stage of the BEV ResNet
BEV_STAGES = ((2, 128, 1), (3, 128, 2), (3, 256, 2))
# (kernel = stride) of the three transposed-conv laterals, 128 channels each
BEV_DEBLOCKS = (1, 2, 4)
BEV_LATERAL = 128
# CenterHead branches and widths; "hm" takes num_classes
HEAD_BRANCHES = (("center", 2), ("center_z", 1), ("dim", 3), ("rot", 2),
                 ("iou", 1), ("hm", None))


@dataclasses.dataclass(frozen=True)
class Config:
    max_points: int
    max_kept_points: int
    max_pillars: int
    max_points_per_pillar: int
    voxel_size: Tuple[float, float, float]
    pc_range_min: Tuple[float, float, float]
    pc_range_max: Tuple[float, float, float]
    grid_size: Tuple[int, int, int]
    point_feature_num: int
    pillar_feature_num: int
    pfn_channels: Tuple[int, int]
    sparse_shape: Tuple[int, int, int]
    window_specs: Tuple[Tuple[Tuple[int, int, int], Tuple[int, int, int]], ...]
    max_sets: int
    set_size: int
    num_blocks: int
    num_heads: int
    d_model: int
    ffn_dim: int
    ln_eps: float
    bn1d_eps: float
    bn2d_eps: float
    num_classes: int
    head_shared_channels: int
    head_conv_channels: int
    top_k: int
    score_threshold: float
    nms_threshold: float

    @staticmethod
    def from_dict(raw: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(Config)}
        kw = {k: v for k, v in raw.items() if k in names}
        for key in ("voxel_size", "pc_range_min", "pc_range_max", "grid_size",
                    "sparse_shape", "pfn_channels"):
            kw[key] = tuple(kw[key])
        kw["window_specs"] = tuple((tuple(w["shape"]), tuple(w["shift"]))
                                   for w in raw["window_specs"])
        return Config(**kw)

    def branches(self):
        return tuple((n, self.num_classes if c is None else c)
                     for n, c in HEAD_BRANCHES)

    def num_windows(self, shape) -> Tuple[int, int]:
        """Windows along x and y of a spec (integer divide, then +1)."""
        return (self.sparse_shape[0] // shape[0] + 1,
                self.sparse_shape[1] // shape[1] + 1)
