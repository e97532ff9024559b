"""CenterPoint-style CenterHead, port of the JAX model/head.py.

Shared 3x3 conv 384->64 (+BN folded, ReLU), then six branches (center 2,
center_z 1, dim 3, rot 2, iou 1, hm num_classes), each 3x3 conv 64 (+BN,
ReLU) -> 3x3 conv with bias.  The iou branch is computed but unused
downstream; it is kept for checkpoint parity.

``lazy=True`` (the main path) computes full maps only for the heatmap, the
top-k source; the regression branches are evaluated at the selected cells
inside decode (ops/postprocess.py:decode_lazy_branches).  The JAX package's
row-batched 3x3 conv (``_rowconv3``) was a TPU layout workaround; here each
is a plain 3x3 conv with padding 1.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..config import DSVTConfig, HEAD_BRANCHES, head_branches
from ..ops.common import relu
from .backbone2d import conv, to_hwc, to_nchw


def head_forward(features: torch.Tensor, params: dict,
                 precision: str = "fp32", cfg: DSVTConfig = None,
                 lazy: bool = False) -> Dict[str, torch.Tensor]:
    """features: [H, W, 384] -> dict of [H, W, c] maps (``lazy``: only
    {"hm", "shared"})."""
    branches = head_branches(cfg) if cfg is not None else tuple(
        (name, params[name]["w1"].shape[0]) for name, _ in HEAD_BRANCHES)
    x = to_nchw(features)
    shared = relu(conv(x, params["shared_w"], params["shared_b"], 1,
                             precision))
    if lazy:
        hm_hidden = relu(conv(shared, params["hm"]["w0"],
                                    params["hm"]["b0"], 1, precision))
        hm = conv(hm_hidden, params["hm"]["w1"], params["hm"]["b1"], 1,
                  precision)
        return {"hm": to_hwc(hm), "shared": to_hwc(shared)}

    # the six hidden convs as one 64 -> 6*64 conv, then each branch's final
    # conv on its own 64-channel slice
    hidden_c = params[branches[0][0]]["w0"].shape[0]
    w0 = torch.cat([params[n]["w0"] for n, _ in branches], dim=0)
    b0 = torch.cat([params[n]["b0"] for n, _ in branches], dim=0)
    hidden = relu(conv(shared, w0, b0, 1, precision))
    out = {}
    for i, (name, _c) in enumerate(branches):
        h = hidden[:, i * hidden_c:(i + 1) * hidden_c]
        out[name] = to_hwc(conv(h, params[name]["w1"], params[name]["b1"], 1,
                                precision))
    return out
