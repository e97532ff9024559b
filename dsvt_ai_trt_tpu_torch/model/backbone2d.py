"""2D BEV ResNet backbone (BaseBEVResBackbone), port of the JAX
model/backbone2d.py.

Three stages of residual units (stage0: stride-1 downsample unit + 1
identity unit @128; stage1: stride-2 unit + 2 identity @128; stage2:
stride-2 unit + 2 identity @256), then three lateral upsampling heads
(1x1 s1, 2x2 s2, 4x4 s4 transposed convs to 128 channels) concatenated to
384 channels at full resolution.

The convs are cuDNN's (``F.conv2d``, ``F.conv_transpose2d``): the JAX
package left them to XLA.  They pad symmetrically by k//2 (torch
``padding=k//2``, NOT XLA "SAME", which pads stride-2 convs asymmetrically)
and run NCHW-logical tensors in the ``channels_last`` memory layout, which
is the [H, W, C] layout of the public functions, so entering and leaving
the stack moves no data.  bf16 convs emit bf16; mixed convs take bf16
inputs and return f32.

Inside ``parallel.spatial.spatial_sharding`` the map holds this rank's
rows only (``spatial.bev_range``): every conv runs on them with halo rows
from its neighbours (``spatial.conv2d_rows``), every deblock locally
(``spatial.conv_transpose_rows``), and the three laterals, each at this
rank's rows of the full map, concatenate per rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import BACKBONE2D_STAGES, BACKBONE2D_DEBLOCK
from ..ops.common import compute_dtype, matmul_dtype, relu
from ..parallel import spatial


def to_nchw(x_hwc: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [1, C, H, W] view (channels_last strides)."""
    return x_hwc.permute(2, 0, 1).unsqueeze(0)


def to_hwc(x_nchw: torch.Tensor) -> torch.Tensor:
    """[1, C, H, W] -> [H, W, C] (a view when the input is channels_last)."""
    return x_nchw[0].permute(1, 2, 0)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int = 1,
         precision: str = "fp32") -> torch.Tensor:
    """Conv with OIHW ``w``, symmetric k//2 padding, bias; NCHW in/out
    (this rank's rows under spatial sharding)."""
    mdt = matmul_dtype(precision)
    x, w, b = x.to(mdt), w.to(mdt), b.to(mdt)
    if spatial.active():
        y = spatial.conv2d_rows(x, w, b, stride)
    else:
        y = F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)
    return y.to(compute_dtype(precision))


def _res_unit(x, unit, stride, precision):
    h = relu(conv(x, unit["conv1_w"], unit["conv1_b"], stride, precision))
    h = conv(h, unit["conv2_w"], unit["conv2_b"], 1, precision)
    if "down_w" in unit:
        shortcut = conv(x, unit["down_w"], unit["down_b"], stride, precision)
    else:
        shortcut = x
    return relu(h + shortcut)


def _upsample(x, w, b, k, precision):
    """ConvTranspose2d with kernel == stride; w is [in, out, k, k]."""
    mdt = matmul_dtype(precision)
    x, w, b = x.to(mdt), w.to(mdt), b.to(mdt)
    if spatial.active():
        y = spatial.conv_transpose_rows(x, w, b, k)
    else:
        y = F.conv_transpose2d(x, w, b, stride=k)
    return relu(y).to(compute_dtype(precision))


def backbone2d_nchw(x: torch.Tensor, params: dict,
                    precision: str = "fp32") -> torch.Tensor:
    """[1, C, H, W] -> [1, 384, H, W], channels_last throughout."""
    x = x.contiguous(memory_format=torch.channels_last)
    laterals = []
    for s, (units, _ch, stride) in enumerate(BACKBONE2D_STAGES):
        stage = params["stages"][s]
        for u in range(units):
            x = _res_unit(x, stage[u], stride if u == 0 else 1, precision)
        k, _s = BACKBONE2D_DEBLOCK[s]
        d = params["deblocks"][s]
        laterals.append(_upsample(x, d["w"], d["b"], k, precision))
    return torch.cat(laterals, dim=1).contiguous(
        memory_format=torch.channels_last)


def backbone2d_forward(bev: torch.Tensor, params: dict,
                       precision: str = "fp32") -> torch.Tensor:
    """bev: [H, W, 192] -> [H, W, 384]."""
    return to_hwc(backbone2d_nchw(to_nchw(bev), params, precision))
