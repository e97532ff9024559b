"""2D BEV ResNet backbone (BaseBEVResBackbone), port of the JAX
model/backbone2d.py.

Three stages of residual units (stage0: stride-1 downsample unit + 1
identity unit @128; stage1: stride-2 unit + 2 identity @128; stage2:
stride-2 unit + 2 identity @256), then three lateral upsampling heads
(1x1 s1, 2x2 s2, 4x4 s4 transposed convs to 128 channels) concatenated to
384 channels at full resolution.

The convs are cuDNN's (``F.conv2d``, ``F.conv_transpose2d``): the JAX
package left them to XLA.  They pad symmetrically by k//2 (torch
``padding=k//2``, NOT XLA "SAME", which pads stride-2 convs asymmetrically).
bf16 convs emit bf16; mixed convs take bf16 inputs and return f32.

The layout follows the conv's input dtype (ops/layout.py).  bf16 convs
(the bf16 and mixed precisions) run NHWC: the [H, W, C] map of the public
functions, viewed as [1, C, H, W] with ``channels_last`` strides, enters
the stack with no data moved, every activation and every weight reaches
cuDNN in the layout its NHWC kernels take, and the elementwise ops and the
final concatenation of the laterals run on dense NHWC tensors.  The bf16
weights are copies folded once, channels_last (``fold``, via
``weights.fold_convs``, which an ``Engine`` at bf16 or mixed calls), unless
a gradient has to reach the f32 leaves or none were folded.  fp32
convs run NCHW-contiguous: the map is copied once at the stack's entry,
and the output, viewed back as [H, W, C], is a strided view.

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
from ..ops.layout import conv_format, laid_out, to_hwc, to_nchw
from ..parallel import spatial

BF16 = "_bf16"      # key suffix of a conv weight's folded bf16 copy


def conv_nodes(params: dict):
    """(dict, weight key, bias key) of every conv of a whole model's BEV
    ResNet and head."""
    bev, head = params["backbone2d"], params["head"]
    for stage in bev["stages"]:
        for unit in stage:
            for name in ("conv1", "conv2", "down"):
                if f"{name}_w" in unit:
                    yield unit, f"{name}_w", f"{name}_b"
    for deblock in bev["deblocks"]:
        yield deblock, "w", "b"
    yield head, "shared_w", "shared_b"
    for branch in head.values():
        if isinstance(branch, dict):
            yield branch, "w0", "b0"
            yield branch, "w1", "b1"


def fold(w: torch.Tensor, b: torch.Tensor):
    """A conv's bf16 weight (channels_last) and bias."""
    return (w.detach().to(torch.bfloat16, memory_format=torch.channels_last),
            b.detach().to(torch.bfloat16))


def conv_weights(node: dict, w_key: str, b_key: str, precision: str):
    """A conv's weight and bias in the dtype and layout of its input: on
    the bf16 convs the copies ``fold`` made, unless a gradient has to reach
    the leaves (or none were folded); else the leaves, cast."""
    w, b = node[w_key], node[b_key]
    mdt = matmul_dtype(precision)
    if (mdt == torch.bfloat16 and w_key + BF16 in node
            and not (torch.is_grad_enabled() and w.requires_grad)):
        return node[w_key + BF16], node[b_key + BF16]
    return laid_out(w.to(mdt), conv_format(mdt)), b.to(mdt)


def conv(x: torch.Tensor, node: dict, w_key: str, b_key: str,
         stride: int = 1, precision: str = "fp32") -> torch.Tensor:
    """Conv with the OIHW weight ``node[w_key]``, symmetric k//2 padding,
    bias ``node[b_key]``; [1, C, H, W] in/out in the conv's layout (this
    rank's rows under spatial sharding)."""
    w, b = conv_weights(node, w_key, b_key, precision)
    fmt = conv_format(w.dtype)
    x = laid_out(x, fmt).to(w.dtype)
    if spatial.active():
        y = spatial.conv2d_rows(x, w, b, stride)
    else:
        y = F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2)
    return laid_out(y, fmt).to(compute_dtype(precision))


def _res_unit(x, unit, stride, precision):
    h = relu(conv(x, unit, "conv1_w", "conv1_b", stride, precision))
    h = conv(h, unit, "conv2_w", "conv2_b", 1, precision)
    if "down_w" in unit:
        shortcut = conv(x, unit, "down_w", "down_b", stride, precision)
    else:
        shortcut = x
    return relu(h + shortcut)


def _upsample(x, deblock, k, precision):
    """ConvTranspose2d with kernel == stride; w is [in, out, k, k]."""
    w, b = conv_weights(deblock, "w", "b", precision)
    fmt = conv_format(w.dtype)
    x = laid_out(x, fmt).to(w.dtype)
    if spatial.active():
        y = spatial.conv_transpose_rows(x, w, b, k)
    else:
        y = F.conv_transpose2d(x, w, b, stride=k)
    return relu(laid_out(y, fmt)).to(compute_dtype(precision))


def backbone2d_nchw(x: torch.Tensor, params: dict,
                    precision: str = "fp32") -> torch.Tensor:
    """[1, C, H, W] -> [1, 384, H, W], in the convs' layout throughout
    (module docstring)."""
    x = laid_out(x, conv_format(matmul_dtype(precision)))
    laterals = []
    for s, (units, _ch, stride) in enumerate(BACKBONE2D_STAGES):
        stage = params["stages"][s]
        for u in range(units):
            x = _res_unit(x, stage[u], stride if u == 0 else 1, precision)
        k, _s = BACKBONE2D_DEBLOCK[s]
        laterals.append(_upsample(x, params["deblocks"][s], k, precision))
    return torch.cat(laterals, dim=1)


def backbone2d_forward(bev: torch.Tensor, params: dict,
                       precision: str = "fp32") -> torch.Tensor:
    """bev: [H, W, 192] -> [H, W, 384]."""
    return to_hwc(backbone2d_nchw(to_nchw(bev), params, precision))
