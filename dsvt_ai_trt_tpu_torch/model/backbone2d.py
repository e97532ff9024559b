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

Each conv's epilogue (bias, residual add, ReLU) runs in the pass that
writes the conv's output where ``fuses_epilogue`` holds: a bf16 map on the
card, the folded weights (so no gradient records), no spatial sharding.
There a conv and its ReLU are one cuDNN call (``conv_relu``:
``torch.cudnn_convolution_relu``), a unit's second conv, its shortcut and
the ReLU another (``torch.cudnn_convolution_add_relu``; the ``down`` conv
runs without bias, its bias folded into conv2's, ``SHORTCUT_B``), f32 from
the accumulator to the one rounding to bf16; and each deblock runs without
bias, kernel ``bev_epilogue`` (ops/bev_epilogue.py) writing its bias and
ReLU into the lateral's channel slice of the concatenated map, which is
allocated once.  ``fused_convs`` counts the fused cuDNN calls (the tracer's
``bev_fused_convs``, model/detector.py).  Everywhere else (fp32, mixed,
training, sharding, the CPU) the bias rides on the conv and the ReLU, the
residual add and the concatenation are PyTorch ops of their own.

Inside ``parallel.spatial.spatial_sharding`` the map holds this rank's
rows only (``spatial.bev_range``): every conv runs on them with halo rows
from its neighbours (``spatial.conv2d_rows``), every deblock locally
(``spatial.conv_transpose_rows``), and the three laterals, each at this
rank's rows of the full map, concatenate per rank.
"""

from __future__ import annotations

import threading

import torch
import torch.nn.functional as F

from ..config import (BACKBONE2D_STAGES, BACKBONE2D_DEBLOCK,
                      BACKBONE2D_OUT_CHANNELS)
from ..ops.bev_epilogue import bev_epilogue
from ..ops.common import compute_dtype, matmul_dtype, relu
from ..ops.layout import conv_format, laid_out, to_hwc, to_nchw
from ..parallel import spatial

BF16 = "_bf16"      # key suffix of a conv weight's folded bf16 copy
# a unit's folded bias of its fused second conv: conv2's plus the down conv's
SHORTCUT_B = "conv2_down_b" + BF16

_STATE = threading.local()


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
    for branch in head.values():   # the TransFusion head's convs: "hm"
        if isinstance(branch, dict) and "w0" in branch:
            yield branch, "w0", "b0"
            yield branch, "w1", "b1"


def shortcut_units(params: dict):
    """The residual units of a whole model's BEV ResNet whose shortcut is a
    conv (``down``)."""
    for stage in params["backbone2d"]["stages"]:
        for unit in stage:
            if "down_w" in unit:
                yield unit


def fold(w: torch.Tensor, b: torch.Tensor):
    """A conv's bf16 weight (channels_last) and bias."""
    return (w.detach().to(torch.bfloat16, memory_format=torch.channels_last),
            b.detach().to(torch.bfloat16))


def fold_shortcut_bias(unit: dict) -> torch.Tensor:
    """``SHORTCUT_B``: conv2's bias plus the down conv's, summed in f32 and
    rounded once to bf16."""
    return (unit["conv2_b"].detach().float()
            + unit["down_b"].detach().float()).to(torch.bfloat16)


def reads_folded(node: dict, w_key: str) -> bool:
    """Whether a bf16 conv reads the copies ``fold`` made: they exist, and
    no gradient has to reach the leaves."""
    return w_key + BF16 in node and not (torch.is_grad_enabled()
                                         and node[w_key].requires_grad)


def _on_card(x: torch.Tensor) -> bool:
    return x.is_cuda


def fuses_epilogue(x: torch.Tensor, node: dict, w_key: str,
                   precision: str) -> bool:
    """Whether the conv ``w_key`` of ``node`` on x finishes its epilogue in
    the pass that writes its output (module docstring)."""
    return (compute_dtype(precision) == torch.bfloat16 and _on_card(x)
            and not spatial.active() and reads_folded(node, w_key)
            and not (torch.is_grad_enabled() and x.requires_grad))


def fused_convs() -> int:
    """The convs run with their epilogue fused into cuDNN's on this thread
    so far."""
    return getattr(_STATE, "fused", 0)


def conv_weights(node: dict, w_key: str, b_key: str, precision: str):
    """A conv's weight and bias in the dtype and layout of its input: on
    the bf16 convs the copies ``fold`` made, unless a gradient has to reach
    the leaves (or none were folded); else the leaves, cast."""
    w, b = node[w_key], node[b_key]
    mdt = matmul_dtype(precision)
    if mdt == torch.bfloat16 and reads_folded(node, w_key):
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


def _fused(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
           z: torch.Tensor = None) -> torch.Tensor:
    """relu(conv(x, w) + b (+ z)), symmetric k//2 padding, as one cuDNN
    call on NHWC bf16 maps; counted."""
    _STATE.fused = fused_convs() + 1
    x, p = laid_out(x, torch.channels_last), w.shape[-1] // 2
    if z is None:
        y = torch.cudnn_convolution_relu(x, w, b, (stride, stride), (p, p),
                                         (1, 1), 1)
    else:
        y = torch.cudnn_convolution_add_relu(x, w, z, 1.0, b,
                                             (stride, stride), (p, p),
                                             (1, 1), 1)
    return laid_out(y, torch.channels_last)


def conv_relu(x: torch.Tensor, node: dict, w_key: str, b_key: str,
              stride: int = 1, precision: str = "fp32") -> torch.Tensor:
    """relu(conv(...)): one fused cuDNN call where ``fuses_epilogue``,
    else ``conv`` and the ReLU."""
    if fuses_epilogue(x, node, w_key, precision):
        return _fused(x, node[w_key + BF16], node[b_key + BF16], stride)
    return relu(conv(x, node, w_key, b_key, stride, precision))


def _res_unit(x, unit, stride, precision):
    h = conv_relu(x, unit, "conv1_w", "conv1_b", stride, precision)
    if fuses_epilogue(h, unit, "conv2_w", precision):
        z, b = laid_out(x, torch.channels_last), unit["conv2_b" + BF16]
        if "down_w" in unit:
            z = F.conv2d(z, unit["down_w" + BF16], None, stride=stride)
            b = unit[SHORTCUT_B]
        return _fused(h, unit["conv2_w" + BF16], b, 1, z)
    h = conv(h, unit, "conv2_w", "conv2_b", 1, precision)
    if "down_w" in unit:
        shortcut = conv(x, unit, "down_w", "down_b", stride, precision)
    else:
        shortcut = x
    return relu(h + shortcut)


def _upsample(x, deblock, k, precision, out=None):
    """ConvTranspose2d with kernel == stride, its bias and the ReLU; w is
    [in, out, k, k].  Given ``out``, a channel slice of the concatenated
    map, the conv runs without bias and ``bev_epilogue`` writes the rest
    into it."""
    w, b = conv_weights(deblock, "w", "b", precision)
    fmt = conv_format(w.dtype)
    x = laid_out(x, fmt).to(w.dtype)
    if out is not None:
        return bev_epilogue(F.conv_transpose2d(x, w, None, stride=k), b, out)
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
    out = None
    if fuses_epilogue(x, params["deblocks"][0], "w", precision):
        out = torch.empty((1, BACKBONE2D_OUT_CHANNELS, *x.shape[2:]),
                          dtype=x.dtype, device=x.device,
                          memory_format=torch.channels_last)
    laterals, c0 = [], 0
    for s, (units, _ch, stride) in enumerate(BACKBONE2D_STAGES):
        stage = params["stages"][s]
        for u in range(units):
            x = _res_unit(x, stage[u], stride if u == 0 else 1, precision)
        k, _s = BACKBONE2D_DEBLOCK[s]
        deblock = params["deblocks"][s]
        c = deblock["w"].shape[1]
        laterals.append(_upsample(x, deblock, k, precision, None if out is None
                                  else out[:, c0:c0 + c]))
        c0 += c
    return out if out is not None else torch.cat(laterals, dim=1)


def backbone2d_forward(bev: torch.Tensor, params: dict,
                       precision: str = "fp32") -> torch.Tensor:
    """bev: [H, W, 192] -> [H, W, 384]."""
    return to_hwc(backbone2d_nchw(to_nchw(bev), params, precision))
