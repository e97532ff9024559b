"""The epilogue of a lateral of the BEV ResNet: kernel ``bev_epilogue`` and
its plain version.

A lateral's transposed conv runs without bias (model/backbone2d.py); its
output ``y`` [1, C, H, W] and its bias [C] then give ``relu(y + bias)``,
written into ``out`` [1, C, H, W], a channel slice of the concatenated
map.  The sum rounds once to y's type, as PyTorch's bias add after the
conv rounds it; the ReLU after the rounding gives the same bits.  All of
it bf16 and channels_last on the card: y dense, ``out`` a slice of a
dense map.

The CUDA kernel is ``csrc/bev_epilogue.cu``.  Tensors on the card launch it
(bf16 only; another type raises); CPU tensors take ``bev_epilogue_plain``.
"""

from __future__ import annotations

import torch

from .. import kernels
from .common import relu
from .layout import is_laid_out


def bev_epilogue_plain(y: torch.Tensor, bias: torch.Tensor,
                       out: torch.Tensor) -> torch.Tensor:
    """``out`` = relu(y + bias), the bias broadcast over the channels."""
    return out.copy_(relu(y + bias.view(1, -1, 1, 1)))


def bev_epilogue_cuda(y: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor) -> torch.Tensor:
    """Launch kernel ``bev_epilogue`` (``csrc/bev_epilogue.cu``) on the
    current stream."""
    n, c, h, w = y.shape
    if (n != 1 or out.shape != y.shape or bias.shape != (c,)
            or c % 8 or out.stride(1) != 1 or out.stride(2) != w * out.stride(3)
            or out.stride(3) % 8 or not is_laid_out(y, torch.channels_last)):
        raise ValueError(f"bev_epilogue: y [1, C, H, W] channels_last, C a "
                         f"multiple of 8, bias [C], out a channel slice of a "
                         f"channels_last map; got y {tuple(y.shape)} "
                         f"{y.stride()}, bias {tuple(bias.shape)}, out "
                         f"{tuple(out.shape)} {out.stride()}")
    if not y.dtype == bias.dtype == out.dtype == torch.bfloat16:
        raise ValueError("bev_epilogue: bf16 y, bias and out")
    kernels.require_cuda("bev_epilogue", bias, align=16)
    if (y.device != bias.device or out.device != bias.device
            or y.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("bev_epilogue: y and out on the bias's device, "
                         "each starting on a 16-byte boundary")
    kernels.launch("bev_epilogue", y.data_ptr(), bias.data_ptr(),
                   out.data_ptr(), h * w, c, out.stride(3))
    kernels.count("bev_epilogue")
    return out


def bev_epilogue(y: torch.Tensor, bias: torch.Tensor,
                 out: torch.Tensor) -> torch.Tensor:
    """The kernel on card tensors, the plain version on CPU tensors."""
    if y.is_cuda:
        return bev_epilogue_cuda(y, bias, out)
    return bev_epilogue_plain(y, bias, out)
