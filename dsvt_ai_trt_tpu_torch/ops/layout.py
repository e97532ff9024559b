"""The memory layout of the BEV stack (model/backbone2d.py, model/head.py).

The public functions hold a BEV map as [H, W, C]; the convs take
[1, C, H, W].  ``to_nchw`` views a contiguous [H, W, C] map as [1, C, H, W]
with the strides of PyTorch's ``channels_last`` format, the size-1 batch
dimension's included (H*W*C).  A conv decides its memory format from all
four strides: the view ``permute(2, 0, 1).unsqueeze(0)`` gives the batch
dimension a stride of C, passes ``is_contiguous(memory_format=
torch.channels_last)`` (which skips size-1 dimensions) and yet runs NCHW,
so cuDNN converts NCHW -> NHWC -> NCHW around every bf16 conv.

The layout follows the conv's input dtype (``conv_format``): bf16 convs run
``channels_last`` (NHWC), which cuDNN's bf16 kernels read as it is; fp32
convs run NCHW-contiguous, cuDNN's fp32 kernels with TF32 off (on an H100
its NHWC fp32 kernels made the fp32 training step 4.2% slower).
``laid_out`` gives a tensor in its stack's layout with exactly the strides
``torch.empty(..., memory_format=fmt)`` gives: as it is, as a view where
only the batch dimension's stride differs (no data moves), else as a copy,
a restride, which it counts on this thread (``restrides``: the tracer's
``bev_restrides`` counter, model/detector.py).
"""

from __future__ import annotations

import threading

import torch

_STATE = threading.local()


def to_nchw(x_hwc: torch.Tensor) -> torch.Tensor:
    """[H, W, C] -> [1, C, H, W] view; channels_last strides (batch stride
    H*W*C) when the map is contiguous."""
    return x_hwc.unsqueeze(0).permute(0, 3, 1, 2)


def to_hwc(x_nchw: torch.Tensor) -> torch.Tensor:
    """[1, C, H, W] -> [H, W, C] view (contiguous when the input is
    channels_last)."""
    return x_nchw[0].permute(1, 2, 0)


def conv_format(dtype: torch.dtype) -> torch.memory_format:
    """The layout of a conv whose input is ``dtype``: channels_last for
    bf16, NCHW-contiguous otherwise."""
    return (torch.channels_last if dtype == torch.bfloat16
            else torch.contiguous_format)


def strides(shape, fmt: torch.memory_format) -> tuple:
    """The strides of a dense [N, C, H, W] tensor in ``fmt``."""
    _n, c, h, w = shape
    if fmt == torch.channels_last:
        return (h * w * c, 1, w * c, c)
    return (c * h * w, h * w, w, 1)


def is_laid_out(x: torch.Tensor, fmt: torch.memory_format) -> bool:
    """Whether a conv or an elementwise op takes x as ``fmt`` as it is."""
    return x.stride() == strides(x.shape, fmt)


def laid_out(x: torch.Tensor, fmt: torch.memory_format) -> torch.Tensor:
    """x [N, C, H, W] in ``fmt`` (module docstring): a view where the
    memory already is (a [1, C, H, W] whose batch stride differs), else a
    copy, counted.  Views and copies carry autograd."""
    if is_laid_out(x, fmt):
        return x
    if x.shape[0] == 1:
        x = (to_nchw(to_hwc(x)) if fmt == torch.channels_last
             else x[0].unsqueeze(0))
        if is_laid_out(x, fmt):
            return x
    _STATE.restrides = restrides() + 1
    return x.clone(memory_format=fmt)


def restrides() -> int:
    """The copies ``laid_out`` has made on this thread so far."""
    return getattr(_STATE, "restrides", 0)
