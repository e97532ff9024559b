"""Rounding of the operands of every product, by precision.

The reference computes at float32 with TF32 off.  The control computes the
same model one precision below what a cell states (``correct``'s control):
``fp8`` rounds each operand of a matmul, einsum or convolution to
float8 e4m3 with a per-tensor scale (its largest magnitude maps to 448),
and accumulates in float32; ``tf32`` leaves the operands as they are and
lets cuBLAS and cuDNN use TF32.  Normalisations, softmax and the
elementwise work stay float32 everywhere.
"""

from __future__ import annotations

import contextlib

import torch

E4M3_MAX = 448.0


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale, back in float32."""
    t = t.float()
    amax = t.detach().abs().max()
    scale = torch.where(amax > 0, amax / E4M3_MAX, torch.ones_like(amax))
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def exact(t: torch.Tensor) -> torch.Tensor:
    return t.float()


ROUNDING = {"fp32": exact, "tf32": exact, "fp8": fp8}


def rounding(precision: str):
    if precision not in ROUNDING:
        raise ValueError(f"reference precision {precision!r}: one of "
                         f"{sorted(ROUNDING)}")
    return ROUNDING[precision]


@contextlib.contextmanager
def matmul_flags(precision: str):
    """TF32 on for ``tf32``, off otherwise, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
