"""Shared numeric helpers: the three precision modes and the device check.

Precision modes (cfg.precision), as in the JAX package's ops/common.py:
  * "fp32"  — strict parity: full float32 products.  On the card that means
    TF32 off for both cuBLAS and cuDNN (``set_fp32_flags``), the analogue of
    ``Precision.HIGHEST``.
  * "mixed" — float32 activations and weights, bf16 matmul inputs with f32
    accumulation.
  * "bf16"  — bf16 activations through the matmuls and convs, f32
    normalizations.
"""

from __future__ import annotations

import torch

PRECISIONS = ("fp32", "mixed", "bf16")


def set_fp32_flags() -> None:
    """Keep float32 products in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def compute_dtype(precision: str) -> torch.dtype:
    """Activation type of the convs and of the VFE/backbone matmuls."""
    assert precision in PRECISIONS, precision
    return torch.bfloat16 if precision == "bf16" else torch.float32


def matmul_dtype(precision: str) -> torch.dtype:
    """Input type of the attention/FFN matmuls (bf16 on both fast modes)."""
    assert precision in PRECISIONS, precision
    return torch.float32 if precision == "fp32" else torch.bfloat16


def dense(x: torch.Tensor, w: torch.Tensor, b, dtype: torch.dtype) -> torch.Tensor:
    """``x @ w (+ b)`` with inputs cast to ``dtype``; the result is float32
    (bf16 products accumulate in f32 and round once on the way out)."""
    y = torch.matmul(x.to(dtype), w.to(dtype)).float()
    return y if b is None else y + b


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  CUDA is asked for explicitly and
    is never replaced by the CPU: without a card this raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        set_fp32_flags()
    return device
