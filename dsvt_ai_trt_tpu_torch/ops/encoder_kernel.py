"""Fused DSVT encoder epilogue: kernel B2 and its plain version.

Replaces the JAX package's Pallas kernel ``ops/encoder_pallas.py:
encoder_epilogue`` (body ``_epilogue_kernel``).  After set attention is
gathered back to pillar rows, each encoder pass computes

    attn = a @ wo + bo                      (out-projection)
    x1   = LN(x + attn)                     (norm1)
    x2   = LN(x1 + gelu(x1@w1 + b1)@w2+b2)  (FFN + norm2)
    out  = LN(x2 + x)                       (per-encoder norm)

with bf16 matmul inputs, f32 accumulation, f32 LN/GELU math (LN eps 1e-5,
population variance) and an f32 result: x [P, C] f32, a [P, C] bf16.

The CUDA kernel is ``csrc/encoder_epilogue.cu``.  A tensor on the card
launches it; a tensor on the CPU takes ``encoder_epilogue_plain``.  The
kernel reads its weights in the forms ``kernel_weights`` makes, once, when
``weights.from_jax_params`` carries a model to the device.
"""

from __future__ import annotations

import torch

from .. import kernels
from .attention import gelu_tanh, layer_norm


def _mm_bf16(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 inputs, f32 accumulation, f32 result (the Pallas ``jnp.dot(...,
    preferred_element_type=f32)``): the bf16 values multiply exactly in
    f32, so an f32 product of the rounded operands is that dot."""
    return torch.matmul(a.to(torch.bfloat16).float(),
                        w.to(torch.bfloat16).float())


def encoder_epilogue_plain(x: torch.Tensor, attn_raw: torch.Tensor, enc: dict,
                           eps: float = 1e-5) -> torch.Tensor:
    """The unfused epilogue, written out with the kernel's types."""
    x = x.float()
    attn = _mm_bf16(attn_raw, enc["wo"]) + enc["bo"]
    x1 = layer_norm(x + attn, enc["ln1_g"], enc["ln1_b"], eps)
    h = gelu_tanh(_mm_bf16(x1, enc["ffn_w1"]) + enc["ffn_b1"])
    f = _mm_bf16(h, enc["ffn_w2"]) + enc["ffn_b2"]
    x2 = layer_norm(x1 + f, enc["ln2_g"], enc["ln2_b"], eps)
    return layer_norm(x2 + x, enc["norm_g"], enc["norm_b"], eps)


def kernel_weights(enc: dict) -> dict:
    """The kernel's weight operands of one encoder pass: wo, w1 and w2 in
    bf16 and the six LayerNorm vectors stacked [6, C] in f32 (ln1, ln2,
    norm; gamma then beta)."""
    bf = torch.bfloat16
    return {"wo_bf16": enc["wo"].to(bf).contiguous(),
            "ffn_w1_bf16": enc["ffn_w1"].to(bf).contiguous(),
            "ffn_w2_bf16": enc["ffn_w2"].to(bf).contiguous(),
            "ln_stack": torch.stack([enc["ln1_g"], enc["ln1_b"], enc["ln2_g"],
                                     enc["ln2_b"], enc["norm_g"],
                                     enc["norm_b"]]).float().contiguous()}


def encoder_epilogue_cuda(x: torch.Tensor, attn_raw: torch.Tensor, enc: dict,
                          eps: float = 1e-5) -> torch.Tensor:
    """Launch kernel B2 (``csrc/encoder_epilogue.cu``) on the current
    stream.  ``enc`` holds the ``kernel_weights`` operands."""
    P, C = x.shape
    wo, w1, w2 = enc["wo_bf16"], enc["ffn_w1_bf16"], enc["ffn_w2_bf16"]
    bo, b1, b2, ln = enc["bo"], enc["ffn_b1"], enc["ffn_b2"], enc["ln_stack"]
    F = w1.shape[1]
    if attn_raw.shape != (P, C) or wo.shape != (C, C) or w2.shape != (F, C) \
            or ln.shape != (6, C):
        raise ValueError(f"encoder_epilogue: x and a [P, C], wo [C, C], "
                         f"w1 [C, F], w2 [F, C], ln [6, C]; got "
                         f"{tuple(x.shape)}, {tuple(attn_raw.shape)}, "
                         f"{tuple(wo.shape)}, {tuple(ln.shape)}")
    if C % 16 or F % 16:
        raise ValueError(f"encoder_epilogue: C and F must be multiples of 16, "
                         f"got {C} and {F}")
    if x.dtype != torch.float32 or attn_raw.dtype != torch.bfloat16:
        raise ValueError(f"encoder_epilogue: f32 x and bf16 a, got {x.dtype} "
                         f"and {attn_raw.dtype}")
    if wo.dtype != torch.bfloat16 or ln.dtype != torch.float32 or \
            bo.dtype != torch.float32:
        raise ValueError("encoder_epilogue: bf16 weights and f32 biases and "
                         "LN vectors (kernel_weights)")
    kernels.require_cuda("encoder_epilogue", x, attn_raw, wo, w1, w2, bo, b1,
                         b2, ln)
    out = torch.empty_like(x)
    if P == 0:
        return out
    kernels.launch("encoder_epilogue", x.data_ptr(), attn_raw.data_ptr(),
                   wo.data_ptr(), bo.data_ptr(), w1.data_ptr(),
                   b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                   ln.data_ptr(), out.data_ptr(), P, C, F, float(eps))
    kernels.count("encoder_epilogue")
    return out


def encoder_epilogue(x: torch.Tensor, attn_raw: torch.Tensor, enc: dict,
                     eps: float = 1e-5) -> torch.Tensor:
    """Kernel B2 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.is_cuda:
        return encoder_epilogue_cuda(x, attn_raw, enc, eps)
    return encoder_epilogue_plain(x, attn_raw, enc, eps)
