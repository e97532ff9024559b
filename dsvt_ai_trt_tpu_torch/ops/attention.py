"""Batched set multi-head attention for DSVT, port of the JAX ops/attention.py.

  * q = k = pillar_feat + pos_embed, v = pillar_feat, gathered by the set's
    pillar indices; the projections run on the [P, C] pillar rows before
    the gather (``set_attention_qkv`` takes the packed [P, 3C] table).
  * q is scaled by 1/sqrt(head_dim) before q k^T.
  * the additive key mask is broadcast over query positions and heads.

The fused fast path (bf16/mixed, ``use_kernels=True``) gathers the packed
table into the flat [S*K, 3C] layout and hands it to kernel B1
(ops/attention_kernel.py).  Unlike the TPU path it keeps K = 36: the 36 ->
40 storage pad existed for TPU sublane alignment only.
"""

from __future__ import annotations

import torch

from . import attention_kernel
from .common import matmul_dtype
from .gather import take_rows


def gather_rows(table: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """``table[inds]`` with out-of-range indices (the dump index P) clamped
    to the last row, the JAX ``mode="clip"`` gather: every slot that reads
    the clamped row is masked by the caller."""
    return table[inds.clamp(max=table.shape[0] - 1)]


def set_attention_qkv(qkv_p: torch.Tensor, inds: torch.Tensor,
                      key_mask: torch.Tensor, num_heads: int,
                      precision: str = "fp32", use_kernels: bool = False,
                      flat_out: bool = False,
                      set_count: torch.Tensor = None) -> torch.Tensor:
    """Masked set attention over pre-projected, packed pillar Q/K/V.

    qkv_p: [P, 3C] = (q | k | v); inds: [S, K] (P = dump, reads zeros);
    key_mask: [S, K] additive.  Returns the pre-out-projection attention
    output [S, K, C], or [S*K, C] (row = flat canonical slot) with
    ``flat_out``.
    """
    S, K = inds.shape
    C = qkv_p.shape[-1] // 3
    H = num_heads
    D = C // H
    gt = matmul_dtype(precision)

    if use_kernels and gt is torch.bfloat16:
        qkv_flat = gather_rows(qkv_p.to(gt), inds.reshape(-1))
        out = attention_kernel.set_attention_fused_flat(
            qkv_flat, key_mask, H, set_count=set_count)
        return out if flat_out else out.view(S, K, C)

    # zero dump row: the JAX gather's out-of-bounds fill
    table = torch.cat([qkv_p.to(gt), qkv_p.new_zeros((1, 3 * C), dtype=gt)])
    qkv = take_rows(table, inds)                               # [S, K, 3C]
    q = qkv[..., :C].reshape(S, K, H, D)
    k = qkv[..., C:2 * C].reshape(S, K, H, D)
    v = qkv[..., 2 * C:].reshape(S, K, H, D)

    # 1/sqrt(D) rounded to the gather type, as the JAX path scales q; a
    # CPU 0-dim tensor is a scalar operand on the card, copied nowhere
    scale = (torch.full((), 1.0, dtype=gt)
             / torch.sqrt(torch.full((), float(D), dtype=gt)))
    logits = torch.einsum("sqhd,skhd->shqk", (q * scale).float(), k.float())
    logits = logits + key_mask[:, None, None, :]
    attn = torch.softmax(logits, dim=-1)
    out = torch.einsum("shqk,skhd->sqhd", attn.to(gt).float(), v.float())
    out = out.reshape(S * K, C) if flat_out else out.reshape(S, K, C)
    return out.to(gt)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Channel layer norm (population variance), the JAX formula."""
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approx GELU with the reference's constants:
    0.5*x*(1 + tanh(x*(B + C*x^2)))."""
    a, b, c = 0.5, 0.7978845608028654, 0.035677408136300125
    return (a + a * torch.tanh(x * (c * x * x + b))) * x


def ffn(x: torch.Tensor, enc: dict, precision: str = "fp32") -> torch.Tensor:
    """linear1 -> GELU -> linear2; the fast paths keep the hidden
    activations in bf16."""
    dt = matmul_dtype(precision)
    h = torch.matmul(x.to(dt), enc["ffn_w1"].to(dt)).float() + enc["ffn_b1"]
    h = gelu_tanh(h).to(dt)
    return torch.matmul(h, enc["ffn_w2"].to(dt)).float() + enc["ffn_b2"]

