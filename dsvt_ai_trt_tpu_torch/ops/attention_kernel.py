"""Fused set multi-head attention: kernel B1 and its plain version.

Replaces the JAX package's Pallas kernel ``ops/attention_pallas.py:
set_attention_fused_flat`` (body ``_attn_kernel_pairs`` ->
``_attn_block_math``).  Input is the flat gathered packed table
``qkv_flat [S*K, 3C]`` (row = set*K + slot; q | k | v on the channel axis),
``key_mask [S, K]`` additive (a key is live iff its mask is >= 0) and
``set_count``.  Output ``[S*K, C]`` in the table's type:

  * scale 1/sqrt(D), softmax in f32 with its max taken per (head, set);
  * the unnormalised weights are rounded to bf16 for the V product, as the
    Pallas kernel does; the row sum and the 1/sum scale stay f32;
  * masked keys contribute exactly nothing (their V rows and their share of
    the row sum are dropped);
  * a set whose keys are all dead gives exact zeros, and so does every set
    with id >= ``set_count``.

The CUDA kernel is ``csrc/set_attention.cu``.  A tensor on the card
launches it; a tensor on the CPU takes ``set_attention_plain``.
"""

from __future__ import annotations

import torch

from .. import kernels


def _scale(head_dim: int) -> float:
    """1/sqrt(D) as the f32 value the Pallas kernel uses."""
    return float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(head_dim))))


def _count_tensor(set_count, S: int, device) -> torch.Tensor:
    if set_count is None:
        return torch.full((1,), S, dtype=torch.int32, device=device)
    return torch.as_tensor(set_count, device=device).to(torch.int32).reshape(1)


def set_attention_plain(qkv_flat: torch.Tensor, key_mask: torch.Tensor,
                        num_heads: int, set_count=None) -> torch.Tensor:
    """Masked per-set attention on [S, K, H, D] tensors with the kernel's
    roundings and zero rules: f32 logits and softmax, bf16 weights into the
    V product, f32 1/sum."""
    S, K = key_mask.shape
    C = qkv_flat.shape[1] // 3
    H = num_heads
    D = C // H
    qkv = qkv_flat.float().view(S, K, 3, H, D)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    live = key_mask >= 0                                        # [S, K]
    logits = torch.einsum("sqhd,skhd->shqk", q, k) * _scale(D)
    logits = logits.masked_fill(~live[:, None, None, :], float("-inf"))
    m = logits.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    e = torch.exp(logits - m)                                   # dead -> 0
    s = e.sum(dim=-1, keepdim=True)
    rinv = torch.where(s > 0, 1.0 / torch.where(s > 0, s, torch.ones_like(s)),
                       torch.zeros_like(s))                     # [S, H, K, 1]
    out = torch.einsum("shqk,skhd->sqhd", e.to(torch.bfloat16).float(), v)
    out = out * rinv.permute(0, 2, 1, 3)                        # [S, K, H, D]
    count = _count_tensor(set_count, S, qkv_flat.device)
    alive = torch.arange(S, device=qkv_flat.device) < count
    out = torch.where(alive[:, None, None, None], out, torch.zeros_like(out))
    return out.reshape(S * K, C).to(qkv_flat.dtype)


def set_attention_cuda(qkv_flat: torch.Tensor, key_mask: torch.Tensor,
                       num_heads: int, set_count=None) -> torch.Tensor:
    """Launch kernel B1 (``csrc/set_attention.cu``) on the current stream."""
    S, K = key_mask.shape
    if qkv_flat.dim() != 2 or qkv_flat.shape[0] != S * K:
        raise ValueError(f"set_attention: qkv_flat [S*K, 3C] with S*K = "
                         f"{S * K}, got {tuple(qkv_flat.shape)}")
    C3 = qkv_flat.shape[1]
    if qkv_flat.dtype != torch.bfloat16 or key_mask.dtype != torch.float32:
        raise ValueError("set_attention: bf16 qkv_flat and f32 key_mask, got "
                         f"{qkv_flat.dtype} and {key_mask.dtype}")
    C = C3 // 3
    if C3 % 3 or C % num_heads or (C // num_heads) % 8 or not 0 < K <= 64:
        raise ValueError(f"set_attention: needs a head width that is a "
                         f"multiple of 8 and K <= 64, got C={C3 / 3} with "
                         f"{num_heads} heads and K={K}")
    count = _count_tensor(set_count, S, qkv_flat.device)
    kernels.require_cuda("set_attention", qkv_flat, key_mask, count)
    kernels.require_cuda("set_attention", qkv_flat, align=16)
    out = torch.empty((S * K, C), dtype=qkv_flat.dtype, device=qkv_flat.device)
    if S == 0:
        return out
    kernels.launch("set_attention", qkv_flat.data_ptr(),
                   key_mask.data_ptr(), count.data_ptr(), out.data_ptr(),
                   S, K, C, num_heads)
    kernels.count("set_attention",
                  lambda: flops(min(int(count), S), K, C))
    return out


def flops(live_sets: int, K: int, C: int) -> int:
    """FLOPs of kernel B1 on ``live_sets`` sets of K slots: Q·Kᵀ and P·V,
    2·K·K·D each per head, so 4·K²·C a set (H·D = C).  The softmax's
    elementwise work is left out, as ``torch.utils.flop_counter`` counts
    none, so the plain version counted by it on the same live sets gives
    the same number."""
    return 4 * live_sets * K * K * C


def set_attention_fused_flat(qkv_flat: torch.Tensor, key_mask: torch.Tensor,
                             num_heads: int, set_count=None) -> torch.Tensor:
    """Kernel B1 on a CUDA tensor, the plain version on a CPU tensor."""
    if qkv_flat.is_cuda:
        return set_attention_cuda(qkv_flat, key_mask, num_heads, set_count)
    return set_attention_plain(qkv_flat, key_mask, num_heads, set_count)
