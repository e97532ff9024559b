"""The attention pooling between two stages: kernel ``stage_pool`` and its
plain version.

For each live parent p and head h, one query (``q`` [N1, C], the parent's
max through the query projection, its bias included) against the keys and
values of the parent's V slots (``child`` [N1, V], N0 where a slot is
empty): slot v holding child row c reads the key ``kv[c, :C] + kbias[v]``
and the value ``kv[c, C:] + vbias`` (``kv`` [N0, 2C], the children rows
through the key and value projections without bias; ``kbias`` [V, C] the
slot's ``pos_embedding`` through the key projection plus its bias).  An
empty slot is upstream's zero placeholder row through the same
projections (upstream masks no slot): key ``kbias[v]``, value ``vbias``.
Scale 1/sqrt(D), f32 softmax over the slots, the weighted values summed in
f32 and scaled by 1/sum; [N1, C] in q's type, zeros for parents >=
``count``.

The CUDA kernel is ``csrc/stage_pool.cu``.  Tensors on the card launch it
(which takes bf16 q and kv and raises on another type); CPU tensors take
``stage_pool_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from .attention_kernel import _count_tensor

MAX_V = 8


def stage_pool_plain(q: torch.Tensor, kv: torch.Tensor, child: torch.Tensor,
                     kbias: torch.Tensor, vbias: torch.Tensor, count,
                     num_heads: int) -> torch.Tensor:
    """The formula, in f32 on every operand, with the kernel's order: the
    logits scaled after the dot, the weighted sum scaled by 1/sum."""
    N1, V = child.shape
    N0, C2 = kv.shape
    C = C2 // 2
    H = num_heads
    D = C // H
    table = torch.cat([kv.float(), kv.new_zeros((1, C2), dtype=torch.float32)])
    rows = table[child.clamp(max=N0)]                            # [N1, V, 2C]
    k = (rows[..., :C] + kbias.float()).view(N1, V, H, D)
    v = (rows[..., C:] + vbias.float()).view(N1, V, H, D)
    scale = float(np.float32(1.0) / np.sqrt(np.float32(D)))   # the kernel's
    logits = torch.einsum("phd,pvhd->phv", q.float().view(N1, H, D),
                          k) * scale
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.einsum("phv,pvhd->phd", e, v) * (1.0 / e.sum(dim=-1,
                                                             keepdim=True))
    alive = torch.arange(N1, device=q.device) < _count_tensor(count, N1,
                                                              q.device)
    out = torch.where(alive[:, None, None], out, torch.zeros_like(out))
    return out.reshape(N1, C).to(q.dtype)


def stage_pool_cuda(q: torch.Tensor, kv: torch.Tensor, child: torch.Tensor,
                    kbias: torch.Tensor, vbias: torch.Tensor, count,
                    num_heads: int) -> torch.Tensor:
    """Launch kernel ``stage_pool`` (``csrc/stage_pool.cu``) on the current
    stream."""
    N1, V = child.shape
    N0, C2 = kv.shape
    C = q.shape[1]
    if q.shape[0] != N1 or C2 != 2 * C or kbias.shape != (V, C) \
            or vbias.shape != (C,):
        raise ValueError(f"stage_pool: q [N1, C], kv [N0, 2C], child [N1, V],"
                         f" kbias [V, C], vbias [C]; got {tuple(q.shape)}, "
                         f"{tuple(kv.shape)}, {tuple(child.shape)}, "
                         f"{tuple(kbias.shape)}, {tuple(vbias.shape)}")
    if q.dtype != torch.bfloat16 or kv.dtype != torch.bfloat16 \
            or child.dtype != torch.int64 or kbias.dtype != torch.float32 \
            or vbias.dtype != torch.float32:
        raise ValueError("stage_pool: bf16 q and kv, int64 child, f32 biases")
    D = C // num_heads if num_heads else 0
    if C % num_heads or D % 8 or D > 64 or not 1 <= V <= MAX_V or N0 < 1:
        raise ValueError(f"stage_pool: a head width that is a multiple of 8 "
                         f"up to 64 and 1 <= V <= {MAX_V}; got C={C} with "
                         f"{num_heads} heads and V={V}")
    n = _count_tensor(count, N1, q.device)
    kernels.require_cuda("stage_pool", q, kv, child, kbias, vbias, n,
                         align=16)
    out = torch.empty((N1, C), dtype=q.dtype, device=q.device)
    if N1 == 0:
        return out
    kernels.launch("stage_pool", q.data_ptr(), kv.data_ptr(),
                   child.data_ptr(), kbias.data_ptr(), vbias.data_ptr(),
                   n.data_ptr(), out.data_ptr(), N1, N0, V, C, num_heads)
    kernels.count("stage_pool", lambda: flops(min(int(n), N1), V, C))
    return out


def flops(live_parents: int, V: int, C: int) -> int:
    """Operations of the kernel on ``live_parents`` parents of V slots: the
    query against V keys and the V weighted values, 2·V·C each."""
    return 4 * live_parents * V * C


def stage_pool(q: torch.Tensor, kv: torch.Tensor, child: torch.Tensor,
               kbias: torch.Tensor, vbias: torch.Tensor, count,
               num_heads: int) -> torch.Tensor:
    """The kernel on card tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return stage_pool_cuda(q, kv, child, kbias, vbias, count, num_heads)
    return stage_pool_plain(q, kv, child, kbias, vbias, count, num_heads)
