"""The cross-attention of the TransFusion-L decoder: kernel
``query_attention`` and its plain version.

The object queries ``q`` [Nq, C] (through the query projection, its bias
included) attend to every cell of the BEV map: ``feats`` [HW, C] (the map
L, a row a cell) plus ``pos`` [HW, C] (the key position embedding Pk, a
constant table), through the key and value projections ``w_kv`` [2C, C]
(nn.Linear's [out, in]: the key rows, then the value rows) and ``b_kv``
[2C]; upstream's value carries the position embedding too.  Heads of C /
num_heads channels, scale 1/sqrt(D), softmax over all HW keys; [Nq, C] in
q's type, before the out-projection.

The CUDA kernel is ``csrc/query_attention.cu`` (C = 128, 8 heads, Nq <=
208: the published widths).  Tensors on the card launch it (bf16 q,
feats, pos and w_kv; another type or width raises); CPU tensors take
``query_attention_plain``.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

WIDTH, HEADS, MAX_QUERIES = 128, 8, 208
KEY_TILE = 64          # keys a tile of the kernel
_SMS = {}              # multiprocessor count by device index


def query_attention_plain(q: torch.Tensor, feats: torch.Tensor,
                          pos: torch.Tensor, w_kv: torch.Tensor,
                          b_kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The formula in f32, with the kernel's roundings to the inputs' type:
    x = feats + pos and the projected k | v rounded once each (the identity
    at f32)."""
    dt = feats.dtype
    Nq, C = q.shape
    HW = feats.shape[0]
    D = C // num_heads
    x = (feats.float() + pos.float()).to(dt).float()
    kv = (x @ w_kv.float().t() + b_kv.float()).to(dt).float()
    k = kv[:, :C].reshape(HW, num_heads, D)
    v = kv[:, C:].reshape(HW, num_heads, D)
    logits = torch.einsum("qhd,khd->hqk", q.float().reshape(Nq, num_heads, D),
                          k) * (1.0 / math.sqrt(D))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1), v)
    return out.reshape(Nq, C).to(q.dtype)


def _sms(device: torch.device) -> int:
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    if index not in _SMS:
        _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _SMS[index]


def query_attention_cuda(q: torch.Tensor, feats: torch.Tensor,
                         pos: torch.Tensor, w_kv: torch.Tensor,
                         b_kv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch kernel ``query_attention`` (``csrc/query_attention.cu``) on the
    current stream: one block a multiprocessor over the key tiles, then the
    combine of their partials."""
    Nq, C = q.shape
    HW = feats.shape[0]
    if C != WIDTH or num_heads != HEADS or not 1 <= Nq <= MAX_QUERIES \
            or tuple(feats.shape) != (HW, C) or tuple(pos.shape) != (HW, C) \
            or tuple(w_kv.shape) != (2 * C, C) or tuple(b_kv.shape) != (2 * C,) \
            or HW < 1:
        raise ValueError(
            f"query_attention: q [Nq <= {MAX_QUERIES}, {WIDTH}] in "
            f"{HEADS} heads, feats and pos [HW, {WIDTH}], w_kv [{2 * WIDTH}, "
            f"{WIDTH}], b_kv [{2 * WIDTH}]; got {tuple(q.shape)} in "
            f"{num_heads} heads, {tuple(feats.shape)}, {tuple(pos.shape)}, "
            f"{tuple(w_kv.shape)}, {tuple(b_kv.shape)}")
    if any(t.dtype != torch.bfloat16 for t in (q, feats, pos, w_kv)) \
            or b_kv.dtype != torch.float32:
        raise ValueError("query_attention: bf16 q, feats, pos and w_kv, f32 "
                         "b_kv")
    kernels.require_cuda("query_attention", q, feats, pos, w_kv, b_kv,
                         align=16)
    tiles = -(-HW // KEY_TILE)
    blocks = min(_sms(q.device), tiles)
    rows = -(-Nq // 16) * 16
    part = torch.empty(blocks * rows * (C + 2 * HEADS), dtype=torch.float32,
                       device=q.device)
    out = torch.empty((Nq, C), dtype=q.dtype, device=q.device)
    kernels.launch("query_attention", q.data_ptr(), feats.data_ptr(),
                   pos.data_ptr(), w_kv.data_ptr(), b_kv.data_ptr(),
                   part.data_ptr(), out.data_ptr(), Nq, HW, blocks)
    kernels.count("query_attention", lambda: flops(Nq, HW, C))
    return out


def flops(queries: int, keys: int, C: int) -> int:
    """Operations of the kernel: the key and value projections of every
    key, 2·C·2C each, and Q.K^T and P.V, 2·C each a (query, key)."""
    return 4 * keys * C * C + 4 * queries * keys * C


def query_attention(q: torch.Tensor, feats: torch.Tensor, pos: torch.Tensor,
                    w_kv: torch.Tensor, b_kv: torch.Tensor,
                    num_heads: int) -> torch.Tensor:
    """The kernel on card tensors, the plain version on CPU tensors."""
    if q.is_cuda:
        return query_attention_cuda(q, feats, pos, w_kv, b_kv, num_heads)
    return query_attention_plain(q, feats, pos, w_kv, b_kv, num_heads)
