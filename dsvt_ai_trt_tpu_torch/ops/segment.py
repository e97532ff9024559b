"""Segmented max over a cell-sorted point stream: kernel B3 and its plain
version.

Replaces the JAX package's Pallas kernel ``ops/segment_pallas.py:
segmented_max`` (body ``_seg_kernel``).  Contract: ``feats [N, C]`` is a
stream whose segments (runs starting at each ``is_start`` row; row 0 always
starts one) are contiguous and at most ``cap`` rows long, ``1 <= cap <=
64`` (the Pallas kernel's own limit); each row gets its whole segment's
channelwise max.  With ``starts_only=True`` only segment-start rows are
defined.  Rows of an over-cap segment (the voxelizer's invalid-sentinel
tail) are undefined and masked by every caller; the kernel neither reads
nor writes them.  The output has the input's type (bf16 or f32); max is
exact, so kernel and plain version agree bit for bit on the defined rows.

The CUDA kernel is ``csrc/segment_max.cu``: a block owns the segments that
start in its 32-row tile and reads their rows once, in 16-byte vectors.
It reads a bool (or uint8) ``is_start`` tensor's bytes as they are, with no
copy.  A tensor on the card launches it; a tensor on the CPU takes
``segmented_max_plain``.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_CAP = 64
TILE = 32      # csrc/segment_max.cu's TILE (rows whose segments one block
#                owns), for the tests' tile-edge streams; change both


def segmented_max_plain(feats: torch.Tensor, is_start: torch.Tensor,
                        cap: int, starts_only: bool = False) -> torch.Tensor:
    """Loop-free reference: ``scatter_reduce("amax")`` on the segment ids
    that ``is_start`` defines, broadcast back to every row (so it also
    meets the ``starts_only`` contract)."""
    del cap, starts_only   # every row gets its full segment max here
    N, C = feats.shape
    seg = torch.cumsum(is_start.long(), 0) - 1
    seg = seg.clamp(min=0)          # rows before the first start (none in
    #                                 a voxelizer stream) join segment 0
    f = feats.float()
    table = torch.full((N, C), float("-inf"), device=feats.device)
    table = table.scatter_reduce(0, seg[:, None].expand(-1, C), f,
                                 reduce="amax", include_self=True)
    return table[seg].to(feats.dtype)


def segmented_max_cuda(feats: torch.Tensor, is_start: torch.Tensor,
                       cap: int, starts_only: bool = False) -> torch.Tensor:
    """Launch kernel B3 (``csrc/segment_max.cu``) on the current stream."""
    if feats.dim() != 2 or is_start.shape != (feats.shape[0],):
        raise ValueError(f"segmented_max: feats [N, C] and is_start [N], got "
                         f"{tuple(feats.shape)} and {tuple(is_start.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"segmented_max: f32 or bf16 input, got {feats.dtype}")
    if is_start.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"segmented_max: bool or uint8 is_start, got "
                         f"{is_start.dtype}")
    if not 1 <= cap <= MAX_CAP:
        raise ValueError(f"segmented_max: cap must be in [1, {MAX_CAP}], "
                         f"got {cap}")
    kernels.require_cuda("segmented_max", feats, is_start)
    N, C = feats.shape
    out = torch.empty_like(feats)
    if N == 0 or C == 0:
        return out
    kernels.launch("segment_max", feats.data_ptr(), is_start.data_ptr(),
                   out.data_ptr(), N, C,
                   int(feats.dtype == torch.bfloat16), int(starts_only), cap)
    kernels.count("segment_max", lambda: flops(defined_rows(is_start, cap), C))
    return out


def defined_rows(is_start: torch.Tensor, cap: int) -> int:
    """Rows of the stream whose segment is at most ``cap`` rows long: the
    rows the contract defines (and the kernel reads)."""
    seg = (torch.cumsum(is_start.long(), 0) - 1).clamp(min=0)
    lengths = torch.bincount(seg)
    return int(lengths[lengths <= cap].sum())


def flops(rows: int, C: int) -> int:
    """Operations of kernel B3 on ``rows`` defined rows of C channels: one
    compare per element."""
    return rows * C


def head_positions(is_head: torch.Tensor, length: int) -> torch.Tensor:
    """Positions of the set flags of ``is_head`` [N] in order, then N as the
    sentinel, cut or padded to ``length``: int64 on the flags' device.

    Compacts segment heads into segment order for the voxelizer's pillars,
    the partition's windows and the pooling's parents.  The size is
    ``length`` whatever the flags hold, and nothing is read on the host, so
    a CUDA graph captures it."""
    n = is_head.numel()
    pos = torch.arange(n, device=is_head.device)
    heads = torch.sort(torch.where(is_head, pos,
                                   torch.full_like(pos, n))).values
    if n < length:
        heads = torch.cat([heads, heads.new_full((length - n,), n)])
    return heads[:length]


def segmented_max(feats: torch.Tensor, is_start: torch.Tensor, cap: int,
                  starts_only: bool = False) -> torch.Tensor:
    """Kernel B3 on a CUDA tensor, the plain version on a CPU tensor."""
    if feats.is_cuda:
        return segmented_max_cuda(feats, is_start, cap, starts_only)
    return segmented_max_plain(feats, is_start, cap, starts_only)
