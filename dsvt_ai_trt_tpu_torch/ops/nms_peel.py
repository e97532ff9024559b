"""NMS's peeling loop: kernel nms_peel and its plain version.

Port of the ``lax.while_loop`` in the JAX package's ``ops/nms.py:nms``
(:283-301), which XLA runs on the device; no Pallas kernel computes it.
Given the suppression mask ``sup [K, K]`` (``sup[i, j]``: the higher-scored
box i suppresses box j; rows past ``count`` are all False) and the valid
count, each round promotes every undecided box that no undecided box
suppresses and drops every box a promoted box suppresses, until no box is
undecided.  The earliest undecided box always promotes, so there are at
most K rounds; at IoU 0.01 there are a few.

The plain version is that loop in PyTorch: its stopping test reads one flag
back to the host each round, so it runs on the CPU only.  The CUDA kernel
is ``csrc/nms_peel.cu``: it bit-packs the mask and runs every round inside
one block, with the stopping test on the device, so a frame's NMS needs no
host read and can be captured in a CUDA graph.  Both give the same kept set
and count bit for bit.  A tensor on the card launches the kernel (K <=
1024); a tensor on the CPU takes the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_K = 1024   # csrc/nms_peel.cu: one thread a box, one block


def _count_tensor(count, device) -> torch.Tensor:
    return torch.as_tensor(count, device=device).to(torch.int64).reshape(1)


def nms_peel_plain(sup: torch.Tensor, count):
    """The peeling rounds with a host-read stopping test: (kept [K] bool,
    kept count [] int64)."""
    K = sup.shape[0]
    valid = torch.arange(K, device=sup.device) < _count_tensor(count,
                                                                 sup.device)
    kept = torch.zeros_like(valid)
    undecided = valid.clone()
    while bool(undecided.any()):
        blocked = (sup & undecided[:, None]).any(dim=0)
        promote = undecided & ~blocked
        suppressed = (sup & promote[:, None]).any(dim=0)
        kept = kept | promote
        undecided = undecided & ~promote & ~suppressed
    return kept, kept.long().sum()


def nms_peel_cuda(sup: torch.Tensor, count):
    """Launch kernel nms_peel (``csrc/nms_peel.cu``, a packing pass and the
    one-block loop) on the current stream.  ``count`` should already be a
    tensor on the card: an int is copied there first."""
    if sup.dim() != 2 or sup.shape[0] != sup.shape[1] or \
            sup.dtype != torch.bool:
        raise ValueError(f"nms_peel: a bool [K, K] mask, got "
                         f"{tuple(sup.shape)} {sup.dtype}")
    K = sup.shape[0]
    if K > MAX_K:
        raise ValueError(f"nms_peel: the kernel takes K <= {MAX_K} boxes "
                         f"(one thread a box in one block), got {K}")
    count = _count_tensor(count, sup.device)
    kernels.require_cuda("nms_peel", sup, count)
    kept = torch.empty(K, dtype=torch.bool, device=sup.device)
    kept_count = torch.empty((), dtype=torch.int64, device=sup.device)
    if K == 0:
        return kept, kept_count.zero_()
    scratch = torch.empty(K * ((K + 31) // 32), dtype=torch.int32,
                          device=sup.device)
    kernels.launch("nms_peel", sup.data_ptr(), K, count.data_ptr(),
                   scratch.data_ptr(), kept.data_ptr(), kept_count.data_ptr())
    kernels.count("nms_peel")
    return kept, kept_count


def nms_peel(sup: torch.Tensor, count):
    """Kernel nms_peel on a CUDA tensor, the plain loop on a CPU tensor."""
    if sup.is_cuda:
        return nms_peel_cuda(sup, count)
    return nms_peel_plain(sup, count)
