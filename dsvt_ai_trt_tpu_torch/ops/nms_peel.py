"""NMS after the pairwise overlap: kernel nms_peel and its plain version.

Port of the JAX package's ``ops/nms.py:nms`` after the overlap (:270-301):
the IoU of each score-sorted pair, the suppression mask
``sup[i, j]`` (the higher-scored box i, below ``count``, suppresses box j at
IoU >= the threshold), the peeling rounds of the ``lax.while_loop`` (which
XLA runs on the device) and the stable argsort and gathers that put the
kept boxes first.  Each round promotes every undecided box that no
undecided box suppresses and drops every box a promoted box suppresses,
until no box is undecided.  The earliest undecided box always promotes, so
there are at most K rounds; at IoU 0.01 there are a few.

The plain version is that code in PyTorch: its stopping test reads one flag
back to the host each round, so it runs on the CPU only.  The CUDA kernel
is ``csrc/nms_peel.cu``: one launch computes the suppression bits from the
overlap, runs every round with the stopping test on the device and
compacts the kept boxes, so a frame's NMS needs no host read and can be
captured in a CUDA graph.  Both give the same boxes and count bit for bit.
A tensor on the card launches the kernel (K <= 1024); a tensor on the CPU
takes the plain version.
"""

from __future__ import annotations

import torch

from .. import kernels

MAX_K = 1024       # csrc/nms_peel.cu: one thread a box in one block
THRESHOLD = 1e-8   # helper.h:26, the union clamp


def _count_tensor(count, device) -> torch.Tensor:
    return torch.as_tensor(count, device=device).to(torch.int64).reshape(1)


def _valid(boxes: torch.Tensor, count) -> torch.Tensor:
    return torch.arange(boxes.shape[0], device=boxes.device) < _count_tensor(
        count, boxes.device)


def suppression_plain(overlap: torch.Tensor, boxes: torch.Tensor, count,
                      iou_threshold: float) -> torch.Tensor:
    """The suppression mask [K, K] bool: box i suppresses box j."""
    idx = torch.arange(boxes.shape[0], device=boxes.device)
    sa = boxes[:, 3] * boxes[:, 4]
    union = torch.clamp(sa[:, None] + sa[None, :] - overlap, min=THRESHOLD)
    iou = overlap / union
    return (iou >= iou_threshold) & (idx[:, None] < idx[None, :]) & \
        _valid(boxes, count)[:, None]


def nms_peel_plain(overlap: torch.Tensor, boxes: torch.Tensor, count,
                   iou_threshold: float):
    """The mask, the rounds with a host-read stopping test, and the stable
    compaction: (boxes [K, 9] kept first, kept count [] int64)."""
    sup = suppression_plain(overlap, boxes, count, iou_threshold)
    undecided = _valid(boxes, count)
    kept = torch.zeros_like(undecided)
    while bool(undecided.any()):
        blocked = (sup & undecided[:, None]).any(dim=0)
        promote = undecided & ~blocked
        suppressed = (sup & promote[:, None]).any(dim=0)
        kept = kept | promote
        undecided = undecided & ~promote & ~suppressed
    order = torch.sort(torch.where(kept, 0, 1), stable=True).indices
    out = torch.where(kept[order][:, None], boxes[order],
                      torch.zeros_like(boxes))
    return out, kept.long().sum()


def nms_peel_cuda(overlap: torch.Tensor, boxes: torch.Tensor, count,
                  iou_threshold: float):
    """Launch kernel nms_peel (``csrc/nms_peel.cu``, one cluster launch) on
    the current stream.  ``count`` should already be a tensor on the card:
    an int is copied there first."""
    K = boxes.shape[0]
    if boxes.dim() != 2 or boxes.shape[1] != 9 or \
            boxes.dtype != torch.float32:
        raise ValueError(f"nms_peel: f32 boxes [K, 9], got "
                         f"{tuple(boxes.shape)} {boxes.dtype}")
    if overlap.shape != (K, K) or overlap.dtype != torch.float32:
        raise ValueError(f"nms_peel: an f32 overlap [K, K] = [{K}, {K}], "
                         f"got {tuple(overlap.shape)} {overlap.dtype}")
    if K > MAX_K:
        raise ValueError(f"nms_peel: the kernel takes K <= {MAX_K} boxes "
                         f"(one thread a box in one block), got {K}")
    count = _count_tensor(count, boxes.device)
    kernels.require_cuda("nms_peel", overlap, boxes, count)
    out = torch.empty_like(boxes)
    kept_count = torch.empty((), dtype=torch.int64, device=boxes.device)
    if K == 0:
        return out, kept_count.zero_()
    kernels.launch("nms_peel", overlap.data_ptr(), boxes.data_ptr(), K,
                   count.data_ptr(), float(iou_threshold), out.data_ptr(),
                   kept_count.data_ptr())
    kernels.count("nms_peel")
    return out, kept_count


def nms_peel(overlap: torch.Tensor, boxes: torch.Tensor, count,
             iou_threshold: float):
    """Kernel nms_peel on a CUDA tensor, the plain version on a CPU
    tensor."""
    if boxes.is_cuda:
        return nms_peel_cuda(overlap, boxes, count, iou_threshold)
    return nms_peel_plain(overlap, boxes, count, iou_threshold)
