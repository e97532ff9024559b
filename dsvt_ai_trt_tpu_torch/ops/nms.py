"""On-device rotated-BEV NMS, port of the JAX package's ops/nms.py.

The pairwise overlap is kernel B4 on the card (ops/nms_kernel.py) and the
validity-masked clip (``pairwise_overlap_clip``) elsewhere.  The greedy
suppression runs as peeling rounds over the strict upper triangle: each
round promotes every undecided box with no undecided higher-scored
suppressor and removes what the promoted boxes suppress.  The round count is
the suppression-chain depth (a few at IoU 0.01).  On the card the rounds run
inside kernel nms_peel (ops/nms_peel.py), stopping test included, as the
JAX package's ``lax.while_loop`` runs on its device, whatever
``use_kernels`` says; so NMS reads nothing back to the host.  On the CPU
they run as the plain loop.

Box convention as the reference: the half-extent along local x is dim1/2
and along local y dim0/2, rotated by +heading.
"""

from __future__ import annotations

import torch

from .nms_kernel import (box_corners, pairwise_overlap,  # noqa: F401
                         pairwise_overlap_clip)
from .nms_peel import nms_peel

THRESHOLD = 1e-8   # helper.h:26, the union clamp


def nms(boxes: torch.Tensor, count, iou_threshold: float, *,
        use_kernels: bool):
    """Greedy rotated NMS on score-sorted boxes [K, 9] with ``count`` valid
    rows.  Returns (boxes [K, 9] compacted keep-first, keep_count).
    ``use_kernels`` takes the overlap from kernel B4's wrapper, else from
    the plain clip on any device; the rounds take nms_peel's wrapper.
    ``count`` may be an int or a tensor on the boxes' device."""
    K = boxes.shape[0]
    idx = torch.arange(K, device=boxes.device)
    count = torch.as_tensor(count, device=boxes.device)
    valid = idx < count
    overlap = (pairwise_overlap(boxes) if use_kernels
               else pairwise_overlap_clip(boxes))
    sa = boxes[:, 3] * boxes[:, 4]
    union = torch.clamp(sa[:, None] + sa[None, :] - overlap, min=THRESHOLD)
    iou = overlap / union
    sup = (iou >= iou_threshold) & (idx[:, None] < idx[None, :]) & valid[:, None]

    kept, kept_count = nms_peel(sup, count)
    order = torch.sort(torch.where(kept, 0, 1), stable=True).indices
    out = torch.where(kept[order][:, None], boxes[order],
                      torch.zeros_like(boxes))
    return out, kept_count
