"""On-device rotated-BEV NMS, port of the JAX package's ops/nms.py.

The pairwise overlap is kernel B4 on the card (ops/nms_kernel.py) and the
validity-masked clip (``pairwise_overlap_clip``) elsewhere.  The rest, the
IoU against the threshold, the greedy suppression as peeling rounds over
the strict upper triangle and the keep-first compaction, is kernel
nms_peel (ops/nms_peel.py) on the card, whatever ``use_kernels`` says, as
the JAX package's ``lax.while_loop`` runs on its device; so NMS reads
nothing back to the host and runs no PyTorch op between the two kernels.
On the CPU it runs as nms_peel's plain version.  Each round promotes every
undecided box with no undecided higher-scored suppressor and removes what
the promoted boxes suppress; the round count is the suppression-chain
depth (a few at IoU 0.01).

Box convention as the reference: the half-extent along local x is dim1/2
and along local y dim0/2, rotated by +heading.
"""

from __future__ import annotations

import torch

from .nms_kernel import (box_corners, pairwise_overlap,  # noqa: F401
                         pairwise_overlap_clip)
from .nms_peel import nms_peel


def nms(boxes: torch.Tensor, count, iou_threshold: float, *,
        use_kernels: bool):
    """Greedy rotated NMS on score-sorted boxes [K, 9] with ``count`` valid
    rows.  Returns (boxes [K, 9] compacted keep-first, keep_count).
    ``use_kernels`` takes the overlap from kernel B4's wrapper, else from
    the plain clip on any device; the rest takes nms_peel's wrapper.
    ``count`` may be an int or a tensor on the boxes' device."""
    overlap = (pairwise_overlap(boxes) if use_kernels
               else pairwise_overlap_clip(boxes))
    return nms_peel(overlap, boxes, count, iou_threshold)
