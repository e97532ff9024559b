"""The numbers that decide ``correct`` in the TransFusion-L cell: each
served frame (every frame of the warm pass and of the window) against the
plain reference's frame of its sweep (``reference/transfusion.py``).

* ``occupancy``: frames whose occupancy (kept points, pillars, live sets
  per window spec) differs from the reference's; exact, limit 0.
* ``proposal_gap``: each (class, cell) proposal that one side makes and
  the other does not, read in the reference's own scores s (before the
  local max) and masked scores: the least change of them that would flip
  the reference's decision on it.  A proposal the reference makes and the
  program does not reads the least of its masked score's margin over the
  reference's first score left out (its 201st) and of its margin over its
  highest neighbour in the local max's window (for the classes the local
  max suppresses); one the program makes and the reference does not reads
  how far s there lies below the reference's 200th masked score or below
  that neighbour, whichever is further (a cell on the border of a
  suppressed class: ``NO_CELL``).  The largest over the frame; 0 when
  the sets are equal.  A proposal near the cut, or a local maximum
  within rounding of its neighbour, reads its small margin; a proposal
  no rounding explains reads a large one.
* ``query_gap``: the reference's decoder and branches run on the
  program's own proposals, over the reference's fp32 L and scores s
  (``reference.transfusion.decode_proposals``), so every query has its
  partner.  The scores are s before the local max: each of the program's
  proposals is a local maximum of its own map, where the masked score is
  s, and a proposal whose local maximum the rounding moved keeps its
  score on the reference's side too.  Each query reads the largest of |d
  score|, the centres' distance in m, |d z| in m, |d log size|, |d
  heading| times the length of the reference's (sin, cos) vector
  (clipped at 1, as ``judge.py``'s ``cell_gap``) and the length of the
  velocities' difference in m/s.  The
  score and range filter must agree, except for a box whose centre lies
  within ``EDGE_M`` of ``post_center_range``'s edge on either side (its
  partner's centre lands on either side with the rounding of the
  regression); a disagreement elsewhere reads ``NO_CELL``.  The largest
  over the frame's queries.
* ``query_median_gap``: the same gap of the frame's median query.  The
  worst query of a frame swings from seed to seed with the few queries
  whose values the rounding moves most; the median query is steady, and
  it is what a lower precision moves (as the training cell's median
  leaf, ``judge.py``).

Every gap of a run is the largest over its frames.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from .judge import EDGE_M, NO_CELL, _wrap
from .reference import transfusion


def _neighbour_max(scores: np.ndarray, c: int, i: int, H: int, W: int,
                   k: int) -> float:
    """The highest s of the other cells in the k x k window around cell i
    of class c; inf on the border (no window there)."""
    r, col = divmod(i, W)
    pad = k // 2
    if not (pad <= r < H - pad and pad <= col < W - pad):
        return float("inf")
    win = scores[c].reshape(H, W)[r - pad:r + pad + 1,
                                  col - pad:col + pad + 1].copy()
    win[pad, pad] = -np.inf
    return float(win.max())


def proposal_gap(classes: np.ndarray, cells: np.ndarray, ref, cfg) -> float:
    """``classes``, ``cells``: the program's proposals; ``ref``: the
    reference's ``Frame``."""
    prog = set(zip(classes.tolist(), cells.tolist()))
    mine = set(zip(ref.classes.tolist(), ref.cells.tolist()))
    if prog == mine:
        return 0.0
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    k = cfg.query_nms_kernel
    s = ref.scores.cpu().numpy()
    masked = ref.masked.cpu().numpy()
    ranked = np.sort(masked.reshape(-1))[::-1]
    last, first_out = float(ranked[len(mine) - 1]), float(ranked[len(mine)])
    free = set(cfg.query_free_classes)
    gaps = []
    for c, i in mine - prog:
        margin = float(masked[c, i]) - first_out
        if c not in free:
            margin = min(margin, float(s[c, i]) - _neighbour_max(s, c, i, H,
                                                                 W, k))
        gaps.append(max(margin, 0.0))
    for c, i in prog - mine:
        need = last - float(s[c, i])
        if c not in free:
            nb = _neighbour_max(s, c, i, H, W, k)
            if nb == float("inf"):
                gaps.append(NO_CELL)
                continue
            need = max(need, nb - float(s[c, i]))
        gaps.append(max(need, 0.0))
    return max(gaps)


def _near_edge(xyz: np.ndarray, cfg) -> np.ndarray:
    lo = np.array(cfg.post_center_range[:3])
    hi = np.array(cfg.post_center_range[3:])
    return np.minimum(np.abs(xyz - lo), np.abs(xyz - hi)).min(1) < EDGE_M


def query_gaps(prog: np.ndarray, count: int, ref_boxes: np.ndarray,
               ref_keep: np.ndarray, ref_rot: np.ndarray, cfg) -> np.ndarray:
    """Each query's gap.  ``prog``: the program's boxes [Nq, 13] (the first
    ``count`` kept); ``ref_*``: the reference's decode of the same
    proposals, row for row."""
    a, b = prog.astype(np.float64), ref_boxes.astype(np.float64)
    gaps = np.stack([
        np.abs(a[:, 8] - b[:, 8]),
        np.hypot(a[:, 0] - b[:, 0], a[:, 1] - b[:, 1]),
        np.abs(a[:, 2] - b[:, 2]),
        np.max(np.abs(np.log(a[:, 3:6]) - np.log(b[:, 3:6])), axis=1),
        _wrap(a[:, 6] - b[:, 6]) * np.minimum(ref_rot, 1.0),
        np.hypot(a[:, 9] - b[:, 9], a[:, 10] - b[:, 10])], 1).max(1)
    kept = np.arange(len(a)) < count
    odd = (kept != ref_keep) & ~_near_edge(a[:, :3], cfg) \
        & ~_near_edge(b[:, :3], cfg)
    return np.where(odd, np.maximum(gaps, NO_CELL), gaps)


def frame_numbers(boxes, count, occ, ref, head, cfg) -> Dict[str, float]:
    """One served frame's numbers; ``ref``: the reference's ``Frame`` of its
    sweep; ``head``: the reference's folded head."""
    boxes = np.asarray(boxes, np.float64)
    classes = np.rint(boxes[:, 12]).astype(np.int64)
    cells = np.rint(boxes[:, 11]).astype(np.int64)
    dev = ref.lmap.device
    ref_boxes, keep, rot = transfusion.decode_proposals(
        head, ref.lmap, ref.scores, torch.from_numpy(classes).to(dev),
        torch.from_numpy(cells).to(dev), cfg)
    gaps = query_gaps(boxes, int(count), ref_boxes.double().cpu().numpy(),
                      keep.cpu().numpy(), rot.double().cpu().numpy(), cfg)
    return {"occupancy": float(np.any(np.asarray(occ) != ref.occupancy)),
            "proposal_gap": proposal_gap(classes, cells, ref, cfg),
            "query_gap": float(gaps.max()),
            "query_median_gap": float(np.median(gaps))}


def sweep_numbers(outputs: Sequence, ref, head, cfg
                  ) -> List[Dict[str, float]]:
    """The numbers of every served frame of one sweep (``outputs``:
    (sweep, boxes, count, occupancy)); identical outputs are judged once."""
    seen: Dict[tuple, Dict[str, float]] = {}
    out = []
    for _i, boxes, count, occ in outputs:
        key = (int(count), np.asarray(occ).tobytes(),
               np.asarray(boxes).tobytes())
        if key not in seen:
            seen[key] = frame_numbers(boxes, count, occ, ref, head, cfg)
        out.append(seen[key])
    return out
