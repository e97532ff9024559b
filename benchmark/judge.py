"""The numbers that decide ``correct``: each is a gap between what the
timed path produced and what the reference computes, never above its
limit (a workload file's ``limits``).

Served frames (every frame the window finished, against the reference's
``Detection`` of its sweep):

* ``occupancy``: frames whose ``Detections.occupancy`` (kept points,
  pillars, live sets per window spec) differs from the reference's; the
  integer stages are exact, limit 0.
* ``score_gap``: whether each box of either side is accounted for on the
  other: the least of |d score| to a box of the same class whose centre
  lies within ``MATCH_M``, of how far it outscores a box that overlaps it
  (NMS at IoU 0.01 drops a box that touches a higher one, and whether two
  boxes touch moves with their sizes' and headings' last bits, so the
  boxes are grown by ``GROW`` for this test), of its margin over the
  score threshold (its partner fell below it) and of its margin over the
  reference's candidate cut (the top-k's last score: its partner was not a
  candidate); the largest over all boxes.  A box within ``EDGE_M`` of the
  range's edge is left out: its partner's centre lands on either side of
  the edge with the rounding of the regressed z (up to 0.1 m at bf16).  It
  holds the kept set: a box missing or extra beyond what the scores, the
  candidate cut and NMS's order explain.
* ``cell_gap``: each box of the program against the reference's decoded
  boxes of the same class (its top-k cells, before the score filter) whose
  centres lie within ``MATCH_M``: for each, the largest of |d score|, the
  centres' distance in m, |d z| in m, |d log size|, and |d heading| times
  the length of the reference's (cos, sin) vector (clipped at 1: a short
  vector's angle is rounding); the box reads the least of these, the cell
  that explains it best (two cells' regressed centres can fall within a
  centimetre of each other, so the nearest centre is not always its own
  cell); ``NO_CELL`` where the reference has no such box.  It holds each
  kept box's values through the regression branches and the decode,
  whatever NMS kept.

Training (the first three steps of the timed step against the
reference's three):

* ``loss_gap``: the largest |d loss| / |loss| over the steps.
* ``grad_gap``: over leaves, | |g| - |g_ref| | / max(|g_ref|, median leaf
  |g_ref|), of step 1's gradient (the program's from AdamW's first moment
  after step 1).
* ``change_gap``: the same of each leaf's change over the three steps,
  leaving out leaves whose reference gradient is under a thousandth of the
  median leaf's (their update is Adam's response to rounding).
* ``grad_median_gap``, ``change_median_gap``: the median over the same
  leaves of the same per-leaf gaps.  The worst leaf swings from seed to
  seed with rounding that a few leaves amplify (the position embedding's
  second linear and the q/k projections of an encoder's second pass, whose
  gradients are sums that largely cancel); the median leaf is steady, and
  it is what a lower precision moves.

Training, the step after the window (through the window's own call, on
the pool's next batch, from the parameters and AdamW state the window
left; the reference takes that state up and makes the same step):

* ``late_loss_gap``: |d loss| / |loss| of that step.  It holds the window's
  steps to their batches and their graph to its inputs after the pool has
  cycled.
* ``late_change_median_gap``: each leaf's change over that step as
  ``change_median_gap`` (leaves left out by the reference's gradient of
  that step).  It holds AdamW at the window's update counts.  The worst
  leaf is not held: after a window its tail on sound runs comes within 3.4x
  of TF32's, leaving no room for a limit.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from .reference.nms import corners, overlap

MATCH_M = 1.0
NO_CELL = 1.0
GROW = (1.05, 0.2)      # sizes x 1.05 + 0.2 m for the overlap test
EDGE_M = 0.25
NOUGHT = 1e-3


def _score_gaps(a: np.ndarray, b: np.ndarray, cut: float, cfg):
    """Each box of ``a`` (boxes within ``EDGE_M`` of the range's edge left
    out): its gap to what accounts for it in ``b``."""
    ga, gb = _grown(a), _grown(b)
    ca, cb = corners(ga), corners(gb)
    reach = 0.5 * (np.hypot(ga[:, 3], ga[:, 4])[:, None]
                   + np.hypot(gb[:, 3], gb[:, 4])[None, :])
    dist = np.hypot(a[:, None, 0] - b[None, :, 0], a[:, None, 1] - b[None, :, 1])
    lo, hi = np.array(cfg.pc_range_min), np.array(cfg.pc_range_max)
    out = []
    for i, box in enumerate(a):
        if min(np.min(box[:3] - lo), np.min(hi - box[:3])) < EDGE_M:
            continue
        gaps = [float(box[8]) - cfg.score_threshold, abs(float(box[8]) - cut)]
        same = (b[:, 7] == box[7]) & (dist[i] < MATCH_M)
        if same.any():
            gaps.append(float(np.min(np.abs(b[same, 8] - box[8]))))
        for j in np.nonzero(dist[i] <= reach[i])[0]:
            if overlap(ca[i], cb[j]) > 0:
                gaps.append(max(0.0, float(box[8] - b[j, 8])))
        out.append(min(gaps))
    return out


def _grown(boxes: np.ndarray) -> np.ndarray:
    out = boxes.copy()
    out[:, 3:5] = out[:, 3:5] * GROW[0] + GROW[1]
    return out


def score_gap(prog: np.ndarray, ref: np.ndarray, cut: float, cfg) -> float:
    return max([0.0] + _score_gaps(prog, ref, cut, cfg)
               + _score_gaps(ref, prog, cut, cfg))


def _wrap(a):
    return np.abs((a + np.pi) % (2 * np.pi) - np.pi)


def cell_gap(prog: np.ndarray, top_k: np.ndarray) -> float:
    """``top_k``: every box the reference decoded before its score filter
    (the global top-k cells, in score order; column 9 the length of the
    heading's vector)."""
    worst = 0.0
    for box in prog:
        dist = np.hypot(top_k[:, 0] - box[0], top_k[:, 1] - box[1])
        cand = top_k[(top_k[:, 7] == box[7]) & (dist < MATCH_M)]
        if not len(cand):
            return NO_CELL
        gaps = np.stack([
            np.abs(cand[:, 8] - box[8]),
            np.hypot(cand[:, 0] - box[0], cand[:, 1] - box[1]),
            np.abs(cand[:, 2] - box[2]),
            np.max(np.abs(np.log(cand[:, 3:6]) - np.log(box[3:6])), axis=1),
            _wrap(cand[:, 6] - box[6]) * np.minimum(cand[:, 9], 1.0)], 1)
        worst = max(worst, float(gaps.max(axis=1).min()))
    return worst


def frame_numbers(prog_boxes, prog_count, prog_occ, ref, cfg
                  ) -> Dict[str, float]:
    """One frame's numbers; ``ref``: the reference's ``Detection``."""
    prog = np.asarray(prog_boxes[:prog_count], np.float64)
    ref_boxes = np.asarray(ref.boxes, np.float64)
    return {"occupancy": float(np.any(np.asarray(prog_occ) != ref.occupancy)),
            "score_gap": score_gap(prog, ref_boxes, float(ref.top_k[-1, 8]),
                                   cfg),
            "cell_gap": cell_gap(prog, ref.top_k)}


def combine(frames: List[Dict[str, float]]) -> Dict[str, float]:
    """Frames' numbers into the run's: frames off in occupancy are
    counted, every gap is the largest."""
    return {k: (sum(f[k] for f in frames) if k == "occupancy"
                else max(f[k] for f in frames)) for k in frames[0]}


def serving_numbers(outputs: Sequence, refs, cfg) -> List[Dict[str, float]]:
    """Each frame's numbers.  ``outputs``: (sweep index, boxes, count,
    occupancy) of every frame the window finished; ``refs``: the
    reference's ``Detection`` by sweep.  Identical outputs of one sweep are
    judged once."""
    seen: Dict[tuple, Dict[str, float]] = {}
    per_frame: List[Dict[str, float]] = []
    for i, boxes, count, occ in outputs:
        key = (i, int(count), np.asarray(occ).tobytes(),
               np.asarray(boxes[:int(count)]).tobytes())
        if key not in seen:
            seen[key] = frame_numbers(boxes, count, occ, refs[i], cfg)
        per_frame.append(seen[key])
    return per_frame


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> np.ndarray:
    floor = float(np.median(list(ref.values())))
    return np.array([abs(prog[p] - r) / max(r, floor, 1e-30)
                     for p, r in ref.items() if keep is None or p in keep])


def training_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"loss": [3], "grad": {leaf: |g|}, "change":
    {leaf: |dp|}} (reference/train.py:first_steps)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["loss"], ref["loss"]))
    grads = ref["grad"]
    floor = float(np.median(list(grads.values())))
    moved = {p for p, g in grads.items() if g >= NOUGHT * floor}
    grad = _leaf_gaps(prog["grad"], grads)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss_gap": loss,
            "grad_gap": float(grad.max()), "change_gap": float(change.max()),
            "grad_median_gap": float(np.median(grad)),
            "change_median_gap": float(np.median(change))}


def late_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: one step's {"loss": [1], "change": {leaf: |dp|}}
    and, on the reference's side, "grad"."""
    a, b = prog["loss"][0], ref["loss"][0]
    grads = ref["grad"]
    floor = float(np.median(list(grads.values())))
    moved = {p for p, g in grads.items() if g >= NOUGHT * floor}
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"late_loss_gap": abs(a - b) / max(abs(b), 1e-30),
            "late_change_median_gap": float(np.median(change))}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]) over the limited numbers."""
    rows = [(k, float(numbers[k]), float(limits[k])) for k in limits]
    return all(v <= lim for _, v, lim in rows), rows
