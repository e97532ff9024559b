"""Order-insensitive box-set comparison for parity checking (a copy of the
JAX package's eval.py, on the NumPy box geometry of ``io/host_nms.py``;
the port imports nothing of that package).

The reference's box *sets* are stable but their order is not (atomicAdd
compaction, SURVEY §2.4-5), so parity between two runs/engines is measured
by greedy class-aware matching on BEV IoU, not row order.  Used by
chip_smoke.py for the bf16-vs-fp32 parity on the card and by ``cli eval``.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .io.host_nms import _clip_area, _corners


def _bev_iou(a: np.ndarray, b: np.ndarray) -> float:
    ca = _corners(a[None])[0]
    cb = _corners(b[None])[0]
    ov = _clip_area(ca, cb)
    sa = a[3] * a[4]
    sb = b[3] * b[4]
    return ov / max(sa + sb - ov, 1e-8)


def match_boxes(pred: np.ndarray, ref: np.ndarray,
                iou_threshold: float = 0.5,
                class_aware: bool = True) -> Dict:
    """Greedy best-IoU matching.  pred/ref: [N, 9] rows
    (x,y,z,dx,dy,dz,heading,class,score).  Returns match stats."""
    n_pred, n_ref = len(pred), len(ref)
    used = np.zeros(n_ref, bool)
    matches = []
    order = np.argsort(-pred[:, 8]) if n_pred else []
    for i in order:
        best_j, best_iou = -1, iou_threshold
        for j in range(n_ref):
            if used[j]:
                continue
            if class_aware and int(pred[i, 7]) != int(ref[j, 7]):
                continue
            iou = _bev_iou(pred[i], ref[j])
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_j >= 0:
            used[best_j] = True
            matches.append((i, best_j, best_iou))

    n_match = len(matches)
    score_err = (max(abs(pred[i, 8] - ref[j, 8]) for i, j, _ in matches)
                 if matches else 0.0)
    center_err = (max(float(np.linalg.norm(pred[i, :3] - ref[j, :3]))
                      for i, j, _ in matches) if matches else 0.0)
    return {
        "n_pred": n_pred,
        "n_ref": n_ref,
        "n_match": n_match,
        "precision": n_match / max(n_pred, 1),
        "recall": n_match / max(n_ref, 1),
        "mean_iou": float(np.mean([m[2] for m in matches])) if matches else 0.0,
        "max_score_err": float(score_err),
        "max_center_err": float(center_err),
    }


def coverage(queries: np.ndarray, pool: np.ndarray,
             iou_threshold: float = 0.5) -> Dict:
    """Existence check: fraction of `queries` with SOME same-class box in
    `pool` at IoU >= threshold.  Unlike match_boxes there is no exclusivity
    — two overlapping query boxes may be witnessed by one pool box — which
    is the correct semantics for "every confident box must exist on the
    other side" parity gates (greedy 1:1 matching under-counts on clustered
    near-duplicates).  Only same-class pool boxes whose BEV circumcircle
    meets the query's are clipped: the others overlap it nowhere, and an
    IoU of 0 never beats the threshold."""
    n = len(queries)
    hit = 0
    score_err = center_err = 0.0
    pool = np.asarray(pool)
    radii = 0.5 * np.hypot(pool[:, 3], pool[:, 4]) if len(pool) else None
    for q in queries:
        best_iou, best_j = iou_threshold, -1
        near = []
        if len(pool):
            near = np.nonzero(
                (pool[:, 7].astype(int) == int(q[7]))
                & (np.hypot(pool[:, 0] - q[0], pool[:, 1] - q[1])
                   <= radii + 0.5 * np.hypot(q[3], q[4]) + 1e-3))[0]
        for j in near:
            iou = _bev_iou(q, pool[j])
            if iou > best_iou:
                best_iou, best_j = iou, j
        if best_j >= 0:
            hit += 1
            # score drift only when both sides carry a score column —
            # GT boxes are [x,y,z,dx,dy,dz,heading,cls] (8 cols, data.py)
            if len(q) > 8 and pool.shape[1] > 8:
                score_err = max(score_err,
                                abs(float(q[8] - pool[best_j, 8])))
            center_err = max(center_err,
                             float(np.linalg.norm(q[:3] - pool[best_j, :3])))
    # vacuous truth for an empty query set: nothing confident to cover
    return {"n": n, "covered": hit, "coverage": hit / n if n else 1.0,
            "max_score_err": score_err, "max_center_err": center_err}


def parity_ok(pred: np.ndarray, ref: np.ndarray, iou_threshold: float = 0.5,
              min_recall: float = 0.95, min_precision: float = 0.95) -> bool:
    stats = match_boxes(pred, ref, iou_threshold)
    return (stats["recall"] >= min_recall
            and stats["precision"] >= min_precision)
