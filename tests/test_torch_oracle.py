"""The port at full width against the independent torch oracle.

The oracle (tools/torch_oracle.py) re-implements the reference engine's
graph on stock torch modules with its own .wts parser, voxelizer and
partitions; it imports neither JAX nor either package.  It anchors the
port's fp32 path at ``DEFAULT_CONFIG`` (with ``parity_atan``, the
reference's heading decode) where JAX cannot run: on the card's machine.

* Weights: the port's ``calibrated_raw`` (seed 0, 40 boxes) on the first
  frame, written with the port's ``save_wts``; the oracle reads them with
  ``DSVTOracle.load_wts`` and the port with its own ``load_wts``.
* Frames: seeded ``bench.entry_frame`` clouds of 4 000 points in +-20 m
  (seeds 1 and 3), on which neither the pillar nor the kept-point cap binds
  (asserted on both sides), so a cap cannot explain a miss.  The dense
  20 000-point frames fill the 10 000-pillar cap and are not used.
* Gates: tests/test_oracle_parity.py's, copied here (that file imports JAX
  at module level): before NMS every box 5e-3 above the score threshold
  matched by class and centre within 0.5 m, score within 1e-3, centre 2e-2,
  dims 2 %, heading 0.05 (``assert_box_parity``); after NMS the kept sets
  agree up to the score-threshold band and suppression-margin churn
  (``assert_kept_sets``, with tests/oracles.py's ``nms_oracle`` on the
  oracle's boxes).

Slow on the CPU.  On the card's machine, which has no JAX:

    python -m pytest tests/test_torch_oracle.py --noconftest -m slow

runs the port on the card (kernels B3 and B4 launched, counted) and the
oracle on the host.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from dsvt_ai_trt_tpu_torch import kernels, weights
from dsvt_ai_trt_tpu_torch.bench import entry_frame
from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
from dsvt_ai_trt_tpu_torch.model.detector import forward

pytestmark = pytest.mark.slow

# name -> (points, seed, half extent in m)
FRAMES = {"sparse_seed1": (4000, 1, 20.0), "sparse_seed3": (4000, 3, 20.0)}


def oracle_boxes(oracle_mod, model, pts, n):
    """The oracle's boxes before NMS on the frame's live points."""
    return oracle_mod.run_oracle(model, pts[: int(n)], parity_atan=True)


def port_boxes(params, cfg, pts, n, device, with_nms):
    """The port's boxes, and its occupancy [points, pillars, sets...]."""
    dets = forward(params, pts, n, cfg, with_nms=with_nms, device=device)
    count = int(dets.count)
    return (dets.boxes[:count].cpu().numpy(),
            dets.occupancy.cpu().numpy())


def setup(oracle_mod, cfg, frames, tmp_dir, device, n_boxes=40):
    """Calibrated weights on the first frame through .wts into both
    implementations; returns (port params, oracle model)."""
    pts0, n0 = next(iter(frames.values()))
    raw = weights.calibrated_raw(cfg, pts0, n0, seed=0, n_boxes=n_boxes,
                                 device=device)
    wts = os.path.join(tmp_dir, "dsvt.wts")
    weights.save_wts(raw, wts)
    model = oracle_mod.DSVTOracle()
    model.load_wts(wts)
    params = weights.from_jax_params(
        weights.prepare_params(weights.load_wts(wts), cfg), device)
    return params, model


def assert_caps_free(oracle_mod, cfg, pts, n, occupancy, frame):
    """Neither implementation's pillar or kept-point cap binds."""
    feats, _pp, coords, _counts = oracle_mod.voxelize(pts[: int(n)])
    assert len(coords) < oracle_mod.MAX_PILLARS, frame
    assert len(feats) < oracle_mod.MAX_KEPT_POINTS, frame
    assert occupancy[0] < cfg.max_kept_points, frame
    assert occupancy[1] < cfg.max_pillars, frame
    assert occupancy[0] == len(feats) and occupancy[1] == len(coords), (
        frame, occupancy, len(feats), len(coords))


def assert_box_parity(boxes_o, boxes_p, frame, score_threshold=0.3,
                      score_atol=1e-3, match_radius=0.5,
                      threshold_margin=5e-3):
    """Greedy same-class nearest-centre matching, asserted at 1.0 (a copy
    of tests/test_oracle_parity.py:_assert_box_parity).

    With the calibrated checkpoint the selection waterline is the score
    threshold itself, so every box clearing it by ``threshold_margin``
    must have a counterpart with the same cell, score and geometry; only
    boxes inside the thin margin band may flip membership (fp32
    accumulation-order differences move scores by ~1e-4)."""
    used = np.zeros(len(boxes_p), bool)
    matched = confident = 0
    for bo in boxes_o:
        is_confident = bo[8] >= score_threshold + threshold_margin
        confident += int(is_confident)
        cand = np.where((~used) & (boxes_p[:, 7] == bo[7]))[0]
        d = (np.hypot(boxes_p[cand, 0] - bo[0], boxes_p[cand, 1] - bo[1])
             if len(cand) else np.array([np.inf]))
        if len(cand) == 0 or d.min() > match_radius:
            assert not is_confident, (
                f"{frame}: confident oracle box unmatched "
                f"(min dist {d.min():.2f}): {bo}")
            continue
        bp = boxes_p[cand[np.argmin(d)]]
        used[cand[np.argmin(d)]] = True
        matched += 1
        assert abs(bp[8] - bo[8]) <= score_atol, (
            f"{frame}: score mismatch {bp[8]} vs {bo[8]} at {bo[:2]}")
        np.testing.assert_allclose(bp[:3], bo[:3], atol=2e-2,
                                   err_msg=f"{frame}: center mismatch")
        np.testing.assert_allclose(bp[3:6], bo[3:6], rtol=2e-2,
                                   err_msg=f"{frame}: dim mismatch")
        assert abs(bp[6] - bo[6]) < 5e-2, (
            f"{frame}: heading mismatch {bp[6]} vs {bo[6]}")
    for bp in boxes_p[~used]:     # unmatched port boxes: in the band only
        assert bp[8] < score_threshold + threshold_margin, (
            f"{frame}: confident port box unmatched: {bp}")
    assert confident >= 5, (
        f"{frame}: calibration produced too few confident boxes "
        f"({confident}; oracle {len(boxes_o)}, port {len(boxes_p)})")
    assert matched >= confident, f"{frame}: {matched} < {confident} matched"


def assert_kept_sets(kept_o, kept_p, frame, nms_threshold,
                     score_threshold=0.3):
    """After NMS (tests/test_oracle_parity.py:test_post_nms_oracle_parity):
    outside the score-threshold band, a survivor on one side has a
    same-class counterpart within 0.5 m on the other, or overlaps one of
    the other side's kept boxes (its suppressor flipped under ~1e-4 score
    reordering); the kept-set sizes agree up to max(3, 10 %)."""
    from oracles import box_overlap_oracle

    def overlaps_kept(box, kept):
        for kb in kept:
            if int(kb[7]) != int(box[7]):
                continue
            ov = box_overlap_oracle(box, kb)
            iou = ov / max(box[3] * box[4] + kb[3] * kb[4] - ov, 1e-8)
            if iou >= nms_threshold * 0.5:
                return True
        return False

    margin = score_threshold + 5e-3
    for mine, theirs, tag in ((kept_o, kept_p, "oracle"),
                              (kept_p, kept_o, "port")):
        for b in mine:
            if b[8] < margin:
                continue
            d = np.hypot(theirs[:, 0] - b[0], theirs[:, 1] - b[1])
            ok = np.any((theirs[:, 7] == b[7]) & (d < 0.5))
            assert ok or overlaps_kept(b, theirs), (
                f"{frame}: confident {tag} NMS survivor has no counterpart "
                f"and no suppression-margin witness: {b}")
    assert abs(len(kept_o) - len(kept_p)) <= max(
        3, int(0.1 * max(len(kept_o), len(kept_p)))), (
        f"{frame}: kept-set sizes diverge: oracle {len(kept_o)} vs port "
        f"{len(kept_p)}")


@pytest.fixture(scope="module")
def anchor(tmp_path_factory):
    from tools import torch_oracle

    device = "cuda" if torch.cuda.is_available() else "cpu"
    torch.set_num_threads(os.cpu_count() or 4)
    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="fp32",
                              parity_atan=True)
    frames = {name: entry_frame(cfg, n, seed, half_extent=h)
              for name, (n, seed, h) in FRAMES.items()}
    params, model = setup(torch_oracle, cfg, frames,
                          str(tmp_path_factory.mktemp("oracle")), device)
    boxes_o, seconds = {}, {}
    for name, (pts, n) in frames.items():
        t0 = time.perf_counter()
        boxes_o[name] = oracle_boxes(torch_oracle, model, pts, n)
        seconds[name] = time.perf_counter() - t0
    return {"oracle": torch_oracle, "cfg": cfg, "frames": frames,
            "params": params, "boxes_o": boxes_o, "device": device,
            "oracle_seconds": seconds}


def _port(anchor, name, with_nms):
    pts, n = anchor["frames"][name]
    kernels.reset_counts()
    boxes, occ = port_boxes(anchor["params"], anchor["cfg"], pts, n,
                            anchor["device"], with_nms)
    if anchor["device"] == "cuda":     # the port's kernels ran
        want = {"segment_max": 2, "set_attention": 0, "encoder_epilogue": 0,
                "rotated_overlap": int(with_nms), "nms_peel": int(with_nms)}
        assert kernels.counts() == want, kernels.counts()
    assert_caps_free(anchor["oracle"], anchor["cfg"], pts, n, occ, name)
    return boxes


@pytest.mark.parametrize("frame", list(FRAMES))
def test_boxes_match_oracle_before_nms(anchor, frame):
    print(json.dumps({"frame": frame, "device": anchor["device"],
                      "oracle_boxes": len(anchor["boxes_o"][frame]),
                      "oracle_host_seconds": anchor["oracle_seconds"][frame]}))
    assert_box_parity(anchor["boxes_o"][frame], _port(anchor, frame, False),
                      frame, anchor["cfg"].score_threshold)


@pytest.mark.parametrize("frame", list(FRAMES))
def test_kept_sets_match_oracle_after_nms(anchor, frame):
    from oracles import nms_oracle

    boxes_o = anchor["boxes_o"][frame]
    thresh = anchor["cfg"].nms_threshold
    kept_o = boxes_o[nms_oracle(boxes_o, len(boxes_o), thresh)]
    assert_kept_sets(kept_o, _port(anchor, frame, True), frame, thresh,
                     anchor["cfg"].score_threshold)
