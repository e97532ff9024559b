"""The TransFusion-L cell (``nusc-transfusion-stream``) at tiny sizes on the
CPU: a sound run is correct, and so is the reference judged against
itself (every number 0, to float32 rounding); a swapped proposal, a
moved box, zeroed velocities and a skipped replay are not; a program whose configuration
does not declare the head's keys is refused before anything is built;
``work_query.py``'s counts agree with a count by hand; the configuration
file loads in the reference's and the port's configurations."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from benchmark import judge_query, work, work_query
from benchmark.harness import Cell, read_json, run_mode, verdict
from benchmark.modes import stream_query
from benchmark.reference import transfusion
from conftest import SWEEPS, tiny

CELL = "nusc-transfusion-stream"
HEAD = {"num_proposals": 24, "query_channels": 32, "query_heads": 4,
        "query_ffn_dim": 48, "query_branch_channels": 16,
        "query_free_classes": [2],
        "post_center_range": [-6.0, -6.0, -10.0, 6.0, 6.0, 10.0]}


def _cell(seed=5, precision="fp32"):
    config = read_json("configs", "dsvt-transfusion-nuscenes.json")["config"]
    cell = Cell.load(CELL, seed, 0.5, False, "cpu", time.perf_counter(),
                     {**tiny(config), **HEAD}, SWEEPS)
    cell.workload = {**cell.workload, "precision": precision}
    return cell


def _faulty(monkeypatch, fault):
    """Serve every frame through ``fault(boxes, count, previous)``."""
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

    call, seen = Engine.__call__, []

    def served(self, points, num_points):
        dets = call(self, points, num_points)
        seen.append(dets)
        return fault(dets, seen)
    monkeypatch.setattr(Engine, "__call__", served)


def test_a_sound_run_is_correct():
    cell = _cell()
    outcome = run_mode(cell)
    ok, rows = verdict(cell, outcome.numbers)
    assert ok, rows
    assert outcome.numbers["occupancy"] == 0
    assert outcome.numbers["proposal_gap"] == 0
    assert outcome.numbers["query_gap"] < 1e-4
    assert outcome.numbers["query_median_gap"] < 1e-4
    assert outcome.failed == 0


def test_the_reference_judged_against_itself_reads_zero():
    cell = _cell()
    setup = stream_query.Setup(cell)
    setup.engine = None
    outputs = []
    for i, ref, _head in stream_query.reference(cell, setup,
                                                range(len(setup.frames))):
        boxes, count = transfusion.as_served(ref)
        outputs.append((i, boxes, count, ref.occupancy))
    numbers = stream_query.judged(cell, setup, outputs)
    # the served order puts the kept queries first: the judge's decode
    # sums the self-attention in that order, a float32 rounding away
    assert all(f["occupancy"] == 0 and f["proposal_gap"] == 0
               and f["query_gap"] < 1e-5 and f["query_median_gap"] < 1e-5
               for f in numbers), numbers


def _swap_proposal(dets, _seen):
    boxes = dets.boxes.clone()
    W = 48
    boxes[0, 11] = (boxes[0, 11] + 9 * W + 9) % (W * W)
    return dets._replace(boxes=boxes)


def _move_box(dets, _seen):
    boxes = dets.boxes.clone()
    boxes[:int(dets.count), 0] += 1.0
    return dets._replace(boxes=boxes)


def _zero_velocity(dets, _seen):
    boxes = dets.boxes.clone()
    boxes[:, 9:11] = 0.0
    return dets._replace(boxes=boxes)


def _skip_replay(dets, seen):
    """The frame before's outputs again (the replay of this one skipped)."""
    return seen[-2] if len(seen) > 1 else dets


@pytest.mark.parametrize("fault", [_swap_proposal, _move_box, _zero_velocity,
                                   _skip_replay])
def test_a_fault_is_not_correct(monkeypatch, fault):
    _faulty(monkeypatch, fault)
    cell = _cell()
    outcome = run_mode(cell)
    ok, rows = verdict(cell, outcome.numbers)
    assert not ok, rows
    assert outcome.failed > 0


def test_a_program_without_the_head_is_refused_first(monkeypatch):
    """The parent's program has no TransFusion keys: the mode raises before
    it draws traffic or builds anything."""
    from benchmark import traffic

    def no_traffic(*_):
        raise AssertionError("traffic drawn before the check")
    monkeypatch.setattr(traffic, "generate", no_traffic)
    cell = _cell()
    cell.config_file = {**cell.config_file,
                        "config": {**cell.config_file["config"],
                                   "a_key_no_program_has": 1}}
    with pytest.raises(ValueError, match="does not declare"):
        stream_query.Setup(cell)


def test_work_counts_by_hand():
    cell = _cell()
    cfg = transfusion.QueryConfig.from_dict(cell.config_file["config"])
    HW, C, Q = 48 * 48, 32, 24
    # the cross-attention: k | v projections of every cell, Q.K^T and P.V
    assert work_query.query_attention_flops(cfg) == \
        2 * HW * C * 2 * C + 2 * 2 * Q * HW * C
    assert work_query.query_attention_bytes(cfg) == \
        (HW * C * 2 + Q * C * 2 + 2 * C * C) * 2 + 2 * C * 4
    assert work_query.query_attention_seconds(cfg) == max(
        work_query.query_attention_bytes(cfg) / 3.35e12,
        work_query.query_attention_flops(cfg) / 989e12)
    # the head: shared conv 384 -> 32 and the heatmap convs 32 -> 32 -> 3
    # on the map, then the 24 queries' layers
    dense = 2 * HW * 9 * (384 * C + C * C + C * 3)
    rows = 2 * Q * (3 * C + 2 * C + C * C + 4 * C * C + 2 * Q * C
                    + 2 * C * C + 2 * C * 48 + 6 * C * 16 + 16 * (10 + 3))
    assert work_query.query_head_flops(cfg) == \
        dense + rows + work_query.query_attention_flops(cfg)
    occ = [1200, 400, 30, 25]
    assert work_query.frame_flops(cfg, occ) == pytest.approx(
        work.frame_flops(cfg, occ) - work.head_flops(cfg, False)
        + work_query.query_head_flops(cfg))


def test_the_configuration_loads_on_both_sides():
    from dsvt_ai_trt_tpu_torch.config import DSVTConfig, query_head

    raw = read_json("configs", "dsvt-transfusion-nuscenes.json")["config"]
    ref = transfusion.QueryConfig.from_dict(raw)
    port = DSVTConfig.from_json(json.dumps(raw))
    port.validate()
    assert query_head(port) and ref.head == "transfusion"
    for key in ("num_proposals", "query_channels", "query_heads",
                "query_ffn_dim", "query_branch_channels", "query_nms_kernel",
                "query_free_classes", "query_score_threshold",
                "post_center_range", "grid_size", "num_classes"):
        assert getattr(port, key) == getattr(ref, key), key
    nusc = read_json("configs", "dsvt-nuscenes.json")["config"]
    assert {k: v for k, v in raw.items() if k in nusc} == nusc


def test_proposal_gap_reads_the_reference_margins():
    """Hand-made maps: a proposal left out near the cut reads its margin; a
    cell far below reads how far."""
    cfg = transfusion.QueryConfig.from_dict(
        {**_cell().config_file["config"], "num_proposals": 2})
    H = W = 48
    s = torch.full((3, H * W), 0.1)
    s[0, 5 * W + 5], s[1, 9 * W + 9], s[0, 20 * W + 20] = 0.9, 0.8, 0.79
    masked = s * (s > 0.5)
    ref = transfusion.Frame(None, None, s, masked, torch.tensor([0, 1]),
                            torch.tensor([5 * W + 5, 9 * W + 9]), None, None,
                            None)
    near = judge_query.proposal_gap(np.array([0, 0]),
                                    np.array([5 * W + 5, 20 * W + 20]), ref,
                                    cfg)
    assert near == pytest.approx(0.01, abs=1e-6)
    far = judge_query.proposal_gap(np.array([0, 2]),
                                   np.array([5 * W + 5, 30 * W + 30]), ref,
                                   cfg)
    assert far == pytest.approx(0.7, abs=1e-6)
