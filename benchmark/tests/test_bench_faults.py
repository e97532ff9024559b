"""A run whose timed path is broken underneath comes out not correct.

Each case drives the rest of a run (set-up, the window, the reference's
verdict under the cell's own limits) at the tiny sizes on the CPU, with no
look for a card, and the program at float32 so that a sound run reads
rounding only.  The faults are those each cell can have: a serving step
that leaves its state as it was (the replay did not run: the frame gets
the previous frame's boxes), an answer altered where it is produced (one
box moved and rescored, or the best box dropped), and for training a step
that leaves the weights unchanged, half of the batch left out (the mean
over the rest), a loss altered where it is produced, and a step that
stops taking in new batches after the first three (its graph replays the
last one copied in).  One chip runs each cell, so no exchange between
chips exists to leave out.
"""

from __future__ import annotations

import pytest
import torch

from benchmark.harness import run_mode, verdict
from conftest import tiny_cell


def _correct(cell):
    outcome = run_mode(cell)
    return verdict(cell, outcome.numbers)[0], outcome.numbers


def _stale(monkeypatch):
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

    call, last = Engine.__call__, {}

    def stale(self, points, num_points):
        dets = call(self, points, num_points)
        out = last.get("dets", dets)
        last["dets"] = dets
        return out
    monkeypatch.setattr(Engine, "__call__", stale)


def _altered(monkeypatch):
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

    call = Engine.__call__

    def altered(self, points, num_points):
        dets = call(self, points, num_points)
        boxes = dets.boxes.clone()
        boxes[0, 0] += 2.0
        boxes[0, 8] -= 0.1
        return dets._replace(boxes=boxes)
    monkeypatch.setattr(Engine, "__call__", altered)


def _dropped(monkeypatch):
    from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

    call = Engine.__call__

    def dropped(self, points, num_points):
        dets = call(self, points, num_points)
        n = int(dets.count)
        if not n:
            return dets
        top = int(torch.argmax(dets.boxes[:n, 8]))
        order = [i for i in range(len(dets.boxes)) if i != top] + [top]
        return dets._replace(boxes=dets.boxes[order], count=dets.count - 1)
    monkeypatch.setattr(Engine, "__call__", dropped)


SERVING = {"stale_state": _stale, "altered_answer": _altered,
           "dropped_box": _dropped}
SERVING_CELLS = ["nusc-stream", "waymo-stream", "nusc-sensor-20hz"]


@pytest.mark.parametrize("name", SERVING_CELLS)
def test_a_sound_serving_run_is_correct(name):
    ok, numbers = _correct(tiny_cell(name, precision="fp32"))
    assert ok, numbers


@pytest.mark.parametrize("fault", sorted(SERVING))
@pytest.mark.parametrize("name", SERVING_CELLS)
def test_a_broken_serving_run_is_not_correct(name, fault, monkeypatch):
    SERVING[fault](monkeypatch)
    ok, numbers = _correct(tiny_cell(name, precision="fp32"))
    assert not ok, numbers


def _unchanged(monkeypatch):
    from dsvt_ai_trt_tpu_torch.parallel import training

    def no_update(self, points, num_points, targets):
        return training.batched_loss(self.params, points, num_points, targets,
                                     self.cfg, remat=False,
                                     device=self.device).detach()
    monkeypatch.setattr(training.CompiledTrainStep, "__call__", no_update)


def _half_batch(monkeypatch):
    from dsvt_ai_trt_tpu_torch.parallel import training

    loss = training.batched_loss

    def half(params, points, num_points, targets, *args, **kw):
        keep = max(len(points) // 2, 1)
        return loss(params, points[:keep], num_points[:keep],
                    training.Targets(*(t[:keep] for t in targets)),
                    *args, **kw)
    monkeypatch.setattr(training, "batched_loss", half)


def _altered_loss(monkeypatch):
    from dsvt_ai_trt_tpu_torch.parallel import training

    call = training.CompiledTrainStep.__call__

    def altered(self, *args):
        return call(self, *args) * 1.01
    monkeypatch.setattr(training.CompiledTrainStep, "__call__", altered)


def _stale_batch(monkeypatch):
    from dsvt_ai_trt_tpu_torch.parallel import training

    from benchmark.modes.train import CHECKED

    call, seen = training.CompiledTrainStep.__call__, []

    def stale(self, *args):
        seen.append(args)
        return call(self, *seen[min(len(seen), CHECKED) - 1])
    monkeypatch.setattr(training.CompiledTrainStep, "__call__", stale)


TRAINING = {"state_unchanged": _unchanged, "half_batch": _half_batch,
            "altered_answer": _altered_loss, "stale_batch": _stale_batch}


def test_a_sound_training_run_is_correct():
    ok, numbers = _correct(tiny_cell("nusc-train-b2", seed=2))
    assert ok, numbers


@pytest.mark.parametrize("fault", sorted(TRAINING))
def test_a_broken_training_run_is_not_correct(fault, monkeypatch):
    TRAINING[fault](monkeypatch)
    ok, numbers = _correct(tiny_cell("nusc-train-b2", seed=2))
    assert not ok, numbers
    torch.set_grad_enabled(True)
