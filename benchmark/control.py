"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --out <file.json>

For each seed, in one process, at the cell's own sizes:

* the program: the cell's set-up, then its timed path (serving: two
  passes of the stream loop over every sweep through the engine;
  training: the first three steps of the compiled step, a window of
  ``run_seconds`` as a run takes it, then the step after), judged against
  the float32 reference as a run judges it, by the run's own functions;
* the control: the reference itself in the program's place, computed one
  precision below the cell's (``fp8`` for the bf16 serving cells,
  ``tf32`` for the fp32 training cell), judged the same way;
* faults: serving, "an answer altered where it is produced" as each
  frame's best box dropped; training, "half of the batch left out" (the
  float32 reference in the program's place with each batch's second frame
  dropped, the mean over the first), a stale batch (the reference's late
  step on the batch before) and "an answer altered where it is produced"
  (the program's losses off by 1%).

Writes {seed: {"program": numbers, "control": numbers, ...}} as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import judge
from .harness import ROOT, Cell
from .manifest import benchmark


def serving(cell: Cell, control: str, with_program: bool) -> dict:
    from .modes import stream
    from .modes.serving import Setup, reference

    setup = Setup(cell)
    sweeps = range(len(setup.frames))
    runs = {}
    if with_program:
        frames = stream.staged(cell, setup)
        runs["program"] = stream.loop(cell, setup, frames,
                                      count=2 * len(frames))
        runs["dropped_box"] = [_drop_top(o) for o in runs["program"]]
    setup.engine = None
    cell.free()
    refs = reference(cell, setup, sweeps)
    low = reference(cell, setup, sweeps, control)
    runs["control"] = [(i, d.boxes, len(d.boxes), d.occupancy)
                       for i, d in low.items()]
    kept = [len(d.boxes) for d in refs.values()]
    out = {"reference_boxes": [min(kept), float(np.median(kept)), max(kept)]}
    for name, outputs in runs.items():
        frames = judge.serving_numbers(outputs, refs, cell.ref_cfg)
        out[name] = judge.combine(frames)
        out[name + "_worst"] = {
            k: _explain(outputs[int(np.argmax([f[k] for f in frames]))], refs)
            for k in ("score_gap", "cell_gap")}
    return out


def _drop_top(output):
    """A served frame with its best box taken out (the fault "an answer
    altered where it is produced": a box dropped)."""
    i, boxes, count, occ = output
    if not count:
        return output
    top = int(np.argmax(boxes[:count, 8]))
    kept = np.delete(boxes[:count], top, axis=0)
    return i, kept, count - 1, occ


def _explain(output, refs) -> dict:
    """A frame's boxes on both sides, for reading a large number."""
    i, boxes, count, _ = output
    top = refs[i].top_k
    return {"sweep": int(i), "program": np.round(boxes[:count], 4).tolist(),
            "reference": np.round(refs[i].boxes, 4).tolist(),
            "reference_top": np.round(top[top[:, 8] > 0.2], 4).tolist()}


def training(cell: Cell, control: str, with_program: bool) -> dict:
    from .modes import train

    batches, _, raw = train.prepare(cell)
    b = train.CHECKED
    out = {}
    if with_program:
        program = train.Program(cell, raw, batches)
        prog = train.checked_steps(program)
        steps = train.loop(cell, program, train.CHECKED,
                           seconds=benchmark()["run_seconds"])
        b = (train.CHECKED + len(steps)) % len(batches)
        state, late = train.late_step(program, b)
        del program
        cell.free()
    else:
        state, late = _seeded_state(cell, raw, batches), None
    ref = train.reference_steps(cell, raw, batches, state, b)
    low = train.reference_steps(cell, raw, batches, state, b, control)
    half = train.reference_steps(cell, raw, batches, state, b, take=1)
    stale = train.reference_steps(cell, raw, batches, state, b - 1)
    out["control"] = train.numbers(*low, ref)
    out["half_batch"] = train.numbers(*half, ref)
    out["stale_batch"] = judge.late_numbers(stale[1], ref[1])
    out["control_leaves"] = _leaves(low[0], ref[0])
    if late is not None:
        out["program"] = train.numbers(prog, late, ref)
        out["program_leaves"] = _leaves(prog, ref[0])
        out["program_late_leaves"] = _leaves(late, ref[1], ("change",))
        out["control_late_leaves"] = _leaves(low[1], ref[1], ("change",))
        altered = {**prog, "loss": [prog["loss"][0] * 1.01] + prog["loss"][1:]}
        out["altered_loss"] = train.numbers(
            altered, {**late, "loss": [late["loss"][0] * 1.01]}, ref)
    return out


def _seeded_state(cell: Cell, raw, batches):
    """Without the program: the reference's own state after its first
    steps, for the late step to start from."""
    from .modes.train import CHECKED
    from .reference import weights as ref_weights
    from .reference.precision import matmul_flags, rounding
    from .reference.train import first_steps

    with matmul_flags("fp32"):
        return first_steps(ref_weights.fold(raw, cell.ref_cfg),
                           batches[:CHECKED], cell.ref_cfg,
                           cell.workload["traffic"]["lr"],
                           rounding("fp32"))["state"]


def _leaves(prog: dict, ref: dict, keys=("grad", "change"), n: int = 4
            ) -> dict:
    """The leaves of the largest gradient and change gaps, with their
    reference norms over the median leaf's, for reading a large number."""
    out = {}
    grad_floor = float(np.median(list(ref["grad"].values())))
    for key in keys:
        floor = float(np.median(list(ref[key].values())))
        gaps = sorted(((abs(prog[key][p] - r) / max(r, floor), p)
                       for p, r in ref[key].items()
                       if key == "grad"
                       or ref["grad"][p] >= judge.NOUGHT * grad_floor),
                      reverse=True)[:n]
        out[key] = [[p, g, ref[key][p] / floor,
                     ref["grad"][p] / float(np.median(list(
                         ref["grad"].values())))] for g, p in gaps]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    os.environ["DSVT_KERNEL_DIR"] = os.path.join(ROOT, "build", "kernels")
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    result = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        cell = Cell.load(args.workload, seed, 0.0, False, "cuda", t0)
        run = training if cell.mode == "train" else serving
        control = "tf32" if cell.mode == "train" else "fp8"
        result[seed] = run(cell, control, True)
        result[seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({seed: result[seed]}), flush=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
