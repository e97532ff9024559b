"""Readings that the TransFusion-L cell's limits of ``correct`` are set
from, as ``control_voxel.py`` takes them for the voxel cell (not run by
the benchmark's own runs).

    python3 -m benchmark.control_query --seeds 1,2,3 --out <file.json>

For each seed, in one process, at the cell's own sizes: the program (the
cell's set-up, then two passes of the stream loop over every sweep through
the engine) judged against the float32 reference as a run judges it
(``judge_query.py``); the control, the reference itself computed with
every product's operands rounded to fp8 e4m3, judged the same way; and
three faults of the program's frames: the first query's cell moved 9
cells down and right (``swapped_proposal``), every kept box moved 1 m in x
(``moved_box``), the velocities zeroed (``zeroed_velocity``).  Writes
{seed: {"program": numbers, "control": numbers, <fault>: numbers, ...}}
as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from . import judge, judge_query
from .harness import ROOT, Cell
from .reference import transfusion
from .reference.precision import matmul_flags, rounding


def _faults(outputs, cfg):
    W = cfg.grid_size[0]
    out = {"swapped_proposal": [], "moved_box": [], "zeroed_velocity": []}
    for i, boxes, count, occ in outputs:
        b = boxes.copy()
        b[0, 11] = (b[0, 11] + 9 * W + 9) % (W * cfg.grid_size[1])
        out["swapped_proposal"].append((i, b, count, occ))
        b = boxes.copy()
        b[:count, 0] += 1.0
        out["moved_box"].append((i, b, count, occ))
        b = boxes.copy()
        b[:, 9:11] = 0.0
        out["zeroed_velocity"].append((i, b, count, occ))
    return out


def serving(cell: Cell) -> dict:
    from .modes import stream, stream_query

    setup = stream_query.Setup(cell)
    frames = stream.staged(cell, setup)
    runs = {"program": stream.loop(cell, setup, frames,
                                   count=2 * len(frames))}
    runs.update(_faults(runs["program"], setup.cfg))
    setup.engine = None
    cell.free()
    cfg = setup.cfg
    params = transfusion.fold(setup.raw, cfg)
    numbers = {name: [] for name in (*runs, "control")}
    kept = []
    for i, ref, head in stream_query.reference(cell, setup,
                                               range(len(setup.frames))):
        kept.append(int(ref.keep.sum()))
        pts, n = setup.frames[i]
        with matmul_flags("fp8"):
            low = transfusion.detect(params, torch.from_numpy(pts).to(
                cell.device), n, cfg, rounding("fp8"))
        boxes, count = transfusion.as_served(low)
        mine = {"control": [(i, boxes, count, low.occupancy)]}
        mine.update({name: [o for o in outs if o[0] == i]
                     for name, outs in runs.items()})
        with matmul_flags("fp32"):
            for name, outs in mine.items():
                numbers[name] += judge_query.sweep_numbers(outs, ref, head,
                                                           cfg)
        del low
    out = {"reference_boxes": [min(kept), float(np.median(kept)), max(kept)]}
    for name, per_frame in numbers.items():
        out[name] = judge.combine(per_frame)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="nusc-transfusion-stream")
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
        result[seed] = serving(cell)
        result[seed]["seconds"] = time.perf_counter() - t0
        print(json.dumps({seed: result[seed]}), flush=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
