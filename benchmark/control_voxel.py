"""Readings that the voxel cell's limits of ``correct`` are set from, as
``control.py`` takes them for the pillar cells (not run by the benchmark's
own runs).

    python3 -m benchmark.control_voxel --workload waymo-voxel-stream \\
        --seeds 1,2,3 --out <file.json>

For each seed, in one process, at the cell's own sizes: the program (the
cell's set-up, then two passes of the stream loop over every sweep through
the engine) judged against the float32 voxel reference as a run judges
it; the control, the reference itself computed with every product's
operands rounded to fp8 e4m3, judged the same way; and the fault "the best
box of every frame dropped".  Writes {seed: {"program": numbers,
"control": numbers, "dropped_box": numbers, ...}} as JSON.
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
from .control import _drop_top, _explain
from .harness import ROOT, Cell


def serving(cell: Cell) -> dict:
    from .modes import stream, stream_voxel

    setup = stream_voxel.Setup(cell)
    frames = stream.staged(cell, setup)
    runs = {"program": stream.loop(cell, setup, frames,
                                   count=2 * len(frames))}
    runs["dropped_box"] = [_drop_top(o) for o in runs["program"]]
    setup.engine = None
    cell.free()
    sweeps = range(len(setup.frames))
    refs = stream_voxel.reference(cell, setup, sweeps)
    low = stream_voxel.reference(cell, setup, sweeps, "fp8")
    runs["control"] = [(i, d.boxes, len(d.boxes), d.occupancy)
                       for i, d in low.items()]
    kept = [len(d.boxes) for d in refs.values()]
    out = {"reference_boxes": [min(kept), float(np.median(kept)), max(kept)]}
    for name, outputs in runs.items():
        per_frame = judge.serving_numbers(outputs, refs, setup.cfg)
        out[name] = judge.combine(per_frame)
        out[name + "_worst"] = {
            k: _explain(outputs[int(np.argmax([f[k] for f in per_frame]))],
                        refs) for k in ("score_gap", "cell_gap")}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="waymo-voxel-stream")
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
        print(json.dumps({seed: {k: v for k, v in result[seed].items()
                                 if not k.endswith("_worst")}}), flush=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
