"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Without a CUDA card, or with fewer cards
than the cell takes, it exits 2 and prints nothing.  It sets up (weights
and traffic from the seed, the program's kernels from its build cache
under ``build/kernels/``, the engine or training step warmed), measures
for ``--seconds``, checks what the timed path produced against the plain
reference (benchmark/reference/), and prints as its last line one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number
compared with its limit, also the last lines of standard error.  It exits
3, printing no result, when ``jax``, ``jaxlib``, ``flax`` or the JAX
package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import json       # noqa: E402
import os         # noqa: E402
import sys        # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dsvt_ai_trt_tpu")


def loaded_forbidden():
    """Whole top-level module names of ``FORBIDDEN`` in ``sys.modules``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's kernel libraries build into, and load from, the
    # checkout's own fixed cache
    os.environ["DSVT_KERNEL_DIR"] = os.path.join(ROOT, "build", "kernels")

    import torch

    # one process with few threads: the host's work is the program's
    # launches, and idle pool threads only add jitter
    torch.set_num_threads(1)

    from .harness import Cell, result_line, run_mode, verdict
    from .manifest import benchmark

    bench = benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload),
                 None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell = Cell.load(args.workload, args.seed, args.seconds, bool(args.trace),
                     "cuda", T_START)
    outcome = run_mode(cell)
    correct, rows = verdict(cell, outcome.numbers)
    found = loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(cell, outcome, correct, rows, bench)
    print(json.dumps(line))
    print("readings " + json.dumps(outcome.numbers), file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
