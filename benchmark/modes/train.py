"""Training steps: the port's compiled training step on a pool of seeded
batches.

Set-up makes ``traffic.batches`` batches of ``traffic.batch`` planted
scenes with their targets (``traffic/scenes.py``) and puts them on the
card, makes the raw checkpoint from the seed, and builds one
``CompiledTrainStep`` (fp32, ``remat``, AdamW at ``lr``) on
``prepare_params`` of it.  Its first ``CHECKED`` steps, on batches 0, 1
and 2, go through the same call as the window's and are what the
reference checks: their losses, step 1's gradient (from AdamW's first
moment after step 1) and each leaf's change over the three.  The window
then takes the next batch of the pool each step, cycling, with two steps
in flight; each step's loss is copied back, and the window closes when the
last is on the host.  ``train_step_ms`` is its wall time over the steps.
A traced run then traces ``traced_steps`` more steps.  Once the peak is
read, one more step goes through the same call on the pool's next batch
(``late_step``): the reference takes up the parameters and AdamW state
that the window left and makes the same step, so the window's steps are
held to their batches and update counts after the pool has cycled.  The
window's own steps are not followed one by one: the reference would take
longer than the window.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import traffic, work
from ..harness import Cell, Outcome, peak_memory, read_layer_metrics
from ..judge import late_numbers, training_numbers
from ..manifest import layer_metrics
from ..reference import counts
from ..reference import weights as ref_weights
from ..reference.precision import matmul_flags, rounding
from ..reference.train import first_steps

CHECKED = 3
HOST_SPANS = ("enqueue", "wait")


def _norms(named):
    return {p: float(torch.linalg.vector_norm(t.detach().double()))
            for p, t in named}


class Program:
    def __init__(self, cell: Cell, raw, batches):
        from dsvt_ai_trt_tpu_torch.parallel.training import (
            AdamW, CompiledTrainStep, Targets)
        from dsvt_ai_trt_tpu_torch.weights import (
            from_jax_params, named_leaves, keystr, prepare_params, trainable)

        cfg = cell.port_config()
        self.Targets = Targets
        self.params = from_jax_params(
            prepare_params(ref_weights.to_numpy(raw), cfg), cell.device)
        self.named = [(keystr(p), t) for p, t in named_leaves(self.params)]
        self.start = {p: t.detach().clone() for p, t in self.named}
        self.opt = AdamW(trainable(self.params),
                         lr=cell.workload["traffic"]["lr"])
        self.step = CompiledTrainStep(cfg, self.params,
                                      batch=cell.workload["traffic"]["batch"],
                                      optimizer=self.opt, remat=True,
                                      device=cell.device)
        self.step.warmup()
        self.batches = batches

    def __call__(self, b: int):
        pts, n, hm, reg, mask = self.batches[b]
        return self.step(pts, n, self.Targets(hm, reg, mask))

    def first_gradient(self) -> dict:
        """|g| of step 1, from AdamW's first moment: mu = (1 - b1) g."""
        b1 = self.opt.param_groups[0]["betas"][0]
        return {p: float(torch.linalg.vector_norm(
            self.opt.state[t]["exp_avg"].double())) / (1 - b1)
            for p, t in self.named}

    def change(self, start=None) -> dict:
        start = self.start if start is None else start
        return {p: float(torch.linalg.vector_norm(
            (t.detach() - start[p]).double())) for p, t in self.named}

    def state(self):
        """Copies of the parameters and of AdamW's mu and nu by leaf, and
        its update count."""
        st = self.opt.state
        return ({p: t.detach().clone() for p, t in self.named},
                {p: st[t]["exp_avg"].clone() for p, t in self.named},
                {p: st[t]["exp_avg_sq"].clone() for p, t in self.named},
                int(round(float(self.opt.count))))


def prepare(cell: Cell):
    """The pool of batches on the device, each batch's operations (the
    benchmark's count) and the raw checkpoint from the seed."""
    cfg, dev = cell.ref_cfg, cell.device
    pool = traffic.generate(cell.workload["traffic"], cell.seed, cfg)
    flops = [sum(work.frame_flops(cfg, counts.occupancy(p, n, cfg), train=True)
                 for p, n in zip(b[0], b[1])) for b in pool]
    batches = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in pool]
    return batches, flops, ref_weights.seeded_raw(cfg, cell.seed, dev)


def checked_steps(program: Program) -> dict:
    """The first ``CHECKED`` steps, on batches 0, 1, 2: their losses, step
    1's gradient and each leaf's change over the three."""
    prog = {"loss": []}
    for b in range(CHECKED):
        prog["loss"].append(float(program(b)))
        if b == 0:
            prog["grad"] = program.first_gradient()
    prog["change"] = program.change()
    return prog


def late_step(program: Program, b: int):
    """One step on batch ``b`` through the window's call: (the state before
    it, its loss and each leaf's change)."""
    state = program.state()
    loss = float(program(b))
    return state, {"loss": [loss], "change": program.change(state[0])}


def reference_steps(cell: Cell, raw, batches, state, b: int,
                    precision: str = "fp32", take=None):
    """The reference's first ``CHECKED`` steps from the seeded weights, and
    its step on batch ``b`` from the program's ``state``, at ``precision``;
    ``take`` keeps each batch's first frames only."""
    cfg, lr = cell.ref_cfg, cell.workload["traffic"]["lr"]

    def cut(batch):
        return batch if take is None else tuple(t[:take] for t in batch)
    params, mu, nu, count = state
    with matmul_flags(precision):
        first = first_steps(ref_weights.fold(raw, cfg),
                            [cut(x) for x in batches[:CHECKED]], cfg, lr,
                            rounding(precision))
        taken = ref_weights.fold(raw, cfg)
        with torch.no_grad():
            for p, t in ref_weights.leaves(taken):
                t.copy_(params[p])
        late = first_steps(taken, [cut(batches[b])], cfg, lr,
                           rounding(precision), (mu, nu, count))
    return first, late


def numbers(prog: dict, late: dict, ref) -> dict:
    return {**training_numbers(prog, ref[0]), **late_numbers(late, ref[1])}


def loop(cell: Cell, program: Program, start: int, count=None, seconds=None,
         label=None):
    """Steps on batches start, start + 1, ... (cycling) until ``count``
    steps or ``seconds`` of dispatching; returns the losses."""
    n = len(program.batches)
    losses, queue = [], []
    t_end = None if seconds is None else time.perf_counter() + seconds
    k = 0

    def done():
        host, event = queue.pop(0)
        with cell.span("wait"):
            if event is not None:
                event.synchronize()
            losses.append(float(host))

    while (count is None or k < count) and (
            t_end is None or time.perf_counter() < t_end):
        with torch.profiler.record_function(label or "step"):
            with cell.span("enqueue"):
                loss = program((start + k) % n)
            host = torch.empty((), pin_memory=cell.on_card)
            host.copy_(loss, non_blocking=cell.on_card)
            event = None
            if cell.on_card:
                event = torch.cuda.Event()
                event.record()
            queue.append((host, event))
            if len(queue) > 1:
                done()
        k += 1
    while queue:
        done()
    return losses


def run(cell: Cell) -> Outcome:
    dev = cell.device
    batches, flops, raw = prepare(cell)
    if cell.on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    program = Program(cell, raw, batches)
    prog = checked_steps(program)
    cell.spans.clear()
    setup_s = time.perf_counter() - cell.t_start

    t0 = time.perf_counter()
    losses = loop(cell, program, CHECKED, seconds=cell.seconds)
    window = time.perf_counter() - t0
    metrics = {"setup_s": setup_s,
               "train_step_ms": window / len(losses) * 1e3}

    layer, trace = {}, None
    if cell.trace:
        from ..trace import capture

        start = (CHECKED + len(losses)) % len(batches)
        n_traced = cell.workload["traced_steps"]
        more, trace = capture(lambda: loop(cell, program, start,
                                           count=n_traced, label="frame"),
                              dev)
        losses += more
        traced = [(start + k) % len(batches) for k in range(n_traced)]
        ctx = {"cell": cell.name, "mode": cell.mode, "spans": cell.spans,
               "trace": trace, "steps": n_traced,
               "flops": sum(flops[b] for b in traced),
               "peak_flops": work.PEAK_FLOPS[cell.workload["precision"]]}
        layer = read_layer_metrics(cell, ctx, layer_metrics(cell.name))
    peak = peak_memory(cell)
    breakdown = None if trace is None else {
        "device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps(HOST_SPANS)}
    b = (CHECKED + len(losses)) % len(batches)
    state, late = late_step(program, b)
    del program
    cell.free()

    judged = numbers(prog, late, reference_steps(cell, raw, batches, state, b))
    failed = int(sum(not np.isfinite(v)
                     for v in losses + prog["loss"] + late["loss"]))
    return Outcome(attempted=CHECKED + len(losses) + 1, failed=failed,
                   metrics=metrics, numbers=judged, layer=layer,
                   busy_s=trace.busy_s() if trace else None,
                   window_s=trace.window_s() if trace else None,
                   breakdown=breakdown, memory_peak_bytes=peak)
