"""The row gathers of the training step (``ops/gather.py:take_rows``), on
the CPU at the tiny configuration:

* ``take_rows`` equals ``table[idx]``: the forward bit for bit, the
  gradient exactly, in f32 and bf16, for 1-D and 2-D indices with a
  10 000-long run of the dump index, where the dump row's reads get a zero
  gradient, as the detector's masks give them; and in f32 where every read
  gets one (the CPU's ``index_add_`` sums in index order, as
  ``index_put_``'s accumulation does on one intra-op thread);
* where autograd records nothing (inference mode, no-grad, a table that
  needs no gradient) it dispatches ``aten.index`` itself and no
  ``index_select``;
* a ``batched_loss`` backward (remat on and off) accumulates with no
  ``index_put_``: no gather of the step's float stages brings back
  PyTorch's sort-based backward of advanced indexing;
* with the tracer on, a step's ``grad_gathers`` counter reads 4 a block
  and 1 for the VFE a frame (17 a frame at the default's 4 blocks), not
  counting ``remat``'s recomputation, and a served frame has none.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu_torch import data, weights
from dsvt_ai_trt_tpu_torch.ops.gather import grad_gathers, take_rows
from dsvt_ai_trt_tpu_torch.parallel.training import (
    CompiledTrainStep, batched_loss)
from dsvt_ai_trt_tpu_torch.runtime import profiler
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

SCENE = dict(n_objects=2, n_ground=200, pts_per_obj=30)
ACCUMULATING = ("index_put", "index_put_", "_index_put_impl_")


# The gradient test's serial summation order rests on torch_cpu's one thread.


class _Ops(TorchDispatchMode):
    """Records each aten op as (overload packet name, args, kwargs)."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.calls.append((func.overloadpacket.__name__, args, kwargs))
        return func(*args, **kwargs)

    def names(self):
        return [name for name, _, _ in self.calls]

    def accumulating(self):
        """The index_put calls that accumulate."""
        out = []
        for name, args, kwargs in self.calls:
            if name in ACCUMULATING and (kwargs.get("accumulate")
                                         or (len(args) > 3 and args[3])):
                out.append(name)
        return out


def _gather_case(dtype, idx_dims, duplicates, dump_run=10_000):
    """A [257, 24] table (row 256 the dump) and shuffled indices: every row
    once and ``dump_run`` reads of the dump row, plus, with
    ``duplicates``, 3 000 random reads of the other rows."""
    gen = torch.Generator().manual_seed(idx_dims)
    rows = 256
    table = torch.randn(rows + 1, 24, generator=gen).to(dtype)
    idx = torch.cat([torch.arange(rows + 1), torch.full((dump_run,), rows),
                     torch.randint(0, rows, (3_000 * duplicates,),
                                   generator=gen)])
    idx = idx[torch.randperm(idx.numel(), generator=gen)]
    if idx_dims == 2:
        idx = idx[:idx.numel() // 36 * 36].view(-1, 36)
    return table, idx


@pytest.mark.parametrize("idx_dims", [1, 2])
@pytest.mark.parametrize("dtype,case", [
    (torch.float32, "masked"), (torch.bfloat16, "masked"),
    (torch.float32, "duplicates")],
    ids=["f32-masked", "bf16-masked", "f32-duplicates"])
def test_take_rows_equals_indexing(dtype, case, idx_dims):
    """"masked" is the detector's gathers: every live row read once, and the
    dump row's many reads given a zero gradient by the masks (so any order
    of summation gives the same bits).  "duplicates" gives every read a
    gradient, the dump row's too: summed in index order on both routes.
    (In bf16 the CPU's ``index_add_`` rounds a row's sum once, where
    ``index_put_`` rounds each addition.)"""
    table, idx = _gather_case(dtype, idx_dims, case == "duplicates")
    grad = torch.randn(*idx.shape, table.shape[1],
                       generator=torch.Generator().manual_seed(7)).to(dtype)
    if case == "masked":
        grad[idx == table.shape[0] - 1] = 0
    got_t = table.clone().requires_grad_(True)
    want_t = table.clone().requires_grad_(True)
    before = grad_gathers()
    got = take_rows(got_t, idx)
    assert grad_gathers() == before + 1
    want = want_t[idx]
    assert got.shape == want.shape == (*idx.shape, table.shape[1])
    assert got.dtype == want.dtype and torch.equal(got, want)
    got.backward(grad)
    want.backward(grad)
    assert torch.equal(got_t.grad, want_t.grad)
    assert (got_t.grad[-1].abs().sum() > 0) == (case == "duplicates")


@pytest.mark.parametrize("context", ["inference_mode", "no_grad",
                                     "no_grad_table"])
def test_take_rows_without_autograd_is_indexing(context):
    table, idx = _gather_case(torch.float32, 2, True)
    if context == "no_grad_table":
        ctx = torch.enable_grad()
    else:
        table.requires_grad_(True)
        ctx = getattr(torch, context)()
    before = grad_gathers()
    with ctx, _Ops() as ops:
        got = take_rows(table, idx)
    assert grad_gathers() == before
    assert "index" in ops.names() and "index_select" not in ops.names()
    assert torch.equal(got, table.detach()[idx])


def _params(cfg, seed=0):
    return weights.from_jax_params(weights.random_params(cfg, seed), "cpu")


@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_training_backward_accumulates_with_no_index_put(remat):
    cfg = tiny_config()
    params = _params(cfg)
    leaves = weights.trainable(params)
    for t in leaves:
        t.requires_grad_(True)
    pts, ns, targets = data.synthetic_batch(np.random.default_rng(3), cfg, 2,
                                            device="cpu", **SCENE)
    with _Ops() as ops:
        loss = batched_loss(params, pts, ns, targets, cfg, remat=remat,
                            device="cpu")
        loss.backward()
    assert ops.accumulating() == []
    # each gather's backward is one index_add, also under remat
    assert ops.names().count("index_add") == 2 * (4 * cfg.num_blocks + 1)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("remat", [False, True], ids=["no_remat", "remat"])
def test_grad_gathers_counts_a_frames_gathers(remat, batch):
    cfg = dataclasses.replace(tiny_config(), num_blocks=4)   # the default's
    step = CompiledTrainStep(cfg, _params(cfg), batch, remat=remat,
                             device="cpu")
    pts, ns, targets = data.synthetic_batch(np.random.default_rng(3), cfg,
                                            batch, device="cpu", **SCENE)
    engine = Engine(_params(cfg), cfg, device="cpu")
    profiler.enable_spans()
    try:
        loss = step(pts, ns, targets)
        engine(*make_cloud(np.random.default_rng(1), cfg, 700))
        rec_step, rec_frame = profiler.spans()
    finally:
        profiler.disable_spans()
    assert torch.isfinite(loss)
    assert rec_step["what"] == "step"
    assert rec_step["counters"]["grad_gathers"] == [17 * batch]
    assert rec_frame["what"] == "frame"
    assert "grad_gathers" not in rec_frame["counters"]
