"""The collectives of the multi-device layer, written out over
``torch.distributed``.

The JAX package wrote no collective: GSPMD inserted each one from the
sharding annotations of its parallel/mesh.py and parallel/spatial.py.
Here every one is explicit, on an explicit process group (``None`` is the
default group):

  * ``copy_to_tp`` / ``reduce_from_tp``: Megatron's pair around a
    column-sharded then row-sharded product.  ``copy_to_tp`` is the
    identity forward and all-reduces the gradient; ``reduce_from_tp``
    all-reduces forward and passes the gradient through.
  * ``all_gather_rows``: every rank's rows (uneven counts allowed) in rank
    order; the gradient of the result is sliced back to this rank's rows,
    which is right where every rank goes on with the same (replicated)
    computation.
  * ``halo_rows``: a rank's rows with its neighbours' edge rows around
    them, zeros past the global edge (the 3x3 convs of a row-sharded map).
  * ``all_reduce``: a sum.

Transport.  The group's backend decides where tensors travel.  NCCL takes
them on the device.  Gloo takes CPU tensors, and of CUDA tensors only
``broadcast`` and ``all_reduce``, with no ``send``/``recv`` and no
``all_gather``; so under gloo a CUDA tensor is copied to the host, reduced
or gathered there and copied back.  That is the stated transport of a gloo
group, not a fallback: the computation stays on the card.  It lets two
processes share one card (NCCL refuses two ranks on one GPU).

Every collective adds its host seconds (the copies, and the wait for the
device that a copy to the host implies, included) and its bytes to
``stats()``; ``reset_stats()`` sets them to 0.

Every collective reaches the transport at exactly two functions,
``all_reduce`` and ``_all_gather_equal``; the rest pad, slice and
concatenate around them.  ``intercepted(hook)`` routes those two, on the
calling thread, to ``hook(kind, x, group)`` (``kind`` "all_reduce" or
"all_gather") instead of ``transport``: ``runtime.compile.
capture_segments`` closes its CUDA graph there and records a host step
that runs ``transport`` at replay into static buffers of ``outputs``.

Who may reach a hook: the thread that entered ``intercepted``, and the
work that thread hands to autograd.  Autograd runs a CUDA backward, and a
non-reentrant checkpoint's recomputation inside it, on a thread of its
own, so the hook travels with that work, not with the thread:
``copy_to_tp`` records the hook current at its forward and its backward
runs under it (``carried``), and a function wrapped by ``carrying`` runs
under the hook current where it was wrapped, whichever thread calls it
(``parallel.training.batched_loss`` wraps each frame's checkpointed
stages).  Any other collective reached from a thread without a hook while
some thread has one raises, so no capture holds half a collective.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

_STATS = {"calls": 0, "seconds": 0.0, "bytes": 0}


def stats() -> dict:
    """Collective calls, host seconds in them and bytes sent, since the
    last ``reset_stats``."""
    return dict(_STATS)


def reset_stats() -> None:
    _STATS.update(calls=0, seconds=0.0, bytes=0)


def init_group(backend: str, world_size: int, rank: int,
               init_file: str) -> None:
    """Join the default process group through a shared file (``file://``
    init, so parallel runs in separate directories never collide on a
    port).  The file must not exist before the first rank joins."""
    dist.init_process_group(backend,
                            init_method="file://" + os.path.abspath(init_file),
                            world_size=world_size, rank=rank)


def _via_host(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


class _Timed:
    """Counts one collective in ``stats()``."""

    def __init__(self, nbytes: int):
        self.nbytes = nbytes

    def __enter__(self):
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        _STATS["calls"] += 1
        _STATS["bytes"] += self.nbytes
        _STATS["seconds"] += time.perf_counter() - self.t0


_LOCAL = threading.local()
_HOOKED = set()          # idents of the threads that have a hook


def _current_hook() -> Optional[Callable]:
    """This thread's hook (``intercepted``, ``carried``), or None."""
    return getattr(_LOCAL, "hook", None)


def _hook():
    hook = _current_hook()
    if hook is None and _HOOKED:
        raise RuntimeError(
            f"a collective on thread {threading.get_ident()} while thread(s) "
            f"{sorted(_HOOKED)} capture segments: a collective that another "
            "thread reaches, and that carries no hook with it (``carried``), "
            "cannot be captured")
    return hook


@contextlib.contextmanager
def intercepted(hook: Callable):
    """Route this thread's collectives to ``hook(kind, x, group)``, which
    returns what ``transport`` would (module docstring)."""
    if getattr(_LOCAL, "hook", None) is not None:
        raise RuntimeError("intercepted: this thread already has a hook")
    ident = threading.get_ident()
    _LOCAL.hook = hook
    _HOOKED.add(ident)
    try:
        yield hook
    finally:
        _HOOKED.discard(ident)
        del _LOCAL.hook


@contextlib.contextmanager
def carried(hook: Optional[Callable]):
    """Run the block under ``hook``, a hook current on the thread that made
    the work this block does (an autograd node, a checkpointed function),
    on whatever thread runs it: nothing changes where ``hook`` is None or
    already this thread's; on a thread without a hook the block runs
    ``intercepted(hook)``; a thread with another hook raises."""
    if hook is None or _current_hook() is hook:
        yield
        return
    with intercepted(hook):
        yield


def carrying(fn: Callable) -> Callable:
    """``fn`` run under the hook current here and now (``carried``), on
    whatever thread calls it: the function of a non-reentrant checkpoint,
    which autograd's thread calls again in the backward."""
    hook = _current_hook()

    def run(*args, **kwargs):
        with carried(hook):
            return fn(*args, **kwargs)
    return run


def outputs(kind: str, x: torch.Tensor, group) -> list:
    """Empty tensors of the shapes, dtype and device that ``transport``
    returns for ``x``: one like x for "all_reduce", the group's size of
    them for "all_gather"."""
    n = 1 if kind == "all_reduce" else dist.get_world_size(group)
    return [torch.empty(x.shape, dtype=x.dtype, device=x.device)
            for _ in range(n)]


def transport(kind: str, x: torch.Tensor, group, out=None):
    """Run one collective now: "all_reduce", the sum of x over the group as
    a new tensor on x's device, or "all_gather", every rank's x (same
    shapes) in rank order.  With ``out`` (``outputs``' tensors) the result
    is written there and ``out`` returned."""
    with _Timed(x.numel() * x.element_size()):
        if kind == "all_reduce":
            buf = x.detach().cpu() if _via_host(x, group) \
                else x.detach().clone(memory_format=torch.contiguous_format)
            dist.all_reduce(buf, group=group)
            parts = [buf]
        else:
            buf = x.detach().contiguous()
            if _via_host(x, group):
                buf = buf.cpu()
            parts = [torch.empty_like(buf)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, buf, group=group)
        if out is None:
            parts = [p.to(x.device, non_blocking=False) for p in parts]
        else:
            for o, p in zip(out, parts):
                o.copy_(p)
            parts = out
    return parts[0] if kind == "all_reduce" else parts


def _collective(kind: str, x: torch.Tensor, group):
    hook = _hook()
    return transport(kind, x, group) if hook is None \
        else hook(kind, x, group)


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``x`` over the group, as a new tensor on x's device."""
    return _collective("all_reduce", x, group)


def _all_gather_equal(x: torch.Tensor, group) -> list:
    """``dist.all_gather`` of same-shape tensors, in rank order."""
    return _collective("all_gather", x, group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.hook = group, _current_hook()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        with carried(ctx.hook):
            return all_reduce(grad, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is all-reduced over ``group``.  Wraps every
    replicated tensor that enters a column-sharded product."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` of a row-sharded product's partial result; the
    gradient passes through."""
    return _ReduceFromTP.apply(x, group)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, counts, group, dim):
        rank = dist.get_rank(group)
        ctx.lo, ctx.n, ctx.dim = sum(counts[:rank]), counts[rank], dim
        if x.shape[dim] != counts[rank]:
            raise ValueError(f"all_gather_rows: rank {rank} holds "
                             f"{x.shape[dim]} rows, counts say "
                             f"{counts[rank]}")
        rows = x.movedim(dim, 0)
        m = max(counts)
        if rows.shape[0] < m:                 # pad to the largest share
            rows = torch.cat([rows, rows.new_zeros((m - rows.shape[0],)
                                                   + rows.shape[1:])])
        parts = _all_gather_equal(rows, group)
        out = torch.cat([p[:c] for p, c in zip(parts, counts)])
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.lo, ctx.n), None, None, None


def all_gather_rows(x: torch.Tensor, counts: Sequence[int], group=None,
                    dim: int = 0) -> torch.Tensor:
    """Concatenate every rank's ``x`` along ``dim`` in rank order.  Rank r
    holds ``counts[r]`` rows (uneven counts allowed).  The gradient is
    sliced back to this rank's rows."""
    return _GatherRows.apply(x, list(counts), group, dim)


def halo_rows(x: torch.Tensor, need_lo: int, need_hi: int, group=None,
              dim: int = 0) -> torch.Tensor:
    """This rank's rows of a global axis (split over the group in rank
    order) with ``need_lo`` rows of the rank before it prepended and
    ``need_hi`` rows of the rank after it appended: zeros before rank 0
    and after the last rank, the global edge.  ``need_lo`` and ``need_hi``
    are the same on every rank, and no rank holds fewer rows than either.
    Inference only: it defines no gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("halo_rows defines no gradient: spatial sharding "
                         "is an inference path")
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rows = x.movedim(dim, 0)
    n = rows.shape[0]
    if n < max(need_lo, need_hi):
        raise ValueError(f"halo_rows: rank {rank} holds {n} rows, fewer "
                         f"than the halo ({need_lo}, {need_hi})")
    if need_lo == need_hi == 0:
        return x
    # each rank offers its first need_hi rows (for the rank before it) and
    # its last need_lo rows (for the rank after it)
    edges = _all_gather_equal(torch.cat([rows[:need_hi], rows[n - need_lo:]]),
                              group)
    zeros = rows.new_zeros
    above = (edges[rank - 1][need_hi:] if rank > 0
             else zeros((need_lo,) + rows.shape[1:]))
    below = (edges[rank + 1][:need_hi] if rank < world - 1
             else zeros((need_hi,) + rows.shape[1:]))
    return torch.cat([above, rows, below]).movedim(0, dim)
