"""Row gathers whose backward sums duplicate rows in one pass.

``take_rows(table, idx)`` is ``table[idx]``: rows of ``table`` at the
integer indices ``idx``, shaped ``idx.shape + table.shape[1:]``.  The
detector's gathers read one row many thousands of times (the dump row of
empty set slots, the clamped row of dead pillars, the dump row of invalid
points).  PyTorch's backward of ``table[idx]`` accumulates with
``index_put_``, which on the card sorts the indices and walks each run of
equal indices in series, so a run of tens of thousands of reads of one
row costs milliseconds.  Where autograd records the gather (grad mode on
and ``table`` requiring grad), ``take_rows`` gathers with
``index_select`` instead: the same values, and a backward of
``index_add_``, one pass over the gradient rows (atomic adds on the card,
index order on the CPU).  Elsewhere (inference, no-grad) it is
``table[idx]`` itself, the same operator as before.

The gathers that took the ``index_select`` route are counted on this
thread (``grad_gathers``: the tracer's ``grad_gathers`` counter, written
by the training step, parallel/training.py).
"""

from __future__ import annotations

import threading

import torch

_STATE = threading.local()


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` for an integer ``idx`` of any shape (module
    docstring)."""
    if torch.is_grad_enabled() and table.requires_grad:
        _STATE.grad_gathers = grad_gathers() + 1
        rows = torch.index_select(table, 0, idx.reshape(-1))
        return rows.view(*idx.shape, *table.shape[1:])
    return table[idx]


def grad_gathers() -> int:
    """The gathers ``take_rows`` has routed through ``index_select`` on
    this thread so far."""
    return getattr(_STATE, "grad_gathers", 0)
