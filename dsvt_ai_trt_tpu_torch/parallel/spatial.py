"""Spatial sharding of one frame across ranks, port of the JAX package's
parallel/spatial.py.

DSVT attention never crosses a set, so the set axis splits freely, and the
dense BEV stages split by map rows.  JAX annotated the tensors
(``constrain_rows``, ``constrain_bev``) and GSPMD inserted the
all-gathers and the halo exchanges.  Here the model calls these helpers at
the same sites, and each exchange is explicit (parallel/collectives.py):

  * pillar and set rows: ``row_range`` splits them; each rank computes the
    q/k/v table of its pillar rows and all-gathers it, runs attention on
    its slice of sets, all-gathers the set-slot outputs and runs the
    epilogue on its pillar rows (model/backbone3d.py);
  * the BEV map: rows split so that they nest through the conv stack's
    strides (``bev_range``): the coarsest level (H/4 rows at the default
    strides, 468 -> 234 -> 117) is split by ``row_range`` and a finer
    level's share is that share times its scale.  So a stride-2 conv's
    input rows of a rank are exactly twice its output rows, a deblock
    (kernel = stride) maps a rank's rows onto its own rows, and the three
    laterals of backbone2d concatenate per rank;
  * ``conv2d_rows``: a conv on this rank's rows with halo rows from the
    neighbours (``halo_rows``), zeros only at the global edge;
  * ``conv_transpose_rows``: a deblock, local;
  * ``gather_rows``: the whole map, before decode reads it anywhere.

Usage::

    with spatial_sharding(group):
        dets = forward(params, points, num_points, cfg, True, device)

Outside the context every helper is a no-op (a rank owns every row), so
the model code stays single-device clean.  Inference only:
``halo_rows`` defines no gradient.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..config import BACKBONE2D_STAGES
from .collectives import all_gather_rows, halo_rows

_STATE = threading.local()
_NO_GROUP = object()

# rows of the BEV map per row of the coarsest level (product of the strides)
BEV_STRIDE = int(np.prod([stride for _u, _c, stride in BACKBONE2D_STAGES]))


def _current():
    return getattr(_STATE, "group", _NO_GROUP)


def active() -> bool:
    """Whether a ``spatial_sharding`` context is open."""
    return _current() is not _NO_GROUP


@contextlib.contextmanager
def spatial_sharding(group=None):
    """Shard one frame over ``group`` (None: the default process group)."""
    prev = _current()
    _STATE.group = group
    try:
        yield
    finally:
        if prev is _NO_GROUP:
            del _STATE.group
        else:
            _STATE.group = prev


def _rank_world() -> Tuple[int, int]:
    if not active():
        return 0, 1
    group = _current()
    return dist.get_rank(group), dist.get_world_size(group)


def row_range(n: int, rank: int, world: int) -> Tuple[int, int]:
    """Rank's rows [lo, hi) of n in a balanced split: each holds n // world
    rows, and the last n % world ranks one more (117 over 2: 58 / 59)."""
    base, extra = divmod(n, world)
    first_long = world - extra
    lo = rank * base + max(0, rank - first_long)
    return lo, lo + base + (1 if rank >= first_long else 0)


def row_counts(n: int) -> list:
    """Every rank's row count of ``row_range`` (the context's group)."""
    _rank, world = _rank_world()
    return [b - a for a, b in (row_range(n, r, world) for r in range(world))]


def my_rows(n: int) -> Tuple[int, int]:
    """This rank's [lo, hi) of n rows; (0, n) outside the context."""
    return row_range(n, *_rank_world())


def _per(n: int, scale: int) -> int:
    """Rows of a BEV level at ``scale`` per row of the coarsest level."""
    per = BEV_STRIDE // scale
    if n % per:
        raise ValueError(f"spatial sharding needs the BEV rows ({n}) at "
                         f"scale {scale} to be a multiple of {per}")
    return per


def bev_range(n: int, scale: int = 1) -> Tuple[int, int]:
    """This rank's rows of a BEV level of ``n`` rows whose rows are
    ``scale`` times the full map's stride (1: the full map; BEV_STRIDE:
    the coarsest level), nested as the module docstring says."""
    per = _per(n, scale)
    lo, hi = my_rows(n // per)
    return lo * per, hi * per


def gather_rows(x: torch.Tensor, n: int, scale: int = 1,
                dim: int = 0) -> torch.Tensor:
    """Every rank's ``bev_range`` rows of a BEV level of ``n`` rows at
    ``scale``, concatenated whole along ``dim`` (the counts follow from
    the split, so none is exchanged); a no-op outside the context."""
    if not active():
        return x
    per = _per(n, scale)
    return all_gather_rows(x, [c * per for c in row_counts(n // per)],
                           _current(), dim)


def gather_split(x: torch.Tensor, n: int, per_row: int = 1) -> torch.Tensor:
    """Every rank's rows of x, concatenated whole, where x holds this
    rank's items of ``row_range``'s split of n, each ``per_row`` rows."""
    if not active():
        return x
    return all_gather_rows(x, [c * per_row for c in row_counts(n)],
                           _current())


def conv2d_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int) -> torch.Tensor:
    """``F.conv2d(x, w, b, stride, padding=k//2)`` on this rank's rows.
    x: [1, C, h, W] (channels_last), this rank's rows of the input level;
    returns its rows of the output level.  Output rows [o, o + h/stride)
    read input rows [stride*o - k//2, stride*o + h + k//2 - stride], so
    the halo is k//2 rows above and k//2 - (stride - 1) (never fewer than
    0) below, the same on every rank; width keeps its k//2 padding."""
    k = w.shape[-1]
    pad = k // 2
    need_hi = max(0, pad - (stride - 1))
    hwc = x[0].permute(1, 2, 0)                    # [h, W, C]
    ext = halo_rows(hwc, pad, need_hi, _current())
    ext = ext.permute(2, 0, 1).unsqueeze(0)        # [1, C, h + halo, W]
    return F.conv2d(ext, w, b, stride=stride, padding=(0, pad))


def conv_transpose_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        k: int) -> torch.Tensor:
    """A deblock (``F.conv_transpose2d`` with kernel = stride = k, no
    padding) on this rank's rows: output rows [k*lo, k*hi) come from input
    rows [lo, hi) alone, so nothing is exchanged."""
    if tuple(w.shape[-2:]) != (k, k):
        raise ValueError(f"conv_transpose_rows: kernel {tuple(w.shape[-2:])}"
                         f" must equal the stride {k}")
    return F.conv_transpose2d(x, w, b, stride=k)
