"""Operations and bytes of the voxel model's work (``reference/voxel.py``),
from its configuration's widths and a frame's counts
(``reference/voxel_counts.py``: kept points, each stage's voxels, the live
sets of each set partition a stage reads), as ``work.py`` counts the
pillar model's: products over live voxel rows and live sets, the BEV
ResNet and head at their full size, one multiply-add 2 operations; bytes
of each input read once and each output written once at 2 bytes (bf16),
weights once.  What implements the work does not enter."""

from __future__ import annotations

from typing import Iterator, Sequence, Tuple

from .work import PEAK_BYTES, PEAK_FLOPS, head_flops, resnet_flops, vfe_flops


def _sets_index(cfg):
    """(stage, window partition) -> position of its live sets in the
    occupancy."""
    out, k = {}, 1 + len(cfg.stages)
    for s in range(len(cfg.stages)):
        for i in cfg.used(s):
            out[(s, i)] = k
            k += 1
    return out


def passes(cfg, occ: Sequence[int]) -> Iterator[Tuple[int, int, int]]:
    """(stage, voxels, live sets) of every encoder pass: global block b of
    stage s attends in the sets of partition b % 2, two passes a block."""
    index = _sets_index(cfg)
    for s, ids in enumerate(cfg.stage_blocks()):
        n = len(cfg.stages[s].windows)
        for b in ids:
            for _e in (0, 1):
                yield s, occ[1 + s], occ[index[(s, b % n)]]


def transitions(cfg, occ: Sequence[int]) -> Iterator[Tuple[int, int, int]]:
    """(children, parents, slots a parent) of every pooling."""
    for s, st in enumerate(cfg.stages[:-1]):
        yield occ[1 + s], occ[2 + s], st.volume


def encoder_flops(cfg, voxels: int, in_dim: int) -> float:
    """One encoder pass on a stage's live voxel rows, attention excluded:
    the position-embedding MLP (``in_dim`` inputs), the q/k/v and out
    projections, the FFN."""
    C, F = cfg.d_model, cfg.ffn_dim
    return 2.0 * voxels * (in_dim * C + C * C + 4 * C * C + 2 * C * F)


def attention_flops(cfg, sets: int, K: int) -> float:
    return 4.0 * sets * K * K * cfg.d_model


def pool_flops(cfg, children: int, parents: int, volume: int) -> float:
    """One pooling: the query projection of the parents' max, the key and
    value projections of the children, one query against its slots, the
    out-projection."""
    C = cfg.d_model
    return (2.0 * parents * C * C + 2.0 * children * 2 * C * C
            + 4.0 * parents * volume * C + 2.0 * parents * C * C)


def frame_flops(cfg, occ: Sequence[int]) -> float:
    """Operations of one served frame's forward."""
    total = vfe_flops(cfg, occ[0]) + resnet_flops(cfg) + head_flops(cfg, False)
    for s, voxels, sets in passes(cfg, occ):
        st = cfg.stages[s]
        in_dim = 3 if st.sparse_shape[2] > 1 else 2
        total += encoder_flops(cfg, voxels, in_dim)
        total += attention_flops(cfg, sets, st.set_size)
    for children, parents, volume in transitions(cfg, occ):
        total += pool_flops(cfg, children, parents, volume)
    return total


def set_attention_seconds(cfg, occ: Sequence[int], width: int = 2) -> float:
    """Least time of a frame's set attention (every pass): the live sets'
    q, k and v read once and the output written once, or the products."""
    C, total = cfg.d_model, 0.0
    for s, _voxels, sets in passes(cfg, occ):
        K = cfg.stages[s].set_size
        moved = sets * K * (3 * C + C) * width
        total += max(moved / PEAK_BYTES,
                     attention_flops(cfg, sets, K) / PEAK_FLOPS["bf16"])
    return total


def encoder_epilogue_seconds(cfg, occ: Sequence[int], width: int = 2
                             ) -> float:
    """Least time of a frame's encoder epilogues (every pass) on its stage's
    live voxel rows, as ``work.encoder_epilogue_seconds``."""
    C, F = cfg.d_model, cfg.ffn_dim
    weights = (C * C + 2 * C * F) * width + (3 * C + F + 6 * C) * 4
    total = 0.0
    for _s, voxels, _sets in passes(cfg, occ):
        moved = 3 * voxels * C * width + weights
        ops = 2.0 * voxels * (C * C + 2 * C * F)
        total += max(moved / PEAK_BYTES, ops / PEAK_FLOPS["bf16"])
    return total


def stage_pool_seconds(cfg, occ: Sequence[int], width: int = 2) -> float:
    """Least time of a frame's pooling attentions: the children's key and
    value rows, the parents' query rows and output rows each moved once,
    or the products of one query against its slots."""
    C, total = cfg.d_model, 0.0
    for children, parents, volume in transitions(cfg, occ):
        moved = (children * 2 * C + 2 * parents * C) * width
        total += max(moved / PEAK_BYTES,
                     4.0 * parents * volume * C / PEAK_FLOPS["bf16"])
    return total
