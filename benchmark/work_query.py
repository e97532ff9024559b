"""Operations and bytes of the TransFusion-L configuration's work
(``reference/transfusion.py``), from its widths, the map's size and a
frame's counts, as ``work.py`` counts the CenterHead model's: the shared
front half (VFE, encoders, BEV ResNet) is ``work.py``'s; the head is the
shared conv and the heatmap convs on the full map, the queries' decoder
and branches, and the cross-attention over every cell: the key and value
projections of L + Pk and Q.K^T and P.V.  The key position embedding Pk
is fixed by the grid (a weight, derived once) and not counted; nor are the
proposal selection, normalisations, activations and softmax.  One
multiply-add is 2 operations; bytes of each input read once and each
output written once at 2 bytes (bf16), weights once.  What implements the
work does not enter."""

from __future__ import annotations

from typing import Sequence

from .work import (BEV_DEBLOCKS, LATERAL, PEAK_BYTES, PEAK_FLOPS, conv_flops,
                   frame_flops as pillar_frame_flops, head_flops)


def cells(cfg) -> int:
    return cfg.grid_size[0] * cfg.grid_size[1]


def query_attention_flops(cfg) -> float:
    """The cross-attention: k | v projections of every cell (2·C·2C each),
    Q.K^T and P.V (2·C each a (query, cell))."""
    C, N = cfg.query_channels, cells(cfg)
    return 4.0 * N * C * C + 4.0 * cfg.num_proposals * N * C


def query_attention_bytes(cfg) -> float:
    """L and Pk read once, the queries read and the output written once,
    the k | v weights (bf16) and biases (f32) once."""
    C, N, Q = cfg.query_channels, cells(cfg), cfg.num_proposals
    return (2 * N * C + 2 * Q * C + 2 * C * C) * 2 + 2 * C * 4


def query_attention_seconds(cfg) -> float:
    """Least time of one frame's cross-attention on the card."""
    return max(query_attention_bytes(cfg) / PEAK_BYTES,
               query_attention_flops(cfg) / PEAK_FLOPS["bf16"])


def decoder_flops(cfg) -> float:
    """The 200-row work: the class encoding, the query position embedding,
    the self-attention (projections, Q.K^T, P.V), the cross-attention's
    query and out projections, the FFN, the branches."""
    C, F, B, Q = (cfg.query_channels, cfg.query_ffn_dim,
                  cfg.query_branch_channels, cfg.num_proposals)
    outs = 2 + 1 + 3 + 2 + 2 + cfg.num_classes
    return 2.0 * Q * (cfg.num_classes * C + 2 * C + C * C      # class, pos
                      + 4 * C * C + 2 * Q * C                  # self-attn
                      + 2 * C * C                              # cross q, out
                      + 2 * C * F                              # FFN
                      + 6 * C * B + B * outs)                  # branches


def query_head_flops(cfg) -> float:
    """One frame's head: the shared conv 384 -> C and the heatmap convs on
    the full map, the decoder and branches, the cross-attention."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    C = cfg.query_channels
    dense = (conv_flops(H, W, 3, LATERAL * len(BEV_DEBLOCKS), C)
             + conv_flops(H, W, 3, C, C)
             + conv_flops(H, W, 3, C, cfg.num_classes))
    return dense + decoder_flops(cfg) + query_attention_flops(cfg)


def frame_flops(cfg, occ: Sequence[int]) -> float:
    """Operations of one served frame: ``work.py``'s front half, this
    head in place of the CenterHead."""
    return (pillar_frame_flops(cfg, occ) - head_flops(cfg, False)
            + query_head_flops(cfg))
