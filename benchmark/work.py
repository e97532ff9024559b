"""Operations and bytes of the detector's work, from a configuration's
widths and a frame's counts, and the card's peaks.

Every count is of the work the model needs for the frame's inputs, not of
what an implementation does: products over live pillar rows and live sets
(``reference/counts.py``'s occupancy: kept points, pillars, live sets per
window spec), the dense BEV maps at their full size, and of the head, in
serving, the heatmap on the full map plus the regression branches at the
``top_k`` decoded cells only.  One multiply-add is 2 operations.
Normalisations, activations and softmax are left out (they are a few
percent of the products).  Bytes are those of each input read once and
each output written once, at the cell's activation width (2 bytes at
bf16, 4 at fp32), weights once.

Peaks: one H100 SXM, NVIDIA's data sheet, dense: 989 TFLOP/s bf16,
67 TFLOP/s fp32 off the tensor cores, 3.35 TB/s of HBM.
"""

from __future__ import annotations

from typing import Sequence

PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
PEAK_BYTES = 3.35e12
BEV_STAGES = ((2, 128, 1), (3, 128, 2), (3, 256, 2))
BEV_DEBLOCKS = (1, 2, 4)
LATERAL = 128


def conv_flops(h: int, w: int, k: int, cin: int, cout: int) -> float:
    """A k x k convolution producing an h x w map."""
    return 2.0 * h * w * k * k * cin * cout


def resnet_flops(cfg) -> float:
    """The BEV ResNet and its laterals, on the full map."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    total, cin, h, w = 0.0, cfg.d_model, H, W
    for (units, ch, stride), k in zip(BEV_STAGES, BEV_DEBLOCKS):
        for u in range(units):
            if u == 0:
                h, w = -(-h // stride), -(-w // stride)
                total += conv_flops(h, w, 3, cin, ch)          # conv1
                total += conv_flops(h, w, 1, cin, ch)          # downsample
            else:
                total += conv_flops(h, w, 3, ch, ch)
            total += conv_flops(h, w, 3, ch, ch)               # conv2
        cin = ch
        # a k x k transposed conv of stride k: one tap an output cell
        total += 2.0 * (h * k) * (w * k) * ch * LATERAL
    return total


def head_flops(cfg, full: bool) -> float:
    """CenterHead: the shared conv and the heatmap branch on the full map;
    the regression branches on the full map (``full``, training) or at the
    ``top_k`` decoded cells (serving: a 3 x 3 hidden patch a cell)."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    hs, hc = cfg.head_shared_channels, cfg.head_conv_channels
    total = conv_flops(H, W, 3, LATERAL * len(BEV_DEBLOCKS), hs)
    total += conv_flops(H, W, 3, hs, hc) + conv_flops(H, W, 3, hc,
                                                      cfg.num_classes)
    reg = [2, 1, 3, 2, 1]       # center, center_z, dim, rot, iou
    for c in reg:
        if full:
            total += conv_flops(H, W, 3, hs, hc) + conv_flops(H, W, 3, hc, c)
        else:
            total += cfg.top_k * (2.0 * 9 * 9 * hs * hc + 2.0 * 9 * hc * c)
    return total


def vfe_flops(cfg, kept: int) -> float:
    c0, c1 = cfg.pfn_channels
    return 2.0 * kept * (cfg.pillar_feature_num * c0 + 2 * c0 * c1)


def encoder_flops(cfg, pillars: int) -> float:
    """One encoder pass on the live pillar rows, attention excluded: the
    position-embedding MLP, the q/k/v and out projections, the FFN."""
    C, F = cfg.d_model, cfg.ffn_dim
    return 2.0 * pillars * (2 * C + C * C + 4 * C * C + 2 * C * F)


def attention_flops(cfg, sets: int) -> float:
    """Q K^T and P V of one encoder pass over ``sets`` live sets."""
    K = cfg.set_size
    return 4.0 * sets * K * K * cfg.d_model


def passes(cfg, occ: Sequence[int]):
    """Live sets of each encoder pass: block b uses spec b % n_specs."""
    specs = len(cfg.window_specs)
    return [occ[2 + b % specs] for b in range(cfg.num_blocks) for _ in (0, 1)]


def frame_flops(cfg, occ: Sequence[int], train: bool = False) -> float:
    """Operations of one frame's forward; ``train``: forward and backward
    (3 x the forward) with every head branch on the full map."""
    kept, pillars = occ[0], occ[1]
    total = vfe_flops(cfg, kept) + resnet_flops(cfg) + head_flops(cfg, train)
    for sets in passes(cfg, occ):
        total += encoder_flops(cfg, pillars) + attention_flops(cfg, sets)
    return 3.0 * total if train else total


def set_attention_seconds(cfg, occ: Sequence[int], width: int) -> float:
    """Least time of a frame's set attention (every pass): the live sets'
    q, k and v read once and the output written once, or the products,
    whichever takes longer."""
    K, C = cfg.set_size, cfg.d_model
    total = 0.0
    for sets in passes(cfg, occ):
        moved = sets * K * (3 * C + C) * width
        total += max(moved / PEAK_BYTES,
                     attention_flops(cfg, sets) / PEAK_FLOPS["bf16"])
    return total


def encoder_epilogue_seconds(cfg, occ: Sequence[int], width: int) -> float:
    """Least time of a frame's encoder epilogues (every pass): on the live
    pillar rows, the residual and the attention output read and the result
    written once, the weights of the out-projection and FFN once; the
    out-projection and FFN products."""
    C, F, P = cfg.d_model, cfg.ffn_dim, occ[1]
    weights = (C * C + 2 * C * F) * width + (3 * C + F + 6 * C) * 4
    moved = 3 * P * C * width + weights
    ops = 2.0 * P * (C * C + 2 * C * F)
    n = 2 * cfg.num_blocks
    return n * max(moved / PEAK_BYTES, ops / PEAK_FLOPS["bf16"])
