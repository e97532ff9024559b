"""Box decoding: sigmoid / top-k / gather / decode + score filtering.

Port of the JAX package's ops/postprocess.py.  Top-k is exact: ``lax.top_k``
breaks ties by the lower index and ``torch.topk`` promises no order, so
every top-k here is ``torch.sort(descending=True, stable=True)[:K]``.
``cfg.approx_topk`` (the TPU's ``approx_max_k``) has no PyTorch analogue;
the port runs exact top-k whatever it says.

Heading decode: ``atan2(sin, cos)`` by default; ``cfg.parity_atan`` gives
the reference's ``atan(sin/cos)``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..config import DSVTConfig, head_branches


class Detections(NamedTuple):
    """boxes: [K, 9] = (x, y, z, dx, dy, dz, heading, class, score); rows
    past ``count`` are zero.  occupancy: [2 + n_window_specs] = (kept
    points, pillars, sets per window spec), filled by model.detector.forward
    so the runtime can flag cap saturation; None elsewhere."""

    boxes: torch.Tensor
    count: torch.Tensor
    occupancy: torch.Tensor = None


def _top_k(x: torch.Tensor, k: int):
    """Exact top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _im2col_slots(device) -> torch.Tensor:
    """[3, 3, 9] im2col of the 3x3 hidden positions over the 5x5 patch:
    tap p at hidden offset (a, b) reads flat slot (a + p//3)*5 + (b + p%3).
    Made on the device by factories, so no host data is copied."""
    r3 = torch.arange(3, device=device)
    p = torch.arange(9, device=device)
    return (r3[:, None, None] * 5 + r3[None, :, None]
            + ((p // 3) * 5 + p % 3)[None, None, :])


def decode_lazy_branches(shared: torch.Tensor, inds: torch.Tensor,
                         head_params: Dict, branches,
                         precision: str = "fp32") -> Dict[str, torch.Tensor]:
    """Evaluate the regression branches at the selected cells only.

    Each branch is conv3x3(64->64)+ReLU then conv3x3(64->c) on the shared
    map (a 5x5 receptive field), so one [K, 5, 5, 64] patch gather plus two
    small products per branch gives the full conv stack's values at those
    cells.  shared: [H, W, C]; inds: [K] flat cell index.  Conv weights are
    OIHW (the port's layout); products take bf16-rounded inputs at bf16 and
    accumulate in f32, as the JAX einsums do.
    """
    H, W, C = shared.shape
    dev = shared.device
    dt = torch.bfloat16 if precision == "bf16" else torch.float32
    ys = inds // W
    xs = inds % W

    off = torch.arange(-2, 3, device=dev)
    py = ys[:, None] + off.repeat_interleave(5)[None, :]           # [K, 25]
    px = xs[:, None] + off.repeat(5)[None, :]
    inb = (py >= 0) & (py < H) & (px >= 0) & (px < W)   # off-map reads are 0
    patch = shared[py.clamp(0, H - 1), px.clamp(0, W - 1)]          # [K,25,C]
    patch = torch.where(inb[..., None], patch, torch.zeros_like(patch))
    p2 = patch.to(dt).float()[:, _im2col_slots(dev)]              # [K,3,3,9,C]

    names = [n for n, _ in branches if n != "hm"]
    # OIHW [64, C, 3, 3] -> [9, C, 64] (tap p = dy*3 + dx)
    w0 = torch.stack([head_params[n]["w0"].permute(2, 3, 1, 0).reshape(9, C, -1)
                      for n in names]).to(dt).float()
    b0 = torch.stack([head_params[n]["b0"] for n in names])
    h1 = torch.einsum("kyxpi,bpic->kyxbc", p2, w0) + b0
    h1 = torch.clamp(h1, min=0.0).to(dt).float()                  # [K,3,3,B,64]

    # hidden positions off the map are ZERO (the full conv's padding)
    o3 = torch.arange(-1, 2, device=dev)
    hy = ys[:, None] + o3[None, :]
    hx = xs[:, None] + o3[None, :]
    in_map = (((hy >= 0) & (hy < H))[:, :, None]
              & ((hx >= 0) & (hx < W))[:, None, :])
    h1 = torch.where(in_map[..., None, None], h1, torch.zeros_like(h1))

    out = {}
    for b, name in enumerate(names):
        w1 = head_params[name]["w1"].permute(2, 3, 1, 0).to(dt).float()  # HWIO
        out[name] = torch.einsum("kyxc,yxcd->kd", h1[:, :, :, b], w1) \
            + head_params[name]["b1"]
    return out


def decode_and_filter(head_out: Dict[str, torch.Tensor], cfg: DSVTConfig,
                      head_params: Dict = None) -> Detections:
    """head_out: {"hm": [H, W, ncls], ...} (full maps, or lazy with
    "shared") -> score-filtered, score-ordered Detections."""
    H, W = head_out["hm"].shape[:2]
    K = cfg.top_k
    ncls = cfg.num_classes
    vx, vy, _vz = cfg.voxel_size
    xmin, ymin, zmin = cfg.pc_range_min
    xmax, ymax, zmax = cfg.pc_range_max

    lazy = "shared" in head_out
    hm = torch.sigmoid(head_out["hm"].float()).permute(2, 0, 1).reshape(
        ncls, H * W)

    # per-class top-k, then global top-k
    cls_scores, cls_inds = _top_k(hm, K)                          # [ncls, K]
    scores, sel = _top_k(cls_scores.reshape(ncls * K), K)         # [K]
    classes = sel // K
    inds = cls_inds.reshape(ncls * K)[sel]
    ys = (inds // W).float()
    xs = (inds % W).float()

    if lazy:
        vals = decode_lazy_branches(head_out["shared"], inds, head_params,
                                    head_branches(cfg), cfg.precision)

        def gather(name):
            return vals[name].float()
    else:
        def gather(name):
            m = head_out[name].float()
            return m.reshape(H * W, m.shape[-1])[inds]

    center = gather("center")
    center_z = gather("center_z")[:, 0]
    dim = torch.exp(gather("dim"))
    rot = gather("rot")
    rot_cos, rot_sin = rot[:, 0], rot[:, 1]
    if cfg.parity_atan:
        heading = torch.atan(rot_sin / rot_cos)
    else:
        heading = torch.atan2(rot_sin, rot_cos)

    x = (xs + center[:, 0]) * vx + xmin
    y = (ys + center[:, 1]) * vy + ymin
    in_range = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax)
                & (center_z >= zmin) & (center_z < zmax))
    keep = in_range & (scores >= cfg.score_threshold)

    boxes = torch.stack([x, y, center_z, dim[:, 0], dim[:, 1], dim[:, 2],
                         heading, classes.float(), scores], dim=-1)
    boxes = torch.where(keep[:, None], boxes, torch.zeros_like(boxes))
    # stable compaction: kept rows first, in score order
    order = torch.sort(torch.where(keep, 0, 1), stable=True).indices
    return Detections(boxes=boxes[order], count=keep.long().sum())
