"""The CenterPoint loss and AdamW, plain float32, and the reference's first
training steps.

Loss of one frame (CenterPoint, with the port's weights): the
penalty-reduced focal loss of the class heatmap, plus 0.25 x the L1 of
the regression maps (centre 2, z 1, log-dims 3, rot cos/sin 2) over the
supervised cells, plus 0.25 x a double-angle L1 of the rot vector, plus
0.25 x a bounded direction term 1 - v.t / max(|v|, 1).  A batch's loss is
the mean over its frames.  AdamW as optax.adamw: one update count, bias
corrections, decoupled weight decay on every leaf; a leaf that gets no
gradient (the iou branch, which no loss term reads) takes a zero one.
The steps start from a fresh optimizer, or from a state that the caller
hands over (the program's after its window: the one step that follows it).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from .config import Config
from .detector import float_stages, integer_stages
from .weights import leaves


def _at_least(x, lo):
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype, device=x.device))


def focal_loss(logits, target, alpha=2.0, beta=4.0):
    pred = torch.minimum(_at_least(torch.sigmoid(logits), 1e-6),
                         torch.full((), 1 - 1e-6, device=logits.device))
    pos = (target >= 0.999).float()
    pos_loss = -torch.log(pred) * (1 - pred) ** alpha * pos
    neg_loss = -torch.log(1 - pred) * pred ** alpha * (1 - target) ** beta \
        * (1 - pos)
    return (pos_loss.sum() + neg_loss.sum()) / _at_least(pos.sum(), 1.0)


def frame_loss(maps: Dict[str, torch.Tensor], heatmap, reg, mask,
               dir_weight=0.25, aux_weight=0.25):
    hm_loss = focal_loss(maps["hm"], heatmap)
    pred = torch.cat([maps["center"], maps["center_z"], maps["dim"],
                      maps["rot"]], -1)
    m = mask[..., None]
    reg_loss = torch.sum(torch.abs(pred - reg) * m) / _at_least(
        torch.sum(m) * pred.shape[-1], 1.0)
    c, s = maps["rot"][..., 0], maps["rot"][..., 1]
    tc, ts = reg[..., 6], reg[..., 7]
    aux = (torch.abs(c * c - s * s - (tc * tc - ts * ts))
           + torch.abs(2.0 * c * s - 2.0 * tc * ts)) * mask
    aux_loss = torch.sum(aux) / _at_least(torch.sum(mask) * 2, 1.0)
    norm = _at_least(torch.sqrt(c * c + s * s + 1e-12), 1.0)
    dir_loss = torch.sum((1.0 - (c * tc + s * ts) / norm) * mask) / _at_least(
        torch.sum(mask), 1.0)
    return hm_loss + 0.25 * reg_loss + aux_weight * aux_loss \
        + dir_weight * dir_loss


def batch_loss(params, batch, cfg: Config, quant):
    """Mean loss of a batch: (points [B, N, 4], counts [B], heatmap, reg,
    mask, each with a leading B)."""
    points, counts, heatmap, reg, mask = batch
    losses = []
    for b in range(points.shape[0]):
        pl, sets = integer_stages(points[b], int(counts[b]), cfg)
        maps = float_stages(params, pl, sets, cfg, quant)
        losses.append(frame_loss(maps, heatmap[b], reg[b], mask[b]))
    return torch.stack(losses).mean()


class AdamW:
    """optax.adamw(lr, b1, b2, eps, weight_decay) on a list of leaves."""

    def __init__(self, tensors: List[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4):
        self.tensors, self.lr, self.eps, self.wd = tensors, lr, eps, weight_decay
        self.b1, self.b2 = betas
        self.mu = [torch.zeros_like(t) for t in tensors]
        self.nu = [torch.zeros_like(t) for t in tensors]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.count += 1
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for t, g, m, v in zip(self.tensors, grads, self.mu, self.nu):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            t.sub_(self.lr * ((m / c1) / (torch.sqrt(v / c2) + self.eps)
                              + self.wd * t))


def first_steps(params, batches, cfg: Config, lr: float, quant, state=None):
    """Train ``params`` (the folded dict, changed in place) for one step a
    batch, from AdamW's ``state`` (mu and nu by leaf, and the update count)
    or, by default, a fresh one.  Returns {"loss": [per step], "grad":
    {leaf: |g| of the first step}, "change": {leaf: |p_end - p_start|},
    "state": (the parameters, mu and nu by leaf, the count) at the end}."""
    named = list(leaves(params))
    start = [t.detach().clone() for _, t in named]
    for _, t in named:
        t.requires_grad_(True)
    opt = AdamW([t for _, t in named], lr)
    if state is not None:
        mu, nu, opt.count = state
        opt.mu = [mu[p].clone() for p, _ in named]
        opt.nu = [nu[p].clone() for p, _ in named]
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        loss = batch_loss(params, batch, cfg, quant)
        grads = torch.autograd.grad(loss, [t for _, t in named],
                                    allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for (_, t), g in zip(named, grads)]
        if i == 0:
            grad_norms = {p: float(torch.linalg.vector_norm(g.double()))
                          for (p, _), g in zip(named, grads)}
        opt.step(grads)
        losses.append(float(loss.detach()))
        del loss, grads
    change = {p: float(torch.linalg.vector_norm((t.detach() - s).double()))
              for (p, t), s in zip(named, start)}
    state = ({p: t.detach().clone() for p, t in named},
             dict(zip((p for p, _ in named), opt.mu)),
             dict(zip((p for p, _ in named), opt.nu)), opt.count)
    return {"loss": losses, "grad": grad_norms, "change": change,
            "state": state}
