"""Training step for the DSVT detector (port of the JAX package's
parallel/training.py).

The loss follows CenterPoint: penalty-reduced focal loss on the class
heatmap, L1 on the regression maps over each box's footprint, a double-angle
auxiliary term and a bounded 1 - cos direction term (``detection_loss``; the
JAX module's comments give the measurements behind each).  It is computed
on ``model.detector.forward_train``: the plain paths, since the JAX
package's kernels, and so the port's B1-B3, define no backward.  No
hand-written kernel runs in a training step.

``make_train_step`` defaults to ``torch.optim.AdamW(lr=1e-4,
weight_decay=1e-4, eps=1e-8)``, which is ``optax.adamw(1e-4)``: both decay
every leaf, and a leaf that gets no gradient (the unused iou branch) is
given a zero one so that it is decayed and its moments kept, as optax does.
After each update ``weights.refold`` remakes the derived encoder weights,
which the inference path reads.  ``save_train_state`` writes the JAX
package's npz (``p:`` params with HWIO convs, ``o:[0].count/mu/nu``, then
``step``), so a checkpoint moves between the packages both ways.

Frames of a batch run one after another (the forward has data-dependent
shapes).  ``remat`` (on by default on the card, as JAX's follows its
backend) wraps each frame's float stages in ``torch.utils.checkpoint``; the
integer stages run before it and carry no gradient, so the recomputation
reads the same partitions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..config import DSVTConfig
from ..model.detector import float_stages, forward_train, partition_frame
from ..ops.common import resolve_device
from ..weights import (keystr, named_leaves, refold, to_numpy_leaf,
                       to_torch_leaf, trainable)


class Targets(NamedTuple):
    """Dense CenterPoint targets, one frame or a batch (leading dim).

    heatmap:  [H, W, ncls] gaussians in [0, 1].
    reg:      [H, W, 8] = (center 2, center_z 1, dim(log) 3, rot 2).
    mask:     [H, W] 1.0 on supervised cells.
    """

    heatmap: torch.Tensor
    reg: torch.Tensor
    mask: torch.Tensor


def _at_least(x: torch.Tensor, lo: float) -> torch.Tensor:
    """``jnp.maximum(x, lo)``, its tie gradient included (ops.common.relu)."""
    return torch.maximum(x, torch.full((), lo, dtype=x.dtype))


def focal_loss(pred_logits: torch.Tensor, target: torch.Tensor,
               alpha: float = 2.0, beta: float = 4.0) -> torch.Tensor:
    """Penalty-reduced pixelwise focal loss (CornerNet/CenterPoint)."""
    pred = torch.sigmoid(pred_logits)
    # jnp.clip: maximum, then minimum
    pred = torch.minimum(_at_least(pred, 1e-6),
                         torch.full((), 1 - 1e-6, dtype=pred.dtype))
    pos = (target >= 0.999).to(pred.dtype)
    pos_loss = -torch.log(pred) * (1 - pred) ** alpha * pos
    neg_loss = (-torch.log(1 - pred) * pred ** alpha
                * (1 - target) ** beta * (1 - pos))
    num_pos = _at_least(pos.sum(), 1.0)
    return (pos_loss.sum() + neg_loss.sum()) / num_pos


def head_loss(out: dict, targets: Targets, dir_weight: float = 0.25,
              aux_weight: float = 0.25) -> torch.Tensor:
    """The loss of one frame's full head maps (``detection_loss``)."""
    hm_loss = focal_loss(out["hm"], targets.heatmap)
    reg_pred = torch.cat(
        [out["center"], out["center_z"], out["dim"], out["rot"]], dim=-1)
    m = targets.mask[..., None]
    reg_loss = torch.sum(torch.abs(reg_pred - targets.reg) * m) / _at_least(
        torch.sum(m) * reg_pred.shape[-1], 1.0)
    # double-angle auxiliary on the rot vector: L1 of (c^2-s^2, 2cs) against
    # (cos 2t, sin 2t), which maps both modes of the pi ambiguity to one
    # target
    c, s = out["rot"][..., 0], out["rot"][..., 1]
    tc, ts = targets.reg[..., 6], targets.reg[..., 7]
    aux = (torch.abs(c * c - s * s - (tc * tc - ts * ts))
           + torch.abs(2.0 * c * s - 2.0 * tc * ts)) * targets.mask
    aux_loss = torch.sum(aux) / _at_least(torch.sum(targets.mask) * 2, 1.0)
    # direction: 1 - v.t / max(|v|, 1), bounded, so the pi-flipped vector
    # is no local minimum
    norm = _at_least(torch.sqrt(c * c + s * s + 1e-12), 1.0)
    dir_cos = (c * tc + s * ts) / norm
    dir_loss = torch.sum((1.0 - dir_cos) * targets.mask) / _at_least(
        torch.sum(targets.mask), 1.0)
    return (hm_loss + 0.25 * reg_loss + aux_weight * aux_loss
            + dir_weight * dir_loss)


def detection_loss(params, points, num_points, targets: Targets,
                   cfg: DSVTConfig, dir_weight: float = 0.25,
                   aux_weight: float = 0.25, device="cuda") -> torch.Tensor:
    """The loss of one frame (``forward_train``'s head maps)."""
    out = forward_train(params, points, num_points, cfg, device).head_out
    return head_loss(out, targets, dir_weight, aux_weight)


def batched_loss(params, points, num_points, targets: Targets,
                 cfg: DSVTConfig, remat: Optional[bool] = None,
                 dir_weight: float = 0.25, aux_weight: float = 0.25,
                 device="cuda") -> torch.Tensor:
    """Mean of the per-frame losses of a batch (points [B, max_points, 4],
    num_points [B], targets with a leading B), frames one after another.
    ``remat`` (default: on the card) recomputes each frame's float stages
    in the backward instead of keeping their activations."""
    device = resolve_device(device)
    if remat is None:
        remat = device.type == "cuda"

    def frame_loss(pillars, wparts, sparts, frame_targets):
        out = float_stages(params, pillars, wparts, sparts, cfg,
                           live_weights=True).head_out
        return head_loss(out, frame_targets, dir_weight, aux_weight)

    losses = []
    for b in range(len(points)):
        # the arguments, not a closure, carry each frame's partitions: the
        # recomputation runs after the loop
        args = (*partition_frame(params, points[b], num_points[b], cfg,
                                 device), Targets(*(t[b] for t in targets)))
        losses.append(checkpoint(frame_loss, *args, use_reentrant=False)
                      if remat else frame_loss(*args))
    return torch.stack(losses).mean()


def default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adamw(1e-4)``: lr 1e-4, betas (0.9, 0.999), eps 1e-8, decay
    1e-4 on every leaf (torch's AdamW decays at 1e-2 unless told)."""
    return torch.optim.AdamW(trainable(params), lr=1e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def clip_by_global_norm(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm``, in place: every gradient scaled by
    max_norm / |g| when the global norm |g| >= max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``), else left as it is."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def make_train_step(cfg: DSVTConfig, params, optimizer=None,
                    dir_weight: float = 0.25, aux_weight: float = 0.25,
                    max_grad_norm: Optional[float] = None,
                    remat: Optional[bool] = None, device="cuda"):
    """Returns (optimizer, train_step).  ``params`` (``weights.
    from_jax_params`` on ``device``) are updated in place: their
    ``trainable`` leaves get ``requires_grad``, and ``optimizer`` (default
    ``default_optimizer``) must hold exactly those.  ``train_step(points,
    num_points, targets)`` computes ``batched_loss``, its gradients (clipped
    to ``max_grad_norm`` when given), takes one optimizer step, refolds the
    derived weights and returns the loss (detached; reading it waits for
    the card)."""
    device = resolve_device(device)
    leaves = trainable(params)
    for t in leaves:
        t.requires_grad_(True)
    optimizer = optimizer or default_optimizer(params)

    def train_step(points, num_points, targets: Targets) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = batched_loss(params, points, num_points, targets, cfg,
                            remat=remat, dir_weight=dir_weight,
                            aux_weight=aux_weight, device=device)
        loss.backward()
        for t in leaves:             # unused leaves: zero, as in optax
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        if max_grad_norm is not None:
            clip_by_global_norm([t.grad for t in leaves], max_grad_norm)
        optimizer.step()
        refold(params)
        return loss.detach()

    return optimizer, train_step


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int
                  ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    decay_steps)`` as a function of the update count (read before the
    update, so update 0 runs at lr 0); for ``LambdaLR``, divide by lr."""
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return lr * count / warmup_steps
        if cosine_steps <= 0:
            return lr
        done = min(count - warmup_steps, cosine_steps)
        return lr * 0.5 * (1 + np.cos(np.pi * done / cosine_steps))

    return schedule


# ---------------------------------------------------------------------------
# Train state in the JAX package's npz format
# ---------------------------------------------------------------------------


def save_train_state(path: str, params, optimizer, step: int = 0) -> str:
    """Checkpoint the trainable leaves and the AdamW state as the JAX
    package's ``save_train_state`` writes ``optax.adamw``'s: ``p:<path>``
    per leaf (convs HWIO), ``o:[0].count`` (int32), ``o:[0].mu<path>`` and
    ``o:[0].nu<path>`` (AdamW's exp_avg and exp_avg_sq, zero before the
    first step), then ``step``.  Returns the file path (``.npz`` appended
    when missing)."""
    named = named_leaves(params)
    count = 0
    flat = {}
    for p, t in named:
        flat[f"p:{keystr(p)}"] = to_numpy_leaf(p, t)
    for p, t in named:
        state = optimizer.state.get(t, {})
        if state:
            count = int(state["step"])
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            moment = state.get(key, torch.zeros_like(t))
            flat[f"o:[0].{slot}{keystr(p)}"] = to_numpy_leaf(p, moment)
    flat["o:[0].count"] = np.int32(count)
    flat["step"] = np.int64(step)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **flat)
    return path


def load_train_state(path: str, params, optimizer) -> int:
    """Restore a ``save_train_state`` file (either package's) into
    ``params`` and ``optimizer``'s state, in place, refold; returns the
    step."""
    data = np.load(path)
    count = int(data["o:[0].count"])

    def tensor(key, p, like):
        out = to_torch_leaf(p, data[key], like.device)
        if out.shape != like.shape:
            raise ValueError(f"{path}: {key} has shape {tuple(out.shape)} "
                             f"(convs as OIHW), the model's is "
                             f"{tuple(like.shape)}")
        return out

    with torch.no_grad():
        for p, t in named_leaves(params):
            t.copy_(tensor(f"p:{keystr(p)}", p, t))
            optimizer.state[t] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": tensor(f"o:[0].mu{keystr(p)}", p, t),
                "exp_avg_sq": tensor(f"o:[0].nu{keystr(p)}", p, t)}
    refold(params)
    return int(data["step"])


def random_targets(rng, cfg: DSVTConfig, batch: int,
                   device="cuda") -> Targets:
    """Synthetic targets for smoke runs (the JAX draws), on ``device``."""
    device = resolve_device(device)
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    hm = np.zeros((batch, H, W, cfg.num_classes), np.float32)
    reg = np.zeros((batch, H, W, 8), np.float32)
    mask = np.zeros((batch, H, W), np.float32)
    for b in range(batch):
        for _ in range(5):
            y, x = rng.integers(2, H - 2), rng.integers(2, W - 2)
            c = rng.integers(0, cfg.num_classes)
            hm[b, y, x, c] = 1.0
            hm[b, y - 1:y + 2, x - 1:x + 2, c] = np.maximum(
                hm[b, y - 1:y + 2, x - 1:x + 2, c], 0.5)
            hm[b, y, x, c] = 1.0
            mask[b, y, x] = 1.0
            reg[b, y, x] = rng.normal(0, 0.3, 8)
    return Targets(*(torch.from_numpy(a).to(device) for a in (hm, reg, mask)))
