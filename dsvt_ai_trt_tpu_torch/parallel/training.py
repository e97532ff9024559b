"""Training step for the DSVT detector (port of the JAX package's
parallel/training.py).

The loss follows CenterPoint: penalty-reduced focal loss on the class
heatmap, L1 on the regression maps over each box's footprint, a double-angle
auxiliary term and a bounded 1 - cos direction term (``detection_loss``; the
JAX module's comments give the measurements behind each).  It is computed
on ``model.detector.forward_train``: the plain paths, since the JAX
package's kernels, and so the port's B1-B3, define no backward.  No
hand-written kernel runs in a training step.

``make_train_step`` defaults to ``AdamW(lr=1e-4)``, this module's
``optax.adamw(1e-4)`` written in tensor ops: one update count on the
device for every leaf (optax's ``count``), the learning rate a float or a
function of that count (``warmup_cosine``), so that a step reads nothing
back to the host.  It decays every leaf, and a leaf that gets no gradient
(the unused iou branch) is given a zero one so that it is decayed and its
moments kept, as optax does.  After each update ``weights.refold`` remakes
the derived encoder weights, which the inference path reads.
``save_train_state`` writes the JAX package's npz (``p:`` params with HWIO
convs, ``o:[0].count/mu/nu``, then ``step``), so a checkpoint moves
between the packages both ways.

``CompiledTrainStep`` is ``jax.jit(train_step)`` for the card: the whole
step (loss, backward, clip, AdamW, refold) captured once as a CUDA graph
over static input buffers, then replayed a call; under a mesh in segments,
one graph closed at each collective (``runtime.compile.capture_segments``):
at mp = 1 two graphs with the gradients' all-reduce between them, under
mp > 1 also one at each of Megatron's all-reduces, those the backward and
``remat``'s recomputation reach on autograd's thread included.  A replay
reads and writes only the addresses it captured, so every piece of state
a step touches is updated in place, never replaced: the parameters, their
gradients, the moments and the count, the derived weights (``refold``)
and what ``load_train_state`` restores.  A host read, a state tensor that
is rebound, or a learning rate held as a Python float that changes
between steps would each break the capture or be frozen into it.

Frames of a batch run one after another (the forward has data-dependent
shapes).  ``remat`` (on by default on the card, as JAX's follows its
backend) wraps each frame's float stages in ``torch.utils.checkpoint``; the
integer stages run before it and carry no gradient, so the recomputation
reads the same partitions.  The step draws no random number, so the
checkpoint keeps no RNG state (reading the card's would stop a capture).
The float stages' row gathers (``ops/gather.py:take_rows``) run as
``index_select``, whose backward is one ``index_add_``; with the tracer on,
the step's ``grad_gathers`` counter holds how many its forward ran (17 a
frame at the pillar model's 4 blocks: two per encoder pass, one in the
VFE; ``remat``'s recomputation not counted).

``make_train_step(..., mesh=...)`` trains over a ``parallel.mesh`` mesh.
dp: each dp rank takes its B/dp frames of the global batch, and after the
backward the gradients are averaged over the dp group (one all-reduce of
every gradient, flattened, with the loss as its last element), which is
the gradient of JAX's global mean of the per-frame losses when the shares
are equal; the returned loss is that global mean.  mp: the encoders run
Megatron's route (model/backbone3d.py, ``live_weights``), each rank steps
AdamW on its own shards and on its copy of the replicated leaves, and
``weights.refold`` refolds each shard.  The replicated leaves' gradients
are whole on every mp rank, equal but for rounding (the card's backward
sums some with atomics, in another order in each process), so they are
averaged over the mp group (one all-reduce, flattened): every rank then
takes the same update, and its copies stay one array, as JAX's do.
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from .. import kernels
from ..config import DSVTConfig
from ..model.backbone2d import fused_convs
from ..model.detector import float_stages, forward_train, partition_frame
from ..ops.common import resolve_device
from ..ops.gather import grad_gathers
from ..runtime import profiler
from ..runtime.compile import capture_graph, capture_segments
from ..weights import (keystr, named_leaves, refold, to_numpy_leaf,
                       to_torch_leaf, trainable)
from .collectives import all_reduce, carrying
from .mesh import COL, COL_BIAS, ROW


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
                   aux_weight: float = 0.25, device="cuda",
                   tp=None) -> torch.Tensor:
    """The loss of one frame (``forward_train``'s head maps)."""
    out = forward_train(params, points, num_points, cfg, device, tp).head_out
    return head_loss(out, targets, dir_weight, aux_weight)


def batched_loss(params, points, num_points, targets: Targets,
                 cfg: DSVTConfig, remat: Optional[bool] = None,
                 dir_weight: float = 0.25, aux_weight: float = 0.25,
                 device="cuda", tp=None) -> torch.Tensor:
    """Mean of the per-frame losses of a batch (points [B, max_points, 4],
    num_points [B], targets with a leading B), frames one after another.
    ``remat`` (default: on the card) recomputes each frame's float stages
    in the backward instead of keeping their activations.  ``tp``: the
    encoders' tensor-parallel group (Megatron's route)."""
    device = resolve_device(device)
    if remat is None:
        remat = device.type == "cuda"

    # autograd's thread recomputes it under the hook current here
    @carrying
    def frame_loss(pillars, stages, frame_targets):
        out = float_stages(params, pillars, stages, cfg,
                           live_weights=True, tp=tp).head_out
        return head_loss(out, frame_targets, dir_weight, aux_weight)

    losses = []
    for b in range(len(points)):
        # the arguments, not a closure, carry each frame's partitions: the
        # recomputation runs after the loop
        args = (*partition_frame(params, points[b], num_points[b], cfg,
                                 device), Targets(*(t[b] for t in targets)))
        losses.append(checkpoint(frame_loss, *args, use_reentrant=False,
                                 preserve_rng_state=False)
                      if remat else frame_loss(*args))
    return torch.stack(losses).mean()


class AdamW(torch.optim.Optimizer):
    """``optax.adamw(lr, b1, b2, eps, weight_decay)`` in tensor ops, so a
    step reads nothing back to the host and a CUDA graph can hold it.

    Its state is made here, at fixed addresses: ``count``, a 0-dim float32
    tensor on the leaves' device (optax's update count), shared by every
    leaf as ``state[leaf]["step"]``, and per leaf ``exp_avg`` and
    ``exp_avg_sq`` (optax's mu and nu), zero.  ``step`` updates them in
    place as optax does: mu = b1 mu + (1 - b1) g, nu = b2 nu + (1 - b2) g^2,
    count + 1, then leaf -= lr (mu / (1 - b1^count) / (sqrt(nu / (1 -
    b2^count)) + eps) + weight_decay leaf).  ``lr`` is each group's float,
    or, with ``schedule``, ``schedule(count)`` on the count before the
    increment, computed on the card (``warmup_cosine`` takes a tensor).
    Leaves without a gradient are skipped, as torch's optimizers do."""

    def __init__(self, params, lr: float = 1e-4, betas=(0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 1e-4,
                 schedule: Optional[Callable] = None):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps,
                                      weight_decay=weight_decay))
        self.schedule = schedule
        leaves = [t for group in self.param_groups for t in group["params"]]
        self.count = torch.zeros((), dtype=torch.float32,
                                 device=leaves[0].device)
        for t in leaves:
            self.state[t] = {"step": self.count,
                             "exp_avg": torch.zeros_like(t),
                             "exp_avg_sq": torch.zeros_like(t)}

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("AdamW.step takes no closure")
        count = self.count + 1
        for group in self.param_groups:
            leaves = [t for t in group["params"] if t.grad is not None]
            grads = [t.grad for t in leaves]
            mu = [self.state[t]["exp_avg"] for t in leaves]
            nu = [self.state[t]["exp_avg_sq"] for t in leaves]
            b1, b2 = group["betas"]
            lr = (self.schedule(self.count) if self.schedule is not None
                  else group["lr"])
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, grads, alpha=1 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
            update = torch._foreach_div(mu, 1 - torch.pow(b1, count))
            denom = torch._foreach_div(nu, 1 - torch.pow(b2, count))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, leaves, alpha=group["weight_decay"])
            torch._foreach_mul_(update, lr)
            torch._foreach_sub_(leaves, update)
        self.count.copy_(count)


def default_optimizer(params) -> AdamW:
    """``optax.adamw(1e-4)``: lr 1e-4, betas (0.9, 0.999), eps 1e-8, decay
    1e-4 on every leaf."""
    return AdamW(trainable(params))


def clip_by_global_norm(grads, max_norm: float, sharded=(),
                        tp=None) -> None:
    """``optax.clip_by_global_norm``, in place: every gradient scaled by
    max_norm / |g| when the global norm |g| >= max_norm (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``), else left as it is.  Under tensor
    parallelism the squares of the ``sharded`` gradients are summed over
    ``tp`` (each rank holds a part), those of the others counted once."""
    sq = sum(torch.sum(g * g) for g in grads)
    if tp is not None:
        part = sum(torch.sum(g * g) for g in sharded)
        sq = sq + all_reduce(part, tp) - part
    norm = torch.sqrt(sq)
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def make_train_step(cfg: DSVTConfig, params, optimizer=None,
                    dir_weight: float = 0.25, aux_weight: float = 0.25,
                    max_grad_norm: Optional[float] = None,
                    remat: Optional[bool] = None, device="cuda",
                    mesh=None):
    """Returns (optimizer, train_step).  ``params`` (``weights.
    from_jax_params`` on ``device``; under a ``mesh``, ``parallel.mesh.
    rank_params``) are updated in place: their ``trainable`` leaves get
    ``requires_grad``, and ``optimizer`` (default ``default_optimizer``)
    must hold exactly those.  ``train_step(points, num_points, targets)``
    computes ``batched_loss``, its gradients (clipped to ``max_grad_norm``
    when given), takes one optimizer step, refolds the derived weights and
    returns the loss (detached; reading it waits for the card).  With a
    ``mesh``, the arguments are the global batch (module docstring)."""
    device = resolve_device(device)
    dp = mesh.dp if mesh is not None else 1
    tp = mesh.mp_group if mesh is not None else None
    if tp is not None:                 # whole weights an update would stale
        for blk in params["blocks"]:
            for enc in blk["enc"]:
                enc.pop("epilogue", None)
    sharded = [t for p, t in named_leaves(params) if tp is not None
               and p[0] == "blocks" and p[-1] in COL + COL_BIAS + ROW]
    leaves = trainable(params)
    replicated = [t for t in leaves if tp is not None
                  and not any(t is s for s in sharded)]
    for t in leaves:
        t.requires_grad_(True)
    optimizer = optimizer or default_optimizer(params)

    def train_step(points, num_points, targets: Targets) -> torch.Tensor:
        profiler.mark("forward")       # TRAIN_STAGES, with the tracer on
        if dp > 1:                     # this dp rank's share of the batch
            share = len(points) // dp
            if share * dp != len(points):
                raise ValueError(f"train_step: batch {len(points)} does not "
                                 f"split over dp={dp}")
            rows = slice(mesh.dp_rank * share, (mesh.dp_rank + 1) * share)
            points, num_points = points[rows], num_points[rows]
            targets = Targets(*(t[rows] for t in targets))
        optimizer.zero_grad(set_to_none=True)
        gathers, fused = grad_gathers(), fused_convs()
        loss = batched_loss(params, points, num_points, targets, cfg,
                            remat=remat, dir_weight=dir_weight,
                            aux_weight=aux_weight, device=device, tp=tp)
        profiler.counter("grad_gathers", grad_gathers() - gathers)
        profiler.counter("bev_fused_convs", fused_convs() - fused)
        profiler.mark("backward")
        loss.backward()
        profiler.mark("optimizer")
        for t in leaves:             # unused leaves: zero, as in optax
            if t.grad is None:
                t.grad = torch.zeros_like(t)
        loss = loss.detach()
        if dp > 1:             # gradients and loss: one all-reduce
            flat = all_reduce(torch.cat([t.grad.reshape(-1) for t in leaves]
                                        + [loss.reshape(1)]),
                              mesh.dp_group) / dp
            *grads, loss = flat.split([t.numel() for t in leaves] + [1])
            for t, g in zip(leaves, grads):
                t.grad.copy_(g.view_as(t))
            loss = loss.reshape(())
        if replicated:         # the mp ranks' copies: one update
            flat = all_reduce(torch.cat([t.grad.reshape(-1)
                                         for t in replicated]), tp) / mesh.mp
            for t, g in zip(replicated,
                            flat.split([t.numel() for t in replicated])):
                t.grad.copy_(g.view_as(t))
        if max_grad_norm is not None:
            clip_by_global_norm([t.grad for t in leaves], max_grad_norm,
                                [t.grad for t in sharded], tp)
        optimizer.step()
        refold(params)
        return loss

    return optimizer, train_step


class CompiledTrainStep:
    """``jax.jit(train_step)`` for the card: ``loss = step(points,
    num_points, targets)`` on batches of ``batch`` frames (points [batch,
    max_points, 4], num_points [batch] int, ``Targets`` at their dense
    shapes), the step of ``make_train_step`` (same arguments, kept as
    ``eager``) as one CUDA graph.

    ``warmup``, which the first call runs if the caller did not, makes the
    static input buffers, runs ``WARM_RUNS`` forward and backward passes on
    them (no update: the optimizer's state exists already and the weights
    stay as given), and captures one whole step into one CUDA graph
    (``runtime.compile.capture_graph``): zeroed gradients, ``batched_loss``,
    the backward with ``remat``'s recomputation, zero gradients for unused
    leaves, the optional clip, the AdamW update and ``refold``.  The capture
    runs nothing, so the first replay is step 1 from the given weights.  A
    call copies the batch into the buffers in stream order, replays, and
    returns a copy of the loss; nothing waits for the card.  The
    parameters, their gradients (``leaf.grad``, rewritten by each replay),
    the optimizer's state and the derived weights keep their addresses, so
    ``save_train_state`` reads what the replays computed and
    ``load_train_state`` writes where the next replay reads (module
    docstring).  The optimizer must update in tensor ops (``AdamW``; the
    default), its learning rate fixed or a ``schedule`` of its count.

    On the CPU a call runs the eager step.  Under a ``mesh`` the arguments
    are the global batch, of which each dp rank takes its share, every
    rank calls the step in step, and the step is captured in segments
    (``runtime.compile.capture_segments``), one graph closed at each
    collective: at mp = 1 graph 1 (zeroed gradients, the loss, the
    backward, zero gradients for unused leaves), the all-reduce of the
    gradients and the loss between the replays' graphs, graph 2 (clip,
    AdamW, refold).  Under mp > 1 Megatron's all-reduces break it too:
    ``reduce_from_tp`` in the forward and again in ``remat``'s
    recomputation, ``copy_to_tp`` in the backward, both on autograd's own
    thread (``collectives.carried``), so its graphs begin and end on
    different threads, in CUDA's relaxed capture mode; with dp > 1 the dp
    all-reduce, then the mp average of the replicated leaves' gradients,
    and with a clip the tp all-reduce of the squared norm
    (``parallel.dryrun.breaks_per_step`` counts them).  A capture or
    replay that fails raises; nothing falls back to the eager step on the
    card.  Recorded:
    ``capture_seconds``, ``graph_pool_bytes`` (the device memory the
    capture reserved: the graph's pool, which holds a whole step's
    intermediates), ``graph_launches`` (hand-written kernels a replay
    launches: none, training runs the plain paths), ``segments`` (graphs
    a replay launches) and ``replays``.

    With the tracer on (``runtime.profiler.enable_spans``, before the
    warm-up) the graph also holds the step's marks (``TRAIN_STAGES``: step
    start, after ``batched_loss``, after the backward, after the update and
    ``refold``), and each call, replayed or eager, leaves a record numbered
    by ``calls``: host spans ``call``, ``copy_in``, ``graph_launch``, the
    step's marks and its ``grad_gathers`` counter (``runtime/profiler.py``).
    The warm-up's record has the spans ``kernels`` (the mark kernel),
    ``warm_runs`` and ``capture``: it replays nothing."""

    WARM_RUNS = 2

    def __init__(self, cfg: DSVTConfig, params, batch: int, optimizer=None,
                 dir_weight: float = 0.25, aux_weight: float = 0.25,
                 max_grad_norm: Optional[float] = None,
                 remat: Optional[bool] = None, device="cuda", mesh=None):
        self.cfg, self.params, self.batch = cfg, params, batch
        self.mesh = mesh if mesh is not None and mesh.dp * mesh.mp > 1 \
            else None
        self.device = resolve_device(device)
        self.remat = self.device.type == "cuda" if remat is None else remat
        self.loss_weights = (dir_weight, aux_weight)
        self.optimizer, self.eager = make_train_step(
            cfg, params, optimizer, dir_weight, aux_weight, max_grad_norm,
            self.remat, self.device, self.mesh)
        self._graph = None
        self.graph_launches = {}
        self.capture_seconds = self.graph_pool_bytes = self.segments = None
        self.replays = 0
        self._marks = self._eager_marks = None   # the tracer's, when on
        self.calls = 0             # calls the tracer recorded

    def __call__(self, points, num_points, targets: Targets) -> torch.Tensor:
        if self.device.type != "cuda":
            if profiler.tracer() is None:
                return self.eager(points, num_points, targets)
            return profiler.traced_eager(
                self, "step", lambda: self.eager(points, num_points, targets))
        if self._graph is None:
            self.warmup()
        if profiler.tracer() is not None:
            return self._traced_call(points, num_points, targets)
        self._load(points, num_points, targets)
        self._graph.replay()
        self.replays += 1
        kernels.replayed(self.graph_launches)
        return self._loss.clone()

    def _load(self, points, num_points, targets: Targets) -> None:
        for buf, t in zip(self._inputs, (points, num_points, *targets)):
            if tuple(t.shape) != tuple(buf.shape):
                raise ValueError(f"CompiledTrainStep: the graph takes "
                                 f"{[tuple(b.shape) for b in self._inputs]} "
                                 f"(points, num_points, targets), got "
                                 f"{tuple(t.shape)} for {tuple(buf.shape)}")
            buf.copy_(t, non_blocking=True)

    def _traced_call(self, points, num_points, targets: Targets):
        """``__call__`` with its host spans, and the step's marks copied
        toward the host after the replay, in stream order."""
        self.calls += 1
        with profiler.record("step", "CompiledTrainStep", self.calls,
                             "replay") as rec:
            with profiler.span("copy_in"):
                self._load(points, num_points, targets)
            with profiler.span("graph_launch"):
                self._graph.replay()
            self.replays += 1
            kernels.replayed(self.graph_launches)
            loss = self._loss.clone()
            profiler.take(rec, self._marks)
        return loss

    def warmup(self) -> "CompiledTrainStep":
        """Capture the step (class docstring); on the CPU nothing."""
        if self.device.type != "cuda" or self._graph is not None:
            return self
        with profiler.record("warmup", "CompiledTrainStep", 0, "host"):
            with profiler.span("kernels"):
                self._marks = profiler.new_marks(self.device)
            self._capture()
        return self

    def _capture(self) -> None:
        t0 = time.perf_counter()
        cfg, dev, B = self.cfg, self.device, self.batch
        H, W = cfg.grid_size[1], cfg.grid_size[0]
        self._inputs = (
            torch.zeros((B, cfg.max_points, 4), dtype=torch.float32,
                        device=dev),
            torch.zeros((B,), dtype=torch.int32, device=dev),
            torch.zeros((B, H, W, cfg.num_classes), device=dev),
            torch.zeros((B, H, W, 8), device=dev),
            torch.zeros((B, H, W), device=dev))
        points, num, *targets = self._inputs
        targets = Targets(*targets)
        leaves = trainable(self.params)
        rows, tp = slice(None), None     # the warm runs: this rank's share
        if self.mesh is not None:
            share = B // self.mesh.dp
            rows = slice(self.mesh.dp_rank * share,
                         (self.mesh.dp_rank + 1) * share)
            tp = self.mesh.mp_group

        def forward_backward():
            loss = batched_loss(self.params, points[rows], num[rows],
                                Targets(*(t[rows] for t in targets)), cfg,
                                self.remat, *self.loss_weights, device=dev,
                                tp=tp)
            torch.autograd.grad(loss, leaves, allow_unused=True)

        def step():
            with profiler.marking(self._marks):
                return self.eager(points, num, targets)
        if self.mesh is None:
            captured = capture_graph(step, forward_backward, dev,
                                     self.WARM_RUNS)
        else:
            captured = capture_segments(step, forward_backward, dev,
                                        self.WARM_RUNS,
                                        across_threads=tp is not None)
        self._graph, self._loss, self.graph_launches, self.graph_pool_bytes \
            = captured
        self.segments = 1 if self.mesh is None else self._graph.segments
        self.capture_seconds = time.perf_counter() - t0


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int
                  ) -> Callable:
    """``optax.warmup_cosine_decay_schedule(0, lr, warmup_steps,
    decay_steps)`` as a function of the update count (read before the
    update, so update 0 runs at lr 0).  The rate is a float32 tensor on
    the count's device (``AdamW.count`` keeps it on the card), computed
    there, as optax computes it inside ``jax.jit``."""
    cosine_steps = decay_steps - warmup_steps

    def schedule(count):
        c = torch.as_tensor(count, dtype=torch.float32)
        warm = c * (lr / max(warmup_steps, 1))
        if cosine_steps <= 0:
            return torch.where(c < warmup_steps, warm, lr)
        done = torch.clamp(c - warmup_steps, max=cosine_steps)
        cos = (torch.cos(done * (np.pi / cosine_steps)) + 1) * (0.5 * lr)
        return torch.where(c < warmup_steps, warm, cos)

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
    flat = {}
    for p, t in named:
        flat[f"p:{keystr(p)}"] = to_numpy_leaf(p, t)
    for p, t in named:
        state = optimizer.state[t]
        for slot, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
            flat[f"o:[0].{slot}{keystr(p)}"] = to_numpy_leaf(p, state[key])
    count = optimizer.state[named[0][1]]["step"]      # shared by every leaf
    flat["o:[0].count"] = np.int32(int(count))
    flat["step"] = np.int64(step)
    if not path.endswith(".npz"):
        path = path + ".npz"
    np.savez(path, **flat)
    return path


def load_train_state(path: str, params, optimizer) -> int:
    """Restore a ``save_train_state`` file (either package's) into
    ``params`` and ``optimizer``'s state (an ``AdamW``'s, made when it
    was), in place: the parameters, the moments and the count keep their
    addresses, so a ``CompiledTrainStep`` resumes from them; refold;
    returns the step."""
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
            state = optimizer.state[t]
            state["exp_avg"].copy_(tensor(f"o:[0].mu{keystr(p)}", p, t))
            state["exp_avg_sq"].copy_(tensor(f"o:[0].nu{keystr(p)}", p, t))
            state["step"].fill_(count)
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
