"""Device-mesh parallelism, port of the JAX package's parallel/mesh.py.

  * **dp**: data parallel over frames.  Each dp rank runs its share of a
    batch through an ``Engine`` of ``model.detector.forward_batch`` (a
    replayed CUDA graph on the card); no collective inside a frame.  The
    training step all-reduces the gradients (parallel/training.py).
  * **mp**: tensor parallel (Megatron) over the attention heads and the
    FFN hidden width: wq/wk/wv and ffn_w1 split by columns, wo and ffn_w2
    by rows (``param_shardings``, the JAX rules).  The collectives GSPMD
    inserted from those annotations are written out in
    parallel/collectives.py, and model/backbone3d.py calls them
    (its docstring gives the two routes, chosen by precision).

Ranks are laid out ``[dp, mp]`` as JAX reshapes its devices: rank = d * mp
+ m.  A rank holds the slice of each sharded leaf that JAX puts on device
(d, m) (``shard_params``; for a model, ``rank_params`` carries it to the
device and refolds it per shard).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import DSVTConfig
from ..ops import encoder_kernel
from ..ops.postprocess import Detections
from ..runtime.compile import Engine
from .collectives import all_gather_rows

COL = ("wq", "wk", "wv", "ffn_w1")
COL_BIAS = ("bq", "bk", "bv", "ffn_b1")
ROW = ("wo", "ffn_w2")
# the weights of an encoder's epilogue (out-projection, FFN, three LNs)
EPILOGUE_LEAVES = ("wo", "bo", "ffn_w1", "ffn_b1", "ffn_w2", "ffn_b2",
                   "ln1_g", "ln1_b", "ln2_g", "ln2_b", "norm_g", "norm_b")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a dp x mp mesh and its two sub-groups: the
    ranks of its column (``dp_group``, same m) and of its row
    (``mp_group``, same d).  A group of one rank is ``None``: nothing to
    communicate."""

    dp: int
    mp: int
    dp_rank: int
    mp_rank: int
    dp_group: Any = None
    mp_group: Any = None


def make_mesh(dp: int, mp: int = 1) -> Mesh:
    """The mesh over the default process group, whose size must be dp*mp
    (without a process group, only the 1 x 1 mesh).  Every rank must call
    it, in the same order as any other group creation."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if dp < 1 or mp < 1 or dp * mp != world:
        raise ValueError(f"make_mesh: dp={dp} x mp={mp} must equal the "
                         f"world size {world}")
    grid = np.arange(world).reshape(dp, mp)
    dp_group = mp_group = None
    if dp > 1:
        for m in range(mp):              # new_group is collective: all ranks
            g = dist.new_group(grid[:, m].tolist())
            if rank in grid[:, m]:
                dp_group = g
    if mp > 1:
        for d in range(dp):
            g = dist.new_group(grid[d].tolist())
            if rank in grid[d]:
                mp_group = g
    d, m = divmod(rank, mp)
    return Mesh(dp, mp, d, m, dp_group, mp_group)


def param_shardings(params: Dict, mesh: Mesh) -> Dict:
    """The params' tree with each leaf's partition spec, as JAX's
    ``PartitionSpec`` entries: ``(None, "mp")`` columns, ``("mp",)`` a
    bias, ``("mp", None)`` rows, ``()`` replicated.  Only encoder weights
    are sharded, and only when mp > 1."""
    def enc_spec(name: str) -> tuple:
        if mesh.mp > 1:
            if name in COL:
                return (None, "mp")
            if name in COL_BIAS:
                return ("mp",)
            if name in ROW:
                return ("mp", None)
        return ()

    def replicated(node):
        if isinstance(node, dict):
            return {k: replicated(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [replicated(v) for v in node]
        return ()

    out = {}
    for top, sub in params.items():
        if top == "blocks":
            out[top] = [{"enc": [{k: enc_spec(k) for k in enc}
                                 for enc in blk["enc"]],
                         "res_g": (), "res_b": ()} for blk in sub]
        else:
            out[top] = replicated(sub)
    return out


def _shard(leaf, spec: tuple, mesh: Mesh):
    """This rank's slice of ``leaf`` (NumPy array or tensor) under
    ``spec``."""
    if "mp" not in spec:
        return leaf
    axis = spec.index("mp")
    n = leaf.shape[axis]
    if n % mesh.mp:
        raise ValueError(f"shard_params: axis {axis} of {n} does not split "
                         f"over mp={mesh.mp}")
    w = n // mesh.mp
    index = [slice(None)] * len(leaf.shape)
    index[axis] = slice(mesh.mp_rank * w, (mesh.mp_rank + 1) * w)
    return leaf[tuple(index)]


def shard_params(params: Dict, mesh: Mesh) -> Dict:
    """Each leaf as this rank holds it: its shard under
    ``param_shardings``, or the whole leaf.  Leaves stay NumPy arrays or
    tensors (slices of them)."""
    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, s) for v, s in zip(node, spec)]
        return _shard(node, spec, mesh)
    return walk(params, param_shardings(params, mesh))


def _epilogue(enc: Dict, device) -> Dict:
    """One encoder's whole epilogue weights on ``device``, with kernel
    B2's operands."""
    ep = {k: torch.tensor(np.asarray(enc[k], np.float32), device=device)
          for k in EPILOGUE_LEAVES}
    ep.update(encoder_kernel.kernel_weights(ep))
    return ep


def rank_params(params: Dict, mesh: Mesh, device="cuda") -> Dict:
    """This rank's model from the whole NumPy params (``random_params`` or
    ``prepare_params``): ``shard_params`` carried to ``device`` by
    ``weights.from_jax_params``, which refolds the packed q/k/v
    projections from the shards (a shard's [q|k|v] table is [C, 3C/mp]:
    H/mp whole heads).  Under mp each encoder also gets ``epilogue``, its
    whole out-projection, FFN and LayerNorm weights with kernel B2's
    operands, which the bf16/mixed route runs on the gathered heads
    (model/backbone3d.py).  Training updates the shards only, so
    ``parallel.training.make_train_step`` drops ``epilogue``."""
    from ..weights import from_jax_params
    tree = from_jax_params(shard_params(params, mesh), device)
    if mesh.mp > 1 and "blocks" in tree:
        for blk, blk_np in zip(tree["blocks"], params["blocks"]):
            for enc, enc_np in zip(blk["enc"], blk_np["enc"]):
                enc["epilogue"] = _epilogue(enc_np, device)
    return tree


def check_heads(cfg: DSVTConfig, mesh: Mesh) -> None:
    """Column-sharding q, k and v keeps whole heads only if mp divides
    the head count."""
    if cfg.num_heads % mesh.mp:
        raise ValueError(f"mp={mesh.mp} must divide num_heads="
                         f"{cfg.num_heads}: a shard holds whole heads")


def make_dp_engine(params: Dict, cfg: DSVTConfig, mesh: Mesh,
                   with_nms: bool = False, device="cuda"):
    """Batched, dp-sharded inference: the JAX package's jitted
    ``make_dp_engine``.  ``params`` are the whole NumPy params; each rank
    keeps its own (``rank_params``).

    Returns ``run(points [B, N, 4], num_points [B], gather=False)``: dp
    rank d runs frames [d*B/dp, (d+1)*B/dp) and returns their stacked
    ``Detections``; ``gather=True`` all-gathers them over the dp group
    (eagerly, after the run), so every rank returns all B frames.  The
    share runs through an ``Engine(..., batch=B/dp, tp=mesh.mp_group)``
    made the first time a batch size is seen: on the card a replayed graph
    (in segments under mp > 1), on the CPU ``forward_batch``.  Every rank
    calls ``run`` in step.  ``run.engines`` maps each share to its
    engine."""
    check_heads(cfg, mesh)
    rank_p = rank_params(params, mesh, device)
    engines: Dict[int, Engine] = {}

    def run(points, num_points, gather: bool = False) -> Detections:
        B = len(points)
        if B % mesh.dp:
            raise ValueError(f"make_dp_engine: batch {B} does not split "
                             f"over dp={mesh.dp}")
        share = B // mesh.dp
        lo = mesh.dp_rank * share
        if share not in engines:
            engines[share] = Engine(rank_p, cfg, device, with_nms,
                                    batch=share, tp=mesh.mp_group)
        dets = engines[share](points[lo:lo + share],
                              num_points[lo:lo + share])
        if gather and mesh.dp > 1:
            counts = [share] * mesh.dp
            dets = Detections(*(all_gather_rows(t, counts, mesh.dp_group)
                                for t in dets))
        return dets

    run.engines = engines
    return run


def gather_params(params: Dict, mesh: Optional[Mesh],
                  grads: bool = False) -> Dict[str, torch.Tensor]:
    """Inverse of ``shard_params`` for a rank's torch params: every leaf of
    ``weights.named_leaves`` (with ``grads``, its gradient) whole, by its
    ``weights.keystr`` path, the sharded ones all-gathered over the mp
    group (every rank gets them)."""
    from ..weights import keystr, named_leaves
    out = {}
    for path, t in named_leaves(params):
        t = (t.grad if grads else t).detach()
        if mesh is not None and mesh.mp > 1 and path[0] == "blocks" \
                and path[-1] in COL + COL_BIAS + ROW:
            axis = 1 if path[-1] in COL else 0
            t = all_gather_rows(t, [t.shape[axis]] * mesh.mp, mesh.mp_group,
                                dim=axis)
        out[keystr(path)] = t
    return out
