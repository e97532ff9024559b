"""DSVT 3D backbone: 4 blocks x 2 rotated-set attention encoders.

Port of the JAX package's model/backbone3d.py, with the same wiring:

  for block b:                              # stage_0.{b}
    sets = set_partition[b % 2]
    x_in = x
    for pass e in 0..1:                     # encoder_list.{e}
      pos  = posembed_mlp[b][e](xy_centered of window partition e)   (!)
      attn = MHA(q=k=x[inds]+pos[inds], v=x[inds], key_mask)
      x1 = LN1(x + scatter_back(attn)); x2 = LN2(x1 + FFN(x1))
      x  = LN_enc(x2 + x)
    x = LN_res(x + x_in)

(!) pos-embed coords come from window partition e, set indices from
partition b % 2, as in the reference.

Kept from the JAX package: the pos-embed second linear folded into the q/k
projections, the three projections packed into one [C, 3C] matmul on the
[P, C] pillar rows, and the deterministic canonical-slot scatter-back.  The
fused path (kernels B1 + B2) is chosen by ``use_kernels`` and the precision
(bf16 or mixed), not by the device; on CPU tensors its wrappers run their
plain versions.

A staged configuration (upstream DSVT-V) runs the same blocks stage by
stage (``staged_forward``), global block ids running across stages, and
pools between stages (``pool_forward``: upstream's attention pooling, the
kernel ``stage_pool`` on the fused path); the pillar model is one stage.

Inference reads the packed projections that ``fold_encoder`` made once from
the weights; ``live_weights`` (training) packs them from the current leaves
inside the autograd graph on every call, as the JAX package does, so their
gradients reach wq/wk/wv and the pos-embed linear.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from ..config import DSVTConfig, stage_blocks
from ..ops import encoder_kernel
from ..ops import segment as seg_ops
from ..ops.attention import set_attention_qkv, layer_norm, ffn, gelu_tanh
from ..ops.common import dense, matmul_dtype, relu
from ..ops.gather import take_rows
from ..ops.pool_kernel import stage_pool, stage_pool_plain
from ..ops.pooling import PoolMap
from ..ops.windows import SetPartition, WindowPartition
from ..parallel import spatial
from ..parallel.collectives import all_gather_rows, copy_to_tp, reduce_from_tp
from ..runtime import profiler


def pos_embed_hidden(xy: torch.Tensor, mlp: dict) -> torch.Tensor:
    """First half of the pos-embed MLP: linear(2->C)+BN1d(folded)+ReLU, in
    f32 (its second linear is folded into the attention projections)."""
    return relu(torch.matmul(xy, mlp["w1"]) + mlp["b1"])


def scatter_back(attn_flat: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """Gather each pillar's canonical set-slot output.  attn_flat: [S*K, C]
    (row = flat slot); canon: [P] flat slot, S*K = dump -> zeros."""
    n = attn_flat.shape[0]
    out = take_rows(attn_flat, canon.clamp(max=n - 1))
    return torch.where((canon < n)[:, None], out, torch.zeros_like(out))


def pack_projections(enc: dict, mlp: dict):
    """(w_qkv [C, 3C], w_pos [C, 3C], b_qkv [3C]) of one encoder pass: the
    q/k/v projections side by side, the pos-embed linear2 folded into q and
    k (zero for v), and the packed bias."""
    w_qkv = torch.cat([enc["wq"], enc["wk"], enc["wv"]], dim=1)
    w_pos = torch.cat([mlp["w2"] @ enc["wq"], mlp["w2"] @ enc["wk"],
                       torch.zeros_like(enc["wv"])], dim=1)
    b_qkv = torch.cat([mlp["b2"] @ enc["wq"] + enc["bq"],
                       mlp["b2"] @ enc["wk"] + enc["bk"], enc["bv"]])
    return w_qkv, w_pos, b_qkv


# the keys fold_encoder adds to an encoder's dict (none is a trained leaf)
FOLDED_KEYS = ("w_qkv", "w_pos", "b_qkv", "w_qkv_bf16", "w_pos_bf16",
               "ln_stack", "wo_panels_bf16", "ffn_w1_panels_bf16",
               "ffn_w2_panels_bf16")
# and the whole epilogue weights parallel.mesh.rank_params adds under mp
DERIVED_KEYS = FOLDED_KEYS + ("epilogue",)


def fold_encoder(enc: dict, mlp: dict) -> dict:
    """The derived weights of one encoder pass, made once when the weights
    are carried to the device (``weights.from_jax_params``) and again after
    every optimizer step (``weights.refold``): ``pack_projections``' three
    in f32, w_qkv and w_pos again in bf16 for the fast paths' products, and
    kernel B2's operands (``encoder_kernel.kernel_weights``)."""
    w_qkv, w_pos, b_qkv = pack_projections(enc, mlp)
    return {"w_qkv": w_qkv, "w_pos": w_pos, "b_qkv": b_qkv,
            "w_qkv_bf16": w_qkv.to(torch.bfloat16),
            "w_pos_bf16": w_pos.to(torch.bfloat16),
            **encoder_kernel.kernel_weights(enc)}


def _epilogue(x, attn_p, enc, eps, precision, use_fused):
    """Out-projection + LN + FFN + LN + residual + LN of one encoder pass
    on whole heads: kernel B2 on the fused path, else the plain formula."""
    if use_fused:
        return encoder_kernel.encoder_epilogue(x.float(), attn_p, enc, eps)
    mdt = matmul_dtype(precision)
    attn_p = dense(attn_p, enc["wo"], enc["bo"], mdt)
    x1 = layer_norm(x + attn_p, enc["ln1_g"], enc["ln1_b"], eps)
    x2 = layer_norm(x1 + ffn(x1, enc, precision),
                    enc["ln2_g"], enc["ln2_b"], eps)
    return layer_norm(x2 + x, enc["norm_g"], enc["norm_b"], eps)


def _epilogue_tp(x, attn_p, enc, eps, precision, tp):
    """The Megatron epilogue on this rank's heads: wo and ffn_w2 are row
    shards, so their products are partial sums, all-reduced by
    ``reduce_from_tp`` before the replicated bias; ffn_w1 is a column
    shard, fed through ``copy_to_tp``."""
    mdt = matmul_dtype(precision)
    attn_o = reduce_from_tp(dense(attn_p, enc["wo"], None, mdt), tp) + enc["bo"]
    x1 = layer_norm(x + attn_o, enc["ln1_g"], enc["ln1_b"], eps)
    h = gelu_tanh(dense(copy_to_tp(x1, tp), enc["ffn_w1"], enc["ffn_b1"], mdt))
    f = reduce_from_tp(dense(h.to(mdt), enc["ffn_w2"], None, mdt), tp) \
        + enc["ffn_b2"]
    x2 = layer_norm(x1 + f, enc["ln2_g"], enc["ln2_b"], eps)
    return layer_norm(x2 + x, enc["norm_g"], enc["norm_b"], eps)


def backbone3d_forward(pillar_feats: torch.Tensor,
                       window_parts: Sequence[WindowPartition],
                       set_parts: Sequence[SetPartition],
                       params: dict, cfg: DSVTConfig, *,
                       use_kernels: bool,
                       live_weights: bool = False,
                       tp=None, blocks: Sequence[int] = None) -> torch.Tensor:
    """pillar_feats: [P, C] -> [P, C] (f32) after the DSVT blocks, at
    ``cfg.precision``: ``blocks``, the global ids of one stage's blocks
    (default: every block of the pillar model), with that stage's window
    and set partitions (``set_parts`` by window spec: global block b reads
    ``set_parts[b % len(set_parts)]``).  ``params`` as ``weights.from_jax_params`` makes
    them (with ``fold_encoder``'s weights).  ``use_kernels`` with bf16 or
    mixed precision takes the fused path (kernels B1 + B2).
    ``live_weights`` packs the projections from the current leaves
    (``pack_projections``) instead of reading the folded copies; it runs
    the plain path only, since kernels B1 and B2 define no backward.

    ``tp``, a process group, runs the encoders tensor parallel over it
    (mp ranks; params from ``parallel.mesh.rank_params``): each rank's
    packed projection gives its [P, 3C/mp] q/k/v table and attention
    (kernel B1 on the fused path) runs on its H/mp heads.  Then one of two
    routes, chosen by precision and never by device:

      * bf16 or mixed, without ``live_weights``: the [P, C/mp] head outputs
        are all-gathered to [P, C] (mp - 1 shares of P*C*2 bytes a rank)
        and the epilogue runs whole on every rank with the encoder's
        whole weights (``enc["epilogue"]``; kernel B2 on the fused path),
        as GSPMD runs the un-partitionable Pallas call on the TPU, so B2's
        input is the unsharded path's;
      * fp32, and ``live_weights`` (training): Megatron's epilogue
        (``_epilogue_tp``), two all-reduces of [P, C] f32 an encoder, and
        ``copy_to_tp`` on every replicated input of a column-sharded
        product (x, the pos-embed hidden rows and the pos-embed linear
        folded into q and k), so the gradients of replicated leaves are
        whole on every rank.

    Inside ``parallel.spatial.spatial_sharding`` (sp ranks) each rank
    computes the q/k/v table of its pillar rows and all-gathers it (at
    ``DEFAULT_CONFIG``, 10 000 x 576 in bf16, 11.5 MB, or f32 at fp32),
    runs attention on its slice of sets with ``set_count`` shifted to its
    slice (sets past the count still give zeros), all-gathers the
    set-slot outputs (800 x 36 x 192 in bf16, 11.1 MB) so that every
    pillar reads its canonical slot wherever its set ran, and runs the
    epilogue on its pillar rows (B2 is row-wise).  So an encoder gathers
    the table and the set slots, and a block gathers x once at its end
    (10 000 x 192 f32, 7.7 MB).  tp and sp do not combine.
    """
    eps = cfg.ln_eps
    precision = cfg.precision
    mdt = matmul_dtype(precision)
    w_sfx = "_bf16" if mdt is torch.bfloat16 else ""
    sharded = spatial.active()
    if sharded and tp is not None:
        raise ValueError("backbone3d: tensor and spatial sharding do not "
                         "combine")
    use_fused = use_kernels and precision in ("bf16", "mixed")
    if use_fused and live_weights:
        raise ValueError("live_weights runs the plain path: kernels B1 and "
                         "B2 define no backward")
    gather_heads = tp is not None and precision in ("bf16", "mixed") \
        and not live_weights
    heads = cfg.num_heads
    if tp is not None:
        heads //= dist.get_world_size(tp)

    P = pillar_feats.shape[0]
    plo, phi = spatial.my_rows(P)
    if blocks is None:
        blocks = range(cfg.num_blocks)
    hidden: Dict[int, List[torch.Tensor]] = {
        b: [pos_embed_hidden(window_parts[e].xy_centered[plo:phi],
                             params["posembed"][b][e])
            for e in range(2)] for b in blocks}

    x = pillar_feats
    for b in blocks:
        sp = set_parts[b % len(set_parts)]
        S, K = sp.key_mask.shape
        slo, shi = spatial.my_rows(S)
        set_count = sp.set_count
        if sharded:
            set_count = (set_count - slo).clamp(0, shi - slo)
        x_in = x[plo:phi]
        x_loc = x_in
        for e in range(2):
            enc = params["blocks"][b]["enc"][e]
            mlp = params["posembed"][b][e]
            x_q, h1 = x_loc, hidden[b][e]
            if tp is not None:
                x_q, h1 = copy_to_tp(x_q, tp), copy_to_tp(h1, tp)
                if live_weights:     # folded into the q/k columns
                    mlp = {**mlp, "w2": copy_to_tp(mlp["w2"], tp),
                           "b2": copy_to_tp(mlp["b2"], tp)}
            if live_weights:
                w_qkv, w_pos, b_qkv = pack_projections(enc, mlp)
            else:
                w_qkv, w_pos, b_qkv = (enc["w_qkv" + w_sfx],
                                       enc["w_pos" + w_sfx], enc["b_qkv"])
            qkv_p = (dense(x_q, w_qkv, None, mdt)
                     + dense(h1, w_pos, None, mdt) + b_qkv)
            if sharded:
                qkv_p = spatial.gather_split(qkv_p.to(mdt), P)

            attn = set_attention_qkv(qkv_p, sp.inds[e][slo:shi],
                                     sp.key_mask[slo:shi], heads, precision,
                                     use_kernels=use_fused, flat_out=True,
                                     set_count=set_count)
            if sharded:
                attn = spatial.gather_split(attn, S, per_row=K)
            attn_p = scatter_back(attn, sp.canon[e][plo:phi])

            if gather_heads:
                if "epilogue" not in enc:
                    raise ValueError("the bf16/mixed tensor-parallel route "
                                     "needs the whole epilogue weights: "
                                     "parallel.mesh.rank_params")
                attn_p = all_gather_rows(
                    attn_p, [attn_p.shape[1]] * dist.get_world_size(tp), tp,
                    dim=1)
                x_loc = _epilogue(x_loc, attn_p, enc["epilogue"], eps,
                                  precision, use_fused)
            elif tp is not None:
                x_loc = _epilogue_tp(x_loc, attn_p, enc, eps, precision, tp)
            else:
                x_loc = _epilogue(x_loc, attn_p, enc, eps, precision,
                                  use_fused)
        x = layer_norm(x_loc + x_in, params["blocks"][b]["res_g"],
                       params["blocks"][b]["res_b"], eps)
        if sharded:
            x = spatial.gather_split(x, P)
    return x


# ---------------------------------------------------------------------------
# Staged backbone (upstream DSVT-V): the stages' blocks with attention
# pooling between them
# ---------------------------------------------------------------------------

# the keys fold_pool adds to a pooling's dict (none is a trained leaf)
POOL_FOLDED_KEYS = ("w_kv", "kbias", "wq_bf16", "w_kv_bf16", "wo_bf16")


def fold_pool(pool: dict) -> dict:
    """The derived weights of one pooling: the key and value projections
    side by side ([C, 2C]), each slot's key bias (its ``pos_embedding``
    row through the key projection, plus the key bias: [V, C]), and the
    bf16 copies of the products' weights."""
    w_kv = torch.cat([pool["wk"], pool["wv"]], dim=1)
    return {"w_kv": w_kv, "kbias": pool["pos"] @ pool["wk"] + pool["bk"],
            "wq_bf16": pool["wq"].to(torch.bfloat16),
            "w_kv_bf16": w_kv.to(torch.bfloat16),
            "wo_bf16": pool["wo"].to(torch.bfloat16)}


def pool_forward(x: torch.Tensor, pm: PoolMap, pool: dict, cfg: DSVTConfig,
                 *, use_kernels: bool) -> torch.Tensor:
    """One stage's voxels x [N0, C] (f32) -> the next stage's [N1, C] (f32):
    upstream's ``Stage_ReductionAtt_Block`` on the placeholder of the
    map's V slots a parent.  query = the max over the slots (an empty
    slot is a zero row), key = slot + pos_embedding, value = slot, 8-head
    attention with in- and out-projection biases, LayerNorm(attention +
    query).  On the fused path (``use_kernels``, bf16 or mixed) the max is
    kernel B3 over the children sorted by parent (with 0 where a slot is
    empty) and the attention kernel ``stage_pool``; else the plain
    placeholder and formula.  Parents past the count give zero queries."""
    precision = cfg.precision
    mdt = matmul_dtype(precision)
    sfx = "_bf16" if mdt is torch.bfloat16 else ""
    use_fused = use_kernels and precision in ("bf16", "mixed")
    if use_fused:
        m = seg_ops.segmented_max(x[pm.order], pm.is_start,
                                  pm.child.shape[1], starts_only=True)[pm.first]
        m = torch.where(pm.full[:, None], m, relu(m))
    else:
        m = torch.cat([x, x.new_zeros((1, x.shape[1]))])[pm.child].amax(1)
    m = torch.where(pm.valid[:, None], m, torch.zeros_like(m))
    q = dense(m, pool["wq" + sfx], pool["bq"], mdt).to(mdt)
    kv = dense(x, pool["w_kv" + sfx], None, mdt).to(mdt)
    attend = stage_pool if use_fused else stage_pool_plain
    attn = attend(q, kv, pm.child, pool["kbias"], pool["bv"], pm.count,
                  cfg.num_heads)
    out = dense(attn, pool["wo" + sfx], pool["bo"], mdt) + m
    return layer_norm(out, pool["ln_g"], pool["ln_b"], cfg.ln_eps)


def staged_forward(feats: torch.Tensor, stages, params: dict,
                   cfg: DSVTConfig, *, use_kernels: bool,
                   live_weights: bool = False, tp=None) -> torch.Tensor:
    """The staged backbone: stage 0's voxel features [N0, C] -> the last
    stage's [Nn, C] (f32).  ``stages``: each stage's window partitions,
    set partitions (by window spec, None where no block reads it) and
    pooling map to the next stage (``model/detector.py:StageParts``).
    Each stage runs its blocks (``backbone3d_forward`` with the global
    block ids: the block counter runs across stages), then its pooling
    under the ``pool`` label, with a device stage mark on entry to it and
    one back into ``backbone3d`` after it while the tracer is on.  The
    pillar model is one stage: its blocks, no pooling; ``live_weights``
    and ``tp`` reach its blocks as in ``backbone3d_forward``."""
    for s, (blocks, parts) in enumerate(zip(stage_blocks(cfg), stages)):
        feats = backbone3d_forward(feats, parts.windows, parts.sets, params,
                                   cfg, use_kernels=use_kernels,
                                   live_weights=live_weights, tp=tp,
                                   blocks=blocks)
        if parts.pool is not None:
            with profiler.stage_scope("pool"):
                feats = pool_forward(feats, parts.pool, params["pool"][s], cfg,
                                     use_kernels=use_kernels)
            profiler.mark("backbone3d")
    return feats
