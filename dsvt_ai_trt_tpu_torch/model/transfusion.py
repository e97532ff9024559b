"""TransFusion-L, upstream DSVT's nuScenes detection head (Bai et al.,
"TransFusion", CVPR 2022; OpenPCDet's ``dense_heads/transfusion_head.py``
with ``tools/cfgs/nuscenes_models/transfusion_lidar.yaml``), on the
384-channel BEV map of the BEV ResNet.  ``F`` is that map, H x W cells,
``C`` = ``query_channels``:

1. ``L = conv3x3(F; 384 -> C, bias)``: a bare conv, no BN or ReLU.
2. ``hm = conv3x3(relu(BN(conv3x3(L; C -> C))); C -> classes, bias)``.
3-4. The proposals (``ops/postprocess.select_proposals``): the local
   maxima of sigmoid(hm), then the exact top ``num_proposals`` over every
   (class, cell); each gives a class ``c`` and a cell ``i``.
5. Queries ``q = L[i] + class_encoding(one_hot(c))`` (a 1x1 conv of the
   one-hot: a row of its weight plus its bias).
6-7. ``query_pos = bev_pos[i]`` (``postprocess.query_positions``) and the
   position embeddings ``PositionEmbeddingLearned(2, C)``: linear 2 -> C,
   BN1d, ReLU, linear C -> C; ``self_pos`` of query_pos, ``cross_pos`` of
   every cell's bev_pos (``Pk``: the grid fixes it, so it is derived once
   from the weights, ``fold_query``, like a folded BatchNorm).
8. One decoder layer, post-norm, ``nn.MultiheadAttention`` semantics
   (``query_heads`` heads), no dropout: q = LN1(q + SelfAttn(q + Pq, q +
   Pq, q + Pq)); q = LN2(q + CrossAttn(q + Pq, L + Pk, L + Pk)); q = LN3(q
   + W2 relu(W1 q)).
9. Branches: linear C -> ``query_branch_channels`` (no bias), BN1d, ReLU,
   linear to the branch's outputs; center += query_pos.
10. Decode (``postprocess.decode_queries``).  No NMS.

The cross-attention over all H x W keys is kernel ``query_attention``
(``ops/query_attention_kernel.py``, on the bf16 path on the card: the key
and value projections of L + Pk inside it, the [HW, C] keys and values
never written); everywhere else its plain version.  The 200-row work
(the gathers, the self-attention, the FFN, the LayerNorms, the branches)
is PyTorch ops in f32.  The convs are the BEV stack's (``backbone2d.conv``,
``conv_relu``): NHWC bf16 on the card, their weights folded by
``weights.fold_convs``, the hidden heatmap conv's ReLU fused into cuDNN's
pass where the stack's are.

``head_forward`` runs steps 1-9 inside the detector's ``head`` label, the
decoder and branches (5-9) under the nested ``query`` label, whose entry
the tracer marks; the counter ``proposals`` takes the (class, cell)
scores above 0 after the local max.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..config import DSVTConfig, query_branches
from ..ops.attention import layer_norm
from ..ops.common import relu
from ..ops.layout import to_hwc, to_nchw
from ..ops.postprocess import query_positions, select_proposals
from ..ops.query_attention_kernel import query_attention, \
    query_attention_plain
from ..runtime import profiler
from ..runtime.profiler import stage_scope
from .backbone2d import conv, conv_relu

# the keys ``fold_query`` adds to the head's dict (none is a trained leaf)
QUERY_DERIVED = ("pk", "pk_bf16", "w_kv", "w_kv_bf16", "b_kv")


def grid_positions(cfg: DSVTConfig, device) -> torch.Tensor:
    """``bev_pos`` of every cell, in the map's flat order [H*W, 2]."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    return query_positions(torch.arange(H * W, device=device), cfg)


def pos_embed(xy: torch.Tensor, mlp: dict) -> torch.Tensor:
    """PositionEmbeddingLearned: linear (BN folded), ReLU, linear; f32."""
    h = relu(xy @ mlp["w1"] + mlp["b1"])
    return h @ mlp["w2"] + mlp["b2"]


def fold_query(head: dict, cfg: DSVTConfig) -> dict:
    """Add to the head's dict what the cross-attention derives from its
    weights, once: ``pk`` [H*W, C], the key position embedding of every
    cell; ``w_kv`` [2C, C], the key and value projections in nn.Linear's
    layout, and ``b_kv`` [2C]; on the bf16 path their bf16 copies (the
    kernel's operands).  ``runtime.compile.Engine`` calls it; a bare
    ``forward`` without it derives them on every call."""
    with torch.no_grad():
        head.update(_tables(head, cfg))
        if cfg.precision == "bf16":
            head["pk_bf16"] = head["pk"].to(torch.bfloat16)
            head["w_kv_bf16"] = head["w_kv"].to(torch.bfloat16)
    return head


def _tables(head: dict, cfg: DSVTConfig) -> Dict[str, torch.Tensor]:
    if "pk" in head:
        return {k: head[k] for k in ("pk", "w_kv", "b_kv")}
    attn = head["cross_attn"]
    pk = pos_embed(grid_positions(cfg, attn["wk"].device), head["cross_pos"])
    return {"pk": pk,
            "w_kv": torch.cat([attn["wk"], attn["wv"]], dim=1).t()
            .contiguous(),
            "b_kv": torch.cat([attn["bk"], attn["bv"]])}


def _attention(q, k, v, heads: int) -> torch.Tensor:
    """Scaled dot-product attention of [Nq, C] queries over [N, C] keys and
    values, per head, f32."""
    Nq, C = q.shape
    D = C // heads
    logits = torch.einsum("qhd,khd->hqk", q.reshape(Nq, heads, D),
                          k.reshape(-1, heads, D)) * (1.0 / math.sqrt(D))
    out = torch.einsum("hqk,khd->qhd", torch.softmax(logits, dim=-1),
                       v.reshape(-1, heads, D))
    return out.reshape(Nq, C)


def _cross(q: torch.Tensor, feats: torch.Tensor, head: dict, cfg: DSVTConfig,
           use_kernel: bool) -> torch.Tensor:
    """CrossAttn(q, L + Pk, L + Pk) before its out-projection: kernel
    ``query_attention`` on the bf16 path, else its plain version on the
    f32 tables."""
    attn = head["cross_attn"]
    qp = q @ attn["wq"] + attn["bq"]
    if use_kernel:
        tables = _tables(head, cfg)
        pk = head.get("pk_bf16")
        w_kv = head.get("w_kv_bf16")
        if pk is None:
            pk = tables["pk"].to(torch.bfloat16)
            w_kv = tables["w_kv"].to(torch.bfloat16)
        out = query_attention(qp.to(torch.bfloat16), feats, pk, w_kv,
                              tables["b_kv"], cfg.query_heads)
        return out.float()
    tables = _tables(head, cfg)
    return query_attention_plain(qp, feats.float(), tables["pk"],
                                 tables["w_kv"], tables["b_kv"],
                                 cfg.query_heads)


def decoder(q: torch.Tensor, qpos: torch.Tensor, feats: torch.Tensor,
            head: dict, cfg: DSVTConfig, use_kernel: bool) -> torch.Tensor:
    """The decoder layer (step 8) on queries ``q`` [Nq, C] with their
    embedded positions ``qpos``, over the map's rows ``feats`` [H*W, C]."""
    eps = cfg.ln_eps
    sa = head["self_attn"]
    x = q + qpos
    a = _attention(x @ sa["wq"] + sa["bq"], x @ sa["wk"] + sa["bk"],
                   x @ sa["wv"] + sa["bv"], cfg.query_heads)
    q = layer_norm(q + a @ sa["wo"] + sa["bo"], head["ln1_g"], head["ln1_b"],
                   eps)
    ca = head["cross_attn"]
    a = _cross(q + qpos, feats, head, cfg, use_kernel)
    q = layer_norm(q + a @ ca["wo"] + ca["bo"], head["ln2_g"], head["ln2_b"],
                   eps)
    f = relu(q @ head["ffn_w1"] + head["ffn_b1"]) @ head["ffn_w2"] \
        + head["ffn_b2"]
    return layer_norm(q + f, head["ln3_g"], head["ln3_b"], eps)


def head_forward(features: torch.Tensor, head: dict, cfg: DSVTConfig,
                 use_kernels: bool) -> Dict[str, torch.Tensor]:
    """features: [H, W, 384] -> the branches' outputs of every query (f32,
    ``center`` with query_pos added) and its ``classes``, ``cells`` and
    ``cell_scores`` (the masked heatmap of every class at its cell), for
    ``postprocess.decode_queries``."""
    precision = cfg.precision
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    lmap = conv(to_nchw(features), head, "shared_w", "shared_b", 1, precision)
    hidden = conv_relu(lmap, head["hm"], "w0", "b0", 1, precision)
    hm = conv(hidden, head["hm"], "w1", "b1", 1, precision)
    masked, classes, cells, proposals = select_proposals(hm, cfg)
    profiler.counter("proposals", proposals)
    feats = to_hwc(lmap).reshape(H * W, -1)
    with stage_scope("query"):
        pos = query_positions(cells, cfg)
        q = feats[cells].float() + head["class_w"][classes] + head["class_b"]
        q = decoder(q, pos_embed(pos, head["self_pos"]), feats, head, cfg,
                    use_kernels and precision == "bf16")
        out = {name: relu(q @ br["w1"] + br["b1"]) @ br["w2"] + br["b2"]
               for name, br in ((n, head["branches"][n])
                                for n, _ in query_branches(cfg))}
        out["center"] = out["center"] + pos
    out.update(classes=classes, cells=cells, cell_scores=masked[:, cells].t())
    return out
