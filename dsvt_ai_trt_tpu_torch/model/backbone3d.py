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
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..config import DSVTConfig
from ..ops import encoder_kernel
from ..ops.attention import set_attention_qkv, layer_norm, ffn
from ..ops.common import dense, matmul_dtype
from ..ops.windows import SetPartition, WindowPartition


def pos_embed_hidden(xy: torch.Tensor, mlp: dict) -> torch.Tensor:
    """First half of the pos-embed MLP: linear(2->C)+BN1d(folded)+ReLU, in
    f32 (its second linear is folded into the attention projections)."""
    return torch.clamp(torch.matmul(xy, mlp["w1"]) + mlp["b1"], min=0.0)


def scatter_back(attn_flat: torch.Tensor, canon: torch.Tensor) -> torch.Tensor:
    """Gather each pillar's canonical set-slot output.  attn_flat: [S*K, C]
    (row = flat slot); canon: [P] flat slot, S*K = dump -> zeros."""
    n = attn_flat.shape[0]
    out = attn_flat[canon.clamp(max=n - 1)]
    return torch.where((canon < n)[:, None], out, torch.zeros_like(out))


def fold_encoder(enc: dict, mlp: dict) -> dict:
    """The derived weights of one encoder pass, made once when the weights
    are carried to the device (``weights.from_jax_params``): w_qkv [C, 3C],
    w_pos [C, 3C] (pos-embed linear2 folded into q and k, zero for v) and
    b_qkv [3C] in f32, w_qkv and w_pos again in bf16 for the fast paths'
    products, and kernel B2's operands (``encoder_kernel.kernel_weights``)."""
    w_qkv = torch.cat([enc["wq"], enc["wk"], enc["wv"]], dim=1)
    w_pos = torch.cat([mlp["w2"] @ enc["wq"], mlp["w2"] @ enc["wk"],
                       torch.zeros_like(enc["wv"])], dim=1)
    b_qkv = torch.cat([mlp["b2"] @ enc["wq"] + enc["bq"],
                       mlp["b2"] @ enc["wk"] + enc["bk"], enc["bv"]])
    return {"w_qkv": w_qkv, "w_pos": w_pos, "b_qkv": b_qkv,
            "w_qkv_bf16": w_qkv.to(torch.bfloat16),
            "w_pos_bf16": w_pos.to(torch.bfloat16),
            **encoder_kernel.kernel_weights(enc)}


def backbone3d_forward(pillar_feats: torch.Tensor,
                       window_parts: Sequence[WindowPartition],
                       set_parts: Sequence[SetPartition],
                       params: dict, cfg: DSVTConfig, *,
                       use_kernels: bool) -> torch.Tensor:
    """pillar_feats: [P, C] -> [P, C] (f32) after the DSVT blocks, at
    ``cfg.precision``.  ``params`` as ``weights.from_jax_params`` makes
    them (with ``fold_encoder``'s weights).  ``use_kernels`` with bf16 or
    mixed precision takes the fused path (kernels B1 + B2)."""
    eps = cfg.ln_eps
    precision = cfg.precision
    mdt = matmul_dtype(precision)
    w_sfx = "_bf16" if mdt is torch.bfloat16 else ""
    hidden: List[List[torch.Tensor]] = [
        [pos_embed_hidden(window_parts[e].xy_centered,
                          params["posembed"][b][e])
         for e in range(2)] for b in range(cfg.num_blocks)]

    use_fused = use_kernels and precision in ("bf16", "mixed")

    x = pillar_feats
    for b in range(cfg.num_blocks):
        sp = set_parts[b % len(set_parts)]
        x_in = x
        for e in range(2):
            enc = params["blocks"][b]["enc"][e]
            qkv_p = (dense(x, enc["w_qkv" + w_sfx], None, mdt)
                     + dense(hidden[b][e], enc["w_pos" + w_sfx], None, mdt)
                     + enc["b_qkv"])

            attn = set_attention_qkv(qkv_p, sp.inds[e], sp.key_mask,
                                     cfg.num_heads, precision,
                                     use_kernels=use_fused, flat_out=True,
                                     set_count=sp.set_count)
            attn_p = scatter_back(attn, sp.canon[e])

            if use_fused:
                x = encoder_kernel.encoder_epilogue(x.float(), attn_p, enc, eps)
            else:
                attn_p = dense(attn_p, enc["wo"], enc["bo"], mdt)
                x1 = layer_norm(x + attn_p, enc["ln1_g"], enc["ln1_b"], eps)
                x2 = layer_norm(x1 + ffn(x1, enc, precision),
                                enc["ln2_g"], enc["ln2_b"], eps)
                x = layer_norm(x2 + x, enc["norm_g"], enc["norm_b"], eps)
        x = layer_norm(x + x_in, params["blocks"][b]["res_g"],
                       params["blocks"][b]["res_b"], eps)
    return x
