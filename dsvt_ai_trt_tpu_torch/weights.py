"""Weight management: checkpoint names, loaders, folding, and the move to torch.

A copy of the JAX package's NumPy checkpoint code (the port imports nothing
of that package): the same ``module.*`` name contract of the reference's
``.wts`` dump, the same BatchNorm folding, and the same nested-dict layout
(``prepare_params``: linears ``[in, out]``, convs HWIO, deconvs
``[in, out, k, k]``).  ``random_params`` therefore equals the JAX one bit for
bit, and ``from_jax_params`` carries either package's dict to torch tensors
on a device, transposing conv weights to torch's OIHW.

For training: ``trainable`` lists the leaves of that dict (the tensors an
optimizer updates), ``refold`` remakes the derived weights (the encoders'
packed projections and kernel operands, the BEV convs' bf16 copies where
``fold_convs`` made them) after an update, ``to_jax_params`` carries the
tensors back to the NumPy dict (HWIO convs) and ``unfold_params`` turns
them into a raw ``module.*`` checkpoint for ``save_wts``.
"""

from __future__ import annotations

import itertools
import struct
from typing import Dict, List

import numpy as np

from .config import (DSVTConfig, head_branches, query_branches, query_head,
                     stage_blocks, stage_specs, staged, BACKBONE2D_STAGES,
                     BACKBONE2D_DEBLOCK, BACKBONE2D_OUT_CHANNELS)

Raw = Dict[str, np.ndarray]

# ---------------------------------------------------------------------------
# Raw parameter specification (name -> shape), torch state_dict layout.
# ---------------------------------------------------------------------------


def _bn_names(prefix: str, c: int) -> Dict[str, tuple]:
    return {
        f"{prefix}.weight": (c,),
        f"{prefix}.bias": (c,),
        f"{prefix}.running_mean": (c,),
        f"{prefix}.running_var": (c,),
    }


def block_names(cfg: DSVTConfig):
    """(global block b, stage s, block j of the stage) of every DSVT block:
    upstream names block b ``stage_{s}.{j}`` (the pillar model: s = 0,
    j = b)."""
    return [(b, s, b - blocks.start)
            for s, blocks in enumerate(stage_blocks(cfg)) for b in blocks]


def pos_in_dim(cfg: DSVTConfig, s: int) -> int:
    """Inputs of stage s's position embedding: (x, y, z) in the window where
    the stage's grid has more than one z cell, else (x, y)."""
    return 3 if stage_specs(cfg)[s].sparse_shape[2] > 1 else 2


def pool_prefix(s: int) -> str:
    """Upstream's name of the pooling after stage s."""
    return f"module.backbone_3d.stage_{s}_reduction"


def param_spec(cfg: DSVTConfig) -> Dict[str, tuple]:
    """All raw tensor names and shapes, matching the upstream checkpoint.

    QKV projections appear pre-split (``.query/.key/.value``) exactly as the
    reference's loadWeights_new leaves them in its weightMap
    (helper.h:353-434).  A staged configuration adds each stage's blocks
    under ``stage_{s}`` and the poolings between stages
    (``stage_{s}_reduction``: in- and out-projections, LayerNorm and the
    per-slot ``pos_embedding``).
    """
    d = cfg.d_model
    spec: Dict[str, tuple] = {}

    # PFN (reference graph: dsvt-ai-trt.cpp:577-590)
    c0, c1 = cfg.pfn_channels
    spec["module.vfe.pfn_layers.0.linear.weight"] = (c0, cfg.pillar_feature_num)
    spec.update(_bn_names("module.vfe.pfn_layers.0.norm", c0))
    spec["module.vfe.pfn_layers.1.linear.weight"] = (c1, 2 * c0)
    spec.update(_bn_names("module.vfe.pfn_layers.1.norm", c1))

    # position embedding MLPs: posembed_layers.0.{block}.{pass} (cpp:603-637)
    for _b, s, j in block_names(cfg):
        for e in range(2):
            p = f"module.backbone_3d.input_layer.posembed_layers.{s}.{j}.{e}.position_embedding_head"
            spec[f"{p}.0.weight"] = (d, pos_in_dim(cfg, s))
            spec[f"{p}.0.bias"] = (d,)
            spec.update(_bn_names(f"{p}.1", d))
            spec[f"{p}.3.weight"] = (d, d)
            spec[f"{p}.3.bias"] = (d,)

    # DSVT blocks: stage_0.{b}.encoder_list.{e} (cpp:648-1120)
    for _b, s, j in block_names(cfg):
        for e in range(2):
            p = f"module.backbone_3d.stage_{s}.{j}.encoder_list.{e}"
            for part in ("query", "key", "value"):
                spec[f"{p}.win_attn.self_attn.in_proj_weight.{part}"] = (d, d)
                spec[f"{p}.win_attn.self_attn.in_proj_bias.{part}"] = (d,)
            spec[f"{p}.win_attn.self_attn.out_proj.weight"] = (d, d)
            spec[f"{p}.win_attn.self_attn.out_proj.bias"] = (d,)
            for ln in ("norm1", "norm2"):
                spec[f"{p}.win_attn.{ln}.weight"] = (d,)
                spec[f"{p}.win_attn.{ln}.bias"] = (d,)
            spec[f"{p}.win_attn.linear1.weight"] = (cfg.ffn_dim, d)
            spec[f"{p}.win_attn.linear1.bias"] = (cfg.ffn_dim,)
            spec[f"{p}.win_attn.linear2.weight"] = (d, cfg.ffn_dim)
            spec[f"{p}.win_attn.linear2.bias"] = (d,)
            spec[f"{p}.norm.weight"] = (d,)
            spec[f"{p}.norm.bias"] = (d,)
        spec[f"module.backbone_3d.residual_norm_stage_{s}.{j}.weight"] = (d,)
        spec[f"module.backbone_3d.residual_norm_stage_{s}.{j}.bias"] = (d,)

    # poolings between stages (upstream Stage_ReductionAtt_Block)
    for s, st in enumerate(stage_specs(cfg)[:-1]):
        p = pool_prefix(s)
        for part in ("query", "key", "value"):
            spec[f"{p}.self_attn.in_proj_weight.{part}"] = (d, d)
            spec[f"{p}.self_attn.in_proj_bias.{part}"] = (d,)
        spec[f"{p}.self_attn.out_proj.weight"] = (d, d)
        spec[f"{p}.self_attn.out_proj.bias"] = (d,)
        spec[f"{p}.norm.weight"] = (d,)
        spec[f"{p}.norm.bias"] = (d,)
        spec[f"{p}.pos_embedding"] = (st.pool_volume, d)

    # 2D BEV ResNet (cpp:1140-1364)
    in_ch = d
    for s, (units, ch, _stride) in enumerate(BACKBONE2D_STAGES):
        for u in range(units):
            p = f"module.backbone_2d.blocks.{s}.{u}"
            u_in = in_ch if u == 0 else ch
            spec[f"{p}.conv1.weight"] = (ch, u_in, 3, 3)
            spec.update(_bn_names(f"{p}.bn1", ch))
            spec[f"{p}.conv2.weight"] = (ch, ch, 3, 3)
            spec.update(_bn_names(f"{p}.bn2", ch))
            if u == 0:
                spec[f"{p}.downsample_layer.0.weight"] = (ch, u_in, 1, 1)
                spec.update(_bn_names(f"{p}.downsample_layer.1", ch))
        in_ch = ch
    stage_ch = [c for (_u, c, _s) in BACKBONE2D_STAGES]
    for s, (k, _stride) in enumerate(BACKBONE2D_DEBLOCK):
        # ConvTranspose2d weight layout: (in, out, kH, kW)
        spec[f"module.backbone_2d.deblocks.{s}.0.weight"] = (stage_ch[s], 128, k, k)
        spec.update(_bn_names(f"module.backbone_2d.deblocks.{s}.1", 128))

    if query_head(cfg):
        spec.update(query_head_spec(cfg))
        return spec

    # CenterHead (cpp:1369-1468)
    spec["module.dense_head.shared_conv.0.weight"] = (cfg.head_shared_channels, 128 * 3, 3, 3)
    spec.update(_bn_names("module.dense_head.shared_conv.1", cfg.head_shared_channels))
    for name, out_c in head_branches(cfg):
        p = f"module.dense_head.heads_list.0.{name}"
        spec[f"{p}.0.0.weight"] = (cfg.head_conv_channels, cfg.head_shared_channels, 3, 3)
        spec.update(_bn_names(f"{p}.0.1", cfg.head_conv_channels))
        spec[f"{p}.1.weight"] = (out_c, cfg.head_conv_channels, 3, 3)
        spec[f"{p}.1.bias"] = (out_c,)

    return spec


QUERY_HEAD = "module.dense_head"


def query_head_spec(cfg: DSVTConfig) -> Dict[str, tuple]:
    """The TransFusion-L head's tensors under OpenPCDet's ``dense_head``
    names (transfusion_head.py): the shared conv, the heatmap head
    (BasicBlock2D, conv), the class encoding, the decoder layer (two
    ``nn.MultiheadAttention``, the FFN, three LayerNorms, the two
    ``PositionEmbeddingLearned``) and the prediction branches
    (SeparateHead_Transfusion)."""
    C, F, B = cfg.query_channels, cfg.query_ffn_dim, cfg.query_branch_channels
    p, d = QUERY_HEAD, f"{QUERY_HEAD}.decoder"
    spec = {f"{p}.shared_conv.weight": (C, BACKBONE2D_OUT_CHANNELS, 3, 3),
            f"{p}.shared_conv.bias": (C,),
            f"{p}.heatmap_head.0.conv.weight": (C, C, 3, 3)}
    spec.update(_bn_names(f"{p}.heatmap_head.0.bn", C))
    spec[f"{p}.heatmap_head.1.weight"] = (cfg.num_classes, C, 3, 3)
    spec[f"{p}.heatmap_head.1.bias"] = (cfg.num_classes,)
    spec[f"{p}.class_encoding.weight"] = (C, cfg.num_classes, 1)
    spec[f"{p}.class_encoding.bias"] = (C,)
    for attn in ("self_attn", "multihead_attn"):
        spec[f"{d}.{attn}.in_proj_weight"] = (3 * C, C)
        spec[f"{d}.{attn}.in_proj_bias"] = (3 * C,)
        spec[f"{d}.{attn}.out_proj.weight"] = (C, C)
        spec[f"{d}.{attn}.out_proj.bias"] = (C,)
    spec[f"{d}.linear1.weight"] = (F, C)
    spec[f"{d}.linear1.bias"] = (F,)
    spec[f"{d}.linear2.weight"] = (C, F)
    spec[f"{d}.linear2.bias"] = (C,)
    for n in (1, 2, 3):
        spec[f"{d}.norm{n}.weight"] = (C,)
        spec[f"{d}.norm{n}.bias"] = (C,)
    for pe in ("self_posembed", "cross_posembed"):
        e = f"{d}.{pe}.position_embedding_head"
        spec[f"{e}.0.weight"] = (C, 2, 1)
        spec[f"{e}.0.bias"] = (C,)
        spec.update(_bn_names(f"{e}.1", C))
        spec[f"{e}.3.weight"] = (C, C, 1)
        spec[f"{e}.3.bias"] = (C,)
    for name, out_c in query_branches(cfg):
        b = f"{p}.prediction_head.{name}"
        spec[f"{b}.0.0.weight"] = (B, C, 1)
        spec.update(_bn_names(f"{b}.0.1", B))
        spec[f"{b}.1.weight"] = (out_c, B, 1)
        spec[f"{b}.1.bias"] = (out_c,)
    return spec


# the final convs' biases of TransFusion-L's branches: quiet weights and
# these biases give boxes of a few metres, as the CenterHead's random head;
# the heatmap's at upstream's init, -2.19
QUERY_BIAS = {"center": 0.2, "height": -0.5, "dim": 0.3, "rot": 0.2,
              "vel": 0.0, "heatmap": -2.19}


def grid_bn_stats(w: np.ndarray, b: np.ndarray, cfg: DSVTConfig):
    """BatchNorm statistics of ``x @ w.T + b`` over every cell's bev_pos
    (x uniform over 0.5 .. X - 0.5, y over 0.5 .. Y - 0.5, independent):
    the running mean and variance a trained position embedding's BN holds,
    so that random weights embed positions at unit scale."""
    X, Y = cfg.grid_size[0], cfg.grid_size[1]
    w = w.reshape(len(b), 2)
    mean = w[:, 0] * X / 2.0 + w[:, 1] * Y / 2.0 + b
    var = w[:, 0] ** 2 * (X * X - 1) / 12.0 + w[:, 1] ** 2 * (Y * Y - 1) / 12.0
    return mean.astype(np.float32), var.astype(np.float32)


def random_raw(cfg: DSVTConfig, seed: int = 0, scale: float = 0.05) -> Raw:
    """Synthesize a random checkpoint with the real name/shape contract.

    Used for goldens and benchmarks while no real ``dsvt.wts`` is available
    (the reference snapshot itself ships without it — .MISSING_LARGE_BLOBS).
    """
    rng = np.random.default_rng(seed)
    raw: Raw = {}
    for name, shape in param_spec(cfg).items():
        if name.endswith("running_var"):
            raw[name] = np.abs(rng.normal(1.0, 0.1, shape)).astype(np.float32)
        elif name.endswith("running_mean"):
            raw[name] = rng.normal(0.0, scale, shape).astype(np.float32)
        elif ".norm" in name or "bn" in name or "norm1" in name or name.endswith((".weight",)) and len(shape) == 1:
            # 1-D gamma / LN weights near 1, biases near 0
            if name.endswith(".weight"):
                raw[name] = np.ones(shape, np.float32) + rng.normal(0, 0.02, shape).astype(np.float32)
            else:
                raw[name] = rng.normal(0, scale, shape).astype(np.float32)
        else:
            # He/fan-in scaling keeps activations O(1) through the 12-conv
            # BEV stack (a fixed std amplifies ~2x per conv and saturates
            # every head output)
            if len(shape) >= 2:
                fan_in = int(np.prod(shape[1:]))
                std = float(np.sqrt(2.0 / fan_in))
            else:
                std = scale
            raw[name] = rng.normal(0.0, std, shape).astype(np.float32)

    # Make the synthetic checkpoint produce *realistic* detections instead of
    # exp-overflowed garbage: tame the head's final convs and set biases so
    # heatmap scores sit around the 0.3 threshold and dims decode to a few
    # meters.  Without this, parity/NMS behavior on random weights is
    # degenerate (dims ~ e^50).
    if query_head(cfg):
        _quiet_query_head(raw, cfg, rng)
        return raw
    head_bias = {"hm": -2.0, "dim": 0.3, "center": 0.2, "center_z": -0.5,
                 "rot": 0.2, "iou": 0.0}
    for branch, bias in head_bias.items():
        wname = f"module.dense_head.heads_list.0.{branch}.1.weight"
        bname = f"module.dense_head.heads_list.0.{branch}.1.bias"
        raw[wname] = rng.normal(0, 0.02, raw[wname].shape).astype(np.float32)
        raw[bname] = (bias + rng.normal(0, 0.1, raw[bname].shape)).astype(np.float32)
    return raw


def _quiet_query_head(raw: Raw, cfg: DSVTConfig, rng) -> None:
    """The TransFusion-L head's random checkpoint made usable: quiet final
    convs with ``QUERY_BIAS`` biases (the heatmap conv's too), attention
    projections at ``nn.MultiheadAttention``'s Xavier scale, and the
    position embeddings' BatchNorm statistics of the grid
    (``grid_bn_stats``)."""
    p, d = QUERY_HEAD, f"{QUERY_HEAD}.decoder"
    finals = [(f"{p}.prediction_head.{n}.1", n) for n, _ in
              query_branches(cfg)] + [(f"{p}.heatmap_head.1", "heatmap")]
    for conv, branch in finals:
        shape = raw[f"{conv}.weight"].shape
        raw[f"{conv}.weight"] = rng.normal(0, 0.02, shape).astype(np.float32)
        raw[f"{conv}.bias"] = np.full(shape[0], QUERY_BIAS[branch],
                                      np.float32)
    for attn in ("self_attn", "multihead_attn"):
        w = f"{d}.{attn}.in_proj_weight"
        std = float(np.sqrt(2.0 / sum(raw[w].shape)))
        raw[w] = rng.normal(0, std, raw[w].shape).astype(np.float32)
    for pe in ("self_posembed", "cross_posembed"):
        e = f"{d}.{pe}.position_embedding_head"
        raw[f"{e}.1.running_mean"], raw[f"{e}.1.running_var"] = \
            grid_bn_stats(raw[f"{e}.0.weight"], raw[f"{e}.0.bias"], cfg)


def calibrated_raw(cfg: DSVTConfig, points, num_points, seed: int = 0,
                   n_boxes: int = 40, device: str = "cuda") -> Raw:
    """A structured synthetic checkpoint that produces a *sparse* set of
    confident detections on the given calibration cloud.

    random_raw alone yields thousands of above-threshold noise detections,
    so the per-class top-k waterline sits in a dense score region and box
    membership churns under any numeric perturbation (precision change,
    accumulation order) — parity can then only be asserted loosely.  Here
    the heatmap branch bias is shifted so that only ~n_boxes cells clear
    the 0.3 score threshold: the top-k never truncates, every confident box
    is far from the waterline, and cross-implementation / cross-precision
    parity becomes assertable at ~1.0.

    The calibration pass is this package's ``forward_debug`` on ``device``
    (the JAX copy runs its own; at fp32 the two shifts agree to float
    rounding).
    """
    raw = random_raw(cfg, seed)
    # car-sized boxes: tiny random-weight dims (~exp(0) * noise ~ 0.2 m)
    # make IoU matching degenerate — a one-cell center flip zeroes the
    # overlap.  Pin the dim branch to quiet weights + log(car) biases so a
    # 0.32 m drift keeps IoU >= 0.8 like real detections.
    rng = np.random.default_rng(seed + 1)
    wname = "module.dense_head.heads_list.0.dim.1.weight"
    bname_d = "module.dense_head.heads_list.0.dim.1.bias"
    raw[wname] = rng.normal(0, 0.005, raw[wname].shape).astype(np.float32)
    raw[bname_d] = np.log([4.2, 1.9, 1.7]).astype(np.float32)
    # ... and decisive headings: raw random rot outputs are ~0, so the
    # decoded atan2 is numerically unstable (a 0.01 logit drift can rotate
    # a box 45 degrees and sink its IoU) — trained rot heads saturate
    # cos/sin far from the origin
    wname_r = "module.dense_head.heads_list.0.rot.1.weight"
    bname_r = "module.dense_head.heads_list.0.rot.1.bias"
    raw[wname_r] = rng.normal(0, 0.02, raw[wname_r].shape).astype(np.float32)
    raw[bname_r] = np.array([0.9, 0.35], np.float32)

    from .model.detector import forward_debug  # local: avoids import cycle

    params = from_jax_params(prepare_params(raw, cfg), device)
    dbg = forward_debug(params, points, num_points, cfg, device=device)
    logits = dbg.head_out["hm"].detach().double().cpu().numpy().ravel()
    kth = np.sort(logits)[-n_boxes]
    # shift so the n_boxes-th largest logit lands at sigmoid^-1(0.38):
    # confident boxes sit >=0.08 above the 0.3 threshold, everything else
    # falls well below it
    shift = np.log(0.38 / 0.62) - kth
    bname = f"module.dense_head.heads_list.0.hm.1.bias"
    raw[bname] = (raw[bname] + np.float32(shift)).astype(np.float32)
    return raw


# ---------------------------------------------------------------------------
# Loaders
# ---------------------------------------------------------------------------


def load_wts(path: str) -> Raw:
    """Parse the reference's text .wts format (helper.h:286-439).

    Format: first line = tensor count; then per tensor one line
    ``name length hex hex ...`` with big-endian float32 hex words
    (gen_wts.py:86-99).  Fused ``*.in_proj_*`` blobs are split into thirds
    named ``.query/.key/.value`` exactly like loadWeights_new.
    """
    raw: Raw = {}
    with open(path, "r") as f:
        count = int(f.readline().strip())
        for _ in range(count):
            line = f.readline().split()
            name, n = line[0], int(line[1])
            words = line[2:2 + n]
            arr = np.frombuffer(
                bytes.fromhex("".join(w.zfill(8) for w in words)),
                dtype=">f4").astype(np.float32)
            assert arr.size == n, f"{name}: expected {n} values, got {arr.size}"
            if ".in_proj_" in name:
                third = n // 3
                for i, part in enumerate(("query", "key", "value")):
                    raw[f"{name}.{part}"] = arr[i * third:(i + 1) * third].copy()
            else:
                raw[name] = arr
    return raw


def save_wts(raw: Raw, path: str) -> None:
    """Write the .wts text format (gen_wts.py:86-99), re-fusing QKV splits."""
    fused: Dict[str, np.ndarray] = {}
    pending: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in raw.items():
        for part in ("query", "key", "value"):
            suffix = f".{part}"
            if name.endswith(suffix) and ".in_proj_" in name:
                pending.setdefault(name[: -len(suffix)], {})[part] = arr
                break
        else:
            fused[name] = arr
    for base, parts in pending.items():
        fused[base] = np.concatenate(
            [parts["query"].ravel(), parts["key"].ravel(), parts["value"].ravel()])
    with open(path, "w") as f:
        f.write(f"{len(fused)}\n")
        for name, arr in fused.items():
            flat = np.asarray(arr, np.float32).ravel()
            f.write(f"{name} {flat.size} ")
            f.write(" ".join(struct.pack(">f", float(v)).hex() for v in flat))
            f.write("\n")


def load_npz(path: str) -> Raw:
    """An .npz of raw tensors; a fused ``*.in_proj_*`` entry is split into
    q/k/v thirds of its first axis, each kept 2-D (as the JAX package's)."""
    data = np.load(path)
    raw: Raw = {}
    for name in data.files:
        arr = np.asarray(data[name], np.float32)
        if ".in_proj_" in name and not name.endswith((".query", ".key", ".value")):
            third = arr.shape[0] // 3
            flat = arr.reshape(arr.shape[0], -1)
            for i, part in enumerate(("query", "key", "value")):
                raw[f"{name}.{part}"] = flat[i * third:(i + 1) * third]
        else:
            raw[name] = arr
    return raw


def save_npz(raw: Raw, path: str) -> None:
    np.savez(path, **raw)


def load_torch(path: str) -> Raw:
    """Load a torch checkpoint (on the CPU) and split fused in_proj tensors.
    Only tensors are read (``weights_only``): a checkpoint is outside input."""
    import torch

    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    raw: Raw = {}
    for name, tensor in state.items():
        arr = tensor.detach().cpu().numpy().astype(np.float32)
        if not name.startswith("module."):
            name = "module." + name
        if ".in_proj_" in name:
            third = arr.shape[0] // 3
            flat = arr.reshape(arr.shape[0], -1)
            for i, part in enumerate(("query", "key", "value")):
                raw[f"{name}.{part}"] = flat[i * third:(i + 1) * third].reshape(
                    (third,) + arr.shape[1:])
        else:
            raw[name] = arr
    return raw


def load_checkpoint(path: str) -> Raw:
    """.wts, .npz or a torch checkpoint, by the file's extension."""
    if path.endswith(".wts"):
        return load_wts(path)
    if path.endswith(".npz"):
        return load_npz(path)
    return load_torch(path)


# ---------------------------------------------------------------------------
# Folding into the compute-ready nested dict
# ---------------------------------------------------------------------------


def _bn_affine(raw: Raw, prefix: str, eps: float):
    g = raw[f"{prefix}.weight"]
    b = raw[f"{prefix}.bias"]
    mean = raw[f"{prefix}.running_mean"]
    var = raw[f"{prefix}.running_var"]
    scale = g / np.sqrt(var + eps)
    shift = b - mean * scale
    return scale.astype(np.float32), shift.astype(np.float32)


def _linear_bn(raw: Raw, lin: str, bn: str, eps: float, bias: bool = False):
    """Fold linear (torch [out,in]) + BN1d into x @ w + b.

    All fold helpers reshape from the BN/branch channel counts, because
    the .wts text format stores shapeless flat blobs (gen_wts.py:86-99 —
    the reference's loader also reshapes at the consumer, helper.h:288)."""
    scale, shift = _bn_affine(raw, bn, eps)
    w = raw[f"{lin}.weight"].reshape(len(scale), -1)
    wf = (w * scale[:, None]).T.astype(np.float32)  # [in, out]
    bf = shift.copy()
    if bias:
        bf = bf + raw[f"{lin}.bias"] * scale
    return wf, bf.astype(np.float32)


def _linear(raw: Raw, prefix: str, in_dim: int):
    w = raw[f"{prefix}.weight"].reshape(-1, in_dim)
    return w.T.astype(np.float32).copy(), raw[f"{prefix}.bias"].astype(np.float32).copy()


def _conv_bn(raw: Raw, conv: str, bn: str, eps: float, kernel=(3, 3)):
    """Fold OIHW conv + BN2d into HWIO conv + bias (flat blobs reshaped
    from the BN channel count + the known kernel size)."""
    scale, shift = _bn_affine(raw, bn, eps)
    w = raw[f"{conv}.weight"].reshape(  # [O, I, H, W]
        len(scale), -1, kernel[0], kernel[1])
    w = w * scale[:, None, None, None]
    return np.transpose(w, (2, 3, 1, 0)).astype(np.float32).copy(), shift


def _conv_bias(raw: Raw, conv: str, out_ch: int, kernel=(3, 3)):
    w = raw[f"{conv}.weight"].reshape(out_ch, -1, kernel[0], kernel[1])
    return (np.transpose(w, (2, 3, 1, 0)).astype(np.float32).copy(),
            raw[f"{conv}.bias"].astype(np.float32).copy())


def prepare_params(raw: Raw, cfg: DSVTConfig) -> Dict:
    """Fold the raw checkpoint into the compute-ready nested dict (NumPy)."""
    d = cfg.d_model
    c0, c1 = cfg.pfn_channels
    p: Dict = {}

    w0, b0 = _linear_bn(raw, "module.vfe.pfn_layers.0.linear",
                        "module.vfe.pfn_layers.0.norm", cfg.bn1d_eps)
    w1, b1 = _linear_bn(raw, "module.vfe.pfn_layers.1.linear",
                        "module.vfe.pfn_layers.1.norm", cfg.bn1d_eps)
    p["vfe"] = {"l0": {"w": w0, "b": b0}, "l1": {"w": w1, "b": b1}}

    pos: List[List[Dict]] = []
    for _b, s, j in block_names(cfg):
        row = []
        for e in range(2):
            pre = f"module.backbone_3d.input_layer.posembed_layers.{s}.{j}.{e}.position_embedding_head"
            w1e, b1e = _linear_bn(raw, f"{pre}.0", f"{pre}.1", cfg.bn1d_eps, bias=True)
            w2e, b2e = _linear(raw, f"{pre}.3", d)
            row.append({"w1": w1e, "b1": b1e, "w2": w2e, "b2": b2e})
        pos.append(row)
    p["posembed"] = pos

    blocks: List[Dict] = []
    for _b, s, j in block_names(cfg):
        encs = []
        for e in range(2):
            pre = f"module.backbone_3d.stage_{s}.{j}.encoder_list.{e}"
            attn = f"{pre}.win_attn.self_attn"
            enc = {}
            for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
                w = raw[f"{attn}.in_proj_weight.{part}"].reshape(d, d)
                enc[f"w{key}"] = w.T.astype(np.float32).copy()
                enc[f"b{key}"] = raw[f"{attn}.in_proj_bias.{part}"].astype(np.float32).copy()
            enc["wo"], enc["bo"] = _linear(raw, f"{attn}.out_proj", d)
            for ln, key in (("norm1", "ln1"), ("norm2", "ln2")):
                enc[f"{key}_g"] = raw[f"{pre}.win_attn.{ln}.weight"].astype(np.float32)
                enc[f"{key}_b"] = raw[f"{pre}.win_attn.{ln}.bias"].astype(np.float32)
            enc["ffn_w1"], enc["ffn_b1"] = _linear(raw, f"{pre}.win_attn.linear1", d)
            enc["ffn_w2"], enc["ffn_b2"] = _linear(raw, f"{pre}.win_attn.linear2", cfg.ffn_dim)
            enc["norm_g"] = raw[f"{pre}.norm.weight"].astype(np.float32)
            enc["norm_b"] = raw[f"{pre}.norm.bias"].astype(np.float32)
            encs.append(enc)
        blocks.append({
            "enc": encs,
            "res_g": raw[f"module.backbone_3d.residual_norm_stage_{s}.{j}.weight"].astype(np.float32),
            "res_b": raw[f"module.backbone_3d.residual_norm_stage_{s}.{j}.bias"].astype(np.float32),
        })
    p["blocks"] = blocks
    if staged(cfg):
        p["pool"] = [_pool_leaves(raw, s, d) for s in range(len(cfg.stages) - 1)]

    stages = []
    for s, (units, ch, _stride) in enumerate(BACKBONE2D_STAGES):
        stage = []
        for u in range(units):
            pre = f"module.backbone_2d.blocks.{s}.{u}"
            unit = {}
            unit["conv1_w"], unit["conv1_b"] = _conv_bn(raw, f"{pre}.conv1", f"{pre}.bn1", cfg.bn2d_eps)
            unit["conv2_w"], unit["conv2_b"] = _conv_bn(raw, f"{pre}.conv2", f"{pre}.bn2", cfg.bn2d_eps)
            if u == 0:
                unit["down_w"], unit["down_b"] = _conv_bn(
                    raw, f"{pre}.downsample_layer.0", f"{pre}.downsample_layer.1", cfg.bn2d_eps,
                    kernel=(1, 1))
            stage.append(unit)
        stages.append(stage)
    deblocks = []
    for s, (k, _stride) in enumerate(BACKBONE2D_DEBLOCK):
        pre = f"module.backbone_2d.deblocks.{s}"
        scale, shift = _bn_affine(raw, f"{pre}.1", cfg.bn2d_eps)
        # ConvTranspose2d [in, out, k, k]; out from the BN channel count
        w = raw[f"{pre}.0.weight"].reshape(-1, len(scale), k, k)
        # fold BN over out channels; keep layout [in, out, k, k] for the
        # einsum-based stride==kernel upsampling in backbone2d
        w = w * scale[None, :, None, None]
        deblocks.append({"w": w.astype(np.float32).copy(), "b": shift})
    p["backbone2d"] = {"stages": stages, "deblocks": deblocks}

    if query_head(cfg):
        p["head"] = _query_head_leaves(raw, cfg)
        return p

    head: Dict = {}
    head["shared_w"], head["shared_b"] = _conv_bn(
        raw, "module.dense_head.shared_conv.0", "module.dense_head.shared_conv.1", cfg.bn2d_eps)
    for name, c in head_branches(cfg):
        pre = f"module.dense_head.heads_list.0.{name}"
        w0h, b0h = _conv_bn(raw, f"{pre}.0.0", f"{pre}.0.1", cfg.bn2d_eps)
        w1h, b1h = _conv_bias(raw, f"{pre}.1", c)
        head[name] = {"w0": w0h, "b0": b0h, "w1": w1h, "b1": b1h}
    p["head"] = head
    return p


def _query_head_leaves(raw: Raw, cfg: DSVTConfig) -> Dict:
    """The TransFusion-L head folded: convs HWIO with their BatchNorm
    folded (PyTorch's default eps, 1e-5 = ``bn1d_eps``, for every BN of
    the head), linears [in, out], the class encoding [classes, C]; the
    attentions' in-projections split into q, k, v."""
    C, eps = cfg.query_channels, cfg.bn1d_eps
    p, d = QUERY_HEAD, f"{QUERY_HEAD}.decoder"
    head: Dict = {}
    head["shared_w"], head["shared_b"] = _conv_bias(raw, f"{p}.shared_conv", C)
    w0, b0 = _conv_bn(raw, f"{p}.heatmap_head.0.conv", f"{p}.heatmap_head.0.bn",
                      eps)
    w1, b1 = _conv_bias(raw, f"{p}.heatmap_head.1", cfg.num_classes)
    head["hm"] = {"w0": w0, "b0": b0, "w1": w1, "b1": b1}
    head["class_w"] = raw[f"{p}.class_encoding.weight"].reshape(
        C, cfg.num_classes).T.astype(np.float32).copy()
    head["class_b"] = raw[f"{p}.class_encoding.bias"].astype(np.float32).copy()
    for key, pe in (("self_pos", "self_posembed"),
                    ("cross_pos", "cross_posembed")):
        e = f"{d}.{pe}.position_embedding_head"
        w1e, b1e = _linear_bn(raw, f"{e}.0", f"{e}.1", eps, bias=True)
        w2e, b2e = _linear(raw, f"{e}.3", C)
        head[key] = {"w1": w1e, "b1": b1e, "w2": w2e, "b2": b2e}
    for key, attn in (("self_attn", "self_attn"),
                      ("cross_attn", "multihead_attn")):
        w = raw[f"{d}.{attn}.in_proj_weight"].reshape(3 * C, C)
        b = raw[f"{d}.{attn}.in_proj_bias"]
        leaves = {}
        for i, part in enumerate("qkv"):
            leaves[f"w{part}"] = w[i * C:(i + 1) * C].T.astype(np.float32).copy()
            leaves[f"b{part}"] = b[i * C:(i + 1) * C].astype(np.float32).copy()
        leaves["wo"], leaves["bo"] = _linear(raw, f"{d}.{attn}.out_proj", C)
        head[key] = leaves
    head["ffn_w1"], head["ffn_b1"] = _linear(raw, f"{d}.linear1", C)
    head["ffn_w2"], head["ffn_b2"] = _linear(raw, f"{d}.linear2",
                                             cfg.query_ffn_dim)
    for n in (1, 2, 3):
        head[f"ln{n}_g"] = raw[f"{d}.norm{n}.weight"].astype(np.float32).copy()
        head[f"ln{n}_b"] = raw[f"{d}.norm{n}.bias"].astype(np.float32).copy()
    branches = {}
    for name, _c in query_branches(cfg):
        b = f"{p}.prediction_head.{name}"
        w1b, b1b = _linear_bn(raw, f"{b}.0.0", f"{b}.0.1", eps)
        w2b, b2b = _linear(raw, f"{b}.1", cfg.query_branch_channels)
        branches[name] = {"w1": w1b, "b1": b1b, "w2": w2b, "b2": b2b}
    head["branches"] = branches
    return head


def _pool_leaves(raw: Raw, s: int, d: int) -> Dict:
    """The pooling after stage s: linears [in, out], LayerNorm, pos [V, C]."""
    pre = pool_prefix(s)
    attn = f"{pre}.self_attn"
    leaves = {}
    for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
        w = raw[f"{attn}.in_proj_weight.{part}"].reshape(d, d)
        leaves[f"w{key}"] = w.T.astype(np.float32).copy()
        leaves[f"b{key}"] = raw[f"{attn}.in_proj_bias.{part}"].astype(np.float32).copy()
    leaves["wo"], leaves["bo"] = _linear(raw, f"{attn}.out_proj", d)
    leaves["ln_g"] = raw[f"{pre}.norm.weight"].astype(np.float32).copy()
    leaves["ln_b"] = raw[f"{pre}.norm.bias"].astype(np.float32).copy()
    leaves["pos"] = raw[f"{pre}.pos_embedding"].reshape(-1, d).astype(np.float32).copy()
    return leaves


def random_params(cfg: DSVTConfig, seed: int = 0) -> Dict:
    return prepare_params(random_raw(cfg, seed), cfg)


# ---------------------------------------------------------------------------
# To torch
# ---------------------------------------------------------------------------


def _conv_keys(path):
    """Which leaves are HWIO conv kernels (to be transposed to OIHW)."""
    if path[0] == "backbone2d":
        return path[-1] in ("conv1_w", "conv2_w", "down_w")
    if path[0] == "head":
        return path[-1] in ("shared_w", "w0", "w1")
    return False


def from_jax_params(params: Dict, device="cuda"):
    """The nested NumPy dict of ``prepare_params``/``random_params`` (either
    package's) -> the same nesting of float32 torch tensors on ``device``,
    copies of the arrays (training updates them in place).

    HWIO conv kernels become OIHW (``F.conv2d``'s layout); linears stay
    ``[in, out]`` (``x @ w``); deconv kernels are already torch's
    ``ConvTranspose2d`` layout ``[in, out, k, k]``.  Lists stay lists.
    For a whole model, each encoder pass also gets the weights that the
    forward pass derives from it, made here once rather than per frame
    (``refold``).
    """
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return to_torch_leaf(path, node, device)

    tree = walk(params, ())
    if "blocks" in tree:
        refold(tree)
    return tree


def fold_convs(params: Dict) -> Dict:
    """Add to a whole model the copies of its BEV ResNet's and head's conv
    weights that the bf16 and mixed convs read (``model.backbone2d.fold``:
    bf16 channels_last weight and bf16 bias, keys ending ``_bf16``), and
    the fused second convs' biases of the units with a down conv
    (``fold_shortcut_bias``), where they are missing.
    ``runtime.compile.Engine`` calls it at those precisions; ``refold``
    keeps the copies in step with the leaves."""
    import torch
    from .model.backbone2d import (BF16, SHORTCUT_B, conv_nodes, fold,
                                   fold_shortcut_bias,
                                   shortcut_units)  # local: cycle

    with torch.no_grad():
        for node, w_key, b_key in list(conv_nodes(params)):
            if w_key + BF16 not in node:
                node[w_key + BF16], node[b_key + BF16] = fold(node[w_key],
                                                              node[b_key])
        for unit in shortcut_units(params):
            if SHORTCUT_B not in unit:
                unit[SHORTCUT_B] = fold_shortcut_bias(unit)
    return params


def refold(params: Dict) -> Dict:
    """Remake the derived weights of a whole model from its current leaves,
    without autograd: every encoder pass's (``model.backbone3d.
    fold_encoder``: packed q/k/v projections and their bf16 copies, kernel
    B2's bf16 weights and stacked LayerNorm vectors), every pooling's
    (``fold_pool``) and the BEV convs' bf16 copies and summed biases that
    ``fold_convs`` made.  Run it after every change to
    the leaves: the inference path reads only the derived copies of those
    weights.  A derived weight that exists is written in place, so a CUDA
    graph that captured its address (an ``Engine``'s, a compiled training
    step's) reads the new values; a missing encoder weight is added."""
    import torch
    # local: avoids import cycles
    from .model.backbone2d import (BF16, SHORTCUT_B, conv_nodes, fold,
                                   fold_shortcut_bias, shortcut_units)
    from .model.backbone3d import fold_encoder, fold_pool

    with torch.no_grad():
        derived = itertools.chain(
            ((enc, fold_encoder(enc, params["posembed"][b][e]))
             for b, block in enumerate(params["blocks"])
             for e, enc in enumerate(block["enc"])),
            ((pool, fold_pool(pool)) for pool in params.get("pool", ())))
        for node, folded in derived:   # one node's at a time
            for k, v in folded.items():
                old = node.get(k)
                if (isinstance(old, torch.Tensor) and old.shape == v.shape
                        and old.dtype == v.dtype):
                    old.copy_(v)
                else:
                    node[k] = v
        for node, w_key, b_key in (conv_nodes(params) if "head" in params
                                   else ()):
            if w_key + BF16 in node:
                w, b = fold(node[w_key], node[b_key])
                node[w_key + BF16].copy_(w)
                node[b_key + BF16].copy_(b)
        for unit in (shortcut_units(params) if "head" in params else ()):
            if SHORTCUT_B in unit:
                unit[SHORTCUT_B].copy_(fold_shortcut_bias(unit))
    return params


def _is_folded(path) -> bool:
    from .model.backbone2d import BF16
    from .model.backbone3d import DERIVED_KEYS, POOL_FOLDED_KEYS
    from .model.transfusion import QUERY_DERIVED
    if path[0] == "blocks":
        return path[-1] in DERIVED_KEYS
    if path[0] == "pool":
        return path[-1] in POOL_FOLDED_KEYS
    return (path[0] in ("backbone2d", "head") and isinstance(path[-1], str)
            and (path[-1].endswith(BF16) or (path[0] == "head"
                                             and path[-1] in QUERY_DERIVED)))


def keystr(path) -> str:
    """A leaf's path as ``jax.tree_util.keystr`` writes it:
    ``['blocks'][0]['enc'][1]['wq']``."""
    return "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def named_leaves(params: Dict):
    """(path, tensor) of every leaf that JAX's ``prepare_params`` dict has
    (no derived key), in JAX's flattening order (sorted dict keys; list
    positions are path entries)."""
    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                if not _is_folded(path + (k,)):
                    yield from walk(node[k], path + (k,))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                yield from walk(v, path + (i,))
        else:
            yield path, node
    return list(walk(params, ()))


def trainable(params: Dict) -> list:
    """The tensors an optimizer updates: ``named_leaves`` without paths."""
    return [t for _, t in named_leaves(params)]


def to_torch_leaf(path, leaf, device):
    """One leaf of the JAX dict as a float32 tensor on ``device`` (a copy),
    convs OIHW."""
    import torch
    arr = np.asarray(leaf, np.float32)
    if _conv_keys(path) and arr.ndim == 4:
        arr = np.transpose(arr, (3, 2, 0, 1))
    return torch.tensor(np.ascontiguousarray(arr), device=device)


def to_numpy_leaf(path, tensor) -> np.ndarray:
    """One leaf as the JAX dict holds it: a float32 NumPy copy, convs
    HWIO."""
    arr = tensor.detach().float().cpu().numpy()
    if _conv_keys(path) and arr.ndim == 4:
        arr = np.transpose(arr, (2, 3, 1, 0))
    return np.array(arr, order="C", copy=True)


def to_jax_params(params: Dict) -> Dict:
    """Inverse of ``from_jax_params``: the nested NumPy dict of
    ``prepare_params`` (HWIO convs, no derived keys)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()
                    if not _is_folded(path + (k,))}
        if isinstance(node, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(node)]
        return to_numpy_leaf(path, node)
    return walk(params, ())


# ---------------------------------------------------------------------------
# Unfolding: the compute-ready dict -> a raw checkpoint (the .wts export of
# trained weights, keeping the module.* name contract)
# ---------------------------------------------------------------------------


def _identity_bn(c: int, eps: float, shift: np.ndarray) -> Dict[str, np.ndarray]:
    """BN stats that make the affine exactly (scale=1, shift=shift):
    running_var = 1 - eps so sqrt(var + eps) == 1."""
    return {
        "weight": np.ones(c, np.float32),
        "bias": np.asarray(shift, np.float32),
        "running_mean": np.zeros(c, np.float32),
        "running_var": np.full(c, 1.0 - eps, np.float32),
    }


def unfold_params(params: Dict, cfg: DSVTConfig) -> Raw:
    """Inverse of prepare_params for the port's tensors (``from_jax_params``
    layout): a raw state-dict that reproduces the same computation.  BN
    folds are not uniquely invertible, so folded linear/conv+BN pairs export
    as (trained weight, identity BN with the trained bias as BN shift),
    numerically identical under prepare_params (var + eps rounds to exactly
    1 in float32 at both BN epsilons) and loadable by the reference's
    loadWeights_new.  The JAX package's ``unfold_params`` of the same
    weights gives the same arrays bit for bit."""
    params = to_jax_params(params)
    raw: Raw = {}
    asnp = lambda t: np.asarray(t, np.float32)

    def lin_bn(prefix_lin, prefix_bn, w, b, eps, with_bias=False):
        raw[f"{prefix_lin}.weight"] = asnp(w).T.copy()        # [out, in]
        if with_bias:
            raw[f"{prefix_lin}.bias"] = np.zeros(w.shape[1], np.float32)
        for k, v in _identity_bn(w.shape[1], eps, asnp(b)).items():
            raw[f"{prefix_bn}.{k}"] = v

    def conv_bn(prefix_conv, prefix_bn, w, b, eps):
        raw[f"{prefix_conv}.weight"] = np.transpose(asnp(w), (3, 2, 0, 1)).copy()
        for k, v in _identity_bn(w.shape[3], eps, asnp(b)).items():
            raw[f"{prefix_bn}.{k}"] = v

    lin_bn("module.vfe.pfn_layers.0.linear", "module.vfe.pfn_layers.0.norm",
           params["vfe"]["l0"]["w"], params["vfe"]["l0"]["b"], cfg.bn1d_eps)
    lin_bn("module.vfe.pfn_layers.1.linear", "module.vfe.pfn_layers.1.norm",
           params["vfe"]["l1"]["w"], params["vfe"]["l1"]["b"], cfg.bn1d_eps)

    for b_i, s, j in block_names(cfg):
        for e in range(2):
            mlp = params["posembed"][b_i][e]
            pre = (f"module.backbone_3d.input_layer.posembed_layers.{s}."
                   f"{j}.{e}.position_embedding_head")
            lin_bn(f"{pre}.0", f"{pre}.1", mlp["w1"], mlp["b1"], cfg.bn1d_eps,
                   with_bias=True)
            raw[f"{pre}.3.weight"] = asnp(mlp["w2"]).T.copy()
            raw[f"{pre}.3.bias"] = asnp(mlp["b2"])

            enc = params["blocks"][b_i]["enc"][e]
            pre = f"module.backbone_3d.stage_{s}.{j}.encoder_list.{e}"
            attn = f"{pre}.win_attn.self_attn"
            for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
                raw[f"{attn}.in_proj_weight.{part}"] = asnp(enc[f"w{key}"]).T.copy()
                raw[f"{attn}.in_proj_bias.{part}"] = asnp(enc[f"b{key}"])
            raw[f"{attn}.out_proj.weight"] = asnp(enc["wo"]).T.copy()
            raw[f"{attn}.out_proj.bias"] = asnp(enc["bo"])
            for ln, key in (("norm1", "ln1"), ("norm2", "ln2")):
                raw[f"{pre}.win_attn.{ln}.weight"] = asnp(enc[f"{key}_g"])
                raw[f"{pre}.win_attn.{ln}.bias"] = asnp(enc[f"{key}_b"])
            raw[f"{pre}.win_attn.linear1.weight"] = asnp(enc["ffn_w1"]).T.copy()
            raw[f"{pre}.win_attn.linear1.bias"] = asnp(enc["ffn_b1"])
            raw[f"{pre}.win_attn.linear2.weight"] = asnp(enc["ffn_w2"]).T.copy()
            raw[f"{pre}.win_attn.linear2.bias"] = asnp(enc["ffn_b2"])
            raw[f"{pre}.norm.weight"] = asnp(enc["norm_g"])
            raw[f"{pre}.norm.bias"] = asnp(enc["norm_b"])
        raw[f"module.backbone_3d.residual_norm_stage_{s}.{j}.weight"] = asnp(
            params["blocks"][b_i]["res_g"])
        raw[f"module.backbone_3d.residual_norm_stage_{s}.{j}.bias"] = asnp(
            params["blocks"][b_i]["res_b"])
    for s, pool in enumerate(params.get("pool", ())):
        attn = f"{pool_prefix(s)}.self_attn"
        for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
            raw[f"{attn}.in_proj_weight.{part}"] = asnp(pool[f"w{key}"]).T.copy()
            raw[f"{attn}.in_proj_bias.{part}"] = asnp(pool[f"b{key}"])
        raw[f"{attn}.out_proj.weight"] = asnp(pool["wo"]).T.copy()
        raw[f"{attn}.out_proj.bias"] = asnp(pool["bo"])
        raw[f"{pool_prefix(s)}.norm.weight"] = asnp(pool["ln_g"])
        raw[f"{pool_prefix(s)}.norm.bias"] = asnp(pool["ln_b"])
        raw[f"{pool_prefix(s)}.pos_embedding"] = asnp(pool["pos"])

    for s, stage in enumerate(params["backbone2d"]["stages"]):
        for u, unit in enumerate(stage):
            pre = f"module.backbone_2d.blocks.{s}.{u}"
            conv_bn(f"{pre}.conv1", f"{pre}.bn1", unit["conv1_w"],
                    unit["conv1_b"], cfg.bn2d_eps)
            conv_bn(f"{pre}.conv2", f"{pre}.bn2", unit["conv2_w"],
                    unit["conv2_b"], cfg.bn2d_eps)
            if "down_w" in unit:
                conv_bn(f"{pre}.downsample_layer.0", f"{pre}.downsample_layer.1",
                        unit["down_w"], unit["down_b"], cfg.bn2d_eps)
    for s, de in enumerate(params["backbone2d"]["deblocks"]):
        pre = f"module.backbone_2d.deblocks.{s}"
        raw[f"{pre}.0.weight"] = asnp(de["w"]).copy()  # already [in,out,k,k]
        for k, v in _identity_bn(de["w"].shape[1], cfg.bn2d_eps,
                                 asnp(de["b"])).items():
            raw[f"{pre}.1.{k}"] = v

    head = params["head"]
    conv_bn("module.dense_head.shared_conv.0", "module.dense_head.shared_conv.1",
            head["shared_w"], head["shared_b"], cfg.bn2d_eps)
    for name, _c in head_branches(cfg):
        pre = f"module.dense_head.heads_list.0.{name}"
        conv_bn(f"{pre}.0.0", f"{pre}.0.1", head[name]["w0"], head[name]["b0"],
                cfg.bn2d_eps)
        raw[f"{pre}.1.weight"] = np.transpose(
            asnp(head[name]["w1"]), (3, 2, 0, 1)).copy()
        raw[f"{pre}.1.bias"] = asnp(head[name]["b1"])
    return raw
