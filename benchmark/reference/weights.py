"""The seeded raw checkpoint, and the reference's own folding of it.

``seeded_raw`` makes a checkpoint with the upstream ``module.*`` names and
shapes (the reference's ``.wts`` contract) from one seed, on the device,
from one standard-normal draw of a ``torch.Generator`` on that device:
each tensor is a slice of it, scaled as the port's ``weights.random_raw``
scales its NumPy draws (BatchNorm statistics near 1 and 0, He fan-in
scaling of the products, quiet head outputs with set biases), with the
``dim`` and ``rot`` branches set as ``weights.calibrated_raw`` sets them.
``calibrate_heatmap`` then shifts the heatmap bias so that a sparse set of
boxes clears the score threshold on a calibration frame, by the
reference's own forward pass.  The same raw checkpoint goes to both sides:
the port folds it with its ``prepare_params``, the reference with ``fold``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from .config import BEV_DEBLOCKS, BEV_LATERAL, BEV_STAGES, Config

HEAD_BIAS = {"hm": -2.0, "dim": 0.3, "center": 0.2, "center_z": -0.5,
             "rot": 0.2, "iou": 0.0}
DIM_BIAS = (math.log(4.2), math.log(1.9), math.log(1.7))   # a car, in m
ROT_BIAS = (0.9, 0.35)


def _bn(prefix: str, c: int) -> Dict[str, tuple]:
    return {f"{prefix}.{k}": (c,)
            for k in ("weight", "bias", "running_mean", "running_var")}


def param_spec(cfg: Config) -> Dict[str, tuple]:
    """Every raw tensor name and shape of the upstream checkpoint."""
    d = cfg.d_model
    c0, c1 = cfg.pfn_channels
    spec: Dict[str, tuple] = {}
    spec["module.vfe.pfn_layers.0.linear.weight"] = (c0, cfg.pillar_feature_num)
    spec.update(_bn("module.vfe.pfn_layers.0.norm", c0))
    spec["module.vfe.pfn_layers.1.linear.weight"] = (c1, 2 * c0)
    spec.update(_bn("module.vfe.pfn_layers.1.norm", c1))
    for b in range(cfg.num_blocks):
        for e in range(2):
            p = (f"module.backbone_3d.input_layer.posembed_layers.0.{b}.{e}"
                 ".position_embedding_head")
            spec[f"{p}.0.weight"] = (d, 2)
            spec[f"{p}.0.bias"] = (d,)
            spec.update(_bn(f"{p}.1", d))
            spec[f"{p}.3.weight"] = (d, d)
            spec[f"{p}.3.bias"] = (d,)
    for b in range(cfg.num_blocks):
        for e in range(2):
            p = f"module.backbone_3d.stage_0.{b}.encoder_list.{e}"
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
        spec[f"module.backbone_3d.residual_norm_stage_0.{b}.weight"] = (d,)
        spec[f"module.backbone_3d.residual_norm_stage_0.{b}.bias"] = (d,)
    in_ch = d
    for s, (units, ch, _stride) in enumerate(BEV_STAGES):
        for u in range(units):
            p = f"module.backbone_2d.blocks.{s}.{u}"
            u_in = in_ch if u == 0 else ch
            spec[f"{p}.conv1.weight"] = (ch, u_in, 3, 3)
            spec.update(_bn(f"{p}.bn1", ch))
            spec[f"{p}.conv2.weight"] = (ch, ch, 3, 3)
            spec.update(_bn(f"{p}.bn2", ch))
            if u == 0:
                spec[f"{p}.downsample_layer.0.weight"] = (ch, u_in, 1, 1)
                spec.update(_bn(f"{p}.downsample_layer.1", ch))
        in_ch = ch
    for s, k in enumerate(BEV_DEBLOCKS):
        spec[f"module.backbone_2d.deblocks.{s}.0.weight"] = (
            BEV_STAGES[s][1], BEV_LATERAL, k, k)
        spec.update(_bn(f"module.backbone_2d.deblocks.{s}.1", BEV_LATERAL))
    hs, hc = cfg.head_shared_channels, cfg.head_conv_channels
    spec["module.dense_head.shared_conv.0.weight"] = (
        hs, BEV_LATERAL * len(BEV_DEBLOCKS), 3, 3)
    spec.update(_bn("module.dense_head.shared_conv.1", hs))
    for name, out_c in cfg.branches():
        p = f"module.dense_head.heads_list.0.{name}"
        spec[f"{p}.0.0.weight"] = (hc, hs, 3, 3)
        spec.update(_bn(f"{p}.0.1", hc))
        spec[f"{p}.1.weight"] = (out_c, hc, 3, 3)
        spec[f"{p}.1.bias"] = (out_c,)
    return spec


def _scale_and_shift(name: str, shape: tuple):
    """(std, mean, absolute) of a tensor's draw: the distribution the
    port's ``weights.random_raw`` and ``calibrated_raw`` give it."""
    final = ".heads_list.0." in name and ".1." in name and ".0.1." not in name
    if final:
        branch = name.split(".heads_list.0.")[1].split(".")[0]
        if name.endswith(".weight"):
            std = {"dim": 0.005}.get(branch, 0.02)
            return std, 0.0, False
        return 0.1, HEAD_BIAS[branch], False
    if name.endswith("running_var"):
        return 0.1, 1.0, True
    if name.endswith("running_mean"):
        return 0.05, 0.0, False
    norm_like = (".norm" in name or "bn" in name or "norm1" in name
                 or (name.endswith(".weight") and len(shape) == 1))
    if norm_like:
        return (0.02, 1.0, False) if name.endswith(".weight") else \
            (0.05, 0.0, False)
    if len(shape) >= 2:
        return math.sqrt(2.0 / int(np.prod(shape[1:]))), 0.0, False
    return 0.05, 0.0, False


def seeded_raw(cfg: Config, seed: int, device) -> Dict[str, torch.Tensor]:
    """The raw checkpoint of ``seed``: float32 tensors on ``device``, made
    from one draw of a generator on that device."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(s)) for s in spec.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    raw, off = {}, 0
    for name, shape in spec.items():
        n = int(np.prod(shape))
        std, mean, absolute = _scale_and_shift(name, shape)
        t = z[off:off + n].view(shape) * std + mean
        raw[name] = t.abs() if absolute else t
        off += n
    dim_b = "module.dense_head.heads_list.0.dim.1.bias"
    rot_b = "module.dense_head.heads_list.0.rot.1.bias"
    raw[dim_b] = torch.tensor(DIM_BIAS, dtype=torch.float32, device=device)
    raw[rot_b] = torch.tensor(ROT_BIAS, dtype=torch.float32, device=device)
    return raw


HM_BIAS = "module.dense_head.heads_list.0.hm.1.bias"


def calibrate_heatmap(raw: Dict[str, torch.Tensor], frames, n_boxes: int,
                      top_k: int, target: float = 0.38,
                      waterline: float = 0.25, least: float = 0.36) -> None:
    """Shift the heatmap bias, in place, from the reference's heatmap of
    every frame (``frames``: (logits [H, W, classes], whether each cell's
    box lies inside the range [H, W]) a frame): on no frame do more than
    ``n_boxes`` cells in range reach the score ``target``, and on none does
    the ``top_k``-th cell (the decode's candidate cut) reach ``waterline``;
    but the frame of the highest cell in range keeps it at ``least``, so
    that some box is always there to compare.  The densest frame sets the
    shift, so the frames hold sparse sets of confident boxes clear of the
    score threshold and of the cut (the port's ``weights.calibrated_raw``
    makes the same shift on one frame)."""
    def kth(k, in_range):
        return max(float(torch.topk(
            (torch.where(inside[..., None], t, -torch.inf) if in_range
             else t).reshape(-1).double(), k).values[-1])
            for t, inside in frames)

    def logit(p):
        return math.log(p / (1.0 - p))
    shift = max(min(logit(target) - kth(n_boxes, True),
                    logit(waterline) - kth(top_k, False)),
                logit(least) - kth(1, True))
    raw[HM_BIAS] = (raw[HM_BIAS] + shift).float()


def to_numpy(raw: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The raw checkpoint as float32 NumPy arrays (the port's input)."""
    return {k: v.detach().float().cpu().numpy() for k, v in raw.items()}


# ---------------------------------------------------------------------------
# Folding: BatchNorm into the products, the layout the reference computes in
# (linears [in, out], convs OIHW, transposed convs [in, out, k, k]).  The
# nesting and leaf names are those of the port's trainable leaves, so the
# training comparison pairs leaves by path.
# ---------------------------------------------------------------------------


def _bn_affine(raw, prefix: str, eps: float):
    scale = raw[f"{prefix}.weight"] / torch.sqrt(raw[f"{prefix}.running_var"]
                                                 + eps)
    return scale, raw[f"{prefix}.bias"] - raw[f"{prefix}.running_mean"] * scale


def _linear_bn(raw, lin: str, bn: str, eps: float, bias: bool = False):
    scale, shift = _bn_affine(raw, bn, eps)
    w = raw[f"{lin}.weight"].reshape(len(scale), -1)
    b = shift + raw[f"{lin}.bias"] * scale if bias else shift
    return (w * scale[:, None]).t().contiguous(), b


def _linear(raw, prefix: str, in_dim: int):
    return (raw[f"{prefix}.weight"].reshape(-1, in_dim).t().contiguous(),
            raw[f"{prefix}.bias"].clone())


def _conv_bn(raw, conv: str, bn: str, eps: float, k: int = 3):
    scale, shift = _bn_affine(raw, bn, eps)
    w = raw[f"{conv}.weight"].reshape(len(scale), -1, k, k)
    return (w * scale[:, None, None, None]).contiguous(), shift


def fold(raw: Dict[str, torch.Tensor], cfg: Config) -> Dict:
    """The raw checkpoint folded into the nested dict the reference runs."""
    d = cfg.d_model
    p: Dict = {}
    w0, b0 = _linear_bn(raw, "module.vfe.pfn_layers.0.linear",
                        "module.vfe.pfn_layers.0.norm", cfg.bn1d_eps)
    w1, b1 = _linear_bn(raw, "module.vfe.pfn_layers.1.linear",
                        "module.vfe.pfn_layers.1.norm", cfg.bn1d_eps)
    p["vfe"] = {"l0": {"w": w0, "b": b0}, "l1": {"w": w1, "b": b1}}
    pos: List[List[Dict]] = []
    blocks: List[Dict] = []
    for b in range(cfg.num_blocks):
        row, encs = [], []
        for e in range(2):
            pre = (f"module.backbone_3d.input_layer.posembed_layers.0.{b}.{e}"
                   ".position_embedding_head")
            pw1, pb1 = _linear_bn(raw, f"{pre}.0", f"{pre}.1", cfg.bn1d_eps,
                                  bias=True)
            pw2, pb2 = _linear(raw, f"{pre}.3", d)
            row.append({"w1": pw1, "b1": pb1, "w2": pw2, "b2": pb2})
            pre = f"module.backbone_3d.stage_0.{b}.encoder_list.{e}"
            attn = f"{pre}.win_attn.self_attn"
            enc = {}
            for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
                enc[f"w{key}"] = raw[f"{attn}.in_proj_weight.{part}"].reshape(
                    d, d).t().contiguous()
                enc[f"b{key}"] = raw[f"{attn}.in_proj_bias.{part}"].clone()
            enc["wo"], enc["bo"] = _linear(raw, f"{attn}.out_proj", d)
            for ln, key in (("norm1", "ln1"), ("norm2", "ln2")):
                enc[f"{key}_g"] = raw[f"{pre}.win_attn.{ln}.weight"].clone()
                enc[f"{key}_b"] = raw[f"{pre}.win_attn.{ln}.bias"].clone()
            enc["ffn_w1"], enc["ffn_b1"] = _linear(
                raw, f"{pre}.win_attn.linear1", d)
            enc["ffn_w2"], enc["ffn_b2"] = _linear(
                raw, f"{pre}.win_attn.linear2", cfg.ffn_dim)
            enc["norm_g"] = raw[f"{pre}.norm.weight"].clone()
            enc["norm_b"] = raw[f"{pre}.norm.bias"].clone()
            encs.append(enc)
        pos.append(row)
        res = "module.backbone_3d.residual_norm_stage_0"
        blocks.append({"enc": encs, "res_g": raw[f"{res}.{b}.weight"].clone(),
                       "res_b": raw[f"{res}.{b}.bias"].clone()})
    p["posembed"], p["blocks"] = pos, blocks
    stages = []
    for s, (units, _ch, _stride) in enumerate(BEV_STAGES):
        stage = []
        for u in range(units):
            pre = f"module.backbone_2d.blocks.{s}.{u}"
            unit = {}
            unit["conv1_w"], unit["conv1_b"] = _conv_bn(
                raw, f"{pre}.conv1", f"{pre}.bn1", cfg.bn2d_eps)
            unit["conv2_w"], unit["conv2_b"] = _conv_bn(
                raw, f"{pre}.conv2", f"{pre}.bn2", cfg.bn2d_eps)
            if u == 0:
                unit["down_w"], unit["down_b"] = _conv_bn(
                    raw, f"{pre}.downsample_layer.0",
                    f"{pre}.downsample_layer.1", cfg.bn2d_eps, k=1)
            stage.append(unit)
        stages.append(stage)
    deblocks = []
    for s, k in enumerate(BEV_DEBLOCKS):
        pre = f"module.backbone_2d.deblocks.{s}"
        scale, shift = _bn_affine(raw, f"{pre}.1", cfg.bn2d_eps)
        w = raw[f"{pre}.0.weight"].reshape(-1, len(scale), k, k)
        deblocks.append({"w": (w * scale[None, :, None, None]).contiguous(),
                         "b": shift})
    p["backbone2d"] = {"stages": stages, "deblocks": deblocks}
    head: Dict = {}
    head["shared_w"], head["shared_b"] = _conv_bn(
        raw, "module.dense_head.shared_conv.0",
        "module.dense_head.shared_conv.1", cfg.bn2d_eps)
    for name, c in cfg.branches():
        pre = f"module.dense_head.heads_list.0.{name}"
        w0h, b0h = _conv_bn(raw, f"{pre}.0.0", f"{pre}.0.1", cfg.bn2d_eps)
        head[name] = {"w0": w0h, "b0": b0h,
                      "w1": raw[f"{pre}.1.weight"].reshape(
                          c, -1, 3, 3).clone(),
                      "b1": raw[f"{pre}.1.bias"].clone()}
    p["head"] = head
    return p


def leaves(params: Dict, path=()):
    """(path string, tensor) of every leaf, paths as ``['blocks'][0]...``."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from leaves(params[k], path + (k,))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            yield from leaves(v, path + (i,))
    else:
        yield "".join(f"['{k}']" if isinstance(k, str) else f"[{k}]"
                      for k in path), params
