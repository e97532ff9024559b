"""The plain DSVT-V detector (upstream DSVT's 3-D voxel model): points ->
boxes, float32 PyTorch, no kernels, nothing of the port.

Where it differs from the pillar model of ``detector.py``, whose shared
stages it imports (VFE, set attention, BEV ResNet, CenterHead, decode,
greedy NMS):

  voxelize   dynamic voxels on a 3-D grid (cell (iz * gy + iy) * gx + ix),
             at most ``max_points_per_pillar`` points each in file order,
             the first ``max_kept_points`` of the cell-sorted stream, the
             first ``max_pillars`` voxels (stage 0's cap); the 10 point
             features with the centre offset to the voxel's own z cell
  stages     per stage of ``stages``: its window partitions on its 3-D
             grid (in-window x, y, z; the position embedding reads (x, y,
             z) minus half the window where the grid has more than one z
             cell) and DSVT's rotated sets; its blocks, the block counter
             running across stages (global block b reads the set partition
             b % 2 of its stage, and the position embeddings of window
             partitions 0 and 1); then the pooling to the next stage as
             upstream writes it (``Stage_ReductionAtt_Block``): a zero
             placeholder [parents, V, C] that takes each voxel's row in its
             slot, query = MaxPool1d(V), key = slot + pos_embedding, value
             = slot, ``nn.MultiheadAttention`` and LayerNorm(attention +
             query)
  bev        the last stage's voxels (z = 0) scattered onto the map

``VoxelConfig`` is ``config.Config`` with the configuration file's
``stages``.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import Config
from .detector import (NEG_MASK, Detection, Pillars, Sets, _bin, _shift,
                       decode, gelu_tanh, head, layer_norm, linear, relu,
                       resnet, set_attention, to_bev, vfe)
from .nms import greedy_nms
from .precision import exact
from . import weights as ref_weights


@dataclasses.dataclass(frozen=True)
class Stage:
    sparse_shape: Tuple[int, int, int]
    windows: Tuple[Tuple[Tuple[int, int, int], Tuple[int, int, int]], ...]
    blocks: int
    set_size: int
    max_voxels: int
    max_sets: int
    stride: Tuple[int, int, int]

    @property
    def volume(self) -> int:
        return int(np.prod(self.stride))


@dataclasses.dataclass(frozen=True)
class VoxelConfig(Config):
    stages: Tuple[Stage, ...] = ()

    @staticmethod
    def from_dict(raw: dict) -> "VoxelConfig":
        base = Config.from_dict(raw)
        stages = tuple(
            Stage(tuple(st["sparse_shape"]),
                  tuple((tuple(w["shape"]), tuple(w["shift"]))
                        for w in st["window_specs"]),
                  st["num_blocks"], st["set_size"], st["max_voxels"],
                  st["max_sets"], tuple(st["stride"]))
            for st in raw["stages"])
        return VoxelConfig(**{f.name: getattr(base, f.name)
                              for f in dataclasses.fields(Config)},
                           stages=stages)

    def stage_blocks(self) -> List[range]:
        out, b0 = [], 0
        for st in self.stages:
            out.append(range(b0, b0 + st.blocks))
            b0 += st.blocks
        return out

    def used(self, s: int) -> List[int]:
        """The window partitions whose sets stage s's blocks read."""
        n = len(self.stages[s].windows)
        return sorted({b % n for b in self.stage_blocks()[s]})


def voxelize(points: torch.Tensor, num_points: int, cfg: VoxelConfig
             ) -> Pillars:
    """``detector.voxelize`` on the 3-D grid; ``coords`` [P, 3] (iz, iy,
    ix)."""
    dev = points.device
    N = points.shape[0]
    P1, P, CAP = cfg.max_kept_points, cfg.max_pillars, cfg.max_points_per_pillar
    gx, gy, gz = cfg.grid_size
    xmin, ymin, zmin = cfg.pc_range_min
    xmax, ymax, zmax = cfg.pc_range_max
    vx, vy, vz = cfg.voxel_size
    points = points.float()
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    valid = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax) & (z >= zmin)
             & (z < zmax) & (torch.arange(N, device=dev) < int(num_points)))
    sentinel = gx * gy * gz
    cell = torch.where(valid, (_bin(z, zmin, vz, gz) * gy
                               + _bin(y, ymin, vy, gy)) * gx
                       + _bin(x, xmin, vx, gx),
                       torch.full((N,), sentinel, device=dev))
    s_cell, perm = torch.sort(cell, stable=True)
    pay = points[perm]
    pos = torch.arange(N, device=dev)
    first = (s_cell != sentinel) & (s_cell != torch.cat(
        [s_cell.new_full((1,), -1), s_cell[:-1]]))
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    capped = (s_cell != sentinel) & (rank < CAP)
    key = torch.where(capped, s_cell, torch.full_like(s_cell, sentinel))
    key, perm2 = torch.sort(key, stable=True)
    s_cell, pay = key[:P1], pay[perm2[:P1]]
    if s_cell.shape[0] < P1:
        pad = P1 - s_cell.shape[0]
        s_cell = torch.cat([s_cell, s_cell.new_full((pad,), sentinel)])
        pay = torch.cat([pay, pay.new_zeros((pad, 4))])
    sx, sy, sz, sw = pay.unbind(-1)
    live = s_cell != sentinel
    new = live & (s_cell != torch.cat([s_cell.new_full((1,), -1), s_cell[:-1]]))
    voxel = torch.cumsum(new.long(), 0) - 1
    kept = live & (voxel < P)
    point_voxel = torch.where(kept, voxel, torch.full_like(voxel, P))
    count = torch.clamp(new.long().sum(), max=P)
    voxel_valid = torch.arange(P, device=dev) < count

    rows = torch.arange(P1, device=dev)
    rank_c = rows - torch.cummax(torch.where(new, rows, 0), 0).values
    zero = sx.new_zeros(())
    sums = [torch.where(kept, v, zero) for v in (sx, sy, sz)]
    for s in (1, 2, 4, 8, 16, 32):
        sums = [v + torch.where(rank_c >= s, _shift(v, s), zero) for v in sums]
    last = live & (s_cell != torch.cat([s_cell[1:], s_cell.new_full((1,), -1)]))
    to_end = (rows - torch.cummax(torch.where(torch.flip(last, (0,)), rows, 0),
                                  0).values).flip(0)
    dist = to_end
    for s in (32, 16, 8, 4, 2, 1):
        take = dist >= s
        sums = [torch.where(take, _shift(v, -s), v) for v in sums]
        dist = dist - s * take.long()
    mean = torch.stack(sums, -1) / torch.clamp(
        (rank_c + to_end + 1).float()[:, None], min=1.0)

    starts = torch.sort(torch.where(new, rows, torch.full_like(rows, P1))).values
    if starts.shape[0] < P:
        starts = torch.cat([starts, starts.new_full((P - starts.shape[0],), P1)])
    head_cell = torch.where(voxel_valid, s_cell[starts[:P].clamp(0, P1 - 1)],
                            torch.zeros(P, dtype=torch.long, device=dev))
    coords = torch.stack([head_cell // (gx * gy), (head_cell // gx) % gy,
                          head_cell % gx], -1)

    def centre(i, size, vmin):    # one rounding of (i + 0.5) * size + min
        return ((i.double() + 0.5) * float(np.float32(size))
                + float(np.float32(vmin))).float()

    feats = torch.stack([sx, sy, sz, sw, sx - mean[:, 0], sy - mean[:, 1],
                         sz - mean[:, 2], sx - centre(s_cell % gx, vx, xmin),
                         sy - centre((s_cell // gx) % gy, vy, ymin),
                         sz - centre(s_cell // (gx * gy), vz, zmin)], -1)
    feats = torch.where(kept[:, None], feats, torch.zeros_like(feats))
    return Pillars(feats, point_voxel, kept, coords, voxel_valid, count,
                   kept.long().sum())


def window_counts(spec, sparse_shape) -> Tuple[int, int, int]:
    """Windows along x, y, z (integer divide, then +1); one along z where
    the window spans the grid's z."""
    (wx, wy, wz), _ = spec
    return (sparse_shape[0] // wx + 1, sparse_shape[1] // wy + 1,
            1 if wz >= sparse_shape[2] else sparse_shape[2] // wz + 1)


def partition(coords, valid, spec, stage: Stage) -> Sets:
    """Windows of one spec on a stage's 3-D grid and DSVT's rotated sets."""
    (wx, wy, wz), (shx, shy, shz) = spec
    nwx, nwy, nwz = window_counts(spec, stage.sparse_shape)
    dev = coords.device
    P = coords.shape[0]
    K, S = stage.set_size, stage.max_sets
    X, Y = coords[:, 2] + shx, coords[:, 1] + shy
    Z = coords[:, 0] + (shz if nwz > 1 else 0)
    win = torch.where(valid, ((Z // wz) * nwy + Y // wy) * nwx + X // wx,
                      torch.full_like(X, nwx * nwy * nwz))
    cx, cy, cz = X % wx, Y % wy, Z % wz
    centred = [cx.float() - wx / 2.0, cy.float() - wy / 2.0]
    if stage.sparse_shape[2] > 1:
        centred.append(cz.float() - wz / 2.0)
    xy = torch.stack(centred, -1)
    cap = max(wx * wy * wz, wx * wz * wy) + 1
    big = P * cap + cap
    pos = torch.arange(P, device=dev)

    def order(key):
        return torch.sort(torch.where(valid, win * cap + key,
                                      torch.full_like(key, big)), stable=True)

    s_comp, order_y = order(cy * (wx * wz) + cx * wz + cz)
    _, order_x = order(cx * (wy * wz) + cy * wz + cz)
    s_live = s_comp < big
    s_win = torch.where(s_live, s_comp // cap, torch.full_like(s_comp, -1))
    new_win = s_live & (s_win != torch.cat([s_win.new_full((1,), -2),
                                            s_win[:-1]]))
    win_rank = torch.cumsum(new_win.long(), 0) - 1
    W = min(P, nwx * nwy * nwz)
    win_rank = torch.where(s_live & (win_rank < W), win_rank,
                           torch.full_like(win_rank, W))
    starts = torch.cat([torch.sort(torch.where(new_win, pos, torch.full_like(
        pos, P))).values, pos.new_full((2,), P)])
    win_start = starts[:W + 1]
    win_size = torch.clamp(torch.minimum(starts[1:W + 2], s_live.long().sum())
                           - win_start, min=0)
    n_sets = (win_size[:W] + K - 1) // K
    base = torch.cat([pos.new_zeros((1,)), torch.cumsum(n_sets, 0)])
    set_count = torch.clamp(base[torch.clamp(new_win.long().sum(), max=W)
                                 .reshape(1)][0], max=S)
    sid = torch.arange(S, device=dev)
    bump = pos.new_zeros((S + 1,)).index_add_(
        0, torch.clamp(base[1:W + 1], max=S), (n_sets > 0).long())
    wos = torch.clamp(torch.cumsum(bump[:S], 0), max=W - 1)
    live_set = sid < set_count
    n = win_size[wos]
    m = (sid - base[wos])[:, None] * K + torch.arange(K, device=dev)[None, :]
    local = torch.minimum((m * n[:, None]) // (K * torch.clamp(
        n_sets[wos], min=1)[:, None]), torch.clamp(n[:, None] - 1, min=0))
    src = torch.where(live_set[:, None], win_start[wos][:, None] + local,
                      torch.full_like(local, P - 1))
    dump = torch.full_like(src, P)
    inds = torch.stack([torch.where(live_set[:, None], order_y[src], dump),
                        torch.where(live_set[:, None], order_x[src], dump)])
    dup = torch.cat([torch.zeros((S, 1), dtype=torch.bool, device=dev),
                     local[:, 1:] == local[:, :-1]], 1)
    key_mask = torch.zeros((S, K), device=dev).masked_fill(
        dup | ~live_set[:, None], NEG_MASK)
    tbl = torch.stack([win_start, torch.clamp(win_size, min=1),
                       K * torch.clamp(F.pad(n_sets, (0, 1)), min=1),
                       F.pad(base[:W], (0, 1))], 1)

    def canon(order_):
        inv = torch.empty_like(order_)
        inv[order_] = pos
        wr = torch.empty_like(order_)
        wr[order_] = win_rank
        row = tbl[wr]
        r = inv - row[:, 0]
        flat = row[:, 3] * K + (r * row[:, 2] + row[:, 1] - 1) // row[:, 1]
        return torch.where(valid & (flat < S * K), flat,
                           torch.full_like(flat, S * K))

    return Sets(xy, inds, key_mask, set_count,
                torch.stack([canon(order_y), canon(order_x)]))


class Pooled(NamedTuple):
    """The parents of one pooling: ``inverse`` [P] each voxel's parent
    (the next stage's cap or more: none), ``slot`` [P], ``coords``, ``valid``
    and ``count`` of the next stage's voxels (padded to its cap)."""

    inverse: torch.Tensor
    slot: torch.Tensor
    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def parents(coords, valid, stage: Stage, nxt: Stage) -> Pooled:
    """upstream ``get_pooling_index``: each voxel's parent cell and its slot
    (``index_in_win``); the parents in ascending cell id (torch.unique)."""
    sx, sy, sz = stage.stride
    gx, gy, _gz = nxt.sparse_shape
    z, y, x = coords.unbind(-1)
    cell = ((z // sz) * gy + y // sy) * gx + x // sx
    slot = (x % sx) * (sy * sz) + (y % sy) * sz + z % sz
    uniq, inverse = torch.unique(cell[valid], return_inverse=True)
    n1 = min(len(uniq), nxt.max_voxels)
    full_inverse = torch.full_like(cell, nxt.max_voxels)
    full_inverse[valid] = torch.where(inverse < n1, inverse,
                                      torch.full_like(inverse, nxt.max_voxels))
    cells = torch.zeros(nxt.max_voxels, dtype=torch.long, device=coords.device)
    cells[:n1] = uniq[:n1]
    nxt_coords = torch.stack([cells // (gx * gy), (cells // gx) % gy,
                              cells % gx], -1)
    nxt_valid = torch.arange(nxt.max_voxels, device=coords.device) < n1
    return Pooled(full_inverse, slot, nxt_coords, nxt_valid,
                  torch.tensor(n1, device=coords.device))


def pool(x, pooled: Pooled, p, cfg: VoxelConfig, volume: int, quant=exact):
    """upstream ``Stage_ReductionAtt_Block`` on the zero placeholder."""
    N1 = pooled.valid.shape[0]
    C = x.shape[1]
    keep = pooled.inverse < N1
    placeholder = x.new_zeros((N1, volume, C))
    placeholder[pooled.inverse[keep], pooled.slot[keep]] = x[keep]
    # upstream: x [N, C, V] -> MaxPool1d(V) -> [N, 1, C]
    query = torch.nn.MaxPool1d(volume)(placeholder.permute(0, 2, 1)).permute(
        0, 2, 1)
    key = placeholder + p["pos"][None]
    mha = torch.nn.MultiheadAttention(C, cfg.num_heads, batch_first=True).to(
        x.device)
    with torch.no_grad():
        mha.in_proj_weight.copy_(quant(p["in_w"]))
        mha.in_proj_bias.copy_(p["in_b"])
        mha.out_proj.weight.copy_(quant(p["out_w"]))
        mha.out_proj.bias.copy_(p["out_b"])
    # upstream's key_padding_mask is all zeros: an empty slot is a zero row
    out = mha(quant(query), quant(key), quant(placeholder),
              need_weights=False)[0]
    out = layer_norm(out + query, p["ln_g"], p["ln_b"], cfg.ln_eps)[:, 0]
    return torch.where(pooled.valid[:, None], out, torch.zeros_like(out))


class StageSets(NamedTuple):
    coords: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor
    sets: List[Sets]          # every window partition of the stage
    pooled: object            # Pooled, None at the last stage


def integer_stages(points, num_points, cfg: VoxelConfig):
    with torch.no_grad():
        pl = voxelize(points, num_points, cfg)
        coords, valid, count = pl.coords, pl.pillar_valid, pl.pillar_count
        stages = []
        for s, st in enumerate(cfg.stages):
            sets = [partition(coords, valid, spec, st) for spec in st.windows]
            pooled = (parents(coords, valid, st, cfg.stages[s + 1])
                      if s + 1 < len(cfg.stages) else None)
            stages.append(StageSets(coords, valid, count, sets, pooled))
            if pooled is not None:
                coords, valid, count = pooled.coords, pooled.valid, pooled.count
    return pl, stages


def blocks(x, sets: List[Sets], ids, params, cfg: VoxelConfig, quant=exact):
    """A stage's blocks: global block b attends in the sets of partition
    b % 2; encoder e's position embedding reads window partition e."""
    eps = cfg.ln_eps
    for b in ids:
        sp = sets[b % len(sets)]
        x_in = x
        for e in range(2):
            enc, mlp = params["blocks"][b]["enc"][e], params["posembed"][b][e]
            h = relu(linear(sets[e].xy, mlp["w1"], mlp["b1"], quant))
            pos = linear(h, mlp["w2"], mlp["b2"], quant)
            attn = set_attention(x, pos, sp, e, enc, cfg.num_heads, quant)
            canon = sp.canon[e]
            n = attn.shape[0]
            a = torch.where((canon < n)[:, None], attn[canon.clamp(max=n - 1)],
                            torch.zeros_like(x))
            a = linear(a, enc["wo"], enc["bo"], quant)
            x1 = layer_norm(x + a, enc["ln1_g"], enc["ln1_b"], eps)
            f = linear(gelu_tanh(linear(x1, enc["ffn_w1"], enc["ffn_b1"], quant)),
                       enc["ffn_w2"], enc["ffn_b2"], quant)
            x2 = layer_norm(x1 + f, enc["ln2_g"], enc["ln2_b"], eps)
            x = layer_norm(x2 + x, enc["norm_g"], enc["norm_b"], eps)
        x = layer_norm(x + x_in, params["blocks"][b]["res_g"],
                       params["blocks"][b]["res_b"], eps)
    return x


def backbone(x, stages: List[StageSets], params, cfg: VoxelConfig,
             quant=exact):
    for s, (st, ids) in enumerate(zip(stages, cfg.stage_blocks())):
        x = blocks(x, st.sets, ids, params, cfg, quant)
        if st.pooled is not None:
            x = pool(x, st.pooled, params["pool"][s], cfg,
                     cfg.stages[s].volume, quant)
    return x


def float_stages(params, pl: Pillars, stages: List[StageSets],
                 cfg: VoxelConfig, quant=exact, only=None):
    feats = vfe(pl, params["vfe"], cfg, quant)
    feats = backbone(feats, stages, params, cfg, quant)
    last = stages[-1]
    flat = types.SimpleNamespace(coords=last.coords[:, 1:],
                                 pillar_valid=last.valid)
    bev = resnet(to_bev(feats, flat, cfg), params["backbone2d"], quant)
    return head(bev, params["head"], cfg, quant, only)


def occupancy(pl: Pillars, stages: List[StageSets], cfg: VoxelConfig
              ) -> np.ndarray:
    """Kept points, each stage's voxels, the live sets of each partition a
    stage reads: what the port's ``Detections.occupancy`` reports."""
    return np.array([int(pl.point_count)] + [int(st.count) for st in stages]
                    + [int(st.sets[i].set_count) for s, st in enumerate(stages)
                       for i in cfg.used(s)], np.int64)


@torch.no_grad()
def heatmap(params, points, num_points, cfg: VoxelConfig):
    """``detector.heatmap`` of the voxel model."""
    pl, stages = integer_stages(points, num_points, cfg)
    maps = float_stages(params, pl, stages, cfg,
                        only=("hm", "center", "center_z"))
    H, W = maps["hm"].shape[:2]
    vx, vy, _ = cfg.voxel_size
    (xmin, ymin, zmin), (xmax, ymax, zmax) = cfg.pc_range_min, cfg.pc_range_max
    x = (torch.arange(W, device=points.device).float()[None, :]
         + maps["center"][..., 0]) * vx + xmin
    y = (torch.arange(H, device=points.device).float()[:, None]
         + maps["center"][..., 1]) * vy + ymin
    z = maps["center_z"][..., 0]
    inside = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax)
              & (z >= zmin) & (z < zmax))
    return maps["hm"], inside


@torch.no_grad()
def detect(params, points, num_points, cfg: VoxelConfig, quant=exact
           ) -> Detection:
    """One frame through the whole voxel detector."""
    pl, stages = integer_stages(points, num_points, cfg)
    maps = float_stages(params, pl, stages, cfg, quant)
    top, keep = decode(maps, cfg)
    top = top.double().cpu().numpy()
    boxes = top[keep.cpu().numpy(), :9]
    kept = greedy_nms(boxes, cfg.nms_threshold)
    return Detection(boxes[kept].astype(np.float32),
                     occupancy(pl, stages, cfg), top)


# ---------------------------------------------------------------------------
# The checkpoint: upstream's names of the stages and poolings
# ---------------------------------------------------------------------------


def block_names(cfg: VoxelConfig):
    """(global block, stage, block of the stage)."""
    return [(b, s, b - ids.start) for s, ids in enumerate(cfg.stage_blocks())
            for b in ids]


def param_spec(cfg: VoxelConfig) -> Dict[str, tuple]:
    """Every raw tensor of the voxel model: the pillar model's VFE, BEV
    ResNet and head (``weights.param_spec``), each stage's blocks under
    upstream's stage names, and the poolings."""
    d = cfg.d_model
    outer = ref_weights.param_spec(dataclasses.replace(cfg, num_blocks=0))
    spec: Dict[str, tuple] = {k: v for k, v in outer.items()
                              if k.startswith("module.vfe.")}
    for _b, s, j in block_names(cfg):
        p = (f"module.backbone_3d.input_layer.posembed_layers.{s}.{j}")
        dim = 3 if cfg.stages[s].sparse_shape[2] > 1 else 2
        for e in range(2):
            q = f"{p}.{e}.position_embedding_head"
            spec[f"{q}.0.weight"] = (d, dim)
            spec[f"{q}.0.bias"] = (d,)
            spec.update(ref_weights._bn(f"{q}.1", d))
            spec[f"{q}.3.weight"] = (d, d)
            spec[f"{q}.3.bias"] = (d,)
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
    for s, st in enumerate(cfg.stages[:-1]):
        p = f"module.backbone_3d.stage_{s}_reduction"
        for part in ("query", "key", "value"):
            spec[f"{p}.self_attn.in_proj_weight.{part}"] = (d, d)
            spec[f"{p}.self_attn.in_proj_bias.{part}"] = (d,)
        spec[f"{p}.self_attn.out_proj.weight"] = (d, d)
        spec[f"{p}.self_attn.out_proj.bias"] = (d,)
        spec[f"{p}.norm.weight"] = (d,)
        spec[f"{p}.norm.bias"] = (d,)
        spec[f"{p}.pos_embedding"] = (st.volume, d)
    spec.update({k: v for k, v in outer.items()
                 if not k.startswith("module.vfe.")})
    return spec


def seeded_raw(cfg: VoxelConfig, seed: int, device) -> Dict[str, torch.Tensor]:
    """``weights.seeded_raw`` over the voxel model's tensors: one
    standard-normal draw on ``device``, each tensor scaled as there."""
    spec = param_spec(cfg)
    total = sum(int(np.prod(s)) for s in spec.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    raw, off = {}, 0
    for name, shape in spec.items():
        n = int(np.prod(shape))
        std, mean, absolute = ref_weights._scale_and_shift(name, shape)
        t = z[off:off + n].view(shape) * std + mean
        raw[name] = t.abs() if absolute else t
        off += n
    raw["module.dense_head.heads_list.0.dim.1.bias"] = torch.tensor(
        ref_weights.DIM_BIAS, dtype=torch.float32, device=device)
    raw["module.dense_head.heads_list.0.rot.1.bias"] = torch.tensor(
        ref_weights.ROT_BIAS, dtype=torch.float32, device=device)
    return raw


def fold(raw: Dict[str, torch.Tensor], cfg: VoxelConfig) -> Dict:
    """The raw checkpoint folded as ``weights.fold`` folds the pillar
    model's, with the stages' blocks under their global ids and each
    pooling's tensors as ``nn.MultiheadAttention`` holds them."""
    d = cfg.d_model
    p = ref_weights.fold(raw, dataclasses.replace(cfg, num_blocks=0))
    for _b, s, j in block_names(cfg):
        row = []
        for e in range(2):
            pre = (f"module.backbone_3d.input_layer.posembed_layers.{s}.{j}."
                   f"{e}.position_embedding_head")
            w1, b1 = ref_weights._linear_bn(raw, f"{pre}.0", f"{pre}.1",
                                            cfg.bn1d_eps, bias=True)
            w2, b2 = ref_weights._linear(raw, f"{pre}.3", d)
            row.append({"w1": w1, "b1": b1, "w2": w2, "b2": b2})
        p["posembed"].append(row)
        encs = []
        for e in range(2):
            pre = f"module.backbone_3d.stage_{s}.{j}.encoder_list.{e}"
            attn = f"{pre}.win_attn.self_attn"
            enc = {}
            for part, key in (("query", "q"), ("key", "k"), ("value", "v")):
                enc[f"w{key}"] = raw[f"{attn}.in_proj_weight.{part}"].reshape(
                    d, d).t().contiguous()
                enc[f"b{key}"] = raw[f"{attn}.in_proj_bias.{part}"].clone()
            enc["wo"], enc["bo"] = ref_weights._linear(raw, f"{attn}.out_proj", d)
            for ln, key in (("norm1", "ln1"), ("norm2", "ln2")):
                enc[f"{key}_g"] = raw[f"{pre}.win_attn.{ln}.weight"].clone()
                enc[f"{key}_b"] = raw[f"{pre}.win_attn.{ln}.bias"].clone()
            enc["ffn_w1"], enc["ffn_b1"] = ref_weights._linear(
                raw, f"{pre}.win_attn.linear1", d)
            enc["ffn_w2"], enc["ffn_b2"] = ref_weights._linear(
                raw, f"{pre}.win_attn.linear2", cfg.ffn_dim)
            enc["norm_g"] = raw[f"{pre}.norm.weight"].clone()
            enc["norm_b"] = raw[f"{pre}.norm.bias"].clone()
            encs.append(enc)
        res = f"module.backbone_3d.residual_norm_stage_{s}.{j}"
        p["blocks"].append({"enc": encs, "res_g": raw[f"{res}.weight"].clone(),
                            "res_b": raw[f"{res}.bias"].clone()})
    p["pool"] = []
    for s, st in enumerate(cfg.stages[:-1]):
        pre = f"module.backbone_3d.stage_{s}_reduction"
        attn = f"{pre}.self_attn"
        parts = ("query", "key", "value")
        p["pool"].append({
            "in_w": torch.cat([raw[f"{attn}.in_proj_weight.{k}"].reshape(d, d)
                               for k in parts]),
            "in_b": torch.cat([raw[f"{attn}.in_proj_bias.{k}"] for k in parts]),
            "out_w": raw[f"{attn}.out_proj.weight"].reshape(d, d).clone(),
            "out_b": raw[f"{attn}.out_proj.bias"].clone(),
            "ln_g": raw[f"{pre}.norm.weight"].clone(),
            "ln_b": raw[f"{pre}.norm.bias"].clone(),
            "pos": raw[f"{pre}.pos_embedding"].reshape(st.volume, d).clone()})
    return p
