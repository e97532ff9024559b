"""The plain DSVT detector: points -> boxes, float32 PyTorch, no kernels.

Stages, in the reference engine's order (DSVT, Wang et al., CVPR 2023,
and the reference's params.h):

  voxelize   dynamic 0.32 m pillars, at most ``max_points_per_pillar``
             points each in file order, the first ``max_kept_points`` of
             the cell-sorted stream, the first ``max_pillars`` pillars;
             10 features per point (x, y, z, i, offsets to the pillar's
             mean and to its cell centre)
  vfe        linear+BN+ReLU, max over the pillar, concat, linear+BN+ReLU,
             max over the pillar
  partition  per window spec, windows and the rotated sets of DSVT's
             Eq. (3): each window's pillars sorted along y then x,
             spread over ceil(n / set_size) sets of ``set_size`` slots
  backbone   ``num_blocks`` blocks of two set-attention encoders: q = k =
             x + pos, v = x, keys that repeat a slot masked; out-proj,
             LN, FFN (tanh GELU), LN, per-encoder LN; block residual LN
  bev        pillar features scattered onto the H x W map
  resnet     the BEV ResNet and its three transposed-conv laterals
  head       CenterHead, every branch on the full map
  decode     per-class top-k, global top-k, boxes; score and range filter
  nms        greedy rotated NMS (reference/nms.py) on the host

Everything runs on the tensors' device.  ``quant`` rounds the operands of
each product (reference/precision.py); float32 is the identity.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .config import BEV_DEBLOCKS, BEV_STAGES, Config
from .nms import greedy_nms
from .precision import exact

NEG_MASK = torch.finfo(torch.float32).min


class Detection(NamedTuple):
    boxes: np.ndarray        # [n, 9] after NMS, float32
    occupancy: np.ndarray    # kept points, pillars, sets per window spec
    top_k: np.ndarray        # [K, 10] every decoded candidate, float64


class Pillars(NamedTuple):
    point_feats: torch.Tensor    # [P1, 10]
    point_pillar: torch.Tensor   # [P1] pillar id, P for dropped rows
    point_valid: torch.Tensor    # [P1]
    coords: torch.Tensor         # [P, 2] (iy, ix)
    pillar_valid: torch.Tensor   # [P]
    pillar_count: torch.Tensor   # []
    point_count: torch.Tensor    # []


def _edges(vmin: float, vsize: float, n: int, device) -> torch.Tensor:
    """Grid lines vmin + i * vsize, computed in float64, rounded to f32."""
    return (torch.arange(n + 1, dtype=torch.float64, device=device)
            * float(vsize) + float(vmin)).float()


def _bin(v: torch.Tensor, vmin: float, vsize: float, n: int) -> torch.Tensor:
    """The cell of each value: the last grid line at or below it."""
    edges = _edges(vmin, vsize, n, v.device)
    return (torch.searchsorted(edges, v.contiguous(), right=True) - 1).clamp(
        0, n - 1)


def _shift(v: torch.Tensor, s: int) -> torch.Tensor:
    """v[i - s] for s > 0, v[i - s] = v[i + |s|] for s < 0; zeros in."""
    z = v.new_zeros((abs(s),) + tuple(v.shape[1:]))
    return torch.cat([z, v[:-s]]) if s > 0 else torch.cat([v[-s:], z])


def voxelize(points: torch.Tensor, num_points: int, cfg: Config) -> Pillars:
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
    sentinel = gx * gy
    cell = torch.where(valid, _bin(y, ymin, vy, gy) * gx + _bin(x, xmin, vx, gx),
                       torch.full((N,), sentinel, device=dev))
    # points grouped by cell, file order kept inside each cell
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
    pillar = torch.cumsum(new.long(), 0) - 1
    kept = live & (pillar < P)
    point_pillar = torch.where(kept, pillar, torch.full_like(pillar, P))
    pillar_count = torch.clamp(new.long().sum(), max=P)
    pillar_valid = torch.arange(P, device=dev) < pillar_count

    # the pillar's mean: segmented inclusive sums (Hillis-Steele over
    # segments of at most 64 rows), then each segment's total carried to
    # every row of it, in this order, so the rounding is fixed
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
    head = torch.where(pillar_valid, s_cell[starts[:P].clamp(0, P1 - 1)],
                       torch.zeros(P, dtype=torch.long, device=dev))
    coords = torch.stack([head // gx, head % gx], -1)

    def centre(i, size, vmin):    # one rounding of (i + 0.5) * size + min
        return ((i.double() + 0.5) * float(np.float32(size))
                + float(np.float32(vmin))).float()

    cz = centre(_bin(sz, zmin, vz, gz), vz, zmin)
    feats = torch.stack([sx, sy, sz, sw, sx - mean[:, 0], sy - mean[:, 1],
                         sz - mean[:, 2], sx - centre(s_cell % gx, vx, xmin),
                         sy - centre(s_cell // gx, vy, ymin), sz - cz], -1)
    feats = torch.where(kept[:, None], feats, torch.zeros_like(feats))
    return Pillars(feats, point_pillar, kept, coords, pillar_valid,
                   pillar_count, kept.long().sum())


def relu(x: torch.Tensor) -> torch.Tensor:
    return torch.maximum(x, torch.zeros((), dtype=x.dtype))


def linear(x, w, b, quant=exact):
    y = torch.matmul(quant(x), quant(w))
    return y if b is None else y + b


def _pillar_max(x, point_pillar, valid, P):
    """Per pillar, the channelwise max of its points ([P, C]; empty pillars
    0), and that max broadcast back to each point ([P1, C]; dropped 0)."""
    C = x.shape[1]
    guarded = torch.where(valid[:, None], x, torch.full_like(x, -1e6))
    table = torch.full((P + 1, C), -1e6, dtype=x.dtype, device=x.device)
    table = table.scatter_reduce(0, point_pillar[:, None].expand(-1, C),
                                 guarded, reduce="amax", include_self=True)
    table = torch.where(table > -1e6, table, torch.zeros_like(table))
    back = torch.where(valid[:, None], table[point_pillar], torch.zeros_like(x))
    return back, table[:P]


def vfe(pl: Pillars, p, cfg: Config, quant=exact) -> torch.Tensor:
    valid = pl.point_valid
    x = relu(linear(pl.point_feats, p["l0"]["w"], p["l0"]["b"], quant))
    x = torch.where(valid[:, None], x, torch.zeros_like(x))
    back, _ = _pillar_max(x, pl.point_pillar, valid, cfg.max_pillars)
    x = relu(linear(torch.cat([x, back], -1), p["l1"]["w"], p["l1"]["b"], quant))
    x = torch.where(valid[:, None], x, torch.zeros_like(x))
    _, table = _pillar_max(x, pl.point_pillar, valid, cfg.max_pillars)
    return torch.where(pl.pillar_valid[:, None], table, torch.zeros_like(table))


class Sets(NamedTuple):
    xy: torch.Tensor         # [P, 2] in-window (x, y) minus half the window
    inds: torch.Tensor       # [2, S, K] pillar per slot (y-major, x-major)
    key_mask: torch.Tensor   # [S, K] 0 or NEG_MASK
    set_count: torch.Tensor  # []
    canon: torch.Tensor      # [2, P] each pillar's slot (S*K: none)


def partition(coords, pillar_valid, spec, cfg: Config) -> Sets:
    """Windows of one spec and DSVT's rotated sets over them."""
    (wx, wy, wz), (shx, shy, _shz) = spec
    nwx, nwy = cfg.num_windows(spec[0])
    dev = coords.device
    P = coords.shape[0]
    K, S = cfg.set_size, cfg.max_sets
    X, Y = coords[:, 1] + shx, coords[:, 0] + shy
    win = torch.where(pillar_valid, (Y // wy) * nwx + X // wx,
                      torch.full_like(X, nwx * nwy))
    cx, cy = X % wx, Y % wy
    xy = torch.stack([cx.float() - wx / 2.0, cy.float() - wy / 2.0], -1)
    cap = max(wx * wy * wz, wx * wz * wy) + 1
    big = P * cap + cap
    pos = torch.arange(P, device=dev)

    def order(key):
        return torch.sort(torch.where(pillar_valid, win * cap + key,
                                      torch.full_like(key, big)), stable=True)

    s_comp, order_y = order(cy * (wx * wz) + cx * wz)
    _, order_x = order(cx * (wy * wz) + cy * wz)
    s_live = s_comp < big
    s_win = torch.where(s_live, s_comp // cap, torch.full_like(s_comp, -1))
    new_win = s_live & (s_win != torch.cat([s_win.new_full((1,), -2),
                                            s_win[:-1]]))
    win_rank = torch.cumsum(new_win.long(), 0) - 1
    W = min(P, nwx * nwy)
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
        return torch.where(pillar_valid & (flat < S * K), flat,
                           torch.full_like(flat, S * K))

    return Sets(xy, inds, key_mask, set_count,
                torch.stack([canon(order_y), canon(order_x)]))


def layer_norm(x, g, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = torch.square(x - mean).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g + b


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(0.7978845608028654
                                       * (x + 0.044715 * x * x * x)))


def set_attention(x, pos, sets: Sets, e: int, enc, heads, quant=exact):
    """Multi-head attention inside each set of axis ``e``: q = k = x + pos,
    v = x; [S*K, C], row = set * K + slot."""
    S, K = sets.key_mask.shape
    C = x.shape[1]
    D = C // heads
    qk_in = x + pos
    q = linear(qk_in, enc["wq"], enc["bq"], quant)
    k = linear(qk_in, enc["wk"], enc["bk"], quant)
    v = linear(x, enc["wv"], enc["bv"], quant)

    def gather(t):     # the dump index reads a zero row
        t = torch.cat([t, t.new_zeros((1, C))])
        return t[sets.inds[e]].view(S, K, heads, D)

    q, k, v = gather(q), gather(k), gather(v)
    scale = 1.0 / float(np.sqrt(np.float32(D)))
    logits = torch.einsum("sqhd,skhd->shqk", quant(q * scale), quant(k))
    attn = torch.softmax(logits + sets.key_mask[:, None, None, :], -1)
    return torch.einsum("shqk,skhd->sqhd", quant(attn), quant(v)).reshape(
        S * K, C)


def backbone3d(x, sets: List[Sets], params, cfg: Config, quant=exact):
    eps = cfg.ln_eps
    for b in range(cfg.num_blocks):
        sp = sets[b % len(sets)]
        x_in = x
        for e in range(2):
            enc, mlp = params["blocks"][b]["enc"][e], params["posembed"][b][e]
            # the position embedding reads window partition e's coordinates
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


def to_bev(feats, pl: Pillars, cfg: Config) -> torch.Tensor:
    """[1, C, H, W] map of the pillar features."""
    W, H = cfg.grid_size[0], cfg.grid_size[1]
    C = feats.shape[1]
    lin = torch.where(pl.pillar_valid, pl.coords[:, 0] * W + pl.coords[:, 1],
                      torch.full_like(pl.coords[:, 0], H * W))
    canvas = feats.new_zeros((H * W + 1, C)).index_copy(0, lin, feats)
    return canvas[:H * W].t().reshape(1, C, H, W)


def conv(x, w, b, stride=1, quant=exact):
    return F.conv2d(quant(x), quant(w), b, stride=stride,
                    padding=w.shape[-1] // 2)


def resnet(x, p, quant=exact) -> torch.Tensor:
    laterals = []
    for s, (units, _ch, stride) in enumerate(BEV_STAGES):
        for u in range(units):
            unit, st = p["stages"][s][u], (stride if u == 0 else 1)
            h = relu(conv(x, unit["conv1_w"], unit["conv1_b"], st, quant))
            h = conv(h, unit["conv2_w"], unit["conv2_b"], 1, quant)
            short = (conv(x, unit["down_w"], unit["down_b"], st, quant)
                     if "down_w" in unit else x)
            x = relu(h + short)
        d, k = p["deblocks"][s], BEV_DEBLOCKS[s]
        laterals.append(relu(F.conv_transpose2d(quant(x), quant(d["w"]),
                                                d["b"], stride=k)))
    return torch.cat(laterals, 1)


def head(x, p, cfg: Config, quant=exact, only=None) -> Dict[str, torch.Tensor]:
    """Every branch (or those named in ``only``) on the full map: {name:
    [H, W, c]}."""
    shared = relu(conv(x, p["shared_w"], p["shared_b"], 1, quant))
    out = {}
    for name, _c in cfg.branches():
        if only is not None and name not in only:
            continue
        h = relu(conv(shared, p[name]["w0"], p[name]["b0"], 1, quant))
        out[name] = conv(h, p[name]["w1"], p[name]["b1"], 1, quant)[0].permute(
            1, 2, 0)
    return out


def float_stages(params, pl: Pillars, sets, cfg: Config, quant=exact,
                 only=None):
    feats = vfe(pl, params["vfe"], cfg, quant)
    feats = backbone3d(feats, sets, params, cfg, quant)
    bev = resnet(to_bev(feats, pl, cfg), params["backbone2d"], quant)
    return head(bev, params["head"], cfg, quant, only)


@torch.no_grad()
def heatmap(params, points, num_points, cfg: Config):
    """The heatmap logits [H, W, classes] of one frame, and where the box a
    cell decodes to lies inside the range [H, W]."""
    pl, sets = integer_stages(points, num_points, cfg)
    maps = float_stages(params, pl, sets, cfg,
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


def integer_stages(points, num_points, cfg: Config):
    with torch.no_grad():
        pl = voxelize(points, num_points, cfg)
        sets = [partition(pl.coords, pl.pillar_valid, spec, cfg)
                for spec in cfg.window_specs]
    return pl, sets


def top_k(x, k):
    """Top-k along the last axis, ties to the lower index."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def decode(maps, cfg: Config):
    """(the global top-k boxes [K, 10] = (x, y, z, dx, dy, dz, heading,
    class, score, |rot|) in score order, which of them pass the score
    threshold and the range).  |rot| is the length of the regressed
    (cos, sin) vector the heading is read from."""
    H, W, ncls = maps["hm"].shape
    K = cfg.top_k
    hm = torch.sigmoid(maps["hm"]).permute(2, 0, 1).reshape(ncls, H * W)
    cls_scores, cls_inds = top_k(hm, K)
    scores, sel = top_k(cls_scores.reshape(-1), K)
    classes = sel // K
    inds = cls_inds.reshape(-1)[sel]

    def at(name):
        m = maps[name]
        return m.reshape(H * W, m.shape[-1])[inds]

    vx, vy, _ = cfg.voxel_size
    xmin, ymin, zmin = cfg.pc_range_min
    xmax, ymax, zmax = cfg.pc_range_max
    center, z, dim, rot = at("center"), at("center_z")[:, 0], at("dim"), at("rot")
    x = ((inds % W).float() + center[:, 0]) * vx + xmin
    y = ((inds // W).float() + center[:, 1]) * vy + ymin
    keep = ((x >= xmin) & (x < xmax) & (y >= ymin) & (y < ymax) & (z >= zmin)
            & (z < zmax) & (scores >= cfg.score_threshold))
    dim = torch.exp(dim)
    boxes = torch.stack([x, y, z, dim[:, 0], dim[:, 1], dim[:, 2],
                         torch.atan2(rot[:, 1], rot[:, 0]), classes.float(),
                         scores, torch.linalg.vector_norm(rot, dim=1)], -1)
    return boxes, keep


def occupancy(pl: Pillars, sets) -> np.ndarray:
    """(kept points, pillars, sets per window spec): what the port's
    ``Detections.occupancy`` reports."""
    return np.array([int(pl.point_count), int(pl.pillar_count)]
                    + [int(s.set_count) for s in sets], np.int64)


@torch.no_grad()
def detect(params, points, num_points, cfg: Config, quant=exact) -> Detection:
    """One frame through the whole detector."""
    pl, sets = integer_stages(points, num_points, cfg)
    maps = float_stages(params, pl, sets, cfg, quant)
    top, keep = decode(maps, cfg)
    top = top.double().cpu().numpy()
    boxes = top[keep.cpu().numpy(), :9]
    kept = greedy_nms(boxes, cfg.nms_threshold)
    return Detection(boxes[kept].astype(np.float32), occupancy(pl, sets), top)
