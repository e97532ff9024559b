"""The five main-path CUDA kernels against their plain versions, the engine's
CUDA graph against the eager forward, and the tracer's stage marks, on the
card.

Marked ``cuda``; each test skips (from a fixture) where no card is present.
Run on a machine with a card, without the JAX-loading conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: B3 bit-exact on the defined rows (max is exact); B1 atol 5e-3,
rtol 2e-2 on live query slots (bf16 inputs, f32 softmax, different
summation order), exact zeros on dead sets; B2 atol 2e-2 (a bf16 rounding
flip of x1 or of the GELU output before the next product); B4 bit-exact on
the strict upper triangle: it builds the corners with ``box_corners``'
rounding (``cosf``/``sinf``, as ``torch.cos``/``torch.sin`` on the card)
and rounds every product, difference, quotient and sum of the clip on its
own, with no fused multiply-adds, as the plain version's PyTorch ops do;
nms_peel bit-exact (boxes out and kept count: its IoU rounds as PyTorch's
ops do, and the rest is boolean algebra and copies).  The engine's
replays bit-exact against ``Engine.eager`` at a tiny configuration: the
same kernels on the same inputs; the scan graph's frames bit-exact against
the per-frame engine's replays; a segmented capture
(``capture_segments``, on a one-rank gloo group; also across autograd's
thread, with Megatron's pair in a backward) and the engines captured
in segments (``Engine(..., tp=)``, ``Engine(..., spatial=)``) bit-exact
against their eager runs.  The compiled training step against eager
steps from the same weights: the loss at 1e-5 relative, each leaf within
1e-6 of its largest plus 2 lr (the backward's atomics reorder sums, and
AdamW's first steps move a leaf by about lr times the sign of its
gradient, which a rounding difference can flip where it is near 0); a
profiled replay runs no sort-based ``indexing_backward_kernel``.
The bf16 BEV ResNet and head at ``DEFAULT_CONFIG`` run NHWC: no cuDNN
layout conversion, no strided copy, and ``bev_restrides`` 0; their convs
finish bias, residual add and ReLU in their own pass (``bev_fused_convs``
18, ``bev_epilogue`` 3 a frame), the maps within 3% of the largest
magnitude of the unfused route's, ``bev_epilogue`` bit-exact.
"""

import re
import threading

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from dsvt_ai_trt_tpu_torch import kernels, weights
from dsvt_ai_trt_tpu_torch.config import DSVTConfig, WindowSpec
from dsvt_ai_trt_tpu_torch.ops import attention_kernel as ak
from dsvt_ai_trt_tpu_torch.ops import encoder_kernel as ek
from dsvt_ai_trt_tpu_torch.ops import nms_kernel as nk
from dsvt_ai_trt_tpu_torch.ops import nms_peel as npl
from dsvt_ai_trt_tpu_torch.ops import segment
from dsvt_ai_trt_tpu_torch.parallel import collectives, dryrun
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine, capture_segments

pytestmark = pytest.mark.cuda
NEG = -3.4028235e38


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _segments(rng, N, cap, forced=(), tail=0):
    """is_start of a stream of segments of 1..cap rows; each row in
    `forced` starts a segment of exactly cap rows; the last `tail` rows
    (> cap) form one over-cap segment, else the last segment ends at row
    N - 1."""
    forced = sorted(forced)
    end = N - tail
    flags = np.zeros(N, bool)
    p = 0
    while p < end:
        flags[p] = True
        if forced and p == forced[0]:
            forced.pop(0)
            p += cap
        else:
            limit = forced[0] if forced else end
            p += min(int(rng.integers(1, cap + 1)), limit - p)
    assert p == end and not forced
    if tail:
        flags[end] = True
    return flags


def _check_segment_max(dev, flags, C, cap, starts_only, dtype):
    rng = np.random.default_rng(len(flags) + C)
    is_start = torch.from_numpy(flags).to(dev)
    feats = torch.from_numpy(rng.normal(0, 1, (len(flags), C)).astype(
        np.float32)).to(dev, dtype)
    before = kernels.counts()["segment_max"]
    got = segment.segmented_max(feats, is_start, cap, starts_only)
    assert kernels.counts()["segment_max"] == before + 1
    ref = segment.segmented_max_plain(feats, is_start, cap, starts_only)
    seg = torch.cumsum(is_start.long(), 0) - 1
    defined = torch.bincount(seg)[seg] <= cap
    if starts_only:
        defined &= is_start
    assert got.dtype == dtype
    assert torch.equal(got[defined], ref[defined])
    return int(defined.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("starts_only", [False, True])
@pytest.mark.parametrize("N,C,cap", [(30000, 96, 48), (1001, 33, 8),
                                     (30000, 192, 48)])
def test_segment_max(dev, dtype, starts_only, N, C, cap):
    rng = np.random.default_rng(N + C)
    _check_segment_max(dev, _segments(rng, N, cap, tail=100), C, cap,
                       starts_only, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("starts_only", [False, True])
@pytest.mark.parametrize("C", [96, 192, 33])
@pytest.mark.parametrize("cap", [48, 64])
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_segment_max_tile_edges(dev, dtype, starts_only, C, cap, offset):
    """Segments of exactly cap rows that start one row before, on and one
    row after a tile edge (and reach into the next tile), N no multiple of
    the tile, and the last segment ending at row N - 1."""
    T = segment.TILE
    N = 7 * T + 13
    rng = np.random.default_rng(cap + offset + 2)
    forced = [k * T + offset for k in (1, 3, 5)]
    flags = _segments(rng, N, cap, forced)
    assert all(flags[f] and flags[f + cap] for f in forced)
    n_defined = _check_segment_max(dev, flags, C, cap, starts_only, dtype)
    assert n_defined == (int(flags.sum()) if starts_only else N)


@pytest.mark.parametrize("flag_dtype", [torch.bool, torch.uint8])
def test_segment_max_flags_in_place(dev, flag_dtype, monkeypatch):
    """The kernel reads the flag tensor's own bytes (no copy), with an
    over-cap tail that it leaves alone."""
    N, C, cap = 3001, 96, 48
    flags = _segments(np.random.default_rng(7), N, cap, tail=400)
    is_start = torch.from_numpy(flags).to(dev, flag_dtype)
    feats = torch.randn(N, C, device=dev).bfloat16()
    seen = []
    launch = kernels.launch
    monkeypatch.setattr(kernels, "launch",
                        lambda name, *a, **kw: (seen.append(a),
                                                launch(name, *a, **kw)))
    got = segment.segmented_max(feats, is_start, cap)
    assert seen[0][1] == is_start.data_ptr()
    ref = segment.segmented_max_plain(feats, is_start, cap)
    assert torch.equal(got[:N - 400], ref[:N - 400])


@pytest.mark.parametrize("S,K,C,H", [(800, 36, 192, 8), (64, 12, 32, 4),
                                     (50, 7, 96, 4)])
@pytest.mark.parametrize("count", [None, 19, 0])
def test_set_attention(dev, S, K, C, H, count):
    """Main-path tiling (K=36: 3 query m-tiles, 5 key n-tiles, D=24 as a
    k16 + k8 pair), D=8 heads, and K=7 with D=24 (one ragged tile each
    way).  count=19 ends the live sets inside a block's run of sets."""
    rng = np.random.default_rng(S + K)
    qkv = torch.from_numpy(rng.normal(0, 1, (S * K, 3 * C)).astype(
        np.float32)).to(dev, torch.bfloat16)
    mask = np.where(rng.uniform(size=(S, K)) < 0.2, NEG, 0.0).astype(np.float32)
    mask[3] = NEG                         # an all-dead set
    mask[5] = NEG                         # a set with exactly one live key
    mask[5, K // 2] = 0.0
    mask = torch.from_numpy(mask).to(dev)
    n_live = S if count is None else count
    cnt = None if count is None else torch.tensor(count, device=dev)
    got = ak.set_attention_fused_flat(qkv, mask, H, set_count=cnt)
    ref = ak.set_attention_plain(qkv, mask, H, set_count=cnt)
    live = (mask >= 0).reshape(-1)
    torch.testing.assert_close(got[live].float(), ref[live].float(),
                               atol=5e-3, rtol=2e-2)
    out = got.view(S, K, C)
    assert torch.all(out[3] == 0) and torch.all(out[n_live:] == 0)
    if n_live > 5:                        # one live key: its V row, rounded
        v = qkv.view(S, K, 3 * C)[5, K // 2, 2 * C:]
        assert torch.equal(out[5], v.expand(K, C))


@pytest.mark.parametrize("P,C,F", [(10000, 192, 384), (37, 32, 64)] + [
    (P, C, F) for C, F in ((192, 384), (32, 64))
    for P in (10000, 37, 64, 65, 10001) if (P, C) not in ((10000, 192),
                                                          (37, 32))])
def test_encoder_epilogue(dev, P, C, F):
    """64-row tiles: one partial tile (37), exactly one (64), one row past
    a tile (65), the main path's 157 tiles (10000) and one row more."""
    g = torch.Generator(device="cpu").manual_seed(P)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).to(dev)
    enc = {"wo": rnd(C, C, scale=C ** -0.5), "bo": rnd(C, scale=0.1),
           "ffn_w1": rnd(C, F, scale=C ** -0.5), "ffn_b1": rnd(F, scale=0.1),
           "ffn_w2": rnd(F, C, scale=F ** -0.5), "ffn_b2": rnd(C, scale=0.1)}
    for key in ("ln1", "ln2", "norm"):
        enc[f"{key}_g"] = 1 + rnd(C, scale=0.02)
        enc[f"{key}_b"] = rnd(C, scale=0.05)
    enc.update(ek.kernel_weights(enc))
    x = rnd(P, C)
    a = rnd(P, C).bfloat16()
    before = kernels.counts()["encoder_epilogue"]
    got = ek.encoder_epilogue(x, a, enc)
    assert kernels.counts()["encoder_epilogue"] == before + 1
    ref = ek.encoder_epilogue_plain(x, a, enc)
    torch.testing.assert_close(got, ref, atol=2e-2, rtol=0)


def _boxes(rng, n, offset=0.0):
    """Score-sorted random boxes in +-20 m around (offset, offset), with
    clusters of near neighbours; from 9 boxes on, rows 1-8 hold the edge
    cases: 1 and 2 identical, 4 nested in 3, 5 and 6 sharing an edge, 7 of
    zero width across 8."""
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (n, 2))
    boxes[:, 3] = rng.uniform(0.5, 6, n)
    boxes[:, 4] = rng.uniform(0.5, 3, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 8] = np.sort(rng.uniform(0.3, 1.0, n))[::-1]
    for c in range(0, n - 4, 5):
        boxes[c + 1:c + 4, :2] = boxes[c, :2] + rng.uniform(-0.6, 0.6, (3, 2))
    if n >= 9:
        boxes[2] = boxes[1]
        boxes[3, [0, 1, 3, 4, 6]] = [5.0, 5.0, 4.0, 2.0, 0.3]
        boxes[4, [0, 1, 3, 4, 6]] = [5.0, 5.0, 2.0, 1.0, 0.5]
        boxes[5, [0, 1, 3, 4, 6]] = [10.0, -10.0, 4.0, 2.0, 0.0]
        boxes[6, [0, 1, 3, 4, 6]] = [12.0, -10.0, 4.0, 2.0, 0.0]
        boxes[7, [0, 1, 3, 4, 6]] = [-5.0, 3.0, 3.0, 0.0, 0.0]
        boxes[8, [0, 1, 3, 4, 6]] = [-5.0, 3.0, 2.0, 2.0, 0.7]
    boxes[:, :2] += np.float32(offset)
    return boxes


def _upper_equal(got, ref):
    n = got.shape[0]
    iu = torch.triu_indices(n, n, 1, device=got.device)
    assert torch.equal(got[iu[0], iu[1]], ref[iu[0], iu[1]])
    assert torch.all(torch.tril(got) == 0)


@pytest.mark.parametrize("n", [500, 37, 513])
def test_rotated_overlap(dev, n):
    b = torch.from_numpy(_boxes(np.random.default_rng(n), n)).to(dev)
    got = nk.pairwise_overlap(b)
    _upper_equal(got, nk.pairwise_overlap_clip(b))
    area = float(b[1, 3] * b[1, 4])
    assert abs(float(got[1, 2]) - area) / area < 1e-4


@pytest.mark.parametrize("n", [1, 37, 500, 513])
@pytest.mark.parametrize("offset", [0.0, 55.0])
@pytest.mark.parametrize("strided", [False, True])
def test_rotated_overlap_cases(dev, n, offset, strided):
    """Identical, nested, edge-sharing and zero-width boxes, at the origin
    and at 50-60 m; boxes read in place from a wider row (row stride 12)."""
    boxes = _boxes(np.random.default_rng(n + int(offset)), n, offset)
    b = torch.from_numpy(boxes).to(dev)
    if strided:
        b = torch.cat([b, torch.ones(n, 3, device=dev)], dim=1)[:, :9]
        assert b.stride(0) == 12
    before = kernels.counts()["rotated_overlap"]
    got = nk.pairwise_overlap(b)
    assert kernels.counts()["rotated_overlap"] == before + 1
    _upper_equal(got, nk.pairwise_overlap_clip(b.contiguous()))
    if n >= 9:   # against the exact areas, at a few ulps of x*y at 60 m
        assert abs(float(got[3, 4]) - 2.0) < 1e-3          # nested: inner box
        assert abs(float(got[5, 6])) < 1e-3                 # shared edge
        assert abs(float(got[7, 8])) < 1e-3                 # zero width
        assert float(got[1, 2]) > 0.0                       # identical


@pytest.mark.parametrize("offset", [0.0, 55.0])
def test_rotated_overlap_near_contact(dev, offset):
    """Pairs whose circumcircles are just apart, touching or just overlapping
    (centre distance (ra + rb) * (1 + d), |d| <= 2e-3, around the kernel's
    early-out reach): every area equals the plain clip's."""
    rng = np.random.default_rng(int(offset) + 21)
    n = 256
    boxes = _boxes(rng, n, offset)
    r = 0.5 * np.hypot(boxes[:, 3], boxes[:, 4])
    for k in range(0, n, 2):
        ang = rng.uniform(-np.pi, np.pi)
        dist = (r[k] + r[k + 1]) * (1 + rng.uniform(-2e-3, 2e-3))
        boxes[k + 1, :2] = boxes[k, :2] + dist * np.array(
            [np.cos(ang), np.sin(ang)], np.float32)
        boxes[k + 1, 6] = boxes[k, 6] + rng.choice([0.0, np.pi / 2, ang])
    b = torch.from_numpy(boxes).to(dev)
    _upper_equal(nk.pairwise_overlap(b), nk.pairwise_overlap_clip(b))


def test_rotated_overlap_slow_path(dev):
    """A build with 4 vertex slots overflows on every overlapping pair whose
    first pass emits a fifth vertex and reruns it on 64 slots: still equal
    to the plain version.  The 16-slot build never needs the rerun here."""
    n = 500
    b = torch.from_numpy(_boxes(np.random.default_rng(9), n)).to(dev)
    ref = nk.pairwise_overlap_clip(b)
    for defines in ({"B4_SLOTS": 4}, None):
        out = torch.empty((n, n), device=dev)
        slow = torch.zeros(1, dtype=torch.int32, device=dev)
        entry = getattr(kernels.lib("rotated_overlap", defines),
                        kernels.SPECS["rotated_overlap"][1])
        assert entry(b.data_ptr(), b.stride(0), out.data_ptr(), n,
                     slow.data_ptr(),
                     torch.cuda.current_stream().cuda_stream) == 0
        _upper_equal(out, ref)
        assert (int(slow) > 50) if defines else (int(slow) == 0)


def _peel_equal(overlap, boxes, count, thr=0.01):
    """Kernel nms_peel against its plain version on the card: boxes out
    and kept count bit-equal, one launch.  Returns the kept count."""
    before = kernels.counts()["nms_peel"]
    out, n = npl.nms_peel(overlap, boxes, count, thr)
    assert kernels.counts()["nms_peel"] == before + 1
    ref_out, ref_n = npl.nms_peel_plain(overlap, boxes, count, thr)
    assert torch.equal(out.view(torch.int32), ref_out.view(torch.int32))
    assert n.dtype == torch.int64 and torch.equal(n, ref_n)
    return int(n)


def _pair_overlaps(gen, boxes, density, thr=0.01):
    """An overlap matrix for score-sorted boxes: a share `density` of the
    pairs gets an IoU within 1% of the threshold (about half of them
    suppress; the kernel must round as PyTorch does), the rest an IoU
    below half of it; the lower triangle holds noise the kernel must not
    read."""
    K = boxes.shape[0]
    sa = boxes[:, 3] * boxes[:, 4]
    pair = sa[:, None] + sa[None, :]
    u = torch.rand(K, K, device=boxes.device, generator=gen)
    near = torch.rand(K, K, device=boxes.device, generator=gen) < density
    iou = torch.where(near, thr * (0.99 + 0.02 * u), thr * 0.5 * u)
    overlap = iou * pair / (1 + iou)
    noise = torch.rand(K, K, device=boxes.device, generator=gen) * pair
    return torch.where(torch.ones_like(near).triu(1), overlap, noise)


@pytest.mark.parametrize("K", [1, 37, 500, 1024])
@pytest.mark.parametrize("density", [0.01, 0.2])
def test_nms_peel_random(dev, K, density):
    gen = torch.Generator(device=dev).manual_seed(K)
    boxes = torch.from_numpy(_boxes(np.random.default_rng(K), K)).to(dev)
    overlap = _pair_overlaps(gen, boxes, density)
    for count in (K, K // 2, 0):
        n = _peel_equal(overlap, boxes, torch.tensor(count, device=dev))
        assert n <= count and (n > 0) == (count > 0)


@pytest.mark.parametrize("thr", [0.01, 0.0])
def test_nms_peel_at_the_threshold(dev, thr):
    """IoUs a few ulps either side of the threshold, where the kernel's
    quick test cannot decide and it divides as PyTorch does; at a
    threshold of 0 (outside the quick test's range) every pair divides."""
    K = 300
    boxes = torch.zeros(K, 9, device=dev)
    boxes[:, 0] = torch.arange(K, device=dev)
    boxes[:, 3] = boxes[:, 4] = 1.0
    t = torch.tensor(max(thr, 1e-3), device=dev)
    ov = 2 * t / (1 + t)                  # IoU t at unit areas
    steps = torch.randint(-12, 13, (K, K), device=dev,
                          generator=torch.Generator(device=dev).manual_seed(3))
    bits = ov.view(torch.int32) + steps.int()
    overlap = bits.view(torch.float32).triu(1)
    for count in (K, 123):
        _peel_equal(overlap, boxes, torch.tensor(count, device=dev), thr)


@pytest.mark.parametrize("K", [500, 1024])
def test_nms_peel_deep_chain(dev, K):
    """Each box suppresses the next: K / 2 rounds, every other box kept."""
    boxes = torch.zeros(K, 9, device=dev)
    boxes[:, 0] = torch.arange(K, device=dev)
    boxes[:, 3] = boxes[:, 4] = 1.0
    overlap = torch.zeros(K, K, device=dev)
    i = torch.arange(K - 1, device=dev)
    overlap[i, i + 1] = 0.5
    assert _peel_equal(overlap, boxes, K) == K // 2


def test_nms_peel_on_rotated_overlap(dev):
    """On kernel B4's overlap of 500 decoded-like boxes (clusters of near
    neighbours, identical, nested and edge-sharing pairs)."""
    boxes = torch.from_numpy(_boxes(np.random.default_rng(13), 500)).to(dev)
    overlap = nk.pairwise_overlap(boxes)
    for count in (500, 321):
        n = _peel_equal(overlap, boxes, torch.tensor(count, device=dev))
        assert 0 < n < count


def test_nms_peel_refuses_more_than_1024_boxes(dev):
    with pytest.raises(ValueError, match="K <= 1024"):
        npl.nms_peel(torch.zeros(1025, 1025, device=dev),
                     torch.zeros(1025, 9, device=dev), 5, 0.01)


def _tiny_config(precision):
    """The test suite's tiny configuration (tests/conftest.py), built here:
    this file runs without the JAX conftest."""
    return DSVTConfig(
        max_points=2048, max_kept_points=1536, max_pillars=512,
        max_points_per_pillar=8, voxel_size=(0.32, 0.32, 8.0),
        pc_range_min=(-7.68, -7.68, -5.0), pc_range_max=(7.68, 7.68, 3.0),
        grid_size=(48, 48, 1), pfn_channels=(16, 32), sparse_shape=(48, 48, 1),
        window_specs=(WindowSpec((12, 12, 1), (0, 0, 0)),
                      WindowSpec((24, 24, 1), (6, 6, 0))),
        max_voxels_per_window=576, max_sets=128, set_size=12, num_blocks=2,
        num_heads=4, d_model=32, ffn_dim=64, num_classes=3, top_k=64,
        precision=precision)


def _cloud(cfg, n, seed):
    rng = np.random.default_rng(seed)
    lo = np.array(cfg.pc_range_min, np.float32)
    hi = np.array(cfg.pc_range_max, np.float32)
    pts = np.zeros((cfg.max_points, 4), np.float32)
    pts[:n, :3] = rng.uniform(lo - 0.5, hi + 0.5, (n, 3))
    pts[:n, 3] = rng.uniform(0, 1, n)
    return pts, n


@pytest.mark.parametrize("with_nms", [True, False])
@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_graph_replay_equals_eager(dev, precision, with_nms):
    cfg = _tiny_config(precision)
    engine = Engine(weights.random_params(cfg, 0), cfg,
                    with_nms=with_nms).warmup()
    frames = [_cloud(cfg, n, seed) for n, seed in ((1500, 1), (600, 2))]
    fused = 4 if precision == "bf16" else 0   # 2 blocks x 2 encoders
    want = {"segment_max": 2, "set_attention": fused,
            "encoder_epilogue": fused, "rotated_overlap": int(with_nms),
            "nms_peel": int(with_nms), "stage_mark": 0, "stage_pool": 0,
            "bev_epilogue": 3 if precision == "bf16" else 0,
            "query_attention": 0, "voxel_segments": 2}
    assert engine.graph_launches == want
    kernels.reset_counts()
    replays = [engine(pts, n) for pts, n in frames]   # no wait between
    assert kernels.counts() == {k: 2 * v for k, v in want.items()}
    for (pts, n), got in zip(frames, replays):
        ref = engine.eager(torch.from_numpy(pts).to(dev),
                           torch.tensor(n, device=dev))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    assert not torch.equal(replays[0].boxes, replays[1].boxes)
    with pytest.raises(ValueError, match="max_points"):
        engine(np.zeros((10, 4), np.float32), 3)


def test_scan_graph_equals_per_frame_replays(dev):
    """``Engine(..., batch=3)``: one replay holds three frames' launches,
    and each frame equals the per-frame engine's replay bit for bit."""
    cfg = _tiny_config("bf16")
    params = weights.random_params(cfg, 0)
    engine = Engine(params, cfg).warmup()
    scan = Engine(engine.params, cfg, batch=3).warmup()
    frames = [_cloud(cfg, n, seed) for n, seed in
              ((1500, 1), (600, 2), (900, 3))]
    per_frame = {"segment_max": 2, "set_attention": 4, "encoder_epilogue": 4,
                 "rotated_overlap": 1, "nms_peel": 1, "stage_mark": 0,
                 "stage_pool": 0, "bev_epilogue": 3, "query_attention": 0,
                 "voxel_segments": 2}
    assert scan.graph_launches == {k: 3 * v for k, v in per_frame.items()}
    points = np.stack([p for p, _ in frames])
    kernels.reset_counts()
    got = scan(points, [n for _, n in frames])
    assert kernels.counts() == scan.graph_launches
    for i, (pts, n) in enumerate(frames):
        for a, b in zip(got, engine(pts, n)):
            assert torch.equal(a[i], b)
    with pytest.raises(ValueError, match="max_points"):
        scan(points[:2], [1, 2])


def test_compiled_train_step_equals_eager(dev, tmp_path):
    """``CompiledTrainStep`` at the tiny configuration (fp32, batch 2):
    three replays against three eager steps, each pair from the same state
    (the graph's leaves, moments and count set in place to the eager's
    before each replay): the loss at 1e-5 relative, every leaf under
    ``dryrun.step_gate``; then a checkpoint of the graph's state resumes an
    eager step held the same way to the graph's next replay."""
    from dsvt_ai_trt_tpu_torch.data import synthetic_batch
    from dsvt_ai_trt_tpu_torch.parallel.training import (
        CompiledTrainStep, load_train_state, make_train_step,
        save_train_state)
    cfg = _tiny_config("fp32")
    batch = synthetic_batch(np.random.default_rng(3), cfg, 2, device=dev,
                            n_objects=2, n_ground=200, pts_per_obj=30)

    def fresh():
        return weights.from_jax_params(weights.random_params(cfg, 3), dev)

    ref, got = fresh(), fresh()
    opt_e, eager = make_train_step(cfg, ref)
    compiled = CompiledTrainStep(cfg, got, 2)

    def held(step_e, step_g, ref, got):
        le, lg = float(step_e(*batch)), float(step_g(*batch))
        assert abs(lg - le) <= 1e-5 * abs(le)
        for (path, a), (_, b) in zip(weights.named_leaves(ref),
                                     weights.named_leaves(got)):
            dryrun.step_gate(weights.keystr(path),
                             *(t.detach().cpu().numpy()
                               for t in (b, a, b.grad, a.grad)))

    def same_state():
        with torch.no_grad():
            for (_, r), (_, t) in zip(weights.named_leaves(ref),
                                      weights.named_leaves(got)):
                t.copy_(r)
                for key in ("exp_avg", "exp_avg_sq"):
                    compiled.optimizer.state[t][key].copy_(
                        opt_e.state[r][key])
            compiled.optimizer.count.copy_(opt_e.count)
        weights.refold(got)

    compiled.warmup()
    for k in range(3):
        if k:
            same_state()
        held(eager, compiled, ref, got)
    assert compiled.replays == 3 and int(compiled.optimizer.count) == 3
    assert not any(compiled.graph_launches.values())
    path = save_train_state(str(tmp_path / "state"), got,
                            compiled.optimizer, step=3)
    resumed = fresh()
    opt, step = make_train_step(cfg, resumed)
    assert load_train_state(path, resumed, opt) == 3
    held(step, compiled, resumed, got)
    assert int(compiled.optimizer.count) == int(opt.count) == 4
    with pytest.raises(ValueError, match="graph takes"):
        compiled(batch[0][:1], batch[1][:1],
                 type(batch[2])(*(t[:1] for t in batch[2])))


def test_compiled_train_step_sums_gathers_with_index_add(dev, tmp_path):
    """A profiled replay of ``CompiledTrainStep`` (tiny configuration, fp32,
    batch 2, the tracer on) runs no ``indexing_backward_kernel``, PyTorch's
    sort-based backward of ``table[idx]``: the row gathers' backward is
    ``index_add_`` (ops/gather.py), and the step's ``grad_gathers`` reads
    4 a block and 1 for the VFE a frame."""
    import json

    from torch.profiler import ProfilerActivity, profile

    from dsvt_ai_trt_tpu_torch.data import synthetic_batch
    from dsvt_ai_trt_tpu_torch.parallel.training import CompiledTrainStep
    from dsvt_ai_trt_tpu_torch.runtime import profiler

    cfg = _tiny_config("fp32")
    batch = synthetic_batch(np.random.default_rng(3), cfg, 2, device=dev,
                            n_objects=2, n_ground=200, pts_per_obj=30)
    profiler.enable_spans()
    try:
        step = CompiledTrainStep(cfg, weights.from_jax_params(
            weights.random_params(cfg, 3), dev), 2).warmup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            loss = step(*batch)
            torch.cuda.synchronize()
        (rec,) = [r for r in profiler.spans() if r["kind"] == "replay"]
    finally:
        profiler.disable_spans()
    assert torch.isfinite(loss)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    kernels_run = [e["name"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "kernel"]
    assert kernels_run                  # the profiler sees the graph's kernels
    assert [k for k in kernels_run if "indexing_backward_kernel" in k] == []
    assert rec["counters"]["grad_gathers"] == [2 * (4 * cfg.num_blocks + 1)]


@pytest.fixture
def gloo1(tmp_path):
    """A gloo group of one rank (this process): its collectives copy
    through the host as a larger group's do."""
    import torch.distributed as dist
    collectives.init_group("gloo", 1, 0, str(tmp_path / "init"))
    yield dist.group.WORLD
    dist.destroy_process_group()


def test_capture_segments_replays_two_all_reduces(dev, gloo1):
    """A toy program with two all-reduces: 3 segments, 2 host steps, and
    a replay equal to the eager run bit for bit (new inputs written into
    the captured ones)."""
    x = torch.randn(4096, device=dev)
    w = torch.randn(4096, device=dev)

    def fn():
        a = collectives.all_reduce(x * 2 + 1, gloo1)
        b = collectives.all_reduce(torch.sin(a) * w, gloo1)
        return torch.cos(b * 3)

    program, out, _launches, nbytes = capture_segments(fn, fn, dev, 2)
    assert program.segments == 3 and len(program.steps) == 2
    assert program.static_bytes == 2 * 4096 * 4 and nbytes >= 0
    for seed in (1, 2):
        x.copy_(torch.randn(4096, generator=torch.Generator().manual_seed(
            seed)).to(dev))
        collectives.reset_stats()
        program.replay()
        assert collectives.stats()["calls"] == 2
        assert torch.equal(out, fn())


def test_capture_segments_refuses_another_threads_collective(dev, gloo1):
    """A collective reached from another thread while the capture is open
    raises there; the capture fails and ends its open graph."""
    x = torch.ones(8, device=dev)

    def fn():
        errors = []

        def other():
            try:
                collectives.all_reduce(x, gloo1)
            except RuntimeError as exc:
                errors.append(exc)
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        if errors:
            raise errors[0]
        return x + 1

    with pytest.raises(RuntimeError, match="cannot be captured"):
        capture_segments(fn, lambda: None, dev, 1)
    assert float(collectives.all_reduce(x + 1, gloo1).sum()) == 16.0


@pytest.mark.parametrize("remat", [False, True])
def test_capture_segments_across_autograd_thread(dev, gloo1, remat):
    """Megatron's pair around a small MLP, its loss and its backward,
    captured across threads (``across_threads``): ``reduce_from_tp``'s
    all-reduce on this thread, ``copy_to_tp``'s in the backward on
    autograd's, and with a non-reentrant checkpoint (``collectives.
    carrying``) ``reduce_from_tp``'s again in the recomputation there.
    Segments: 1 + the 2 (3) collectives; replays of new inputs equal
    the eager run bit for bit."""
    from torch.utils.checkpoint import checkpoint
    gen = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(s, generator=gen).to(dev).requires_grad_()
                 for s in ((512, 64), (64, 128), (128, 64)))

    def block(inp):
        h = torch.relu(collectives.copy_to_tp(inp, gloo1) @ w1)
        # tanh keeps its output, so a recomputation runs to the end
        return torch.tanh(collectives.reduce_from_tp(h @ w2, gloo1))

    def fn():
        for t in (x, w1, w2):
            t.grad = None
        run = collectives.carrying(block)
        y = (checkpoint(run, x, use_reentrant=False,
                        preserve_rng_state=False) if remat else run(x))
        (y * y).sum().backward()
        return [t.grad for t in (x, w1, w2)]

    program, out, _launches, _nbytes = capture_segments(
        fn, fn, dev, 2, across_threads=True)
    assert program.segments == 1 + 2 + remat
    for seed in (1, 2):
        with torch.no_grad():
            x.copy_(torch.randn(x.shape, generator=torch.Generator()
                                .manual_seed(seed)).to(dev))
        collectives.reset_stats()
        program.replay()
        assert collectives.stats()["calls"] == 2 + remat
        for got, want in zip(out, fn()):
            assert torch.equal(got, want)


@pytest.mark.parametrize("group", ["tp", "spatial"])
def test_segmented_engine_replay_equals_eager(dev, gloo1, group):
    """``Engine(..., tp=)`` (fp32: Megatron's all-reduces) and ``Engine(...,
    spatial=)`` on the one-rank group: the segments ``dryrun.
    breaks_per_frame`` counts, plus one, and replays equal to
    ``Engine.eager`` bit for bit."""
    cfg = _tiny_config("fp32")
    engine = Engine(weights.random_params(cfg, 0), cfg,
                    **{group: gloo1}).warmup()
    mode = "mp" if group == "tp" else "sp"
    assert engine.segments == 1 + dryrun.breaks_per_frame(cfg, mode)
    assert engine.graph_launches == {
        "segment_max": 2, "set_attention": 0, "encoder_epilogue": 0,
        "rotated_overlap": 1, "nms_peel": 1, "stage_mark": 0,
        "stage_pool": 0, "bev_epilogue": 0, "query_attention": 0,
        "voxel_segments": 2}
    for n, seed in ((1500, 1), (600, 2)):
        pts, n = _cloud(cfg, n, seed)
        got = engine(pts, n)
        ref = engine.eager(torch.from_numpy(pts).to(dev),
                           torch.tensor(n, device=dev))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_stage_marks_land_on_their_kernels_and_leave_the_boxes(dev, tmp_path):
    """With the tracer on: the graph holds 10 stage marks a frame (the nine
    ``STAGES`` and "end"); on the host clock each replay's first mark
    follows its graph launch and the last mark precedes the host's
    synchronise, within the calibrating bracket, which is at most 20 us;
    after one offset (the mean of the differences) each mark lies within
    10 us of its ``stage_mark_kernel``'s start in a profiler trace;
    the warm-up's record holds its four spans; and the boxes equal those
    of an engine warmed with the tracer off."""
    import json
    import time

    from torch.profiler import ProfilerActivity, profile

    from dsvt_ai_trt_tpu_torch.model.detector import STAGES
    from dsvt_ai_trt_tpu_torch.runtime import profiler

    cfg = _tiny_config("bf16")
    plain = Engine(weights.random_params(cfg, 0), cfg).warmup()
    frames = [_cloud(cfg, n, seed) for n, seed in ((1500, 1), (600, 2))]
    profiler.enable_spans()
    try:
        traced = Engine(plain.params, cfg).warmup()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            got = [traced(pts, n) for pts, n in frames]
            torch.cuda.synchronize()
            t_sync = time.perf_counter_ns()
        records = profiler.spans()
        clock = profiler.calibration()
    finally:
        profiler.disable_spans()
    assert traced.graph_launches["stage_mark"] == len(STAGES) + 1
    assert plain.graph_launches["stage_mark"] == 0
    for (pts, n), dets in zip(frames, got):
        for a, b in zip(dets, plain(pts, n)):
            assert torch.equal(a, b)
    bracket = clock["bracket_ns"]
    assert 0 < bracket <= 20_000
    warm = next(r for r in records if r["what"] == "warmup")
    assert [s["name"] for s in warm["host"]] == [
        "warmup", "kernels", "warm_runs", "capture", "first_replay"]
    replays = [r for r in records if r["kind"] == "replay"][-len(frames):]
    marks = []
    for r in replays:
        assert [s["name"] for s in r["device"]] == list(STAGES)
        assert all(s["parent"] == "graph_launch" for s in r["device"])
        launch = next(s for s in r["host"] if s["name"] == "graph_launch")
        assert r["device"][0]["start_ns"] >= launch["start_ns"] - bracket
        marks += [s["start_ns"] for s in r["device"]]
        marks.append(r["device"][-1]["end_ns"])
    assert marks[-1] <= t_sync + bracket
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    starts = sorted(e["ts"] for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "kernel"
        and "stage_mark_kernel" in e["name"])
    assert len(starts) == len(marks) == len(frames) * (len(STAGES) + 1)
    ours = (np.array(marks) - marks[0]) / 1e3
    theirs = np.array(starts) - starts[0]
    offset = np.mean(theirs - ours)
    assert np.abs(theirs - ours - offset).max() <= 10.0


def test_stage_marks_after_the_tracer_is_switched_on_again(dev):
    """An engine warmed with the tracer on keeps its marks buffer and its
    graph's mark nodes when the tracer goes off; switched on again, the
    tracer calibrates on the first marks that reach it, and ``spans()``
    decodes the replay's stages on the host clock."""
    import time

    from dsvt_ai_trt_tpu_torch.model.detector import STAGES
    from dsvt_ai_trt_tpu_torch.runtime import profiler

    cfg = _tiny_config("bf16")
    pts, n = _cloud(cfg, 1500, 1)
    profiler.enable_spans()
    try:
        engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
        profiler.disable_spans()
        profiler.enable_spans()
        t0 = time.perf_counter_ns()
        engine(pts, n)
        (rec,) = profiler.spans()
        t1 = time.perf_counter_ns()
        bracket = profiler.calibration()["bracket_ns"]
    finally:
        profiler.disable_spans()
    assert rec["kind"] == "replay"
    assert [s["name"] for s in rec["device"]] == list(STAGES)
    assert t0 - bracket <= rec["device"][0]["start_ns"] \
        <= rec["device"][-1]["end_ns"] <= t1 + bracket


def test_stage_marks_through_a_ring_that_wraps(dev, monkeypatch):
    """With a ring of 3 host slots, 7 replays take each slot again after
    its earlier copy's event: every record keeps its own frame's marks
    (in order, after the one before) and occupancy."""
    from dsvt_ai_trt_tpu_torch.model.detector import STAGES
    from dsvt_ai_trt_tpu_torch.runtime import profiler

    monkeypatch.setattr(profiler, "RING", 3)
    cfg = _tiny_config("bf16")
    frames = [_cloud(cfg, n, seed) for n, seed in
              ((1500, 1), (600, 2), (900, 3), (300, 4), (1200, 5), (700, 6),
               (1000, 7))]
    profiler.enable_spans()
    try:
        engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
        got = [engine(pts, n).occupancy.tolist() for pts, n in frames]
        records = [r for r in profiler.spans() if r["kind"] == "replay"]
    finally:
        profiler.disable_spans()
    records = records[-len(frames):]
    assert [r["counters"]["occupancy"] for r in records] == [[o] for o in got]
    ends = 0
    for r in records:
        assert [s["name"] for s in r["device"]] == list(STAGES)
        assert r["device"][0]["start_ns"] >= ends
        ends = r["device"][-1]["end_ns"]


# cuDNN's layout conversions, and PyTorch's non-vectorised (strided) copy
# and add: what a conv stack out of layout runs (ops/layout.py)
CONVERSION = re.compile(r"nchwToNhwc|nhwcToNchw")
STRIDED = re.compile(r"elementwise_kernel<128, ?4\b.*(direct_copy|CUDAFunctor_add)")


def test_bev_stack_runs_nhwc_with_no_layout_conversion(dev):
    """One eager bf16 frame at ``DEFAULT_CONFIG`` under the profiler: under
    the ``backbone2d`` and ``head`` labels no cuDNN layout conversion runs,
    no strided copy, no concatenation's copy, no vectorised residual add,
    and one strided add, the heatmap conv's bias (PyTorch adds a conv's
    bias after cuDNN's kernel, a broadcast over the channels that its
    vectorised kernel does not take): every other conv finishes its bias,
    residual add and ReLU inside cuDNN's pass, and the three laterals in
    ``bev_epilogue``.  With the tracer on, a replay's ``bev_restrides``
    reads 0 and ``bev_fused_convs`` 18."""
    import dataclasses

    from dsvt_ai_trt_tpu_torch.bench import synthetic_frames
    from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.model.detector import forward
    from dsvt_ai_trt_tpu_torch.runtime import profiler, trace

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    params = weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 0), dev))          # as an Engine does
    pts, n = synthetic_frames(cfg)["dense_seed0"]
    points = torch.from_numpy(pts).to(dev)
    prof = trace.capture(lambda: forward(params, points, n, cfg, True, dev),
                         (), iters=1)
    names = [o["name"] for o in prof.ops
             if o["stage"] in ("backbone2d", "head")]
    assert [m for m in names if CONVERSION.search(m)] == []
    strided = [m for m in names if STRIDED.search(m)]
    assert len(strided) == 1 and "CUDAFunctor_add" in strided[0]
    assert not [m for m in names if "vectorized_elementwise_kernel" in m
                and "CUDAFunctor_add" in m]
    assert not [m for m in names if "CatArray" in m]
    assert sum("bev_epilogue_kernel" in m for m in names) == 3
    profiler.enable_spans()
    try:
        Engine(params, cfg).warmup()(pts, n)
        record = profiler.spans()[-1]
    finally:
        profiler.disable_spans()
    assert record["kind"] == "replay"
    assert record["counters"]["bev_restrides"] == [0]
    assert record["counters"]["bev_fused_convs"] == [18]


# the fused BEV stack against today's route (``backbone2d._on_card`` off):
# the largest difference as a share of the map's largest magnitude
FUSED_SHARE = 0.03


def test_bev_stack_fuses_its_epilogues(dev, monkeypatch):
    """``DEFAULT_CONFIG`` bf16, three seeds of weights on the frame's own
    BEV map: the fused route's backbone features and lazy head maps within
    ``FUSED_SHARE`` of their largest magnitude of today's route (f32 from
    the accumulator through bias, add and ReLU, one rounding, where today's
    rounds after the conv, the bias and the add: about one bf16 ulp a conv,
    compounded over 16 convs; worst seen 1.46% of the features' largest,
    1.20% of the heatmap's, 1.32% of the shared map's, H100, 3 seeds x 3
    frames).  Each lateral through ``bev_epilogue`` equals today's
    ``relu(conv_transpose2d(x, w, b))`` and the plain version bit for bit.
    The FLOPs counted are the same on both routes.  An ``Engine``'s replay
    equals its eager frame bit for bit, with ``bev_fused_convs`` 18 and
    three ``bev_epilogue`` launches a frame."""
    import dataclasses

    import torch.nn.functional as F

    from dsvt_ai_trt_tpu_torch.bench import synthetic_frames
    from dsvt_ai_trt_tpu_torch.config import BACKBONE2D_DEBLOCK, DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.model import backbone2d, detector
    from dsvt_ai_trt_tpu_torch.model.head import head_forward
    from dsvt_ai_trt_tpu_torch.ops import bev_epilogue as be
    from dsvt_ai_trt_tpu_torch.ops.common import relu
    from dsvt_ai_trt_tpu_torch.runtime import profiler
    from dsvt_ai_trt_tpu_torch.runtime.profiler import count_flops

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    pts, n = synthetic_frames(cfg)["dense_seed0"]
    points = torch.from_numpy(pts).to(dev)
    on_card = backbone2d._on_card

    def stack(params, bev, route):
        monkeypatch.setattr(backbone2d, "_on_card", route)
        try:
            feats = backbone2d.backbone2d_forward(bev, params["backbone2d"],
                                                  "bf16")
            return {"feats": feats, **head_forward(feats, params["head"],
                                                   "bf16", cfg, lazy=True)}
        finally:
            monkeypatch.setattr(backbone2d, "_on_card", on_card)

    for seed in range(3):
        params = weights.fold_convs(weights.from_jax_params(
            weights.random_params(cfg, seed), dev))
        seen = {}
        orig = detector.backbone2d_forward

        def record(bev, *args, **kw):
            seen["bev"] = bev.clone()
            return orig(bev, *args, **kw)
        monkeypatch.setattr(detector, "backbone2d_forward", record)
        with torch.inference_mode():
            detector.forward(params, points, n, cfg, True, dev)
        monkeypatch.setattr(detector, "backbone2d_forward", orig)
        with torch.inference_mode():
            fused = stack(params, seen["bev"], on_card)
            plain = stack(params, seen["bev"], lambda x: False)
        for name, want in plain.items():
            share = ((fused[name].float() - want.float()).abs().max()
                     / want.float().abs().max()).item()
            assert share <= FUSED_SHARE, (seed, name, share)

    gen = torch.Generator(device=dev).manual_seed(3)
    h, w = cfg.grid_size[1], cfg.grid_size[0]
    out = torch.empty((1, 384, h, w), dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    c0 = 0
    with torch.inference_mode():
        for s, deblock in enumerate(params["backbone2d"]["deblocks"]):
            k = BACKBONE2D_DEBLOCK[s][0]
            x = relu(torch.randn((1, deblock["w"].shape[0], h // k, w // k),
                                 device=dev, generator=gen)).to(
                torch.bfloat16, memory_format=torch.channels_last)
            wt = deblock["w" + backbone2d.BF16]
            b = deblock["b" + backbone2d.BF16]
            today = relu(F.conv_transpose2d(x, wt, b, stride=k))
            y = F.conv_transpose2d(x, wt, None, stride=k)
            got = be.bev_epilogue_cuda(y, b, out[:, c0:c0 + today.shape[1]])
            assert torch.equal(got, today), s
            ref = torch.empty_like(out)[:, :today.shape[1]]
            assert torch.equal(got, be.bev_epilogue_plain(y, b, ref)), s
            c0 += today.shape[1]

    bev = seen["bev"]
    with torch.inference_mode():
        flops = [count_flops(lambda: stack(params, bev, route)).total
                 for route in (on_card, lambda x: False)]
    assert flops[0] == flops[1] > 0

    profiler.enable_spans()
    try:
        engine = Engine(params, cfg).warmup()
        kernels.reset_counts()
        got = engine(pts, n)
        record = profiler.spans()[-1]
    finally:
        profiler.disable_spans()
    assert engine.graph_launches["bev_epilogue"] == 3
    assert kernels.counts()["bev_epilogue"] == 3
    assert record["counters"]["bev_fused_convs"] == [18]
    ref = engine.eager(points, torch.tensor(n, device=dev))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
