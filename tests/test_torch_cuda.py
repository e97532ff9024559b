"""The four CUDA kernels against their plain versions, on the card.

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
own, with no fused multiply-adds, as the plain version's PyTorch ops do.
"""

import numpy as np
import pytest
import torch

from dsvt_ai_trt_tpu_torch import kernels
from dsvt_ai_trt_tpu_torch.ops import attention_kernel as ak
from dsvt_ai_trt_tpu_torch.ops import encoder_kernel as ek
from dsvt_ai_trt_tpu_torch.ops import nms_kernel as nk
from dsvt_ai_trt_tpu_torch.ops import segment

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
