"""The four CUDA kernels against their plain versions, on the card.

Marked ``cuda``; each test skips (from a fixture) where no card is present.
Run on a machine with a card, without the JAX-loading conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: B3 bit-exact on the defined rows (max is exact); B1 atol 5e-3,
rtol 2e-2 on live query slots (bf16 inputs, f32 softmax, different
summation order), exact zeros on dead sets; B2 atol 2e-2 (a bf16 rounding
flip of x1 or of the GELU output before the next product); B4 atol and rtol
1e-4 on the strict upper triangle (same clip, f32, fused multiply-adds).
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


def _stream(rng, N, P, cap, n_valid):
    ids = []
    p = 0
    while len(ids) < n_valid and p < P:
        ids += [p] * int(rng.integers(1, cap + 1))
        p += 1
    ids = np.asarray(ids[:n_valid] + [P] * (N - min(len(ids), n_valid)))
    return np.concatenate([[True], ids[1:] != ids[:-1]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("starts_only", [False, True])
@pytest.mark.parametrize("N,C,cap", [(30000, 96, 48), (1001, 33, 8)])
def test_segment_max(dev, dtype, starts_only, N, C, cap):
    rng = np.random.default_rng(N + C)
    is_start = torch.from_numpy(_stream(rng, N, N, cap, N - 100)).to(dev)
    feats = torch.from_numpy(rng.normal(0, 1, (N, C)).astype(np.float32)).to(
        dev, dtype)
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


@pytest.mark.parametrize("n", [500, 37])
def test_rotated_overlap(dev, n):
    rng = np.random.default_rng(n)
    boxes = np.zeros((n, 9), np.float32)
    boxes[:, :2] = rng.uniform(-20, 20, (n, 2))
    boxes[:, 3] = rng.uniform(0.5, 6, n)
    boxes[:, 4] = rng.uniform(0.5, 3, n)
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    boxes[:, 8] = np.sort(rng.uniform(0.3, 1.0, n))[::-1]
    for c in range(0, n - 4, 5):
        boxes[c + 1:c + 4, :2] = boxes[c, :2] + rng.uniform(-0.6, 0.6, (3, 2))
    boxes[2] = boxes[1]
    b = torch.from_numpy(boxes).to(dev)
    got = nk.pairwise_overlap(b)
    ref = nk.pairwise_overlap_clip(b)
    iu = torch.triu_indices(n, n, 1, device=dev)
    torch.testing.assert_close(got[iu[0], iu[1]], ref[iu[0], iu[1]],
                               atol=1e-4, rtol=1e-4)
    assert torch.all(torch.tril(got) == 0)
    area = float(b[1, 3] * b[1, 4])
    assert abs(float(got[1, 2]) - area) / area < 1e-4
