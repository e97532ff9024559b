"""The voxel model's card paths against their plain versions: the pooling
kernel ``stage_pool`` at the voxel Waymo cell's shapes (and its wrapper,
which takes no plain version on the card), kernel B1 at sets
of 48, and the engine's CUDA graph of a whole ``dsvt-voxel-waymo`` frame
against ``Engine.eager``.

Marked ``cuda``; each test skips (from a fixture) where no card is present.
Run on a machine with a card, without the JAX-loading conftest:

    python -m pytest tests/test_torch_voxel_cuda.py --noconftest -q

Tolerances: ``stage_pool`` atol 2e-2, rtol 1e-2 on live parents (bf16
inputs, f32 softmax and sums in another order than the plain version's
einsums, one bf16 rounding of the output), exact zeros past the count;
B1 as ``test_torch_cuda.py`` holds it; the engine's replay bit-exact
against its eager frame (the same kernels on the same inputs).
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsvt_ai_trt_tpu_torch import kernels, weights          # noqa: E402
from dsvt_ai_trt_tpu_torch.config import (  # noqa: E402
    DSVTConfig, occupancy_caps)
from dsvt_ai_trt_tpu_torch.ops import attention_kernel as ak  # noqa: E402
from dsvt_ai_trt_tpu_torch.ops import pool_kernel as pk      # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine     # noqa: E402

pytestmark = pytest.mark.cuda
NEG = torch.finfo(torch.float32).min
CONFIG = os.path.join(ROOT, "benchmark", "configs", "dsvt-voxel-waymo.json")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _pool_inputs(dev, N0, N1, V, C, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(N1, C, generator=g).to(dev, torch.bfloat16)
    kv = torch.randn(N0, 2 * C, generator=g).to(dev, torch.bfloat16)
    # each parent takes 1..V children in random slots; N0 marks an empty one
    child = torch.full((N1, V), N0, dtype=torch.long)
    perm = torch.randperm(N0, generator=g)
    n_child = torch.randint(1, V + 1, (N1,), generator=g)
    used = 0
    for p in range(N1):
        k = int(n_child[p])
        if used + k > N0:
            break
        slots = torch.randperm(V, generator=g)[:k]
        child[p, slots] = perm[used:used + k]
        used += k
    kbias = torch.randn(V, C, generator=g).to(dev)
    vbias = (0.1 * torch.randn(C, generator=g)).to(dev)
    return q, kv, child.to(dev), kbias, vbias


@pytest.mark.parametrize("N0,N1,V", [(31768, 21797, 4), (21797, 17368, 4),
                                     (17368, 14350, 2), (37, 20, 8)])
def test_stage_pool(dev, N0, N1, V):
    C, H = 192, 8
    q, kv, child, kbias, vbias = _pool_inputs(dev, N0, N1, V, C, N0 + V)
    count = torch.tensor([N1 - 7], dtype=torch.int32, device=dev)
    got = pk.stage_pool_cuda(q, kv, child, kbias, vbias, count, H)
    want = pk.stage_pool_plain(q, kv, child, kbias, vbias, count, H)
    live = N1 - 7
    torch.testing.assert_close(got[:live].float(), want[:live].float(),
                               atol=2e-2, rtol=1e-2)
    assert torch.equal(got[live:], torch.zeros_like(got[live:]))


def test_stage_pool_on_the_card_is_the_kernel(dev):
    """The wrapper launches the kernel for any card tensor: an f32 query
    is refused, not served by the plain version."""
    q, kv, child, kbias, vbias = _pool_inputs(dev, 64, 32, 4, 64, 1)
    count = torch.tensor([32], dtype=torch.int32, device=dev)
    kernels.reset_counts()
    pk.stage_pool(q, kv, child, kbias, vbias, count, 8)
    assert kernels.counts()["stage_pool"] == 1
    with pytest.raises(ValueError, match="bf16"):
        pk.stage_pool(q.float(), kv, child, kbias, vbias, count, 8)


@pytest.mark.parametrize("count", [None, 700])
def test_set_attention_at_sets_of_48(dev, count):
    """Kernel B1 at K = 48, C = 192 (112 KB of staged rows a block, two
    blocks an SM): the voxel model's sets."""
    S, K, C, H = 1024, 48, 192, 8
    g = torch.Generator(device="cpu").manual_seed(48)
    qkv = torch.randn(S * K, 3 * C, generator=g).to(dev, torch.bfloat16)
    mask = torch.where(torch.rand(S, K, generator=g) < 0.2, NEG,
                       0.0).to(dev)
    mask[:, 0] = 0.0
    got = ak.set_attention_cuda(qkv, mask, H, count)
    want = ak.set_attention_plain(qkv, mask, H, count)
    live = S if count is None else count
    torch.testing.assert_close(got[:live * K].float(),
                               want[:live * K].float(), atol=5e-3, rtol=2e-2)
    assert torch.equal(got[live * K:], torch.zeros_like(got[live * K:]))


def _sweep(cfg_raw):
    from benchmark.reference import voxel as ref
    from benchmark.traffic import generate

    with open(os.path.join(ROOT, "benchmark", "workloads",
                           "waymo-voxel-stream.json")) as f:
        traffic = {**json.load(f)["traffic"], "frames": 1}
    return generate(traffic, 2 ** 31 + 5, ref.VoxelConfig.from_dict(cfg_raw))[0]


def test_voxel_engine_replay_equals_eager(dev):
    with open(CONFIG) as f:
        raw = json.load(f)["config"]
    cfg = DSVTConfig.from_json(json.dumps({**raw, "precision": "bf16"}))
    cfg.validate()
    pts, n = _sweep(raw)
    engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
    assert engine.graph_launches == {
        "segment_max": 2 + 3, "set_attention": 8, "encoder_epilogue": 8,
        "rotated_overlap": 1, "nms_peel": 1, "stage_mark": 0,
        "stage_pool": 3, "bev_epilogue": 3, "query_attention": 0,
        "voxel_segments": 2}
    kernels.reset_counts()
    got = engine(pts, n)
    assert kernels.counts() == engine.graph_launches
    ref = engine.eager(torch.from_numpy(pts).to(dev),
                       torch.tensor(n, device=dev))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    occ = got.occupancy.cpu().numpy()
    caps = np.array(occupancy_caps(cfg)[1])
    assert np.all(occ < caps) and occ[1] > occ[2] > occ[3] > occ[4] > 0
