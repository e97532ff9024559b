"""The TransFusion-L head's card paths: kernel ``query_attention`` against
its plain version at the nuScenes cell's shapes (200 queries over 468 x 468
cells) and at ragged sizes (a last key tile part full, a query count that
is no multiple of 16), its wrapper (no plain version on the card), and
the engine's CUDA graph of a whole ``dsvt-transfusion-nuscenes`` frame:
one ``query_attention`` launch, no NMS launch, the replay bit-equal to
``Engine.eager``.

Marked ``cuda``; each test skips (from a fixture) where no card is present.
Run on a machine with a card, without the JAX-loading conftest:

    python -m pytest tests/test_torch_transfusion_cuda.py --noconftest -q

Tolerances: ``query_attention`` atol 2e-2, rtol 2e-2 (the plain version
rounds x = L + Pk and the projected keys and values to bf16 as the kernel
does; the kernel also rounds the softmax weights to bf16 for the value
product, sums over 219 024 keys in another order, and rounds its output
once to bf16); the engine's replay bit-exact against its eager frame (the
same kernels on the same inputs).
"""

import json
import os
import sys

import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from dsvt_ai_trt_tpu_torch import kernels, weights          # noqa: E402
from dsvt_ai_trt_tpu_torch.config import DSVTConfig         # noqa: E402
from dsvt_ai_trt_tpu_torch.ops import query_attention_kernel as qa  # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine    # noqa: E402

pytestmark = pytest.mark.cuda
CONFIG = os.path.join(ROOT, "benchmark", "configs",
                      "dsvt-transfusion-nuscenes.json")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(dev, Nq, HW, seed):
    """Queries, L, Pk and the k | v weights at the scales of the head's
    seeded weights (unit-scale rows, Xavier-scale projections)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    C = qa.WIDTH
    q = torch.randn(Nq, C, generator=g)
    feats = torch.randn(HW, C, generator=g)
    pos = torch.randn(HW, C, generator=g)
    w_kv = torch.randn(2 * C, C, generator=g) * (2.0 / (3 * C + C)) ** 0.5
    b_kv = 0.1 * torch.randn(2 * C, generator=g)
    bf = torch.bfloat16
    return (q.to(dev, bf), feats.to(dev, bf), pos.to(dev, bf),
            w_kv.to(dev, bf), b_kv.to(dev))


@pytest.mark.parametrize("Nq,HW", [(200, 468 * 468), (37, 1000), (16, 64),
                                   (208, 8 * 64 + 1)])
def test_query_attention(dev, Nq, HW):
    args = _inputs(dev, Nq, HW, Nq + HW)
    got = qa.query_attention_cuda(*args, qa.HEADS)
    want = qa.query_attention_plain(*args, qa.HEADS)
    assert got.shape == (Nq, qa.WIDTH) and got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_query_attention_on_the_card_is_the_kernel(dev):
    """The wrapper launches the kernel for any card tensor: f32 queries are
    refused, not served by the plain version; so are other widths."""
    args = _inputs(dev, 24, 640, 3)
    kernels.reset_counts()
    qa.query_attention(*args, qa.HEADS)
    assert kernels.counts()["query_attention"] == 1
    with pytest.raises(ValueError, match="bf16"):
        qa.query_attention(args[0].float(), *args[1:], qa.HEADS)
    with pytest.raises(ValueError, match="208"):
        qa.query_attention(torch.cat([args[0]] * 10), *args[1:], qa.HEADS)


def _sweep(cfg_raw):
    from benchmark.reference import transfusion as ref
    from benchmark.traffic import generate

    with open(os.path.join(ROOT, "benchmark", "workloads",
                           "nusc-transfusion-stream.json")) as f:
        traffic = {**json.load(f)["traffic"], "frames": 1}
    return generate(traffic, 2 ** 31 + 7,
                    ref.QueryConfig.from_dict(cfg_raw))[0]


def test_transfusion_engine_replay_equals_eager(dev):
    with open(CONFIG) as f:
        raw = json.load(f)["config"]
    cfg = DSVTConfig.from_json(json.dumps({**raw, "precision": "bf16"}))
    cfg.validate()
    pts, n = _sweep(raw)
    engine = Engine(weights.random_params(cfg, 0), cfg).warmup()
    assert engine.graph_launches == {
        "segment_max": 2, "set_attention": 8, "encoder_epilogue": 8,
        "rotated_overlap": 0, "nms_peel": 0, "stage_mark": 0,
        "stage_pool": 0, "bev_epilogue": 3, "query_attention": 1,
        "voxel_segments": 2}
    kernels.reset_counts()
    got = engine(pts, n)
    assert kernels.counts() == engine.graph_launches
    ref = engine.eager(torch.from_numpy(pts).to(dev),
                       torch.tensor(n, device=dev))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert got.boxes.shape == (cfg.num_proposals, 13)
    assert bool(torch.isfinite(got.boxes).all())
    assert 0 < int(got.count) <= cfg.num_proposals
