"""The BEV stack's fused epilogues (model/backbone2d.py), on the CPU:

* ``bev_epilogue``'s plain version writes, lateral by lateral into one
  preallocated map, exactly what today's route computes on the card: the
  ReLU of the transposed conv plus its bias (which PyTorch adds after
  cuDNN's kernel, rounding once) and the concatenation of the three;
* ``fold_convs`` folds a unit's down conv's bias into its second conv's,
  summed in f32 and rounded once, and ``refold`` keeps it in step with the
  leaves through an optimizer step, in place;
* the route follows what the code observes: with the card's fused cuDNN
  calls stood in for by their formula (f32 from the conv through bias, add
  and ReLU, one rounding) and the device check passed, a bf16 frame takes
  it (``bev_fused_convs`` 18, its maps close to today's) and fp32, mixed,
  a recorded gradient, a training step and spatial sharding do not (0,
  today's code; the stand-ins there raise).

The card's own calls are held to today's route in
``tests/test_torch_cuda.py::test_bev_stack_fuses_its_epilogues``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu_torch import data, weights
from dsvt_ai_trt_tpu_torch.config import BACKBONE2D_DEBLOCK
from dsvt_ai_trt_tpu_torch.model import backbone2d
from dsvt_ai_trt_tpu_torch.model.backbone2d import (BF16, SHORTCUT_B,
                                                    shortcut_units)
from dsvt_ai_trt_tpu_torch.model.head import head_forward
from dsvt_ai_trt_tpu_torch.ops.bev_epilogue import (bev_epilogue,
                                                    bev_epilogue_plain)
from dsvt_ai_trt_tpu_torch.ops.common import relu
from dsvt_ai_trt_tpu_torch.ops.layout import to_nchw
from dsvt_ai_trt_tpu_torch.parallel import spatial
from dsvt_ai_trt_tpu_torch.parallel.training import (CompiledTrainStep,
                                                     make_train_step)
from dsvt_ai_trt_tpu_torch.runtime import profiler
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 0), "cpu"))


def _conv_relu(x, w, b, stride, padding, dilation, groups):
    """cuDNN's fused conv + bias + ReLU, by its formula: f32 throughout,
    one rounding."""
    return _conv_add_relu(x, w, None, 0.0, b, stride, padding, dilation,
                          groups)


def _conv_add_relu(x, w, z, alpha, b, stride, padding, dilation, groups):
    y = F.conv2d(x.float(), w.float(), b.float(), stride, padding, dilation,
                 groups)
    if z is not None:
        y = y + alpha * z.float()
    return relu(y).to(x.dtype, memory_format=torch.channels_last)


def _refused(*args):
    raise AssertionError("the fused route ran where it must not")


@pytest.fixture
def card_route(monkeypatch):
    """The device check passed and the fused cuDNN calls stood in for;
    ``refuse()`` makes them raise instead."""
    monkeypatch.setattr(backbone2d, "_on_card", lambda x: True)
    monkeypatch.setattr(torch, "cudnn_convolution_relu", _conv_relu,
                        raising=False)
    monkeypatch.setattr(torch, "cudnn_convolution_add_relu", _conv_add_relu,
                        raising=False)

    def refuse():
        monkeypatch.setattr(torch, "cudnn_convolution_relu", _refused)
        monkeypatch.setattr(torch, "cudnn_convolution_add_relu", _refused)
        monkeypatch.setattr(backbone2d, "bev_epilogue", _refused)
    return refuse


def _bev(cfg, dtype, h=24, w=20, seed=5):
    g = torch.Generator().manual_seed(seed)
    return relu(torch.randn(h, w, cfg.d_model, generator=g)).to(dtype)


def _stack(params, cfg, bev, precision):
    feats = backbone2d.backbone2d_forward(bev, params["backbone2d"], precision)
    return {"feats": feats, **head_forward(feats, params["head"], precision,
                                           cfg, lazy=True)}


def test_plain_epilogue_equals_relu_and_cat_of_the_laterals(tiny):
    cfg, params = tiny
    g = torch.Generator().manual_seed(7)
    h, w = 24, 20
    out = torch.empty((1, 384, h, w), dtype=torch.bfloat16,
                      memory_format=torch.channels_last)
    laterals, c0 = [], 0
    for s, deblock in enumerate(params["backbone2d"]["deblocks"]):
        k = BACKBONE2D_DEBLOCK[s][0]
        x = relu(torch.randn((1, deblock["w"].shape[0], h // k, w // k),
                             generator=g)).to(
            torch.bfloat16, memory_format=torch.channels_last)
        b = deblock["b" + BF16]
        y = F.conv_transpose2d(x, deblock["w" + BF16], None, stride=k)
        # today's lateral on the card: cuDNN's conv, then PyTorch's bias add
        laterals.append(relu(y + b.view(1, -1, 1, 1)))
        got = bev_epilogue(y, b, out[:, c0:c0 + y.shape[1]])
        assert got.data_ptr() == out[:, c0:].data_ptr()
        c0 += y.shape[1]
    want = torch.cat(laterals, dim=1)
    assert c0 == want.shape[1] == 384
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert out.is_contiguous(memory_format=torch.channels_last)


def test_plain_epilogue_keeps_nan_and_rounds_once():
    y = torch.tensor([1.0, -3.0, float("nan"), 0.5, 2.0 ** -8, -0.25, 7.0,
                      1.0]).to(torch.bfloat16).view(1, 8, 1, 1)
    b = torch.tensor([2.0 ** -9, 1.0, 0.0, -1.0, 1.0, 0.25, 0.0,
                      2.0 ** -8]).to(torch.bfloat16)
    out = torch.full((1, 8, 1, 1), 9.0, dtype=torch.bfloat16)
    got = bev_epilogue_plain(y, b, out).flatten()
    want = relu((y.flatten().float() + b.float()).to(torch.bfloat16))
    assert torch.equal(got.isnan(), want.isnan())
    keep = ~want.isnan()
    assert torch.equal(got[keep], want[keep])
    assert got[2].isnan() and got[1] == 0 and got[3] == 0


def test_shortcut_bias_is_the_sum_and_follows_refold():
    cfg = tiny_config()
    tparams = weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 4), "cpu"))
    units = list(shortcut_units(tparams))
    assert len(units) == 3                      # one a stage
    for unit in units:
        assert unit[SHORTCUT_B].dtype == torch.bfloat16
        assert torch.equal(unit[SHORTCUT_B], (
            unit["conv2_b"].float() + unit["down_b"].float()).bfloat16())
    ptrs = [u[SHORTCUT_B].data_ptr() for u in units]
    before = [u[SHORTCUT_B].clone() for u in units]
    _, step = make_train_step(cfg, tparams, device="cpu")
    step(*data.synthetic_batch(np.random.default_rng(4), cfg, 1,
                               device="cpu", n_objects=2, n_ground=200,
                               pts_per_obj=30))
    for unit, ptr, old in zip(units, ptrs, before):
        assert unit[SHORTCUT_B].data_ptr() == ptr         # written in place
        assert torch.equal(unit[SHORTCUT_B], (
            unit["conv2_b"].detach().float()
            + unit["down_b"].detach().float()).bfloat16())
        assert not torch.equal(unit[SHORTCUT_B], old)
    leaves = [weights.keystr(p) for p, _ in weights.named_leaves(tparams)]
    assert not [k for k in leaves if "conv2_down" in k]
    assert not [k for k in weights.unfold_params(tparams, cfg)
                if "conv2_down" in k]


def test_fused_route_matches_todays_stack(tiny, card_route, monkeypatch):
    """The route's wiring (which map is added, which bias is folded, where
    each lateral lands) with the fused calls by their formula: within
    rounding of today's stack, 18 fused convs."""
    cfg, params = tiny
    bev = _bev(cfg, torch.bfloat16)
    with torch.inference_mode():
        first = backbone2d.fused_convs()
        got = _stack(params, cfg, bev, "bf16")
        assert backbone2d.fused_convs() - first == 18
        monkeypatch.setattr(backbone2d, "_on_card", lambda x: False)
        want = _stack(params, cfg, bev, "bf16")
    assert backbone2d.fused_convs() - first == 18
    for name, ref in want.items():
        assert got[name].dtype == ref.dtype and got[name].shape == ref.shape
        diff, ref = (got[name].float() - ref.float()).abs(), ref.float().abs()
        # rounding alone: at most 1.1% of the largest, 0.8% of the mean;
        # conv2 without the down conv's bias: 4.2-5.2%, 1.8-5.0%
        assert (diff.max() / ref.max()).item() < 0.03, name
        assert (diff.mean() / ref.mean()).item() < 0.015, name


@pytest.mark.parametrize("precision", ["bf16", "fp32", "mixed"])
def test_bev_fused_convs_counts_a_frames_fused_convs(tiny, card_route,
                                                      precision):
    cfg, params = tiny
    cfg = dataclasses.replace(cfg, precision=precision)
    if precision != "bf16":
        card_route()                                # refuse the route
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    profiler.enable_spans()
    try:
        Engine(params, cfg, device="cpu")(pts, n)
        (record,) = profiler.spans()
    finally:
        profiler.disable_spans()
    assert record["counters"]["bev_fused_convs"] == [
        18 if precision == "bf16" else 0]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_bev_fused_convs_reads_0_in_a_training_step(card_route, precision):
    card_route()
    cfg = dataclasses.replace(tiny_config(), precision=precision)
    tparams = weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 4), "cpu"))
    step = CompiledTrainStep(cfg, tparams, 1, device="cpu")
    batch = data.synthetic_batch(np.random.default_rng(4), cfg, 1,
                                 device="cpu", n_objects=2, n_ground=200,
                                 pts_per_obj=30)
    profiler.enable_spans()
    try:
        loss = step(*batch)
        (record,) = profiler.spans()
    finally:
        profiler.disable_spans()
    assert torch.isfinite(loss)
    assert record["what"] == "step"
    assert record["counters"]["bev_fused_convs"] == [0]


def test_route_falls_to_todays_code_off_the_card_or_with_a_gradient(
        tiny, card_route, monkeypatch):
    cfg, params = tiny
    unit = params["backbone2d"]["stages"][0][0]
    x = to_nchw(_bev(cfg, torch.bfloat16))
    fuses = backbone2d.fuses_epilogue
    with torch.inference_mode():
        assert fuses(x, unit, "conv1_w", "bf16")
        assert not fuses(x, unit, "conv1_w", "mixed")
        assert not fuses(x, unit, "conv1_w", "fp32")
        with monkeypatch.context() as m:
            m.setattr(spatial, "active", lambda: True)
            assert not fuses(x, unit, "conv1_w", "bf16")
        bare = {k: v for k, v in unit.items() if not k.endswith(BF16)}
        assert not fuses(x, bare, "conv1_w", "bf16")     # nothing folded
    with torch.no_grad():
        assert fuses(x, unit, "conv1_w", "bf16")
    assert fuses(x, unit, "conv1_w", "bf16")      # no tensor records
    leaves = {k: (v.detach().requires_grad_(True) if not k.endswith(BF16)
                  else v) for k, v in unit.items()}
    assert not fuses(x, leaves, "conv1_w", "bf16")   # a leaf records
    with torch.no_grad():
        assert fuses(x, leaves, "conv1_w", "bf16")
    xg = x.detach().float().requires_grad_(True).to(torch.bfloat16)
    assert not fuses(xg, unit, "conv1_w", "bf16")    # the map records
    monkeypatch.setattr(backbone2d, "_on_card", lambda t: t.is_cuda)
    with torch.inference_mode():
        assert not fuses(x, unit, "conv1_w", "bf16")  # the CPU itself
