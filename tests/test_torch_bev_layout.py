"""The memory layout of the BEV ResNet and the CenterHead (ops/layout.py),
on the CPU, at bf16, mixed and fp32:

* every conv of ``backbone2d_nchw`` and of the lazy and the full
  ``head_forward`` gets and gives [1, C, H, W] tensors with a batch stride
  of C*H*W, channels_last where its input is bf16 (weights included),
  NCHW-contiguous at fp32;
* ``bev_restrides``, the tracer's counter of the tensors the stack copies
  into its layout on a frame, reads 0 at bf16 and mixed, 1 at fp32 (the
  stack's entry);
* the maps equal those of the stack run the way it ran before it kept a
  layout of its own (NCHW-contiguous tensors, the f32 weights cast at
  every conv), within torch's default tolerances of their dtype;
* the folded bf16 conv weights are made for the bf16 and mixed engines
  only (``weights.fold_convs``), follow the leaves through an optimizer
  step (``refold``, in place) and stay out of the trained leaves and of
  ``unfold_params``.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu_torch import data, weights
from dsvt_ai_trt_tpu_torch.config import (BACKBONE2D_DEBLOCK,
                                          BACKBONE2D_STAGES, head_branches)
from dsvt_ai_trt_tpu_torch.model import backbone2d
from dsvt_ai_trt_tpu_torch.model.backbone2d import BF16, conv_nodes, fold
from dsvt_ai_trt_tpu_torch.model.head import head_forward
from dsvt_ai_trt_tpu_torch.ops import layout
from dsvt_ai_trt_tpu_torch.ops.common import (compute_dtype, matmul_dtype,
                                              relu)
from dsvt_ai_trt_tpu_torch.parallel.training import make_train_step
from dsvt_ai_trt_tpu_torch.runtime import profiler
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine

PRECISIONS = ["bf16", "mixed", "fp32"]


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 0), "cpu"))


def _bev(cfg, precision, h=24, w=20):
    g = torch.Generator().manual_seed(5)
    return torch.randn(h, w, cfg.d_model, generator=g).to(
        compute_dtype(precision))


@pytest.fixture
def convs(monkeypatch):
    """(input, weight, output) of every conv2d and conv_transpose2d."""
    seen = []

    def recording(fn):
        def call(x, w, b=None, *args, **kwargs):
            y = fn(x, w, b, *args, **kwargs)
            seen.append((x, w, y))
            return y
        return call
    monkeypatch.setattr(F, "conv2d", recording(F.conv2d))
    monkeypatch.setattr(F, "conv_transpose2d", recording(F.conv_transpose2d))
    return seen


def _run(stack, params, cfg, precision):
    bev = _bev(cfg, precision)
    with torch.inference_mode():
        if stack == "backbone2d":
            backbone2d.backbone2d_nchw(layout.to_nchw(bev),
                                       params["backbone2d"], precision)
        else:
            bev = torch.randn(*bev.shape[:2], 384).to(bev.dtype)
            head_forward(bev, params["head"], precision, cfg,
                         lazy=stack == "lazy head")


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("stack,n_convs",
                         [("backbone2d", 22), ("lazy head", 3),
                          ("full head", 8)])
def test_every_conv_sees_the_stacks_layout(tiny, convs, stack, n_convs,
                                           precision):
    cfg, params = tiny
    _run(stack, params, cfg, precision)
    assert len(convs) == n_convs
    fmt = (torch.contiguous_format if precision == "fp32"
           else torch.channels_last)
    for x, w, y in convs:
        assert x.dtype == w.dtype == matmul_dtype(precision)
        for t in (x, y):
            _n, c, h, wd = t.shape
            assert t.stride(0) == c * h * wd
        assert layout.is_laid_out(x, fmt), x.stride()
        assert layout.is_laid_out(w, fmt), w.stride()
        assert layout.is_laid_out(y, fmt), y.stride()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bev_restrides_counts_the_copies_of_a_frame(tiny, precision):
    cfg, params = tiny
    cfg = dataclasses.replace(cfg, precision=precision)
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)
    profiler.enable_spans()
    try:
        Engine(params, cfg, device="cpu")(pts, n)
        (record,) = profiler.spans()
    finally:
        profiler.disable_spans()
    assert record["counters"]["bev_restrides"] == [
        1 if precision == "fp32" else 0]


def test_laid_out_views_where_it_can_and_counts_its_copies():
    hwc = torch.randn(6, 5, 8)
    old = hwc.permute(2, 0, 1).unsqueeze(0)          # batch stride C
    assert old.stride() == (8, 1, 40, 8)
    assert old.is_contiguous(memory_format=torch.channels_last)
    assert not layout.is_laid_out(old, torch.channels_last)
    first = layout.restrides()
    view = layout.laid_out(old, torch.channels_last)
    assert view.stride() == (240, 1, 40, 8)
    assert view.data_ptr() == hwc.data_ptr()
    assert layout.restrides() == first
    nchw = layout.laid_out(old, torch.contiguous_format)
    assert nchw.stride() == (240, 30, 5, 1)
    assert layout.restrides() == first + 1
    sliced = nchw[:, 2:6]                            # a dense NCHW slice
    assert layout.laid_out(sliced, torch.contiguous_format).data_ptr() \
        == sliced.data_ptr()
    assert layout.restrides() == first + 1
    torch.testing.assert_close(nchw, old, rtol=0, atol=0)


def _nchw_reference(bev, params, cfg, precision):
    """The stack as it ran before it kept a layout of its own:
    NCHW-contiguous maps, the f32 OIHW weights cast at every conv.
    Returns the [H, W, 384] features, the full head and the lazy head."""
    mdt, cdt = matmul_dtype(precision), compute_dtype(precision)

    def conv(x, w, b, stride=1):
        return F.conv2d(x.to(mdt).contiguous(), w.to(mdt), b.to(mdt),
                        stride=stride, padding=w.shape[-1] // 2).to(cdt)

    x = bev.permute(2, 0, 1)[None].contiguous()
    laterals = []
    for s, (units, _ch, stride) in enumerate(BACKBONE2D_STAGES):
        for u in range(units):
            unit = params["backbone2d"]["stages"][s][u]
            st = stride if u == 0 else 1
            h = relu(conv(x, unit["conv1_w"], unit["conv1_b"], st))
            h = conv(h, unit["conv2_w"], unit["conv2_b"])
            short = (conv(x, unit["down_w"], unit["down_b"], st)
                     if "down_w" in unit else x)
            x = relu(h + short)
        d = params["backbone2d"]["deblocks"][s]
        y = F.conv_transpose2d(x.to(mdt).contiguous(), d["w"].to(mdt),
                               d["b"].to(mdt),
                               stride=BACKBONE2D_DEBLOCK[s][0])
        laterals.append(relu(y).to(cdt))
    x = torch.cat(laterals, dim=1)
    hp = params["head"]
    shared = relu(conv(x, hp["shared_w"], hp["shared_b"]))
    full = {}
    for name, _c in head_branches(cfg):
        h = relu(conv(shared, hp[name]["w0"], hp[name]["b0"]))
        full[name] = conv(h, hp[name]["w1"], hp[name]["b1"])
    hwc = lambda t: t[0].permute(1, 2, 0)
    return (hwc(x), {k: hwc(v) for k, v in full.items()},
            {"hm": hwc(full["hm"]), "shared": hwc(shared)})


@pytest.mark.parametrize("precision", PRECISIONS)
def test_maps_equal_the_nchw_stack(tiny, precision):
    cfg, params = tiny
    bev = _bev(cfg, precision)
    with torch.inference_mode():
        feats = backbone2d.backbone2d_forward(bev, params["backbone2d"],
                                              precision)
        full = head_forward(feats, params["head"], precision, cfg)
        lazy = head_forward(feats, params["head"], precision, cfg, lazy=True)
        ref = _nchw_reference(bev, params, cfg, precision)
    torch.testing.assert_close(feats, ref[0])
    for got, want in ((full, ref[1]), (lazy, ref[2])):
        assert sorted(got) == sorted(want)
        for name in want:
            assert got[name].dtype == want[name].dtype
            torch.testing.assert_close(got[name], want[name], msg=name)


@pytest.mark.parametrize("precision", PRECISIONS)
def test_bev_weights_are_folded_for_the_bf16_convs_only(tiny, precision):
    cfg = dataclasses.replace(tiny[0], precision=precision)
    fresh = weights.from_jax_params(weights.random_params(cfg, 0), "cpu")
    assert not [w for node, w, _b in conv_nodes(fresh) if w + BF16 in node]
    weights.refold(fresh)                   # remakes only what exists
    assert not [w for node, w, _b in conv_nodes(fresh) if w + BF16 in node]
    params = Engine(fresh, cfg, device="cpu").params
    folded = [w for node, w, _b in conv_nodes(params) if w + BF16 in node]
    assert len(folded) == (0 if precision == "fp32"
                           else len(list(conv_nodes(params))))


def test_folded_bev_weights_follow_an_optimizer_step():
    cfg = tiny_config()
    tparams = weights.fold_convs(weights.from_jax_params(
        weights.random_params(cfg, 4), "cpu"))
    nodes = list(conv_nodes(tparams))
    assert len(nodes) == 22 + 1 + 2 * len(head_branches(cfg))
    before = [(node[w].clone(), node[w + BF16].data_ptr())
              for node, w, _b in nodes]
    _, step = make_train_step(cfg, tparams, device="cpu")
    step(*data.synthetic_batch(np.random.default_rng(4), cfg, 1,
                               device="cpu", n_objects=2, n_ground=200,
                               pts_per_obj=30))
    moved = 0
    for (node, w, b), (old, ptr) in zip(nodes, before):
        fw, fb = fold(node[w], node[b])
        assert node[w + BF16].data_ptr() == ptr          # written in place
        assert layout.is_laid_out(node[w + BF16], torch.channels_last)
        assert torch.equal(node[w + BF16], fw)
        assert torch.equal(node[b + BF16], fb)
        moved += not torch.equal(node[w], old)
    # every leaf but the unread iou branch's two (no gradient: AdamW
    # skips them)
    assert moved == len(nodes) - 2
    leaves = [weights.keystr(p) for p, _ in weights.named_leaves(tparams)]
    assert not [k for k in leaves if BF16 in k and "blocks" not in k]
    raw = weights.unfold_params(tparams, cfg)
    assert sorted(raw) == sorted(weights.unfold_params(
        weights.from_jax_params(weights.to_jax_params(tparams), "cpu"), cfg))
    assert not [k for k in raw if "bf16" in k]
