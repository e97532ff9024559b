"""Kernel B2's plain version vs the JAX Pallas encoder epilogue, and the
DSVT backbone at fp32.

Same rows and weights into ``encoder_pallas.encoder_epilogue(...,
interpret=True)`` and the port's ``encoder_epilogue_plain``.  Both take
bf16 matmul inputs with f32 accumulation, so they differ only where the
summation order flips a bf16 rounding of x1 or of the GELU output (one
bf16 ulp, 2^-8 relative) before the next product; after the LayerNorms
that stays well inside atol 2e-2.  The fp32 backbone (unfused path) is held
against the JAX one at 1e-4, and the bf16 fused path (plain B1 + B2)
against the JAX bf16 path loosely, at the bf16 drift of the encoder passes.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.model.backbone3d import backbone3d_forward as jax_bb3d
from dsvt_ai_trt_tpu.model.vfe import vfe_forward as jax_vfe
from dsvt_ai_trt_tpu.ops.encoder_pallas import encoder_epilogue as jax_epilogue
from dsvt_ai_trt_tpu.ops.voxelize import voxelize as jax_voxelize
from dsvt_ai_trt_tpu.ops.windows import partition as jax_partition
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.model.backbone3d import backbone3d_forward
from dsvt_ai_trt_tpu_torch.ops.encoder_kernel import encoder_epilogue_plain
from dsvt_ai_trt_tpu_torch.ops.voxelize import voxelize
from dsvt_ai_trt_tpu_torch.ops.windows import partition


def test_plain_epilogue_matches_pallas():
    cfg = tiny_config()
    rng = np.random.default_rng(9)
    P, C = 200, cfg.d_model
    enc = jax_weights.random_params(cfg, 1)["blocks"][1]["enc"][0]
    x = rng.normal(0, 1, (P, C)).astype(np.float32)
    a = rng.normal(0, 1, (P, C)).astype(np.float32)
    a_bf = jnp.asarray(a).astype(jnp.bfloat16)

    ref = np.asarray(jax_epilogue(jnp.asarray(x), a_bf,
                                  {k: jnp.asarray(v) for k, v in enc.items()},
                                  cfg.ln_eps, interpret=True))
    tenc = weights.from_jax_params(enc, "cpu")
    got = encoder_epilogue_plain(torch.from_numpy(x),
                                 torch.from_numpy(a).to(torch.bfloat16),
                                 tenc, cfg.ln_eps).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=0)
    assert np.abs(got - ref).mean() < 1e-3


def _both_backbones(precision):
    cfg = dataclasses.replace(tiny_config(), precision=precision)
    pts, n = make_cloud(np.random.default_rng(4), cfg, 1500)
    params = jax_weights.random_params(cfg, 0)

    jp = jax_voxelize(jnp.asarray(pts), jnp.int32(n), cfg)
    jfeats = jax_vfe(jp, params["vfe"], cfg.max_pillars, "fp32",
                     allow_pallas=False)
    jparts = [jax_partition(jp.coords, jp.pillar_valid, s, cfg)
              for s in cfg.window_specs]
    ref = np.asarray(jax_bb3d(jfeats, [w for w, _ in jparts],
                              [s for _, s in jparts], params, cfg, precision))

    tparams = weights.from_jax_params(params, "cpu")
    tp = voxelize(torch.from_numpy(pts), int(n), cfg)
    tparts = [partition(tp.coords, tp.pillar_valid, s, cfg)
              for s in cfg.window_specs]
    tfeats = torch.from_numpy(np.array(jfeats))
    got = backbone3d_forward(tfeats, [w for w, _ in tparts],
                             [s for _, s in tparts], tparams, cfg,
                             use_kernels=True).float().numpy()
    valid = np.asarray(jp.pillar_valid)
    return got, ref, valid


def test_backbone3d_fp32_matches_jax():
    got, ref, _valid = _both_backbones("fp32")
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)


def test_backbone3d_bf16_fused_path_tracks_jax():
    """bf16: the port's fused path (B1 + B2 plain versions) vs the JAX bf16
    path (dot_product_attention + XLA epilogue); bf16 rounding through 4
    encoder passes, so a loose bound on valid pillars."""
    got, ref, valid = _both_backbones("bf16")
    err = np.abs(got[valid] - ref[valid])
    assert err.mean() < 2e-2, err.mean()
    assert np.corrcoef(got[valid].ravel(), ref[valid].ravel())[0, 1] > 0.999


@pytest.mark.parametrize("P", [8, 37])
def test_plain_epilogue_any_row_count(P):
    """The kernel contract has no P % 8 rule (the TPU padding logic does not
    carry over); the plain version is row-wise."""
    cfg = tiny_config()
    enc = weights.from_jax_params(
        jax_weights.random_params(cfg, 1)["blocks"][0]["enc"][1], "cpu")
    x = torch.randn(P, cfg.d_model, generator=torch.Generator().manual_seed(P))
    a = torch.randn(P, cfg.d_model,
                    generator=torch.Generator().manual_seed(P + 1)).bfloat16()
    full = encoder_epilogue_plain(x, a, enc)
    part = encoder_epilogue_plain(x[:5], a[:5], enc)
    torch.testing.assert_close(part, full[:5], atol=1e-5, rtol=1e-5)
