"""Kernel B1's plain version vs the JAX Pallas set attention, and the fp32
attention path.

The same gathered bf16 table goes through ``attention_pallas.
set_attention_fused_flat(..., interpret=True)`` and the port's
``set_attention_plain``.  On live slots they agree to bf16 rounding (atol
5e-3, rtol 2e-2, the tolerance of tests/test_attention_pallas.py: both run
bf16 inputs with an f32 softmax and round the unnormalised softmax weights
to bf16 before the V product; the sums run in different orders).  An
all-dead set and every set past ``set_count`` are exact zeros; the cases
put ``set_count`` inside a kernel block and at 0.  The fp32 path
(``set_attention_qkv``) is held at 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from dsvt_ai_trt_tpu.ops.attention import set_attention_qkv as jax_attn
from dsvt_ai_trt_tpu.ops.attention_pallas import set_attention_fused_flat
from dsvt_ai_trt_tpu_torch.ops.attention import set_attention_qkv
from dsvt_ai_trt_tpu_torch.ops.attention_kernel import set_attention_plain

NEG = -3.4028235e38


def _mk(rng, P, C, S, K):
    qkv_p = rng.normal(0, 1, (P, 3 * C)).astype(np.float32)
    inds = rng.integers(0, P + 1, (S, K)).astype(np.int32)  # P == dump
    mask = np.where(inds < P, 0.0, NEG).astype(np.float32)
    return qkv_p, inds, mask


def _gathered_bf16(qkv_p, inds):
    """The flat [S*K, 3C] bf16 table, dump rows zero, for both sides."""
    table = np.concatenate([qkv_p, np.zeros((1, qkv_p.shape[1]), np.float32)])
    return torch.from_numpy(table[inds.reshape(-1)]).to(torch.bfloat16)


@pytest.mark.parametrize("count", [19, 0, 64])
def test_plain_matches_pallas(count):
    rng = np.random.default_rng(21 + count)
    P, C, H, S, K = 300, 64, 4, 64, 12
    qkv_p, inds, mask = _mk(rng, P, C, S, K)
    inds[3] = P                       # one all-dead set among the live ones
    mask[3] = NEG
    inds[count:] = P
    mask[count:] = NEG
    flat = _gathered_bf16(qkv_p, inds)

    ref = np.asarray(set_attention_fused_flat(
        jnp.asarray(flat.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(mask), H, interpret=True,
        set_count=jnp.int32(count))).astype(np.float32).reshape(S, K, C)
    got = set_attention_plain(flat, torch.from_numpy(mask), H,
                              torch.tensor(count)).float().numpy()
    got = got.reshape(S, K, C)

    live = mask == 0.0
    np.testing.assert_allclose(got[live], ref[live], atol=5e-3, rtol=2e-2)
    assert np.all(got[3] == 0.0)
    assert np.all(got[count:] == 0.0)
    np.testing.assert_array_equal(ref[count:], 0.0)


def test_fp32_set_attention_matches_jax():
    rng = np.random.default_rng(5)
    P, C, H, S, K = 200, 32, 4, 16, 12
    qkv_p, inds, mask = _mk(rng, P, C, S, K)
    ref = np.asarray(jax_attn(jnp.asarray(qkv_p), jnp.asarray(inds),
                              jnp.asarray(mask), H, "fp32"))
    got = set_attention_qkv(torch.from_numpy(qkv_p),
                            torch.from_numpy(inds).long(),
                            torch.from_numpy(mask), H, "fp32").numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_fused_path_matches_jax_bf16_path():
    """The port's fused bf16 path (clip gather + B1) vs the JAX bf16 path
    (dot_product_attention) on live slots."""
    rng = np.random.default_rng(6)
    P, C, H, S, K = 200, 64, 4, 16, 12
    qkv_p, inds, mask = _mk(rng, P, C, S, K)
    ref = np.asarray(jax_attn(jnp.asarray(qkv_p), jnp.asarray(inds),
                              jnp.asarray(mask), H, "bf16")).astype(np.float32)
    got = set_attention_qkv(torch.from_numpy(qkv_p),
                            torch.from_numpy(inds).long(),
                            torch.from_numpy(mask), H, "bf16",
                            use_kernels=True).float().numpy()
    live = mask == 0.0
    np.testing.assert_allclose(got[live], ref[live], atol=5e-3, rtol=2e-2)
