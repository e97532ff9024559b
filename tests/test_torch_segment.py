"""Kernel B3's plain version vs the JAX Pallas segmented max, and the VFE.

Same streams (numpy seed) into ``segment_pallas.segmented_max(...,
interpret=True)`` and the port's ``segmented_max_plain``: both modes, f32
and bf16; the defined rows must be exactly equal (max is exact).  Then the
port's vfe_forward (kernel path with the plain B3, and the scatter
reference) against the JAX vfe_forward reference that forward_debug runs,
at fp32 (atol/rtol 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.model.vfe import vfe_forward as jax_vfe
from dsvt_ai_trt_tpu.ops.segment_pallas import segmented_max as jax_segmax
from dsvt_ai_trt_tpu.ops.voxelize import voxelize as jax_voxelize
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.model.vfe import vfe_forward
from dsvt_ai_trt_tpu_torch.ops.segment import segmented_max_plain
from dsvt_ai_trt_tpu_torch.ops.voxelize import voxelize

CAP = 48


def _stream(rng, N, P, cap, n_valid):
    """Sorted pillar ids with segments of 1..cap rows, then the sentinel
    tail (one over-cap segment, undefined)."""
    ids = []
    p = 0
    while len(ids) < n_valid and p < P:
        ids += [p] * int(rng.integers(1, cap + 1))
        p += 1
    ids = np.asarray(ids[:n_valid] + [P] * (N - min(len(ids), n_valid)),
                     np.int32)
    return np.concatenate([[True], ids[1:] != ids[:-1]])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("starts_only", [False, True])
def test_segmented_max_plain_matches_pallas(dtype, starts_only):
    rng = np.random.default_rng(11)
    N, C = 1920, 16
    is_start = _stream(rng, N, 600, CAP, 1700)
    feats = rng.normal(0, 1, (N, C)).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16

    ref = np.asarray(jax_segmax(jnp.asarray(feats, jdt), jnp.asarray(is_start),
                                CAP, interpret=True,
                                starts_only=starts_only).astype(jnp.float32))
    got = segmented_max_plain(torch.from_numpy(feats).to(tdt),
                              torch.from_numpy(is_start), CAP,
                              starts_only).float().numpy()
    starts = np.flatnonzero(is_start)
    ends = np.append(starts[1:], N)
    checked = 0
    for s, e in zip(starts, ends):
        if e - s > CAP:
            continue  # the over-cap sentinel tail is undefined
        rows = slice(s, s + 1) if starts_only else slice(s, e)
        np.testing.assert_array_equal(got[rows], ref[rows],
                                      err_msg=f"segment {s}:{e}")
        checked += 1
    assert checked > 50


def _vfe_inputs(seed, n_points):
    cfg = tiny_config()
    pts, n = make_cloud(np.random.default_rng(seed), cfg, n_points)
    params = jax_weights.random_params(cfg, 0)
    return cfg, pts, n, params


@pytest.mark.parametrize("use_kernel_path", [True, False])
def test_vfe_matches_jax_reference(use_kernel_path):
    cfg, pts, n, params = _vfe_inputs(5, 1500)
    jp = jax_voxelize(jnp.asarray(pts), jnp.int32(n), cfg)
    # the JAX reference path (what forward_debug's pillar_feats runs)
    ref = np.asarray(jax_vfe(jp, params["vfe"], cfg.max_pillars, "fp32",
                             allow_pallas=False))
    tp = voxelize(torch.from_numpy(pts), int(n), cfg)
    tparams = weights.from_jax_params(params, "cpu")
    got = vfe_forward(tp, tparams["vfe"], cfg, use_kernels=use_kernel_path)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    assert np.count_nonzero(np.abs(ref).sum(1)) == int(jp.pillar_count)
