"""The port's multi-device layer (parallel/mesh.py, collectives.py,
training.py) on the CPU, against the JAX package and against the port's
own unsharded path.

Sharded runs spawn gloo worlds of CPU processes
(``parallel.dryrun.spawn``); every child runs ``dryrun.run_tasks`` and
reports the modules of JAX or of the JAX package it imported (none).  One
world of 2 and one of 4 per module, each running several tasks, keep the
spawns few.  Tolerances: dp equals the unsharded path exactly (the same
computation on the same frames); mp and the train step at 1e-4 (the
sharded products sum in another order); against JAX's ``forward_jit`` the
tolerance of tests/test_parallel.py (atol 2e-3, rtol 1e-3) at fp32, and
tests/test_torch_parity.py's gate at bf16.
"""

import dataclasses

import jax
import numpy as np
import pytest

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.eval import coverage
from dsvt_ai_trt_tpu.model.detector import forward_jit
from dsvt_ai_trt_tpu.parallel import mesh as jax_mesh
from dsvt_ai_trt_tpu.parallel.training import (Targets as JaxTargets,
                                               batched_loss as jax_loss,
                                               random_targets)
from dsvt_ai_trt_tpu_torch.config import DSVTConfig
from dsvt_ai_trt_tpu_torch.parallel import dryrun, mesh

FRAMES = 4
CLIP = 1.0      # below the tiny model's global gradient norm: clipping acts
PARITY_SCORE = 0.3 + 0.05   # tests/test_torch_parity.py's MIN_SCORE
# CompiledTrainStep in the world of 4: (dp, mp, index of its task)
COMPILED = [(2, 2, 10), (1, 4, 11)]


def port_cfg(cfg, **kw) -> DSVTConfig:
    """The port's own config object (a child must not unpickle the JAX
    package's)."""
    return dataclasses.replace(DSVTConfig.from_json(cfg.to_json()), **kw)


def _frames(cfg, n_frames=FRAMES):
    rng = np.random.default_rng(1234)
    pts = np.stack([make_cloud(rng, cfg, 400 + 50 * i)[0]
                    for i in range(n_frames)])
    nums = np.array([400 + 50 * i for i in range(n_frames)], np.int32)
    return pts, nums


def _spawn(world, tasks):
    out = dryrun.spawn(dryrun.run_tasks, world, "cpu", (tasks,))
    for rank in out:
        assert rank["foreign_modules"] == []
    return [rank["results"] for rank in out]


@pytest.fixture(scope="module")
def inputs():
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, seed=2)
    pts, nums = _frames(cfg)
    targets = random_targets(np.random.default_rng(7), cfg, 2)
    return cfg, params, pts, nums, [np.asarray(t) for t in targets]


@pytest.fixture(scope="module")
def calibrated():
    """tests/test_torch_parity.py's dense cloud and its calibrated weights
    at bf16: on random weights near-equal boxes crowd the top-k, and the
    bf16 gate between XLA and PyTorch cannot hold there."""
    cfg = dataclasses.replace(tiny_config(), precision="bf16")
    pts, n = make_cloud(np.random.default_rng(77), cfg, 1500)
    raw = jax_weights.calibrated_raw(cfg, pts, n, seed=0, n_boxes=12)
    params = jax.tree_util.tree_map(np.asarray,
                                    jax_weights.prepare_params(raw, cfg))
    return cfg, params, pts[None], np.array([n], np.int32)


@pytest.fixture(scope="module")
def world2(inputs, calibrated):
    """dp=2 on 4 frames, mp=2 at fp32 (Megatron) and bf16 (gather, on the
    calibrated frame, boxes before NMS), the Megatron pair, and the
    unsharded references, in one world of 2."""
    cfg, params, pts, nums, _ = inputs
    cal_cfg, cal_params, cal_pts, cal_nums = calibrated
    c32, c16 = port_cfg(cfg), port_cfg(cal_cfg)
    rng = np.random.default_rng(3)
    mlp = [rng.normal(0, 1, s).astype(np.float32)
           for s in ((5, 6), (6, 8), (8,), (8, 6))]
    tasks = [(dryrun.forward_task, (c32, params, pts, nums, 2, 1)),
             (dryrun.forward_task, (c32, params, pts[:1], nums[:1], 1, 2)),
             (dryrun.forward_task, (c16, cal_params, cal_pts, cal_nums, 1,
                                    2, False, False)),
             (dryrun.whole_task, (c32, params, pts, nums)),
             (dryrun.whole_task, (c16, cal_params, cal_pts, cal_nums,
                                  False)),
             (dryrun.megatron_mlp_task, tuple(mlp))]
    return _spawn(2, tasks), mlp


@pytest.fixture(scope="module")
def world4(inputs, calibrated):
    """mp=4 at fp32 and bf16 (before NMS), and the train step at dp=2 x mp=2 (also with
    ``remat``), mp=4 and unsharded, eager and (dp=2 x mp=2, mp=4) through
    ``CompiledTrainStep``, in one world of 4."""
    cfg, params, pts, nums, targets = inputs
    cal_cfg, cal_params, cal_pts, cal_nums = calibrated
    c32, c16 = port_cfg(cfg), port_cfg(cal_cfg)
    tasks = [(dryrun.forward_task, (c32, params, pts[:1], nums[:1], 1, 4)),
             (dryrun.forward_task, (c16, cal_params, cal_pts, cal_nums, 1,
                                    4, False, False)),
             (dryrun.whole_task, (c32, params, pts[:1], nums[:1])),
             (dryrun.whole_task, (c16, cal_params, cal_pts, cal_nums,
                                  False)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  2, 2)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  1, 4)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  1, 1)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  1, 4, CLIP)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  1, 1, CLIP)),
             (dryrun.train_task, (c32, params, pts[:2], nums[:2], targets,
                                  2, 2, None, True))]
    tasks += [(dryrun.compiled_step_task, (c32, params, pts[:2], nums[:2],
                                           targets, 1, mp))
              for _dp, mp, _i in COMPILED]
    return _spawn(4, tasks)


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_params_match_jax_device_shards(mp):
    """Every leaf of the port's shard for rank (d, m) equals the data JAX
    places on device (d, m) of make_mesh(8 // mp, mp), bit for bit."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of conftest.py")
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, seed=0)
    jm = jax_mesh.make_mesh(8 // mp, mp)
    sharded = jax.tree_util.tree_leaves(jax_mesh.shard_params(params, jm))
    devices = np.asarray(jm.devices)
    n_sharded = 0
    for d in range(8 // mp):
        for m in range(mp):
            mine = jax.tree_util.tree_leaves(mesh.shard_params(
                params, mesh.Mesh(8 // mp, mp, d, m)))
            assert len(mine) == len(sharded)
            for got, arr in zip(mine, sharded):
                shard, = [s for s in arr.addressable_shards
                          if s.device == devices[d, m]]
                want = np.asarray(shard.data)
                assert got.shape == want.shape
                assert np.array_equal(got, want)
                n_sharded += got.shape != arr.shape
    # wq/wk/wv/ffn_w1, bq/bk/bv/ffn_b1 and wo/ffn_w2 of every encoder
    assert n_sharded == 8 * 2 * cfg.num_blocks * 10


def _assert_same(got, ref, n_frames, atol, rtol):
    for b in range(n_frames):
        n = int(ref["count"][b])
        assert int(got["count"][b]) == n
        np.testing.assert_allclose(got["boxes"][b][:n], ref["boxes"][b][:n],
                                   atol=atol, rtol=rtol)


def test_dp2_forward_equals_unsharded_and_jax(inputs, world2):
    cfg, params, pts, nums, _ = inputs
    results, _ = world2
    dp, whole = results[0][0], results[0][3]
    for rank in results:                      # gathered on every rank
        np.testing.assert_array_equal(rank[0]["boxes"], dp["boxes"])
    np.testing.assert_array_equal(dp["boxes"], whole["boxes"])
    np.testing.assert_array_equal(dp["count"], whole["count"])
    assert dp["boxes"].shape == (FRAMES, cfg.top_k, 9)
    for b in range(FRAMES):
        ref = forward_jit(params, pts[b], nums[b], cfg, True)
        n = int(ref.count)
        assert int(dp["count"][b]) == n and n > 0
        np.testing.assert_allclose(dp["boxes"][b], np.asarray(ref.boxes),
                                   atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("mp,route", [(2, "megatron"), (2, "gather"),
                                      (4, "megatron"), (4, "gather")])
def test_mp_forward_equals_unsharded(inputs, calibrated, world2, world4,
                                     mp, route):
    """fp32 runs Megatron's route, bf16 the head-gather route (B2 whole);
    each rank returns the same boxes as the unsharded path, and as JAX's
    ``forward_jit`` at the same precision: at fp32 within the tolerance of
    tests/test_parallel.py, at bf16 (XLA and PyTorch round bf16
    differently) under tests/test_torch_parity.py's gate on its
    calibrated frame's boxes before NMS."""
    cfg, params, pts, nums, _ = inputs
    ranks = world2[0] if mp == 2 else world4
    i, j = {(2, "megatron"): (1, 3), (2, "gather"): (2, 4),
            (4, "megatron"): (0, 2), (4, "gather"): (1, 3)}[(mp, route)]
    got, ref = ranks[0][i], ranks[0][j]
    others = [r[i] for r in ranks]
    for o in others:
        np.testing.assert_array_equal(o["boxes"], got["boxes"])
    _assert_same(got, ref, 1, atol=1e-4, rtol=1e-4)
    if route == "megatron":
        want = forward_jit(params, pts[0], nums[0], cfg, True)
        assert int(got["count"][0]) == int(want.count) > 0
        np.testing.assert_allclose(got["boxes"][0], np.asarray(want.boxes),
                                   atol=2e-3, rtol=1e-3)
        return
    cal_cfg, cal_params, cal_pts, cal_nums = calibrated
    want = forward_jit(cal_params, cal_pts[0], cal_nums[0], cal_cfg, False)
    a = got["boxes"][0][:int(got["count"][0])]
    b = np.asarray(want.boxes)[:int(want.count)]
    for q, pool in ((a, b), (b, a)):
        cov = coverage(q[q[:, 8] >= PARITY_SCORE], pool)
        assert cov["n"] >= 10 and cov["coverage"] >= 0.99, cov
        assert cov["max_score_err"] <= 0.03, cov
        assert cov["max_center_err"] <= 0.3, cov


def test_megatron_pair_gradients_equal_unsharded(world2):
    import torch
    results, (x, w1, b1, w2) = world2
    xt, w1t, b1t, w2t = (torch.tensor(a, requires_grad=True)
                         for a in (x, w1, b1, w2))
    y = torch.relu(xt @ w1t + b1t) @ w2t
    (y * y).sum().backward()
    for rank in results:
        got = rank[5]
        np.testing.assert_allclose(got["y"], y.detach().numpy(), rtol=1e-5,
                                   atol=1e-5)
        for key, t in (("dx", xt), ("dw1", w1t), ("db1", b1t), ("dw2", w2t)):
            np.testing.assert_allclose(got[key], t.grad.numpy(), rtol=1e-5,
                                       atol=1e-5)


def test_dp2_mp2_train_step(inputs, world4):
    """Loss equal to JAX's batched_loss at 1e-4 relative; mp=4 equal to
    mp=2 within 1e-3 (__graft_entry__.py:109); the AdamW step's leaves
    equal the unsharded step's."""
    cfg, params, pts, nums, targets = inputs
    dp2mp2, mp4, whole = world4[0][4], world4[0][5], world4[0][6]
    ref = float(jax.jit(lambda p: jax_loss(
        p, pts[:2], nums[:2], JaxTargets(*targets), cfg))(params))
    assert abs(dp2mp2["loss"] - ref) <= 1e-4 * abs(ref)
    assert abs(mp4["loss"] - dp2mp2["loss"]) <= 1e-3 * abs(dp2mp2["loss"])
    assert abs(whole["loss"] - ref) <= 1e-4 * abs(ref)
    for rank in world4:
        assert rank[4]["loss"] == dp2mp2["loss"]
    assert set(dp2mp2["leaves"]) == set(whole["leaves"])
    for got in (dp2mp2, mp4):
        for key, want in whole["leaves"].items():
            step_gate(key, got["leaves"][key], want, got["grads"][key],
                      whole["grads"][key])


def test_dp2_mp2_train_step_with_remat(world4):
    """With ``remat`` the backward reruns each frame's float stages, and
    with them Megatron's collectives: the step equals the unsharded step
    (the card's default) and the dp=2 x mp=2 step without remat."""
    got, plain, whole = world4[0][9], world4[0][4], world4[0][6]
    assert got["loss"] == plain["loss"]
    for want in (whole, plain):
        for key, leaf in want["leaves"].items():
            step_gate(key, got["leaves"][key], leaf, got["grads"][key],
                      want["grads"][key])


def test_clipped_step_under_mp4_equals_unsharded(world4):
    """clip_by_global_norm under mp=4 sums the sharded gradients' squares
    over the group: the clipped gradients and the step equal the unsharded
    clipped step's."""
    got, want = world4[0][7], world4[0][8]
    unclipped = world4[0][6]
    norm = np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                       for g in unclipped["grads"].values()))
    assert norm > CLIP                         # the clip is active
    for key, leaf in want["leaves"].items():
        step_gate(key, got["leaves"][key], leaf, got["grads"][key],
                  want["grads"][key])


def step_gate(key, new, ref_new, grad, ref_grad, lr=1e-4):
    """The gradient within 1e-4 of the leaf's largest plus 1e-6 (the key
    bias's gradient is zero but for rounding, ~1e-8), and the updated leaf
    within 1e-4 of its largest wherever the gradient exceeds its own
    difference by 1e-6 (100 AdamW eps).  Elsewhere the first step's update
    lr * g / (|g| + eps), about lr * sign(g), may flip with the gradient's
    rounding: held at 2 lr + 1e-6, the port's step gate
    (test_torch_training)."""
    gdiff = np.abs(grad - ref_grad)
    assert float(gdiff.max()) <= 1e-4 * float(np.abs(ref_grad).max()) \
        + 1e-6, key
    d = np.abs(new - ref_new)
    big = np.abs(ref_grad) > gdiff + 1e-6
    assert float(d[big].max(initial=0)) <= 1e-4 * float(
        np.abs(ref_new).max()), key
    assert float(d.max(initial=0)) <= 2 * lr + 1e-6, key


@pytest.mark.parametrize("dp,mp,i", COMPILED, ids=["dp2_mp2", "mp4"])
def test_compiled_sharded_step(inputs, world4, dp, mp, i):
    """``CompiledTrainStep`` under the dp x mp mesh (on the CPU its eager
    step, the program the card captures in segments): the loss equal to
    JAX's batched_loss at 1e-4 relative and to the eager step's, every
    rank's the same, and the step's leaves under ``step_gate`` against the
    unsharded eager step's."""
    cfg, params, pts, nums, targets = inputs
    ref = float(jax.jit(lambda p: jax_loss(
        p, pts[:2], nums[:2], JaxTargets(*targets), cfg))(params))
    got = world4[0][i]
    (loss, eager), = got["losses"]
    assert loss == eager and got["bit_equal"]
    assert abs(loss - ref) <= 1e-4 * abs(ref)
    for rank in world4:
        assert rank[i]["losses"] == got["losses"]
    whole = world4[0][6]
    assert set(got["leaves"]) == set(whole["leaves"])
    for key, want in whole["leaves"].items():
        step_gate(key, got["leaves"][key], want, got["grads"][key],
                  whole["grads"][key])


@pytest.mark.parametrize("dp,mp,i", COMPILED, ids=["dp2_mp2", "mp4"])
def test_compiled_sharded_step_breaks(inputs, world4, dp, mp, i):
    """Its collectives, each a graph break on the card, number
    ``dryrun.breaks_per_step`` on every rank (the dp all-reduce included
    at dp=2); the static buffers match what the transport returned; the
    sync guard finds no host read outside the transports."""
    cfg = port_cfg(inputs[0])
    want = dryrun.breaks_per_step(cfg, dp, mp, 2, False, False)
    for rank in world4:
        res = rank[i]
        assert len(res["breaks"]) == want
        assert all(b["static"] == b["eager"] for b in res["breaks"])
        assert res["hits"] == []


@pytest.mark.slow
def test_dryrun_five_modes_cpu_world_of_4():
    """parallel/dryrun.py's five modes at the flagship widths on a gloo CPU
    world of 4 (each gate raises inside the run)."""
    ranks = dryrun.spawn(dryrun.dryrun, 4, "cpu")
    assert abs(ranks[0]["loss_mp4"] - ranks[0]["loss"]) <= 1e-3 * abs(
        ranks[0]["loss"])
    for rank in ranks[1:]:
        assert rank["loss"] == ranks[0]["loss"]


@pytest.mark.slow
def test_dp_mp_engine_matches_jax_make_dp_engine(inputs, world2):
    """The port's dp=2 engine against JAX's make_dp_engine on a dp=4 x mp=2
    mesh of the 8 virtual devices, same frames and weights."""
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8 virtual CPU devices of conftest.py")
    cfg, params, pts, nums, _ = inputs
    run = jax_mesh.make_dp_engine(params, cfg, jax_mesh.make_mesh(4, 2),
                                  with_nms=True)
    ref = run(pts, nums)
    got = world2[0][0][0]
    for b in range(FRAMES):
        n = int(ref.count[b])
        assert int(got["count"][b]) == n
        np.testing.assert_allclose(got["boxes"][b], np.asarray(ref.boxes[b]),
                                   atol=2e-3, rtol=1e-3)
