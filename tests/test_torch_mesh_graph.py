"""The port's multi-device programs as the card compiles them, checked on
the CPU at the tiny configuration (the captures themselves run on the card:
``chip_smoke.py``'s multi phase and ``tests/test_torch_cuda.py``).

One gloo world of 2 spawned CPU processes (``parallel.dryrun.spawn``, as
tests/test_torch_parallel.py runs them) runs each mode's compiled
counterpart (``dryrun.graph_task``): dp through ``make_dp_engine``, mp
through ``Engine(..., tp=)`` at fp32 (Megatron's route) and bf16 (the
heads' gather), sp through ``Engine(..., spatial=)`` at fp32 and bf16, and
``CompiledTrainStep`` under a dp = 2 and an mp = 2 mesh
(``dryrun.compiled_step_task``).  On the CPU the engines and the step run
their eager programs, which is what a card captures:

* (a) breaks: a ``dryrun.BreakRecorder`` runs every collective through the
  real transport and records, per break, the static buffers a segmented
  capture would make; their shapes and dtypes equal what the transport
  returned, and the breaks a frame equal ``dryrun.breaks_per_frame`` (dp at
  mp = 1: none), pinned here at ``DEFAULT_CONFIG`` too;
* (b) the sync guard (``runtime.compile.SyncGuard``) finds no host read in
  the dp, mp and sp forwards or the dp and mp train steps, outside the two
  transports (and the kernels' plain versions, as in
  tests/test_torch_graph.py);
* (c) the fp32 dp, mp and sp programs against the JAX package's jitted
  ``make_dp_engine`` (dp = 2 and mp = 2 meshes) and its jitted forward
  inside ``spatial_sharding`` over 2 of the 8 virtual devices: counts and
  occupancy exact, boxes within the golden's 1e-4;
* (d) the compiled step under the dp mesh equals ``make_train_step(...,
  mesh=)``'s eager step bit for bit over 3 steps (``dryrun.held_steps``,
  each replay from the eager step's state), with one break a step
  (gradients and loss in one all-reduce);
* (e) the compiled step under the mp = 2 mesh, with ``remat`` off and on
  and with the clip, equals the eager step bit for bit, and its breaks a
  step equal ``dryrun.breaks_per_step`` (Megatron's collectives in the
  forward, the backward and the recomputation; the replicated leaves'
  average; the clip's);
* (f) with the ranks' copies of the replicated leaves nudged apart, the
  mp = 2 step still gives both ranks the same AdamW moments of them (the
  step averages their gradients over the mp group);
* a collective reached from another thread while one thread intercepts
  raises, and a backward run on another thread reaches the hook of the
  thread that ran its forward, its checkpoint's recomputation included
  (``collectives.carried``, ``collectives.carrying``).
"""

import dataclasses
import threading

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config
from test_golden import _assert_boxes

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.model.detector import forward as jax_forward
from dsvt_ai_trt_tpu.parallel import mesh as jax_mesh
from dsvt_ai_trt_tpu.parallel.spatial import spatial_sharding as jax_sp
from dsvt_ai_trt_tpu.parallel.training import random_targets
from dsvt_ai_trt_tpu_torch.config import DEFAULT_CONFIG, DSVTConfig
from dsvt_ai_trt_tpu_torch.parallel import collectives, dryrun

# (mode, precision, frames, index of its task in the world's results)
MODES = [("dp", "fp32", 2, 0), ("mp", "fp32", 1, 1), ("mp", "bf16", 1, 2),
         ("sp", "fp32", 1, 3), ("sp", "bf16", 1, 4)]
IDS = [f"{m}_{p}" for m, p, _n, _i in MODES]
CLIP = 1.0      # below the tiny model's global gradient norm: clipping acts
# the mp = 2 steps: (remat, clip, index of the task in the world's results)
MP_STEPS = [(False, None, 6), (True, None, 7), (True, CLIP, 8)]
MP_IDS = ["plain", "remat", "remat_clip"]


def port_cfg(cfg, **kw) -> DSVTConfig:
    """The port's own config object (a child must not unpickle the JAX
    package's)."""
    return dataclasses.replace(DSVTConfig.from_json(cfg.to_json()), **kw)


@pytest.fixture(scope="module")
def inputs():
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, seed=2)
    rng = np.random.default_rng(1234)
    pts = np.stack([make_cloud(rng, cfg, 900 + 100 * i)[0]
                    for i in range(2)])
    nums = np.array([900, 1000], np.int32)
    targets = random_targets(np.random.default_rng(7), cfg, 2)
    return cfg, params, pts, nums, [np.asarray(t) for t in targets]


@pytest.fixture(scope="module")
def world2(inputs):
    cfg, params, pts, nums, targets = inputs
    tasks = [(dryrun.graph_task, (port_cfg(cfg, precision=p), params,
                                  pts[:n], nums[:n], mode))
             for mode, p, n, _i in MODES]
    tasks.append((dryrun.compiled_step_task, (port_cfg(cfg), params, pts,
                                              nums, targets)))
    tasks += [(dryrun.compiled_step_task, (port_cfg(cfg), params, pts, nums,
                                           targets, 1, 2, remat, clip))
              for remat, clip, _i in MP_STEPS]
    tasks.append((dryrun.replicated_moments_task, (port_cfg(cfg), params,
                                                   pts, nums, targets)))
    out = dryrun.spawn(dryrun.run_tasks, 2, "cpu", (tasks,))
    for rank in out:
        assert rank["foreign_modules"] == []
    return [rank["results"] for rank in out]


@pytest.mark.parametrize("mode,precision,n,i", MODES, ids=IDS)
def test_breaks_match_the_eager_collectives(inputs, world2, mode, precision,
                                            n, i):
    cfg = port_cfg(inputs[0], precision=precision)
    want = dryrun.breaks_per_frame(cfg, mode)
    for rank in world2:
        res = rank[i]
        assert res["breaks_per_frame"] == [want] * (1 if mode == "dp" else n)
        for brk in res["breaks"]:
            assert brk["static"] == brk["eager"], brk
            if brk["kind"] == "all_gather":
                assert len(brk["static"]) == 2
    kinds = {b["kind"] for b in world2[0][i]["breaks"]}
    assert kinds == {"dp": set(), "mp": {"all_reduce"} if precision == "fp32"
                     else {"all_gather"}, "sp": {"all_gather"}}[mode]


def test_breaks_per_frame_at_the_default_config():
    bf16 = dataclasses.replace(DEFAULT_CONFIG, precision="bf16")
    assert [dryrun.breaks_per_frame(DEFAULT_CONFIG, m)
            for m in ("dp", "mp", "sp")] == [0, 16, 41]
    assert [dryrun.breaks_per_frame(bf16, m)
            for m in ("dp", "mp", "sp")] == [0, 8, 41]


@pytest.mark.parametrize("mode,precision,n,i", MODES, ids=IDS)
def test_no_host_read_outside_the_transports(world2, mode, precision, n, i):
    for rank in world2:
        assert rank[i]["hits"] == []
        assert int(rank[i]["count"][0]) > 0


def _jax_dp_engine(params, cfg, dp, mp, pts, nums):
    run = jax_mesh.make_dp_engine(params, cfg, jax_mesh.make_mesh(dp, mp),
                                  with_nms=True)
    return run(pts, nums)


def _jax_spatial(params, cfg, pts, nums):
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("sp",))
    with jax_sp(mesh):
        ref = jax.jit(lambda p, x, m: jax_forward(p, x, m, cfg, True))(
            params, pts[0], nums[0])
    return jax.tree_util.tree_map(lambda a: np.asarray(a)[None], ref)


@pytest.mark.parametrize("mode", ["dp", "mp", "sp"])
def test_fp32_programs_equal_jax(inputs, world2, mode):
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual CPU devices of conftest.py")
    cfg, params, pts, nums, _ = inputs
    i = {"dp": 0, "mp": 1, "sp": 3}[mode]
    n = MODES[i][2]
    if mode == "sp":
        ref = _jax_spatial(params, cfg, pts, nums)
    else:
        dp, mp = (2, 1) if mode == "dp" else (1, 2)
        ref = _jax_dp_engine(params, cfg, dp, mp, pts[:n], nums[:n])
    for rank in world2:
        got = rank[i]
        np.testing.assert_array_equal(got["count"], np.asarray(ref.count))
        np.testing.assert_array_equal(got["occupancy"],
                                      np.asarray(ref.occupancy))
        for b in range(n):
            k = int(got["count"][b])
            assert k > 0
            _assert_boxes(got["boxes"][b][:k], np.asarray(ref.boxes)[b][:k])


def test_compiled_step_under_dp_mesh_equals_eager(world2):
    for rank in world2:
        res = rank[5]
        assert len(res["losses"]) == 3
        for got, want in res["losses"]:
            assert got == want
        assert res["bit_equal"]
        assert res["hits"] == []
        brk, = res["breaks"]                     # gradients and loss
        assert brk["kind"] == "all_reduce" and brk["static"] == brk["eager"]
    assert world2[0][5]["losses"] == world2[1][5]["losses"]
    losses = [got for got, _ in world2[0][5]["losses"]]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("remat,clip,i", MP_STEPS, ids=MP_IDS)
def test_compiled_step_under_mp_mesh_equals_eager(inputs, world2, remat,
                                                  clip, i):
    cfg = port_cfg(inputs[0])
    want = dryrun.breaks_per_step(cfg, 1, 2, 2, remat, clip is not None)
    for rank in world2:
        res = rank[i]
        (got, eager), = res["losses"]
        assert got == eager and res["bit_equal"]
        assert len(res["breaks"]) == want
        for brk in res["breaks"]:
            assert brk["kind"] == "all_reduce"
            assert brk["static"] == brk["eager"], brk
    assert world2[0][i]["losses"] == world2[1][i]["losses"]
    assert world2[0][i]["losses"] == world2[0][6]["losses"]


def test_mp_ranks_take_one_update_of_the_replicated_leaves(world2):
    """With each rank's copy of the replicated leaves moved one ulp at
    random, so that their gradients differ between the ranks as the
    card's atomics make them differ, the mp = 2 step averages those
    gradients: both ranks' AdamW moments of every replicated leaf are
    bit-equal (JAX keeps one array), while the leaves themselves still
    differ by their nudges."""
    mine, theirs = (rank[9] for rank in world2)
    assert set(mine) == set(theirs) and len(mine) > 0
    assert any(not np.array_equal(mine[k]["leaf"], theirs[k]["leaf"])
               for k in mine)
    for key, got in mine.items():
        for m in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(got[m], theirs[key][m],
                                          err_msg=f"{key} {m}")


@pytest.mark.parametrize("remat,clip,i", MP_STEPS, ids=MP_IDS)
def test_no_host_read_in_the_mp_step(world2, remat, clip, i):
    for rank in world2:
        assert rank[i]["hits"] == []


def test_breaks_per_step_at_the_default_config():
    """At ``DEFAULT_CONFIG`` (8 encoders): 72 breaks a frame with
    ``remat``, 56 without; one more for the dp all-reduce and, under
    mp > 1, one for the replicated leaves' average and one for the
    clip."""
    cfg = DEFAULT_CONFIG
    assert dryrun.breaks_per_step(cfg, 1, 2, 2, True, False) == 145
    assert dryrun.breaks_per_step(cfg, 1, 2, 2, False, False) == 113
    assert dryrun.breaks_per_step(cfg, 2, 2, 2, True, True) == 75
    assert dryrun.breaks_per_step(cfg, 2, 1, 2, True, True) == 1


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_backward_on_another_thread_reaches_the_hook(remat):
    """A forward under ``intercepted`` on this thread, its backward run
    from another thread, as autograd runs a CUDA backward: ``copy_to_tp``'s
    all-reduce and the checkpoint's recomputed ``reduce_from_tp`` reach
    the hook there; the gradients equal the plain MLP's (the hook is a
    one-rank all-reduce)."""
    from torch.utils.checkpoint import checkpoint
    seen = []

    def hook(kind, x, group):
        seen.append((kind, threading.get_ident()))
        return x.clone()

    gen = torch.Generator().manual_seed(0)
    x, w1, w2 = (torch.randn(s, generator=gen, requires_grad=True)
                 for s in ((6, 4), (4, 8), (8, 4)))

    def block(inp):
        h = torch.relu(collectives.copy_to_tp(inp, None) @ w1)
        # tanh keeps its output, so a recomputation runs to the end
        return torch.tanh(collectives.reduce_from_tp(h @ w2, None))

    errors = []

    def backward(loss):
        try:
            loss.backward()
        except RuntimeError as exc:
            errors.append(exc)

    with collectives.intercepted(hook):
        run = collectives.carrying(block)
        y = (checkpoint(run, x, use_reentrant=False,
                        preserve_rng_state=False) if remat else run(x))
        thread = threading.Thread(target=backward, args=((y * y).sum(),))
        thread.start()
        thread.join()
    assert errors == []
    main = threading.get_ident()
    assert [kind for kind, _ in seen] == ["all_reduce"] * (2 + remat)
    assert seen[0][1] == main and all(t != main for _, t in seen[1:])
    got = [t.grad.clone() for t in (x, w1, w2)]
    for t in (x, w1, w2):
        t.grad = None
    y = torch.tanh(torch.relu(x @ w1) @ w2)
    (y * y).sum().backward()
    for a, t in zip(got, (x, w1, w2)):
        assert torch.equal(a, t.grad)


def test_collective_from_another_thread_raises():
    seen = []

    def hook(kind, x, group):
        seen.append(kind)
        return x

    errors = []

    def other():
        try:
            collectives.all_reduce(torch.ones(3))
        except RuntimeError as exc:
            errors.append(str(exc))

    with collectives.intercepted(hook):
        assert collectives.all_reduce(torch.ones(2)).shape == (2,)
        thread = threading.Thread(target=other)
        thread.start()
        thread.join()
        with pytest.raises(RuntimeError, match="already has a hook"):
            with collectives.intercepted(hook):
                pass
    assert seen == ["all_reduce"]
    assert len(errors) == 1 and "cannot be captured" in errors[0]
