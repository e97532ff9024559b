"""The port's training slice against the JAX package, on the CPU at the tiny
configuration.

* data: ``synthetic_scene``, ``real_background_scene``, ``assign_targets``,
  ``synthetic_batch`` and ``random_targets`` equal JAX's exactly;
* loss: ``focal_loss`` and ``detection_loss`` (on the same head maps) equal
  JAX's at rtol 1e-5, their gradients too; ``batched_loss`` equals JAX
  ``batched_loss(..., remat=False)`` at rtol 1e-5 and its gradients pass
  JAX's own per-leaf gate (tests/test_training.py: max |d| <= max(5e-3 *
  leaf max, 5e-4), convs transposed); ``remat`` changes neither;
* step: one default step equals ``optax.adamw(1e-4)`` (params within
  2 lr + 1e-6, moments under the gradient gate); the loss falls over six
  steps on a fixed batch; ``clip_by_global_norm`` and ``warmup_cosine``
  equal optax's;
* state: train-state files cross between the packages both ways;
  ``unfold_params`` equals JAX's bit for bit and survives the .wts round
  trip; after a step, inference with the in-memory weights equals
  inference on weights rebuilt from the exported .wts (the derived encoder
  weights were refolded), and would not without the refold;
* ``train_run`` runs its chain on the CPU, and its real-frame cadence fires
  for every period.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import data as jax_data
from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.parallel import training as jax_training
from dsvt_ai_trt_tpu_torch import data, train_run, weights
from dsvt_ai_trt_tpu_torch.model.backbone3d import FOLDED_KEYS
from dsvt_ai_trt_tpu_torch.model.detector import forward
from dsvt_ai_trt_tpu_torch.parallel import training
from dsvt_ai_trt_tpu_torch.parallel.training import (
    Targets, batched_loss, load_train_state, make_train_step,
    save_train_state)

SCENE = dict(n_objects=2, n_ground=200, pts_per_obj=30)
LR = 1e-4


def _jax_keys(tree):
    """{keystr: array} of a JAX pytree."""
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _gate(path, got, ref):
    """JAX's per-leaf gradient gate (tests/test_training.py)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.abs(got - ref).max()
    tol = max(5e-3 * np.abs(ref).max(), 5e-4)
    assert d <= tol, f"{path}: |d| {d:.2e} > {tol:.2e}"


def _grads(tparams):
    """{keystr: gradient as the JAX tree holds it (convs HWIO)}."""
    return {weights.keystr(p): weights.to_numpy_leaf(p, t.grad)
            for p, t in weights.named_leaves(tparams)}


@pytest.fixture(scope="module")
def case():
    """One batch of two planted scenes, JAX's loss, gradients and one
    optax.adamw(1e-4) update, and the port's default step on the same
    weights and scenes (its gradients stay on the leaves).

    The seeds give a batch on which no ReLU input lies within the two
    frameworks' float32 rounding of zero: such an input can take the other
    branch in one of them, which moves one output channel of the layer
    before it by up to twice the gate (seen for weight seeds 1 and 2 here).
    """
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, seed=3)
    pts, ns, tg = jax_data.synthetic_batch(np.random.default_rng(3), cfg, 2,
                                           **SCENE)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jax_training.batched_loss(p, pts, ns, tg, cfg,
                                            remat=False)))(params)
    opt = optax.adamw(LR)
    opt_state = opt.init(params)
    updates, opt_state = opt.update(grads, opt_state, params)
    stepped = optax.apply_updates(params, updates)

    tparams = weights.from_jax_params(params, "cpu")
    batch = data.synthetic_batch(np.random.default_rng(3), cfg, 2,
                                 device="cpu", **SCENE)
    optimizer, step = make_train_step(cfg, tparams, device="cpu")
    port_loss = float(step(*batch))
    return {"cfg": cfg, "params": params, "batch": batch,
            "jax_loss": float(loss), "jax_grads": _jax_keys(grads),
            "jax_stepped": stepped, "jax_opt_state": opt_state,
            "port_loss": port_loss, "tparams": tparams,
            "optimizer": optimizer}


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_scenes_and_targets_equal_jax(seed):
    cfg = tiny_config()
    a = data.synthetic_scene(np.random.default_rng(seed), cfg, **SCENE)
    b = jax_data.synthetic_scene(np.random.default_rng(seed), cfg, **SCENE)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    for dense in (True, False):
        for x, y in zip(data.assign_targets(a[2], cfg, dense_reg=dense),
                        jax_data.assign_targets(b[2], cfg, dense_reg=dense)):
            np.testing.assert_array_equal(x, y)
    base = make_cloud(np.random.default_rng(seed), cfg, 300)[0][:300]
    for x, y in zip(
            data.real_background_scene(np.random.default_rng(seed), cfg, base),
            jax_data.real_background_scene(np.random.default_rng(seed), cfg,
                                           base)):
        np.testing.assert_array_equal(x, y)
    pts, ns, tg = data.synthetic_batch(np.random.default_rng(seed), cfg, 2,
                                       device="cpu", **SCENE)
    jpts, jns, jtg = jax_data.synthetic_batch(np.random.default_rng(seed),
                                              cfg, 2, **SCENE)
    assert pts.dtype == torch.float32 and pts.device.type == "cpu"
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(ns.numpy(), np.asarray(jns))
    for x, y in zip(tg, jtg):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


def test_random_targets_equal_jax():
    cfg = tiny_config()
    got = training.random_targets(np.random.default_rng(5), cfg, 2, "cpu")
    ref = jax_training.random_targets(np.random.default_rng(5), cfg, 2)
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def _head_maps(rng, cfg):
    """Random full-head maps [H, W, c], rot vectors of every length (some
    exactly at the direction term's |v| = 1 and the clip's saturation)."""
    H, W = cfg.grid_size[1], cfg.grid_size[0]
    out = {name: rng.normal(0, 1.0, (H, W, c)).astype(np.float32)
           for name, c in (("hm", cfg.num_classes), ("center", 2),
                           ("center_z", 1), ("dim", 3), ("rot", 2),
                           ("iou", 1))}
    out["hm"][0, 0] = 40.0                      # sigmoid saturates
    out["rot"][1, 1] = (0.6, 0.8)               # |v| == 1
    return out


def test_relu_and_floor_split_the_gradient_at_ties_as_jax():
    from dsvt_ai_trt_tpu_torch.ops.common import relu
    x = np.array([0.0, -1.0, 2.0, 1.0], np.float32)
    for fn, ref in ((relu, lambda v: jnp.maximum(v, 0.0)),
                    (lambda v: training._at_least(v, 1.0),
                     lambda v: jnp.maximum(v, 1.0))):
        t = torch.tensor(x, requires_grad=True)
        fn(t).sum().backward()
        want = jax.grad(lambda v: ref(v).sum())(jnp.asarray(x))
        np.testing.assert_array_equal(t.grad.numpy(), np.asarray(want))


def test_focal_loss_equals_jax():
    cfg = tiny_config()
    rng = np.random.default_rng(11)
    maps = _head_maps(rng, cfg)
    target = data.assign_targets(
        data.synthetic_scene(rng, cfg, **SCENE)[2], cfg)[0]
    x = torch.tensor(maps["hm"], requires_grad=True)
    loss = training.focal_loss(x, torch.from_numpy(target))
    loss.backward()
    ref, ref_grad = jax.value_and_grad(jax_training.focal_loss)(
        jnp.asarray(maps["hm"]), jnp.asarray(target))
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(ref_grad),
                               rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("dir_weight,aux_weight", [(0.25, 0.25), (1.0, 0.0)])
def test_detection_loss_equals_jax(monkeypatch, dir_weight, aux_weight):
    """Both packages' detection_loss on the same head maps (their forward
    passes stubbed to return them): value and gradients at rtol 1e-5."""
    cfg = tiny_config()
    rng = np.random.default_rng(12)
    maps = _head_maps(rng, cfg)
    gt = data.synthetic_scene(rng, cfg, **SCENE)[2]
    tgt = data.assign_targets(gt, cfg)

    class Out:
        def __init__(self, head_out):
            self.head_out = head_out

    leaves = {k: torch.tensor(v, requires_grad=True) for k, v in maps.items()}
    monkeypatch.setattr(training, "forward_train",
                        lambda *a, **k: Out(leaves))
    loss = training.detection_loss(
        None, None, None, Targets(*(torch.from_numpy(t) for t in tgt)), cfg,
        dir_weight, aux_weight, device="cpu")
    loss.backward()

    def jax_loss(head_out):
        monkeypatch.setattr(jax_training, "forward_debug",
                            lambda *a, **k: Out(head_out))
        return jax_training.detection_loss(
            None, None, None, jax_training.Targets(*map(jnp.asarray, tgt)),
            cfg, dir_weight, aux_weight)

    ref, ref_grads = jax.value_and_grad(jax_loss)(
        {k: jnp.asarray(v) for k, v in maps.items()})
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for k, g in ref_grads.items():
        got = (leaves[k].grad.numpy() if leaves[k].grad is not None
               else np.zeros_like(maps[k]))
        np.testing.assert_allclose(got, np.asarray(g), rtol=1e-5, atol=1e-8,
                                   err_msg=k)


def test_batched_loss_and_grads_match_jax(case):
    np.testing.assert_allclose(case["port_loss"], case["jax_loss"], rtol=1e-5)
    got = _grads(case["tparams"])
    assert got.keys() == case["jax_grads"].keys()
    for k, ref in case["jax_grads"].items():
        _gate(k, got[k], ref)


def test_remat_gives_the_same_loss_and_grads():
    cfg = tiny_config()
    tparams = weights.from_jax_params(jax_weights.random_params(cfg, 3),
                                      "cpu")
    for t in weights.trainable(tparams):
        t.requires_grad_(True)
    batch = data.synthetic_batch(np.random.default_rng(3), cfg, 2,
                                 device="cpu", **SCENE)
    out = []
    for remat in (False, True):
        loss = batched_loss(tparams, *batch, cfg, remat=remat, device="cpu")
        grads = torch.autograd.grad(loss, weights.trainable(tparams),
                                    allow_unused=True)
        out.append((loss.item(), grads))
    (l0, g0), (l1, g1) = out
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for (path, t), a, b in zip(weights.named_leaves(tparams), g0, g1):
        assert (a is None) == (b is None), path
        if a is not None:
            _gate(weights.keystr(path), b.numpy(), a.numpy())


# ---------------------------------------------------------------------------
# the optimizer step
# ---------------------------------------------------------------------------


def test_one_step_matches_optax_adamw(case):
    """First-step Adam is about lr * sign(g), so a gradient near zero may
    take the other sign in the other package: params within 2 lr + 1e-6."""
    ref = _jax_keys(case["jax_stepped"])
    adam = case["jax_opt_state"][0]
    mu, nu = _jax_keys(adam.mu), _jax_keys(adam.nu)
    opt = case["optimizer"]
    for path, t in weights.named_leaves(case["tparams"]):
        k = weights.keystr(path)
        np.testing.assert_allclose(weights.to_numpy_leaf(path, t), ref[k],
                                   rtol=0, atol=2 * LR + 1e-6, err_msg=k)
        state = opt.state[t]
        assert int(state["step"]) == int(adam.count) == 1
        _gate(k, weights.to_numpy_leaf(path, state["exp_avg"]), mu[k])
        _gate(k, weights.to_numpy_leaf(path, state["exp_avg_sq"]), nu[k])


def test_loss_falls_over_six_steps():
    cfg = tiny_config()
    tparams = weights.from_jax_params(jax_weights.random_params(cfg, 0),
                                      "cpu")
    _, step = make_train_step(cfg, tparams, device="cpu")
    batch = data.synthetic_batch(np.random.default_rng(0), cfg, 2,
                                 device="cpu", n_objects=3, n_ground=400,
                                 pts_per_obj=40)
    losses = [float(step(*batch)) for _ in range(6)]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_clip_and_schedule_match_optax():
    rng = np.random.default_rng(2)
    for scale in (0.1, 10.0):          # under and over the max norm
        grads = [rng.normal(0, scale, s).astype(np.float32)
                 for s in ((3, 4), (5,))]
        clip = optax.clip_by_global_norm(1.0)
        ref, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(grads))
        got = [torch.from_numpy(g.copy()) for g in grads]
        training.clip_by_global_norm(got, 1.0)
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    sched = training.warmup_cosine(3e-4, 5, 20)
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 5, 20)
    for count in range(25):
        np.testing.assert_allclose(sched(count), float(ref(count)),
                                   rtol=1e-5, atol=1e-12)
    assert sched(0) == 0.0              # update 0 runs at lr 0


# ---------------------------------------------------------------------------
# weights and train state
# ---------------------------------------------------------------------------


def test_trainable_leaves_are_the_jax_tree():
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, 1)
    tparams = weights.from_jax_params(params, "cpu")
    paths = [weights.keystr(p) for p, _ in weights.named_leaves(tparams)]
    assert paths == list(_jax_keys(params))       # same leaves, same order
    enc = tparams["blocks"][0]["enc"][0]
    assert set(FOLDED_KEYS) <= set(enc)
    assert not set(FOLDED_KEYS) & {p[-1] for p, _ in
                                   weights.named_leaves(tparams)}
    back = weights.to_jax_params(tparams)
    ref = _jax_keys(params)
    for k, v in _jax_keys(back).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)
    # carrying copies: updating a tensor leaves the NumPy dict alone
    with torch.no_grad():
        enc["wq"].add_(1.0)
    np.testing.assert_array_equal(params["blocks"][0]["enc"][0]["wq"],
                                  back["blocks"][0]["enc"][0]["wq"])
    # refold remakes the derived weights from the leaves
    weights.refold(tparams)
    C = cfg.d_model
    torch.testing.assert_close(enc["w_qkv"][:, :C], enc["wq"], rtol=0, atol=0)
    torch.testing.assert_close(enc["w_qkv_bf16"][:, :C], enc["wq"].bfloat16(),
                               rtol=0, atol=0)


def test_train_state_jax_to_port(case, tmp_path):
    cfg = case["cfg"]
    path = jax_training.save_train_state(str(tmp_path / "jax_state"),
                                         case["jax_stepped"],
                                         case["jax_opt_state"], step=7)
    tparams = weights.from_jax_params(jax_weights.random_params(cfg, 0),
                                      "cpu")
    optimizer, _ = make_train_step(cfg, tparams, device="cpu")
    assert load_train_state(path, tparams, optimizer) == 7
    ref = _jax_keys(case["jax_stepped"])
    adam = case["jax_opt_state"][0]
    mu, nu = _jax_keys(adam.mu), _jax_keys(adam.nu)
    for p, t in weights.named_leaves(tparams):
        k = weights.keystr(p)
        np.testing.assert_array_equal(weights.to_numpy_leaf(p, t), ref[k])
        state = optimizer.state[t]
        assert int(state["step"]) == 1
        np.testing.assert_array_equal(
            weights.to_numpy_leaf(p, state["exp_avg"]), mu[k])
        np.testing.assert_array_equal(
            weights.to_numpy_leaf(p, state["exp_avg_sq"]), nu[k])
    enc, mlp = tparams["blocks"][1]["enc"][1], tparams["posembed"][1][1]
    torch.testing.assert_close(enc["w_pos"][:, :cfg.d_model],
                               mlp["w2"] @ enc["wq"])


def test_train_state_port_to_jax(case, tmp_path):
    cfg = case["cfg"]
    path = save_train_state(str(tmp_path / "port_state"), case["tparams"],
                            case["optimizer"], step=3)
    assert path.endswith(".npz")
    assert list(np.load(path).files)[-1] == "step"
    template = jax_weights.random_params(cfg, 0)
    p, o, step = jax_training.load_train_state(
        path, template, optax.adamw(LR).init(template))
    assert step == 3 and int(o[0].count) == 1
    got_p, mu, nu = _jax_keys(p), _jax_keys(o[0].mu), _jax_keys(o[0].nu)
    opt = case["optimizer"]
    for path_, t in weights.named_leaves(case["tparams"]):
        k = weights.keystr(path_)
        np.testing.assert_array_equal(got_p[k],
                                      weights.to_numpy_leaf(path_, t))
        np.testing.assert_array_equal(
            mu[k], weights.to_numpy_leaf(path_, opt.state[t]["exp_avg"]))
        np.testing.assert_array_equal(
            nu[k], weights.to_numpy_leaf(path_, opt.state[t]["exp_avg_sq"]))


def test_unfold_params_bit_exact_and_wts_round_trip(tmp_path):
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, 2)
    raw = weights.unfold_params(weights.from_jax_params(params, "cpu"), cfg)
    ref = jax_weights.unfold_params(params, cfg)
    assert list(raw) == list(ref)
    for k in ref:
        assert raw[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(raw[k], ref[k], err_msg=k)
    path = str(tmp_path / "t.wts")
    weights.save_wts(raw, path)
    back = weights.load_wts(path)
    for k in raw:
        np.testing.assert_array_equal(back[k].ravel(), raw[k].ravel(),
                                      err_msg=k)
    # the identity BN re-encoding folds back to the same weights exactly
    for k, v in _jax_keys(weights.prepare_params(back, cfg)).items():
        np.testing.assert_array_equal(v, _jax_keys(params)[k], err_msg=k)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_trained_weights_reach_inference(tmp_path, precision):
    """After one step, forward with the weights in memory equals forward on
    weights rebuilt from the exported .wts; with the folds of before the
    step (no refold) it would not."""
    cfg = tiny_config()
    tparams = weights.from_jax_params(jax_weights.random_params(cfg, 4),
                                      "cpu")
    # copies: refold writes the derived weights in place
    before = [[{k: enc[k].clone() for k in FOLDED_KEYS}
               for enc in block["enc"]] for block in tparams["blocks"]]
    _, step = make_train_step(cfg, tparams, device="cpu")
    step(*data.synthetic_batch(np.random.default_rng(4), cfg, 1,
                               device="cpu", **SCENE))
    path = str(tmp_path / "trained.wts")
    weights.save_wts(weights.unfold_params(tparams, cfg), path)
    rebuilt = weights.from_jax_params(
        weights.prepare_params(weights.load_wts(path), cfg), "cpu")
    stale = {**tparams, "blocks": [
        {**block, "enc": [{**enc, **old} for enc, old in zip(block["enc"],
                                                             olds)]}
        for block, olds in zip(tparams["blocks"], before)]}

    # every top-k box is compared: one step leaves the tiny model's scores
    # under the default 0.3
    run_cfg = dataclasses.replace(cfg, precision=precision,
                                  score_threshold=0.0)
    pts, n = make_cloud(np.random.default_rng(1234), cfg, 1500)

    def boxes(p):
        dets = forward(p, pts, n, run_cfg, with_nms=True, device="cpu")
        return dets.boxes[: int(dets.count)].numpy()

    got, want = boxes(tparams), boxes(rebuilt)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    old = boxes(stale)
    assert old.shape != want.shape or np.abs(old - want).max() > 1e-5


def test_training_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    rng = np.random.default_rng(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        data.synthetic_batch(rng, cfg, 1, **SCENE)
    tparams = weights.from_jax_params(jax_weights.random_params(cfg, 0),
                                      "cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_step(cfg, tparams)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_run.main(["--steps", "0"])


# ---------------------------------------------------------------------------
# train_run
# ---------------------------------------------------------------------------


def test_real_step_cadence():
    for every in (1, 2, 3, 4, 7):
        fired = [s for s in range(4 * every) if train_run.is_real_step(s, every)]
        assert fired == [every - 1 + i * every for i in range(4)], every
    assert not any(train_run.is_real_step(s, 0) for s in range(8))


def test_train_run_chain_on_cpu(tmp_path):
    cfg = tiny_config()
    (tmp_path / "tiny.json").write_text(cfg.to_json())
    real = tmp_path / "real"
    real.mkdir()
    pts, n = make_cloud(np.random.default_rng(5), cfg, 400)
    pts[:n].tofile(real / "000000.bin")
    out = tmp_path / "run.json"
    res = train_run.main(["--device", "cpu", "--config",
                          str(tmp_path / "tiny.json"), "--steps", "3",
                          "--eval-scenes", "1", "--data", str(real),
                          "--real-every", "2", "--log-every", "1",
                          "--out", str(out), "--wts", str(tmp_path / "t.wts")])
    assert res["real_batches"] == 1                 # step 1 of 0..2
    assert [r["step"] for r in res["loss_curve"]] == [0, 1, 2]
    assert np.isfinite([r["loss"] for r in res["loss_curve"]]).all()
    assert res["wts_roundtrip"]["matches_trained"]
    assert res["device"] == "cpu" and res["train_seconds"] > 0
    assert json.loads(out.read_text())["eval"]["n_gt"] == res["eval"]["n_gt"]
