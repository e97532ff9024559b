"""What the port's compiled training step and scan graph need, checked on
the CPU at the tiny configuration (the captures themselves run on the card:
``chip_smoke.py``'s training and graph phases).

* sync guard (``runtime.compile.SyncGuard``) around a whole step
  of ``CompiledTrainStep`` (on the CPU its eager step): remat on and off,
  and with the global-norm clip.  No plain version is exempt: training runs
  the plain paths on the card too.  The guard does see torch's own AdamW,
  which reads each leaf's step count on the host;
* the tensor-op ``AdamW`` with its learning rate computed from the update
  count by ``warmup_cosine`` equals ``optax.adamw`` under optax's warmup
  cosine schedule over eight steps of given gradients (params atol 1e-7 +
  rtol 1e-6, moments rtol 1e-5), and the schedule's tensor form equals
  optax's at rtol 1e-5;
* ``CompiledTrainStep`` on the CPU equals ``make_train_step``'s eager step
  bit for bit; ``load_train_state`` writes into the addresses the step
  holds and a resumed step equals the eager path's bit for bit; a step
  draws no random number and leaves the RNG state as it was; a dp mesh and
  an mp > 1 mesh are taken (on the CPU the mp step equals the eager
  one); ``refold`` keeps the derived weights' addresses;
* the scan engine (``Engine(..., batch=B)``) on the CPU equals the JAX
  package's jitted ``forward_scan`` frame for frame (counts and occupancy
  exact, boxes 1e-4), and the guard finds nothing around ``forward_batch``
  (kernels' plain versions exempt, as for ``forward``: the card runs the
  kernels there).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import make_cloud, tiny_config
from test_golden import _assert_boxes

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu_torch import data, weights
from dsvt_ai_trt_tpu_torch.model.detector import forward_batch
from dsvt_ai_trt_tpu_torch.parallel.mesh import Mesh
from dsvt_ai_trt_tpu_torch.parallel.training import (
    AdamW, CompiledTrainStep, load_train_state, make_train_step,
    save_train_state, warmup_cosine)
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine, SyncGuard

SCENE = dict(n_objects=2, n_ground=200, pts_per_obj=30)


def _params(seed=0):
    return weights.from_jax_params(
        jax_weights.random_params(tiny_config(), seed), "cpu")


def _batch(seed=3, batch=2):
    return data.synthetic_batch(np.random.default_rng(seed), tiny_config(),
                                batch, device="cpu", **SCENE)


def _state(params, optimizer):
    """Every tensor a step reads or writes: leaves, moments, the count and
    the derived encoder weights."""
    out = [t for _, t in weights.named_leaves(params)]
    for t in list(out):
        st = optimizer.state[t]
        out += [st["exp_avg"], st["exp_avg_sq"]]
    out.append(optimizer.count)
    out += [enc[k] for block in params["blocks"] for enc in block["enc"]
            for k in sorted(enc) if k.startswith(("w_qkv", "w_pos", "b_qkv",
                                                  "ln_stack"))]
    return out


@pytest.mark.parametrize("remat,max_grad_norm", [
    (True, None), (False, None), (True, 10.0)],
    ids=["remat", "no_remat", "remat_clip"])
def test_compiled_step_reads_nothing_back(remat, max_grad_norm):
    step = CompiledTrainStep(tiny_config(), _params(), 2, remat=remat,
                             max_grad_norm=max_grad_norm, device="cpu")
    batch = _batch()
    guard = SyncGuard()
    with guard:
        loss = step(*batch)
    assert guard.hits == []
    assert np.isfinite(float(loss))
    assert int(step.optimizer.count) == 1


def test_guard_finds_torch_adamw_host_reads():
    """torch's AdamW (not capturable) reads each leaf's step on the host:
    the reads the tensor-op AdamW removes."""
    leaves = [torch.ones(3, requires_grad=True), torch.ones(2, 2,
                                                            requires_grad=True)]
    opt = torch.optim.AdamW(leaves, lr=1e-3)
    for t in leaves:
        t.grad = torch.full_like(t, 0.5)
    guard = SyncGuard()
    with guard:
        opt.step()
    assert any("_local_scalar_dense" in h for h in guard.hits)


def test_adamw_with_device_schedule_equals_optax():
    rng = np.random.default_rng(5)
    shapes = [(4, 3), (7,), (2, 3, 3)]
    init = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = [[rng.normal(0, 10.0 ** -k, s).astype(np.float32)
              for k, s in enumerate(shapes)] for _ in range(8)]
    lr, warm, decay = 3e-4, 3, 8
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, lr, warm, decay),
                      b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    ref = [jnp.asarray(a) for a in init]
    ref_state = opt.init(ref)
    leaves = [torch.tensor(a, requires_grad=True) for a in init]
    adamw = AdamW(leaves, lr=lr, schedule=warmup_cosine(lr, warm, decay))
    guard = SyncGuard()
    for g in grads:
        updates, ref_state = opt.update([jnp.asarray(x) for x in g],
                                        ref_state, ref)
        ref = optax.apply_updates(ref, updates)
        for t, x in zip(leaves, g):
            t.grad = torch.from_numpy(x)
        with guard:
            adamw.step()
    assert guard.hits == []
    adam = ref_state[0]
    assert int(adamw.count) == int(adam.count) == 8
    for t, r, m, v in zip(leaves, ref, adam.mu, adam.nu):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(r),
                                   rtol=1e-6, atol=1e-7)
        st = adamw.state[t]
        assert st["step"] is adamw.count
        np.testing.assert_allclose(st["exp_avg"].numpy(), np.asarray(m),
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-12)
    sched = warmup_cosine(lr, warm, decay)
    ref_sched = optax.warmup_cosine_decay_schedule(0.0, lr, warm, decay)
    for count in range(decay + 3):
        got = sched(torch.tensor(float(count)))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(ref_sched(count)),
                                   rtol=1e-5, atol=1e-12)
    flat = warmup_cosine(lr, 0, 0)             # no warm-up, no decay
    assert float(flat(torch.tensor(4.0))) == pytest.approx(lr, rel=1e-6)


def test_cpu_compiled_step_equals_eager():
    cfg = tiny_config()
    a, b = _params(), _params()
    compiled = CompiledTrainStep(cfg, a, 2, max_grad_norm=10.0, device="cpu")
    opt_b, eager = make_train_step(cfg, b, max_grad_norm=10.0, device="cpu")
    batch = _batch()
    for _ in range(2):
        assert torch.equal(compiled(*batch), eager(*batch))
    for x, y in zip(_state(a, compiled.optimizer), _state(b, opt_b)):
        assert torch.equal(x, y)
    assert compiled.replays == 0 and compiled.graph_launches == {}


def test_resume_into_compiled_step_equals_eager(tmp_path):
    """A checkpoint loaded into the compiled step's state keeps every
    address the step holds, and the next step equals the eager path's."""
    cfg = tiny_config()
    trained = _params()
    opt, step = make_train_step(cfg, trained, device="cpu")
    step(*_batch(seed=3))
    path = save_train_state(str(tmp_path / "state"), trained, opt, step=1)

    compiled = CompiledTrainStep(cfg, _params(seed=1), 2, device="cpu")
    held = _state(compiled.params, compiled.optimizer)
    addresses = [t.data_ptr() for t in held]
    assert load_train_state(path, compiled.params, compiled.optimizer) == 1
    assert [t.data_ptr() for t in held] == addresses
    assert int(compiled.optimizer.count) == 1
    resumed = _params(seed=2)
    opt_r, eager = make_train_step(cfg, resumed, device="cpu")
    load_train_state(path, resumed, opt_r)

    batch = _batch(seed=4)
    assert torch.equal(compiled(*batch), eager(*batch))
    for x, y in zip(held, _state(resumed, opt_r)):
        assert torch.equal(x, y)
    assert int(compiled.optimizer.count) == 2


class _RandomOps(TorchDispatchMode):
    """Records every op that draws random numbers."""

    def __init__(self):
        super().__init__()
        self.hits = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if any(w in name for w in ("rand", "bernoulli", "normal", "uniform",
                                   "dropout", "multinomial")):
            self.hits.append(name)
        return func(*args, **(kwargs or {}))


def test_step_leaves_the_rng_state_unchanged():
    step = CompiledTrainStep(tiny_config(), _params(), 2, remat=True,
                             device="cpu")
    batch = _batch()
    torch.manual_seed(123)
    before = torch.get_rng_state()
    mode = _RandomOps()
    with mode:
        step(*batch)
    assert mode.hits == []
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("dp,mp", [(2, 1), (1, 2)])
def test_compiled_step_refuses_a_mesh(dp, mp):
    """A dp mesh (mp = 1) and an mp > 1 mesh are both taken (the card
    captures them in segments); on the CPU the mp step equals
    ``make_train_step``'s under the same mesh bit for bit.  This process
    has no group, so the mesh's groups are None: the sharded step itself
    runs in tests/test_torch_parallel.py's world of 4."""
    mesh = Mesh(dp, mp, 0, 0)
    step = CompiledTrainStep(tiny_config(), _params(), 2, device="cpu",
                             mesh=mesh)
    assert step.mesh is mesh
    if mp > 1:
        ref = _params()
        opt, eager = make_train_step(tiny_config(), ref, device="cpu",
                                     mesh=mesh)
        batch = _batch()
        assert torch.equal(step(*batch), eager(*batch))
        for a, b in zip(_state(step.params, step.optimizer),
                        _state(ref, opt)):
            assert torch.equal(a, b)


def test_refold_keeps_the_derived_weights_addresses():
    params = _params()
    enc = params["blocks"][0]["enc"][0]
    w_qkv, ptr = enc["w_qkv"], enc["w_qkv"].data_ptr()
    with torch.no_grad():
        enc["wq"].add_(1.0)
    weights.refold(params)
    assert enc["w_qkv"] is w_qkv and w_qkv.data_ptr() == ptr
    C = tiny_config().d_model
    torch.testing.assert_close(w_qkv[:, :C], enc["wq"], rtol=0, atol=0)


def _frames(cfg, sizes=(1500, 300, 900)):
    out = [make_cloud(np.random.default_rng(100 + i), cfg, n)
           for i, n in enumerate(sizes)]
    return (torch.from_numpy(np.stack([p for p, _ in out])),
            torch.tensor([int(n) for _, n in out], dtype=torch.int32))


@pytest.mark.parametrize("with_nms", [True, False])
def test_scan_engine_on_cpu_equals_forward_batch(with_nms):
    """The port's scan group (``Engine(..., batch=3)``, on the CPU its
    ``forward_batch``) against the JAX package's jitted ``forward_scan``
    on the same frames: counts and occupancy equal, boxes within the
    golden's 1e-4."""
    import jax
    from dsvt_ai_trt_tpu.model.detector import forward_scan
    cfg = tiny_config()
    jax_params = jax_weights.random_params(cfg, 0)
    points, nums = _frames(cfg)
    scan = Engine(weights.from_jax_params(jax_params, "cpu"), cfg,
                  device="cpu", with_nms=with_nms, batch=len(nums)).warmup()
    got = scan(points, [int(n) for n in nums])
    ref = jax.jit(lambda p, n: forward_scan(jax_params, p, n, cfg,
                                            with_nms))(points.numpy(),
                                                       nums.numpy())
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    for i in range(len(nums)):
        k = int(got.count[i])
        _assert_boxes(got.boxes[i, :k].numpy(), np.asarray(ref.boxes[i, :k]))
    assert int(got.count[0]) > 0


@pytest.mark.parametrize("with_nms", [True, False])
def test_forward_batch_reads_nothing_back(with_nms):
    cfg = tiny_config()
    params = _params()
    points, nums = _frames(cfg)
    guard = SyncGuard()
    with guard.plain_versions_exempt(), guard:
        dets = forward_batch(params, points, nums, cfg, with_nms,
                             device="cpu")
    assert guard.hits == []
    assert tuple(dets.boxes.shape[:1]) == (len(nums),)
