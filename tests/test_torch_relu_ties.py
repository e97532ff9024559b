"""Why the cross-framework gradient gate misses at some seeds: ReLU inputs
that lie within float32 rounding of zero take the other branch in one
framework.

``tests/test_torch_training.py`` holds the port's ``batched_loss``
gradients to the JAX package's under JAX's per-leaf gate, at weight and
batch seeds 3/3.  At seeds 1/1 and 2/2 the gate misses (1.0x and 1.6x on
the CPU).  Neither package can run in float64 without changing more than
its input casts (both cast to float32 inside their layers), so this test
records instead, for those seeds, every ReLU input of the loss's forward
pass whose sign differs between the two packages: its value on each side,
and its distance from 0 in float32 ulps at the scale of its layer (the
spacing of the largest |input| of that ReLU call, the rounding one
product-sum of that layer carries).  Every such input is within a few
ulps of zero on both sides, so which branch it takes is rounding, not a
port fault; away from those inputs both packages' ReLU inputs agree to
float32 rounding.  The flips are printed, not counted: how many there are
depends on the libraries' rounding, and none would be no fault either.

The JAX side's ReLU inputs are read with ``jax.debug.callback`` from a
``jnp.maximum(x, 0.0)`` wrapper installed while the loss is traced; the
port's by wrapping ``ops.common.relu`` in its model modules.
"""

import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import tiny_config

from dsvt_ai_trt_tpu import data as jax_data
from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.parallel import training as jax_training
from dsvt_ai_trt_tpu_torch import data, weights
from dsvt_ai_trt_tpu_torch.model import backbone2d, backbone3d, head, vfe
from dsvt_ai_trt_tpu_torch.ops import common
from dsvt_ai_trt_tpu_torch.parallel.training import batched_loss

SCENE = dict(n_objects=2, n_ground=200, pts_per_obj=30)   # the gate's batch
MAX_ULPS = 4.0


def _jax_relu_inputs(monkeypatch, params, pts, ns, tg, cfg):
    """[(call site, input as a NumPy array)] of every ReLU of JAX's
    batched_loss forward (vmapped frames: one record per frame, in no
    fixed order)."""
    recs = []
    plain = jnp.maximum

    def maximum(x, y, *a, **k):
        if isinstance(y, float) and y == 0.0:
            caller = inspect.stack()[1]
            site = f"{os.path.basename(caller.filename)}:{caller.lineno}"
            jax.debug.callback(lambda v, s=site: recs.append((s, np.array(v))),
                               x)
        return plain(x, y, *a, **k)

    monkeypatch.setattr(jnp, "maximum", maximum)
    jax.block_until_ready(jax.jit(lambda p: jax_training.batched_loss(
        p, pts, ns, tg, cfg, remat=False))(params))
    monkeypatch.setattr(jnp, "maximum", plain)
    return recs


def _port_relu_inputs(monkeypatch, params, batch, cfg):
    """[(call site, input in [H, W, C] or [rows, C])] of every ReLU of the
    port's batched_loss forward, frame by frame."""
    recs = []
    plain = common.relu

    def relu(x):
        caller = inspect.stack()[1]
        v = x.detach().numpy()
        recs.append((f"{os.path.basename(caller.filename)}:{caller.lineno}",
                     v[0].transpose(1, 2, 0) if v.ndim == 4 else v.copy()))
        return plain(x)

    for module in (vfe, backbone3d, backbone2d, head):
        monkeypatch.setattr(module, "relu", relu)
    batched_loss(weights.from_jax_params(params, "cpu"), *batch, cfg,
                 remat=False, device="cpu")
    return recs


def _sign_flips(monkeypatch, seed):
    """Pair each JAX ReLU call with the port's of the same shape whose
    inputs are nearest, and list the inputs whose signs differ."""
    cfg = tiny_config()
    params = jax_weights.random_params(cfg, seed=seed)
    pts, ns, tg = jax_data.synthetic_batch(np.random.default_rng(seed), cfg,
                                           2, **SCENE)
    ours = _port_relu_inputs(monkeypatch, params, data.synthetic_batch(
        np.random.default_rng(seed), cfg, 2, device="cpu", **SCENE), cfg)
    theirs = _jax_relu_inputs(monkeypatch, params, pts, ns, tg, cfg)
    assert len(ours) == len(theirs)
    free = list(range(len(ours)))
    flips = []
    for site, ref in theirs:
        dist = [np.abs(ours[i][1] - ref).max() if ours[i][1].shape == ref.shape
                else np.inf for i in free]
        i = free.pop(int(np.argmin(dist)))
        got = ours[i][1]
        spacing = float(np.spacing(np.float32(np.abs(ref).max())))
        # both packages' inputs agree to float32 rounding at this scale
        assert np.abs(got - ref).max() <= 256 * spacing, (site, ours[i][0])
        for idx in zip(*np.nonzero((got > 0) != (ref > 0))):
            flips.append({"jax_site": site, "port_site": ours[i][0],
                          "index": tuple(int(j) for j in idx),
                          "jax": float(ref[idx]), "port": float(got[idx]),
                          "ulps_jax": abs(float(ref[idx])) / spacing,
                          "ulps_port": abs(float(got[idx])) / spacing})
    return flips


@pytest.mark.parametrize("seed", [1, 2])
def test_relu_inputs_that_flip_lie_within_rounding_of_zero(monkeypatch,
                                                           seed):
    flips = _sign_flips(monkeypatch, seed)
    print({"seed": seed, "flips": flips})   # ROADMAP C2 records them
    for f in flips:
        assert f["ulps_jax"] <= MAX_ULPS and f["ulps_port"] <= MAX_ULPS, f
