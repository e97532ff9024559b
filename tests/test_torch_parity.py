"""bf16 and mixed box parity of the port against the JAX package, on the
CPU.

A calibrated checkpoint (JAX ``weights.calibrated_raw``), run through
``prepare_params`` and carried across; the port's bf16 and mixed paths
(fused, kernels B1-B4 as their plain versions) against the JAX paths of
the same precision, on a dense and a sparse cloud.  On the CPU the JAX
package's mixed convolutions and VFE products run in full float32 (XLA:CPU
ignores ``Precision.DEFAULT``), while the port's take bf16 inputs, as the
TPU's default precision does: the gate below absorbs that, as it does
between bf16 and fp32.

The gate is the criterion of the JAX package's tools/parity_check.py with
exact top-k (the port's only top-k), on the boxes before NMS: every box of
score >= 0.3 + 0.05 on either side exists among the other side's boxes
(same class, BEV IoU >= 0.5) for >= 0.99 of them both ways, with matched
scores within 0.03 and centres within 0.3 m.  chip_smoke.py applies the
same gate at full width on the card (bf16 with the kernels against fp32).

``eval.parity_ok`` (a one-to-one match of every box >= 0.3, recall and
precision >= 0.95) is not the gate: on seeded random weights the JAX
package misses it between its own bf16 and fp32 paths after NMS, and
every box either side keeps exists on the other side before NMS, which
``test_jax_bf16_misses_parity_ok_after_nms`` measures and checks at the
tiny configuration and the slow ``..._at_default_config`` on the three
frames of ROADMAP queue C1.  ``python tests/test_torch_parity.py`` prints
that match for the port against JAX, the port's bf16 against its fp32, and
JAX's bf16 against its fp32, on three clouds.

The port's own ``calibrated_raw`` equals the JAX one up to the float
rounding of the calibration pass.
"""

import dataclasses
import json

import numpy as np
import pytest

from conftest import make_cloud, tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu.eval import coverage, match_boxes
from dsvt_ai_trt_tpu.model.detector import forward_jit as jax_forward
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.model.detector import forward

MIN_SCORE = 0.3 + 0.05      # tools/parity_check.py: threshold + margin
MIN_COVERAGE = 0.99         # its gate with exact top-k
CLOUDS = {"dense": (77, 1500), "sparse": (78, 400), "mid": (79, 800)}


def _calibrated(cloud):
    cfg = tiny_config()
    seed, n_points = CLOUDS[cloud]
    pts, n = make_cloud(np.random.default_rng(seed), cfg, n_points)
    raw = jax_weights.calibrated_raw(cfg, pts, n, seed=0, n_boxes=12)
    return cfg, pts, n, raw


@pytest.fixture(scope="module")
def calibrated():
    return _calibrated("dense")


def _boxes(dets):
    count = int(np.asarray(dets.count))
    return np.asarray(dets.boxes)[:count]


def _port_and_jax(cfg, pts, n, raw, precision, with_nms):
    c = dataclasses.replace(cfg, precision=precision)
    params = jax_weights.prepare_params(raw, c)
    ref = _boxes(jax_forward(params, pts, n, c, with_nms))
    got = _boxes(forward(weights.from_jax_params(params, "cpu"), pts, n, c,
                         with_nms=with_nms, device="cpu"))
    return got, ref


def _assert_parity(got, ref):
    recall = coverage(ref[ref[:, 8] >= MIN_SCORE], got)
    precision = coverage(got[got[:, 8] >= MIN_SCORE], ref)
    assert recall["n"] >= 10 and precision["n"] >= 10
    assert recall["coverage"] >= MIN_COVERAGE, recall
    assert precision["coverage"] >= MIN_COVERAGE, precision
    assert max(recall["max_score_err"], precision["max_score_err"]) <= 0.03
    assert max(recall["max_center_err"], precision["max_center_err"]) <= 0.3


def test_bf16_boxes_match_jax(calibrated):
    _assert_parity(*_port_and_jax(*calibrated, "bf16", False))


def test_bf16_boxes_match_jax_sparse_cloud():
    _assert_parity(*_port_and_jax(*_calibrated("sparse"), "bf16", False))


@pytest.mark.parametrize("cloud", ["dense", "sparse"])
def test_mixed_boxes_match_jax(calibrated, cloud):
    case = calibrated if cloud == "dense" else _calibrated(cloud)
    _assert_parity(*_port_and_jax(*case, "mixed", False))


def _jax_bf16_vs_fp32_after_nms(cfg, pts, n, raw):
    """JAX bf16 against JAX fp32 after NMS: eval.match_boxes (what
    eval.parity_ok reads), and the gate's coverage of each side's
    confident kept boxes among the other side's boxes before NMS."""
    boxes = {}
    for precision in ("bf16", "fp32"):
        c = dataclasses.replace(cfg, precision=precision)
        params = jax_weights.prepare_params(raw, c)
        for with_nms in (False, True):
            boxes[precision, with_nms] = _boxes(jax_forward(
                params, pts, n, c, with_nms))
    m = match_boxes(boxes["bf16", True], boxes["fp32", True])
    cover = {}
    for side, other in (("fp32", "bf16"), ("bf16", "fp32")):
        kept = boxes[side, True]
        cover[side] = coverage(kept[kept[:, 8] >= MIN_SCORE],
                               boxes[other, False])
    return {"boxes": [m["n_pred"], m["n_ref"]], "recall": m["recall"],
            "precision": m["precision"],
            "parity_ok": bool(m["recall"] >= 0.95
                              and m["precision"] >= 0.95),
            "kept_found_before_nms": {k: [v["covered"], v["n"]]
                                      for k, v in cover.items()},
            "min_coverage": min(v["coverage"] for v in cover.values())}


def test_jax_bf16_misses_parity_ok_after_nms(calibrated):
    """What eval.parity_ok after NMS reads between the reference package's
    own bf16 and fp32 on seeded random weights (dense tiny cloud: recall
    and precision 0.5 on the CPU, printed): every confident box either
    side keeps exists among the other side's boxes before NMS, so what the
    match misses is which member of a cluster greedy NMS keeps, not a box
    one side lost.  The port's bf16 is held by the gate before NMS for
    that reason (ROADMAP queue C1)."""
    res = _jax_bf16_vs_fp32_after_nms(*calibrated)
    print(json.dumps(res))
    assert res["min_coverage"] >= MIN_COVERAGE, res


@pytest.mark.slow
def test_jax_bf16_misses_parity_ok_after_nms_at_default_config():
    """ROADMAP queue C1 at full width: the same measurement and check at
    ``DEFAULT_CONFIG`` on the port's three synthetic frames
    (``bench.synthetic_frames``, the frames of the card's measurement),
    each with a checkpoint calibrated on it at fp32 as ``chip_smoke.py``'s
    parity phase does.  Prints each frame's numbers."""
    from dsvt_ai_trt_tpu.config import DEFAULT_CONFIG
    from dsvt_ai_trt_tpu_torch.bench import synthetic_frames

    cfg = dataclasses.replace(DEFAULT_CONFIG, precision="fp32")
    for name, (pts, n) in synthetic_frames(cfg).items():
        raw = jax_weights.calibrated_raw(cfg, pts, n, seed=0)
        res = _jax_bf16_vs_fp32_after_nms(cfg, pts, n, raw)
        print(json.dumps({"frame": name, **res}), flush=True)
        assert res["min_coverage"] >= MIN_COVERAGE, (name, res)


def test_calibrated_raw_matches_jax(calibrated):
    cfg, pts, n, raw = calibrated
    ours = weights.calibrated_raw(cfg, pts, n, seed=0, n_boxes=12,
                                  device="cpu")
    assert ours.keys() == raw.keys()
    bias = "module.dense_head.heads_list.0.hm.1.bias"
    for k in raw:
        if k == bias:   # the shift comes from the calibration pass's logits
            np.testing.assert_allclose(ours[k], raw[k], atol=1e-4)
        else:
            np.testing.assert_array_equal(ours[k], raw[k], err_msg=k)


def report():
    """One JSON line per cloud, stage (before / after NMS) and pair: the
    gate's coverage and eval.match_boxes recall and precision."""
    for cloud in CLOUDS:
        cfg, pts, n, raw = _calibrated(cloud)
        for with_nms in (False, True):
            p16, j16 = _port_and_jax(cfg, pts, n, raw, "bf16", with_nms)
            p32, j32 = _port_and_jax(cfg, pts, n, raw, "fp32", with_nms)
            for pair, a, b in (("port_bf16_vs_jax_bf16", p16, j16),
                               ("port_bf16_vs_port_fp32", p16, p32),
                               ("jax_bf16_vs_jax_fp32", j16, j32)):
                m = match_boxes(a, b)
                print(json.dumps({
                    "cloud": cloud, "nms": with_nms, "pair": pair,
                    "boxes": [len(a), len(b)],
                    "coverage": [coverage(b[b[:, 8] >= MIN_SCORE], a)[
                        "coverage"], coverage(a[a[:, 8] >= MIN_SCORE], b)[
                        "coverage"]],
                    "match_recall": m["recall"],
                    "match_precision": m["precision"]}))


if __name__ == "__main__":
    report()
