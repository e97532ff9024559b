"""Upstream DSVT's nuScenes head, TransFusion-L, at a tiny configuration on
the CPU, against the plain reference (``benchmark/reference/
transfusion.py``) on its seeded weights:

* the head's maps (L, the heatmap), its proposals, its decoded boxes and
  ``forward``'s served boxes equal the reference's at fp32 to 1e-4;
* the proposals' exact top on tied scores takes the lower flat index;
  the local max leaves the free classes unsuppressed and the border of the
  others at 0;
* ``query_attention``'s plain version is ``nn.MultiheadAttention``'s
  cross-attention over the materialised keys and values (the reference's,
  written out);
* the configuration's JSON round-trips, ``validate`` holds the head's
  widths, a CenterHead stamp (``dsvt-nuscenes``) carries none of the
  head's keys, and the port's checkpoint names are the reference's;
* the forward reads nothing back to the host (a CUDA graph can hold it),
  marks ``query`` inside ``head`` and counts ``proposals`` and
  ``query_boxes`` while the tracer is on, and refuses sharding and
  training.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.reference import detector as ref_detector  # noqa: E402
from benchmark.reference import transfusion as ref         # noqa: E402
from benchmark.traffic import sweeps                      # noqa: E402
from dsvt_ai_trt_tpu_torch import weights                 # noqa: E402
from dsvt_ai_trt_tpu_torch.config import (  # noqa: E402
    DEFAULT_CONFIG, QUERY_KEYS, DSVTConfig, query_head)
from dsvt_ai_trt_tpu_torch.model import detector          # noqa: E402
from dsvt_ai_trt_tpu_torch.model.backbone2d import conv, conv_relu  # noqa: E402
from dsvt_ai_trt_tpu_torch.model import transfusion       # noqa: E402
from dsvt_ai_trt_tpu_torch.ops import postprocess         # noqa: E402
from dsvt_ai_trt_tpu_torch.ops.query_attention_kernel import (  # noqa: E402
    query_attention_plain)
from dsvt_ai_trt_tpu_torch.runtime import profiler        # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine, SyncGuard  # noqa: E402

CONFIG = os.path.join(ROOT, "benchmark", "configs",
                      "dsvt-transfusion-nuscenes.json")
NUSC = os.path.join(ROOT, "benchmark", "configs", "dsvt-nuscenes.json")
# the pillar model on a 48 x 48 map, every width cut; the head's too
TINY = {"max_points": 2048, "max_kept_points": 1536, "max_pillars": 512,
        "max_points_per_pillar": 8, "grid_size": [48, 48, 1],
        "pc_range_min": [-7.68, -7.68, -5.0], "pc_range_max": [7.68, 7.68, 3.0],
        "pfn_channels": [16, 32], "sparse_shape": [48, 48, 1],
        "max_sets": 128, "set_size": 12, "num_blocks": 2, "num_heads": 4,
        "d_model": 32, "ffn_dim": 64, "num_classes": 3, "top_k": 64,
        "num_proposals": 24, "query_channels": 32, "query_heads": 4,
        "query_ffn_dim": 48, "query_branch_channels": 16,
        "query_free_classes": [2],
        "post_center_range": [-6.0, -6.0, -10.0, 6.0, 6.0, 10.0]}
SWEEPS = {"frames": 3, "points": [600, 900],
          "lidar": {"beams": 8, "elevation_deg": [-30, 5],
                    "azimuth_steps": 300, "height_m": 1.84,
                    "max_range_m": 7.5, "range_noise_m": 0.02,
                    "sensor_z_m": 0.0},
          "facades": {"count": [1, 2], "range_m": [3, 6],
                      "length_m": [2, 5], "height_m": [2, 4]},
          "bushes": {"count": [2, 4], "range_m": [2, 6],
                     "radius_m": [0.2, 0.5], "points": [5, 10]},
          "objects": {"count": [1, 2], "range_m": [2, 6],
                      "points": [20, 40]}}


def _raw_config(**over):
    with open(CONFIG) as f:
        raw = json.load(f)["config"]
    return {**raw, **TINY, **over}


def _configs(precision="fp32", **over):
    raw = _raw_config(**over)
    port = dataclasses.replace(DSVTConfig.from_json(json.dumps(raw)),
                               precision=precision)
    port.validate()
    return ref.QueryConfig.from_dict(raw), port


@pytest.fixture(scope="module")
def frames():
    rcfg, _ = _configs()
    rng = np.random.default_rng(4)
    out = []
    for n in (600, 750, 900):
        buf = np.zeros((TINY["max_points"], 4), np.float32)
        buf[:n] = sweeps.sweep(rng, SWEEPS, n, rcfg)
        out.append((torch.from_numpy(buf), n))
    return out


def _weights(rcfg, pcfg, seed=1):
    raw = ref.seeded_raw(rcfg, seed, "cpu")
    params = weights.from_jax_params(weights.prepare_params(
        {k: v.numpy() for k, v in raw.items()}, pcfg), "cpu")
    return ref.fold(raw, rcfg), params


# ---------------------------------------------------------------------------
# configuration and checkpoint
# ---------------------------------------------------------------------------


def test_config_json_round_trips_and_validates():
    _, pcfg = _configs()
    assert DSVTConfig.from_json(pcfg.to_json()) == pcfg
    assert query_head(pcfg) and not query_head(DEFAULT_CONFIG)
    for bad in ({"query_heads": 5}, {"query_nms_kernel": 2},
                {"query_free_classes": [3]}, {"head": "anchor"},
                {"post_center_range": [6.0, -6.0, -10.0, -6.0, 6.0, 10.0]}):
        with pytest.raises(AssertionError):
            _configs(**bad)


def test_a_center_head_stamp_is_unchanged():
    """``dsvt-nuscenes``' stamp: its file's keys and precision, none of the
    head's."""
    with open(NUSC) as f:
        raw = json.load(f)["config"]
    for cfg in (DEFAULT_CONFIG, DSVTConfig.from_json(json.dumps(raw))):
        stamp = json.loads(cfg.to_json())
        assert set(stamp) == set(raw) | {"precision"}
        assert not set(QUERY_KEYS) & set(stamp)
    assert json.loads(DEFAULT_CONFIG.to_json()) == {**raw,
                                                    "precision": "fp32"}


def test_checkpoint_names_are_the_references():
    rcfg, pcfg = _configs()
    assert weights.param_spec(pcfg) == ref.param_spec(rcfg)
    raw = weights.random_raw(pcfg, 0)
    assert set(raw) == set(ref.param_spec(rcfg))


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame", range(2))
def test_head_and_forward_match_the_reference_at_fp32(frames, frame):
    rcfg, pcfg = _configs()
    folded, params = _weights(rcfg, pcfg)
    pts, n = frames[frame]
    want = ref.detect(folded, pts, n, rcfg)
    with torch.no_grad():
        pl, sets = ref_detector.integer_stages(pts, n, rcfg)
        feats = ref_detector.backbone3d(
            ref_detector.vfe(pl, folded["vfe"], rcfg), sets, folded, rcfg)
        bev = ref_detector.resnet(ref_detector.to_bev(feats, pl, rcfg),
                                  folded["backbone2d"])
        lmap, hm = ref.dense_maps(bev, folded["head"])
    # the head alone, on the reference's BEV map: L and the heatmap
    head = params["head"]
    with torch.inference_mode():
        mine_l = conv(bev, head, "shared_w", "shared_b")
        mine_hm = conv(conv_relu(mine_l, head["hm"], "w0", "b0"), head["hm"],
                       "w1", "b1")
    for a, b in ((mine_l, lmap), (mine_hm, hm)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)
    with torch.inference_mode():
        preds = transfusion.head_forward(bev[0].permute(1, 2, 0).contiguous(),
                                         params["head"], pcfg, True)
        dets = postprocess.decode_queries(preds, pcfg)
    np.testing.assert_array_equal(preds["cells"].numpy(), want.cells.numpy())
    np.testing.assert_array_equal(preds["classes"].numpy(),
                                  want.classes.numpy())
    np.testing.assert_allclose(preds["cell_scores"].numpy(),
                               want.masked[:, want.cells].t().numpy(),
                               atol=1e-4, rtol=1e-4)
    served, count = ref.as_served(want)
    assert int(dets.count) == count > 0
    np.testing.assert_allclose(dets.boxes.numpy(), served, atol=1e-4,
                               rtol=1e-4)
    # the whole frame
    got = detector.forward(params, pts, n, pcfg, with_nms=True, device="cpu")
    np.testing.assert_array_equal(got.occupancy.numpy(), want.occupancy)
    assert int(got.count) == count
    np.testing.assert_allclose(got.boxes.numpy(), served, atol=1e-4,
                               rtol=1e-4)


def _hm(s: torch.Tensor) -> torch.Tensor:
    """Logits whose sigmoid is s [classes, H, W]."""
    return torch.logit(s.double()).float()[None]


def test_top_proposals_break_ties_to_the_lower_flat_index():
    _, pcfg = _configs(num_proposals=5, query_nms_kernel=1)
    s = torch.full((3, 8, 8), 0.25)
    s[1, 2, 3] = s[0, 6, 6] = s[0, 1, 1] = s[2, 0, 0] = s[1, 7, 0] = 0.75
    s[2, 5, 5] = s[0, 4, 4] = 0.75
    masked, classes, cells, _ = postprocess.select_proposals(_hm(s), pcfg)
    flat = (classes * 64 + cells).tolist()
    assert flat == [9, 36, 54, 64 + 19, 64 + 56]
    ranked = torch.sort(masked.reshape(-1), descending=True, stable=True)
    assert flat == ranked.indices[:5].tolist()


def test_local_max_frees_classes_and_zeroes_the_border():
    _, pcfg = _configs()
    # rising with the flat index: no background cell is a local maximum
    s = (0.1 + 0.001 * torch.arange(64.0)).reshape(1, 8, 8).repeat(3, 1, 1)
    s[:, 3, 3], s[:, 3, 4] = 0.6, 0.5        # an interior pair
    s[:, 0, 5] = 0.9                          # the top row, no window
    masked, _, _, count = postprocess.select_proposals(_hm(s), pcfg)
    m = masked.reshape(3, 8, 8)
    for c in (0, 1):                          # suppressed classes
        assert torch.isclose(m[c, 3, 3], torch.tensor(0.6))
        assert m[c, 3, 4] == 0 and m[c, 0, 5] == 0
        assert int((m[c] > 0).sum()) == 1
    assert torch.allclose(m[2], s[2])         # class 2 is free
    assert int(count) == 2 + 64


def test_query_attention_plain_is_multihead_cross_attention():
    g = torch.Generator().manual_seed(0)
    Nq, HW, C, H = 7, 50, 32, 4
    p = {k: torch.randn(C, C, generator=g) * 0.2 for k in ("wq", "wk", "wv")}
    p.update({k: torch.randn(C, generator=g) * 0.1 for k in ("bq", "bk", "bv")})
    p["wo"], p["bo"] = torch.eye(C), torch.zeros(C)
    query = torch.randn(Nq, C, generator=g)
    feats, pos = torch.randn(HW, C, generator=g), torch.randn(HW, C, generator=g)
    want = ref.multihead_attention(query, feats + pos, feats + pos, p, H)
    got = query_attention_plain(query @ p["wq"] + p["bq"], feats, pos,
                                torch.cat([p["wk"], p["wv"]], 1).t(),
                                torch.cat([p["bk"], p["bv"]]), H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# graph safety, the tracer, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_the_head_reads_nothing_back(frames, precision):
    rcfg, pcfg = _configs(precision=precision)
    _, params = _weights(rcfg, pcfg)
    pts, n = frames[0]
    n = torch.tensor(n, dtype=torch.int32)
    engine = Engine(params, pcfg, device="cpu", with_nms=True)
    want = engine(pts, n)
    guard = SyncGuard()
    with guard.plain_versions_exempt(), guard:
        got = detector.forward(engine.params, pts, n, pcfg, True,
                               device="cpu")
    assert guard.hits == []
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert "pk" in engine.params["head"]        # folded once
    assert ("pk_bf16" in engine.params["head"]) == (precision == "bf16")


def test_the_tracer_marks_the_query_stage(frames):
    rcfg, pcfg = _configs(precision="bf16")
    _, params = _weights(rcfg, pcfg)
    pts, n = frames[1]
    profiler.enable_spans()
    try:
        engine = Engine(params, pcfg, device="cpu", with_nms=True)
        dets = engine(pts, n)
        (rec,) = profiler.spans()
    finally:
        profiler.disable_spans()
    names = [s["name"] for s in rec["device"]]
    assert names == ["voxelize", "vfe", "partition", "backbone3d",
                     "bev_scatter", "backbone2d", "head", "query", "decode"]
    counters = rec["counters"]
    assert counters["query_boxes"] == [int(dets.count)]
    assert counters["proposals"][0] >= pcfg.num_proposals
    assert counters["occupancy"] == [dets.occupancy.tolist()]
    assert "boxes_before_nms" not in counters


def test_the_reference_imports_nothing_of_either_package():
    """The plain reference, its judge and its counts load no module of the
    port, of JAX or of the JAX package."""
    import subprocess

    code = ("import sys; sys.path.insert(0, %r); "
            "import benchmark.reference.transfusion, benchmark.judge_query, "
            "benchmark.work_query; print(' '.join(sorted({m.split('.')[0] "
            "for m in sys.modules})))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT, check=True)
    assert not set(out.stdout.split()) & {"jax", "jaxlib", "flax",
                                          "dsvt_ai_trt_tpu",
                                          "dsvt_ai_trt_tpu_torch"}


def test_the_head_refuses_sharding_and_training(frames):
    rcfg, pcfg = _configs()
    _, params = _weights(rcfg, pcfg)
    pts, n = frames[0]
    with pytest.raises(ValueError, match="one device"):
        detector.forward(params, pts, n, pcfg, device="cpu", tp=object())
    with pytest.raises(ValueError, match="not written"):
        detector.forward_train(params, pts, n, pcfg, device="cpu")
