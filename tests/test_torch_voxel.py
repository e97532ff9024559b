"""The staged sparse backbone (upstream DSVT-V: 3-D voxels, stages of 3-D
windows, attention pooling along z) at a tiny configuration on the CPU:

* the configuration's JSON round-trips, ``validate`` holds the stages to
  their grids and strides, and a pillar model's JSON is what it was;
* the port's voxelize, each stage's window and set partitions and each
  pooling's map equal the plain reference's (``benchmark/reference/
  voxel.py``) bit for bit, and its ``occupancy`` equals the reference's
  and the NumPy count's;
* ``forward_debug``'s head maps and ``forward``'s boxes match the
  reference at fp32 to the goldens' 1e-4;
* the pooling's plain path is upstream's formula: a zero placeholder,
  ``MaxPool1d`` and ``nn.MultiheadAttention`` written out here, with
  parents that have fewer children than slots, at 4 and 8 slots a parent;
  the fused route (kernel B3
  for the max, ``stage_pool``'s plain version on the CPU) equals it;
* a staged configuration of one stage is the pillar model, output for
  output;
* the staged forward reads nothing back to the host (a CUDA graph can
  hold it), marks each pooling while the tracer is on, and refuses
  sharding and training.
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

from benchmark.reference import voxel as ref            # noqa: E402
from benchmark.reference import voxel_counts            # noqa: E402
from benchmark.traffic import sweeps                    # noqa: E402
from dsvt_ai_trt_tpu_torch import weights               # noqa: E402
from dsvt_ai_trt_tpu_torch.config import (  # noqa: E402
    DSVTConfig, StageSpec, WindowSpec, occupancy_caps, stage_specs)
from dsvt_ai_trt_tpu_torch.model import detector        # noqa: E402
from dsvt_ai_trt_tpu_torch.model.backbone3d import (    # noqa: E402
    fold_pool, pool_forward)
from dsvt_ai_trt_tpu_torch.ops.pooling import pool_map  # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime import profiler      # noqa: E402
from dsvt_ai_trt_tpu_torch.runtime.compile import Engine, SyncGuard  # noqa: E402

CONFIG = os.path.join(ROOT, "benchmark", "configs", "dsvt-voxel-waymo.json")


def _w(shape, shift=(0, 0, 0)):
    return {"shape": list(shape), "shift": list(shift)}


# two stages on a 48 x 48 x 8 grid, pooled along z by 8; every width cut
TINY = {"max_points": 2048, "max_kept_points": 1536, "max_pillars": 1024,
        "max_points_per_pillar": 8, "voxel_size": [0.32, 0.32, 0.75],
        "pc_range_min": [-7.68, -7.68, -2.0], "pc_range_max": [7.68, 7.68, 4.0],
        "grid_size": [48, 48, 8], "pfn_channels": [16, 32],
        "sparse_shape": [48, 48, 8],
        "window_specs": [_w((12, 12, 8)), _w((24, 24, 8), (6, 6, 0))],
        "max_sets": 128, "set_size": 12, "num_blocks": 2, "num_heads": 4,
        "d_model": 32, "ffn_dim": 64, "num_classes": 3, "top_k": 64,
        "stages": [
            {"sparse_shape": [48, 48, 8], "num_blocks": 1, "set_size": 12,
             "window_specs": [_w((12, 12, 8)), _w((24, 24, 8), (6, 6, 0))],
             "max_voxels": 1024, "max_sets": 128, "stride": [1, 1, 8]},
            {"sparse_shape": [48, 48, 1], "num_blocks": 1, "set_size": 12,
             "window_specs": [_w((12, 12, 1)), _w((24, 24, 1), (6, 6, 0))],
             "max_voxels": 512, "max_sets": 128, "stride": [1, 1, 1]}]}
SWEEPS = {"frames": 3, "points": [600, 900],
          "lidar": {"beams": 8, "elevation_deg": [-30, 5],
                    "azimuth_steps": 300, "height_m": 1.84,
                    "max_range_m": 7.5, "range_noise_m": 0.02,
                    "sensor_z_m": 1.84},
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


def _configs(precision="fp32"):
    raw = _raw_config()
    port = dataclasses.replace(DSVTConfig.from_json(json.dumps(raw)),
                               precision=precision)
    port.validate()
    return ref.VoxelConfig.from_dict(raw), port


@pytest.fixture(scope="module")
def frames():
    rcfg, _ = _configs()
    rng = np.random.default_rng(3)
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
# configuration
# ---------------------------------------------------------------------------


def test_config_json_round_trips():
    with open(CONFIG) as f:
        raw = json.load(f)["config"]
    cfg = DSVTConfig.from_json(json.dumps(raw))
    cfg.validate()
    assert len(cfg.stages) == 4 and cfg.stages[0].window_specs[1] == \
        WindowSpec((24, 24, 32), (6, 6, 0))
    assert DSVTConfig.from_json(cfg.to_json()) == cfg
    stamp = json.loads(cfg.to_json())
    assert stamp["stages"] == raw["stages"]
    assert {k: stamp[k] for k in raw} == raw
    # every key of the file is one of the port's
    known = {f.name for f in dataclasses.fields(DSVTConfig)}
    assert set(raw) <= known
    # the pillar model's stamp carries no stages
    assert "stages" not in json.loads(DSVTConfig().to_json())


@pytest.mark.parametrize("fault", ["stride", "window", "last", "globals"])
def test_validate_holds_the_stages_to_their_grids(fault):
    raw = _raw_config()
    stages = [dict(st) for st in raw["stages"]]
    if fault == "stride":         # 8 / 4 = 2 z cells, not stage 1's 1
        stages[0]["stride"] = [1, 1, 4]
    elif fault == "window":       # taller than stage 1's grid
        stages[1]["window_specs"] = [_w((12, 12, 2)), _w((24, 24, 1))]
    elif fault == "last":         # the last stage pools
        stages[1]["stride"] = [1, 1, 2]
    else:                         # stage 0's cap is max_pillars
        raw["max_pillars"] = 999
    raw["stages"] = stages
    with pytest.raises(AssertionError):
        DSVTConfig.from_json(json.dumps(raw)).validate()


# ---------------------------------------------------------------------------
# integer stages against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("frame", range(3))
def test_integer_stages_equal_the_reference(frames, frame):
    rcfg, pcfg = _configs()
    pts, n = frames[frame]
    pl, stages = ref.integer_stages(pts, n, rcfg)
    params = {"vfe": {"l0": {"w": torch.zeros(1)}}}      # device only
    ppl, pst = detector.partition_frame(params, pts, n, pcfg, device="cpu")
    for field in ("point_feats", "point_pillar", "point_valid", "coords",
                  "pillar_valid", "pillar_count", "point_count"):
        assert torch.equal(getattr(pl, field), getattr(ppl, field)), field
    assert ppl.coords.shape[1] == 3
    for s, (mine, port) in enumerate(zip(stages, pst)):
        assert torch.equal(mine.coords, port.coords), s
        assert torch.equal(mine.valid, port.valid), s
        assert int(mine.count) == int(port.count), s
        for i, sp in enumerate(port.sets):
            assert torch.equal(mine.sets[i].xy, port.windows[i].xy_centered)
            assert (sp is None) == (i not in rcfg.used(s))
            if sp is not None:
                for field in ("inds", "key_mask", "set_count", "canon"):
                    assert torch.equal(getattr(mine.sets[i], field),
                                       getattr(sp, field)), (s, i, field)
        if mine.pooled is None:
            assert port.pool is None
            continue
        pm, pooled = port.pool, mine.pooled
        # the child of each (parent, slot), from the reference's placeholder
        N1, V = pm.child.shape
        child = torch.full((N1, V), pm.order.shape[0], dtype=torch.long)
        keep = pooled.inverse < N1
        child[pooled.inverse[keep], pooled.slot[keep]] = torch.nonzero(
            keep)[:, 0]
        assert torch.equal(pm.child, child)
        assert torch.equal(pm.full, (child < len(keep)).all(1))
        assert int(pm.count) == int(pooled.count)
    occ = ref.occupancy(pl, stages, rcfg)
    np.testing.assert_array_equal(
        occ, voxel_counts.occupancy(pts.numpy(), n, rcfg))
    assert len(occ) == len(occupancy_caps(pcfg)[1])


@pytest.mark.parametrize("frame", range(2))
def test_forward_matches_the_reference_at_fp32(frames, frame):
    rcfg, pcfg = _configs()
    folded, params = _weights(rcfg, pcfg)
    for pts, n in frames[frame:frame + 1]:
        with torch.no_grad():
            pl, stages = ref.integer_stages(pts, n, rcfg)
            maps = ref.float_stages(folded, pl, stages, rcfg)
        dbg = detector.forward_debug(params, pts, n, pcfg, device="cpu")
        assert dbg.dsvt_feats.shape == (TINY["stages"][1]["max_voxels"],
                                        TINY["d_model"])
        for name, want in maps.items():
            np.testing.assert_allclose(dbg.head_out[name].numpy(),
                                       want.numpy(), atol=1e-4, rtol=1e-4)
        det = ref.detect(folded, pts, n, rcfg)
        got = detector.forward(params, pts, n, pcfg, with_nms=True,
                               device="cpu")
        np.testing.assert_array_equal(got.occupancy.numpy(), det.occupancy)
        assert int(got.count) == len(det.boxes) > 0
        mine = got.boxes[:int(got.count)].numpy()
        mine = mine[np.argsort(-mine[:, 8], kind="stable")]
        want = det.boxes[np.argsort(-det.boxes[:, 8], kind="stable")]
        np.testing.assert_allclose(mine, want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# the pooling
# ---------------------------------------------------------------------------


def _upstream_pool(x, parent, slot, p, V, heads, eps):
    """Stage_ReductionAtt_Block on its placeholder, as upstream writes it."""
    N1, C = int(parent.max()) + 1, x.shape[1]
    placeholder = x.new_zeros((N1, V, C))
    placeholder[parent, slot] = x
    feats = placeholder.permute(0, 2, 1)                  # [N1, C, V]
    src = torch.nn.MaxPool1d(V)(feats).permute(0, 2, 1)   # [N1, 1, C]
    key = feats.permute(0, 2, 1) + p["pos"][None]
    attn = torch.nn.MultiheadAttention(C, heads, batch_first=True)
    norm = torch.nn.LayerNorm(C, eps=eps)
    with torch.no_grad():
        attn.in_proj_weight.copy_(torch.cat([p["wq"].t(), p["wk"].t(),
                                             p["wv"].t()]))
        attn.in_proj_bias.copy_(torch.cat([p["bq"], p["bk"], p["bv"]]))
        attn.out_proj.weight.copy_(p["wo"].t())
        attn.out_proj.bias.copy_(p["bo"])
        norm.weight.copy_(p["ln_g"])
        norm.bias.copy_(p["ln_b"])
        # upstream's key_padding_mask is all zeros
        out = attn(src, key, placeholder,
                   key_padding_mask=torch.zeros((N1, V), dtype=torch.bool))[0]
        return norm(out + src)[:, 0]


@pytest.mark.parametrize("V", [4, 8])
def test_pool_is_upstreams_formula(V):
    torch.manual_seed(0)
    C, H = 32, 4
    # 7 voxels: z 0..3, 5 and 7 of the column x = 0, z 2 of the column
    # x = 1.  Pooled by 4 along z, z 0..3 fill the column's first parent,
    # z 5 and 7 half-fill its second; pooled by 8, the column is one parent
    # with 6 of its 8 slots filled.  The voxel of x = 1 is a parent alone.
    coords = torch.tensor([[0, 0, 0], [1, 0, 0], [2, 0, 0], [3, 0, 0],
                           [5, 0, 0], [7, 0, 0], [2, 0, 1], [0, 0, 0]])
    valid = torch.tensor([True] * 7 + [False])
    stage = StageSpec((2, 1, 8), (WindowSpec((2, 1, 8)),), 1, 8, 8, 4,
                      (1, 1, V))
    nxt = StageSpec((2, 1, 8 // V), (WindowSpec((2, 1, 8 // V)),), 1, 8, 6,
                    4)
    pm = pool_map(coords, valid, stage, nxt)
    # parents in ascending cell id ((z * gy + y) * gx + x)
    if V == 4:
        parents, full = [[0, 0, 0], [0, 0, 1], [1, 0, 0]], [True, False, False]
        parent = torch.tensor([0, 0, 0, 0, 2, 2, 1])
    else:
        parents, full = [[0, 0, 0], [0, 0, 1]], [False, False]
        parent = torch.tensor([0, 0, 0, 0, 0, 0, 1])
    P = len(parents)
    assert int(pm.count) == P
    assert pm.coords[:P].tolist() == parents
    assert pm.full[:P].tolist() == full
    x = torch.randn(8, C)
    p = {k: torch.randn(C, C) / C ** 0.5 for k in ("wq", "wk", "wv", "wo")}
    p.update({k: torch.randn(C) * 0.1 for k in ("bq", "bk", "bv", "bo",
                                                "ln_b")})
    p["ln_g"] = 1 + 0.1 * torch.randn(C)
    p["pos"] = torch.randn(V, C)
    p.update(fold_pool(p))
    cfg = dataclasses.replace(DSVTConfig(), d_model=C, num_heads=H)
    got = pool_forward(x, pm, p, cfg, use_kernels=False)
    slot = coords[:7, 0] % V
    want = _upstream_pool(x[:7], parent, slot, p, V, H, cfg.ln_eps)
    torch.testing.assert_close(got[:P], want, atol=1e-5, rtol=1e-5)
    # the fused route on the CPU: B3's max over the sorted children and
    # stage_pool's plain version, at the fused paths' precision
    mixed = dataclasses.replace(cfg, precision="mixed")
    fused = pool_forward(x, pm, p, mixed, use_kernels=True)
    plain = pool_forward(x, pm, p, mixed, use_kernels=False)
    assert torch.equal(fused, plain)


# ---------------------------------------------------------------------------
# one stage is the pillar model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_one_stage_is_the_pillar_model(precision):
    from conftest import make_cloud, tiny_config
    jcfg = tiny_config()
    pillar = dataclasses.replace(
        DSVTConfig.from_json(jcfg.to_json()), precision=precision)
    staged = dataclasses.replace(pillar, stages=stage_specs(pillar))
    staged.validate()
    assert weights.param_spec(staged) == weights.param_spec(pillar)
    assert occupancy_caps(staged)[1] == occupancy_caps(jcfg)[1]
    params = weights.from_jax_params(weights.random_params(pillar, 0), "cpu")
    assert "pool" not in params
    pts, n = make_cloud(np.random.default_rng(1234), pillar, 1500)
    a = detector.forward(params, pts, int(n), pillar, with_nms=True,
                         device="cpu")
    b = detector.forward(params, pts, int(n), staged, with_nms=True,
                         device="cpu")
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    if precision == "fp32":
        da = detector.forward_debug(params, pts, int(n), pillar, device="cpu")
        db = detector.forward_debug(params, pts, int(n), staged, device="cpu")
        assert torch.equal(da.dsvt_feats, db.dsvt_feats)


# ---------------------------------------------------------------------------
# graph safety, tracer, refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_staged_forward_reads_nothing_back(frames, precision):
    rcfg, pcfg = _configs(precision=precision)
    _, params = _weights(rcfg, pcfg)
    pts, n = frames[0]
    n = torch.tensor(n, dtype=torch.int32)
    ref_out = detector.forward(params, pts, n, pcfg, True, device="cpu")
    guard = SyncGuard()
    with guard.plain_versions_exempt(), guard:
        got = detector.forward(params, pts, n, pcfg, True, device="cpu")
    assert guard.hits == []
    for a, b in zip(got, ref_out):
        assert torch.equal(a, b)
    engine = Engine(params, pcfg, device="cpu", with_nms=True)
    for a, b in zip(engine(pts, n), ref_out):
        assert torch.equal(a, b)


def test_the_tracer_marks_each_pooling(frames):
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
    assert names == ["voxelize", "vfe", "partition", "backbone3d", "pool",
                     "backbone3d", "bev_scatter", "backbone2d", "head",
                     "decode", "nms"]
    assert rec["counters"]["occupancy"] == [dets.occupancy.tolist()]
    assert rec["counters"]["pool_parents"] == [int(dets.occupancy[2])]


def test_staged_config_refuses_sharding_and_training(frames):
    rcfg, pcfg = _configs()
    _, params = _weights(rcfg, pcfg)
    pts, n = frames[0]
    with pytest.raises(ValueError, match="one device"):
        detector.forward(params, pts, n, pcfg, device="cpu", tp=object())
    with pytest.raises(ValueError, match="training a staged"):
        detector.forward_train(params, pts, n, pcfg, device="cpu")
