"""The port's native host library (``io/host_nms.py`` over
``dsvt_ai_trt_tpu_torch/native/dsvt_host.cpp``) against its NumPy routes,
the JAX package's io/host_nms and the NMS oracle, on the CPU (g++ builds
it here; mirrors tests/test_io.py's native cases).

* NMS: the native kept set equals the NumPy route's, the JAX package's
  ``nms_host`` and ``oracles.nms_oracle`` on seeded clustered boxes, with
  strided and float64 inputs cast and copied first;
* the .bin loader equals ``pointcloud.load_bin`` and the JAX loader,
  truncation included; the .wts parser's blob equals the Python reader;
* a build goes to ``build/native/<digest>/`` and leaves the JAX package's
  ``native/`` directory as it was; without a compiler the NumPy route runs
  and says so.
"""

import hashlib
import logging
import os
import shutil
import uuid

import numpy as np
import pytest

import oracles
from dsvt_ai_trt_tpu.io import host_nms as jax_host_nms
from dsvt_ai_trt_tpu.io.pointcloud import load_bin as jax_load_bin
from dsvt_ai_trt_tpu_torch import weights
from dsvt_ai_trt_tpu_torch.io import host_nms, pointcloud

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_NATIVE = os.path.join(REPO, "dsvt_ai_trt_tpu", "native")


def _boxes(seed, n, k=None):
    """Score-sorted [k, 9] boxes, the first n live, clustered in threes so
    that NMS suppresses."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((k or n, 9), np.float32)
    boxes[:n, 0] = rng.uniform(-15, 15, n)
    boxes[:n, 1] = rng.uniform(-15, 15, n)
    boxes[:n, 2] = rng.uniform(-2, 1, n)
    boxes[:n, 3] = rng.uniform(1, 5, n)
    boxes[:n, 4] = rng.uniform(1, 3, n)
    boxes[:n, 5] = rng.uniform(1, 2, n)
    boxes[:n, 6] = rng.uniform(-3, 3, n)
    boxes[:n, 7] = rng.integers(0, 3, n)
    boxes[:n, 8] = np.sort(rng.uniform(0.3, 1, n))[::-1]
    for c in range(0, n - 3, 4):
        boxes[c + 1:c + 3, :2] = boxes[c, :2] + rng.uniform(-0.4, 0.4, (2, 2))
    return boxes


def _snapshot(path):
    return {name: hashlib.sha256(open(os.path.join(path, name), "rb").read())
            .hexdigest() for name in sorted(os.listdir(path))}


@pytest.fixture(scope="module")
def lib():
    lib = host_nms._load_native()
    assert lib is not None, "g++ is on this machine: the library must load"
    return lib


@pytest.mark.parametrize("seed,n,thresh", [(0, 25, 0.01), (1, 120, 0.01),
                                           (2, 60, 0.2), (3, 1, 0.01),
                                           (6, 40, 0.0)])
def test_native_nms_matches_numpy_jax_and_oracle(lib, seed, n, thresh):
    boxes = _boxes(seed, n, k=n + 7)
    out, k = host_nms.nms_host(boxes, n, thresh)
    ref_np, k_np = host_nms._nms_numpy(boxes, n, thresh)
    ref_jax, k_jax = jax_host_nms.nms_host(boxes, n, thresh)
    keep = oracles.nms_oracle(boxes, n, thresh)
    assert k == k_np == k_jax == len(keep)
    assert out.dtype == np.float32 and out.shape == boxes.shape
    np.testing.assert_array_equal(out, ref_np)
    np.testing.assert_array_equal(out, ref_jax)
    np.testing.assert_array_equal(out[:k], boxes[sorted(keep)])
    assert not out[k:].any()


@pytest.mark.parametrize("gap,suppressed", [(-0.05, True), (0.05, False)])
def test_native_nms_skips_only_pairs_that_cannot_overlap(lib, gap,
                                                         suppressed):
    """Both routes skip a pair whose circumcircles lie apart; a pair whose
    circles meet is clipped, so corners overlapping by a sliver suppress.
    Two equal boxes at heading 0.3 face each other corner to corner along
    the first's diagonal, their circumcircles ``gap`` metres apart."""
    boxes = np.zeros((2, 9), np.float32)
    boxes[:, 3:6] = (4.0, 2.0, 1.5)      # half-extents 1 (local x), 2 (y)
    boxes[:, 6] = 0.3
    boxes[:, 8] = (0.9, 0.8)
    c, s = np.cos(0.3), np.sin(0.3)
    corner = np.array([c - 2 * s, s + 2 * c])     # (1, 2) rotated by 0.3
    d = 2 * np.hypot(1.0, 2.0) + gap
    boxes[1, :2] = d * corner / np.hypot(*corner)
    got = host_nms.nms_host(boxes, 2, 1e-6)
    ref = host_nms._nms_numpy(boxes, 2, 1e-6)
    assert got[1] == ref[1] == (1 if suppressed else 2)
    np.testing.assert_array_equal(got[0], ref[0])
    if suppressed:   # the sliver the clip finds is real overlap
        assert jax_host_nms.nms_host(boxes, 2, 1e-6)[1] == 1


def test_native_nms_casts_strided_and_float64_inputs(lib):
    boxes = _boxes(4, 40)
    want = host_nms.nms_host(boxes, 40, 0.01)
    wide = np.zeros((40, 12), np.float64)
    wide[:, :9] = boxes
    strided = wide[:, :9]                      # a float64 view, row stride 12
    assert not strided.flags["C_CONTIGUOUS"]
    got = host_nms.nms_host(strided, 40, 0.01)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    with pytest.raises(ValueError, match=r"\[K, 9\]"):
        host_nms.nms_host(wide, 40, 0.01)
    with pytest.raises(ValueError, match="count"):
        host_nms.nms_host(boxes, 41, 0.01)


@pytest.mark.parametrize("n,cap", [(50, 64), (80, 64)])
def test_native_bin_loader_matches_python(lib, tmp_path, n, cap):
    pts = np.random.default_rng(n).normal(size=(n, 4)).astype(np.float32)
    path = str(tmp_path / "f.bin")
    pts.tofile(path)
    buf_c, n_c = host_nms.load_bin_native(path, cap)
    buf_py, n_py = pointcloud.load_bin(path, cap)
    buf_j, n_j = jax_load_bin(path, cap)
    assert int(n_c) == int(n_py) == int(n_j) == min(n, cap)
    np.testing.assert_array_equal(buf_c, buf_py)
    np.testing.assert_array_equal(buf_c, buf_j)
    with pytest.raises(IOError):
        host_nms.load_bin_native(str(tmp_path / "missing.bin"), cap)


def test_native_wts_parser_matches_python(lib, tmp_path):
    rng = np.random.default_rng(1)
    sub = {"module.a.weight": rng.normal(size=(7, 3)).astype(np.float32),
           "module.b.bias": np.arange(5, dtype=np.float32),
           "module.c.in_proj_weight.query": rng.normal(size=(2, 2)).astype(
               np.float32),
           "module.c.in_proj_weight.key": np.ones((2, 2), np.float32),
           "module.c.in_proj_weight.value": np.full((2, 2), -0.5, np.float32)}
    wts = str(tmp_path / "t.wts")
    weights.save_wts(sub, wts)
    blob, index = str(tmp_path / "t.bin"), str(tmp_path / "t.idx")
    assert host_nms.wts_to_blob_native(wts, blob, index) == 3
    data = np.fromfile(blob, np.float32)
    entries = {}
    for line in open(index):
        name, off, n = line.split()
        entries[name] = data[int(off):int(off) + int(n)]
    reread = weights.load_wts(wts)
    for name in ("module.a.weight", "module.b.bias"):
        np.testing.assert_array_equal(entries[name], sub[name].ravel())
        np.testing.assert_array_equal(entries[name], reread[name].ravel())
    np.testing.assert_array_equal(
        entries["module.c.in_proj_weight"],
        np.concatenate([reread[f"module.c.in_proj_weight.{p}"].ravel()
                        for p in ("query", "key", "value")]))
    bad = tmp_path / "bad.wts"
    bad.write_text("1\nmodule.x 2 3f800000 zz\n")
    assert host_nms.wts_to_blob_native(str(bad), blob, index) == -1


def test_build_goes_to_build_native_and_leaves_jax_dir(monkeypatch,
                                                       tmp_path):
    before = _snapshot(JAX_NATIVE)
    source = tmp_path / "dsvt_host.cpp"
    source.write_text(open(host_nms.SOURCE).read()
                      + f"\n// build check {uuid.uuid4().hex}\n")
    monkeypatch.setattr(host_nms, "SOURCE", str(source))
    monkeypatch.setattr(host_nms, "_native", {})
    so = host_nms.library_path()
    assert not os.path.exists(so)
    try:
        assert host_nms._load_native() is not None
        assert os.path.isfile(so)
        assert os.path.dirname(os.path.dirname(so)) == os.path.join(
            REPO, "build", "native")
        assert os.listdir(os.path.dirname(so)) == ["libdsvt_host.so"]
    finally:
        shutil.rmtree(os.path.dirname(so), ignore_errors=True)
    assert _snapshot(JAX_NATIVE) == before


def test_without_a_compiler_numpy_route_with_warning(monkeypatch, tmp_path,
                                                      caplog):
    monkeypatch.setattr(host_nms, "SOURCE", str(tmp_path / "absent.cpp"))
    monkeypatch.setattr(host_nms, "library_path",
                        lambda: str(tmp_path / "none" / "libdsvt_host.so"))
    monkeypatch.setattr(host_nms, "_native", {})
    monkeypatch.setattr(host_nms.shutil, "which", lambda _name: None)
    boxes = _boxes(5, 30)
    with caplog.at_level(logging.WARNING, logger="dsvt_torch.host_nms"):
        assert host_nms._load_native() is None
    assert "NumPy route" in caplog.text
    got = host_nms.nms_host(boxes, 30, 0.01)
    want = host_nms._nms_numpy(boxes, 30, 0.01)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert host_nms.wts_to_blob_native("a", "b", "c") == -1
