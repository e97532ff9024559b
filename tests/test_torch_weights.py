"""Port weights, imports, kernel plumbing and device rules.

* the port's random_params equals the JAX one bit for bit;
* from_jax_params gives torch tensors of the right shapes on the device;
* importing the port (the serving and training modules named) loads neither
  jax nor dsvt_ai_trt_tpu (exact name or a ``dsvt_ai_trt_tpu.`` submodule:
  ``dsvt_ai_trt_tpu_torch`` shares the prefix, so a substring test would
  be wrong);
* entry points default to CUDA and raise without it; kernel wrappers raise
  on CPU tensors; CPU tensors take the plain versions and count no launch.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_cpu  # noqa: F401  (one torch thread: see tests/torch_cpu.py)

from conftest import tiny_config

from dsvt_ai_trt_tpu import weights as jax_weights
from dsvt_ai_trt_tpu_torch import kernels
from dsvt_ai_trt_tpu_torch import weights

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def test_random_params_bit_exact():
    cfg = tiny_config()
    ours = dict(_leaves(weights.random_params(cfg, 3)))
    ref = dict(_leaves(jax_weights.random_params(cfg, 3)))
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=str(k))


def test_param_spec_and_raw_match():
    cfg = tiny_config()
    assert weights.param_spec(cfg) == jax_weights.param_spec(cfg)
    raw, ref = weights.random_raw(cfg, 5), jax_weights.random_raw(cfg, 5)
    for k in ref:
        np.testing.assert_array_equal(raw[k], ref[k], err_msg=k)


def test_from_jax_params_shapes_and_device():
    cfg = tiny_config()
    p = jax_weights.random_params(cfg, 0)
    t = weights.from_jax_params(p, "cpu")
    for path, leaf in _leaves(t):
        assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"
        want = torch.bfloat16 if path[-1].endswith("_bf16") else torch.float32
        assert leaf.dtype == want, path
    # HWIO conv kernels become OIHW; linears and deconvs keep their layout
    hw = p["backbone2d"]["stages"][0][0]["conv1_w"]
    np.testing.assert_array_equal(
        t["backbone2d"]["stages"][0][0]["conv1_w"].numpy(),
        np.transpose(hw, (3, 2, 0, 1)))
    assert tuple(t["head"]["hm"]["w1"].shape) == (cfg.num_classes, 64, 3, 3)
    assert tuple(t["head"]["shared_w"].shape) == (64, 384, 3, 3)
    np.testing.assert_array_equal(t["vfe"]["l0"]["w"].numpy(),
                                  p["vfe"]["l0"]["w"])
    np.testing.assert_array_equal(t["backbone2d"]["deblocks"][1]["w"].numpy(),
                                  p["backbone2d"]["deblocks"][1]["w"])
    assert len(t["blocks"]) == cfg.num_blocks
    # each encoder pass carries its folded weights, made once here
    enc, mlp = t["blocks"][1]["enc"][0], t["posembed"][1][0]
    C = cfg.d_model
    assert tuple(enc["w_qkv"].shape) == tuple(enc["w_pos"].shape) == (C, 3 * C)
    torch.testing.assert_close(enc["w_qkv"][:, C:2 * C], enc["wk"])
    torch.testing.assert_close(enc["w_pos"][:, :C], mlp["w2"] @ enc["wq"])
    assert torch.all(enc["w_pos"][:, 2 * C:] == 0)
    torch.testing.assert_close(enc["b_qkv"][2 * C:], enc["bv"])
    # kernel B2's panels [N/C, K/32, C, 32] hold the bf16 weights
    for key, w in (("wo_panels_bf16", "wo"),
                   ("ffn_w1_panels_bf16", "ffn_w1"),
                   ("ffn_w2_panels_bf16", "ffn_w2")):
        n_panels, n_slabs = enc[key].shape[:2]
        untiled = enc[key].permute(1, 3, 0, 2).reshape(32 * n_slabs,
                                                       C * n_panels)
        assert torch.equal(untiled, enc[w].bfloat16())
    assert torch.equal(enc["ln_stack"][5], enc["norm_b"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import dsvt_ai_trt_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax'\n"
        "             or n.startswith('jax.') or n == 'dsvt_ai_trt_tpu'\n"
        "             or n.startswith('dsvt_ai_trt_tpu.'))\n"
        "ported = [n for n in sys.modules if n.startswith('dsvt_ai_trt_tpu_torch.')]\n"
        "want = ['cli', 'bench', 'runtime.compile', 'runtime.trace',\n"
        "        'runtime.profiler', 'io.host_nms', 'data',\n"
        "        'parallel.training', 'train_run', 'parity', 'heading_probe',\n"
        "        'parallel.collectives', 'parallel.mesh', 'parallel.spatial',\n"
        "        'parallel.dryrun']\n"
        "missing = [w for w in want if 'dsvt_ai_trt_tpu_torch.' + w not in ported]\n"
        "print(len(ported), missing, bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_ported, rest = out.stdout.strip().split(" ", 1)
    assert int(n_ported) >= 30      # every module was imported
    assert rest == "[] []", rest    # the serving modules too; no JAX


def test_entry_points_default_to_cuda(monkeypatch):
    from dsvt_ai_trt_tpu_torch.model.detector import forward
    from dsvt_ai_trt_tpu_torch.runtime.infer import Engine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_config()
    p = jax_weights.random_params(cfg, 0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(p, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        forward(weights.from_jax_params(p, "cpu"),
                np.zeros((cfg.max_points, 4), np.float32), 0, cfg)


def test_kernel_wrappers_refuse_cpu_tensors():
    from dsvt_ai_trt_tpu_torch.ops import (attention_kernel, encoder_kernel,
                                           nms_kernel, segment)
    cfg = tiny_config()
    enc = weights.from_jax_params(jax_weights.random_params(cfg, 0),
                                  "cpu")["blocks"][0]["enc"][0]
    bf = torch.bfloat16
    with pytest.raises(ValueError, match="CUDA"):
        segment.segmented_max_cuda(torch.zeros(8, 4), torch.ones(8, dtype=torch.bool), 4)
    with pytest.raises(ValueError, match="CUDA"):
        attention_kernel.set_attention_cuda(torch.zeros(8, 96, dtype=bf),
                                            torch.zeros(2, 4), 4)
    with pytest.raises(ValueError, match="CUDA"):
        encoder_kernel.encoder_epilogue_cuda(torch.zeros(8, 32),
                                             torch.zeros(8, 32, dtype=bf), enc)
    with pytest.raises(ValueError, match="CUDA"):
        nms_kernel.pairwise_overlap_cuda(torch.zeros(8, 9))


def test_cpu_tensors_take_plain_versions_without_launches():
    from dsvt_ai_trt_tpu_torch.ops import nms_kernel, segment
    kernels.reset_counts()
    feats = torch.randn(16, 4)
    starts = torch.zeros(16, dtype=torch.bool)
    starts[::4] = True
    out = segment.segmented_max(feats, starts, 4)
    torch.testing.assert_close(out, segment.segmented_max_plain(feats, starts, 4))
    nms_kernel.pairwise_overlap(torch.rand(5, 9))
    assert kernels.counts() == {name: 0 for name in kernels.SPECS}


def test_build_needs_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("DSVT_KERNEL_DIR", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(kernels.shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all()
    # one directory per source hash, under the override root
    assert os.path.dirname(kernels._build_dir()) == str(tmp_path)
