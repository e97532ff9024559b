"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for sm_90a into its own shared library
with a plain C interface, and bound with ``ctypes``.  Libraries go to
``build/kernels/<hash>/`` beside the package (``DSVT_KERNEL_DIR`` overrides
the root), keyed by a hash of the sources and flags, so an edited source
builds anew and an unchanged one is built once.  ``build_all`` starts every
``nvcc`` at once; ``lib(name)`` builds what is missing on first use.

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.

Launch counts: each kernel wrapper calls ``count(name)`` exactly where it
launches its kernel, and nowhere else, so a run can show that the main path
went through the kernels (``reset_counts`` / ``counts``).

A test may build and load a variant of a kernel with extra ``-D`` defines
(``lib(name, defines={"B4_SLOTS": 4})``) to drive a code path that the main
path's inputs do not reach; it goes to its own library.  The wrappers
never pass ``defines``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

import torch

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

# kernel name -> (source file, C entry point, argtypes)
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
SPECS = {
    "segment_max": ("segment_max.cu", "dsvt_segment_max",
                    [_P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "set_attention": ("set_attention.cu", "dsvt_set_attention",
                      [_P, _P, _P, _P, _I, _I, _I, _I, _P]),
    "encoder_epilogue": ("encoder_epilogue.cu", "dsvt_encoder_epilogue",
                         [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                          _I, _I, _I, _F, _P]),
    "rotated_overlap": ("rotated_overlap.cu", "dsvt_rotated_overlap",
                        [_P, _I, _P, _I, _P, _P]),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: Dict[tuple, ctypes.CDLL] = {}
_counts: Dict[str, int] = {name: 0 for name in SPECS}


def count(name: str) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only)."""
    _counts[name] += 1


def reset_counts() -> None:
    for name in _counts:
        _counts[name] = 0


def counts() -> Dict[str, int]:
    return dict(_counts)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def _build_dir() -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SPECS):
        with open(os.path.join(_CSRC, SPECS[name][0]), "rb") as f:
            digest.update(f.read())
    for extra in sorted(os.listdir(_CSRC)):
        if extra.endswith(".cuh"):
            with open(os.path.join(_CSRC, extra), "rb") as f:
                digest.update(f.read())
    root = os.environ.get("DSVT_KERNEL_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "kernels")
    return os.path.join(root, digest.hexdigest()[:16])


def _define_flags(defines: Optional[Dict[str, int]]) -> List[str]:
    return [f"-D{k}={v}" for k, v in sorted((defines or {}).items())]


def _so_path(name: str, defines: Optional[Dict[str, int]] = None) -> str:
    tag = "".join(f"-{k}{v}" for k, v in sorted((defines or {}).items()))
    return os.path.join(_build_dir(), f"lib{name}{tag}.so")


def build_all(names: List[str] = None,
              defines: Optional[Dict[str, int]] = None) -> Dict[str, float]:
    """Compile the named kernels (default all) in parallel, one ``nvcc``
    each, with ``defines`` added as ``-D`` flags; returns the wall seconds
    per kernel built (0.0 when cached).  Raises with the compiler's output
    when a build fails."""
    names = list(SPECS) if names is None else names
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    seconds = {}
    for name in names:
        so = _so_path(name, defines)
        if os.path.exists(so):
            seconds[name] = 0.0
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, *_define_flags(defines), "-o", tmp,
               os.path.join(_CSRC, SPECS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}:\n{log.decode(errors='replace')}")
        else:
            os.replace(tmp, _so_path(name, defines))   # atomic
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def lib(name: str, defines: Optional[Dict[str, int]] = None) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built with ``defines``),
    built on first use."""
    key = (name, tuple(sorted((defines or {}).items())))
    if key not in _libs:
        so = _so_path(name, defines)
        if not os.path.exists(so):
            build_all([name], defines)
        handle = ctypes.CDLL(so)
        fn = getattr(handle, SPECS[name][1])
        fn.argtypes = SPECS[name][2]
        fn.restype = ctypes.c_int
        _libs[key] = handle
    return _libs[key]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C entry on the current stream (appended as the
    last argument); raise if the launch reported a CUDA error."""
    fn = getattr(lib(name), SPECS[name][1])
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")


def require_cuda(name: str, *tensors: torch.Tensor, align: int = 1) -> None:
    """Kernel inputs: on one CUDA device, contiguous, and starting on an
    ``align``-byte boundary (16 for kernels that copy 16-byte vectors)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on the same CUDA "
                             f"device, got {[str(u.device) for u in tensors]}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: inputs must start on a {align}-byte "
                             f"boundary")
