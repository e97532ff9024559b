"""Build, load and count the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for sm_90a into its own shared library
with a plain C interface, and bound with ``ctypes``.  Libraries go to
``build/kernels/<digest>/`` beside the package (``DSVT_KERNEL_DIR``
overrides the root), keyed by ``digest()``, a hash of the sources and
flags, so an edited source builds anew and an unchanged one is built once.
``build_all`` starts every ``nvcc`` at once; ``lib(name)`` builds what is
missing on first use; ``install`` puts an engine artifact's library there
instead (runtime/compile.py).

Nothing here runs at import: the CPU tests import every module, and the
CPU has no ``nvcc``.

Launch counts: each kernel wrapper calls ``count(name, flops)`` exactly
where it launches its kernel, and nowhere else, so a run can show that the
main path went through the kernels (``reset_counts`` / ``counts``).  Inside
``flop_tally`` the same call also adds the launch's FLOPs, from the formula
beside the wrapper, for runtime/profiler.py's counts.  A CUDA graph capture
launches nothing: ``captured`` takes the launches its wrappers counted back
out of the counts and keeps them, and ``replayed`` adds them once for each
replay of the graph, which launches them (runtime/compile.py:Engine).

A test may build and load a variant of a kernel with extra ``-D`` defines
(``lib(name, defines={"B4_SLOTS": 4})``) to drive a code path that the main
path's inputs do not reach; it goes to its own library.  The wrappers
never pass ``defines``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional

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
    "nms_peel": ("nms_peel.cu", "dsvt_nms_peel",
                 [_P, _P, _I, _P, _F, _P, _P, _P]),
    "stage_mark": ("stage_mark.cu", "dsvt_stage_mark", [_P, _I, _P]),
    "stage_pool": ("stage_pool.cu", "dsvt_stage_pool",
                   [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "bev_epilogue": ("bev_epilogue.cu", "dsvt_bev_epilogue",
                     [_P, _P, _P, _I, _I, _I, _P]),
    "query_attention": ("query_attention.cu", "dsvt_query_attention",
                        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "voxel_segments": ("voxel_segments.cu", "dsvt_voxel_segments",
                       [_I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I,
                        _F, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P, _P,
                        _P, _P]),
}

ARCH = "sm_90a"
NVCC_FLAGS = ["-gencode", f"arch=compute_90a,code={ARCH}", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_libs: Dict[tuple, ctypes.CDLL] = {}
_counts: Dict[str, int] = {name: 0 for name in SPECS}
_flop_tallies: List[Dict[str, float]] = []


def count(name: str, flops: Optional[Callable[[], float]] = None) -> None:
    """Record one launch of kernel ``name`` (called by its wrapper only,
    where it launches).  ``flops`` gives the launch's FLOPs from the formula
    kept beside the wrapper; it is called only inside ``flop_tally``, since
    a formula may read a count back from the card."""
    _counts[name] += 1
    if _flop_tallies and flops is not None:
        n = float(flops())
        for tally in _flop_tallies:
            tally[name] = tally.get(name, 0.0) + n


@contextlib.contextmanager
def captured() -> Iterator[Dict[str, int]]:
    """Around a CUDA graph capture: the launches counted inside the block,
    as a dict filled when the block ends, are taken back out of the counts
    (the capture records them into the graph and runs none)."""
    before = counts()
    launches: Dict[str, int] = {}
    try:
        yield launches
    finally:
        for name in _counts:
            launches[name] = _counts[name] - before[name]
            _counts[name] = before[name]


def replayed(launches: Dict[str, int]) -> None:
    """Count one replay of a graph that captured ``launches``."""
    for name, n in launches.items():
        _counts[name] += n


def reset_counts() -> None:
    for name in _counts:
        _counts[name] = 0


def counts() -> Dict[str, int]:
    return dict(_counts)


@contextlib.contextmanager
def flop_tally() -> Iterator[Dict[str, float]]:
    """A dict that collects, per kernel name, the FLOPs of every kernel
    launch made inside the block (``torch.utils.flop_counter`` sees nothing
    inside a ``ctypes`` launch).  Tallies nest."""
    tally: Dict[str, float] = {}
    _flop_tallies.append(tally)
    try:
        yield tally
    finally:   # by identity: two tallies may hold equal counts
        del _flop_tallies[next(i for i, t in enumerate(_flop_tallies)
                               if t is tally)]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return found


def digest() -> str:
    """Hash of the nvcc flags and every source in ``csrc/``: the name of the
    build directory, and the key an engine artifact is stamped with."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(SPECS):
        with open(os.path.join(_CSRC, SPECS[name][0]), "rb") as f:
            h.update(f.read())
    for extra in sorted(os.listdir(_CSRC)):
        if extra.endswith(".cuh"):
            with open(os.path.join(_CSRC, extra), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def _build_dir() -> str:
    root = os.environ.get("DSVT_KERNEL_DIR") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "build", "kernels")
    return os.path.join(root, digest())


def library_path(name: str) -> str:
    """Where kernel ``name``'s library of this tree's sources lives."""
    return _so_path(name)


def install(name: str, data: bytes) -> str:
    """Put a library of kernel ``name`` built elsewhere from the same
    sources (an engine artifact's) where ``lib`` finds it, unless one is
    there already; returns its path."""
    so = _so_path(name)
    if not os.path.exists(so):
        os.makedirs(os.path.dirname(so), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
        with os.fdopen(fd, "wb") as f:
            f.write(data)
        os.replace(tmp, so)   # atomic
    return so


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
