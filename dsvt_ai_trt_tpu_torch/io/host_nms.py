"""Host-side rotated NMS and host I/O, native C++ with a NumPy fallback
(port of the JAX package's io/host_nms.py).

The default pipeline runs NMS on the device (ops/nms.py, kernel B4); this
is the host alternative of the reference's deployment shape (helper.h:
257-283 runs NMS on the CPU after the engine): ``run_frames(...,
host_nms=True)`` with an engine built ``with_nms=False``.

The native route is the port's copy of the C++ host library,
``native/dsvt_host.cpp`` (greedy NMS, the .bin loader and the .wts-to-blob
parser), compiled on first use by ``g++ -O3 -std=c++17 -fPIC -shared``
into ``build/native/<digest>/libdsvt_host.so`` beside the package, keyed by
a hash of the source and flags, and bound with ``ctypes``.  The NumPy route
(``_nms_numpy``, ``pointcloud.load_bin``) is taken only where no C++
compiler is found, with a warning; a compiler that fails on the source
raises.

The box geometry (``_corners``, ``_clip_area``) is also what ``eval.py``
matches boxes with.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np

log = logging.getLogger("dsvt_torch.host_nms")

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PACKAGE, "native", "dsvt_host.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

_FLOATS = ctypes.POINTER(ctypes.c_float)
_native: Dict[str, Optional[ctypes.CDLL]] = {}


def library_path() -> str:
    """Where the library of this tree's source and flags is built."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(os.path.dirname(_PACKAGE), "build", "native",
                        h.hexdigest()[:16], "libdsvt_host.so")


def _build(so: str) -> None:
    """Compile ``SOURCE`` into ``so`` (atomically: a concurrent build of
    the same source writes the same file); raise with the compiler's output
    when it fails."""
    out_dir = os.path.dirname(so)
    os.makedirs(out_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    proc = subprocess.run([shutil.which("g++"), *CXX_FLAGS, "-o", tmp, SOURCE],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stderr}")
    os.replace(tmp, so)


def _load_native() -> Optional[ctypes.CDLL]:
    """The native library, built on first use; None (and a warning) where
    no C++ compiler is found."""
    if "lib" in _native:
        return _native["lib"]
    so = library_path()
    if not os.path.exists(so):
        if shutil.which("g++") is None:
            log.warning("no C++ compiler (g++) found: host NMS, .bin loading "
                        "and .wts parsing take the NumPy route")
            _native["lib"] = None
            return None
        _build(so)
    lib = ctypes.CDLL(so)
    lib.dsvt_nms.restype = ctypes.c_int
    lib.dsvt_nms.argtypes = [_FLOATS, ctypes.c_int, ctypes.c_float,
                             ctypes.POINTER(ctypes.c_int)]
    lib.dsvt_load_bin.restype = ctypes.c_int
    lib.dsvt_load_bin.argtypes = [ctypes.c_char_p, _FLOATS, ctypes.c_int]
    lib.dsvt_wts_to_blob.restype = ctypes.c_int
    lib.dsvt_wts_to_blob.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_char_p]
    _native["lib"] = lib
    return lib


def _corners(boxes: np.ndarray) -> np.ndarray:
    cx, cy = boxes[:, 0], boxes[:, 1]
    hx, hy = boxes[:, 4] / 2, boxes[:, 3] / 2
    ang = boxes[:, 6]
    ox = np.stack([-hx, hx, hx, -hx], 1)
    oy = np.stack([-hy, -hy, hy, hy], 1)
    c, s = np.cos(ang)[:, None], np.sin(ang)[:, None]
    return np.stack([ox * c - oy * s + cx[:, None],
                     ox * s + oy * c + cy[:, None]], -1)


def _clip_area(pa: np.ndarray, pb: np.ndarray) -> float:
    """Sutherland–Hodgman intersection area of two convex quads."""
    poly = list(pa)
    for e in range(4):
        a, b = pb[e], pb[(e + 1) % 4]
        ex, ey = b[0] - a[0], b[1] - a[1]
        out = []
        n = len(poly)
        if n < 3:
            return 0.0
        for i in range(n):
            cur, nxt = poly[i], poly[(i + 1) % n]
            dc = ex * (cur[1] - a[1]) - ey * (cur[0] - a[0])
            dn = ex * (nxt[1] - a[1]) - ey * (nxt[0] - a[0])
            if dc >= 0:
                out.append(cur)
            if (dc >= 0) != (dn >= 0):
                t = dc / (dc - dn)
                out.append((cur[0] + t * (nxt[0] - cur[0]),
                            cur[1] + t * (nxt[1] - cur[1])))
        poly = out
    if len(poly) < 3:
        return 0.0
    area = 0.0
    for i in range(len(poly)):
        j = (i + 1) % len(poly)
        area += poly[i][0] * poly[j][1] - poly[j][0] * poly[i][1]
    return abs(area) / 2


def _nms_numpy(boxes: np.ndarray, count: int,
               iou_threshold: float) -> Tuple[np.ndarray, int]:
    """The NumPy route of ``nms_host``.  A pair whose circumcircles lie
    apart (with a 1 mm margin) cannot overlap, so its IoU of 0 is not
    computed when the threshold is above 0: the kept set is the one every
    pair's clip would give."""
    suppressed = np.zeros(count, bool)
    corners = _corners(boxes[:count])
    areas = boxes[:count, 3] * boxes[:count, 4]
    near = np.ones((count, count), bool)
    if iou_threshold > 0:
        radius = 0.5 * np.hypot(boxes[:count, 3], boxes[:count, 4])
        dist = np.hypot(boxes[:count, 0, None] - boxes[None, :count, 0],
                        boxes[:count, 1, None] - boxes[None, :count, 1])
        near = dist <= radius[:, None] + radius[None, :] + 1e-3
    sel = []
    for i in range(count):
        if suppressed[i]:
            continue
        sel.append(i)
        for j in np.flatnonzero(near[i, i + 1:]) + i + 1:
            if suppressed[j]:
                continue
            ov = _clip_area(corners[i], corners[j])
            iou = ov / max(areas[i] + areas[j] - ov, 1e-8)
            if iou >= iou_threshold:
                suppressed[j] = True
    out = np.zeros_like(boxes)
    out[:len(sel)] = boxes[sel]
    return out, len(sel)


def nms_host(boxes: np.ndarray, count: int,
             iou_threshold: float) -> Tuple[np.ndarray, int]:
    """Greedy NMS on score-sorted boxes [K, 9] (the first ``count`` rows);
    returns the kept boxes compacted to the front of a [K, 9] float32 array
    and their number.  Native where the library loads, else NumPy."""
    # the C entry reads count rows of 9 contiguous float32
    boxes = np.ascontiguousarray(boxes, np.float32)
    count = int(count)
    if boxes.ndim != 2 or boxes.shape[1] != 9 or not 0 <= count <= len(boxes):
        raise ValueError(f"nms_host: boxes {boxes.shape} and count {count}; "
                         "want [K, 9] and 0 <= count <= K")
    lib = _load_native()
    if lib is None or count == 0:
        return _nms_numpy(boxes, count, iou_threshold)
    keep = np.zeros((count,), np.int32)
    kept = lib.dsvt_nms(boxes.ctypes.data_as(_FLOATS), count,
                        ctypes.c_float(iou_threshold),
                        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
    out = np.zeros_like(boxes)
    out[:kept] = boxes[np.flatnonzero(keep)]
    return out, int(kept)


def load_bin_native(path: str, max_points: int):
    """``pointcloud.load_bin`` through the native loader: (buffer
    [max_points, 4] float32, zero-padded; point count as int32), frames
    over the capacity truncated."""
    lib = _load_native()
    if lib is None:
        from .pointcloud import load_bin
        return load_bin(path, max_points)
    buf = np.zeros((max_points, 4), np.float32)
    n = lib.dsvt_load_bin(path.encode(), buf.ctypes.data_as(_FLOATS),
                          max_points)
    if n < 0:
        raise IOError(f"failed to load {path}")
    return buf, np.int32(n)


def wts_to_blob_native(wts_path: str, blob_path: str, index_path: str) -> int:
    """Convert a .wts text checkpoint into a little-endian float32 blob and
    an index of ``name offset count`` lines; returns the tensor count, or
    -1 on a parse error or without the native library."""
    lib = _load_native()
    if lib is None:
        return -1
    return lib.dsvt_wts_to_blob(wts_path.encode(), blob_path.encode(),
                                index_path.encode())
