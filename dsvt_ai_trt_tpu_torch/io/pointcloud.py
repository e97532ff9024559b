"""Point-cloud .bin loading.

Mirrors the reference loader contract (helper.h:28-72): raw float32 x,y,z,i
rows, zero-padded to the static point capacity; frames larger than the
capacity are truncated with a warning (the reference hard-exits,
helper.h:46-52 — a batch runner should skip/flag instead, SURVEY §5).
"""

from __future__ import annotations

import logging
import os
from typing import List, Tuple

import numpy as np

log = logging.getLogger("dsvt_torch.io")


def load_bin(path: str, max_points: int) -> Tuple[np.ndarray, np.int32]:
    pts = np.fromfile(path, dtype=np.float32)
    if pts.size % 4 != 0:
        raise ValueError(f"{path}: size {pts.size} not a multiple of 4 floats")
    pts = pts.reshape(-1, 4)
    n = len(pts)
    if n > max_points:
        log.warning("%s: %d points > capacity %d, truncating", path, n, max_points)
        n = max_points
    buf = np.zeros((max_points, 4), np.float32)
    buf[:n] = pts[:n]
    return buf, np.int32(n)


def frame_paths(data_dir: str) -> List[str]:
    """The .bin frames of a directory, in name order."""
    return sorted(
        os.path.join(data_dir, f) for f in os.listdir(data_dir)
        if f.endswith(".bin"))
