"""Result txt writer, format-compatible with the reference outputs.

Format (helper.h:441-468): first line = seconds (6 decimals), then one line
per box: ``x,  y,  z,  l,  w,  h,  rt,  id,  score`` — where l is the
decoded dim0 and w is dim1 (save_result swaps dims into Bndbox{w,l},
helper.h:470-481, and save_txt writes l before w).  Our box rows are
(x, y, z, dx, dy, dz, heading, class, score), so l=row[3], w=row[4] directly.
"""

from __future__ import annotations

import numpy as np


def format_txt(boxes: np.ndarray, count: int, seconds: float) -> str:
    lines = [f"{seconds:.6f}"]
    for i in range(count):
        b = boxes[i]
        lines.append(
            f"{b[0]:.6f},  {b[1]:.6f},  {b[2]:.6f},  {b[3]:.6f},  {b[4]:.6f},  "
            f"{b[5]:.6f},  {b[6]:.6f},  {int(b[7])},  {b[8]:.6f}")
    return "\n".join(lines) + "\n"


def save_txt(boxes: np.ndarray, count: int, seconds: float, path: str) -> None:
    with open(path, "w") as f:
        f.write(format_txt(boxes, count, seconds))


def load_txt(path: str):
    """Parse a result txt back into (seconds, boxes [N, 9])."""
    with open(path) as f:
        lines = [l.strip() for l in f if l.strip()]
    seconds = float(lines[0])
    rows = []
    for line in lines[1:]:
        vals = [float(v) for v in line.split(",")]
        rows.append(vals)
    return seconds, np.array(rows, np.float32).reshape(-1, 9)
