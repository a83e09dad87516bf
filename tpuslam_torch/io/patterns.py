"""Synthetic test-pattern generators (fault-injection fixtures).

A copy of tpuslam/io/patterns.py (numpy only).  Twins of the FPGA
pattern generators the reference uses for hardware fault injection:
enum PATTERN_SELECT (src/slam/include/core/Parameters.h:61-68) and the
CSI pattern registers (include/core/FPGA.h:100-104): HORIZ_INCR,
VERT_INCR, FRAME_INCR, COLOR_BAR (grayscale bars here), GRID.  Used to
exercise kernels with exactly-known inputs.
"""

from __future__ import annotations

import numpy as np

PATTERN_NORMAL = 0
PATTERN_HORIZ_INCR = 1
PATTERN_VERT_INCR = 2
PATTERN_FRAME_INCR = 3
PATTERN_COLOR_BAR = 4
PATTERN_GRID = 5


def generate_pattern(pattern: int, height: int = 480, width: int = 640,
                     frame_index: int = 0) -> np.ndarray:
    """(H,W) uint8 test frame for the given PATTERN_SELECT code."""
    if pattern == PATTERN_HORIZ_INCR:
        return np.broadcast_to(
            (np.arange(width) % 256).astype(np.uint8)[None, :],
            (height, width)).copy()
    if pattern == PATTERN_VERT_INCR:
        return np.broadcast_to(
            (np.arange(height) % 256).astype(np.uint8)[:, None],
            (height, width)).copy()
    if pattern == PATTERN_FRAME_INCR:
        return np.full((height, width), frame_index % 256, np.uint8)
    if pattern == PATTERN_COLOR_BAR:
        bar = (np.arange(width) * 8 // width) * 255 // 7
        return np.broadcast_to(bar.astype(np.uint8)[None, :],
                               (height, width)).copy()
    if pattern == PATTERN_GRID:
        img = np.zeros((height, width), np.uint8)
        img[::32, :] = 255
        img[:, ::32] = 255
        return img
    raise ValueError(f"unknown pattern {pattern}")
