"""Per-frame debug dump functions.

Counterpart of tpuslam/runtime/dumps.py: twins of the seven SensorData
dump hooks (the reference's src/slam/src/core/SensorData.cpp:135-263):
saveRectImagePair, saveDepthImage, saveEigenvalue, saveKpts2d,
saveKpts3d, saveDescriptor, saveRectImageKpts.  Used by the capture and
kernel-test apps for stage-by-stage inspection and A/B diffing.  Every
function but `_save_gray` is tpuslam's, copied (numpy on the host); the
PNGs are written by io/png.py instead of Pillow, after the same
truncating `np.asarray(img, np.uint8)` conversion, so they decode to
tpuslam's images, and the CSVs are written byte for byte as tpuslam
writes them.
"""

from __future__ import annotations

import os

import numpy as np


def _save_gray(path: str, img: np.ndarray):
    from ..io.png import write_png
    write_png(path, np.asarray(img, np.uint8))


def save_rect_image_pair(dirname: str, idx: int, left, right):
    os.makedirs(dirname, exist_ok=True)
    _save_gray(os.path.join(dirname, f"rect_l_{idx:06d}.png"), left)
    _save_gray(os.path.join(dirname, f"rect_r_{idx:06d}.png"), right)


def save_depth_image(dirname: str, idx: int, disparity: np.ndarray,
                     num_disparities: int = 64):
    """x16 int16 disparity -> 8-bit visualization (SensorData.cpp
    saveDepthImage: scaled to the disparity range)."""
    os.makedirs(dirname, exist_ok=True)
    d = np.asarray(disparity, np.float32) / 16.0
    img = np.clip(d * (255.0 / num_disparities), 0, 255)
    _save_gray(os.path.join(dirname, f"depth_{idx:06d}.png"), img)


def save_eigenvalue(dirname: str, idx: int, eig: np.ndarray):
    os.makedirs(dirname, exist_ok=True)
    e = np.asarray(eig, np.float32)
    mx = e.max() if e.size else 1.0
    img = np.clip(e / max(mx, 1e-9) * 255.0, 0, 255)
    _save_gray(os.path.join(dirname, f"eig_{idx:06d}.png"), img)


def save_kpts2d(dirname: str, idx: int, kpts: np.ndarray):
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, f"kpts2d_{idx:06d}.csv"), "w") as f:
        for k in np.asarray(kpts):
            f.write(",".join(f"{v:.6f}" for v in k) + "\n")


def save_kpts3d(dirname: str, idx: int, kpts3d: np.ndarray):
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, f"kpts3d_{idx:06d}.csv"), "w") as f:
        for k in np.asarray(kpts3d):
            f.write(",".join(f"{v:.6f}" for v in k) + "\n")


def save_descriptor(dirname: str, idx: int, desc: np.ndarray):
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, f"desc_{idx:06d}.csv"), "w") as f:
        for row in np.asarray(desc, np.uint8):
            f.write(",".join(str(int(v)) for v in row) + "\n")


def save_rect_image_kpts(dirname: str, idx: int, img: np.ndarray,
                         kpts: np.ndarray, cross: int = 3):
    """Rectified image with keypoint crosses burned in."""
    os.makedirs(dirname, exist_ok=True)
    out = np.asarray(img, np.uint8).copy()
    h, w = out.shape
    for k in np.asarray(kpts):
        x, y = int(k[0]), int(k[1])
        if 0 <= x < w and 0 <= y < h:
            x0, x1 = max(0, x - cross), min(w, x + cross + 1)
            y0, y1 = max(0, y - cross), min(h, y + cross + 1)
            out[y, x0:x1] = 255
            out[y0:y1, x] = 255
    _save_gray(os.path.join(dirname, f"kpts_{idx:06d}.png"), out)


def dump_frame(dirname: str, idx: int, frame, eig=None):
    """All seven hooks for one Frame (stubs at main.cpp:257-266)."""
    if frame.image_left is not None and frame.image_right is not None:
        save_rect_image_pair(dirname, idx, frame.image_left,
                             frame.image_right)
        save_rect_image_kpts(dirname, idx, frame.image_left, frame.kpts)
    if frame.disparity is not None:
        save_depth_image(dirname, idx, frame.disparity)
    if eig is not None:
        save_eigenvalue(dirname, idx, eig)
    save_kpts2d(dirname, idx, frame.kpts)
    save_kpts3d(dirname, idx, frame.kpts3d)
    save_descriptor(dirname, idx, frame.desc)
