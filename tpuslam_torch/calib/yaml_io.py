"""Calibration YAML output.

A copy of tpuslam/calib/yaml_io.py (numpy only).

Writes both formats the reference ecosystem uses:
  * OpenCV-FileStorage matrices (intrinsics.yml / extrinsics.yml),
    matching stereo_calib.cpp:303-316's M1/D1/M2/D2 and R/T/R1/R2/P1/P2/Q
  * per-camera ROS-style files (image_width / image_height /
    rectification_matrix / projection_matrix) which the SLAM app's
    StereoCameraModel.load consumes (StereoCameraModel.cpp:27-66)
"""

from __future__ import annotations

import numpy as np


def _mat_yaml(name: str, m: np.ndarray) -> str:
    m = np.asarray(m, np.float64)
    data = ", ".join(f"{v:.12e}" for v in m.reshape(-1))
    return (f"{name}: !!opencv-matrix\n"
            f"   rows: {m.shape[0]}\n"
            f"   cols: {m.shape[1] if m.ndim > 1 else 1}\n"
            f"   dt: d\n"
            f"   data: [ {data} ]\n")


def write_opencv_yaml(path: str, mats: dict[str, np.ndarray]) -> None:
    with open(path, "w") as f:
        f.write("%YAML:1.0\n---\n")
        for name, m in mats.items():
            f.write(_mat_yaml(name, np.atleast_2d(m)))


def read_opencv_yaml(path: str) -> dict[str, np.ndarray]:
    import re
    text = open(path).read()
    out = {}
    for m in re.finditer(
            r"(\w+): !!opencv-matrix\s*\n\s*rows: (\d+)\s*\n\s*cols: "
            r"(\d+)\s*\n\s*dt: \w+\s*\n\s*data: \[([^\]]*)\]", text):
        name, rows, cols, data = m.groups()
        vals = [float(v) for v in data.replace("\n", " ").split(",")]
        out[name] = np.array(vals).reshape(int(rows), int(cols))
    return out


def write_camera_info_yaml(path: str, width: int, height: int,
                           P: np.ndarray, R: np.ndarray,
                           K: np.ndarray | None = None,
                           D: np.ndarray | None = None,
                           name: str = "camera") -> None:
    """ROS camera_info-style YAML readable by StereoCameraModel."""
    def block(tag, m):
        m = np.asarray(m, np.float64)
        data = ", ".join(f"{v:.12f}" for v in m.reshape(-1))
        return (f"{tag}:\n  rows: {m.shape[0]}\n  cols: {m.shape[1]}\n"
                f"  data: [{data}]\n")

    with open(path, "w") as f:
        f.write(f"image_width: {width}\nimage_height: {height}\n")
        f.write(f"camera_name: {name}\n")
        if K is not None:
            f.write(block("camera_matrix", K))
        if D is not None:
            f.write(block("distortion_coefficients",
                          np.asarray(D).reshape(1, -1)))
        f.write(block("rectification_matrix", R))
        f.write(block("projection_matrix", P))


def q_matrix(P1: np.ndarray, P2: np.ndarray) -> np.ndarray:
    """Disparity-to-depth Q from rectified projections (stereoRectify)."""
    f = P1[0, 0]
    cx, cy = P1[0, 2], P1[1, 2]
    cx2 = P2[0, 2]
    Tx = P2[0, 3] / f
    return np.array([
        [1, 0, 0, -cx],
        [0, 1, 0, -cy],
        [0, 0, 0, f],
        [0, 0, -1.0 / Tx, (cx - cx2) / Tx]])
