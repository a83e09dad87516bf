"""Writing a rendered log as a KITTI odometry directory: image_0/ and
image_1/ PNG files, calib.txt and times.txt.

The PNG encoder is a frozen copy of tpuslam_torch/io/png.py's `encode`
(each row under the filter whose output has the least sum of absolute
values as signed bytes, as libpng and Pillow choose), and `write_pngs` a
copy of chip_smoke.py's (8 threads: zlib and numpy release the GIL).
"""

from __future__ import annotations

import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload +
            struct.pack(">I", zlib.crc32(kind + payload)))


def _filtered(img: np.ndarray) -> np.ndarray:
    """(5, H, W) uint8: every row under each of the five PNG filters."""
    x = img.astype(np.int16)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return (np.stack([x, x - a, x - b, x - ((a + b) >> 1), x - paeth]) &
            255).astype(np.uint8)


def encode(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) uint8 image -> 8-bit grayscale PNG file bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    cand = _filtered(img)
    kind = np.minimum(cand, 256 - cand.astype(np.int32)).sum(axis=2) \
        .argmin(axis=0)
    rows = np.empty((h, w + 1), np.uint8)
    rows[:, 0] = kind
    rows[:, 1:] = cand[kind, np.arange(h)]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr) +
            _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) +
            _chunk(b"IEND", b""))


def _write(path_img) -> None:
    path, img = path_img
    with open(path, "wb") as fh:
        fh.write(encode(img))


def write_pngs(paths_imgs, threads: int = 8) -> None:
    """Write each (path, (H, W) uint8 image) as a PNG file."""
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(_write, paths_imgs))


def write_calib(out_dir: str, w: int, h: int, f: float,
                baseline: float) -> str:
    """calib.txt of a rectified pair with the principal point at the
    image centre (P0 left, P1 right); returns its path."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    p0 = [f, 0.0, cx, 0.0, 0.0, f, cy, 0.0, 0.0, 0.0, 1.0, 0.0]
    p1 = list(p0)
    p1[3] = -f * baseline
    path = os.path.join(out_dir, "calib.txt")
    with open(path, "w") as fh:
        fh.write("P0: " + " ".join(f"{v:.12e}" for v in p0) + "\n")
        fh.write("P1: " + " ".join(f"{v:.12e}" for v in p1) + "\n")
    return path


def write_kitti(out_dir: str, left: np.ndarray, right: np.ndarray,
                f: float, baseline: float, threads: int = 8):
    """Write (N, H, W) uint8 left and right images as a KITTI odometry
    directory at 10 Hz.  Returns (left paths, right paths, stamps,
    calib.txt's path)."""
    n, h, w = left.shape
    paths = {}
    for sub in ("image_0", "image_1"):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        paths[sub] = [os.path.join(out_dir, sub, f"{i:06d}.png")
                      for i in range(n)]
    write_pngs(list(zip(paths["image_0"], left)) +
               list(zip(paths["image_1"], right)), threads)
    calib = write_calib(out_dir, w, h, f, baseline)
    stamps = [float(f"{i * 0.1:.6e}") for i in range(n)]
    with open(os.path.join(out_dir, "times.txt"), "w") as fh:
        fh.writelines(f"{s:.6e}\n" for s in stamps)
    return paths["image_0"], paths["image_1"], stamps, calib
