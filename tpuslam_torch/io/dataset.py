"""Dataset input: KITTI-style dual-directory stereo reader + graph CSV IO.

Counterpart of tpuslam/io/dataset.py (the reference's Directory.cpp,
CameraStereoImages.cpp and Graph.cpp): the sorted directory scan with a
length-then-ASCII comparator, the stereo pair + timestamp + ground-truth
reader, KITTI ground-truth import with the optical-frame conjugation, and
the poses/links CSV save/load used for optimizer stage replay.  The text
code is tpuslam's.  Images are read without Pillow: `load_gray` gives what
Pillow's convert("L") gives (8-bit gray PNGs and PGMs through the native
decoder, every other PNG through io/png.py's `gray`) and resizes as
Pillow does (io/resize.py); `prefetch_iter` decodes ahead through the
native double-banked loader (io/native_loader.py), as tpuslam's does.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..geometry import transform as T
from . import png
from .native_loader import NativeStereoLoader, decode_image
from .resize import resize_bilinear

# KITTI GT conjugation frame (Graph.cpp:38-41) — equals the camera
# local transform: optical frame -> robot frame.
_P_CONJ = np.array([
    [0.0, 0.0, 1.0, 0.0],
    [-1.0, 0.0, 0.0, 0.0],
    [0.0, -1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
], dtype=np.float32)


def list_images(path: str) -> list[str]:
    """Sorted file listing: by length first, then ASCII (Directory.cpp:25-53)."""
    names = [n for n in os.listdir(path)
             if os.path.isfile(os.path.join(path, n))]
    return sorted(names, key=lambda s: (len(s), s))


def load_gray(path: str, do_resize: bool = False) -> np.ndarray:
    """Grayscale image load (CameraStereoImages.cpp:120-132), equal to
    tpuslam's Pillow `open(path).convert("L")`: 8-bit non-interlaced gray
    PNGs and binary PGMs through the native decoder, every other PNG (bit
    depths 1-16, colour and palette types, Adam7) through io/png.py's
    `gray`, with Pillow's rules.  `do_resize` resizes to 640x480 as
    tpuslam does, with Pillow's bilinear filter."""
    with open(path, "rb") as f:
        head = f.read(64)
    if head.startswith(png.SIGNATURE) and png.header(head)[2:] != (8, 0, 0):
        img = png.read_gray(path)
    else:
        img = decode_image(path)
    if do_resize:
        img = resize_bilinear(img, (640, 480))
    return img


def import_poses(path: str) -> list[np.ndarray]:
    """KITTI ground-truth poses with optical conjugation p*P*p^-1.

    reference: Graph.cpp:32-70.
    """
    poses = []
    p_inv = T.inverse(_P_CONJ)
    with open(path) as f:
        for line in f:
            vals = line.split()
            if len(vals) != 12:
                continue
            m = T.from_3x4([float(v) for v in vals])
            poses.append(T.compose(T.compose(_P_CONJ, m), p_inv))
    return poses


@dataclass
class StereoImageDataset:
    """KITTI-layout stereo sequence: image_0/, image_1/, times.txt, poses.

    reference: CameraStereoImages.cpp:33-118.
    """
    left_dir: str
    right_dir: str
    times_path: str | None = None
    gt_path: str | None = None
    do_resize: bool = False

    _left: list[str] = field(default_factory=list)
    _right: list[str] = field(default_factory=list)
    _stamps: list[float] = field(default_factory=list)
    _gt: list[np.ndarray] = field(default_factory=list)

    def __post_init__(self):
        self._left = list_images(self.left_dir)
        self._right = list_images(self.right_dir)
        if self.times_path and os.path.exists(self.times_path):
            with open(self.times_path) as f:
                self._stamps = [float(line.split(",")[0])
                                for line in f if line.strip()]
        if self.gt_path and os.path.exists(self.gt_path):
            self._gt = import_poses(self.gt_path)

    def __len__(self) -> int:
        return min(len(self._left), len(self._right))

    def ground_truth(self, i: int):
        return self._gt[i] if i < len(self._gt) else None

    def stamp(self, i: int) -> float:
        return self._stamps[i] if i < len(self._stamps) else float(i)

    def __getitem__(self, i: int):
        left = load_gray(os.path.join(self.left_dir, self._left[i]),
                         self.do_resize)
        right = load_gray(os.path.join(self.right_dir, self._right[i]),
                          self.do_resize)
        return {
            "id": i + 1,
            "stamp": self.stamp(i),
            "left": left,
            "right": right,
            "ground_truth": self.ground_truth(i),
        }

    def prefetch_iter(self, start: int = 0, end: int | None = None,
                      n_banks: int = 4, n_threads: int = 2):
        """Iterate items [start, end) through the native double-banked
        prefetch loader: `n_threads` decoder threads fill `n_banks` frame
        banks ahead of the consumer (the reference's A/B DDR bank scheme,
        FPGA.h:35-53), outside the GIL.  Each image is copied out of its
        bank before it is yielded.  Images that need resizing are read one
        by one, as tpuslam reads them."""
        end = len(self) if end is None else min(end, len(self))
        if self.do_resize:
            for i in range(start, end):
                yield self[i]
            return
        if start >= end:
            return
        loader = NativeStereoLoader(
            [os.path.join(self.left_dir, self._left[i])
             for i in range(start, end)],
            [os.path.join(self.right_dir, self._right[i])
             for i in range(start, end)], n_banks, n_threads)
        try:
            for k, left, right in loader:
                i = start + k
                yield {
                    "id": i + 1,
                    "stamp": self.stamp(i),
                    "left": np.array(left),
                    "right": np.array(right),
                    "ground_truth": self.ground_truth(i),
                }
        finally:
            loader.close()


# --------------------------------------------------------------------------
# Poses / links CSV (optimizer stage replay; Graph.cpp:72-175)
# --------------------------------------------------------------------------

def save_poses(path: str, poses: dict[int, np.ndarray]):
    with open(path, "w") as f:
        for nid in sorted(poses):
            t = poses[nid]
            row = [f"{t[r, c]:f}" for r in range(3) for c in range(4)]
            f.write(f"{nid}," + ",".join(row) + ",\n")


def load_poses(path: str) -> dict[int, np.ndarray]:
    poses = {}
    with open(path) as f:
        for line in f:
            vals = [v for v in line.strip().split(",") if v != ""]
            if len(vals) < 13:
                continue
            nid = int(vals[0])
            poses[nid] = T.from_3x4([float(v) for v in vals[1:13]])
    return poses


def save_links(path: str, links: list):
    """links: list of Link-like objects (from_id, to_id, type, transform,
    info 6x6).  CSV layout matches Graph.cpp:97-121."""
    with open(path, "w") as f:
        for link in links:
            t = link.transform
            row = [str(link.from_id), str(link.from_id), str(link.to_id),
                   str(int(link.type))]
            row += [f"{t[r, c]:f}" for r in range(3) for c in range(4)]
            row += [f"{v:f}" for v in np.asarray(link.info).reshape(-1)]
            f.write(",".join(row) + ",\n")


def load_links(path: str) -> list:
    from ..mapping.graph import Link  # local import to avoid cycle
    links = []
    with open(path) as f:
        for line in f:
            vals = [v for v in line.strip().split(",") if v != ""]
            if len(vals) < 4 + 12 + 36:
                continue
            from_id, to_id = int(vals[1]), int(vals[2])
            ltype = int(vals[3])
            t = T.from_3x4([float(v) for v in vals[4:16]])
            info = np.array([float(v) for v in vals[16:52]],
                            dtype=np.float64).reshape(6, 6)
            links.append(Link(from_id, to_id, ltype, t, info))
    return links
