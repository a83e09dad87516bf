"""Bilinear resize of an 8-bit gray image, bit-equal to Pillow's.

tpuslam's `load_gray(do_resize=True)` calls Pillow's
`Image.resize(size, BILINEAR)` on mode "L" (tpuslam/io/dataset.py:40-46).
The port has no Pillow, so this is a numpy twin of Pillow's
libImaging/Resample.c for 8-bit images:

- Coefficients in double: `scale = in / out`, `filterscale = max(scale,
  1)`, support `filterscale` (the triangle's 1.0 times it); output pixel
  xx has `center = (xx + 0.5) * scale`, taps from `xmin = max(int(center -
  support + 0.5), 0)` to `xmax = min(int(center + support + 0.5), in)`,
  each weighted by the triangle at `(x + xmin - center + 0.5) /
  filterscale`, then normalised by their sum taken in order.
- The weights rounded to integers of 22 fraction bits: `int(w * 2**22 +
  0.5)` (C truncation; `- 0.5` for a negative weight).
- Horizontal pass first, then vertical, each over uint8:
  `clip8((2**21 + sum k * in) >> 22)`; a pass whose size is unchanged is
  skipped.

Shrinking averages over a wider window than cv::resize's INTER_LINEAR does
(tpuslam's comment names cv::resize, but Pillow is what it runs).
"""

from __future__ import annotations

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _coefficients(in_size: int, out_size: int):
    """(first tap (out,), integer weights (out, taps)) of one axis, as
    Resample.c's precompute_coeffs and normalize_coeffs_8bpc make them;
    weights past a pixel's own taps are 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64),
                      in_size) - xmin
    x = np.arange(ksize)
    t = np.abs((x[None, :] + xmin[:, None] - center[:, None] + 0.5) *
               (1.0 / filterscale))
    w = np.where((t < 1.0) & (x[None, :] < xmax[:, None]), 1.0 - t, 0.0)
    ww = np.zeros(out_size)
    for k in range(ksize):           # the sum in Resample.c's order
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None],
                 w)
    fixed = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, k


def _pass(img: np.ndarray, out_size: int) -> np.ndarray:
    """Resample the last axis of (rows, in) uint8 to (rows, out_size)."""
    xmin, k = _coefficients(img.shape[-1], out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None, :],
                     img.shape[-1] - 1)
    acc = (img[:, idx].astype(np.int64) * k[None]).sum(axis=-1)
    acc += 1 << (PRECISION_BITS - 1)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W) uint8 -> (height, width) uint8 for size = (width, height),
    as Pillow's `Image.fromarray(img).resize(size, Image.BILINEAR)`."""
    img = np.asarray(img, np.uint8)
    if img.ndim != 2:
        raise ValueError(f"expected an (H, W) image, got {img.shape}")
    width, height = size
    if width < 1 or height < 1:
        raise ValueError(f"size {size}: width and height must be >= 1")
    out = img
    if width != img.shape[1]:
        out = _pass(out, width)
    if height != img.shape[0]:
        out = _pass(out.T, height).T
    return np.ascontiguousarray(out)
