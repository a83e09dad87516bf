"""Stereo rectification: the inverse remap maps (host numpy) and the
bilinear warp, in plain PyTorch.

Counterpart of tpuslam/kernels/rectify.py, the re-design of the
reference's rectification stage:

  * map generation, the reference's src/StereoBM/src/fpga.c:303-366
    (`rect_remap`): for every destination pixel, un-project through the
    rectified intrinsics, rotate by the transposed rectification rotation
    and re-project through the original intrinsics, in s.24 fixed point;
    maps as int16 with 5 fraction bits.  `RectCamera`, `REFERENCE_CALIB`,
    `rect_map_fixed` and `rect_map_float` are numpy, copied verbatim;
  * the bilinear warp, the reference's src/dvp/rtl/rect_intp.v:330-412:
    u1.5 weights, u1.10 weight products, u8.10 accumulation, truncate to
    u8.1, +1 round, saturate to u8.0.  `remap_bilinear_hw` is integer and
    equals tpuslam's bit for bit; `remap_bilinear`, the float warp for new
    calibrations, agrees to f32 rounding (XLA's CPU backend contracts its
    multiply-adds).

tpuslam warps with an XLA gather (no Pallas kernel), so the warp is plain
PyTorch on both devices.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

FRAC_BITS = 5            # map fractional bits (rect_remap output, u1.5 warp)
FRAC_ONE = 1 << FRAC_BITS


@dataclass
class RectCamera:
    """One camera's fixed-point rectification parameters.

    Field scaling follows struct RECT_PARAM (fpga.c:181-227):
      f      : original focal length, u10.16
      c      : original principal point, integer pixels
      f2inv  : 1/f_rect, u-8.32
      c2_f2  : c_rect/f_rect, u0.24
      rot    : rectification rotation (original->rectified), s1.24
    """
    f: tuple[int, int]
    c: tuple[int, int]
    f2inv: tuple[int, int]
    c2_f2: tuple[int, int]
    rot: np.ndarray  # (3,3) int64

    @classmethod
    def from_float(cls, f, c, f_rect, c_rect, R) -> "RectCamera":
        """Quantize a float calibration into the firmware's fixed point."""
        return cls(
            f=(int(round(f[0] * (1 << 16))), int(round(f[1] * (1 << 16)))),
            c=(int(round(c[0])), int(round(c[1]))),
            f2inv=(int(round((1.0 / f_rect[0]) * (1 << 32))),
                   int(round((1.0 / f_rect[1]) * (1 << 32)))),
            c2_f2=(int(round((c_rect[0] / f_rect[0]) * (1 << 24))),
                   int(round((c_rect[1] / f_rect[1]) * (1 << 24)))),
            rot=np.round(np.asarray(R, np.float64) * (1 << 24)).astype(
                np.int64),
        )


# The reference firmware's baked-in calibration ("Data set 220426",
# fpga.c:190-227) — the rig that produced the golden sim data.
REFERENCE_CALIB = (
    RectCamera(f=(40419817, 40382910), c=(320, 240),
               f2inv=(6338213, 6338213), c2_f2=(4984405, 5932596),
               rot=np.array([[16598538, -120818, 2439034],
                             [137992, 16776300, -108069],
                             [-2438123, 126979, 16598626]], np.int64)),
    RectCamera(f=(39609530, 39627967), c=(320, 240),
               f2inv=(6338213, 6338213), c2_f2=(4984405, 5932596),
               rot=np.array([[16569087, -69780, 2633522],
                             [51223, 16776692, 122251],
                             [-2633948, -112694, 16568783]], np.int64)),
)


def rect_map_fixed(cam: RectCamera, height: int,
                   width: int) -> tuple[np.ndarray, np.ndarray]:
    """Bit-exact vectorized twin of rect_remap (fpga.c:303-366).

    Returns (map_x, map_y) int16, 5 fractional bits: the *source*
    coordinate sampled for each destination pixel.
    """
    xdst = np.arange(width, dtype=np.int64)[None, :]
    ydst = np.arange(height, dtype=np.int64)[:, None]

    # (u10.0)*(u-8.32) >> 8 = u1.24 ; minus c2/f2 (u0.24) -> s1.24
    xd = ((xdst * cam.f2inv[0]) >> 8) - cam.c2_f2[0]
    yd = ((ydst * cam.f2inv[1]) >> 8) - cam.c2_f2[1]

    r = cam.rot
    # R^T @ [xd, yd, 1]: (s.24 * s1.24) >> 24, summed
    lx = ((r[0, 0] * xd) >> 24) + ((r[1, 0] * yd) >> 24) + r[2, 0]
    ly = ((r[0, 1] * xd) >> 24) + ((r[1, 1] * yd) >> 24) + r[2, 1]
    lw = ((r[0, 2] * xd) >> 24) + ((r[1, 2] * yd) >> 24) + r[2, 2]

    lw_inv = (1 << 48) // lw                      # s1.24 reciprocal
    x2 = (lx * lw_inv) >> 24
    y2 = (ly * lw_inv) >> 24

    x_fx = (x2 * cam.f[0]) >> 34                  # s10.6
    y_fy = (y2 * cam.f[1]) >> 34
    x_out = (x_fx + (cam.c[0] << 6) + 1) >> 1     # round to 5 frac bits
    y_out = (y_fy + (cam.c[1] << 6) + 1) >> 1
    return x_out.astype(np.int16), np.broadcast_to(
        y_out, (height, width)).astype(np.int16).copy()


def rect_map_float(f, c, f_rect, c_rect, R, height: int,
                   width: int) -> tuple[np.ndarray, np.ndarray]:
    """Float inverse rectification map (same geometry, full precision).

    R maps original-camera rays to rectified rays (OpenCV R1/R2
    convention), matching the firmware's R^T application.
    """
    x = (np.arange(width, dtype=np.float64) - c_rect[0]) / f_rect[0]
    y = (np.arange(height, dtype=np.float64) - c_rect[1]) / f_rect[1]
    xx, yy = np.meshgrid(x, y)
    rays = np.stack([xx, yy, np.ones_like(xx)], axis=-1)
    src = rays @ np.asarray(R, np.float64)        # == (R^T @ ray)^T
    sx = src[..., 0] / src[..., 2] * f[0] + c[0]
    sy = src[..., 1] / src[..., 2] * f[1] + c[1]
    return sx.astype(np.float32), sy.astype(np.float32)


def _corners(img: torch.Tensor, x0: torch.Tensor, y0: torch.Tensor):
    """The (valid mask, ul, ur, dl, dr) of a 2x2 source neighbourhood per
    destination pixel; neighbourhoods that leave the (..., H, W) image are
    invalid and read clipped corners."""
    h, w = img.shape[-2:]
    valid = (x0 >= 0) & (y0 >= 0) & (x0 + 1 <= w - 1) & (y0 + 1 <= h - 1)
    x0c = torch.clamp(x0, 0, w - 2).long()
    y0c = torch.clamp(y0, 0, h - 2).long()
    return valid, img[..., y0c, x0c], img[..., y0c, x0c + 1], \
        img[..., y0c + 1, x0c], img[..., y0c + 1, x0c + 1]


def remap_bilinear_hw(img: torch.Tensor, map_x: torch.Tensor,
                      map_y: torch.Tensor) -> torch.Tensor:
    """Integer bilinear warp of (..., H, W) uint8, bit-exact with
    rect_intp.v:330-412.

    map_x/map_y: int16 source coordinates with 5 fraction bits.  Output
    pixels whose 2x2 source neighbourhood leaves the image are 0."""
    mx = map_x.to(torch.int32)
    my = map_y.to(torch.int32)
    xf = mx & (FRAC_ONE - 1)
    yf = my & (FRAC_ONE - 1)
    xfi = FRAC_ONE - xf
    yfi = FRAC_ONE - yf
    valid, ul, ur, dl, dr = _corners(img.to(torch.int32), mx >> FRAC_BITS,
                                     my >> FRAC_BITS)
    # u8.0 * u1.10 accumulation (the weights sum to 1024)
    acc = (ul * (xfi * yfi) + ur * (xf * yfi)
           + dl * (xfi * yf) + dr * (xf * yf))
    out = torch.clamp(((acc >> 9) + 1) >> 1, max=255)  # u8.1 +1 -> u8.0
    return torch.where(valid, out, 0).to(torch.uint8)


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Float bilinear warp of (..., H, W) by f32 maps (the idiomatic path
    for new calibrations); f32 out, 0 outside."""
    x0 = torch.floor(map_x).to(torch.int32)
    y0 = torch.floor(map_y).to(torch.int32)
    xf = map_x - x0
    yf = map_y - y0
    valid, ul, ur, dl, dr = _corners(img.to(torch.float32), x0, y0)
    out = (ul * (1 - xf) * (1 - yf) + ur * xf * (1 - yf)
           + dl * (1 - xf) * yf + dr * xf * yf)
    return torch.where(valid, out, 0.0)


class StereoRectifier:
    """Per-rig rectifier: maps computed once on the host and held on
    `device` (the card unless the caller asks for the CPU), the per-frame
    warp there.  Takes (H, W) or batched (..., H, W) frames, numpy or
    tensors."""

    def __init__(self, maps_l, maps_r, device="cuda"):
        self.device = torch.device(device)
        self._mx_l, self._my_l, self._mx_r, self._my_r = (
            torch.as_tensor(np.asarray(m), device=self.device)
            for m in (*maps_l, *maps_r))
        self._fixed = self._mx_l.dtype == torch.int16

    @classmethod
    def from_reference_calib(cls, height: int = 480, width: int = 640,
                             device="cuda") -> "StereoRectifier":
        return cls(rect_map_fixed(REFERENCE_CALIB[0], height, width),
                   rect_map_fixed(REFERENCE_CALIB[1], height, width),
                   device=device)

    def __call__(self, left, right):
        warp = remap_bilinear_hw if self._fixed else remap_bilinear
        return (warp(torch.as_tensor(left, device=self.device), self._mx_l,
                     self._my_l),
                warp(torch.as_tensor(right, device=self.device), self._mx_r,
                     self._my_r))
