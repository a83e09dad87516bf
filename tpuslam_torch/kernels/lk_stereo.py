"""Pyramidal Lucas-Kanade stereo correspondence (epipolar-constrained), in
plain PyTorch.

Counterpart of tpuslam/kernels/lk_stereo.py, the twin of
calcOpticalFlowPyrLKStereo (CvLKStereo.cpp:20-407: OpenCV's pyramidal LK
with the update's y-component forced to zero), used by the
DEPTH_METHOD_CV_LK sparse-depth option (Stereo.cpp:9-51: window 15x3,
maxLevel 5, 30 iterations, eps 0.01, minEig 1e-4, disparity gate (0.5,
128]).  tpuslam computes it in XLA (vmap over points, fori_loop), so this
port is plain PyTorch on both devices: the vmap over points becomes
batched gathers with (N, wh+1, ww+1) index tensors, the 30-iteration
fori_loop a Python loop with per-point masks.  The W_BITS = 14
fixed-point bilinear interpolation and CV_DESCALE rounding are integer.

Where the translation could drift:
  * the pyramid's 5-tap blur: its products and sums are exact in f32
    (multiples of 1/256 below 256), so XLA's FMA contraction on the CPU
    leaves it unchanged; `round` is half-to-even in both frameworks;
  * the 2x2 system in f32: XLA's CPU backend contracts `A11*A22 -
    A12*A12`, the discriminant `(A11-A22)**2 + 4*A12*A12` and the
    update's numerator `A12*b2 - A22*b1` into fused multiply-adds (the
    first product unrounded) and divides by 2*ww*wh as a multiply by its
    f32 reciprocal.  `_fma` takes those steps in f64 and rounds once to
    f32, so the tracker equals tpuslam's on the CPU, and the card's run
    the CPU's; a point near a threshold of the ill-conditioned system
    would otherwise diverge by pixels over 30 iterations and 6 levels;
  * `min_eig`'s square root is taken in f64 and rounded to f32: the
    CPU's f32 torch.sqrt is not correctly rounded (ROADMAP C);
  * `jnp.pad(mode="reflect")` is reflect-101, as F.pad's "reflect";
  * `jax.lax.dynamic_slice` clamps an out-of-range start; the corners
    are clipped first, as tpuslam clips them, so no clamp is needed.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

W_BITS = 14
FLT_SCALE = 1.0 / (1 << 20)
_K5 = (1 / 16, 4 / 16, 6 / 16, 4 / 16, 1 / 16)


def _descale(x: torch.Tensor, n: int) -> torch.Tensor:
    return (x + (1 << (n - 1))) >> n


def _reflect101_pad(img: torch.Tensor, py: int, px: int) -> torch.Tensor:
    """(H, W) padded by py rows and px columns, reflect-101."""
    return F.pad(img[None, None], (px, px, py, py), mode="reflect")[0, 0]


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV pyrDown of (H, W) uint8: the 5-tap Gaussian [1,4,6,4,1]/16,
    separable, reflect-101 borders, then every second row and column,
    rounded half to even as tpuslam rounds."""
    x = img.to(torch.float32)
    h, w = x.shape
    xp = _reflect101_pad(x, 2, 2)
    r = sum(_K5[i] * xp[i:i + h, 2:2 + w] for i in range(5))
    rp = _reflect101_pad(r, 0, 2)
    c = sum(_K5[i] * rp[:, i:i + w] for i in range(5))
    return torch.clamp(torch.round(c[::2, ::2]), 0, 255).to(torch.uint8)


def scharr_deriv(img: torch.Tensor) -> torch.Tensor:
    """OpenCV calcScharrDeriv: (H, W, 2) int16 [dx, dy]; smoothing taps
    (3, 10, 3), difference (-1, 0, 1); reflect-101 borders."""
    x = img.to(torch.int32)
    xp = _reflect101_pad(x, 1, 1)
    h, w = x.shape

    def shift(dy, dx):
        return xp[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    dxv = (3 * (shift(-1, 1) - shift(-1, -1))
           + 10 * (shift(0, 1) - shift(0, -1))
           + 3 * (shift(1, 1) - shift(1, -1)))
    dyv = (3 * (shift(1, -1) - shift(-1, -1))
           + 10 * (shift(1, 0) - shift(-1, 0))
           + 3 * (shift(1, 1) - shift(-1, 1)))
    return torch.stack([dxv, dyv], dim=-1).to(torch.int16)


def build_lk_pyramid(img: torch.Tensor, max_level: int):
    """[(image uint8, Scharr int16 (H, W, 2)) per level]."""
    levels = []
    cur = img
    for _ in range(max_level + 1):
        levels.append((cur, scharr_deriv(cur)))
        cur = pyr_down(cur)
    return levels


def _interp_weights(a: torch.Tensor, b: torch.Tensor):
    one = 1 << W_BITS
    iw00 = torch.round((1.0 - a) * (1.0 - b) * one).to(torch.int32)
    iw01 = torch.round(a * (1.0 - b) * one).to(torch.int32)
    iw10 = torch.round((1.0 - a) * b * one).to(torch.int32)
    iw11 = one - iw00 - iw01 - iw10
    return iw00, iw01, iw10, iw11


def _patches(img: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor,
             wh: int, ww: int, pad: int) -> torch.Tensor:
    """(N, wh+1, ww+1) int32 patches at integer corners (iy, ix) (N,) from
    an image padded by `pad` on each side."""
    dev = img.device
    rows = (iy + pad)[:, None] + torch.arange(wh + 1, device=dev)
    cols = (ix + pad)[:, None] + torch.arange(ww + 1, device=dev)
    return img[rows[:, :, None], cols[:, None, :]].to(torch.int32)


def _bilin(p: torch.Tensor, w, shift_bits: int) -> torch.Tensor:
    w00, w01, w10, w11 = (t[:, None, None] for t in w)
    v = (p[:, :-1, :-1] * w00 + p[:, :-1, 1:] * w01
         + p[:, 1:, :-1] * w10 + p[:, 1:, 1:] * w11)
    return _descale(v, shift_bits)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c of f32 tensors with one rounding to f32 (the product is
    exact in f64), as a fused multiply-add."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _isum(x: torch.Tensor) -> torch.Tensor:
    """The (N,) window sums of (N, h, w) int32, as f32 scaled by
    FLT_SCALE (tpuslam sums in int32; no sum here reaches 2**31)."""
    return x.sum(dim=(1, 2), dtype=torch.int32).to(torch.float32) * FLT_SCALE


def lk_stereo(left, right, pts, valid, win: tuple[int, int] = (15, 3),
              max_level: int = 5, max_iters: int = 30, eps: float = 0.01,
              min_eig_threshold: float = 1e-4, device="cuda"):
    """Track left-image points to the right image along x, on `device`
    (the card unless the caller asks for the CPU).

    left, right: (H, W) uint8; pts: (N, 2) float32 left coordinates, of
    which `valid` (N,) marks the real entries.  Returns (next_pts (N, 2),
    status (N,) bool, err (N,) = the minimum eigenvalue, as with
    OPTFLOW_LK_GET_MIN_EIGENVALS), tensors on `device`."""
    left = torch.as_tensor(left, device=device)
    right = torch.as_tensor(right, device=device)
    pts = torch.as_tensor(pts, dtype=torch.float32, device=device)
    valid = torch.as_tensor(valid, device=device)
    ww, wh = win
    half_x = (ww - 1) * 0.5
    half_y = (wh - 1) * 0.5
    eps2 = float(min(max(eps, 0.0), 10.0)) ** 2

    pad = max(ww, wh) + 2
    pyr_l = [(F.pad(i, (pad, pad, pad, pad)),
              F.pad(d.permute(2, 0, 1), (pad, pad, pad, pad)))
             for i, d in build_lk_pyramid(left, max_level)]
    pyr_r = [F.pad(i, (pad, pad, pad, pad))
             for i, _ in build_lk_pyramid(right, max_level)]

    n = pts.shape[0]
    status = valid.to(torch.bool)
    err = torch.zeros((n,), dtype=torch.float32, device=device)
    next_x = torch.zeros((n,), dtype=torch.float32, device=device)

    for level in range(max_level, -1, -1):
        I_img, I_deriv = pyr_l[level]
        J_img = pyr_r[level]
        rows = I_img.shape[0] - 2 * pad
        cols = I_img.shape[1] - 2 * pad

        prev = pts * (1.0 / (1 << level))
        px, py = prev[:, 0], prev[:, 1]
        nx0 = px if level == max_level else next_x * 2.0

        # the patches at prevPt (CvLKStereo.cpp:205-280)
        fx = px - half_x
        fy = py - half_y
        ipx = torch.floor(fx).to(torch.int32)
        ipy = torch.floor(fy).to(torch.int32)
        inb = (ipx >= -ww) & (ipx < cols) & (ipy >= -wh) & (ipy < rows)
        # clipped as tpuslam clips them before its dynamic_slice
        ipx_c = torch.clamp(ipx, -pad + 1, cols + pad - ww - 2)
        ipy_c = torch.clamp(ipy, -pad + 1, rows + pad - wh - 2)
        wts = _interp_weights(fx - ipx, fy - ipy)
        iwin = _bilin(_patches(I_img, ipy_c, ipx_c, wh, ww, pad), wts,
                      W_BITS - 5)                     # 5 fraction bits
        ixwin = _bilin(_patches(I_deriv[0], ipy_c, ipx_c, wh, ww, pad), wts,
                       W_BITS)
        iywin = _bilin(_patches(I_deriv[1], ipy_c, ipx_c, wh, ww, pad), wts,
                       W_BITS)

        A11 = _isum(ixwin * ixwin)
        A12 = _isum(ixwin * iywin)
        A22 = _isum(iywin * iywin)
        D = _fma(A11, A22, -(A12 * A12))
        dA = A11 - A22
        root = torch.sqrt(_fma(dA, dA, 4.0 * A12 * A12).double()
                          ).to(torch.float32)
        min_eig = (A22 + A11 - root) * np.float32(1.0 / (2.0 * ww * wh))
        good = (min_eig >= min_eig_threshold) & (D >= 1.1920929e-07)
        Dinv = torch.where(good, 1.0 / torch.where(good, D, 1.0), 0.0)

        # the refinement (CvLKStereo.cpp:298-362), every point at once
        nx_c = nx0
        conv = torch.zeros((n,), dtype=torch.bool, device=device)
        oob = torch.zeros_like(conv)
        prev_dx = torch.zeros_like(nx0)
        gy = py - half_y
        iny = torch.floor(gy).to(torch.int32)
        iny_c = torch.clamp(iny, -pad + 1, rows + pad - wh - 2)
        for j in range(max_iters):
            gx = nx_c - half_x
            inx = torch.floor(gx).to(torch.int32)
            inb_j = (inx >= -ww) & (inx < cols) & (iny >= -wh) & (iny < rows)
            inx_c = torch.clamp(inx, -pad + 1, cols + pad - ww - 2)
            jwin = _bilin(_patches(J_img, iny_c, inx_c, wh, ww, pad),
                          _interp_weights(gx - inx, gy - iny), W_BITS - 5)
            diff = jwin - iwin
            b1 = _isum(diff * ixwin)
            b2 = _isum(diff * iywin)
            # y forced to 0: the stereo modification
            dxv = _fma(A12, b2, -(A22 * b1)) * Dinv
            active = ~conv & ~oob & inb_j
            oob = oob | (~inb_j & ~conv)
            nx_n = torch.where(active, nx_c + dxv, nx_c)
            converged = dxv * dxv <= eps2
            if j > 0:
                oscill = (dxv + prev_dx).abs() < 0.01
            else:
                oscill = torch.zeros_like(conv)
            nx_c = torch.where(active & oscill & ~converged,
                               nx_n - dxv * 0.5, nx_n)
            conv = conv | (active & (converged | oscill))
            prev_dx = torch.where(active, dxv, prev_dx)

        nx_out = torch.where(good, nx_c, nx0)
        # a point whose prev window left the image stops tracking; at
        # level 0 that clears its status (CvLKStereo.cpp:210-224)
        next_x = torch.where(inb, nx_out, nx0)
        if level == 0:
            status = status & inb & good & ~oob
            err = min_eig

    return torch.stack([next_x, pts[:, 1]], dim=-1), status, err


def compute_correspondences(left, right, left_pts, valid,
                            min_disparity: float = 0.5,
                            max_disparity: float = 128.0, device="cuda"):
    """Stereo.cpp:9-51 twin: the LK track on `device` and the disparity
    gate (min_disparity, max_disparity].  Returns numpy (next_pts,
    status, err)."""
    next_pts, status, err = lk_stereo(left, right, left_pts, valid,
                                      device=device)
    next_pts = next_pts.cpu().numpy()
    disp = np.asarray(left_pts)[:, 0] - next_pts[:, 0]
    status = status.cpu().numpy() & (disp > min_disparity) & \
        (disp <= max_disparity)
    return next_pts, status, err.cpu().numpy()
