"""ORB descriptors at constant keypoint angle: plain PyTorch version and
the dispatcher to the hand-written CUDA kernel (csrc/orb.cu).

Counterpart of tpuslam/kernels/orb.py (`orb_pattern`,
`gaussian_kernel_7_sigma2`, `orb_blur`, `_orb_descriptors_const_angle_device`,
`_const_angle_offsets`) and of the Pallas kernel
orb.py:_orb_desc_planes_pallas.  GFTT keypoints carry angle -1, so the
`bit_pattern_31` offsets are rotated once by -1 degree on the host; the
descriptor of a keypoint is the 256 tests t0 < t1 of the 7x7 sigma-2
blurred image at those offsets, packed LSB first into 32 bytes.  The plain
version blurs the whole image (`orb_blur`) and gathers the 512 samples per
keypoint (`descriptors_from_blurred`); kernel K3's one launch queues a
kernel for each of those halves, and each half is also a tool launcher of
its own (`orb_blur_cuda`, `orb_tests_cuda`).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import _cuda
from .gftt import _reflect101_pad

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "data",
                             "orb_pattern.npy")
_pattern_cache = None


def orb_pattern() -> np.ndarray:
    """(512, 2) int32 sampling offsets (x, y)."""
    global _pattern_cache
    if _pattern_cache is None:
        _pattern_cache = np.load(_PATTERN_PATH)
    return _pattern_cache


def gaussian_kernel_7_sigma2() -> np.ndarray:
    """cv::getGaussianKernel(7, 2): normalized exp(-x^2 / (2 sigma^2))."""
    xs = np.arange(7) - 3
    k = np.exp(-(xs.astype(np.float64) ** 2) / (2.0 * 2.0 ** 2))
    return (k / k.sum()).astype(np.float64)


def _const_angle_offsets(angle_deg: float):
    pat = np.asarray(orb_pattern(), np.float32)
    ca = np.cos(angle_deg * np.pi / 180.0)
    sb = np.sin(angle_deg * np.pi / 180.0)
    dxs = np.round(pat[:, 0] * ca - pat[:, 1] * sb).astype(np.int32)
    dys = np.round(pat[:, 0] * sb + pat[:, 1] * ca).astype(np.int32)
    R = int(max(-dxs.min(), dxs.max(), -dys.min(), dys.max()))
    return dxs, dys, R


def orb_blur(img: torch.Tensor) -> torch.Tensor:
    """7x7 sigma-2 Gaussian blur of (..., H, W) uint8 with reflect-101
    borders, in tpuslam's f32 accumulation order (vertical taps, then
    horizontal), rounded half up and clipped to uint8."""
    k = _gauss_taps(img.device)
    h, w = img.shape[-2:]
    p = _reflect101_pad(img.float(), 3)
    v = 0.0
    for i in range(7):
        v = v + k[i] * p[..., i:i + h, :]
    out = 0.0
    for j in range(7):
        out = out + k[j] * v[..., :, j:j + w]
    return torch.clamp(torch.floor(out + 0.5), 0, 255).to(torch.uint8)


def _centers(kpts_xy: torch.Tensor, h: int, w: int):
    cx = torch.clamp(torch.round(kpts_xy[..., 0]).long(), 0, w - 1)
    cy = torch.clamp(torch.round(kpts_xy[..., 1]).long(), 0, h - 1)
    return cx, cy


def orb_descriptors_plain(image: torch.Tensor, kpts_xy: torch.Tensor,
                          valid: torch.Tensor,
                          angle_deg: float = -1.0) -> torch.Tensor:
    """Plain version of kernel K3: RAW (B, H, W) uint8 images, (B, K, 2)
    keypoints, (B, K) valid -> (B, K, 32) uint8 descriptors (zero rows
    where invalid; samples outside the image read 0)."""
    _cuda.PLAIN_CALLS["orb"] += 1
    return descriptors_from_blurred(orb_blur(image), kpts_xy, valid,
                                    angle_deg)


def descriptors_from_blurred(blurred: torch.Tensor, kpts_xy: torch.Tensor,
                             valid: torch.Tensor,
                             angle_deg: float = -1.0) -> torch.Tensor:
    """The 256 tests on an already blurred (B, H, W) uint8 image (the
    twin of tpuslam's _orb_descriptors_const_angle_device)."""
    B, h, w = blurred.shape
    dxs, dys, R = _const_angle_offsets(angle_deg)
    dev = blurred.device
    pad = torch.nn.functional.pad(blurred.to(torch.int16), (R, R, R, R))
    wp = w + 2 * R
    cx, cy = _centers(kpts_xy, h, w)
    off = torch.as_tensor((dys + R).astype(np.int64) * wp +
                          (dxs + R).astype(np.int64), device=dev)
    flat = (cy * wp + cx)[..., None] + off                  # (B, K, 512)
    samples = pad.reshape(B, -1).gather(1, flat.reshape(B, -1)) \
        .view(B, -1, 512)
    bits = (samples[..., 0::2] < samples[..., 1::2]).to(torch.int32)
    weights = (1 << torch.arange(8, device=dev, dtype=torch.int32))
    desc = (bits.view(B, -1, 32, 8) * weights).sum(-1).to(torch.uint8)
    return torch.where(valid[..., None], desc, 0)


_on_device: dict = {}


def _cached(key, device, make) -> torch.Tensor:
    """make()'s array as a tensor on `device`, copied there once per key
    and device (no host-to-device copy per call)."""
    k = (key, str(device))
    if k not in _on_device:
        _on_device[k] = torch.as_tensor(make(), device=device)
    return _on_device[k]


def _offset_table(angle_deg: float, device) -> torch.Tensor:
    """(512, 2) int32 [dx, dy] rotated pattern on `device` (cached)."""
    def make():
        dxs, dys, _ = _const_angle_offsets(angle_deg)
        return np.stack([dxs, dys], axis=1).astype(np.int32)
    return _cached(("offsets", angle_deg), device, make)


def _gauss_taps(device) -> torch.Tensor:
    """(7,) f32 taps of gaussian_kernel_7_sigma2 on `device` (cached)."""
    return _cached("taps", device,
                   lambda: gaussian_kernel_7_sigma2().astype(np.float32))


def _check_image(image: torch.Tensor, what: str = "image"):
    _cuda.expect(image, what, torch.uint8, 3)
    if image.shape[1] < 4 or image.shape[2] < 4:
        raise ValueError(f"{what} smaller than 4x4")
    return image.shape


def _check_keypoints(kpts_xy: torch.Tensor, valid: torch.Tensor,
                     B: int) -> int:
    _cuda.expect(kpts_xy, "kpts_xy", torch.float32, 3)
    _cuda.expect(valid, "valid", torch.bool, 2)
    K = kpts_xy.shape[1]
    if kpts_xy.shape != (B, K, 2) or valid.shape != (B, K):
        raise ValueError(f"kpts_xy {tuple(kpts_xy.shape)} / valid "
                         f"{tuple(valid.shape)} do not match {B} frames")
    return K


def orb_descriptors_cuda(image: torch.Tensor, kpts_xy: torch.Tensor,
                         valid: torch.Tensor,
                         angle_deg: float = -1.0) -> torch.Tensor:
    """Kernel K3 (csrc/orb.cu): same contract as orb_descriptors_plain.
    One launch queues the blur into a scratch image, then the tests."""
    B, H, W = _check_image(image)
    K = _check_keypoints(kpts_xy, valid, B)
    dev = image.device
    scratch = torch.empty_like(image)
    desc = torch.empty((B, K, 32), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch("orb", image, kpts_xy, valid,
                     _offset_table(angle_deg, dev), _gauss_taps(dev),
                     scratch, desc, B, H, W, K)
    return desc


def orb_blur_cuda(image: torch.Tensor) -> torch.Tensor:
    """K3's blur alone (the `orb_blur` tool launcher): same contract as
    orb_blur on a (B, H, W) uint8 image.  The main path does not run it;
    dist/mesh.py's frontend_one does, through orb_blur_auto."""
    B, H, W = _check_image(image)
    out = torch.empty_like(image)
    with torch.cuda.device(image.device):
        _cuda.launch("orb_blur", image, _gauss_taps(image.device), out, B, H,
                     W)
    return out


def orb_blur_auto(image: torch.Tensor) -> torch.Tensor:
    """orb_blur of a (B, H, W) uint8 image: K3's blur launcher on a CUDA
    tensor (bit-equal), the plain version (counted) on a CPU tensor."""
    if image.is_cuda:
        return orb_blur_cuda(image)
    _cuda.PLAIN_CALLS["orb_blur"] += 1
    return orb_blur(image)


def orb_tests_cuda(blurred: torch.Tensor, kpts_xy: torch.Tensor,
                   valid: torch.Tensor,
                   angle_deg: float = -1.0) -> torch.Tensor:
    """K3's tests alone (the `orb_tests` tool launcher): same contract as
    descriptors_from_blurred.  No path runs it."""
    B, H, W = _check_image(blurred, "blurred")
    K = _check_keypoints(kpts_xy, valid, B)
    dev = blurred.device
    desc = torch.empty((B, K, 32), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _cuda.launch("orb_tests", blurred, kpts_xy, valid,
                     _offset_table(angle_deg, dev), desc, B, H, W, K)
    return desc


def orb_kernel_attrs() -> dict:
    """Registers, static shared bytes and local bytes per thread of K3's
    two kernels on the current card."""
    out = _cuda.attributes("orb", "tpuslam_orb_attrs", 6)
    return {name: dict(registers=out[3 * i], shared_bytes=out[3 * i + 1],
                       local_bytes=out[3 * i + 2])
            for i, name in enumerate(("blur", "tests"))}


def orb_descriptors_const_angle(image: torch.Tensor, kpts_xy: torch.Tensor,
                                valid: torch.Tensor,
                                angle_deg: float = -1.0) -> torch.Tensor:
    """Dispatcher: kernel K3 for a CUDA tensor, the plain version for a
    CPU tensor.  Takes the RAW image (the blur is part of the kernel)."""
    fn = orb_descriptors_cuda if image.is_cuda else orb_descriptors_plain
    return fn(image, kpts_xy, valid, angle_deg)


def run_by_image_border(kpts: np.ndarray, img_shape, border: int = 19):
    """Drop keypoints within `border` px of the image edge
    (CvORB.cpp runByImageBorder; edgeThreshold 19).

    OpenCV's Rect(border, border, w-2*border, h-2*border).contains uses
    half-open [border, w-border): keep border <= x < w - border.
    """
    h, w = img_shape
    x, y = kpts[:, 0], kpts[:, 1]
    keep = ((x >= border) & (x < w - border) &
            (y >= border) & (y < h - border))
    return kpts[keep], keep


def orb_descriptors(image: torch.Tensor, kpts_xy: np.ndarray,
                    max_kpts: int = 1536):
    """The per-frame path's ORB (tpuslam/kernels/orb.py:orb_descriptors):
    descriptors of one RAW (H, W) uint8 image at border-filtered (N, 2)
    keypoints (angle -1, as GFTT gives them), padded to `max_kpts`; kernel
    K3 for a CUDA image, the plain version for a CPU one.  Returns (desc
    (max_kpts, 32) uint8 on the image's device, valid (max_kpts,) bool)."""
    n = len(kpts_xy)
    assert n <= max_kpts, (n, max_kpts)
    xy = np.zeros((max_kpts, 2), np.float32)
    val = np.zeros((max_kpts,), bool)
    if n:
        xy[:n] = np.asarray(kpts_xy, np.float32)[:, :2]
    val[:n] = True
    dev = image.device
    desc = orb_descriptors_const_angle(
        image[None], torch.as_tensor(xy, device=dev)[None],
        torch.as_tensor(val, device=dev)[None])
    return desc[0], val
