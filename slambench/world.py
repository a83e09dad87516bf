"""The benchmark's traffic generator: a KITTI-geometry stereo log rendered
on the card from a seed.

A frozen copy of tpuslam_torch/io/synthetic.py (`_mul32`, `_hash01`,
`_value_noise`, `_spots`, `_texture`, `render_box` without the photo
texture, `BoxWorld`, `forward_trajectory`, `out_and_back_trajectory` and
the KITTI ground-truth conjugation), so that the logs a cell replays stay
the same whatever later changes make to the program.  An analytic ray
tracer renders the inside of a textured box sized around the trajectory;
the texture is multi-octave hash value noise with blob landmarks and an
analytic mip, evaluated at the world hit point and 2x2 supersampled.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), in 16-bit halves."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash01(ix, iy, salt: int):
    """Integer lattice hash -> float32 in [0, 1)."""
    h = (_mul32(ix.long() & _M32, 0x9E3779B1) ^
         _mul32(iy.long() & _M32, 0x85EBCA77) ^
         ((salt & _M32) * 0xC2B2AE3D & _M32))
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h.float() * (1.0 / 4294967296.0)


def _value_noise(a, b, scale, salt):
    """Bilinear value noise over lattice `scale` at plane coords (a, b)."""
    xa = a / scale
    xb = b / scale
    ia = torch.floor(xa)
    ib = torch.floor(xb)
    fa = xa - ia
    fb = xb - ib
    wa = fa * fa * (3.0 - 2.0 * fa)
    wb = fb * fb * (3.0 - 2.0 * fb)
    ia = ia.int()
    ib = ib.int()
    v00 = _hash01(ia, ib, salt)
    v10 = _hash01(ia + 1, ib, salt)
    v01 = _hash01(ia, ib + 1, salt)
    v11 = _hash01(ia + 1, ib + 1, salt)
    return (v00 * (1 - wa) * (1 - wb) + v10 * wa * (1 - wb) +
            v01 * (1 - wa) * wb + v11 * wa * wb)


_OCT_SCALES = (0.06, 0.22, 0.85, 3.4, 13.0)
_OCT_WEIGHTS = (0.08, 0.14, 0.30, 0.28, 0.20)
_SPOT_SCALES = (0.7, 2.8)


def _spots(a, b, scale, salt, footprint):
    """One blob layer: (coverage in [0, 1], intensity in [0, 1])."""
    xa = a / scale
    xb = b / scale
    ia = torch.floor(xa)
    ib = torch.floor(xb)
    fa = xa - ia
    fb = xb - ib
    ia = ia.int()
    ib = ib.int()
    ca = 0.35 + 0.3 * _hash01(ia, ib, salt + 1)
    cb = 0.35 + 0.3 * _hash01(ia, ib, salt + 2)
    r = 0.14 + 0.18 * _hash01(ia, ib, salt + 3)
    polarity = _hash01(ia, ib, salt + 4) < 0.5
    present = _hash01(ia, ib, salt + 5) < 0.88
    inten = torch.where(polarity, 0.04, 0.96)
    d = torch.sqrt((fa - ca) ** 2 + (fb - cb) ** 2)
    edge = torch.clamp(footprint / scale, min=0.015)
    cov = torch.clamp((r - d) / edge, 0.0, 1.0)
    cov = cov * torch.exp(-(footprint / (r * scale)) ** 2)
    cov = torch.where(present, cov, 0.0)
    return cov, inten


def _texture(a, b, footprint, salt):
    """Multi-octave value noise + blob landmarks, in [0, 1]."""
    acc = torch.zeros_like(a)
    wsum = torch.zeros_like(a)
    for k, (s, w) in enumerate(zip(_OCT_SCALES, _OCT_WEIGHTS)):
        wk = w * torch.exp(-(footprint / s) ** 2)
        acc = acc + wk * _value_noise(a, b, s, salt * 7919 + k * 131)
        wsum = wsum + wk
    out = acc / torch.clamp(wsum, min=1e-6)
    for k, s in enumerate(_SPOT_SCALES):
        cov, inten = _spots(a, b, s, salt * 4241 + 977 * k, footprint)
        out = out * (1.0 - cov) + inten * cov
    return out


def render_box(cam_to_world, box, f, cx, cy, h, w, ss, seed, device):
    """Ray-trace the inside of an axis-aligned textured box from each of
    the (B, 4, 4) cam-to-world poses -> (B, h, w) uint8.  box = [x_lo,
    x_hi, y_lo, y_hi, z_lo, z_hi] in the optical frame (x right, y down, z
    forward).  The copy's one change: a batch of poses a call (each ray's
    direction summed term by term instead of a matmul), so a log renders
    in a few dozen calls."""
    f32 = dict(dtype=torch.float32, device=device)
    c2w = torch.as_tensor(np.asarray(cam_to_world, np.float32), **f32)
    box = torch.as_tensor(np.asarray(box, np.float32), **f32)
    f, cx, cy = (torch.tensor(v, **f32) for v in (f, cx, cy))
    R = c2w[:, None, None, :3, :3]
    t = c2w[:, None, None, :3, 3]

    us = (torch.arange(w * ss, **f32) + 0.5) / ss - 0.5
    vs = (torch.arange(h * ss, **f32) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d_cam = torch.stack([(uu - cx) / f, (vv - cy) / f,
                         torch.ones_like(uu)], dim=-1)
    d = (d_cam[None, :, :, None, :] * R).sum(dim=-1)
    inv = 1.0 / torch.where(d.abs() < 1e-9, 1e-9, d)

    def face_t(axis, c):
        tt = (c - t[..., axis]) * inv[..., axis]
        return torch.where(tt > 1e-4, tt, 1e30)

    ts = torch.stack([face_t(0, box[0]), face_t(0, box[1]),
                      face_t(1, box[2]), face_t(1, box[3]),
                      face_t(2, box[4]), face_t(2, box[5])], dim=-1)
    t_hit = ts.amin(dim=-1)
    face = torch.argmin(ts, dim=-1)
    del ts, inv

    p = t + t_hit[..., None] * d
    a = torch.where(face < 2, p[..., 1], p[..., 0])
    b = torch.where(face < 4, p[..., 2], p[..., 1])
    del p, d
    footprint = t_hit / (f * ss)
    tex = _texture(a, b, footprint, seed)
    contrast = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.12, 0.12], **f32)[face]
    tex = 0.5 + (tex - 0.5) * contrast
    gain = torch.tensor([0.95, 1.05, 0.85, 1.0, 0.9, 1.1], **f32)[face]
    val = (25.0 + 205.0 * tex) * gain
    val = val.reshape(-1, h, ss, w, ss).mean(dim=(2, 4))
    return torch.clamp(torch.round(val), 0, 255).to(torch.uint8)


# poses rendered a call: ~2.4 GB of float temporaries at 1241x376, 2x2
RENDER_BATCH = 8


class BoxWorld:
    """A trajectory-sized textured box world with a camera renderer."""

    def __init__(self, poses, seed: int = 0, half_width: float = 11.0,
                 ground: float = 1.6, ceiling: float = -3.2,
                 z_margin: float = 45.0):
        xs = np.array([p[0, 3] for p in poses])
        ys = np.array([p[1, 3] for p in poses])
        zs = np.array([p[2, 3] for p in poses])
        self.box = np.array([
            xs.min() - half_width, xs.max() + half_width,
            ys.min() + ceiling, ys.max() + ground,
            zs.min() - z_margin, zs.max() + z_margin,
        ], np.float32)
        self.seed = int(seed) & 0x7FFFFFFF

    def render(self, poses, f, cx, cy, h, w, device, ss: int = 2,
               batch: int = RENDER_BATCH):
        """(N, h, w) uint8 views from the cam-to-world `poses`, `batch`
        poses a call."""
        poses = np.asarray(poses, np.float64).reshape(-1, 4, 4)
        return torch.cat([render_box(poses[i:i + batch], self.box, f, cx, cy,
                                     int(h), int(w), int(ss), self.seed,
                                     device)
                          for i in range(0, len(poses), batch)])


def forward_trajectory(n_frames: int, speed: float, yaw_rate: float):
    """Forward motion with gentle yaw (rotation about the optical +y)."""
    poses = []
    pose = np.eye(4)
    for _ in range(n_frames):
        poses.append(pose.copy())
        cy_, sy_ = np.cos(yaw_rate), np.sin(yaw_rate)
        step = np.array([[cy_, 0.0, sy_, 0.0],
                         [0.0, 1.0, 0.0, 0.0],
                         [-sy_, 0.0, cy_, speed],
                         [0.0, 0.0, 0.0, 1.0]])
        pose = pose @ step
    return poses


def out_and_back_trajectory(n_forward: int, speed: float = 0.5):
    """Forward, one apex frame, then backing up along the same path:
    2 * n_forward + 1 frames that revisit early poses exactly."""
    poses = []
    pose = np.eye(4)
    for _ in range(n_forward):
        poses.append(pose.copy())
        pose = pose.copy()
        pose[2, 3] += speed
    poses.append(pose.copy())
    for _ in range(n_forward):
        pose = pose.copy()
        pose[2, 3] -= speed
        poses.append(pose.copy())
    return poses


# KITTI ground-truth conjugation, optical -> robot frame
P_CONJ = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                   [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]])


def robot_frame(pose_cam: np.ndarray) -> np.ndarray:
    """A cam0-to-world pose in the robot frame the odometry reports."""
    return P_CONJ @ pose_cam @ np.linalg.inv(P_CONJ)


def world_seed(seed: int, stream: int) -> int:
    """The world of stream `stream` of a run seeded `seed`: any whole
    number, however large, maps to a 31-bit world seed."""
    h = (int(seed) * 0x9E3779B97F4A7C15 + int(stream) * 0xBF58476D1CE4E5B9)
    h &= (1 << 64) - 1
    h ^= h >> 31
    return h & 0x7FFFFFFF


def render_log(poses, seed: int, width: int, height: int, f: float,
               baseline: float, device, frames=None):
    """(left, right) (N, H, W) uint8 tensors on `device` and the robot-
    frame ground truth (N, 4, 4) float64 of a log along `poses`; only the
    indices `frames` of it where they are given."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    world = BoxWorld(poses, seed=seed)
    if frames is not None:
        poses = [poses[i] for i in frames]
    right_offset = np.eye(4)
    right_offset[0, 3] = baseline
    left = world.render(poses, f, cx, cy, height, width, device)
    right = world.render([p @ right_offset for p in poses], f, cx, cy,
                         height, width, device)
    gt = np.stack([robot_frame(np.asarray(p, np.float64)) for p in poses])
    return left, right, gt
