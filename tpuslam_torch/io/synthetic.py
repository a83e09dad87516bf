"""Synthetic stereo sequence, rendered in torch on a given device.

Counterpart of tpuslam/io/synthetic.py (`_hash01`, `_value_noise`,
`_spots`, `_texture`, `_render_box_device`, `BoxWorld`, the default
forward-with-yaw trajectory of `make_sequence` and
`out_and_back_trajectory`).  An analytic ray tracer renders the inside of
a textured box sized around the trajectory; the texture is multi-octave
hash value noise with blob landmarks and an analytic mip, evaluated at the
world hit point and 2x2 supersampled.

`make_sequence` returns the frames in memory, with the timestamps and
ground truth the KITTI-layout files would have given (the same text round
trip); `write_sequence` writes those files, as tpuslam's make_sequence
does (images as PNGs through io/png.py).  Either may texture the world
with a real grayscale photograph instead of the procedural noise
(`texture_photo`: `photo_pyramid`, `_sample_photo`, `_texture_photo`),
mirror-tiled and mip-mapped, with the blob landmarks laid over it, as
tpuslam's photo mode does: real image statistics in the end-to-end
evidence chain.

`pnp_scene` makes the known-pose refinement inputs that the card-only
tests and chip_smoke.py hold the LM-refine kernel to, and
`noisy_circuit` / `exact_closure` the noisy pose graphs that they hold
the back end and the sharded pose-graph steps to.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from ..mapping.graph import LOOP_CLOSURE, NEIGHBOR, Link, MultiMap

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32): split into 16-bit
    halves so no product leaves the int64 range."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _hash01(ix, iy, salt: int):
    """Integer lattice hash -> float32 in [0, 1); uint32 mixing carried
    out in int64."""
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
    """One blob layer: returns (coverage in [0,1], intensity in [0,1])."""
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


def photo_pyramid(photo, levels: int = 6, device="cuda"):
    """Mip pyramid of a real grayscale photograph for _texture_photo, on
    `device` (the card unless the caller asks for the CPU): tuple of f32
    [0,1] tensors, each level 2x2-mean downsampled (in numpy, as
    tpuslam's)."""
    img = np.asarray(photo, np.float32) / 255.0
    pyr = [img]
    for _ in range(levels - 1):
        im = pyr[-1]
        if min(im.shape) < 4:
            break
        h2, w2 = im.shape[0] // 2 * 2, im.shape[1] // 2 * 2
        pyr.append(im[:h2, :w2].reshape(h2 // 2, 2, w2 // 2, 2)
                   .mean(axis=(1, 3)))
    return tuple(torch.as_tensor(p, device=device) for p in pyr)


def _mirror(u, n: int):
    """Mirror-tiled coordinate of u over [0, n-1]: jnp.mod's floor
    modulo (fmod, then the period added to a negative remainder)."""
    period = 2.0 * (n - 1)
    m = torch.fmod(u, period)
    m = torch.where(m < 0, m + period, m)
    return torch.where(m <= n - 1, m, period - m)


def _sample_photo(level_img, ua, ub):
    """Mirror-tiled bilinear sample of one pyramid level at pixel coords
    (ua, ub)."""
    H, W = level_img.shape
    x = _mirror(ua, W)
    y = _mirror(ub, H)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0 = torch.clamp(x0.int(), 0, W - 1)
    y0 = torch.clamp(y0.int(), 0, H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    flat = level_img.reshape(-1)

    def at(yy, xx):
        return flat[(yy * W + xx).long()]

    return (at(y0, x0) * (1 - fx) * (1 - fy) +
            at(y0, x1) * fx * (1 - fy) +
            at(y1, x0) * (1 - fx) * fy +
            at(y1, x1) * fx * fy)


def _texture_photo(a, b, footprint, pyr, px_per_m: float = 96.0):
    """Real-photo plane texture: mirror-tiled trilinear (bilinear +
    mip-level tent blend) lookup, level chosen by the pixel footprint so
    distant surfaces sample pre-averaged texture instead of aliasing."""
    px = footprint * px_per_m
    lvl = torch.clamp(torch.log2(torch.clamp(px, min=1.0)), 0.0,
                      float(len(pyr) - 1))
    out = torch.zeros_like(a)
    for li, level in enumerate(pyr):
        w_l = torch.clamp(1.0 - torch.abs(lvl - li), 0.0, 1.0)
        scale = px_per_m / (2.0 ** li)
        out = out + w_l * _sample_photo(level, a * scale, b * scale)
    return out


def render_box(cam_to_world, box, f, cx, cy, h, w, ss, seed, device,
               photo_pyr=None):
    """Ray-trace the inside of an axis-aligned textured box -> (h, w)
    uint8.  box = [x_lo, x_hi, y_lo, y_hi, z_lo, z_hi] in the optical
    frame (x right, y down, z forward).  `photo_pyr` (photo_pyramid's
    levels on `device`) textures the faces with a photograph instead of
    the procedural noise."""
    f32 = dict(dtype=torch.float32, device=device)
    c2w = torch.as_tensor(np.asarray(cam_to_world, np.float32), **f32)
    box = torch.as_tensor(np.asarray(box, np.float32), **f32)
    f, cx, cy = (torch.tensor(v, **f32) for v in (f, cx, cy))
    R, t = c2w[:3, :3], c2w[:3, 3]

    us = (torch.arange(w * ss, **f32) + 0.5) / ss - 0.5
    vs = (torch.arange(h * ss, **f32) + 0.5) / ss - 0.5
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d_cam = torch.stack([(uu - cx) / f, (vv - cy) / f,
                         torch.ones_like(uu)], dim=-1)
    d = d_cam @ R.T
    inv = 1.0 / torch.where(d.abs() < 1e-9, 1e-9, d)

    def face_t(axis, c):
        tt = (c - t[axis]) * inv[..., axis]
        return torch.where(tt > 1e-4, tt, 1e30)

    ts = torch.stack([face_t(0, box[0]), face_t(0, box[1]),
                      face_t(1, box[2]), face_t(1, box[3]),
                      face_t(2, box[4]), face_t(2, box[5])], dim=-1)
    t_hit = ts.amin(dim=-1)
    face = torch.argmin(ts, dim=-1)

    p = t[None, None, :] + t_hit[..., None] * d
    a = torch.where(face < 2, p[..., 1], p[..., 0])
    b = torch.where(face < 4, p[..., 2], p[..., 1])
    footprint = t_hit / (f * ss)
    if photo_pyr is None:
        tex = _texture(a, b, footprint, seed)
    else:
        tex = _texture_photo(a, b, footprint, photo_pyr)
        # globally unique blob landmarks over the mirror-tiled photo
        # (an exactly repeating wall aliases descriptor matching)
        for k, s_ in enumerate(_SPOT_SCALES):
            cov, inten = _spots(a, b, s_, seed * 4241 + 977 * k, footprint)
            tex = tex * (1.0 - cov) + inten * cov
    contrast = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.12, 0.12], **f32)[face]
    tex = 0.5 + (tex - 0.5) * contrast
    gain = torch.tensor([0.95, 1.05, 0.85, 1.0, 0.9, 1.1], **f32)[face]
    val = (25.0 + 205.0 * tex) * gain
    val = val.reshape(h, ss, w, ss).mean(dim=(1, 3))
    return torch.clamp(torch.round(val), 0, 255).to(torch.uint8)


class BoxWorld:
    """A trajectory-sized textured box world with a camera renderer."""

    def __init__(self, poses, seed: int = 0, half_width: float = 11.0,
                 ground: float = 1.6, ceiling: float = -3.2,
                 z_margin: float = 45.0, photo=None):
        poses = [np.asarray(p, np.float64) for p in poses]
        xs = np.array([p[0, 3] for p in poses])
        ys = np.array([p[1, 3] for p in poses])
        zs = np.array([p[2, 3] for p in poses])
        self.box = np.array([
            xs.min() - half_width, xs.max() + half_width,
            ys.min() + ceiling, ys.max() + ground,
            zs.min() - z_margin, zs.max() + z_margin,
        ], np.float32)
        self.seed = seed
        # photo: real grayscale image to texture every face with
        # (mirror-tiled, mip-mapped) instead of the procedural noise; its
        # pyramid is made on each device at that device's first render
        self.photo = None if photo is None else np.asarray(photo)
        self._pyramids = {}

    def photo_pyr(self, device):
        """The photo's pyramid on `device` (None without a photo)."""
        if self.photo is None:
            return None
        key = str(torch.device(device))
        if key not in self._pyramids:
            self._pyramids[key] = photo_pyramid(self.photo, device=device)
        return self._pyramids[key]

    def render(self, cam_to_world, f, cx, cy, h, w, ss: int = 2,
               device="cuda") -> torch.Tensor:
        """One (h, w) uint8 view from `cam_to_world`, rendered on `device`
        (the card unless the caller asks for the CPU)."""
        return render_box(cam_to_world, self.box, f, cx, cy, int(h), int(w),
                          int(ss), int(self.seed) & 0x7FFFFFFF, device,
                          self.photo_pyr(device))


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


# KITTI GT conjugation (optical -> robot frame), as io/dataset.py reads it
_P_CONJ = np.array([[0.0, 0.0, 1.0, 0.0], [-1.0, 0.0, 0.0, 0.0],
                    [0.0, -1.0, 0.0, 0.0], [0.0, 0.0, 0.0, 1.0]],
                   dtype=np.float32)


def _robot_gt(pose_cam: np.ndarray) -> np.ndarray:
    """poses.txt row ('%.9e' text) -> conjugated robot-frame pose, exactly
    as tpuslam.io.dataset.import_poses computes it."""
    m = T.from_3x4([float(f"{v:.9e}") for v in pose_cam[:3].reshape(-1)])
    return T.compose(T.compose(_P_CONJ, m), T.inverse(_P_CONJ))


def out_and_back_trajectory(n_forward: int, speed: float = 0.5):
    """Forward motion, one apex frame, then backing up along the same
    path (viewing direction unchanged so the start-of-corridor world stays
    visible) — revisits early poses exactly, for loop-closure testing.
    2*n_forward+1 frames."""
    poses = []
    pose = np.eye(4)
    for _ in range(n_forward):
        poses.append(pose.copy())
        pose = pose.copy()
        pose[2, 3] += speed
    poses.append(pose.copy())  # apex
    for _ in range(n_forward):
        pose = pose.copy()
        pose[2, 3] -= speed
        poses.append(pose.copy())
    return poses


def make_sequence(n_frames: int = 20, width: int = 640, height: int = 480,
                  f: float = 500.0, baseline: float = 0.54,
                  speed: float = 0.5, yaw_rate: float = 0.004,
                  seed: int = 0, device="cuda", poses=None,
                  texture_photo=None):
    """Render a synthetic stereo sequence on `device` (the card unless the
    caller asks for the CPU).  `poses` (4x4 cam-to-world, optical frame)
    replaces the forward-with-yaw trajectory; n_frames is then theirs.
    `texture_photo`: a real grayscale image (H, W) used as the world
    texture (mirror-tiled, mip-mapped) instead of the procedural noise.

    Returns (left (N, H, W) uint8, right (N, H, W) uint8, stamps list of
    float, gt_poses (N, 4, 4) float32 robot-frame numpy array).  Frames,
    stamps and ground truth match what tpuslam.io.synthetic.make_sequence
    writes and tpuslam.io.dataset reads back, up to the renderer's
    transcendental ulps."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    if poses is None:
        poses = forward_trajectory(n_frames, speed, yaw_rate)
    else:
        poses = [np.asarray(p, np.float64) for p in poses]
        n_frames = len(poses)
    world = BoxWorld(poses, seed=seed, photo=texture_photo)
    right_offset = np.eye(4)
    right_offset[0, 3] = baseline
    left = torch.stack([world.render(p, f, cx, cy, height, width,
                                     device=device) for p in poses])
    right = torch.stack([world.render(p @ right_offset, f, cx, cy, height,
                                      width, device=device) for p in poses])
    stamps = [float(f"{i * 0.1:.6e}") for i in range(n_frames)]
    gt = np.stack([_robot_gt(p) for p in poses])
    return left, right, stamps, gt


def write_sequence(out_dir: str, n_frames: int = 20, width: int = 640,
                   height: int = 480, f: float = 500.0,
                   baseline: float = 0.54, speed: float = 0.5,
                   yaw_rate: float = 0.004, seed: int = 0, poses=None,
                   device="cuda", texture_photo=None) -> str:
    """Render a sequence on `device` (the card unless the caller asks for
    the CPU) and write it as a KITTI-layout directory, as
    tpuslam.io.synthetic.make_sequence(out_dir, ...) does: image_0/ and
    image_1/ PNGs, calib.txt, times.txt and poses.txt (cam0-to-world 3x4
    rows) in the same text formats; `texture_photo` as make_sequence's.
    Returns out_dir."""
    from .png import write_png
    if poses is None:
        poses = forward_trajectory(n_frames, speed, yaw_rate)
    poses = [np.asarray(p, np.float64) for p in poses]
    left, right, _, _ = make_sequence(width=width, height=height, f=f,
                                      baseline=baseline, seed=seed,
                                      device=device, poses=poses,
                                      texture_photo=texture_photo)
    for sub, imgs in (("image_0", left), ("image_1", right)):
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        for i, img in enumerate(imgs.cpu().numpy()):
            write_png(os.path.join(out_dir, sub, f"{i:06d}.png"), img)

    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    with open(os.path.join(out_dir, "calib.txt"), "w") as fh:
        p0 = [f, 0.0, cx, 0.0, 0.0, f, cy, 0.0, 0.0, 0.0, 1.0, 0.0]
        p1 = list(p0)
        p1[3] = -f * baseline
        fh.write("P0: " + " ".join(f"{v:.12e}" for v in p0) + "\n")
        fh.write("P1: " + " ".join(f"{v:.12e}" for v in p1) + "\n")

    with open(os.path.join(out_dir, "times.txt"), "w") as fh:
        for i in range(len(poses)):
            fh.write(f"{i * 0.1:.6e}\n")

    with open(os.path.join(out_dir, "poses.txt"), "w") as fh:
        for p in poses:
            fh.write(" ".join(f"{v:.9e}" for v in p[:3].reshape(-1)) + "\n")
    return out_dir


def pnp_scene(rng: np.random.Generator, n: int, K: np.ndarray, rvec0=None,
              device="cuda"):
    """Refinement inputs with a known pose: `n` points in front of the
    camera `K` at rvec (0.02, -0.03, 0.01), tvec (0.3, -0.1, 0.8), pixels
    with 0.3 px noise, 30 % of the rows at weight 0 (as the VO's refine
    rounds weight the inliers); the start is `rvec0` (default off by
    0.05 rad per axis) and tvec off by 0.3 m.

    Returns ([obj, img, weight, valid, K, rvec0, tvec0] as f32/bool tensors
    on `device`, true rvec, true tvec)."""
    rv = np.array([0.02, -0.03, 0.01])
    tv = np.array([0.3, -0.1, 0.8])
    th = np.linalg.norm(rv)
    k = rv / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    pts = np.stack([rng.uniform(-10, 10, n), rng.uniform(-5, 5, n),
                    rng.uniform(5, 40, n)], 1)
    pc = pts @ R.T + tv
    K = np.asarray(K, np.float32)
    img = pc[:, :2] / pc[:, 2:] * K[[0, 1], [0, 1]] + K[[0, 1], [2, 2]]
    img = img + rng.normal(0, 0.3, (n, 2))
    w = (rng.uniform(size=n) < 0.7).astype(np.float32)
    r0 = rv + 0.05 if rvec0 is None else rvec0
    args = (pts.astype(np.float32), img.astype(np.float32), w, w > 0, K,
            np.asarray(r0, np.float32), (tv + 0.3).astype(np.float32))
    return [torch.as_tensor(a, device=device) for a in args], rv, tv


def se3_noise(rng: np.random.Generator, t_scale: float,
              r_scale: float) -> np.ndarray:
    """A random 4x4 rigid motion (f64): a rotation vector ~ N(0, r_scale)
    per axis, a translation ~ N(0, t_scale) per axis (the JAX suite's
    tests/test_optim.py rand_se3)."""
    rvec = rng.normal(0, r_scale, 3)
    angle = np.linalg.norm(rvec)
    m = np.eye(4)
    if angle > 1e-12:
        k = rvec / angle
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        m[:3, :3] = np.eye(3) + np.sin(angle) * K + \
            (1 - np.cos(angle)) * (K @ K)
    m[:3, 3] = rng.normal(0, t_scale, 3)
    return m


def noisy_circuit(n: int, lap: int, rng: np.random.Generator):
    """A pose graph of `n` poses driving a circuit of `lap` poses 1 m
    apart (yawing 2 pi / lap per pose), laps repeated, with odometry
    noise as the JAX suite's make_noisy_loop (0.05 m and 0.01 rad per
    axis, Omega = 100 I): ground truth (n, 4, 4) f64, the noisy poses
    {node id: 4x4 f32} (ids 1..n) and the MultiMap of NEIGHBOR links.
    Loop closures are added with `exact_closure`."""
    a = 2 * np.pi / lap
    step = np.eye(4)
    step[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]]
    step[:3, 3] = [0, 0, 1.0]
    gt = [np.eye(4)]
    for _ in range(n - 1):
        gt.append(gt[-1] @ step)
    poses, links, cur = {1: gt[0].astype(np.float32)}, MultiMap(), gt[0]
    for i in range(1, n):
        meas = np.linalg.inv(gt[i - 1]) @ gt[i] @ se3_noise(rng, 0.05, 0.01)
        cur = cur @ meas
        poses[i + 1] = cur.astype(np.float32)
        links.insert(i, Link(i, i + 1, NEIGHBOR, meas.astype(np.float32),
                             np.eye(6) * 100.0))
    return np.stack(gt), poses, links


def exact_closure(links, gt: np.ndarray, i: int, j: int):
    """Add to `links` an exact loop closure from pose i to pose j (0-based
    indices into `gt`; node ids i + 1 -> j + 1), Omega = 100 I."""
    links.insert(i + 1, Link(i + 1, j + 1, LOOP_CLOSURE, (
        np.linalg.inv(gt[i]) @ gt[j]).astype(np.float32), np.eye(6) * 100.0))


def sequence_camera(width: int, height: int, f: float,
                    baseline: float) -> StereoCameraModel:
    """The stereo camera of a make_sequence run, with the values that the
    KITTI calib.txt ('%.12e' text) carries."""
    cx, cy = (width - 1) / 2.0, (height - 1) / 2.0
    p0 = [f, 0.0, cx, 0.0, 0.0, f, cy, 0.0, 0.0, 0.0, 1.0, 0.0]
    p1 = list(p0)
    p1[3] = -f * baseline

    def mat(p):
        return np.array([float(f"{v:.12e}") for v in p],
                        np.float64).reshape(3, 4)

    return StereoCameraModel(P_l=mat(p0), P_r=mat(p1), width=width,
                             height=height)
