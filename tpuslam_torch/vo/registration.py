"""Frame-to-frame registration: matching + motion estimation, in PyTorch.

Counterpart of tpuslam/vo/registration.py (the reference's
Registration.cpp and MotionEstimation.cpp:59-241), on the port's
matchers and PnP:

  * matchingNoGuess: brute KNN-2 Hamming + NNDR + first-wins train dedup
    (kernels.matching.knn2_hamming),
  * matchingGuess: project the 'from' 3D points with the guess, 40-px
    radius candidate set, per-point KNN-2 + NNDR with the single-candidate
    accept (kernels.matching.guided_knn2_hamming),
  * estimateMotion3DTo2D: correspondences -> kernels.pnp.solve_pnp_ransac
    (RANSAC, then the LM refine rounds on kernel K6 for a CUDA device) ->
    frame conversions -> covariance from the median squared-distance and
    angle errors of the inliers.

The descriptor matrices and the PnP run on `device`; the bookkeeping is
host numpy.  `draws` injects the RANSAC uniforms (tests pass tpuslam's).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from ..kernels import matching as M
from ..kernels import pnp as P
from .frame import Frame, CAPACITY


@dataclass
class RegInfo:
    """REG_INFO twin (include/core/Registration.h)."""
    covariance: np.ndarray = field(
        default_factory=lambda: np.eye(6, dtype=np.float64))
    num_matches: int = 0
    num_inliers: int = 0
    matches: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))
    inliers: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int64))


def _rot_to_rvec_tvec(t_cam: np.ndarray):
    """4x4 camera extrinsics -> (rvec, tvec) float32 (cv::Rodrigues twin)."""
    R = t_cam[:3, :3].astype(np.float64)
    q = T.rot_to_quat(R)
    # axis-angle from quaternion (stable for all magnitudes)
    w = np.clip(q[0], -1.0, 1.0)
    angle = 2.0 * np.arccos(w)
    s = np.sqrt(max(1.0 - w * w, 0.0))
    if s < 1e-12:
        rvec = np.zeros(3)
    else:
        axis = q[1:] / s
        if angle > np.pi:
            angle -= 2.0 * np.pi
        rvec = axis * angle
    return rvec.astype(np.float32), t_cam[:3, 3].astype(np.float32)


def project_points(pts3d: np.ndarray, t_cam: np.ndarray,
                   K: np.ndarray) -> np.ndarray:
    """cv::projectPoints twin (no distortion): world pts through camera
    extrinsics t_cam (pc = R p + t), pinhole K.  NaN-safe."""
    pc = pts3d @ t_cam[:3, :3].T + t_cam[:3, 3]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = pc[:, 0] / pc[:, 2] * K[0, 0] + K[0, 2]
        v = pc[:, 1] / pc[:, 2] * K[1, 1] + K[1, 2]
    return np.stack([u, v], axis=1), pc[:, 2]


def _host(*ts):
    return [t.cpu().numpy() for t in ts]


def matching_guess(frame_from: Frame, frame_to: Frame, guess: np.ndarray,
                   camera: StereoCameraModel,
                   nndr: float = 0.8, guess_win_size: float = 40.0,
                   device="cuda"):
    """Guided matching (Registration.cpp:236-303).

    Returns list of (from_idx, to_idx) pairs, first-wins dedup on to_idx.
    """
    kpts3d_from = frame_from.kpts3d
    if len(kpts3d_from) == 0 or frame_to.n_kpts == 0:
        return []

    # project "from" 3D keypoints into the "to" image with the guess
    guess_cam = T.inverse(T.compose(guess, camera.local_transform))
    proj, z = project_points(kpts3d_from, guess_cam, camera.K_l)
    w, h = camera.width, camera.height
    with np.errstate(invalid="ignore"):
        valid = (np.isfinite(proj).all(axis=1) &
                 (proj[:, 0] > 0.0) & (proj[:, 0] < w - 1) &
                 (proj[:, 1] > 0.0) & (proj[:, 1] < h - 1) &
                 (z > 0.0))
    if not valid.any():
        return []

    cap = CAPACITY
    desc_from, _ = frame_from.desc_padded(cap)
    desc_to, val_to = frame_to.desc_padded(cap)
    proj_p = np.zeros((cap, 2), np.float32)
    pval_p = np.zeros((cap,), bool)
    n_from = min(len(kpts3d_from), cap)
    proj_p[:n_from] = np.nan_to_num(proj[:n_from], nan=-1e6)
    pval_p[:n_from] = valid[:n_from]
    kpts_to_p = np.full((cap, 2), 1e9, np.float32)
    n_to = min(frame_to.n_kpts, cap)
    kpts_to_p[:n_to] = frame_to.kpts[:n_to, :2]

    def dev(x):
        return torch.as_tensor(x, device=device)

    d1, i1, d2, _, n_cand = _host(*M.guided_knn2_hamming(
        dev(desc_from), dev(proj_p), dev(pval_p), dev(desc_to),
        dev(kpts_to_p), dev(val_to),
        torch.tensor(guess_win_size, dtype=torch.float32, device=device)))
    accept = M.nndr_accept(d1, i1, d2, n_cand, nndr, single_accept=True)
    return M.dedup_matches(np.arange(cap), i1, accept)


def matching_no_guess(frame_from: Frame, frame_to: Frame,
                      nndr: float = 0.8, device="cuda"):
    """Global brute-force matching (Registration.cpp:311-335)."""
    if frame_from.n_kpts == 0 or frame_to.n_kpts == 0:
        return []
    cap = CAPACITY
    desc_from, val_from = frame_from.desc_padded(cap)
    desc_to, val_to = frame_to.desc_padded(cap)

    def dev(x):
        return torch.as_tensor(x, device=device)

    d1, i1, d2, _ = _host(*M.knn2_hamming(dev(desc_from), dev(val_from),
                                          dev(desc_to), dev(val_to)))
    # BFMatcher always returns 2 neighbors here (train size >= 2), so the
    # n_cand >= 2 branch applies throughout; no single-accept.
    n_cand = np.full(cap, 2)
    n_cand[~val_from] = 0
    accept = M.nndr_accept(d1, i1, d2, n_cand, nndr, single_accept=False)
    return M.dedup_matches(np.arange(cap), i1, accept)


def estimate_motion(frame_from: Frame, frame_to: Frame, guess: np.ndarray,
                    camera: StereoCameraModel, pairs,
                    min_inliers: int = 20, refine_iterations: int = 1,
                    seed: int = 0, device="cuda", draws=None):
    """estimateMotion + estimateMotion3DTo2D twin
    (Registration.cpp:337-397, MotionEstimation.cpp:59-241).

    Returns (transform 4x4 or None, RegInfo).
    """
    info = RegInfo()
    if not pairs:
        return None, info

    # correspondences: finite "from" 3D <-> "to" 2D (and "to" 3D for cov)
    f_idx = np.array([p[0] for p in pairs])
    t_idx = np.array([p[1] for p in pairs])
    obj = frame_from.kpts3d[f_idx]
    finite = np.isfinite(obj).all(axis=1)
    f_idx, t_idx, obj = f_idx[finite], t_idx[finite], obj[finite]
    img = frame_to.kpts[t_idx, :2]
    obj3b = frame_to.kpts3d[t_idx]

    info.num_matches = len(f_idx)
    info.matches = f_idx
    if len(f_idx) < min_inliers:
        return None, info

    # guess -> camera extrinsics (MotionEstimation.cpp:122-133)
    guess_for_pnp = guess if guess is not None and not T.is_null(guess) \
        else T.identity()
    guess_cam = T.inverse(T.compose(guess_for_pnp, camera.local_transform))
    rvec0, tvec0 = _rot_to_rvec_tvec(guess_cam)

    rvec, tvec, inl = P.solve_pnp_ransac(
        obj, img, camera.K_l, rvec0, tvec0,
        min_inliers=min_inliers, refine_iterations=refine_iterations,
        seed=seed, capacity=CAPACITY, device=device, draws=draws)

    info.num_inliers = len(inl)
    info.inliers = f_idx[inl] if len(inl) else np.zeros(0, np.int64)
    if len(inl) < min_inliers:
        return None, info

    # camera pose -> robot-frame transform (MotionEstimation.cpp:155-160)
    R = P.rodrigues(torch.as_tensor(rvec)).numpy()
    pnp_mat = T.identity()
    pnp_mat[:3, :3] = R
    pnp_mat[:3, 3] = tvec
    tf = T.inverse(T.compose(camera.local_transform, pnp_mat))

    # covariance from median errors of inliers (MotionEstimation.cpp:162-214)
    cov = np.eye(6, dtype=np.float64)
    pts_b = obj3b[inl]
    pts_a = obj[inl]
    ok3 = np.isfinite(pts_b).all(axis=1)
    if ok3.any():
        new_pt = T.transform_points(tf, pts_b[ok3])
        d2 = np.sum((pts_a[ok3] - new_pt) ** 2, axis=1).astype(np.float32)
        org = tf[:3, 3]
        v1 = pts_a[ok3] - org
        v2 = new_pt - org
        n1 = np.linalg.norm(v1, axis=1, keepdims=True)
        n2 = np.linalg.norm(v2, axis=1, keepdims=True)
        with np.errstate(invalid="ignore", divide="ignore"):
            cosr = np.sum((v1 / n1) * (v2 / n2), axis=1)
        ang = np.arccos(np.clip(cosr, -1.0, 1.0)).astype(np.float32)
        # median via sorted[size >> 1] like the reference's std::sort pick
        ds = np.sort(d2)
        as_ = np.sort(ang)
        med_d = max(float(ds[len(ds) >> 1]), 1e-4)
        med_a = max(float(as_[len(as_) >> 1]), 1e-4)
        cov[:3, :3] *= med_d
        cov[3:, 3:] *= med_a
    info.covariance = cov

    return tf, info


def compute_transform(frame_from: Frame, frame_to: Frame,
                      guess: np.ndarray | None,
                      camera: StereoCameraModel,
                      nndr: float = 0.8, guess_win_size: float = 40.0,
                      min_inliers: int = 20, refine_iterations: int = 1,
                      seed: int = 0, device="cuda", draws=None):
    """computeTransform twin (Registration.cpp:10-30).

    guess None/null -> global matching; else guided matching.
    Returns (transform 4x4 or None, RegInfo).
    """
    if guess is None or T.is_null(guess):
        pairs = matching_no_guess(frame_from, frame_to, nndr, device)
        guess_used = None
    else:
        pairs = matching_guess(frame_from, frame_to, guess, camera,
                               nndr, guess_win_size, device)
        guess_used = guess
    return estimate_motion(frame_from, frame_to, guess_used, camera, pairs,
                           min_inliers, refine_iterations, seed, device,
                           draws)
