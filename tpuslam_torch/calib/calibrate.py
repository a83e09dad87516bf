"""Camera + stereo-rig calibration from chessboard views.

Counterpart of tpuslam/calib/calibrate.py, the twin of the reference's
offline tool (src/stereo_calib/stereo_calib.cpp: cv::stereoCalibrate
:220, cv::stereoRectify :285, YAML outputs :303-316): Zhang's
closed-form intrinsics initialization on the host (tpuslam's numpy code,
copied: `board_points`, `init_intrinsics`, `init_extrinsics`, `_rvec`,
`stereo_rectify`, and the LM loop `_lm`), then a Levenberg-Marquardt
bundle refinement whose reprojection residuals and Jacobians are one
batched torch program over all (view, corner) pairs on the device
(`torch.func.jacfwd` over a `torch.func.vmap` of the views; no
hand-derived derivative code) and whose damped normal equations are
solved by `torch.linalg.solve`.

The refinement runs in float32, as tpuslam's does (JAX's 64-bit mode is
off there, so its float64 parameters enter the jitted step as float32).
Its accept test lies below one float32 ulp, so the two may take
different accept/reject paths and agree to a tolerance, not bit for bit.

Distortion model: k1, k2 radial (+ p1, p2 tangential slots, estimated
but typically ~0 for the synthetic/test rigs).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .chessboard import _homography, _rodrigues


def board_points(nx: int, ny: int, square: float) -> np.ndarray:
    gx, gy = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1))
    return np.stack([gx.ravel() * square, gy.ravel() * square,
                     np.zeros(nx * ny)], axis=1)


# ------------------------------------------------------------- Zhang init
def _v_ij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j]])


def init_intrinsics(homographies: list[np.ndarray],
                    size: tuple[int, int]) -> np.ndarray:
    """Zhang's method: K from >= 3 plane homographies (fallback to
    principal point at image center + common focal for 2 views)."""
    V = []
    for H in homographies:
        V.append(_v_ij(H, 0, 1))
        V.append(_v_ij(H, 0, 0) - _v_ij(H, 1, 1))
    V = np.stack(V)
    _, _, vt = np.linalg.svd(V)
    b = vt[-1]
    B11, B12, B22, B13, B23, B33 = b
    den = B11 * B22 - B12 * B12
    if abs(den) < 1e-16:
        return _fallback_K(homographies, size)
    cy = (B12 * B13 - B11 * B23) / den
    lam = B33 - (B13 * B13 + cy * (B12 * B13 - B11 * B23)) / B11
    if lam / B11 <= 0 or den <= 0:
        return _fallback_K(homographies, size)
    fx = np.sqrt(lam / B11)
    fy = np.sqrt(lam * B11 / den)
    cx = -B13 * fx * fx / lam
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    if not np.isfinite(K).all() or fx < 10 or fy < 10:
        return _fallback_K(homographies, size)
    return K


def _fallback_K(homographies, size):
    """Assume center principal point; solve focal from the orthogonality
    constraint of each homography."""
    w, h = size
    cx, cy = (w - 1) / 2, (h - 1) / 2
    f2 = []
    for H in homographies:
        h1 = H[:, 0].copy()
        h2 = H[:, 1].copy()
        h1[0] -= cx * h1[2]
        h1[1] -= cy * h1[2]
        h2[0] -= cx * h2[2]
        h2[1] -= cy * h2[2]
        num = -(h1[0] * h2[0] + h1[1] * h2[1])
        den = h1[2] * h2[2]
        if abs(den) > 1e-12 and num / den > 0:
            f2.append(num / den)
    f = np.sqrt(np.median(f2)) if f2 else max(w, h)
    return np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float64)


def init_extrinsics(H: np.ndarray, K: np.ndarray):
    """Plane pose from homography: H = K [r1 r2 t]."""
    A = np.linalg.solve(K, H)
    s = (np.linalg.norm(A[:, 0]) + np.linalg.norm(A[:, 1])) / 2
    if A[2, 2] < 0:
        A = -A
    r1 = A[:, 0] / np.linalg.norm(A[:, 0])
    r2 = A[:, 1] - r1 * (r1 @ A[:, 1])
    r2 /= np.linalg.norm(r2)
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    t = A[:, 2] / s
    return _rvec(R), t


def _rvec(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-12:
        return np.zeros(3)
    axis = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]]) / (2 * np.sin(th))
    return axis * th


def _lm(residual_step, params, args, iters=30):
    lam = 1e-3
    cost = None
    for _ in range(iters):
        new_params, new_cost = residual_step(params, *args, lam)
        if cost is None or float(new_cost) <= float(cost) * (1 + 1e-12):
            params, cost, lam = new_params, new_cost, max(lam / 3, 1e-9)
        else:
            lam = min(lam * 10, 1e6)
    return params, float(cost) if cost is not None else np.inf


# ------------------------------------------------ batched LM (torch) -----
def _rodrigues_j(rvec):
    th = torch.linalg.norm(rvec) + 1e-12
    k = rvec / th
    z = torch.zeros_like(th)
    Kx = torch.stack([torch.stack([z, -k[2], k[1]]),
                      torch.stack([k[2], z, -k[0]]),
                      torch.stack([-k[1], k[0], z])])
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return (eye + torch.sin(th) * Kx
            + (1 - torch.cos(th)) * (Kx @ Kx))


def _distort(x, y, intr):
    """Pinhole + radial/tangential pixel coords of normalized (x, y);
    intr = [fx, fy, cx, cy, k1, k2, p1, p2]."""
    k1, k2, p1, p2 = intr[4], intr[5], intr[6], intr[7]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([intr[0] * xd + intr[2], intr[1] * yd + intr[3]],
                       dim=1)


def _project_j(pts3, rvec, tvec, intr):
    """intr = [fx, fy, cx, cy, k1, k2, p1, p2]."""
    R = _rodrigues_j(rvec)
    p = pts3 @ R.T + tvec
    return _distort(p[:, 0] / p[:, 2], p[:, 1] / p[:, 2], intr)


def _mono_residual(params, pts3, obs, n_views):
    intr = params[:8]
    ext = params[8:].reshape(n_views, 6)
    proj = vmap(lambda e: _project_j(pts3, e[:3], e[3:], intr))(ext)
    return (proj - obs).reshape(-1)


def _lm_step(residual, params, args, lam):
    """One damped Gauss-Newton step of `residual(params, *args)`:
    (params - delta, the squared residual norm at params)."""
    r = residual(params, *args)
    J = jacfwd(residual)(params, *args)
    H = J.T @ J
    g = J.T @ r
    Hd = H + lam * torch.diag(torch.diag(H) + 1e-9)
    delta = torch.linalg.solve(Hd, g)
    return params - delta, torch.sum(r * r)


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def calibrate_camera(corners: list[np.ndarray], nx: int, ny: int,
                     square: float, size: tuple[int, int], device="cuda"):
    """Mono calibration, refined on `device` (the card unless the caller
    asks for the CPU).  Returns (K, dist(4,), rvecs, tvecs, rms_px)."""
    pts3 = board_points(nx, ny, square)
    grid = pts3[:, :2]
    Hs = [_homography(grid, c) for c in corners]
    K = init_intrinsics(Hs, size)
    exts = [np.concatenate(init_extrinsics(H, K)) for H in Hs]
    n_views = len(corners)
    params = np.concatenate([
        [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0],
        np.concatenate(exts)]).astype(np.float64)
    obs = np.stack(corners).astype(np.float64)

    args = (_f32(pts3, device), _f32(obs, device), n_views)
    step = lambda p, lam: _lm_step(  # noqa: E731
        _mono_residual, _f32(p, device), args, _f32(lam, device))
    params, cost = _lm(step, params, ())
    params = params.cpu().numpy()
    K = np.array([[params[0], 0, params[2]], [0, params[1], params[3]],
                  [0, 0, 1]])
    dist = params[4:8]
    ext = params[8:].reshape(n_views, 6)
    rms = np.sqrt(cost / (n_views * len(pts3)))
    return K, dist, ext[:, :3], ext[:, 3:], rms


def _stereo_residual(params, pts3, obs_l, obs_r, intr_l, intr_r, n_views):
    rT = params[:6]
    ext = params[6:].reshape(n_views, 6)
    R_lr = _rodrigues_j(rT[:3])

    def per_view(e):
        pl = _project_j(pts3, e[:3], e[3:], intr_l)
        Rl = _rodrigues_j(e[:3])
        # right camera: X_r = R_lr (Rl X + tl) + T
        Rr = R_lr @ Rl
        tr = R_lr @ e[3:] + rT[3:]
        p_cam = pts3 @ Rr.T + tr
        pr = _distort(p_cam[:, 0] / p_cam[:, 2], p_cam[:, 1] / p_cam[:, 2],
                      intr_r)
        return pl, pr

    pl, pr = vmap(per_view)(ext)
    return torch.cat([(pl - obs_l).reshape(-1), (pr - obs_r).reshape(-1)])


def stereo_calibrate(corners_l: list[np.ndarray],
                     corners_r: list[np.ndarray], nx: int, ny: int,
                     square: float, size: tuple[int, int], device="cuda"):
    """cv::stereoCalibrate twin, refined on `device` (the card unless the
    caller asks for the CPU).  Returns dict with K1,D1,K2,D2,R,T,rms."""
    K1, D1, rv1, tv1, _ = calibrate_camera(corners_l, nx, ny, square,
                                           size, device=device)
    K2, D2, rv2, tv2, _ = calibrate_camera(corners_r, nx, ny, square,
                                           size, device=device)
    n_views = len(corners_l)
    # initial R,T: median over per-view relative poses
    Rs, Ts = [], []
    for i in range(n_views):
        Rl, Rr = _rodrigues(rv1[i]), _rodrigues(rv2[i])
        R = Rr @ Rl.T
        Tv = tv2[i] - R @ tv1[i]
        Rs.append(_rvec(R))
        Ts.append(Tv)
    rT0 = np.concatenate([np.median(Rs, axis=0), np.median(Ts, axis=0)])

    pts3 = board_points(nx, ny, square)
    params = np.concatenate(
        [rT0] + [np.concatenate([rv1[i], tv1[i]]) for i in range(n_views)])
    intr_l = np.concatenate([[K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2]], D1])
    intr_r = np.concatenate([[K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]], D2])
    obs_l = np.stack(corners_l).astype(np.float64)
    obs_r = np.stack(corners_r).astype(np.float64)

    args = tuple(_f32(a, device)
                 for a in (pts3, obs_l, obs_r, intr_l, intr_r)) + (n_views,)
    step = lambda p, lam: _lm_step(  # noqa: E731
        _stereo_residual, _f32(p, device), args, _f32(lam, device))
    params, cost = _lm(step, params, ())
    params = params.cpu().numpy()
    R = _rodrigues(params[:3])
    Tv = params[3:6]
    rms = np.sqrt(cost / (2 * n_views * len(pts3)))
    return {"K1": K1, "D1": D1, "K2": K2, "D2": D2, "R": R, "T": Tv,
            "rms": rms}


# ----------------------------------------------------------- stereoRectify
def stereo_rectify(K1, D1, K2, D2, size, R, T):
    """cv::stereoRectify twin (no alpha scaling): returns R1, R2, P1, P2.

    Both cameras rotate to a common frame whose x-axis is the baseline;
    the new rotation splits R evenly between the two views.
    """
    rv = _rvec(R)
    # split R evenly: X_r' = R2 X_r, X_l' = R1 X_l with R1 = R2 @ R so
    # both new frames share one orientation; T' = R2 @ T
    R_half_l = _rodrigues(rv / 2)
    R_half_r = _rodrigues(-rv / 2)
    t = R_half_r @ T

    # x-axis along the baseline
    e1 = t / np.linalg.norm(t)
    if abs(t[0]) >= abs(t[1]):
        sgn = -1.0 if t[0] < 0 else 1.0
    else:
        sgn = -1.0 if t[1] < 0 else 1.0
    e1 = e1 * sgn
    e2 = np.cross(np.array([0, 0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3], axis=0)

    R1 = Rrect @ R_half_l
    R2 = Rrect @ R_half_r

    f = (K1[1, 1] + K2[1, 1]) / 2
    w, h = size
    cx = (w - 1) / 2
    cy = (h - 1) / 2
    P1 = np.array([[f, 0, cx, 0], [0, f, cy, 0], [0, 0, 1, 0]])
    tx = float((R2 @ T)[0] if abs(t[0]) >= abs(t[1]) else (R2 @ T)[1])
    P2 = P1.copy()
    P2[0, 3] = f * tx
    return R1, R2, P1, P2
