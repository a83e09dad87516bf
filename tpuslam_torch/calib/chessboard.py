"""Chessboard corner detection for camera calibration.

Counterpart of tpuslam/calib/chessboard.py.  Plays the role of
cv::findChessboardCorners + cornerSubPix in the reference's calibration
tool (src/stereo_calib/stereo_calib.cpp:100-220, 9x6 inner corners): a
dense saddle-point response (negative Hessian determinant of the
smoothed image) is computed in torch f32 on the device, in tpuslam's
order of operations; candidate selection, subpixel refinement and
homography-guided grid ordering run on the host over ~100 points, in
tpuslam's numpy code, copied (`_nms_candidates`, `_subpix`,
`_homography`, `_apply_h`, `_rodrigues`, `project_points`,
`_distort_inverse_grid` and the synthetic renderer `render_chessboard`,
the test oracle: known corner positions under a known homography + lens
distortion).
"""

from __future__ import annotations

import numpy as np
import torch


# ----------------------------------------------------------------- response
def saddle_response(img: torch.Tensor, sigma_taps: int = 7) -> torch.Tensor:
    """-det(Hessian) of the Gaussian-smoothed (H, W) image, f32 on the
    image's device: strongly positive at chessboard X-corners (intensity
    saddles), negative at blobs/edges.  tpuslam's sums in its order (XLA
    may contract them into FMAs, so the two agree to f32 rounding)."""
    x = img.to(torch.float32)
    # separable binomial smoothing (sigma_taps taps)
    k = np.array([1.0])
    for _ in range(sigma_taps - 1):
        k = np.convolve(k, [0.5, 0.5])
    kj = torch.as_tensor(k, dtype=torch.float32, device=x.device)
    r = sigma_taps // 2
    h, w = x.shape
    xp = torch.nn.functional.pad(x[None, None], (r, r, r, r),
                                 mode="replicate")[0, 0]
    sm = sum(kj[i] * xp[i:i + h, r:r + w] for i in range(sigma_taps))
    smp = torch.nn.functional.pad(sm[None], (r, r), mode="replicate")[0]
    sm = sum(kj[i] * smp[:, i:i + w] for i in range(sigma_taps))

    def d2(a, dim):
        up = torch.roll(a, 1, dim)
        dn = torch.roll(a, -1, dim)
        return up + dn - 2 * a

    ixx = d2(sm, 1)
    iyy = d2(sm, 0)
    ixy = (torch.roll(sm, (1, 1), (0, 1))
           + torch.roll(sm, (-1, -1), (0, 1))
           - torch.roll(sm, (1, -1), (0, 1))
           - torch.roll(sm, (-1, 1), (0, 1))) * 0.25
    resp = -(ixx * iyy - ixy * ixy)
    # zero the border (roll wraps)
    mask = torch.zeros_like(resp)
    mask[r + 1:-r - 1, r + 1:-r - 1] = 1.0
    return resp * mask


def _nms_candidates(resp: np.ndarray, n_max: int, min_dist: int = 8):
    """Greedy max selection with radius suppression -> (K,2) x,y."""
    r = resp.copy()
    h, w = r.shape
    thr = r.max() * 0.05
    out = []
    vals = []
    for _ in range(n_max):
        idx = np.argmax(r)
        y, x = divmod(idx, w)
        if r[y, x] <= thr:
            break
        out.append((x, y))
        vals.append(resp[y, x])
        y0, y1 = max(0, y - min_dist), min(h, y + min_dist + 1)
        x0, x1 = max(0, x - min_dist), min(w, x + min_dist + 1)
        r[y0:y1, x0:x1] = -np.inf
    return (np.array(out, np.float64).reshape(-1, 2),
            np.array(vals, np.float64))


def _subpix(resp: np.ndarray, pts: np.ndarray, r: int = 2) -> np.ndarray:
    """Quadratic-surface subpixel refinement of response peaks."""
    h, w = resp.shape
    out = pts.copy()
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    A = np.stack([np.ones_like(xs).ravel(), xs.ravel(), ys.ravel(),
                  (xs * xs).ravel(), (xs * ys).ravel(),
                  (ys * ys).ravel()], axis=1).astype(np.float64)
    Ainv = np.linalg.pinv(A)
    for i, (x, y) in enumerate(pts):
        xi, yi = int(round(x)), int(round(y))
        if not (r <= xi < w - r and r <= yi < h - r):
            continue
        patch = resp[yi - r:yi + r + 1, xi - r:xi + r + 1].ravel()
        c = Ainv @ patch
        # stationary point of c0 + c1 x + c2 y + c3 x^2 + c4 xy + c5 y^2
        Hm = np.array([[2 * c[3], c[4]], [c[4], 2 * c[5]]])
        g = np.array([c[1], c[2]])
        det = np.linalg.det(Hm)
        if abs(det) < 1e-12:
            continue
        d = -np.linalg.solve(Hm, g)
        if np.abs(d).max() <= 1.0:
            out[i] = (xi + d[0], yi + d[1])
    return out


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography src->dst, both (N,2), N>=4."""
    n = len(src)
    A = np.zeros((2 * n, 9))
    for i in range(n):
        x, y = src[i]
        u, v = dst[i]
        A[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        A[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    _, _, vt = np.linalg.svd(A)
    H = vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _apply_h(H: np.ndarray, pts: np.ndarray) -> np.ndarray:
    p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ H.T
    return p[:, :2] / p[:, 2:3]


def find_chessboard(img: np.ndarray, nx: int = 9, ny: int = 6,
                    device="cuda"):
    """Detect the (nx*ny) inner-corner grid.

    Returns (corners (ny*nx,2) float64 in row-major board order, ok).
    Canonical orientation: the board origin is the corner nearest the
    image top-left, rows along the long axis — consistent between the
    two cameras of a near-parallel rig.  The saddle response is computed
    on `device` (the card unless the caller asks for the CPU).
    """
    resp = saddle_response(torch.as_tensor(img, device=device)).cpu().numpy()
    need = nx * ny
    cand, vals = _nms_candidates(resp, need + 24)
    if len(cand) < need:
        return None, False
    # inner X-corners (4 squares meeting) respond far stronger than the
    # board rim's L-corners; keep only candidates near the top tier
    ref = np.sort(vals)[::-1][need - 1]
    keep = vals >= 0.45 * ref
    cand = cand[keep]
    if len(cand) < need:
        return None, False
    cand = _subpix(resp, cand)

    # 4 extreme board corners from the candidate cloud: maximize the
    # projections onto the diagonal directions
    s = cand[:, 0] + cand[:, 1]
    d = cand[:, 0] - cand[:, 1]
    quad = np.array([cand[np.argmin(s)], cand[np.argmax(d)],
                     cand[np.argmax(s)], cand[np.argmin(d)]])
    # grid corners in board coords (row-major, x fastest)
    board_quad = np.array([[0, 0], [nx - 1, 0], [nx - 1, ny - 1],
                           [0, ny - 1]], np.float64)
    # try both diagonal pairings (board may be rotated 90 deg)
    best = None
    gx, gy = np.meshgrid(np.arange(nx), np.arange(ny))
    grid = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
    for roll in range(4):
        q = np.roll(quad, roll, axis=0)
        H = _homography(board_quad, q)
        for _ in range(3):
            pred = _apply_h(H, grid)
            dists = np.linalg.norm(pred[:, None, :] - cand[None], axis=2)
            idx = np.argmin(dists, axis=1)
            res = dists[np.arange(need), idx]
            if len(np.unique(idx)) < need:
                break
            H = _homography(grid, cand[idx])
        else:
            pred = _apply_h(H, grid)
            dists = np.linalg.norm(pred[:, None, :] - cand[None], axis=2)
            idx = np.argmin(dists, axis=1)
            res = dists[np.arange(need), idx]
            if len(np.unique(idx)) == need and res.max() < 3.0:
                score = res.mean()
                if best is None or score < best[0]:
                    best = (score, cand[idx])
    if best is None:
        return None, False
    corners = best[1]
    # 180-degree ambiguity (the grid maps onto itself): canonicalize so
    # the origin corner is the one nearer the image top-left — keeps
    # left/right detections of a near-parallel rig in correspondence
    if corners[0].sum() > corners[-1].sum():
        corners = corners[::-1].copy()
    return corners, True


# ----------------------------------------------------------------- renderer
def render_chessboard(K: np.ndarray, rvec: np.ndarray, tvec: np.ndarray,
                      dist: np.ndarray | None = None, nx: int = 9,
                      ny: int = 6, square: float = 0.025,
                      size: tuple[int, int] = (640, 480),
                      supersample: int = 3) -> tuple[np.ndarray, np.ndarray]:
    """Render a chessboard under a camera model; returns (image uint8,
    true inner-corner pixel coords (ny*nx,2))."""
    from ..geometry.transform import quat_to_rot  # noqa: F401 (doc link)
    w, h = size
    R = _rodrigues(rvec)

    # board plane points for every SUPERSAMPLED pixel: invert homography
    # of the plane z=0:  p ~ K [r1 r2 t] [X Y 1]^T
    Hm = K @ np.stack([R[:, 0], R[:, 1], tvec], axis=1)
    Hinv = np.linalg.inv(Hm)
    ss = supersample
    ys, xs = np.mgrid[0:h * ss, 0:w * ss].astype(np.float64)
    xs = (xs + 0.5) / ss - 0.5
    ys = (ys + 0.5) / ss - 0.5
    if dist is not None and np.any(dist):
        xs, ys = _distort_inverse_grid(K, dist, xs, ys)
    ones = np.ones_like(xs)
    q = np.stack([xs, ys, ones], axis=-1) @ Hinv.T
    X = q[..., 0] / q[..., 2]
    Y = q[..., 1] / q[..., 2]
    # checker pattern: (nx+1) x (ny+1) squares, inner corners at
    # X=square..nx*square
    ix = np.floor(X / square).astype(np.int64)
    iy = np.floor(Y / square).astype(np.int64)
    inside = (X >= 0) & (X < (nx + 1) * square) & (Y >= 0) & \
        (Y < (ny + 1) * square)
    checker = ((ix + iy) % 2 == 0)
    img = np.where(inside, np.where(checker, 235.0, 20.0), 128.0)
    img = img.reshape(h, ss, w, ss).mean(axis=(1, 3))

    # true inner corners
    gx, gy = np.meshgrid(np.arange(1, nx + 1), np.arange(1, ny + 1))
    pts3 = np.stack([gx.ravel() * square, gy.ravel() * square,
                     np.zeros(nx * ny)], axis=1)
    proj = project_points(pts3, rvec, tvec, K, dist)
    return img.astype(np.uint8), proj


def _rodrigues(rvec: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = np.asarray(rvec, np.float64) / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def project_points(pts3: np.ndarray, rvec, tvec, K, dist=None):
    """Pinhole + radial/tangential projection (cv::projectPoints twin)."""
    R = _rodrigues(np.asarray(rvec, np.float64))
    p = pts3 @ R.T + np.asarray(tvec, np.float64)
    x = p[:, 0] / p[:, 2]
    y = p[:, 1] / p[:, 2]
    if dist is not None and np.any(dist):
        k1, k2, p1, p2 = (list(dist) + [0, 0, 0, 0])[:4]
        r2 = x * x + y * y
        rad = 1 + k1 * r2 + k2 * r2 * r2
        xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = xd, yd
    u = K[0, 0] * x + K[0, 2]
    v = K[1, 1] * y + K[1, 2]
    return np.stack([u, v], axis=1)


def _distort_inverse_grid(K, dist, xs, ys):
    """For rendering through a distorting lens: map ideal pixel grid to
    the undistorted ray grid by Newton inversion of the distortion."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    xn = (xs - cx) / fx
    yn = (ys - cy) / fy
    k1, k2, p1, p2 = (list(dist) + [0, 0, 0, 0])[:4]
    xu, yu = xn.copy(), yn.copy()
    for _ in range(8):
        r2 = xu * xu + yu * yu
        rad = 1 + k1 * r2 + k2 * r2 * r2
        dx = 2 * p1 * xu * yu + p2 * (r2 + 2 * xu * xu)
        dy = p1 * (r2 + 2 * yu * yu) + 2 * p2 * xu * yu
        xu = (xn - dx) / rad
        yu = (yn - dy) / rad
    return xu * fx + cx, yu * fy + cy
