"""Bundle adjustment with a Schur complement, in PyTorch.

Counterpart of tpuslam/optim/ba.py: fixed-capacity observation arrays (O
observations of L landmarks from W cameras, masked validity), analytic
per-observation Jacobians computed for all observations at once (the
batch dimension written out where tpuslam vmaps), the normal equations
assembled as dense camera and camera-landmark blocks by segment sums
(optim/segment.py, in observation order on every device), landmarks
eliminated by the Schur complement (H_ll is (L, 3, 3) block-diagonal,
inverted in closed form), and the reduced
camera system solved by torch.linalg.solve (tpuslam solves it outside any
Pallas kernel too).  All f32, on the tensors' device.

Gauge: the first `n_fixed` cameras are held fixed.
"""

from __future__ import annotations

import torch

from .segment import segment_sum as _segment_sum


def project(Tcw: torch.Tensor, X: torch.Tensor, intr: torch.Tensor):
    """Pinhole projection of world points X (..., 3) by cam-from-world
    poses Tcw (..., 4, 4) -> (uv (..., 2), camera-frame p (..., 3))."""
    p = (Tcw[..., :3, :3] @ X[..., None])[..., 0] + Tcw[..., :3, 3]
    z = torch.clamp(p[..., 2], min=1e-6)
    u = intr[0] * p[..., 0] / z + intr[2]
    v = intr[1] * p[..., 1] / z + intr[3]
    return torch.stack([u, v], dim=-1), p


def _obs_residual_jac(Tcw, X, uv, intr):
    """Residuals (O, 2) and Jacobians wrt the camera se3 twist (O, 2, 6)
    and the landmark (O, 2, 3).  Camera update: Tcw <- exp([w, t]) Tcw."""
    proj_uv, p = project(Tcw, X, intr)
    r = proj_uv - uv
    x, y = p[:, 0], p[:, 1]
    zi = 1.0 / torch.clamp(p[:, 2], min=1e-6)
    fx, fy = intr[0], intr[1]
    zero = torch.zeros_like(zi)
    # d(u, v)/dp in the camera frame
    J_p = torch.stack([torch.stack([fx * zi, zero, -fx * x * zi * zi], -1),
                       torch.stack([zero, fy * zi, -fy * y * zi * zi], -1)],
                      dim=-2)                                   # (O, 2, 3)
    # dp/d(twist): rotation part -[p]x, translation part I
    pz = torch.zeros_like(p[:, 0])
    px = torch.stack([torch.stack([pz, -p[:, 2], p[:, 1]], -1),
                      torch.stack([p[:, 2], pz, -p[:, 0]], -1),
                      torch.stack([-p[:, 1], p[:, 0], pz], -1)], dim=-2)
    J_c = torch.cat([J_p @ (-px), J_p], dim=-1)                  # (O, 2, 6)
    J_l = J_p @ Tcw[:, :3, :3]                                   # (O, 2, 3)
    return r, J_c, J_l


def _huber_w(r2, delta):
    """Huber IRLS weight for a squared residual norm."""
    rn = torch.sqrt(r2 + 1e-12)
    return torch.where(rn <= delta, 1.0, delta / rn)


def ba_normal_equations(Tcw, lms, intr, obs_cam, obs_lm, obs_uv,
                        obs_valid, n_cams, n_lms,
                        huber_delta=float("inf")):
    """Assemble the BA normal equations.

    Returns (H_cc (W, 6, 6) diagonal blocks, b_c (W, 6),
    H_cl (W, L, 6, 3), H_ll (L, 3, 3), b_l (L, 3), cost)."""
    Tc = Tcw[obs_cam]
    X = lms[obs_lm]
    r, J_c, J_l = _obs_residual_jac(Tc, X, obs_uv, intr)
    # cheirality: a landmark behind the camera would blow up the f32
    # normal equations through the 1/z terms -- mask it
    z = torch.sum(Tc[:, 2, :3] * X, dim=-1) + Tc[:, 2, 3]
    valid = obs_valid.float() * (z > 0.1)
    r2 = torch.sum(r * r, dim=-1)
    w = _huber_w(r2, huber_delta) * valid
    sw = torch.sqrt(w)[:, None, None]
    J_c = J_c * sw
    J_l = J_l * sw
    rw = r * torch.where(obs_valid, 1.0, 0.0)[:, None]

    # camera blocks, scattered by observation camera index
    H_cc = _segment_sum(torch.einsum("oki,okj->oij", J_c, J_c), obs_cam,
                        n_cams)
    b_c = _segment_sum(torch.einsum("oki,ok->oi", J_c, rw), obs_cam, n_cams)
    # landmark blocks
    H_ll = _segment_sum(torch.einsum("oki,okj->oij", J_l, J_l), obs_lm,
                        n_lms)
    b_l = _segment_sum(torch.einsum("oki,ok->oi", J_l, rw), obs_lm, n_lms)
    # cross terms, scattered into (W * L, 6, 3)
    H_cl = _segment_sum(torch.einsum("oki,okj->oij", J_c, J_l),
                        obs_cam * n_lms + obs_lm, n_cams * n_lms)
    return (H_cc, b_c, H_cl.reshape(n_cams, n_lms, 6, 3), H_ll, b_l,
            torch.sum(w * r2))


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det), f32-robust where
    a batched LU can emit NaNs on ill-conditioned blocks."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    K = a * e - b * d
    det = a * A + d * B + g * C
    det = torch.where(det.abs() < 1e-20, 1e-20, det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, F], -1),
                       torch.stack([G, H, K], -1)], -2)
    return adj / det[..., None, None]


def _se3_exp(tw):
    """Exponential map of twists [w (3,), t (3,)] (n, 6) -> (n, 4, 4):
    Rodrigues rotation, translation coupled through V."""
    w, t = tw[:, :3], tw[:, 3:]
    th = torch.linalg.vector_norm(w, dim=-1) + 1e-12
    k = w / th[:, None]
    z = torch.zeros_like(th)
    Kx = torch.stack([torch.stack([z, -k[:, 2], k[:, 1]], -1),
                      torch.stack([k[:, 2], z, -k[:, 0]], -1),
                      torch.stack([-k[:, 1], k[:, 0], z], -1)], dim=-2)
    KK = Kx @ Kx
    eye = torch.eye(3, dtype=tw.dtype, device=tw.device)
    s, c = torch.sin(th)[:, None, None], torch.cos(th)[:, None, None]
    th2 = (th * th)[:, None, None]
    R = eye + s * Kx + (1 - c) * KK
    A = s / th[:, None, None]
    V = eye + (1 - c) / th2 * Kx + (1 - A) / th2 * KK
    T = torch.eye(4, dtype=tw.dtype, device=tw.device).repeat(len(tw), 1, 1)
    T[:, :3, :3] = R
    T[:, :3, 3] = (V @ t[..., None])[..., 0]
    return T


def ba_solve(Tcw, lms, intr, obs_cam, obs_lm, obs_uv, obs_valid,
             n_cams, n_lms, iterations=5, damping=1e-4,
             huber_delta=float("inf"), n_fixed=1):
    """Windowed BA: damped Gauss-Newton with Schur elimination of the
    landmarks, a step kept only when it lowers the robust cost.

    The first `n_fixed` cameras are gauge-fixed (2 for monocular
    problems to pin scale; 1 when landmarks carry metric scale, e.g.
    stereo-triangulated).  Returns (Tcw', lms', cost)."""
    dev = Tcw.device
    valid_f = obs_valid.float()

    def eval_cost(Tcw, lms):
        Tc = Tcw[obs_cam]
        X = lms[obs_lm]
        r = project(Tc, X, intr)[0] - obs_uv
        z = torch.sum(Tc[:, 2, :3] * X, dim=-1) + Tc[:, 2, 3]
        r2 = torch.sum(r * r, dim=-1)
        w = _huber_w(r2, huber_delta) * valid_f * (z > 0.1)
        return torch.sum(w * r2)

    n6 = 6 * n_cams
    mask = torch.ones(n6, dtype=torch.float32, device=dev)
    mask[:6 * n_fixed] = 0.0
    cams = torch.arange(n_cams, device=dev)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    lam = torch.tensor(damping, dtype=torch.float32, device=dev)
    cost = eval_cost(Tcw, lms)
    for _ in range(iterations):
        H_cc, b_c, H_cl, H_ll, b_l, _ = ba_normal_equations(
            Tcw, lms, intr, obs_cam, obs_lm, obs_uv, obs_valid,
            n_cams, n_lms, huber_delta)

        # LM: relative damping on the landmark blocks and camera diagonal
        tr = torch.diagonal(H_ll, dim1=1, dim2=2).sum(-1) / 3.0
        Hll_inv = _inv3x3(H_ll + (lam * tr + 1e-3)[:, None, None] * eye3)

        # reduced camera system: S = Hcc - sum_j Wj Hll_j^-1 Wj^T
        WHinv = torch.einsum("wlij,ljk->wlik", H_cl, Hll_inv)
        S = -torch.einsum("wlik,vljk->wvij", WHinv, H_cl)      # (W, W, 6, 6)
        b_corr = torch.einsum("wlik,lk->wi", WHinv, b_l)
        diag_damp = torch.diag_embed(
            lam * torch.diagonal(H_cc, dim1=1, dim2=2) + 1e-6)
        S[cams, cams] = S[cams, cams] + H_cc + diag_damp
        S = S.permute(0, 2, 1, 3).reshape(n6, n6)
        rhs = (b_c - b_corr).reshape(-1)

        # gauge: fix the first n_fixed cameras
        S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        dx_c = -torch.linalg.solve(S, rhs * mask).reshape(n_cams, 6)

        # back-substitute the landmarks: dx_l = -Hll^-1 (b_l + H_lc dx_c)
        Hlc_dx = torch.einsum("wlij,wi->lj", H_cl, dx_c)
        dx_l = -torch.einsum("lij,lj->li", Hll_inv, b_l + Hlc_dx)

        Tcw_try = _se3_exp(dx_c) @ Tcw
        lms_try = lms + dx_l
        cost_try = eval_cost(Tcw_try, lms_try)
        accept = cost_try < cost
        Tcw = torch.where(accept, Tcw_try, Tcw)
        lms = torch.where(accept, lms_try, lms)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-7),
                          torch.clamp(lam * 5.0, max=1e3))
        cost = torch.where(accept, cost_try, cost)
    return Tcw, lms, cost
