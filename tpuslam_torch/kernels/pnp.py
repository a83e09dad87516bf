"""Batched EPnP + RANSAC and the LM refine in PyTorch.

Counterpart of tpuslam/kernels/pnp.py.  All 300 RANSAC hypotheses
are solved at once; every small decomposition (Cholesky, 3x3 eigh, Horn)
is unrolled into arithmetic on the matrix components, as in the JAX
version, so the f32 operation order is the same.  A "scalar" here is a
tensor that carries the batch shape (for example (n_hyp,)); EPnP's three
beta-approximation cases ride one more trailing axis of size 3.

The LM refine (`refine_lm`, `refine_lm_with_errors`) is the plain
version of kernel K6 (csrc/lm_refine.cu), which replaces the Pallas
kernel `_refine_lm_errors_kernel`; `refine_lm_with_errors_auto` sends a
CUDA tensor to K6 and a CPU tensor to the plain version.  The two agree
to f32 reduction order (rvec 1e-5, tvec 1e-4, the same inliers at 2 px:
the JAX suite's own Pallas-vs-XLA tolerance, tests/test_pnp.py:127-133).

Hypothesis draws: JAX draws them with jax.random.uniform(PRNGKey(frame)),
a stream torch cannot reproduce, so `ransac_epnp` takes the (n_hyp, m)
uniforms as an argument.  Tests pass JAX's own draws; runs draw from a
torch.Generator.
"""

from __future__ import annotations

import math

from . import _cuda

import numpy as np
import torch

# ---------------------------------------------------------------------------
# geometry helpers
# ---------------------------------------------------------------------------

def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of a 1-D tensor (jnp.argmax)."""
    n = x.shape[0]
    idx = torch.arange(n, device=x.device)
    return torch.where(x == x.max(), idx, n).min()


def rodrigues(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (3,) -> rotation matrix (3,3).  Small-angle safe."""
    rvec = rvec.float()
    theta = torch.sqrt(torch.sum(rvec * rvec) + 1e-24)
    k = rvec / theta
    z = torch.zeros_like(theta)
    K = torch.stack([torch.stack([z, -k[2], k[1]]),
                     torch.stack([k[2], z, -k[0]]),
                     torch.stack([-k[1], k[0], z])])
    s, c = torch.sin(theta), torch.cos(theta)
    eye = torch.eye(3, dtype=torch.float32, device=rvec.device)
    R = eye + s * K + (1.0 - c) * (K @ K)
    Rsmall = eye + torch.stack([torch.stack([z, -rvec[2], rvec[1]]),
                                torch.stack([rvec[2], z, -rvec[0]]),
                                torch.stack([-rvec[1], rvec[0], z])])
    return torch.where(theta < 1e-7, Rsmall, R)


def rodrigues_inv(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (3,3) -> axis-angle (3,)."""
    R = R.float()
    c = torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.acos(c)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                     R[1, 0] - R[0, 1]])
    s2 = torch.sqrt(torch.sum(v * v)) + 1e-24     # = 2 sin(theta)
    axis = v / s2
    # theta ~ pi fallback: axis from the largest-diagonal column
    i = _first_argmax(torch.diagonal(R))
    eye = torch.eye(3, dtype=torch.float32, device=R.device)
    col = R[:, i] + eye[:, i]
    axis_pi = col / (torch.linalg.vector_norm(col) + 1e-24)
    sign = torch.where(v[i] >= 0, 1.0, -1.0)
    axis = torch.where(theta > 3.1415, sign * axis_pi, axis)
    return torch.where(theta < 1e-7, v * 0.5, axis * theta)


def project_norm(pts3d: torch.Tensor, R: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) world points -> (..., N, 2) normalized image coords,
    for (..., 3, 3) R and (..., 3) t."""
    pc = pts3d @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2:3]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    return pc[..., :2] / z


def pixel_err2(proj_n, img_n, fx, fy):
    """Squared pixel reprojection error from normalized residuals."""
    d = proj_n - img_n
    return (d[..., 0] * fx) ** 2 + (d[..., 1] * fy) ** 2


def normalize_points(img: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    return torch.stack([(img[..., 0] - cx) / fx, (img[..., 1] - cy) / fy],
                       dim=-1)


# ---------------------------------------------------------------------------
# unrolled small linear algebra on scalar components
# ---------------------------------------------------------------------------

def _chol_s(A, n):
    """Unrolled Cholesky of an n x n PSD matrix given as nested lists of
    scalars.  Returns lower-triangular L as nested lists."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        d = A[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(d, min=1e-30))
        inv_d = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol_solve_s(L, b, n):
    """Solve L L^T x = b (unrolled); L entries broadcast against b's."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _inv3_s(M):
    """General 3x3 inverse via adjugate (scalar comps)."""
    a, b, c = M[0]
    d, e, f = M[1]
    g, h, i = M[2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(det.abs() < 1e-30,
                                torch.where(det < 0, -1e-30, 1e-30), det)
    return (((e * i - f * h) * inv_det, -(b * i - c * h) * inv_det,
             (b * f - c * e) * inv_det),
            (-(d * i - f * g) * inv_det, (a * i - c * g) * inv_det,
             -(a * f - c * d) * inv_det),
            ((d * h - e * g) * inv_det, -(a * h - b * g) * inv_det,
             (a * e - b * d) * inv_det))


def _dot3_s(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross3_s(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def _norm3_s(a):
    return torch.sqrt(torch.clamp(_dot3_s(a, a), min=1e-30))


def _matmul3_s(A, B):
    return tuple(tuple(sum(A[i][k] * B[k][j] for k in range(3))
                       for j in range(3)) for i in range(3))


def _rodrigues_s(w):
    """Axis-angle 3-tuple -> rotation matrix as nested tuples."""
    th2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2]
    theta = torch.sqrt(th2 + 1e-24)
    kx, ky, kz = w[0] / theta, w[1] / theta, w[2] / theta
    s, c = torch.sin(theta), torch.cos(theta)
    one_c = 1.0 - c
    small = theta < 1e-7
    one = torch.ones_like(theta)

    def entry(big, sm):
        return torch.where(small, sm, big)

    return (
        (entry(c + one_c * kx * kx, one),
         entry(one_c * kx * ky - s * kz, -w[2]),
         entry(one_c * kx * kz + s * ky, w[1])),
        (entry(one_c * ky * kx + s * kz, w[2]),
         entry(c + one_c * ky * ky, one),
         entry(one_c * ky * kz - s * kx, -w[0])),
        (entry(one_c * kz * kx - s * ky, -w[1]),
         entry(one_c * kz * ky + s * kx, w[0]),
         entry(c + one_c * kz * kz, one)),
    )


def _eigh3_s(a00, a01, a02, a11, a12, a22):
    """Closed-form (Smith) symmetric 3x3 eigendecomposition, ascending.
    Returns ((w0, w1, w2), V) with V[i][k] = component i of eigenvector k."""
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=1e-30))
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02)) / (p * p * p)
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    w2 = q + 2.0 * p * torch.cos(phi)
    w0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    w1 = 3.0 * q - w0 - w2

    def eigvec(lam):
        r0 = (a00 - lam, a01, a02)
        r1 = (a01, a11 - lam, a12)
        r2 = (a02, a12, a22 - lam)
        c01 = _cross3_s(r0, r1)
        c02 = _cross3_s(r0, r2)
        c12 = _cross3_s(r1, r2)
        n01 = _dot3_s(c01, c01)
        n02 = _dot3_s(c02, c02)
        n12 = _dot3_s(c12, c12)
        use01 = n01 >= torch.maximum(n02, n12)
        use02 = n02 >= n12
        v = tuple(torch.where(use01, c01[i],
                              torch.where(use02, c02[i], c12[i]))
                  for i in range(3))
        nv = torch.maximum(torch.sqrt(n01),
                           torch.maximum(torch.sqrt(n02), torch.sqrt(n12)))
        nv = torch.clamp(nv, min=1e-30)
        return tuple(v[i] / nv for i in range(3))

    v0 = eigvec(w0)
    v2 = eigvec(w2)
    v1 = _cross3_s(v2, v0)
    n1 = _norm3_s(v1)
    v1 = tuple(v1[i] / n1 for i in range(3))
    V = tuple((v0[i], v1[i], v2[i]) for i in range(3))
    return (w0, w1, w2), V


_SUBSPACE_X0 = np.linalg.qr(
    np.random.default_rng(42).standard_normal((12, 8)))[0].astype(np.float32)
_x0_on: dict = {}


def _subspace_x0(k: int, device) -> torch.Tensor:
    """The fixed inverse-iteration start basis, (12, k), cached per device
    so a frame costs no host-to-device copy."""
    key = (k, str(device))
    if key not in _x0_on:
        _x0_on[key] = torch.as_tensor(_SUBSPACE_X0[:, :k], device=device)
    return _x0_on[key]


def _smallest_eigvecs_12_s(A, k: int = 4, iters: int = 6):
    """The k eigenvectors of smallest eigenvalue of a 12x12 PSD matrix of
    scalar components, ascending: deflated shifted inverse iteration with
    ordered modified Gram-Schmidt.  The k columns ride a trailing (k,)
    axis.  Returns a list of k columns, each a list of 12 scalars."""
    tr = A[0][0]
    for i in range(1, 12):
        tr = tr + A[i][i]
    sigma = 1e-4 * (tr / 12.0) + 1e-12
    Ash = [[A[i][j] + sigma if i == j else A[i][j] for j in range(12)]
           for i in range(12)]
    L = _chol_s(Ash, 12)
    Lk = [[None if x is None else x[..., None] for x in row] for row in L]

    x0 = _subspace_x0(k, tr.device)
    X = [x0[i] for i in range(12)]                   # (k,) each
    cols = []
    for _ in range(iters):
        Y = _chol_solve_s(Lk, X, 12)
        cols = []
        for j in range(k):
            v = [Y[i][..., j] for i in range(12)]
            for u in cols:
                d = v[0] * u[0]
                for i in range(1, 12):
                    d = d + v[i] * u[i]
                v = [v[i] - d * u[i] for i in range(12)]
            nrm2 = v[0] * v[0]
            for i in range(1, 12):
                nrm2 = nrm2 + v[i] * v[i]
            nrm = torch.sqrt(torch.clamp(nrm2, min=1e-30))
            cols.append([v[i] / nrm for i in range(12)])
        X = [torch.stack([cols[j][i] for j in range(k)], dim=-1)
             for i in range(12)]
    return cols


def _horn_core_s(P0, c0, pcs, n: int):
    """Absolute orientation on scalar components: R, t with
    pcs ~= R pws + t, where pws = c0 + P0 (pre-centered world points);
    closed-form Kabsch plus two orthogonal-Procrustes polish steps."""
    inv_n = 1.0 / n
    cc = tuple(sum(pcs[p][i] for p in range(n)) * inv_n for i in range(3))
    C = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            s = (pcs[0][i] - cc[i]) * P0[0][j]
            for p in range(1, n):
                s = s + (pcs[p][i] - cc[i]) * P0[p][j]
            C[i][j] = s

    def b_entry(i, j):
        return C[0][i] * C[0][j] + C[1][i] * C[1][j] + C[2][i] * C[2][j]

    (w0, w1, w2), V = _eigh3_s(b_entry(0, 0), b_entry(0, 1), b_entry(0, 2),
                               b_entry(1, 1), b_entry(1, 2), b_entry(2, 2))
    s1 = torch.sqrt(torch.clamp(w1, min=1e-20))
    s2 = torch.sqrt(torch.clamp(w2, min=1e-20))
    v1 = (V[0][1], V[1][1], V[2][1])
    v2 = (V[0][2], V[1][2], V[2][2])
    u2 = tuple(_dot3_s(C[i], v2) / s2 for i in range(3))
    u1 = tuple(_dot3_s(C[i], v1) / s1 for i in range(3))
    n2 = _norm3_s(u2)
    u2 = tuple(u2[i] / n2 for i in range(3))
    d12 = _dot3_s(u1, u2)
    u1 = tuple(u1[i] - d12 * u2[i] for i in range(3))
    n1 = _norm3_s(u1)
    u1 = tuple(u1[i] / n1 for i in range(3))
    u0 = _cross3_s(u1, u2)
    v0 = (V[0][0], V[1][0], V[2][0])
    R = [[u0[i] * v0[j] + u1[i] * v1[j] + u2[i] * v2[j]
          for j in range(3)] for i in range(3)]
    for _ in range(2):
        E = [[R[0][i] * C[0][j] + R[1][i] * C[1][j] + R[2][i] * C[2][j]
              for j in range(3)] for i in range(3)]
        a = (0.5 * (E[2][1] - E[1][2]),
             0.5 * (E[0][2] - E[2][0]),
             0.5 * (E[1][0] - E[0][1]))
        trS = E[0][0] + E[1][1] + E[2][2]
        Hs = [[None] * 3 for _ in range(3)]
        for i in range(3):
            for j in range(3):
                sij = 0.5 * (E[i][j] + E[j][i])
                Hs[i][j] = (trS - sij + 1e-9) if i == j else -sij
        Hi = _inv3_s(Hs)
        wv = tuple(2.0 * _dot3_s(Hi[i], a) for i in range(3))
        R = _matmul3_s(R, _rodrigues_s(wv))
    t = tuple(cc[i] - _dot3_s(R[i], c0) for i in range(3))
    return R, t


_CP_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


# ---------------------------------------------------------------------------
# EPnP
# ---------------------------------------------------------------------------

def epnp_norm(obj: torch.Tensor, img_n: torch.Tensor):
    """EPnP for minimal samples, observations in normalized coords.

    obj (..., n, 3), img_n (..., n, 2) f32.  Returns (R (..., 3, 3),
    t (..., 3), ok (...)) with pc = R pw + t.  Mirrors OpenCV's epnp class
    (control points, barycentric coordinates, MtM null space, betas by
    approximations 1-3 + Gauss-Newton, Horn) in tpuslam's unrolled form."""
    obj = obj.float()
    img_n = img_n.float()
    n = obj.shape[-2]
    ox = [obj[..., p, 0] for p in range(n)]
    oy = [obj[..., p, 1] for p in range(n)]
    oz = [obj[..., p, 2] for p in range(n)]
    uu = [img_n[..., p, 0] for p in range(n)]
    vv = [img_n[..., p, 1] for p in range(n)]
    inv_n = 1.0 / n

    # control points: centroid + principal axes
    c0 = (sum(ox) * inv_n, sum(oy) * inv_n, sum(oz) * inv_n)
    P0 = [(ox[p] - c0[0], oy[p] - c0[1], oz[p] - c0[2]) for p in range(n)]

    def cov_entry(i, j):
        s = P0[0][i] * P0[0][j]
        for p in range(1, n):
            s = s + P0[p][i] * P0[p][j]
        return s

    (w0, w1, w2), V = _eigh3_s(cov_entry(0, 0), cov_entry(0, 1),
                               cov_entry(0, 2), cov_entry(1, 1),
                               cov_entry(1, 2), cov_entry(2, 2))
    scale = [torch.sqrt(torch.clamp(wd, min=0.0) * inv_n)
             for wd in (w2, w1, w0)]
    cws = [c0] + [tuple(c0[i] + scale[k] * V[i][2 - k] for i in range(3))
                  for k in range(3)]

    # barycentric coordinates
    CC = [[cws[j + 1][i] - c0[i] + (1e-9 if i == j else 0.0)
           for j in range(3)] for i in range(3)]
    CCinv = _inv3_s(CC)
    alphas = []
    for p in range(n):
        a123 = tuple(_dot3_s(CCinv[i], P0[p]) for i in range(3))
        alphas.append((1.0 - a123[0] - a123[1] - a123[2],
                       a123[0], a123[1], a123[2]))

    # MtM (12x12) from its 4x4 structure blocks
    Sq = [[None] * 4 for _ in range(4)]
    Uq = [[None] * 4 for _ in range(4)]
    Vq = [[None] * 4 for _ in range(4)]
    Qq = [[None] * 4 for _ in range(4)]
    for i in range(4):
        for l in range(i, 4):
            s_ = u_ = v_ = q_ = None
            for p in range(n):
                ail = alphas[p][i] * alphas[p][l]
                su = uu[p] * ail
                sv = vv[p] * ail
                sq = uu[p] * uu[p] * ail + vv[p] * vv[p] * ail
                s_ = ail if s_ is None else s_ + ail
                u_ = su if u_ is None else u_ + su
                v_ = sv if v_ is None else v_ + sv
                q_ = sq if q_ is None else q_ + sq
            Sq[i][l] = Sq[l][i] = s_
            Uq[i][l] = Uq[l][i] = u_
            Vq[i][l] = Vq[l][i] = v_
            Qq[i][l] = Qq[l][i] = q_
    zero = torch.zeros_like(Sq[0][0])
    MtM = [[None] * 12 for _ in range(12)]
    for i in range(4):
        for l in range(4):
            MtM[3 * i + 0][3 * l + 0] = Sq[i][l]
            MtM[3 * i + 0][3 * l + 1] = zero
            MtM[3 * i + 0][3 * l + 2] = -Uq[i][l]
            MtM[3 * i + 1][3 * l + 0] = zero
            MtM[3 * i + 1][3 * l + 1] = Sq[i][l]
            MtM[3 * i + 1][3 * l + 2] = -Vq[i][l]
            MtM[3 * i + 2][3 * l + 0] = -Uq[i][l]
            MtM[3 * i + 2][3 * l + 1] = -Vq[i][l]
            MtM[3 * i + 2][3 * l + 2] = Qq[i][l]

    cols = _smallest_eigvecs_12_s(MtM)      # 4 smallest, ascending
    v4 = [[(cols[k][3 * cp + 0], cols[k][3 * cp + 1], cols[k][3 * cp + 2])
           for cp in range(4)] for k in range(4)]

    # L (6x10) and rho (6,)
    dv = [[tuple(v4[k][a][i] - v4[k][b][i] for i in range(3))
           for k in range(4)] for a, b in _CP_PAIRS]

    def dvdot(pair, i, j):
        return _dot3_s(dv[pair][i], dv[pair][j])

    Lmat = [[dvdot(p, 0, 0), 2 * dvdot(p, 0, 1), dvdot(p, 1, 1),
             2 * dvdot(p, 0, 2), 2 * dvdot(p, 1, 2), dvdot(p, 2, 2),
             2 * dvdot(p, 0, 3), 2 * dvdot(p, 1, 3), 2 * dvdot(p, 2, 3),
             dvdot(p, 3, 3)] for p in range(6)]
    rho = [sum((cws[a][i] - cws[b][i]) ** 2 for i in range(3))
           for a, b in _CP_PAIRS]

    # betas, three approximation cases
    def lsq_cols(idx):
        """Least squares of L[:, idx] x = rho via regularized normal
        equations."""
        k = len(idx)
        AtA = [[None] * k for _ in range(k)]
        for i in range(k):
            for j in range(i, k):
                s = Lmat[0][idx[i]] * Lmat[0][idx[j]]
                for p in range(1, 6):
                    s = s + Lmat[p][idx[i]] * Lmat[p][idx[j]]
                AtA[i][j] = AtA[j][i] = s
        tr = AtA[0][0]
        for i in range(1, k):
            tr = tr + AtA[i][i]
        reg = 1e-8 * (tr / k + 1.0)
        for i in range(k):
            AtA[i][i] = AtA[i][i] + reg
        rhs = []
        for i in range(k):
            s = Lmat[0][idx[i]] * rho[0]
            for p in range(1, 6):
                s = s + Lmat[p][idx[i]] * rho[p]
            rhs.append(s)
        return _chol_solve_s(_chol_s(AtA, k), rhs, k)

    x1 = lsq_cols([0, 1, 3, 6])
    b1_1 = torch.sqrt(x1[0].abs())
    s1 = torch.where(x1[0] < 0, -1.0, 1.0)
    den1 = torch.clamp(b1_1, min=1e-9)
    betas1 = (b1_1, s1 * x1[1] / den1, s1 * x1[2] / den1,
              s1 * x1[3] / den1)

    x2 = lsq_cols([0, 1, 2])
    b2_1 = torch.sqrt(x2[0].abs())
    b2_2 = torch.sqrt(x2[2].abs())
    b2_2 = torch.where(x2[1] < 0, -b2_2, b2_2)
    betas2 = (b2_1, b2_2, zero, zero)

    x3 = lsq_cols([0, 1, 2, 3, 4])
    b3_1 = torch.sqrt(x3[0].abs())
    b3_2 = torch.sqrt(x3[2].abs())
    b3_2 = torch.where(x3[1] < 0, -b3_2, b3_2)
    b3_3 = x3[3] / torch.clamp(b3_1, min=1e-9)
    betas3 = (b3_1, b3_2, b3_3, zero)

    # shared Gauss-Newton + Horn tail over a trailing (3,) case axis; the
    # case-free operands gain a unit axis to broadcast against it
    def u(x):
        return x[..., None]

    Lc = [[u(x) for x in row] for row in Lmat]
    rhoc = [u(x) for x in rho]
    b = [torch.stack([betas1[c], betas2[c], betas3[c]], dim=-1)
         for c in range(4)]
    for _ in range(5):
        b1, b2, b3, b4 = b
        mono = (b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3, b3 * b3,
                b1 * b4, b2 * b4, b3 * b4, b4 * b4)
        r = []
        for p in range(6):
            s = Lc[p][0] * mono[0]
            for c in range(1, 10):
                s = s + Lc[p][c] * mono[c]
            r.append(s - rhoc[p])
        J = [(2 * b1 * Lc[p][0] + b2 * Lc[p][1] + b3 * Lc[p][3]
              + b4 * Lc[p][6],
              b1 * Lc[p][1] + 2 * b2 * Lc[p][2] + b3 * Lc[p][4]
              + b4 * Lc[p][7],
              b1 * Lc[p][3] + b2 * Lc[p][4] + 2 * b3 * Lc[p][5]
              + b4 * Lc[p][8],
              b1 * Lc[p][6] + b2 * Lc[p][7] + b3 * Lc[p][8]
              + 2 * b4 * Lc[p][9]) for p in range(6)]
        AtA = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(i, 4):
                s = J[0][i] * J[0][j]
                for p in range(1, 6):
                    s = s + J[p][i] * J[p][j]
                AtA[i][j] = AtA[j][i] = s
        tr = AtA[0][0] + AtA[1][1] + AtA[2][2] + AtA[3][3]
        reg = 1e-8 * (tr / 4 + 1.0)
        for i in range(4):
            AtA[i][i] = AtA[i][i] + reg
        rhs = []
        for i in range(4):
            s = J[0][i] * r[0]
            for p in range(1, 6):
                s = s + J[p][i] * r[p]
            rhs.append(-s)
        db = _chol_solve_s(_chol_s(AtA, 4), rhs, 4)
        b = [b[i] + db[i] for i in range(4)]

    # camera-frame control points and points (case axis rides along)
    v4c = [[tuple(u(x) for x in v4[k][cp]) for cp in range(4)]
           for k in range(4)]
    alc = [tuple(u(x) for x in a) for a in alphas]
    ccs = [tuple(b[0] * v4c[0][cp][i] + b[1] * v4c[1][cp][i]
                 + b[2] * v4c[2][cp][i] + b[3] * v4c[3][cp][i]
                 for i in range(3)) for cp in range(4)]
    pcs = [tuple(alc[p][0] * ccs[0][i] + alc[p][1] * ccs[1][i]
                 + alc[p][2] * ccs[2][i] + alc[p][3] * ccs[3][i]
                 for i in range(3)) for p in range(n)]
    # depth sign fix (OpenCV: if pc z of first point negative, negate)
    sign = torch.where(pcs[0][2] < 0, -1.0, 1.0)
    pcs = [tuple(sign * pcs[p][i] for i in range(3)) for p in range(n)]

    P0c = [tuple(u(x) for x in P) for P in P0]
    c0c = tuple(u(x) for x in c0)
    R, t = _horn_core_s(P0c, c0c, pcs, n)

    # per-case mean squared reprojection error over the sample points
    err = None
    for p in range(n):
        o = (u(ox[p]), u(oy[p]), u(oz[p]))
        pcx = _dot3_s(R[0], o) + t[0]
        pcy = _dot3_s(R[1], o) + t[1]
        pcz = _dot3_s(R[2], o) + t[2]
        z = torch.where(pcz.abs() < 1e-9, 1e-9, pcz)
        du = pcx / z - u(uu[p])
        dvp = pcy / z - u(vv[p])
        e = du * du + dvp * dvp
        err = e if err is None else err + e
    err = err * inv_n

    # best of the 3 cases (first-min tie-break; non-finite errors lose)
    inf = float("inf")
    e0 = torch.where(torch.isfinite(err[..., 0]), err[..., 0], inf)
    e1 = torch.where(torch.isfinite(err[..., 1]), err[..., 1], inf)
    e2 = torch.where(torch.isfinite(err[..., 2]), err[..., 2], inf)
    pick0 = (e0 <= e1) & (e0 <= e2)
    pick1 = e1 <= e2

    def pick(q):
        return torch.where(pick0, q[..., 0],
                           torch.where(pick1, q[..., 1], q[..., 2]))

    Rb = torch.stack([torch.stack([pick(R[i][j]) for j in range(3)], -1)
                      for i in range(3)], -2)
    tb = torch.stack([pick(t[i]) for i in range(3)], -1)
    best_err = torch.where(pick0, e0, torch.where(pick1, e1, e2))
    ok = best_err < inf
    return Rb, tb, ok


# ---------------------------------------------------------------------------
# RANSAC driver
# ---------------------------------------------------------------------------

def ransac_epnp(obj: torch.Tensor, img: torch.Tensor, valid: torch.Tensor,
                K: torch.Tensor, draws: torch.Tensor, reproj_thr,
                n_hyp: int = 300, model_points: int = 6):
    """Batched RANSAC: n_hyp EPnP hypotheses at once.

    obj (N, 3), img (N, 2) pixels, valid (N,) bool (padded capacity),
    draws (n_hyp, model_points) uniforms in [0, 1).  Returns (rvec, tvec,
    inlier_mask (N,), n_inliers) of the best minimal-sample model (the
    reference's OpenCV-3 semantics), with the first maximum winning ties.
    No host synchronisation."""
    if draws.shape != (n_hyp, model_points):
        raise ValueError(f"draws {tuple(draws.shape)} != "
                         f"({n_hyp}, {model_points})")
    N = obj.shape[0]
    dev = obj.device
    K = K.float()
    fx, fy = K[0, 0], K[1, 1]
    img_n = normalize_points(img.float(), K)
    obj = obj.float()
    nv = valid.sum()

    # map uniform draws to valid indices
    ar = torch.arange(N, device=dev)
    order = torch.argsort(torch.where(valid, ar, N + ar))
    draw = torch.minimum((draws * torch.clamp(nv, min=1)).long(),
                         torch.clamp(nv - 1, min=0))
    sample_idx = order[draw]                            # (n_hyp, m)

    Rs, ts, oks = epnp_norm(obj[sample_idx], img_n[sample_idx])

    # reprojection errors of every hypothesis against every point
    err2 = pixel_err2(project_norm(obj, Rs, ts), img_n, fx, fy)
    inl = (err2 <= reproj_thr * reproj_thr) & valid[None, :]
    counts = torch.where(oks, inl.sum(dim=1), -1)
    best = _first_argmax(counts)
    return rodrigues_inv(Rs[best]), ts[best], inl[best], counts[best]


# ---------------------------------------------------------------------------
# LM refine (cv::solvePnP ITERATIVE with a guess): plain version of K6
# ---------------------------------------------------------------------------

BIG_ERR = 1e12      # reprojection error of an invalid row (pnp.py BIG)
LM_ITERS = 20


def _normal_eqs(obj, img_n, w, p):
    """Analytic H = J^T J, g = J^T r and cost of the weighted normalized
    reprojection residuals at p = (rvec, tvec); dR/drvec by forward-mode
    autodiff of `rodrigues` (tpuslam's jacfwd)."""
    rv, t = p[:3], p[3:]
    R = rodrigues(rv)
    pc = obj @ R.T + t
    z = torch.where(pc[:, 2].abs() < 1e-9, 1e-9, pc[:, 2])
    invz = 1.0 / z
    x_z = pc[:, 0] * invz
    y_z = pc[:, 1] * invz
    r2 = (torch.stack([x_z, y_z], dim=1) - img_n) * w[:, None]

    J_R = torch.func.jacfwd(rodrigues)(rv)             # (3, 3, 3)
    dPdr = torch.einsum("abc,nb->nac", J_R, obj)       # (N, 3, 3)
    Ju_r = (dPdr[:, 0] - x_z[:, None] * dPdr[:, 2]) * invz[:, None]
    Jv_r = (dPdr[:, 1] - y_z[:, None] * dPdr[:, 2]) * invz[:, None]
    zero = torch.zeros_like(invz)
    Ju_t = torch.stack([invz, zero, -x_z * invz], dim=1)
    Jv_t = torch.stack([zero, invz, -y_z * invz], dim=1)
    Ju = torch.cat([Ju_r, Ju_t], dim=1) * w[:, None]    # (N, 6)
    Jv = torch.cat([Jv_r, Jv_t], dim=1) * w[:, None]
    H = Ju.T @ Ju + Jv.T @ Jv
    g = Ju.T @ r2[:, 0] + Jv.T @ r2[:, 1]
    return H, g, torch.sum(r2 * r2)


def refine_lm(obj, img, weight, K, rvec0, tvec0, iters: int = LM_ITERS):
    """Weighted LM minimizing sum w_i ||proj(X_i) - x_i||^2 over (rvec, t),
    residuals in normalized coordinates (tpuslam refine_lm, step for
    step): lambda 1e-3, x0.5 on an accepted step and x10 on a rejected
    one, (H, g, cost) of the accepted iterate carried, the damped 6x6
    solved by the unrolled scalar Cholesky.  No host synchronisation."""
    K = K.float()
    obj = obj.float()
    img_n = normalize_points(img.float(), K)
    w = weight.float()
    p = torch.cat([rvec0.float(), tvec0.float()])
    H, g, c = _normal_eqs(obj, img_n, w, p)
    lam = torch.tensor(1e-3, dtype=torch.float32, device=obj.device)
    for _ in range(iters):
        Hd = [[H[i, j] + (lam * (H[i, i] + 1e-12) if i == j else 0.0)
               for j in range(6)] for i in range(6)]
        step = _chol_solve_s(_chol_s(Hd, 6), [-g[i] for i in range(6)], 6)
        new_p = p + torch.stack(step)
        Hn, gn, c_new = _normal_eqs(obj, img_n, w, new_p)
        better = c_new < c
        p = torch.where(better, new_p, p)
        H = torch.where(better, Hn, H)
        g = torch.where(better, gn, g)
        lam = torch.where(better, lam * 0.5, lam * 10.0)
        c = torch.where(better, c_new, c)
    return p[:3], p[3:]


def reproj_errors(obj, img, valid, K, rvec, tvec):
    """Per-point reprojection L2 pixel errors, BIG_ERR where invalid."""
    K = K.float()
    p = project_norm(obj.float(), rodrigues(rvec), tvec.float())
    img_n = normalize_points(img.float(), K)
    e = torch.sqrt(pixel_err2(p, img_n, K[0, 0], K[1, 1]))
    return torch.where(valid, e, BIG_ERR)


def refine_lm_with_errors(obj, img, weight, valid, K, rvec, tvec):
    """Plain version of kernel K6: refine_lm + reproj_errors at the
    refined pose -> (rvec (3,), tvec (3,), err (N,))."""
    _cuda.PLAIN_CALLS["lm_refine"] += 1
    rvec2, tvec2 = refine_lm(obj, img, weight, K, rvec, tvec)
    return rvec2, tvec2, reproj_errors(obj, img, valid, K, rvec2, tvec2)


def refine_lm_errors_cuda(obj, img, weight, valid, K, rvec, tvec,
                          iters: int = LM_ITERS):
    """Kernel K6 (csrc/lm_refine.cu): same contract as
    refine_lm_with_errors, one block running the whole loop.  rvec, tvec
    and K are read from device memory and the result stays there: no host
    synchronisation."""
    _cuda.expect(obj, "obj", torch.float32, 2)
    _cuda.expect(img, "img", torch.float32, 2)
    _cuda.expect(weight, "weight", torch.float32, 1)
    _cuda.expect(valid, "valid", torch.bool, 1)
    _cuda.expect(K, "K", torch.float32, 2)
    _cuda.expect(rvec, "rvec", torch.float32, 1)
    _cuda.expect(tvec, "tvec", torch.float32, 1)
    N = obj.shape[0]
    if obj.shape != (N, 3) or img.shape != (N, 2) or \
            weight.shape != (N,) or valid.shape != (N,) or \
            K.shape != (3, 3) or rvec.shape != (3,) or tvec.shape != (3,):
        raise ValueError("expected obj (N,3), img (N,2), weight and valid "
                         "(N,), K (3,3), rvec and tvec (3,)")
    if N < 1:
        raise ValueError("no correspondences")
    p = torch.empty((6,), dtype=torch.float32, device=obj.device)
    err = torch.empty((N,), dtype=torch.float32, device=obj.device)
    with torch.cuda.device(obj.device):
        _cuda.launch("lm_refine", obj, img, weight, valid, K, rvec, tvec, p,
                     err, N, iters)
    return p[:3], p[3:], err


def refine_lm_with_errors_auto(obj, img, weight, valid, K, rvec, tvec):
    """A CUDA tensor goes to kernel K6, a CPU tensor to the plain
    version."""
    if obj.is_cuda:
        return refine_lm_errors_cuda(
            *(t.float().contiguous() for t in (obj, img, weight)),
            valid.contiguous(), K.float().contiguous(),
            rvec.float().contiguous(), tvec.float().contiguous())
    return refine_lm_with_errors(obj, img, weight, valid, K, rvec, tvec)


def solve_pnp_ransac(obj: np.ndarray, img: np.ndarray, K: np.ndarray,
                     rvec0: np.ndarray, tvec0: np.ndarray,
                     min_inliers: int = 20, refine_iterations: int = 1,
                     reprojection_error: float = 2.0,
                     refine_sigma: float = 3.0,
                     iterations_count: int = 300,
                     seed: int = 0,
                     capacity: int = 1536,
                     device="cuda", draws=None):
    """Host driver: the reference's solvePnPRansac + refinement loop
    (MotionEstimation.cpp:279-374), tpuslam's solve_pnp_ransac.

    The RANSAC uniforms come from a torch.Generator on `device` seeded
    with `seed`, or from `draws` ((iterations_count, 6), as tests inject
    tpuslam's).  Returns (rvec, tvec, inlier_indices ndarray); on failure
    the guess is passed back with empty inliers.  Inputs are unpadded
    (N, 3) / (N, 2) float arrays."""
    n = len(obj)
    if n < 6:
        return np.asarray(rvec0), np.asarray(tvec0), np.zeros(0, np.int64)

    cap = capacity
    obj_p = np.zeros((cap, 3), np.float32)
    img_p = np.zeros((cap, 2), np.float32)
    val_p = np.zeros((cap,), bool)
    obj_p[:n] = obj
    img_p[:n] = img
    val_p[:n] = True

    dev = torch.device(device)
    obj_d = torch.as_tensor(obj_p, device=dev)
    img_d = torch.as_tensor(img_p, device=dev)
    val_d = torch.as_tensor(val_p, device=dev)
    K_d = torch.as_tensor(np.asarray(K, np.float32), device=dev)
    if draws is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        u = torch.rand((iterations_count, 6), generator=gen, device=dev)
    else:
        u = torch.as_tensor(np.asarray(draws, np.float32), device=dev)

    rvec, tvec, inl_mask, n_inl = ransac_epnp(
        obj_d, img_d, val_d, K_d, u, reprojection_error,
        n_hyp=iterations_count)
    inl_mask = inl_mask.cpu().numpy()
    n_inl = int(n_inl)
    if n_inl <= 0:
        return np.asarray(rvec0), np.asarray(tvec0), np.zeros(0, np.int64)

    inliers = np.nonzero(inl_mask)[0]

    # ---- refinement loop (MotionEstimation.cpp:310-374) ---------------
    if n_inl >= min_inliers and refine_iterations > 0:
        thr = reprojection_error
        prev = inliers
        new_inliers = inliers
        new_rvec, new_tvec = rvec, tvec
        refine_count = 0
        while refine_count < refine_iterations:
            w = np.zeros((cap,), np.float32)
            w[prev] = 1.0
            new_rvec, new_tvec, err_d = refine_lm_with_errors_auto(
                obj_d, img_d, torch.as_tensor(w, device=dev), val_d, K_d,
                new_rvec, new_tvec)
            err = err_d.cpu().numpy()
            new_inliers = np.nonzero(err[:n] <= thr)[0]
            kept = err[new_inliers]
            # reference calcVariance over the kept errors
            var = float(np.var(kept, ddof=1)) if len(kept) > 1 else 0.0
            thr = min(reprojection_error,
                      refine_sigma * float(np.sqrt(var)))
            if (len(new_inliers) < min_inliers or
                    np.array_equal(new_inliers, prev)):
                break
            # the reference's std::swap: prev takes the new set,
            # new_inliers the old one (matters for the post-loop swap)
            new_inliers, prev = prev, new_inliers
            refine_count += 1
        # post-loop swap(new_inliers, inliers) (MotionEstimation.cpp:370):
        # break -> last computed set; budget exhaustion -> the previous set
        inliers = new_inliers
        rvec, tvec = new_rvec, new_tvec

    return rvec.cpu().numpy(), tvec.cpu().numpy(), inliers
