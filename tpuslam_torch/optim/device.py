"""The pose graph's device back end: batched SE3 pose-graph LM in PyTorch
(f32), counterpart of tpuslam/optim/device.py with the same function
names.

The host optimizer (optim/pose_graph.py) reproduces the reference's exact
LM semantics in f64.  This module is the same per-edge maths on tensors,
on the device they lie on (the card, or the CPU where the caller asks for
it):

  * per edge: errors, the g2o Jacobians, the oplus update;
  * linearisations: gn_normal_equations (the full symmetric H), lm_system
    (the reference's transposed, one-off-diagonal-block layout that its
    lower-triangle LDLT then reads) and sparse_system (the same system as
    diagonal, sub-diagonal and extra blocks);
  * solvers: lm_solve (dense (6V)^2 solve), lm_solve_sparse (block-Thomas
    over the block-tridiagonal part plus a push-through Woodbury
    correction for the extra blocks, O(V) memory) and gn_solve (damped
    Cholesky).

Every loop over iterations is a Python loop (tpuslam's lax.scan), with the
lambda seeded as tau * max_diag on iteration 0; each solver returns the
per-iteration chi2.  The block-Thomas recursion is serial in the vertex
index: `thomas_solve` sends a CUDA tensor to kernel K7
(csrc/thomas.cu) and a CPU tensor to the plain `_thomas_solve`, whose
element ops cost ~325 launches per vertex on the card.  Every sum of
the assembly goes through `segment.segment_sum`, which adds each
destination's terms in edge order on both devices, so a run on the card
repeats bit for bit.

graph_to_arrays and classify_extra_edges are numpy-only, copied from
tpuslam (tests/test_torch_config.py keeps them equal).
"""

from __future__ import annotations

import torch

from ..kernels import _cuda
from .segment import segment_sum


def _quat_xyz(R):
    """(E,3,3) -> (E,3) quaternion xyz, w>=0 (branchless Shepperd)."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    t = m00 + m11 + m22

    s0 = torch.sqrt(torch.clamp(t + 1.0, min=1e-12)) * 2
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], dim=-1)
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], dim=-1)
    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-12)) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], dim=-1)
    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-12)) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3], dim=-1)

    diag = torch.stack([m00, m11, m22], dim=-1)
    arg = torch.argmax(diag, dim=-1)
    q = torch.where((t > 0)[:, None], q0,
                    torch.where((arg == 0)[:, None], q1,
                                torch.where((arg == 1)[:, None], q2, q3)))
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[:, 0:1] < 0, -1.0, 1.0)
    return q[:, 1:] * sign


def edge_errors(Z_inv, Xi, Xj):
    """(E,6) error = [t; q.xyz] of Z^-1 Xi^-1 Xj (f32)."""
    delta = Z_inv @ _se3_inv(Xi) @ Xj
    return torch.cat([delta[:, :3, 3], _quat_xyz(delta[:, :3, :3])], dim=1)


def _se3_inv(X):
    """(E,4,4) rigid inverse (no general 4x4 inverse needed)."""
    R = X[:, :3, :3]
    t = X[:, :3, 3]
    Rt = R.transpose(1, 2)
    top = torch.cat([Rt, -(Rt @ t[..., None])], dim=2)
    bot = torch.tensor([[[0., 0., 0., 1.]]], dtype=X.dtype,
                       device=X.device).expand(X.shape[0], 1, 4)
    return torch.cat([top, bot], dim=1)


def edge_jacobians(Z, Xi, Xj):
    """(E,6,6) Ji, Jj: the g2o dq_dR chain rule (SE3Gradient.cpp:39-105),
    as optim.pose_graph.compute_jacobians in f32."""
    E = Z.shape[0]
    A = _se3_inv(Z)
    B = _se3_inv(Xi) @ Xj
    Emat = A @ B
    Re = Emat[:, :3, :3]
    Ra = A[:, :3, :3]
    Rb = B[:, :3, :3]
    tb = B[:, :3, 3]

    # dq_dR (E,3,9), columns in column-major R order
    tr = Re.diagonal(dim1=1, dim2=2).sum(-1)
    qw = 0.25 * (torch.sqrt(torch.clamp(tr + 1.0, min=1e-12)) * 2.0)
    a1 = 1.0 / qw ** 3
    a4 = 0.25 / qw
    a2 = -0.03125 * (Re[:, 2, 1] - Re[:, 1, 2]) * a1
    a6 = 0.03125 * (Re[:, 2, 0] - Re[:, 0, 2]) * a1
    a7 = -0.03125 * (Re[:, 1, 0] - Re[:, 0, 1]) * a1
    z = torch.zeros_like(a2)
    dq_dR = torch.stack([
        torch.stack([a2, z, z, z, a2, a4, z, -a4, a2], dim=-1),
        torch.stack([a6, z, -a4, z, a6, z, a4, z, a6], dim=-1),
        torch.stack([a7, a4, z, -a4, a7, z, z, z, a7], dim=-1),
    ], dim=1)

    def vec_cm(M):
        return M.transpose(1, 2).reshape(E, 9)

    # skew1(tb, transposed) with doubled values
    x, y, zz = 2 * tb[:, 0], 2 * tb[:, 1], 2 * tb[:, 2]
    zer = torch.zeros_like(x)
    S1 = torch.stack([
        torch.stack([zer, -zz, y], dim=-1),
        torch.stack([zz, zer, -x], dim=-1),
        torch.stack([-y, x, zer], dim=-1),
    ], dim=1)

    def skew2(R, transposed):
        r = 2.0 * R
        zr = torch.zeros_like(r[:, 0, :])
        if transposed:
            Sx = torch.stack([zr, r[:, 2, :], -r[:, 1, :]], dim=1)
            Sy = torch.stack([-r[:, 2, :], zr, r[:, 0, :]], dim=1)
            Sz = torch.stack([r[:, 1, :], -r[:, 0, :], zr], dim=1)
        else:
            Sx = torch.stack([zr, -r[:, 2, :], r[:, 1, :]], dim=1)
            Sy = torch.stack([r[:, 2, :], zr, -r[:, 0, :]], dim=1)
            Sz = torch.stack([-r[:, 1, :], r[:, 0, :], zr], dim=1)
        return Sx, Sy, Sz

    zeros33 = torch.zeros((E, 3, 3), dtype=Z.dtype, device=Z.device)

    Sxt, Syt, Szt = skew2(Rb, True)
    M = torch.stack([vec_cm(Ra @ Sxt), vec_cm(Ra @ Syt),
                     vec_cm(Ra @ Szt)], dim=2)
    Ji_rr = dq_dR @ M

    I3 = torch.eye(3, dtype=Z.dtype, device=Z.device).expand(E, 3, 3)
    Sx, Sy, Sz = skew2(I3, False)
    M = torch.stack([vec_cm(Re @ Sx), vec_cm(Re @ Sy),
                     vec_cm(Re @ Sz)], dim=2)
    Jj_rr = dq_dR @ M

    Ji = torch.cat([
        torch.cat([-Ra, Ra @ S1], dim=2),
        torch.cat([zeros33, Ji_rr], dim=2),
    ], dim=1)
    Jj = torch.cat([
        torch.cat([Re, zeros33], dim=2),
        torch.cat([zeros33, Jj_rr], dim=2),
    ], dim=1)
    return Ji, Jj


def _oplus_batch(est, upd):
    """(N,4,4) estimates x (N,6) updates -> (N,4,4)."""
    v = upd[:, 3:]
    w2 = 1.0 - torch.sum(v * v, dim=1)
    ok = w2 >= 0
    w = torch.sqrt(torch.clamp(w2, min=0.0))
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    R = torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=1)
    I3 = torch.eye(3, dtype=est.dtype, device=est.device).expand(R.shape)
    R = torch.where(ok[:, None, None], R, I3)
    inc = torch.zeros_like(est)
    inc[:, :3, :3] = R
    inc[:, :3, 3] = upd[:, :3]
    inc[:, 3, 3] = 1.0
    return est @ inc


# ---------------------------------------------------------------------------
# linearisations
# ---------------------------------------------------------------------------

def _edge_terms(poses, e_from, e_to, Z_inv, Z, Omega):
    """Per-edge error, gradient halves bi, bj and the blocks Ji^T O Ji,
    Jj^T O Jj, Ji^T O Jj, shared by the three linearisations."""
    Xi = poses[e_from]
    Xj = poses[e_to]
    err = edge_errors(Z_inv, Xi, Xj)
    Ji, Jj = edge_jacobians(Z, Xi, Xj)

    w_err = -torch.einsum("eij,ej->ei", Omega, err)
    bi = torch.einsum("eji,ej->ei", Ji, w_err)
    bj = torch.einsum("eji,ej->ei", Jj, w_err)

    JtO_i = torch.einsum("eji,ejk->eik", Ji, Omega)
    JtO_j = torch.einsum("eji,ejk->eik", Jj, Omega)
    chi2 = torch.einsum("ei,eij,ej->", err, Omega, err)
    return err, bi, bj, JtO_i @ Ji, JtO_j @ Jj, JtO_i @ Jj, chi2


def _gradient(fi, fj, mi, mj, bi, bj, n_free):
    """b (6n,): bi at the from vertices, then bj at the to vertices;
    masked edges land on a dump block sliced off."""
    dest = torch.cat([torch.where(mi, fi, n_free),
                      torch.where(mj, fj, n_free)])
    return segment_sum(torch.cat([bi, bj]), dest,
                       n_free + 1)[:n_free].reshape(-1)


def _block_matrix(parts, n_free):
    """The (6n, 6n) sum of the (E,6,6) blocks of each part (fi, fj,
    blocks, mask) at block positions (fi, fj), the parts' blocks added in
    order; masked edges land on a dump block sliced off (tpuslam builds a
    padded copy per call)."""
    w = n_free + 1
    dest = torch.cat([torch.where(mask, fi, n_free) * w +
                      torch.where(mask, fj, n_free)
                      for fi, fj, _, mask in parts])
    A = segment_sum(torch.cat([blocks for _, _, blocks, _ in parts]),
                    dest, w * w)
    A = A.reshape(w, w, 6, 6).permute(0, 2, 1, 3).reshape(6 * w, 6 * w)
    return A[:6 * n_free, :6 * n_free]


def _max_diag(m_ii, m_jj, mi, mj):
    diag_i = torch.abs(torch.diagonal(m_ii, dim1=1, dim2=2))
    diag_j = torch.abs(torch.diagonal(m_jj, dim1=1, dim2=2))
    return torch.maximum(
        torch.max(torch.where(mi[:, None], diag_i, 0.0)),
        torch.max(torch.where(mj[:, None], diag_j, 0.0)))


def gn_normal_equations(poses, e_from, e_to, Z_inv, Z, Omega, n_free,
                        free_idx):
    """One Gauss-Newton linearization: dense symmetric (6n,6n) H and (6n,)
    b.  `free_idx` maps vertex index -> solve index (-1 == fixed)."""
    _, bi, bj, H_ii, H_jj, H_ij, chi2 = _edge_terms(
        poses, e_from, e_to, Z_inv, Z, Omega)
    fi = free_idx[e_from]
    fj = free_idx[e_to]
    mi = fi >= 0
    mj = fj >= 0
    b = _gradient(fi, fj, mi, mj, bi, bj, n_free)

    # symmetric full H (the device path solves the true normal equations;
    # the host path reproduces the reference's lower-triangle quirk)
    H = _block_matrix([(fi, fi, H_ii, mi), (fj, fj, H_jj, mj),
                       (fi, fj, H_ij, mi & mj),
                       (fj, fi, H_ij.transpose(1, 2), mi & mj)], n_free)
    return H, b, chi2


def lm_system(poses, e_from, e_to, Z_inv, Z, Omega, n_free, free_idx):
    """One LM linearization with the REFERENCE's exact assembly quirks
    (HyperGraph::buildSystem + GraphEdge::constructQuadraticForm):

      * every block inserted TRANSPOSED (GraphEdge.cpp:70-118),
      * only ONE off-diagonal block per edge, at (to, from), so a loop
        closure (from=new, to=old) lands in the upper triangle that
        SimplicialLDLT's lower-triangle view ignores (HyperGraph.cpp:
        197-204); callers tril-symmetrize: A_eff = tril(A) + tril(A)^T -
        diag(A).

    Returns (A (6n,6n) raw quirk layout, b (6n,), chi2, max_diag of the
    diagonal blocks, the lambda_0 seed)."""
    _, bi, bj, m_ii, m_jj, m_ij, chi2 = _edge_terms(
        poses, e_from, e_to, Z_inv, Z, Omega)
    fi = free_idx[e_from]
    fj = free_idx[e_to]
    mi = fi >= 0
    mj = fj >= 0
    b = _gradient(fi, fj, mi, mj, bi, bj, n_free)
    A = _block_matrix([(fi, fi, m_ii.transpose(1, 2), mi),
                       (fj, fj, m_jj.transpose(1, 2), mj),
                       (fj, fi, m_ij.transpose(1, 2), mi & mj)], n_free)
    return A, b, chi2, _max_diag(m_ii, m_jj, mi, mj)


def _apply_step(poses, x, free_idx, n_free):
    """The (6n,) step x applied to the free vertices (fixed ones keep
    their pose)."""
    upd = x.reshape(n_free, 6)
    full_upd = torch.where((free_idx >= 0)[:, None],
                           upd[torch.clamp(free_idx, min=0)], 0.0)
    return _oplus_batch(poses, full_upd)


def _scale_lambda(x, b, lam, chi2_before, chi2_after, lower_step,
                  upper_step):
    """The gain-ratio lambda rescale (scaleLambda, HyperGraph.cpp:118-135)."""
    scale = x @ (lam * x + b) + 1e-3
    rho = (chi2_before - chi2_after) / scale
    alpha = 1.0 - (2.0 * rho - 1.0) ** 3
    alpha = torch.clamp(alpha, max=upper_step)
    return lam * torch.clamp(alpha, min=lower_step)


def _lm_update(poses, x, b, chi2_before, lam, e_from, e_to, Z_inv, Omega,
               n_free, free_idx, lower_step, upper_step):
    """Apply the step x, then the gain-ratio lambda rescale
    -> (poses, lambda, chi2 after)."""
    new_poses = _apply_step(poses, x, free_idx, n_free)
    err_after = edge_errors(Z_inv, new_poses[e_from], new_poses[e_to])
    chi2_after = torch.einsum("ei,eij,ej->", err_after, Omega, err_after)
    return new_poses, _scale_lambda(x, b, lam, chi2_before, chi2_after,
                                    lower_step, upper_step), chi2_after


def _dense_solve(A, b, lam):
    """x = (tril(A) + tril(A)^T - diag(A) + lam I)^-1 b: SimplicialLDLT
    reads the lower triangle of the raw quirk layout only."""
    L = torch.tril(A)
    A_eff = L + L.T - torch.diag(torch.diag(A)) + \
        lam * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.solve(A_eff, b)


def _lm_iteration(poses, A, b, chi2_before, lam, e_from, e_to, Z_inv,
                  Omega, n_free, free_idx, lower_step, upper_step):
    """Shared LM update + gain-ratio lambda rescale (HyperGraph.cpp:57-97).
    `A` is the raw quirk layout from lm_system; lam must already be seeded
    (tau * max_diag on the first iteration)."""
    return _lm_update(poses, _dense_solve(A, b, lam), b, chi2_before, lam,
                      e_from, e_to, Z_inv, Omega, n_free, free_idx,
                      lower_step, upper_step)


def _stack(chis, like):
    return torch.stack(chis) if chis else like.new_zeros((0,))


def lm_solve(poses, e_from, e_to, Z, Omega, free_idx, n_free,
             iterations=10, tau=1e-5, lower_step=1.0 / 3.0,
             upper_step=2.0 / 3.0):
    """Device LM twin of the host PoseGraphOptimizer.optimize
    (HyperGraph.cpp:57-97): same transposed/lower-triangle assembly,
    lambda_0 = tau * max|blockdiag|, gain-ratio lambda schedule with the
    [1/3, 2/3] clamp, dense (6n)^2 solve.  f32 where the host is f64.
    Returns (poses, chi2 after each iteration)."""
    Z_inv = _se3_inv(Z)
    lam = poses.new_zeros(())
    chis = []
    for it in range(iterations):
        A, b, chi2, max_diag = lm_system(poses, e_from, e_to, Z_inv, Z,
                                         Omega, n_free, free_idx)
        if it == 0:
            lam = tau * max_diag
        poses, lam, chi2_after = _lm_iteration(
            poses, A, b, chi2, lam, e_from, e_to, Z_inv, Omega, n_free,
            free_idx, lower_step, upper_step)
        chis.append(chi2_after)
    return poses, _stack(chis, poses)


def graph_to_arrays(poses: dict, links, fixed_id: int = 1):
    """Pose dict + link MultiMap -> device arrays.

    Returns (ids, pose_arr (N,4,4) f32, e_from, e_to (E,) i32 vertex
    indices, Z (E,4,4), Omega (E,6,6), free_idx (N,) i32 with -1 for the
    fixed vertex).  Vertex `fixed_id` is gauge-fixed like the host driver
    (Optimizer.cpp:36-38)."""
    import numpy as np
    ids = sorted(poses)
    vidx = {vid: i for i, vid in enumerate(ids)}
    pose_arr = np.stack([np.asarray(poses[v], np.float32) for v in ids])
    ef, et, Zs, Os = [], [], [], []
    for _, link in links.items():
        if link.from_id in vidx and link.to_id in vidx:
            ef.append(vidx[link.from_id])
            et.append(vidx[link.to_id])
            Zs.append(np.asarray(link.transform, np.float32))
            Os.append(np.asarray(link.info, np.float32))
    e_from = np.asarray(ef, np.int32)
    e_to = np.asarray(et, np.int32)
    Z = (np.stack(Zs) if Zs
         else np.zeros((0, 4, 4), np.float32))
    Omega = (np.stack(Os) if Os
             else np.zeros((0, 6, 6), np.float32))
    free_idx = np.full(len(ids), -1, np.int32)
    k = 0
    for i, vid in enumerate(ids):
        if vid != fixed_id:
            free_idx[i] = k
            k += 1
    return ids, pose_arr, e_from, e_to, Z, Omega, free_idx


# ---------------------------------------------------------------------------
# structure-aware solve: block-tridiagonal + low-rank correction
# ---------------------------------------------------------------------------
#
# The quirk-faithful system is almost block-tridiagonal by construction:
# an edge contributes off-diagonal structure only when
# free_idx[to] > free_idx[from].  Odometry links (from=i, to=i+1) land on
# the first sub-diagonal; loop closures (from=new, to=old) land in the
# ignored upper triangle (their diagonal contributions remain).  This
# path assembles only
#   D  (V, 6, 6)    diagonal blocks
#   S  (V-1, 6, 6)  first sub-diagonal blocks (A[k+1, k])
#   X  (R, 6, 6)    the rare kept blocks with to - from >= 2, at block
#                   coordinates (xp, xq), xp > xq
# and solves by block-Thomas factorization of the tridiagonal part with a
# push-through Woodbury correction for the R extra blocks:
#   A = T + P M P',  A^-1 r = T^-1 r - G (I + M P'G)^-1 M P' T^-1 r,
#   G = T^-1 P.


def sparse_system(poses, e_from, e_to, Z_inv, Z, Omega, n_free, free_idx,
                  xsel, xp, xq, n_sub):
    """lm_system in sparse block form.  `xsel` (E,) maps each edge to its
    slot in the extras array (-1: not an extra), `xp`/`xq` (R,) the
    extras' block coordinates, `n_sub` = n_free - 1.

    Returns (D (n_free,6,6), S (n_sub,6,6), X (R,6,6), b (6n,), chi2,
    max_diag).  Block contents are the dense path's post-tril-
    symmetrization values (transposed-insert quirk included)."""
    _, bi, bj, m_ii, m_jj, m_ij, chi2 = _edge_terms(
        poses, e_from, e_to, Z_inv, Z, Omega)
    fi = free_idx[e_from]
    fj = free_idx[e_to]
    mi = fi >= 0
    mj = fj >= 0
    dt, dev = poses.dtype, poses.device

    # diagonal blocks: the quirk layout inserts m^T; the dense path then
    # tril-symmetrizes the whole matrix, which on a diagonal block is
    # tril(B) + tril(B)^T - diag(B) elementwise
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def tril_sym(B):
        L = torch.tril(B)
        return L + L.transpose(-1, -2) - B * eye6

    D = segment_sum(torch.cat([tril_sym(m_ii.transpose(1, 2)),
                               tril_sym(m_jj.transpose(1, 2))]),
                    torch.cat([torch.where(mi, fi, n_free),
                               torch.where(mj, fj, n_free)]), n_free + 1)

    # off-diagonal: ONE block per edge at (fj, fi), value m_ij^T, kept
    # iff fj > fi (lower triangle); fj == fi + 1 -> sub-diagonal slot
    B_e = m_ij.transpose(1, 2)
    keep = mi & mj & (fj > fi)
    sub = keep & (fj == fi + 1)
    S = segment_sum(B_e, torch.where(sub, fi, n_sub), n_sub + 1)

    R = xp.shape[0]
    is_x = keep & (xsel >= 0)
    X = segment_sum(B_e, torch.where(is_x, xsel, R), R + 1)

    b = _gradient(fi, fj, mi, mj, bi, bj, n_free)
    return (D[:n_free], S[:n_sub], X[:R], b, chi2,
            _max_diag(m_ii, m_jj, mi, mj))


def _chol6(A):
    """Unrolled 6x6 Cholesky on a (..., 6, 6) tensor -> lower L, in
    tpuslam's scalar-component order (K7 repeats it)."""
    comps = [[A[..., i, j] for j in range(6)] for i in range(6)]
    L = [[None] * 6 for _ in range(6)]
    for j in range(6):
        d = comps[j][j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        d = torch.sqrt(torch.clamp(d, min=1e-30))
        L[j][j] = d
        inv = 1.0 / d
        for i in range(j + 1, 6):
            s = comps[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    rows = [torch.stack([L[i][j] if j <= i else torch.zeros_like(L[i][i])
                         for j in range(6)], dim=-1) for i in range(6)]
    return torch.stack(rows, dim=-2)


def _chol6_solve(L, B):
    """Solve (L L^T) X = B for (..., 6, m) B given lower L (..., 6, 6),
    unrolled forward/back substitution."""
    y = [None] * 6
    for i in range(6):
        s = B[..., i, :]
        for k in range(i):
            s = s - L[..., i, k, None] * y[k]
        y[i] = s / L[..., i, i, None]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - L[..., k, i, None] * x[k]
        x[i] = s / L[..., i, i, None]
    return torch.stack(x, dim=-2)


# ---------------------------------------------------------------------------
# block-Thomas solve: plain version and kernel K7 (csrc/thomas.cu)
# ---------------------------------------------------------------------------

def _thomas_solve(D, S, B, lam):
    """Plain version of kernel K7: solve (T + lam I) X = B for symmetric
    block-tridiagonal T with diagonal blocks D (n,6,6) and sub-diagonal
    blocks S (n-1,6,6) at A[k+1, k]; B is (n, 6, m).  Block-Thomas with
    the unrolled 6x6 Cholesky (tpuslam's two lax.scans as Python loops)."""
    _cuda.PLAIN_CALLS["thomas"] += 1
    n = D.shape[0]
    Dl = D + lam * torch.eye(6, dtype=D.dtype, device=D.device)
    Ls, gs = [_chol6(Dl[0])], [B[0]]
    for k in range(1, n):
        Sk = S[k - 1]                           # A[k, k-1]
        W = _chol6_solve(Ls[-1], Sk.T)          # C_{k-1}^-1 Sk^T
        z = _chol6_solve(Ls[-1], gs[-1])        # C_{k-1}^-1 g_{k-1}
        gs.append(B[k] - _mm6(Sk, z))
        Ls.append(_chol6(Dl[k] - _mm6(Sk, W)))
    x = [None] * n
    x[n - 1] = _chol6_solve(Ls[n - 1], gs[n - 1])
    for k in range(n - 2, -1, -1):
        x[k] = _chol6_solve(Ls[k], gs[k] - _mm6(S[k].T, x[k + 1]))
    return torch.stack(x)


def _mm6(A, B):
    """A (6,6) @ B (6,m) as six products summed from the first, each op
    rounded on its own: the order of K7's sums (a matrix product on the
    card takes them in another order, with fused multiply-adds)."""
    acc = A[:, 0, None] * B[0]
    for r in range(1, 6):
        acc = acc + A[:, r, None] * B[r]
    return acc


# columns of B that one thread block of K7 takes, each block with its own
# factor chain: csrc/thomas.cu's MAX_COLS
K7_MAX_COLS = 448


def thomas_solve_cuda(D, S, B, lam):
    """Kernel K7: _thomas_solve in one launch (csrc/thomas.cu): a thread
    block per K7_MAX_COLS columns of B, in which one warp runs the factor
    chain and the columns, a lane each, follow it a few vertices behind,
    forward and back; lam is a 0-d f32 tensor on the card."""
    _cuda.expect(D, "D", torch.float32, 3)
    _cuda.expect(S, "S", torch.float32, 3)
    _cuda.expect(B, "B", torch.float32, 3)
    _cuda.expect(lam, "lam", torch.float32, 0)
    n = D.shape[0]
    if n < 1 or D.shape[1:] != (6, 6) or S.shape != (n - 1, 6, 6) or \
            B.shape[:2] != (n, 6) or B.shape[2] < 1:
        raise ValueError(f"thomas: D {tuple(D.shape)}, S {tuple(S.shape)}, "
                         f"B {tuple(B.shape)} are not (n,6,6), (n-1,6,6), "
                         f"(n,6,m)")
    chains = -(-B.shape[2] // K7_MAX_COLS)      # one per thread block
    L = torch.empty((chains, n, 48), dtype=torch.float32, device=D.device)
    G = torch.empty_like(B)                   # the forward pass's g_k
    X = torch.empty_like(B)
    with torch.cuda.device(D.device):
        _cuda.launch("thomas", D, S, B, lam, L, G, X, n, B.shape[2])
    return X


def thomas_solve(D, S, B, lam):
    """(T + lam I)^-1 B: kernel K7 for CUDA tensors, the plain version on
    the CPU; a failed build or launch on the card raises."""
    lam = torch.as_tensor(lam, dtype=D.dtype, device=D.device).reshape(())
    if _cuda.on_kernel(D, None):
        return thomas_solve_cuda(D.contiguous(), S.contiguous(),
                                 B.contiguous(), lam.contiguous())
    return _thomas_solve(D, S, B, lam)


def _sparse_solve(D, S, X, xp, xq, b, lam):
    """x = A_eff^-1 b where A_eff = tridiag(D + lam, S) plus, for each
    extra r: block X[r] at (xp[r], xq[r]) and X[r]^T at (xq[r], xp[r]).
    Push-through Woodbury over the block-Thomas solve."""
    n = D.shape[0]
    R = xp.shape[0]
    bb = b.reshape(n, 6, 1)
    if R == 0:
        return thomas_solve(D, S, bb, lam).reshape(-1)
    dt, dev = D.dtype, D.device
    eye6 = torch.eye(6, dtype=dt, device=dev)
    r_ = torch.arange(R, device=dev)
    # P columns: unit block-columns at rows xp (first R groups) and xq
    # (second R groups); M couples them with X / X^T
    P = torch.zeros((n, 6, 2 * R, 6), dtype=dt, device=dev)
    P[torch.cat([xp, xq]), :, torch.arange(2 * R, device=dev), :] = eye6
    P = P.reshape(n, 6, 12 * R)
    M = torch.zeros((2 * R, 6, 2 * R, 6), dtype=dt, device=dev)
    M[r_, :, R + r_, :] = X
    M[R + r_, :, r_, :] = X.transpose(1, 2)
    M = M.reshape(12 * R, 12 * R)

    sol = thomas_solve(D, S, torch.cat([bb, P], dim=-1), lam)
    t_b = sol[..., :1]                          # T^-1 b
    G = sol[..., 1:]                            # T^-1 P
    PtG = torch.einsum("nkr,nks->rs", P, G)     # P' T^-1 P
    Ptb = torch.einsum("nkr,nk->r", P, t_b[..., 0])
    cap = torch.eye(12 * R, dtype=dt, device=dev) + M @ PtG
    y = torch.linalg.solve(cap, M @ Ptb)
    x = t_b[..., 0] - torch.einsum("nkr,r->nk", G, y)
    return x.reshape(-1)


def classify_extra_edges(e_from, e_to, free_idx):
    """Host-side prep for sparse_system: slot index per edge for kept
    non-adjacent blocks, and their block coordinates.  Returns
    (xsel (E,) i32, xp (R,) i32, xq (R,) i32)."""
    import numpy as np
    e_from = np.asarray(e_from)
    e_to = np.asarray(e_to)
    free_idx = np.asarray(free_idx)
    fi = free_idx[e_from]
    fj = free_idx[e_to]
    keep = (fi >= 0) & (fj >= 0) & (fj > fi)
    extra = keep & (fj != fi + 1)
    xsel = np.full(len(e_from), -1, np.int32)
    idxs = np.nonzero(extra)[0]
    xsel[idxs] = np.arange(len(idxs), dtype=np.int32)
    return (xsel, fj[idxs].astype(np.int32), fi[idxs].astype(np.int32))


def lm_solve_sparse(poses, e_from, e_to, Z, Omega, free_idx, n_free,
                    xsel, xp, xq, iterations=10, tau=1e-5,
                    lower_step=1.0 / 3.0, upper_step=2.0 / 3.0):
    """lm_solve with the structure-aware solver: the same semantics (quirk
    assembly, lambda schedule), O(V) memory.  `xsel`/`xp`/`xq` from
    classify_extra_edges.  Returns (poses, chi2 after each iteration)."""
    Z_inv = _se3_inv(Z)
    n_sub = n_free - 1
    lam = poses.new_zeros(())
    chis = []
    for it in range(iterations):
        D, S, X, b, chi2, max_diag = sparse_system(
            poses, e_from, e_to, Z_inv, Z, Omega, n_free, free_idx,
            xsel, xp, xq, n_sub)
        if it == 0:
            lam = tau * max_diag
        x = _sparse_solve(D, S, X, xp, xq, b, lam)
        poses, lam, chi2_after = _lm_update(
            poses, x, b, chi2, lam, e_from, e_to, Z_inv, Omega, n_free,
            free_idx, lower_step, upper_step)
        chis.append(chi2_after)
    return poses, _stack(chis, poses)


def gn_solve(poses, e_from, e_to, Z, Omega, free_idx, n_free,
             lam=1e-4, iterations=10):
    """Replicated single-device GN/LM loop with a fixed damping `lam`
    (Cholesky factor and solve).  Returns (poses, chi2 before each
    update)."""
    Z_inv = _se3_inv(Z)
    chis = []
    for _ in range(iterations):
        H, b, chi2 = gn_normal_equations(poses, e_from, e_to, Z_inv, Z,
                                         Omega, n_free, free_idx)
        Hd = H + lam * torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
        x = torch.cholesky_solve(b[:, None], torch.linalg.cholesky(Hd))[:, 0]
        poses = _apply_step(poses, x, free_idx, n_free)
        chis.append(chi2)
    return poses, _stack(chis, poses)
