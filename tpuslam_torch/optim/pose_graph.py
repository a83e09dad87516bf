"""SE3 pose-graph Levenberg-Marquardt: the host backend of
tpuslam/optim/pose_graph.py (numpy/scipy, f64), copied, and the dispatch
to the device backends (backend="device" / "device-dense",
optim/device.py, in f32 on `device`) as tpuslam's.

Exact behavioral twin of the reference optimizer
(the reference's src/slam/src/core/HyperGraph.cpp, GraphEdge.cpp,
GraphVertex.cpp, g2o/SE3Gradient.cpp, Optimizer.cpp), with all per-edge
math batched:

  * error = [t; q.xyz] of Z^-1 Xi^-1 Xj, quaternion sign-fixed
    (GraphEdge.cpp:27-43),
  * analytic Jacobians via the g2o dq_dR chain rule
    (SE3Gradient.cpp:39-172), vectorized over edges,
  * quadratic form assembled like the reference: per-edge diagonal blocks
    (J^T O J)^T and ONE off-diagonal block (J_i^T O J_j)^T at block
    (to, from) (GraphEdge.cpp:60-119).  Eigen's SimplicialLDLT reads only
    the LOWER triangle, so entries landing above the diagonal are dropped
    — we reproduce that by masking triplets to the lower triangle and
    symmetrizing (HyperGraph.cpp:174-208),
  * LM loop with no step rejection: lambda_0 = tau * max|diag|, each
    iteration solves, applies oplus (compact-quaternion increment,
    GraphVertex.cpp:16-39), then rescales lambda by the gain-ratio rule
    clamped to [1/3, 2/3] (HyperGraph.cpp:57-135),
  * robust driver: optimize 5 iters, eject the worst non-neighbor edge
    with chi2 >= 10, rebuild the connected graph, repeat; final
    `final_iterations` polish (Optimizer.cpp:147-225).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..config import OptimizerConfig
from ..geometry import transform as T
from ..mapping.graph import Link, MultiMap, get_connected_graph


# ---------------------------------------------------------------------------
# batched SE3 edge math (float64, vectorized over E edges)
# ---------------------------------------------------------------------------

def _quat_xyz_sign_fixed(R: np.ndarray) -> np.ndarray:
    """(E,3,3) -> (E,3) quaternion xyz with w >= 0 (GraphEdge.cpp:34-40)."""
    q = T.rot_to_quat(R)              # (E,4) wxyz, normalized
    sign = np.where(q[..., 0:1] < 0, -1.0, 1.0)
    return (q[..., 1:] * sign)


def compute_errors(Z_inv: np.ndarray, Xi: np.ndarray,
                   Xj: np.ndarray) -> np.ndarray:
    """(E,6) error = [t; q.xyz] of Z^-1 Xi^-1 Xj."""
    delta = Z_inv @ np.linalg.inv(Xi) @ Xj
    err = np.zeros((len(delta), 6), np.float64)
    err[:, :3] = delta[:, :3, 3]
    err[:, 3:] = _quat_xyz_sign_fixed(delta[:, :3, :3])
    return err


def _compute_dq_dR(Re: np.ndarray) -> np.ndarray:
    """(E,3,3) -> (E,3,9) with columns in column-major R order
    (SE3Gradient.cpp compute_dq_dR:107-172)."""
    E = len(Re)
    tr = np.trace(Re, axis1=1, axis2=2)
    S = np.sqrt(tr + 1.0) * 2.0
    qw = 0.25 * S
    a1 = 1.0 / qw ** 3
    a3 = 1.0 / qw
    a4 = 0.25 * a3
    a5 = -a4
    r21_12 = Re[:, 2, 1] - Re[:, 1, 2]
    r20_02 = Re[:, 2, 0] - Re[:, 0, 2]
    r10_01 = Re[:, 1, 0] - Re[:, 0, 1]
    a2 = -0.03125 * r21_12 * a1
    a6 = 0.03125 * r20_02 * a1
    a7 = -0.03125 * r10_01 * a1

    d = np.zeros((E, 3, 9), np.float64)
    d[:, 0, 0] = a2
    d[:, 0, 4] = a2
    d[:, 0, 5] = a4
    d[:, 0, 7] = a5
    d[:, 0, 8] = a2
    d[:, 1, 0] = a6
    d[:, 1, 2] = a5
    d[:, 1, 4] = a6
    d[:, 1, 6] = a4
    d[:, 1, 8] = a6
    d[:, 2, 0] = a7
    d[:, 2, 1] = a4
    d[:, 2, 3] = a5
    d[:, 2, 4] = a7
    d[:, 2, 8] = a7
    return d


def _skew1_T(v: np.ndarray) -> np.ndarray:
    """skew1(., transposed=1) of 2*v (SE3Gradient.cpp:174-186)."""
    E = len(v)
    x, y, z = 2 * v[:, 0], 2 * v[:, 1], 2 * v[:, 2]
    s = np.zeros((E, 3, 3), np.float64)
    s[:, 0, 1] = -z
    s[:, 0, 2] = y
    s[:, 1, 0] = z
    s[:, 1, 2] = -x
    s[:, 2, 0] = -y
    s[:, 2, 1] = x
    return s


def _skew2(R: np.ndarray, transposed: bool):
    """(Sx, Sy, Sz) each (E,3,3) from 2*R (SE3Gradient.cpp:188-202)."""
    E = len(R)
    r = 2.0 * R
    Sx = np.zeros((E, 3, 3), np.float64)
    Sy = np.zeros((E, 3, 3), np.float64)
    Sz = np.zeros((E, 3, 3), np.float64)
    if transposed:
        Sx[:, 1, :] = r[:, 2, :]
        Sx[:, 2, :] = -r[:, 1, :]
        Sy[:, 0, :] = -r[:, 2, :]
        Sy[:, 2, :] = r[:, 0, :]
        Sz[:, 0, :] = r[:, 1, :]
        Sz[:, 1, :] = -r[:, 0, :]
    else:
        Sx[:, 1, :] = -r[:, 2, :]
        Sx[:, 2, :] = r[:, 1, :]
        Sy[:, 0, :] = r[:, 2, :]
        Sy[:, 2, :] = -r[:, 0, :]
        Sz[:, 0, :] = -r[:, 1, :]
        Sz[:, 1, :] = r[:, 0, :]
    return Sx, Sy, Sz


def _vec_cm(M: np.ndarray) -> np.ndarray:
    """(E,3,3) -> (E,9) column-major flatten."""
    return M.transpose(0, 2, 1).reshape(len(M), 9)


def compute_jacobians(Z: np.ndarray, Xi: np.ndarray, Xj: np.ndarray):
    """(E,6,6) Ji, Jj — batched computeEdgeSE3Gradient
    (SE3Gradient.cpp:39-105)."""
    E = len(Z)
    A = np.linalg.inv(Z)
    B = np.linalg.inv(Xi) @ Xj
    Emat = A @ B
    Re = Emat[:, :3, :3]
    Ra = A[:, :3, :3]
    Rb = B[:, :3, :3]
    tb = B[:, :3, 3]

    dq_dR = _compute_dq_dR(Re)

    Ji = np.zeros((E, 6, 6), np.float64)
    Jj = np.zeros((E, 6, 6), np.float64)

    Ji[:, 0:3, 0:3] = -Ra
    Jj[:, 0:3, 0:3] = Re
    Ji[:, 0:3, 3:6] = Ra @ _skew1_T(tb)
    # dte/dqj is zero

    # dre/dqi
    Sxt, Syt, Szt = _skew2(Rb, True)
    M = np.stack([_vec_cm(Ra @ Sxt), _vec_cm(Ra @ Syt),
                  _vec_cm(Ra @ Szt)], axis=2)        # (E,9,3)
    Ji[:, 3:6, 3:6] = dq_dR @ M

    # dre/dqj
    I3 = np.broadcast_to(np.eye(3), (E, 3, 3))
    Sx, Sy, Sz = _skew2(I3, False)
    M = np.stack([_vec_cm(Re @ Sx), _vec_cm(Re @ Sy),
                  _vec_cm(Re @ Sz)], axis=2)
    Jj[:, 3:6, 3:6] = dq_dR @ M

    return Ji, Jj


def _oplus(est: np.ndarray, upd: np.ndarray) -> np.ndarray:
    """Vertex::oplus for one pose: compact-quaternion increment."""
    inc = np.eye(4)
    v = upd[3:]
    w2 = 1.0 - float(v @ v)
    if w2 >= 0:
        q = np.array([np.sqrt(w2), v[0], v[1], v[2]])
        inc[:3, :3] = T.quat_to_rot(q)
    inc[:3, 3] = upd[:3]
    return est @ inc


# ---------------------------------------------------------------------------
# HyperGraph twin
# ---------------------------------------------------------------------------

class PoseGraphOptimizer:
    def __init__(self, cfg: OptimizerConfig = OptimizerConfig()):
        self.cfg = cfg
        self.ids: list[int] = []
        self.estimates: dict[int, np.ndarray] = {}   # id -> 4x4 f64
        self.fixed: set[int] = set()
        self.edges: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        # (from_id, to_id, measurement 4x4, information 6x6)
        self._edge_keys: list[int] = []   # multimap key per edge (driver)

    def add_vertex(self, vid: int, pose: np.ndarray, fixed: bool = False):
        if vid not in self.estimates:
            self.ids.append(vid)
            self.ids.sort()
        self.estimates[vid] = np.asarray(pose, np.float64).copy()
        if fixed:
            self.fixed.add(vid)

    def add_edge(self, from_id: int, to_id: int, measurement: np.ndarray,
                 information: np.ndarray, key: int | None = None):
        self.edges.append((from_id, to_id,
                           np.asarray(measurement, np.float64).copy(),
                           np.asarray(information, np.float64).copy()))
        self._edge_keys.append(from_id if key is None else key)

    # -- per-iteration batched quantities ---------------------------------
    def _gather(self):
        Xi = np.stack([self.estimates[f] for f, _, _, _ in self.edges])
        Xj = np.stack([self.estimates[t] for _, t, _, _ in self.edges])
        Z = np.stack([m for _, _, m, _ in self.edges])
        O = np.stack([o for _, _, _, o in self.edges])
        return Xi, Xj, Z, O

    def compute_active_errors(self) -> float:
        """Total chi2 (HyperGraph::computeActiveErrors)."""
        if not self.edges:
            return 0.0
        Xi, Xj, Z, O = self._gather()
        err = compute_errors(np.linalg.inv(Z), Xi, Xj)
        return float(np.einsum("ei,eij,ej->", err, O, err))

    def edge_chi2(self) -> np.ndarray:
        Xi, Xj, Z, O = self._gather()
        err = compute_errors(np.linalg.inv(Z), Xi, Xj)
        return np.einsum("ei,eij,ej->e", err, O, err)

    def optimize(self, iterations: int) -> float:
        """HyperGraph::optimize (HyperGraph.cpp:57-97)."""
        if not self.edges:
            return 0.0
        # index mapping skipping fixed vertices (buildIndexMapping)
        hidx = {}
        n = 0
        for vid in self.ids:
            if vid in self.fixed:
                hidx[vid] = -1
            else:
                hidx[vid] = n
                n += 1
        size = n * 6
        if size == 0:
            return self.compute_active_errors()

        e_from = np.array([hidx[f] for f, _, _, _ in self.edges])
        e_to = np.array([hidx[t] for _, t, _, _ in self.edges])

        current_lambda = 0.0
        for it in range(iterations):
            Xi, Xj, Z, O = self._gather()
            Z_inv = np.linalg.inv(Z)
            err = compute_errors(Z_inv, Xi, Xj)
            current_chi = float(np.einsum("ei,eij,ej->", err, O, err))

            Ji, Jj = compute_jacobians(Z, Xi, Xj)

            # b += J^T (-Omega e) for each non-fixed endpoint
            w_err = -np.einsum("eij,ej->ei", O, err)         # (E,6)
            b = np.zeros(size)
            Jt_e_i = np.einsum("eji,ej->ei", Ji, w_err)
            Jt_e_j = np.einsum("eji,ej->ei", Jj, w_err)
            for e in range(len(self.edges)):
                if e_from[e] >= 0:
                    b[e_from[e] * 6:e_from[e] * 6 + 6] += Jt_e_i[e]
                if e_to[e] >= 0:
                    b[e_to[e] * 6:e_to[e] * 6 + 6] += Jt_e_j[e]

            # H blocks, inserted transposed like the reference
            JtO_i = np.einsum("eji,ejk->eik", Ji, O)
            JtO_j = np.einsum("eji,ejk->eik", Jj, O)
            m_ii = JtO_i @ Ji         # (E,6,6)
            m_jj = JtO_j @ Jj
            m_ij = JtO_i @ Jj         # off-diagonal block

            rows, cols, vals = [], [], []

            def put_block(bi, bj, m_T):
                # reference inserts m(i,j) at (row j, col i) => m^T block
                rows.append(np.repeat(bi * 6 + np.arange(6), 6))
                cols.append(np.tile(bj * 6 + np.arange(6), 6))
                vals.append(m_T.reshape(-1))

            max_diag = 0.0
            for e in range(len(self.edges)):
                if e_from[e] >= 0:
                    put_block(e_from[e], e_from[e], m_ii[e].T)
                if e_to[e] >= 0:
                    put_block(e_to[e], e_to[e], m_jj[e].T)
                if e_from[e] >= 0 and e_to[e] >= 0:
                    # block (to, from) = (Ji^T O Jj)^T
                    put_block(e_to[e], e_from[e], m_ij[e].T)
                if it == 0:
                    if e_from[e] >= 0:
                        max_diag = max(max_diag,
                                       np.abs(np.diag(m_ii[e])).max())
                    if e_to[e] >= 0:
                        max_diag = max(max_diag,
                                       np.abs(np.diag(m_jj[e])).max())

            if it == 0:
                current_lambda = self.cfg.tau * max_diag

            rows = np.concatenate(rows)
            cols = np.concatenate(cols)
            vals = np.concatenate(vals)
            A = sp.coo_matrix((vals, (rows, cols)),
                              shape=(size, size)).tocsr()
            # SimplicialLDLT reads only the lower triangle
            L = sp.tril(A, k=0)
            A_eff = (L + L.T - sp.diags(L.diagonal()) +
                     current_lambda * sp.eye(size)).tocsc()
            x = spla.spsolve(A_eff, b)

            # update (updateGraph): vertices in id order
            k = 0
            for vid in self.ids:
                if vid not in self.fixed:
                    self.estimates[vid] = _oplus(self.estimates[vid],
                                                 x[k * 6:k * 6 + 6])
                    k += 1

            # lambda rescale (scaleLambda)
            scale = float(x @ (current_lambda * x + b)) + 1e-3
            rho = (current_chi - self.compute_active_errors()) / scale
            alpha = 1.0 - (2.0 * rho - 1.0) ** 3
            alpha = min(alpha, self.cfg.upper_step)
            current_lambda *= max(self.cfg.lower_step, alpha)

        return self.compute_active_errors()


# ---------------------------------------------------------------------------
# Optimizer driver (Optimizer.cpp)
# ---------------------------------------------------------------------------

def _build(poses: dict, links: MultiMap,
           cfg: OptimizerConfig) -> PoseGraphOptimizer:
    g = PoseGraphOptimizer(cfg)
    for vid in sorted(poses):
        g.add_vertex(vid, np.asarray(poses[vid], np.float64),
                     fixed=(vid == 1))
    for key, link in links.items():
        g.add_edge(link.from_id, link.to_id,
                   np.asarray(link.transform, np.float64),
                   link.info, key=key)
    return g


def run_optimize(poses: dict, links: MultiMap, num: int,
                 cfg: OptimizerConfig = OptimizerConfig(),
                 backend: str = "host", device="cuda"):
    """runOptimize twin (Optimizer.cpp:94-145).

    backend="host": the f64 SciPy-LDLT behavioral twin.
    backend="device": the LM twin with the structure-aware solver
    (optim.device.lm_solve_sparse: block-Thomas over the quirk system's
    block-tridiagonal part, kernel K7 on the card, + Woodbury extras) in
    f32 on `device`, O(V) memory; the dense lm_solve where fewer than two
    vertices are free.
    backend="device-dense": the dense (6V)^2 variant (lm_solve), kept
    for cross-validation.

    Returns (optimized_poses dict of 4x4 f32, final chi2)."""
    if backend in ("device", "device-dense"):
        return _run_optimize_device(poses, links, num, cfg,
                                    dense=backend == "device-dense",
                                    device=device)
    g = _build(poses, links, cfg)
    err = g.optimize(num)
    out = {vid: g.estimates[vid].astype(np.float32)
           for vid in sorted(poses)}
    return out, err


def _run_optimize_device(poses: dict, links: MultiMap, num: int,
                         cfg: OptimizerConfig, dense: bool = False,
                         device="cuda"):
    import torch
    from . import device as dev
    ids, pose_arr, e_from, e_to, Z, Omega, free_idx = \
        dev.graph_to_arrays(poses, links)
    if len(e_from) == 0 or (free_idx >= 0).sum() == 0:
        return ({vid: np.asarray(poses[vid], np.float32)
                 for vid in sorted(poses)}, 0.0)
    n_free = int((free_idx >= 0).sum())

    def on(a, dtype=torch.float32):
        return torch.as_tensor(a, dtype=dtype, device=device)

    args = (on(pose_arr), on(e_from, torch.long), on(e_to, torch.long),
            on(Z), on(Omega), on(free_idx, torch.long), n_free)
    kw = dict(iterations=num, tau=cfg.tau, lower_step=cfg.lower_step,
              upper_step=cfg.upper_step)
    if dense or n_free < 2:
        out_poses, chis = dev.lm_solve(*args, **kw)
    else:
        xsel, xp, xq = dev.classify_extra_edges(e_from, e_to, free_idx)
        out_poses, chis = dev.lm_solve_sparse(
            *args, on(xsel, torch.long), on(xp, torch.long),
            on(xq, torch.long), **kw)
    out_poses = out_poses.cpu().numpy()
    return ({vid: out_poses[i] for i, vid in enumerate(ids)},
            float(chis[-1]))


def run_optimize_robust(poses: dict, links: MultiMap, num: int,
                        cfg: OptimizerConfig = OptimizerConfig(),
                        backend: str = "host", device="cuda"):
    """runOptimizeRobust twin (Optimizer.cpp:147-225): iteratively eject
    the worst non-neighbor (loop-closure) edge with chi2 >= outlier_chi2,
    rebuilding the connected graph each round.  The ejection driver is
    host control flow in every backend.  As in tpuslam, only
    backend="device" solves the ejection rounds on `device`;
    "device-dense" solves them on the host and only its final run_optimize
    on `device`."""
    inliers = links.copy()
    while True:
        poses_out, links_out = get_connected_graph(1, poses, inliers)
        g = _build(poses_out, links_out, cfg)
        if backend == "device":
            opt, _ = _run_optimize_device(poses_out, links_out,
                                          cfg.robust_iterations, cfg,
                                          device=device)
            for vid, p in opt.items():
                g.estimates[vid] = np.asarray(p, np.float64)
        else:
            g.optimize(cfg.robust_iterations)
        chi2 = g.edge_chi2() if g.edges else np.zeros(0)

        worst = -1
        worst_err = 0.0
        for e, (f, t, _, _) in enumerate(g.edges):
            if f != t + 1 and t != f + 1 and chi2[e] >= cfg.outlier_chi2:
                if chi2[e] > worst_err:
                    worst, worst_err = e, chi2[e]

        if worst < 0:
            return run_optimize(poses_out, links_out, num, cfg,
                                backend=backend, device=device)

        f_id, t_id = g.edges[worst][0], g.edges[worst][1]
        key = g._edge_keys[worst]
        links_out.remove(key, lambda l: l.from_id == f_id and
                         l.to_id == t_id)
        inliers = links_out
