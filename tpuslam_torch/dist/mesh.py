"""Device mesh and the sharded step functions, on torch.distributed.

Counterpart of tpuslam/dist/mesh.py.  tpuslam expresses a sharding with
`jax.sharding.Mesh` + `shard_map`; the port keeps its two levels (see
dist/__init__.py):

  * a `Mesh` holds this process's shards, each on a torch device (on one
    card several shards share it, as the JAX suite's 8 virtual CPU
    devices share one CPU), and the process group when one is
    initialised.  The mesh has world size x local shards global shards,
    in (rank, local shard) order;
  * a sharded step computes each local shard's partial on its device and
    meets them where tpuslam's `psum` / `pmax` / `all_gather` do: summed
    over the local shards in shard order, then one `all_reduce` (or
    `all_gather`) across processes.
    Without a process group every collective is the identity across
    processes (`jax.process_count() == 1`); with one, the collectives
    run whatever its size (a one-rank NCCL group still goes through
    NCCL).

What tpuslam replicates on every device (the dense solve, the oplus, the
gain-ratio rescale) runs once per process on the mesh's first device and
is copied to the other local devices: the same numbers on each shard.
The sparse step's block-Thomas root solve runs on global shard 0 only and
reaches the other ranks by one `broadcast` (tpuslam: `lax.cond` on
axis_index 0, then a `psum` of x with zeros).  On a CUDA tensor the front
end runs K1, K5, K2 and K3's blur launcher and the root solve K7, each
through its dispatcher; a CPU tensor runs their plain versions.

gloo carries CUDA tensors in all_reduce and broadcast but, in torch's
documentation, not in all_gather: `_all_gather` copies a CUDA tensor to
the host and back for gloo, and counts it in COLLECTIVES["host_hop"].

pad_edges and shard_ba_problem are numpy-only, copied from tpuslam
(tests/test_torch_config.py keeps them equal).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..config import StereoBMConfig
from ..kernels.gftt import gftt_response_auto
from ..kernels.orb import orb_blur_auto
from ..kernels.stereo_bm import stereo_bm
from ..mapping.dictionary import BIG, _first_min, _l2_dist
from ..optim import ba as B
from ..optim import device as dev

# collectives issued across processes, by kind; "host_hop": CUDA tensors
# copied to the host and back for a gloo all_gather
COLLECTIVES = {"all_reduce": 0, "broadcast": 0, "all_gather": 0,
               "host_hop": 0}


def reset_collectives() -> None:
    for k in COLLECTIVES:
        COLLECTIVES[k] = 0


@dataclass(frozen=True)
class Mesh:
    """The shards of this process, each on its device, one axis name, and
    the torch.distributed process group (None: one process).  Every
    process of a group holds the same number of local shards."""
    devices: tuple
    axis: str = "frames"
    group: object = None

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def world(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def rank(self) -> int:
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def size(self) -> int:
        """Global shard count."""
        return self.world * self.local_size

    def shard_ids(self) -> range:
        """Global indices of this process's shards."""
        lo = self.rank * self.local_size
        return range(lo, lo + self.local_size)


def make_mesh(n_devices: int | None = None, axis: str = "frames",
              device="cuda") -> Mesh:
    """A mesh of `n_devices` local shards on `device` (the card unless the
    caller asks for the CPU), joined to the default process group when
    one is initialised.

    "cuda" without an index spreads the shards round-robin over this
    process's cards: every visible card in a one-process run (default
    n_devices: one shard per card), the current card when several
    processes run (multihost.initialize sets it from the rank's index on
    its host; default: one shard).  An indexed card or the CPU holds
    every shard (default: one)."""
    dev_ = torch.device(device)
    group = dist.group.WORLD if dist.is_available() and \
        dist.is_initialized() else None
    if dev_.type == "cuda" and dev_.index is None:
        if group is not None and dist.get_world_size() > 1:
            cards = [torch.device("cuda", torch.cuda.current_device())]
        else:
            cards = [torch.device("cuda", i)
                     for i in range(torch.cuda.device_count())]
        if not cards:
            raise RuntimeError("make_mesh: no CUDA device")
    else:
        cards = [dev_]
    n = n_devices or len(cards)
    return Mesh(tuple(cards[i % len(cards)] for i in range(n)), axis, group)


# ---------------------------------------------------------------------------
# collectives over the mesh
# ---------------------------------------------------------------------------

def _shards(mesh: Mesh, *arrays):
    """Each local shard's slice of the leading axis of every (global)
    array, on the shard's device: global shard g of S takes rows
    [g n / S, (g + 1) n / S)."""
    n = arrays[0].shape[0]
    if n % mesh.size:
        raise ValueError(f"leading dimension {n} is not divisible by the "
                         f"mesh's {mesh.size} shards")
    k = n // mesh.size
    return [tuple(torch.as_tensor(a[g * k:(g + 1) * k], device=d)
                  for a in arrays)
            for g, d in zip(mesh.shard_ids(), mesh.devices)]


def _replicas(mesh: Mesh, t: torch.Tensor) -> dict:
    """`t` on each distinct device of the mesh."""
    return {d: t.to(d) for d in dict.fromkeys(mesh.devices)}


def _reduce(mesh: Mesh, parts: list, op: str = "sum") -> list:
    """tpuslam's psum (op "sum") or pmax ("max") of the tensors in `parts`
    (one list per local shard): over the local shards in shard order on
    the mesh's first device, then one all_reduce of them all across
    processes when there is a process group."""
    lead = mesh.devices[0]
    out = [t.to(lead) for t in parts[0]]
    for shard in parts[1:]:
        out = [a + b.to(lead) if op == "sum" else
               torch.maximum(a, b.to(lead)) for a, b in zip(out, shard)]
    if mesh.group is not None:
        flat = torch.cat([t.reshape(-1) for t in out])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=mesh.group)
        COLLECTIVES["all_reduce"] += 1
        out = [p.reshape(t.shape) for p, t in
               zip(flat.split([t.numel() for t in out]), out)]
    return out


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """(world, *t.shape): `t` of every process, in rank order (a leading
    dimension of 1 without a process group)."""
    if mesh.group is None:
        return t[None]
    hop = t.is_cuda and dist.get_backend(mesh.group) == "gloo"
    src = (t.cpu() if hop else t).contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.world)]
    dist.all_gather(outs, src, group=mesh.group)
    COLLECTIVES["all_gather"] += 1
    COLLECTIVES["host_hop"] += hop
    return torch.stack(outs).to(t.device)


def _broadcast_from_shard0(mesh: Mesh, x: torch.Tensor | None,
                           like: torch.Tensor) -> torch.Tensor:
    """x of global shard 0 (rank 0) on every process; the other ranks
    pass None and receive it in a tensor shaped like `like`."""
    if mesh.group is None:
        return x
    if mesh.rank != 0:
        x = torch.zeros_like(like)
    dist.broadcast(x, src=0, group=mesh.group)
    COLLECTIVES["broadcast"] += 1
    return x


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------

def frontend_one(left, right, cfg: StereoBMConfig = StereoBMConfig(),
                 device="cuda"):
    """Per-frame device front end of one (H, W) uint8 stereo pair (numpy
    or tensors), on `device` (the card unless the caller asks for the
    CPU): (disparity (H, W) int16 x16 with the speckle pass, GFTT
    response (H, W) float32 at block 3, the 7x7 blurred left image
    (H, W) uint8 for descriptors).  tpuslam computes the disparity with
    its StereoBM strip kernel (Pallas on a TPU) and the corner response
    and the blur in XLA; a CUDA pair runs K1 and K5 (StereoBM with its
    left-right check, then the speckle pass), K2 (the response: the first
    output of its response-and-dilation launch) and K3's blur launcher,
    each through its dispatcher in `kernels/`."""
    lb = torch.as_tensor(left, device=device)[None].contiguous()
    rb = torch.as_tensor(right, device=device)[None].contiguous()
    disp = stereo_bm(lb, rb, cfg)                            # K1, K5
    eig = gftt_response_auto(lb, 3)                          # K2
    blurred = orb_blur_auto(lb)                              # K3's blur
    return disp[0], eig[0], blurred[0]


def sharded_frontend_step(mesh: Mesh, cfg: StereoBMConfig | None = None,
                          with_speckle: bool = True):
    """Returns fn((B, H, W) uint8 lefts, rights) -> (disparity int16,
    response float32, blurred uint8), each (B_rank, H, W): frames sharded
    over the mesh (B divisible by its global shard count), each shard's
    block in ONE batched call of StereoBM (K1, K5, then the speckle pass
    when asked), the GFTT response at block 3 (K2) and the ORB blur (K3's
    blur launcher); the outputs of this process's shards concatenated in
    shard order on the mesh's first device.  Each process returns its own
    block, as tpuslam's out_specs=P(axis) leaves the result sharded."""
    cfg = cfg or StereoBMConfig()

    def step(lefts, rights):
        outs = []
        for lb, rb in _shards(mesh, lefts, rights):
            lb, rb = lb.contiguous(), rb.contiguous()
            outs.append((stereo_bm(lb, rb, cfg, with_speckle=with_speckle),
                         gftt_response_auto(lb, 3), orb_blur_auto(lb)))
        lead = mesh.devices[0]
        return tuple(torch.cat([o[k].to(lead) for o in outs])
                     for k in range(3))

    return step


# ---------------------------------------------------------------------------
# pose graph, edges sharded
# ---------------------------------------------------------------------------

def _chi2_after(mesh, new_poses, shards):
    """Sum over every edge shard of e^T Omega e at new_poses."""
    P = _replicas(mesh, new_poses)
    parts = []
    for d, (ef, et, Z_inv, _, Om) in zip(mesh.devices, shards):
        err = dev.edge_errors(Z_inv, P[d][ef], P[d][et])
        parts.append([torch.einsum("ei,eij,ej->", err, Om, err)])
    return _reduce(mesh, parts)[0]


def _edge_shards(mesh, e_from, e_to, Z, Omega):
    out = []
    for ef, et, Zs, Os in _shards(mesh, e_from, e_to, Z, Omega):
        Zs, Os = Zs.float(), Os.float()
        out.append((ef, et, dev._se3_inv(Zs), Zs, Os))
    return out


def sharded_pose_graph_step(mesh: Mesh, n_vertices: int, n_free: int,
                            iterations: int = 5, tau: float = 1e-5,
                            lower_step: float = 1.0 / 3.0,
                            upper_step: float = 2.0 / 3.0):
    """Returns the LM step with EDGES sharded over the mesh:
    fn(poses (V,4,4), e_from, e_to (E,), Z (E,4,4), Omega (E,6,6),
    free_idx (V,)) -> (poses, chi2 after each iteration).  Each shard
    linearizes its edge slice into the partial quirk-layout normal
    equations (optim.device.lm_system, HyperGraph.cpp:174-208), one
    all-reduce meets (A, b, chi2) and one the max of max_diag, and the
    dense solve of tril(A) + tril(A)^T - diag + lambda I, the oplus and
    the gain-ratio rescale run replicated.  Semantics == optim.device.
    lm_solve up to f32 reduction order.

    The edge count must be divisible by the global shard count (pad with
    zero-information edges, pad_edges)."""

    def step(poses, e_from, e_to, Z, Omega, free_idx):
        lead = mesh.devices[0]
        poses = torch.as_tensor(poses, dtype=torch.float32, device=lead)
        free_idx = torch.as_tensor(free_idx, device=lead)
        frees = _replicas(mesh, free_idx)
        shards = _edge_shards(mesh, e_from, e_to, Z, Omega)
        lam = poses.new_zeros(())
        chis = []
        for it in range(iterations):
            P = _replicas(mesh, poses)
            parts = [dev.lm_system(P[d], ef, et, Z_inv, Zs, Os, n_free,
                                   frees[d])
                     for d, (ef, et, Z_inv, Zs, Os) in
                     zip(mesh.devices, shards)]
            A, b, chi2 = _reduce(mesh, [p[:3] for p in parts])
            max_diag, = _reduce(mesh, [p[3:] for p in parts], "max")
            if it == 0:
                lam = tau * max_diag
            x = dev._dense_solve(A, b, lam)
            new_poses = dev._apply_step(poses, x, free_idx, n_free)
            chi2_after = _chi2_after(mesh, new_poses, shards)
            lam = dev._scale_lambda(x, b, lam, chi2, chi2_after, lower_step,
                                    upper_step)
            poses = new_poses
            chis.append(chi2_after)
        return poses, dev._stack(chis, poses)

    return step


def sharded_pose_graph_step_sparse(mesh: Mesh, n_free: int,
                                   iterations: int = 5, tau: float = 1e-5,
                                   lower_step: float = 1.0 / 3.0,
                                   upper_step: float = 2.0 / 3.0):
    """sharded_pose_graph_step with the structure-aware solver
    (optim.device.lm_solve_sparse): each shard linearizes its edge slice
    into the sparse block form (diagonal blocks, first sub-diagonal,
    capped extras), so the all-reduced payload is O(V) blocks instead of
    the dense (6V)^2 matrix; the block-Thomas + Woodbury root solve
    (`_sparse_solve`: kernel K7 on a CUDA tensor) runs on global shard 0
    alone and its (6V,) solution reaches the other ranks by one
    broadcast.  fn(poses, e_from, e_to, Z, Omega, free_idx, xsel, xp, xq)
    -> (poses, chis), with xsel/xp/xq from classify_extra_edges on the
    UNSHARDED edge list, xsel sharded (padded with -1) alongside the
    edges."""
    n_sub = n_free - 1

    def step(poses, e_from, e_to, Z, Omega, free_idx, xsel, xp, xq):
        lead = mesh.devices[0]
        poses = torch.as_tensor(poses, dtype=torch.float32, device=lead)
        free_idx = torch.as_tensor(free_idx, device=lead)
        xp = torch.as_tensor(xp, device=lead)
        xq = torch.as_tensor(xq, device=lead)
        frees, xps, xqs = (_replicas(mesh, t) for t in (free_idx, xp, xq))
        shards = _edge_shards(mesh, e_from, e_to, Z, Omega)
        xsels = [s[0] for s in _shards(mesh, xsel)]
        lam = poses.new_zeros(())
        chis = []
        for it in range(iterations):
            P = _replicas(mesh, poses)
            parts = [dev.sparse_system(P[d], ef, et, Z_inv, Zs, Os, n_free,
                                       frees[d], xs, xps[d], xqs[d], n_sub)
                     for d, (ef, et, Z_inv, Zs, Os), xs in
                     zip(mesh.devices, shards, xsels)]
            D, S, X, b, chi2 = _reduce(mesh, [p[:5] for p in parts])
            max_diag, = _reduce(mesh, [p[5:] for p in parts], "max")
            if it == 0:
                lam = tau * max_diag
            x = dev._sparse_solve(D, S, X, xp, xq, b, lam) \
                if mesh.rank == 0 else None                  # K7
            x = _broadcast_from_shard0(mesh, x, b)
            new_poses = dev._apply_step(poses, x, free_idx, n_free)
            chi2_after = _chi2_after(mesh, new_poses, shards)
            lam = dev._scale_lambda(x, b, lam, chi2, chi2_after, lower_step,
                                    upper_step)
            poses = new_poses
            chis.append(chi2_after)
        return poses, dev._stack(chis, poses)

    return step


# ---------------------------------------------------------------------------
# bundle adjustment, landmarks sharded
# ---------------------------------------------------------------------------

def shard_ba_problem(lms, obs_cam, obs_lm, obs_uv, obs_valid,
                     n_shards: int):
    """Regroup a BA problem for landmark-axis sharding.

    Landmarks are padded to a multiple of n_shards; observations are
    re-bucketed so shard k's equal-size observation block references only
    shard k's landmarks, with obs_lm rewritten to LOCAL indices.
    Returns (lms_p, obs_cam_p, obs_lm_local_p, obs_uv_p, obs_valid_p,
    L_local, O_local).
    """
    L = lms.shape[0]
    L_pad = -(-L // n_shards) * n_shards
    L_local = L_pad // n_shards
    lms_p = np.zeros((L_pad, 3), lms.dtype)
    lms_p[:L] = lms

    shard_of = np.asarray(obs_lm) // L_local
    buckets = [[] for _ in range(n_shards)]
    for i in range(len(obs_cam)):
        if obs_valid[i]:
            buckets[int(shard_of[i])].append(i)
    O_local = max((len(b) for b in buckets), default=1)
    O_local = max(O_local, 1)

    oc = np.zeros((n_shards * O_local,), np.int32)
    ol = np.zeros((n_shards * O_local,), np.int32)
    uv = np.zeros((n_shards * O_local, 2), np.float32)
    ov = np.zeros((n_shards * O_local,), bool)
    for s, b in enumerate(buckets):
        for j, i in enumerate(b):
            k = s * O_local + j
            oc[k] = obs_cam[i]
            ol[k] = obs_lm[i] - s * L_local     # local index
            uv[k] = obs_uv[i]
            ov[k] = True
    return lms_p, oc, ol, uv, ov, L_local, O_local


def make_sharded_ba_step(mesh: Mesh, n_cams: int, L_local: int,
                         iterations: int = 8, damping: float = 1e-4,
                         huber_delta: float = float("inf"),
                         n_fixed: int = 1):
    """Landmark-axis sharded windowed BA: each shard assembles the normal
    equations of ITS landmarks (optim.ba.ba_normal_equations) and their
    Schur terms, one all-reduce meets (H_cc, b_c, S_corr, b_corr), the
    (6W, 6W) reduced camera system is solved replicated
    (torch.linalg.solve, as tpuslam solves it in XLA) and the landmark
    back-substitution stays local.  Same LM accept/reject and damping
    schedule as optim.ba.ba_solve, up to reduction order.

    Returns fn(Tcw (W,4,4), lms (S*L_local,3), intr (4,), obs_cam
    (S*O_local,), obs_lm_local, obs_uv, obs_valid) -> (Tcw', this
    process's landmarks (local shards * L_local, 3), cost), with the
    landmark and observation arrays laid out by shard_ba_problem."""
    n6 = 6 * n_cams

    def step(Tcw, lms, intr, obs_cam, obs_lm, obs_uv, obs_valid):
        lead = mesh.devices[0]
        f32 = dict(dtype=torch.float32)
        Tcw = torch.as_tensor(Tcw, device=lead, **f32)
        intrs = _replicas(mesh, torch.as_tensor(intr, device=lead, **f32))
        lms_s = [s[0].float() for s in _shards(mesh, lms)]
        obs = _shards(mesh, obs_cam, obs_lm, obs_uv, obs_valid)
        if any(lm.shape[0] != L_local for lm in lms_s):
            raise ValueError("lms is not S * L_local rows")
        eye3 = {d: torch.eye(3, device=d, **f32) for d in intrs}

        def eval_cost(Tcw, lms_s):
            T = _replicas(mesh, Tcw)
            parts = []
            for d, lm, (oc, ol, uv, ov) in zip(mesh.devices, lms_s, obs):
                Tc = T[d][oc]
                X = lm[ol]
                r = B.project(Tc, X, intrs[d])[0] - uv
                z = torch.sum(Tc[:, 2, :3] * X, dim=-1) + Tc[:, 2, 3]
                r2 = torch.sum(r * r, dim=-1)
                w = B._huber_w(r2, huber_delta) * ov.float() * (z > 0.1)
                parts.append([torch.sum(w * r2)])
            return _reduce(mesh, parts)[0]

        mask = torch.ones(n6, device=lead, **f32)
        mask[:6 * n_fixed] = 0.0
        cams = torch.arange(n_cams, device=lead)
        lam = torch.tensor(damping, device=lead, **f32)
        cost = eval_cost(Tcw, lms_s)
        for _ in range(iterations):
            T = _replicas(mesh, Tcw)
            lams = _replicas(mesh, lam)
            parts, local = [], []
            for d, lm, (oc, ol, uv, ov) in zip(mesh.devices, lms_s, obs):
                H_cc, b_c, H_cl, H_ll, b_l, _ = B.ba_normal_equations(
                    T[d], lm, intrs[d], oc, ol, uv, ov, n_cams, L_local,
                    huber_delta)
                tr = torch.diagonal(H_ll, dim1=1, dim2=2).sum(-1) / 3.0
                Hll_inv = B._inv3x3(H_ll + (lams[d] * tr + 1e-3)[:, None,
                                                                  None]
                                    * eye3[d])
                WHinv = torch.einsum("wlij,ljk->wlik", H_cl, Hll_inv)
                S_corr = torch.einsum("wlik,vljk->wvij", WHinv, H_cl)
                b_corr = torch.einsum("wlik,lk->wi", WHinv, b_l)
                parts.append([H_cc, b_c, S_corr, b_corr])
                local.append((H_cl, Hll_inv, b_l))
            H_cc, b_c, S_corr, b_corr = _reduce(mesh, parts)

            diag_damp = torch.diag_embed(
                lam * torch.diagonal(H_cc, dim1=1, dim2=2) + 1e-6)
            S = -S_corr
            S[cams, cams] = S[cams, cams] + H_cc + diag_damp
            S = S.permute(0, 2, 1, 3).reshape(n6, n6)
            rhs = (b_c - b_corr).reshape(-1)
            S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
            dx_c = -torch.linalg.solve(S, rhs * mask).reshape(n_cams, 6)

            dxs = _replicas(mesh, dx_c)
            lms_try = []
            for d, lm, (H_cl, Hll_inv, b_l) in zip(mesh.devices, lms_s,
                                                   local):
                Hlc_dx = torch.einsum("wlij,wi->lj", H_cl, dxs[d])
                lms_try.append(lm - torch.einsum("lij,lj->li", Hll_inv,
                                                 b_l + Hlc_dx))
            Tcw_try = B._se3_exp(dx_c) @ Tcw
            cost_try = eval_cost(Tcw_try, lms_try)
            accept = cost_try < cost
            Tcw = torch.where(accept, Tcw_try, Tcw)
            lms_s = [torch.where(accept.to(a.device), a, b)
                     for a, b in zip(lms_try, lms_s)]
            lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-7),
                              torch.clamp(lam * 5.0, max=1e3))
            cost = torch.where(accept, cost_try, cost)
        return Tcw, torch.cat([lm.to(lead) for lm in lms_s]), cost

    return step


def pad_edges(e_from, e_to, Z, Omega, multiple: int):
    """Pad edge arrays to a multiple with zero-information self-edges."""
    E = len(e_from)
    pad = (-E) % multiple
    if pad == 0:
        return e_from, e_to, Z, Omega
    ef = np.concatenate([e_from, np.zeros(pad, e_from.dtype)])
    et = np.concatenate([e_to, np.zeros(pad, e_to.dtype)])
    Zp = np.concatenate([Z, np.tile(np.eye(4, dtype=Z.dtype),
                                    (pad, 1, 1))])
    Op = np.concatenate([Omega, np.zeros((pad, 6, 6), Omega.dtype)])
    return ef, et, Zp, Op


# ---------------------------------------------------------------------------
# dictionary top-2, words sharded
# ---------------------------------------------------------------------------

NO_WORD = 2 ** 30


def _merge2(cd, cw):
    """(K, Q) candidate distances and word ids -> the two best per query
    with the (distance, word id) ascending tie-break."""
    d1 = cd.amin(dim=0)
    w1 = torch.where(cd == d1[None], cw, NO_WORD).amin(dim=0)
    hit1 = (cd == d1[None]) & (cw == w1[None])
    cd2 = torch.where(hit1, BIG, cd)
    d2 = cd2.amin(dim=0)
    w2 = torch.where(cd2 == d2[None], cw, NO_WORD).amin(dim=0)
    return d1, w1, d2, w2


def sharded_dict_top2_step(mesh: Mesh, axis: str = "words"):
    """Word-axis-sharded BoW dictionary top-2, the on-mesh analog of
    ShardedVWDictionary's cross-rank merge (dist/partitioned_map.py):
    each shard searches its own word rows (|q|^2 + |t|^2 - 2 q t^T, one
    f32 matmul with TF32 off), the shards' two best (distance, global
    word id) pairs are gathered, and every process merges them with the
    single-process tie-break (ascending distance, then ascending word id).

    fn(query (Q,32) f32 replicated; train (W,32) f32, word_ids (W,) i32,
    valid (W,) bool sharded on the word axis) -> (d1, w1, d2), identical
    to an unsharded exact top-2.  `axis` must be the mesh's axis (tpuslam
    gathers over it by name)."""
    if axis != mesh.axis:
        raise ValueError(f"axis {axis!r} is not the mesh's {mesh.axis!r}")

    def step(query, train, word_ids, valid):
        lead = mesh.devices[0]
        qs = _replicas(mesh, torch.as_tensor(query, dtype=torch.float32,
                                             device=lead))
        cds, cws = [], []
        for d, (t, wids, v) in zip(mesh.devices,
                                   _shards(mesh, train, word_ids, valid)):
            d1, i1, dm = _first_min(_l2_dist(qs[d], t.float(), v))
            d2, i2, _ = _first_min(dm)
            wids = wids.int()
            cds.append(torch.stack([d1, d2]).to(lead))
            cws.append(torch.stack([torch.where(d1 < BIG, wids[i1], NO_WORD),
                                    torch.where(d2 < BIG, wids[i2],
                                                NO_WORD)]).to(lead))
        q = qs[lead].shape[0]
        cd = _all_gather(mesh, torch.cat(cds)).reshape(-1, q)
        cw = _all_gather(mesh, torch.cat(cws)).reshape(-1, q)
        g1, gw1, g2, _ = _merge2(cd, cw)
        return g1, gw1, g2

    return step
