"""Fused visual odometry over frame chunks, in PyTorch.

Counterpart of tpuslam/vo/fused.py.  A chunk of B stereo pairs goes
through the front end as one batch (StereoBM disparity, GFTT response +
3x3 dilation + two-stage top-k, greedy min-distance NMS, the ORB border
filter, ORB descriptors, the 3D lift), then a Python loop runs the
per-frame VO step over the chunk: the Hamming matrix, guided and global
top-2 NNDR matching with dedup and the wrong-guess retry, 300-hypothesis
EPnP RANSAC, the LM refine rounds with the reference's swap semantics, the
covariance medians and the keyframe and velocity state.
The loop keeps `lax.scan`'s active-mask semantics: an inactive (padding)
frame runs but leaves the carry unchanged.

The VO step never reads a tensor on the host (no .item(), no bool() of a
tensor), so the frames of a chunk queue on the device without a sync.

The chunk's disparity is SGBM's for depth_method "sgbm" and StereoBM's
for every other method, "lk" and "cv_bm" included, as tpuslam's fused
program computes it (tpuslam/vo/fused.py:242-252: the sparse LK and the
OpenCV oracle run only on the per-frame path).  With `fused_speckle` the
chunk's disparity goes through the batch speckle filter in the engine's
range (SGBM's x16), as tpuslam's batched_frontend filters it.  The
factories build on the card unless the caller asks for the CPU
(device="cpu").

RANSAC draws: tpuslam seeds each frame's hypotheses with
jax.random.PRNGKey(frame index); here each frame takes its (n_hyp, 6)
uniforms from the `draws` argument of the chunk step.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..config import SlamConfig
from ..geometry.camera import StereoCameraModel
from ..kernels import _cuda
from ..kernels import matching as M
from ..kernels import pnp as P
from ..kernels.gftt import gftt_candidates, select_from_candidates_device
from ..kernels.orb import orb_descriptors_const_angle
from ..kernels.sgbm import sgbm
from ..kernels.stereo_bm import stereo_bm
from ..runtime import perf

BIG = 1e9


# ---------------------------------------------------------------------------
# rigid-transform helpers on (4, 4) tensors (twins of geometry/transform.py)
# ---------------------------------------------------------------------------

def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _rot_to_quat(R):
    """Shepperd's method, f32 (transform.py rot_to_quat twin)."""
    t = torch.trace(R)
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    s0 = torch.sqrt(torch.clamp(t + 1.0, min=1e-30)) * 2
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0])
    s1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-30)) * 2
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1])
    s2 = torch.sqrt(torch.clamp(1.0 + m11 - m00 - m22, min=1e-30)) * 2
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2])
    s3 = torch.sqrt(torch.clamp(1.0 + m22 - m00 - m11, min=1e-30)) * 2
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3,
                      0.25 * s3])
    arg = P._first_argmax(torch.stack([m00, m11, m22]))
    q = torch.where(t > 0, q0,
                    torch.where(arg == 0, q1, torch.where(arg == 1, q2, q3)))
    return q / _norm(q)


def _quat_to_rot(q):
    w, x, y, z = q[0], q[1], q[2], q[3]
    n = w * w + x * x + y * y + z * z
    s = torch.where(n > 0, 2.0 / torch.clamp(n, min=1e-30), 0.0)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return torch.stack([
        torch.stack([1 - (yy + zz), xy - wz, xz + wy]),
        torch.stack([xy + wz, 1 - (xx + zz), yz - wx]),
        torch.stack([xz - wy, yz + wx, 1 - (xx + yy)])])


def _compose(a, b):
    """a @ b with quaternion rotation renormalization
    (Transform.cpp:190-200)."""
    m = a @ b
    out = m.clone()
    out[:3, :3] = _quat_to_rot(_rot_to_quat(m[:3, :3]))
    return out


def _inv(t):
    """Rigid 4x4 inverse."""
    R = t[:3, :3]
    out = torch.eye(4, dtype=torch.float32, device=t.device)
    out[:3, :3] = R.T
    out[:3, 3] = -R.T @ t[:3, 3]
    return out


def _from_rpy_xyz(x, y, z, roll, pitch, yaw):
    A, B = torch.cos(yaw), torch.sin(yaw)
    C, D = torch.cos(pitch), torch.sin(pitch)
    E, F = torch.cos(roll), torch.sin(roll)
    DE, DF = D * E, D * F
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([
        torch.stack([A * C, A * DF - B * E, B * F + A * DE, x]),
        torch.stack([B * C, A * E + B * DF, B * DE - A * F, y]),
        torch.stack([-D, C * F, C * E, z]),
        torch.stack([zero, zero, zero, one])])


def _get_rpy(t):
    roll = torch.atan2(t[2, 1], t[2, 2])
    pitch = torch.asin(torch.clamp(-t[2, 0], -1.0, 1.0))
    yaw = torch.atan2(t[1, 0], t[0, 0])
    return roll, pitch, yaw


# ---------------------------------------------------------------------------
# covariance medians: plain version and kernel K4 (csrc/median.cu)
# ---------------------------------------------------------------------------

def _masked_median(x, mask):
    """sorted(kept)[count >> 1] over the last axis — the reference's
    std::sort median pick (MotionEstimation.cpp:188-206)."""
    v = torch.sort(torch.where(mask, x, 3e38), dim=-1).values
    cnt = mask.sum(dim=-1)
    idx = torch.clamp(cnt >> 1, 0, x.shape[-1] - 1)
    return v.gather(-1, idx[..., None])[..., 0], cnt


def masked_median2_plain(a, b, mask):
    """Plain version of kernel K4: (F, N) f32 a, b and (F, N) bool mask ->
    (med_a (F,), med_b (F,), count (F,))."""
    _cuda.PLAIN_CALLS["median"] += 1
    med_a, cnt = _masked_median(a, mask)
    med_b, _ = _masked_median(b, mask)
    return med_a, med_b, cnt


def masked_median2_cuda(a, b, mask):
    """Kernel K4: exact k-th smallest (k = count >> 1) of two masked
    non-negative f32 rows by bisection on the bit pattern; equal to
    masked_median2_plain for non-negative inputs (+inf included)."""
    _cuda.expect(a, "a", torch.float32, 2)
    _cuda.expect(b, "b", torch.float32, 2)
    _cuda.expect(mask, "mask", torch.bool, 2)
    if b.shape != a.shape or mask.shape != a.shape:
        raise ValueError("a, b and mask must share one (F, N) shape")
    F, N = a.shape
    if N == 0:
        raise ValueError("empty rows")
    meds = torch.empty((F, 2), dtype=torch.float32, device=a.device)
    cnt = torch.empty((F,), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        _cuda.launch("median", a, b, mask, meds, cnt, F, N)
    return meds[:, 0], meds[:, 1], cnt


def median_kernel_attrs(n: int) -> dict:
    """Registers, static shared bytes, local bytes per thread and keys per
    thread (0: re-read) of the K4 kernel that rows of n keys take."""
    out = _cuda.attributes("median", "tpuslam_masked_median2_attrs", 4, n)
    return dict(zip(("registers", "shared_bytes", "local_bytes",
                     "keys_per_thread"), out))


def masked_median2(a, b, mask):
    fn = masked_median2_cuda if a.is_cuda else masked_median2_plain
    return fn(a, b, mask)


# ---------------------------------------------------------------------------
# front end
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FusedShapes:
    chunk: int = 40
    capacity: int = 1536
    n_cand: int = 4096
    dec: int = 4                 # disparity decimation for map nodes


def detect_keypoints(lefts: torch.Tensor, cfg: SlamConfig,
                     shapes: FusedShapes = FusedShapes()):
    """GFTT candidates, greedy NMS and the ORB border filter with its
    order-preserving compaction (CvORB.cpp:137-155) over (B, H, W) uint8.
    Returns (kpts (B, C, 3), valid (B, C), n_kpts (B,))."""
    _, H, W = lefts.shape
    C = shapes.capacity
    vals, idx, _, _ = gftt_candidates(
        lefts, cfg.gftt.quality_level, cfg.gftt.block_size,
        max_candidates=shapes.n_cand)
    kpts, valid, _ = select_from_candidates_device(
        vals, idx, W, cfg.gftt.min_distance,
        max_features=cfg.gftt.max_features, capacity=C)
    border = cfg.orb.edge_threshold
    x, y = kpts[..., 0], kpts[..., 1]
    keep = valid & (x >= border) & (x < W - border) & \
        (y >= border) & (y < H - border)
    order = torch.argsort((~keep).to(torch.uint8), dim=1, stable=True)
    kpts = kpts.gather(1, order[..., None].expand(-1, -1, 3))
    n_k = keep.sum(dim=1)
    valid = torch.arange(C, device=lefts.device)[None, :] < n_k[:, None]
    return torch.where(valid[..., None], kpts, 0.0), valid, n_k


def make_frontend_fn(camera: StereoCameraModel, cfg: SlamConfig,
                     shapes: FusedShapes = FusedShapes(),
                     device="cuda"):
    """Front-end factory: (lefts, rights) (B, H, W) uint8 -> feature dict
    of batched tensors (kpts, valid, n_kpts, desc, bits, pts3d,
    disp_dec)."""
    H, W = camera.height, camera.width
    dec = shapes.dec
    Hd, Wd = H // dec, W // dec
    f32 = dict(dtype=torch.float32, device=device)

    local_t = torch.tensor(camera.local_transform, **f32)
    fx = torch.tensor(camera.fx_l, **f32)
    cx_l = torch.tensor(camera.cx_l, **f32)
    cy_l = torch.tensor(camera.cy_l, **f32)
    c_rl = torch.tensor(camera.cx_r - camera.cx_l, **f32)
    wx_n = torch.tensor(camera.Tx_l / camera.fx_l -
                        camera.Tx_r / camera.fx_r, **f32)
    wy_n = torch.tensor(camera.Tx_l / camera.fy_l -
                        camera.Tx_r / camera.fy_r, **f32)

    def compute_disparity(lefts, rights):
        # the dense engines only (tpuslam/vo/fused.py:242-252)
        if cfg.depth_method == "sgbm":
            return sgbm(lefts, rights, cfg.sgbm,
                        with_speckle=cfg.fused_speckle, device=lefts.device)
        return stereo_bm(lefts, rights, cfg.bm,
                         with_speckle=cfg.fused_speckle)

    def frontend(lefts, rights):
        with perf.span("fe.disparity"):
            disp = compute_disparity(lefts, rights)
        with perf.span("fe.gftt"):
            kpts, valid, n_k = detect_keypoints(lefts, cfg, shapes)

        # GFTT keypoints carry angle -1 (GFTT.cpp octave-0 path)
        with perf.span("fe.orb"):
            desc = orb_descriptors_const_angle(
                lefts, kpts[..., :2].contiguous(), valid, angle_deg=-1.0)
        with perf.span("fe.lift"):
            return lift(disp, kpts, valid, n_k, desc)

    def lift(disp, kpts, valid, n_k, desc):
        """The 3D lift (Stereo.cpp:53-117): truncated int coords, /16,
        robot frame; and the feature dict."""
        B = disp.shape[0]
        xi = kpts[..., 0].long()
        yi = kpts[..., 1].long()
        d16 = disp.reshape(B, -1).gather(1, yi * W + xi)
        d = torch.clamp(d16.float() / 16.0, min=0.0)
        denom = d + c_rl
        Wx = wx_n / denom
        Wy = wy_n / denom
        px = (kpts[..., 0] - cx_l) * Wx
        py = (kpts[..., 1] - cy_l) * Wy
        pz = fx * Wx
        pts = torch.stack([px, py, pz], dim=-1)
        pts = pts @ local_t[:3, :3].T + local_t[:3, 3]
        ok3 = (d > 0.0) & valid & torch.isfinite(pts).all(dim=-1)
        pts3d = torch.where(ok3[..., None], pts, float("nan"))

        disp_dec = disp[:, :Hd * dec:dec, :Wd * dec:dec]
        return dict(kpts=kpts, valid=valid, n_kpts=n_k, desc=desc,
                    bits=M.unpack_bits(desc), pts3d=pts3d,
                    disp_dec=disp_dec)

    return frontend


# ---------------------------------------------------------------------------
# fused chunk program factory
# ---------------------------------------------------------------------------

def make_fused_chunk_fn(camera: StereoCameraModel, cfg: SlamConfig,
                        shapes: FusedShapes = FusedShapes(),
                        full_node_offsets: tuple[int, ...] | None = None,
                        device="cuda"):
    """Build (init_carry, chunk_step, full_node_offsets) for the fused VO.

    chunk_step(carry, lefts (B,H,W) u8, rights, dts (B,) f32,
               active (B,) bool, draws (B, n_hyp, 6) f32)
      -> (carry, outs dict, feats dict)

    outs holds per-frame poses, transforms and flags for every frame;
    feats holds the features of the mapper's full-node frames only
    (`full_node_offsets`)."""
    H, W = camera.height, camera.width
    C = shapes.capacity
    B = shapes.chunk
    if full_node_offsets is None:
        mu = cfg.mapper.map_update
        full_node_offsets = tuple(range(mu - 1, B, mu))
    f32 = dict(dtype=torch.float32, device=device)

    local_t = torch.tensor(camera.local_transform, **f32)
    fx, fy = (torch.tensor(v, **f32) for v in (camera.fx_l, camera.fy_l))
    cx_l, cy_l = (torch.tensor(v, **f32) for v in (camera.cx_l, camera.cy_l))
    nndr = torch.tensor(cfg.matching.nndr, **f32)
    radius = torch.tensor(cfg.matching.guess_win_size, **f32)
    min_inl = cfg.pnp.min_inliers
    reproj_err = torch.tensor(cfg.pnp.reprojection_error, **f32)
    refine_sigma = torch.tensor(cfg.pnp.refine_sigma, **f32)
    K_l = torch.tensor(camera.K_l, **f32)
    eye4 = torch.eye(4, **f32)
    eye6 = torch.eye(6, **f32)
    zeros6 = torch.zeros(6, **f32)
    ar = torch.arange(C, device=device)
    off = torch.tensor(full_node_offsets, dtype=torch.long, device=device)
    n_hyp = cfg.pnp.iterations_count

    frontend = make_frontend_fn(camera, cfg, shapes, device)

    # ---- match-set helpers ---------------------------------------------
    def dedup(accept, i1):
        """First-wins train-index dedup (Registration.cpp:284-300): among
        accepted rows sharing i1, keep the lowest from-index."""
        rank = torch.where(accept, ar, C + 1)
        first = torch.full((C,), C + 1, dtype=torch.long, device=device)
        first = first.scatter_reduce(0, i1, rank, reduce="amin")
        return accept & (first[i1] == ar)

    def corr_mask(accept, i1, ref_pts3d):
        """Accepted + deduped + finite-3D correspondences and their count."""
        m = dedup(accept, i1) & torch.isfinite(ref_pts3d).all(dim=1)
        return m, m.sum()

    # ---- the VO step -----------------------------------------------------
    def vo_step(carry, feats, dt, draws):
        with perf.span("vo.match"):
            frames = carry["frames"]
            is_first = frames == 0
            pose = carry["pose"]

            # constant-velocity guess (Odometry.cpp:42-56)
            v = carry["vel"]
            guess = _from_rpy_xyz(v[0] * dt, v[1] * dt, v[2] * dt,
                                  v[3] * dt, v[4] * dt, v[5] * dt)
            has_guess = carry["has_vel"] & ~is_first

            motion_since_kf = _compose(_inv(carry["kf_pose"]), pose)
            guess_update = _compose(motion_since_kf, guess)

            # shared Hamming matrix, ref (query) x cur (train); exact in f32
            dist = (carry["ref_nbits"][:, None] + feats["nbits"][None, :]
                    - 2.0 * (carry["ref_bits"] @ feats["bits"].T))
            dist = torch.where(carry["ref_valid"][:, None] &
                               feats["valid"][None, :], dist, BIG)

            # guided candidate set (Registration.cpp:236-303)
            guess_cam = _inv(_compose(guess_update, local_t))
            pc = carry["ref_pts3d"] @ guess_cam[:3, :3].T + guess_cam[:3, 3]
            pu = pc[:, 0] / pc[:, 2] * fx + cx_l
            pv = pc[:, 1] / pc[:, 2] * fy + cy_l
            pvalid = (torch.isfinite(pu) & torch.isfinite(pv) &
                      (pu > 0.0) & (pu < W - 1) & (pv > 0.0) & (pv < H - 1) &
                      (pc[:, 2] > 0.0) & carry["ref_valid"])
            dxm = torch.nan_to_num(pu, nan=-1e6)[:, None] - \
                feats["kpts"][:, 0][None, :]
            dym = torch.nan_to_num(pv, nan=-1e6)[:, None] - \
                feats["kpts"][:, 1][None, :]
            in_rad = ((dxm * dxm + dym * dym <= radius * radius) &
                      feats["valid"][None, :] & pvalid[:, None])
            n_cand_g = in_rad.sum(dim=1)

            d1g, i1g, d2g, _ = M._top2_min(torch.where(in_rad, dist, BIG))
            acc_g = ((n_cand_g >= 2) & (d1g < nndr * d2g)) | (n_cand_g == 1)
            m_g, n_match_g = corr_mask(acc_g, i1g, carry["ref_pts3d"])

            # global brute-force (Registration.cpp:311-335)
            d1n, i1n, d2n, _ = M._top2_min(dist)
            acc_n = carry["ref_valid"] & (d1n < nndr * d2n)
            m_n, n_match_n = corr_mask(acc_n, i1n, carry["ref_pts3d"])

            # wrong-guess retry (Odometry.cpp:139-142)
            retry = has_guess & (n_match_g <
                                 carry["num_objects"].float() *
                                 cfg.odometry.guess_ratio)
            use_global = ~has_guess | retry
            i1 = torch.where(use_global, i1n, i1g)
            m = torch.where(use_global, m_n, m_g)
            n_match = torch.where(use_global, n_match_n, n_match_g)

        with perf.span("vo.ransac"):
            # PnP RANSAC (MotionEstimation.cpp:279-374)
            obj = torch.nan_to_num(carry["ref_pts3d"], nan=0.0)
            img = feats["kpts"][i1, :2]
            rvec, tvec, inl_mask, n_inl = P.ransac_epnp(
                obj, img, m, K_l, draws, reproj_err, n_hyp=n_hyp)
            ransac_ok = n_inl > 0

        with perf.span("vo.refine"):
            # refinement round(s) with the reference's swap semantics
            inl, rv, tv = inl_mask, rvec, tvec
            thr = reproj_err
            do_refine = n_inl >= min_inl
            prev = inl_mask
            for _ in range(max(cfg.pnp.refine_iterations, 0)):
                rv2, tv2, err = P.refine_lm_with_errors_auto(
                    obj, img, prev.float(), m, K_l, rv, tv)
                new_inl = (err <= thr) & m
                n_new = new_inl.sum()
                kept = torch.where(new_inl, err, 0.0)
                mean = kept.sum() / torch.clamp(n_new, min=1)
                var = torch.where(new_inl, (err - mean) ** 2, 0.0).sum() / \
                    torch.clamp(n_new - 1, min=1)
                thr = torch.minimum(reproj_err, refine_sigma * torch.sqrt(var))
                same = (new_inl == prev).all()
                brk = (n_new < min_inl) | same
                # break -> latest set; budget exhaustion -> previous set
                # (MotionEstimation.cpp:370 std::swap tail)
                inl_final = torch.where(brk, new_inl, prev)
                rv = torch.where(do_refine, rv2, rv)
                tv = torch.where(do_refine, tv2, tv)
                inl = torch.where(do_refine, inl_final, inl)
                prev = torch.where(brk, prev, new_inl)

        with perf.span("vo.pose"):
            n_inliers = inl.sum()
            ok = ((n_match >= min_inl) & ransac_ok & (n_inliers >= min_inl)) \
                | is_first

            # camera pose -> robot-frame transform
            # (MotionEstimation.cpp:155-160)
            pnp_mat = eye4.clone()
            pnp_mat[:3, :3] = P.rodrigues(rv)
            pnp_mat[:3, 3] = tv
            tf = _inv(_compose(local_t, pnp_mat))
            t = torch.where(is_first, eye4, tf)

            # covariance from median errors of inliers
            # (MotionEstimation.cpp:162-214)
            pts_b = feats["pts3d"][i1]
            ok3 = torch.isfinite(pts_b).all(dim=1) & inl
            new_pt = torch.nan_to_num(pts_b, nan=0.0) @ tf[:3, :3].T + \
                tf[:3, 3]
            pts_a = obj
            d2 = torch.sum((pts_a - new_pt) ** 2, dim=1)
            org = tf[:3, 3]
            v1 = pts_a - org
            v2 = new_pt - org
            n1 = _norm(v1) + 1e-30
            n2 = _norm(v2) + 1e-30
            cosr = torch.sum(v1 * v2, dim=1) / (n1 * n2)
            ang_err = torch.acos(torch.clamp(cosr, -1.0, 1.0))
            med_d, med_a, cnt3 = masked_median2(d2[None], ang_err[None],
                                                ok3[None])
            med_d = torch.clamp(med_d[0], min=1e-4)
            med_a = torch.clamp(med_a[0], min=1e-4)
            cov_med = torch.diag(torch.cat([med_d.expand(3), med_a.expand(3)]))
            cov = torch.where(is_first, eye6 * cfg.odometry.initial_cov,
                              torch.where(ok & (cnt3[0] > 0), cov_med, eye6))

            # odometry output transform & keyframe logic (Odometry.cpp:104-183)
            output = _compose(_inv(motion_since_kf), t)
            new_pose = torch.where(ok, _compose(pose, output), pose)
            step_len = torch.where(ok, _norm(output[:3, 3]), 0.0)

            n_ref = carry["ref_n"].float()
            add_kf = is_first | \
                (n_inliers.float() <= cfg.odometry.keyframe_thr * n_ref) | \
                (n_inliers <= cfg.odometry.vis_keyframe_thr)

            # velocity update (Odometry.cpp:62-76 via process)
            roll, pitch, yaw = _get_rpy(output)
            safe_dt = torch.clamp(dt, min=1e-9)
            vel_new = torch.stack([output[0, 3], output[1, 3], output[2, 3],
                                   roll, pitch, yaw]) / safe_dt
            vel = torch.where(dt > 0, torch.where(ok, vel_new, zeros6), zeros6)

            def sel(new, old):
                return torch.where(add_kf, new, old)

            new_carry = dict(
                pose=new_pose,
                vel=vel,
                has_vel=dt > 0,
                kf_pose=sel(new_pose, carry["kf_pose"]),
                ref_kpts=sel(feats["kpts"], carry["ref_kpts"]),
                ref_pts3d=sel(feats["pts3d"], carry["ref_pts3d"]),
                ref_bits=sel(feats["bits"], carry["ref_bits"]),
                ref_nbits=sel(feats["nbits"], carry["ref_nbits"]),
                ref_valid=sel(feats["valid"], carry["ref_valid"]),
                ref_n=sel(feats["n_kpts"], carry["ref_n"]),
                num_objects=torch.where(is_first, carry["num_objects"],
                                        n_match),
                frames=frames + 1,
                dist=carry["dist"] + step_len,
            )
            out = dict(pose=new_pose,
                       transform=torch.where(ok, output,
                                             torch.zeros_like(eye4)),
                       lost=~ok, keyframe=add_kf, cov=cov,
                       n_inliers=n_inliers, n_matches=n_match, vel=vel,
                       dist=new_carry["dist"],
                       used_global=use_global,
                       n_matches_guided=n_match_g,
                       n_matches_global=n_match_n)
            return new_carry, out

    # ---- chunk program ---------------------------------------------------
    def chunk_step(carry, lefts, rights, dts, active, draws):
        with perf.span("vo.frontend"):
            feats_all = frontend(lefts, rights)
            feats_all["nbits"] = feats_all["bits"].sum(dim=2)
        per_frame = []
        for i in range(lefts.shape[0]):
            with perf.span("vo.step"):
                f = {k: v[i] for k, v in feats_all.items()}
                nc, out = vo_step(carry, f, dts[i], draws[i])
                act = active[i]
                carry = {k: torch.where(act, nc[k], carry[k])
                         for k in carry}
            per_frame.append(out)
        outs = {k: torch.stack([o[k] for o in per_frame])
                for k in per_frame[0]}
        outs["n_kpts"] = feats_all["n_kpts"]
        feats = {k: feats_all[k][off]
                 for k in ("kpts", "pts3d", "desc", "disp_dec", "n_kpts")}
        return carry, outs, feats

    def init_carry():
        return dict(
            pose=eye4.clone(),
            vel=torch.zeros(6, **f32),
            has_vel=torch.tensor(False, device=device),
            kf_pose=eye4.clone(),
            ref_kpts=torch.zeros((C, 3), **f32),
            ref_pts3d=torch.full((C, 3), float("nan"), **f32),
            ref_bits=torch.zeros((C, 256), **f32),
            ref_nbits=torch.zeros((C,), **f32),
            ref_valid=torch.zeros((C,), dtype=torch.bool, device=device),
            ref_n=torch.tensor(0, device=device),
            num_objects=torch.tensor(0, device=device),
            frames=torch.tensor(0, device=device),
            dist=torch.tensor(0.0, **f32),
        )

    return init_carry, chunk_step, full_node_offsets
