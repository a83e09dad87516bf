"""Per-frame front end: disparity -> keypoints -> descriptors -> 3D.

Counterpart of tpuslam/runtime/pipeline.py (the feature-generation block
of the reference main loop, main.cpp:195-255): the depth engine that
`cfg.depth_method` names (appSetting.depthMethod, main.cpp:197-244,
Parameters.h:24-30), GFTT candidates (kernel K2, the 3x3 local max and the
two-stage top-k), the host's grid min-distance suppression, the ORB
border filter (computeDescriptor's runByImageBorder, so a frame's
keypoints are the border-filtered set), ORB descriptors (kernel K3) and
the 3D points in the robot frame (Stereo.cpp:53-155).  The depth engines:
  * "bm": StereoBM and its left-right check (kernels K1 and K5), then the
    speckle filter;
  * "sgbm": semi-global matching on the device (kernels/sgbm.py), then
    its speckle filter (x16 range);
  * "lk": no dense map; LK stereo tracks the keypoints to the right image
    at collect time (Stereo.cpp:9-51, kernels/lk_stereo.py);
  * "cv_bm": OpenCV's StereoBM on the host with tpuslam's setters, the
    map then moved to the device (the oracle engine).

`frontend_dispatch` queues one frame's image-sized device work and
returns without waiting for the card; `frontend_collect` waits for it and
finishes on the host, so a driver may queue frame i+1 before it collects
frame i.  The speckle filter checks its labels for convergence on the
host, so it runs at collect time.  A CPU tensor takes every kernel's plain
version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DepthMethod, SlamConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel, project_disparity_to_3d
from ..kernels.gftt import gftt_candidates, select_from_candidates
from ..kernels.lk_stereo import lk_stereo
from ..kernels.orb import orb_descriptors, run_by_image_border
from ..kernels.sgbm import sgbm, speckle_sgbm
from ..kernels.stereo_bm import speckle_bm, stereo_bm_lr
from ..vo.frame import Frame, CAPACITY


def _cv_bm(left: np.ndarray, right: np.ndarray, bm) -> np.ndarray:
    """cv2.StereoBM with tpuslam's setters (the oracle engine), on the
    host: (H, W) int16 x16 disparity, speckle-filtered by OpenCV."""
    import cv2
    m = cv2.StereoBM_create(bm.num_disparities, bm.block_size)
    m.setPreFilterCap(bm.prefilter_cap)
    m.setTextureThreshold(bm.texture_threshold)
    m.setUniquenessRatio(bm.uniqueness_ratio)
    m.setSpeckleWindowSize(bm.speckle_window_size)
    m.setSpeckleRange(bm.speckle_range)
    m.setDisp12MaxDiff(bm.disp12_max_diff)
    return m.compute(left, right)


def frontend_dispatch(left: np.ndarray, right: np.ndarray, cfg: SlamConfig,
                      device="cuda") -> dict:
    """Queue the image-sized device work of one (H, W) uint8 stereo pair on
    `device` (the card unless the caller asks for the CPU) without
    waiting for it: the dense depth engine (none for "lk"), the GFTT
    candidates, and their copies to the host."""
    left_d = torch.as_tensor(left).to(device)[None]
    right_d = torch.as_tensor(right).to(device)[None]
    method = DepthMethod(cfg.depth_method)
    if method == DepthMethod.SGBM:
        disp = sgbm(left_d, right_d, cfg.sgbm, with_speckle=False,
                    device=left_d.device)               # main.cpp:218-244
    elif method == DepthMethod.LK:
        disp = None                  # sparse: tracked at collect time
    elif method == DepthMethod.CV_BM:
        disp = torch.as_tensor(_cv_bm(left, right, cfg.bm)).to(device)[None]
    else:
        disp = stereo_bm_lr(left_d, right_d, cfg.bm)        # K1, K5
    vals, idx, _, _ = gftt_candidates(left_d, cfg.gftt.quality_level,
                                      cfg.gftt.block_size)  # K2
    # the candidates' copies to the host overlap whatever the host does
    # until collect
    cand = tuple(t[0].to("cpu", non_blocking=True) for t in (vals, idx))
    ready = None
    if left_d.is_cuda:
        ready = torch.cuda.Event()
        ready.record()
    return {"left": left, "right": right, "left_d": left_d,
            "right_d": right_d, "disp": disp, "method": method,
            "cand": cand, "ready": ready}


def frontend_collect(pending: dict, camera: StereoCameraModel,
                     cfg: SlamConfig, stamp: float = 0.0,
                     frame_id: int = -1,
                     gt_pose: np.ndarray | None = None) -> Frame:
    """Wait for a frontend_dispatch result and finish the frame: the host
    NMS, the border filter, ORB descriptors (queued before the speckle
    filter), the speckle filter and the 3D lift."""
    left = pending["left"]
    if pending["ready"] is not None:
        pending["ready"].synchronize()
    vals, flat_idx = (t.numpy() for t in pending["cand"])
    kpts = select_from_candidates(vals, flat_idx, width=left.shape[1],
                                  max_features=cfg.gftt.max_features,
                                  min_distance=cfg.gftt.min_distance)

    # ORB border filter + descriptors (CvORB.cpp:137-218)
    kpts, _ = run_by_image_border(kpts, left.shape,
                                  cfg.orb.edge_threshold)
    desc_dev, _ = orb_descriptors(pending["left_d"][0], kpts[:, :2],
                                  max_kpts=CAPACITY)         # K3
    method, disp = pending["method"], pending["disp"]
    if method == DepthMethod.BM:
        disp = speckle_bm(disp, cfg.bm)
    elif method == DepthMethod.SGBM:
        disp = speckle_sgbm(disp, cfg.sgbm)
    n = len(kpts)
    desc = desc_dev.cpu().numpy()[:n]

    # disparity -> 3D in robot frame (Stereo.cpp:53-155)
    if disp is None:     # the sparse LK correspondences (Stereo.cpp:9-51)
        disp_np = None
        kpts3d = _keypoints_3d_lk(kpts, pending["left_d"][0],
                                  pending["right_d"][0], camera, cfg)
    else:
        disp_np = disp[0].cpu().numpy()
        kpts3d = _keypoints_3d(kpts, disp_np, camera)

    frame = Frame(stamp=stamp, image_left=left,
                  image_right=pending["right"],
                  disparity=disp_np, kpts=kpts, kpts3d=kpts3d,
                  desc=desc, gt_pose=gt_pose, frame_id=frame_id)
    return frame


def extract_features(left: np.ndarray, right: np.ndarray,
                     camera: StereoCameraModel, cfg: SlamConfig,
                     stamp: float = 0.0, frame_id: int = -1,
                     gt_pose: np.ndarray | None = None,
                     device="cuda") -> Frame:
    """Full front end for one stereo pair -> populated Frame, on `device`
    (the card unless the caller asks for the CPU)."""
    return frontend_collect(frontend_dispatch(left, right, cfg, device),
                            camera, cfg, stamp, frame_id, gt_pose)


def _keypoints_3d_lk(kpts: np.ndarray, left_d: torch.Tensor,
                     right_d: torch.Tensor, camera: StereoCameraModel,
                     cfg: SlamConfig) -> np.ndarray:
    """Sparse 3D from per-keypoint LK stereo correspondences on the
    images' device.

    Twin of computeCorrespondences + generateKeypoints3DStereo for the
    DEPTH_METHOD_CV_LK option (Stereo.cpp:9-51, 84-117): pyramidal LK to
    the right image over CAPACITY points, disparity = left.x - right.x,
    gate (min_disparity, max_disparity], project, optical->robot
    transform."""
    n = len(kpts)
    if n == 0:
        return np.zeros((0, 3), np.float32)
    lk = cfg.lk
    pts = np.zeros((CAPACITY, 2), np.float32)
    val = np.zeros((CAPACITY,), bool)
    pts[:n] = kpts[:, :2]
    val[:n] = True
    nxt, status, _ = lk_stereo(
        left_d, right_d, pts, val, win=(lk.win_w, lk.win_h),
        max_level=lk.max_level, max_iters=lk.iterations, eps=lk.epsilon,
        min_eig_threshold=lk.min_eig_threshold, device=left_d.device)
    nxt = nxt.cpu().numpy()[:n]
    status = status.cpu().numpy()[:n]
    d = kpts[:n, 0] - nxt[:, 0]
    ok = status & (d > lk.min_disparity) & (d <= lk.max_disparity)
    pts3 = project_disparity_to_3d(kpts[:n, :2],
                                   np.where(ok, d, 0.0).astype(np.float32),
                                   camera)
    pts3[~ok] = np.nan
    valid = np.isfinite(pts3).all(axis=1)
    out = np.full_like(pts3, np.nan)
    if valid.any():
        out[valid] = T.transform_points(camera.local_transform,
                                        pts3[valid])
    return out.astype(np.float32)


def _keypoints_3d(kpts: np.ndarray, disp: np.ndarray,
                  camera: StereoCameraModel) -> np.ndarray:
    """generateKeypoints3DStereo twin (Stereo.cpp:53-117): sample the x16
    fixed-point dense map at truncated int coords, clamp negatives to 0,
    project, then optical->robot transform."""
    if len(kpts) == 0:
        return np.zeros((0, 3), np.float32)
    xs = kpts[:, 0].astype(np.int64)   # (int) cast truncates like C++
    ys = kpts[:, 1].astype(np.int64)
    d16 = disp[ys, xs].astype(np.float32)
    d = d16 / 16.0
    d = np.maximum(d, 0.0)
    pts = project_disparity_to_3d(kpts[:, :2], d, camera)
    # disparity == 0 -> invalid (Stereo.cpp:89-90 skips zero)
    pts[d == 0.0] = np.nan
    valid = np.isfinite(pts).all(axis=1)
    out = np.full_like(pts, np.nan)
    if valid.any():
        out[valid] = T.transform_points(camera.local_transform, pts[valid])
    return out.astype(np.float32)
