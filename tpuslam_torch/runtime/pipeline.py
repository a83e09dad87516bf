"""Per-frame front end: disparity -> keypoints -> descriptors -> 3D.

Counterpart of tpuslam/runtime/pipeline.py (the feature-generation block
of the reference main loop, main.cpp:195-255) for the "bm" depth method:
StereoBM and its left-right check (kernels K1 and K5), the speckle
filter, GFTT candidates (kernel K2, the 3x3 local max and the two-stage
top-k), the host's grid min-distance suppression, the ORB border filter
(computeDescriptor's runByImageBorder, so a frame's keypoints are the
border-filtered set), ORB descriptors (kernel K3) and the
disparity-lifted 3D points in the robot frame (Stereo.cpp:119-155).

`frontend_dispatch` queues one frame's image-sized device work and
returns without waiting for the card; `frontend_collect` waits for it and
finishes on the host, so a driver may queue frame i+1 before it collects
frame i.  The speckle filter checks its labels for convergence on the
host, so it runs at collect time.  A CPU tensor takes every kernel's plain
version.  The other depth methods (SGBM, LK stereo, OpenCV's BM) raise
NotImplementedError (ROADMAP A4).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DepthMethod, SlamConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel, project_disparity_to_3d
from ..kernels.gftt import gftt_candidates, select_from_candidates
from ..kernels.orb import orb_descriptors, run_by_image_border
from ..kernels.stereo_bm import speckle_bm, stereo_bm_lr
from ..vo.frame import Frame, CAPACITY


def check_depth_method(cfg: SlamConfig) -> None:
    """Refuse the depth methods that are not ported."""
    if cfg.depth_method != DepthMethod.BM:
        raise NotImplementedError(
            f"depth_method={DepthMethod(cfg.depth_method).value!r}: only "
            "'bm' is ported (ROADMAP A4)")


def frontend_dispatch(left: np.ndarray, right: np.ndarray, cfg: SlamConfig,
                      device="cuda") -> dict:
    """Queue the image-sized device work of one (H, W) uint8 stereo pair on
    `device` (the card unless the caller asks for the CPU) without
    waiting for it: StereoBM + the left-right check, the GFTT candidates,
    and their copies to the host."""
    check_depth_method(cfg)
    left_d = torch.as_tensor(left).to(device)[None]
    right_d = torch.as_tensor(right).to(device)[None]
    disp = stereo_bm_lr(left_d, right_d, cfg.bm)            # K1, K5
    vals, idx, _, _ = gftt_candidates(left_d, cfg.gftt.quality_level,
                                      cfg.gftt.block_size)  # K2
    # the candidates' copies to the host overlap whatever the host does
    # until collect
    cand = tuple(t[0].to("cpu", non_blocking=True) for t in (vals, idx))
    ready = None
    if left_d.is_cuda:
        ready = torch.cuda.Event()
        ready.record()
    return {"left": left, "right": right, "left_d": left_d, "disp": disp,
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
    disp = speckle_bm(pending["disp"], cfg.bm)
    n = len(kpts)
    desc = desc_dev.cpu().numpy()[:n]

    # disparity -> 3D in robot frame (Stereo.cpp:53-155)
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
