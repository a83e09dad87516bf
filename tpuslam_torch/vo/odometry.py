"""Visual odometry state machine, on the port's registration.

Counterpart of tpuslam/vo/odometry.py (the reference's Odometry.cpp):

  * constant-velocity motion guess from the previous frame interval
    (Odometry.cpp:42-56),
  * frame-to-keyframe registration with guided matching; wrong-guess retry
    without a prior when matches < 25% of the previous count
    (Odometry.cpp:139-142, _guessRatio = 0.25),
  * keyframe insertion when inliers <= 30% of the reference frame's
    keypoints or <= 150 (Odometry.cpp:165-176),
  * Lost state with null transform propagation (Odometry.cpp:148-153);
    like the reference, a lost frame multiplies the pose by the null
    transform — the caller is expected to stop/handle via odom_info.lost.

Registration (vo/registration.py) runs on `device`, the card unless the
caller asks for the CPU.  The RANSAC seed of a frame is
`frames_processed`; `draws_fn(seed)`, when set, supplies its uniforms
(tests pass tpuslam's).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..config import OdometryConfig, MatchingConfig, PnPConfig
from ..geometry import transform as T
from ..geometry.camera import StereoCameraModel
from .frame import Frame
from .registration import compute_transform, RegInfo


@dataclass
class OdomInfo:
    """ODOM_INFO twin (include/core/Odometry.h:11-20)."""
    pose: np.ndarray = field(default_factory=T.identity)
    lost: bool = False
    stamp: float = 0.0
    interval: float = 0.0
    transform: np.ndarray = field(default_factory=T.identity)
    distance_travelled: float = 0.0
    velocity: np.ndarray | None = None
    covariance: np.ndarray = field(
        default_factory=lambda: np.eye(6, dtype=np.float64))
    keyframe_added: bool = False
    num_inliers: int = 0
    num_matches: int = 0


class Odometry:
    def __init__(self, camera: StereoCameraModel,
                 cfg: OdometryConfig = OdometryConfig(),
                 matching_cfg: MatchingConfig = MatchingConfig(),
                 pnp_cfg: PnPConfig = PnPConfig(), device="cuda",
                 draws_fn=None):
        self.camera = camera
        self.device = device
        self.draws_fn = draws_fn       # seed -> RANSAC uniforms (tests)
        self.cfg = cfg
        self.matching_cfg = matching_cfg
        self.pnp_cfg = pnp_cfg

        self.pose = T.identity()
        self.velocity_guess: np.ndarray | None = None  # None == null
        self.last_keyframe_pose: np.ndarray | None = None
        self.ref_frame: Frame | None = None
        self.previous_stamp = 0.0
        self.frames_processed = 0
        self.num_objects = 0           # matches of the previous frame
        self.distance_travelled = 0.0
        self.state = "Initialized"     # Initialized | Running | Lost
        self.reg_info = RegInfo()

    def _draws(self):
        return None if self.draws_fn is None \
            else self.draws_fn(self.frames_processed)

    # -- Odometry::process (Odometry.cpp:31-100) -------------------------
    def process(self, frame: Frame) -> OdomInfo:
        dt = 0.0 if self.frames_processed == 0 \
            else frame.stamp - self.previous_stamp

        if self.velocity_guess is None:
            guess = None
        else:
            v = self.velocity_guess
            guess = T.from_rpy_xyz(v[0] * dt, v[1] * dt, v[2] * dt,
                                   v[3] * dt, v[4] * dt, v[5] * dt)

        t = self._update_motion(frame, guess)

        if dt:
            if t is None:
                self.velocity_guess = np.zeros(6, np.float32)
            else:
                roll, pitch, yaw = T.get_rpy(t)
                self.velocity_guess = np.array(
                    [t[0, 3] / dt, t[1, 3] / dt, t[2, 3] / dt,
                     roll / dt, pitch / dt, yaw / dt], np.float32)
        else:
            self.velocity_guess = None

        if t is not None:
            self.distance_travelled += T.translation_norm(t)
            self.pose = T.compose(self.pose, t)
        self.previous_stamp = frame.stamp
        self.frames_processed += 1

        info = OdomInfo(
            pose=self.pose.copy(),
            lost=t is None,
            stamp=frame.stamp,
            interval=dt,
            transform=t.copy() if t is not None else T.NULL.copy(),
            distance_travelled=self.distance_travelled,
            velocity=self.velocity_guess,
            covariance=self.reg_info.covariance,
            keyframe_added=self._keyframe_added,
            num_inliers=self.reg_info.num_inliers,
            num_matches=self.reg_info.num_matches,
        )
        return info

    # -- Odometry::updateMotion (Odometry.cpp:104-183) --------------------
    def _update_motion(self, frame: Frame, guess: np.ndarray | None):
        if self.last_keyframe_pose is None:
            self.last_keyframe_pose = self.pose.copy()
        motion_since_kf = T.compose(T.inverse(self.last_keyframe_pose),
                                    self.pose)

        reg = RegInfo()
        if self.frames_processed == 0:
            t = T.identity()
            reg.covariance = np.eye(6, dtype=np.float64) * \
                self.cfg.initial_cov
        else:
            guess_update = None if guess is None \
                else T.compose(motion_since_kf, guess)
            t, reg = compute_transform(
                self.ref_frame, frame, guess_update, self.camera,
                nndr=self.matching_cfg.nndr,
                guess_win_size=self.matching_cfg.guess_win_size,
                min_inliers=self.pnp_cfg.min_inliers,
                refine_iterations=self.pnp_cfg.refine_iterations,
                seed=self.frames_processed, device=self.device,
                draws=self._draws())

            # wrong-guess retry (Odometry.cpp:139-142)
            if (guess_update is not None and
                    reg.num_matches <
                    self.num_objects * self.cfg.guess_ratio):
                t, reg = compute_transform(
                    self.ref_frame, frame, None, self.camera,
                    nndr=self.matching_cfg.nndr,
                    guess_win_size=self.matching_cfg.guess_win_size,
                    min_inliers=self.pnp_cfg.min_inliers,
                    refine_iterations=self.pnp_cfg.refine_iterations,
                    seed=self.frames_processed, device=self.device,
                    draws=self._draws())

            self.num_objects = reg.num_matches

        self.state = "Lost" if t is None else "Running"

        output = None if t is None \
            else T.compose(T.inverse(motion_since_kf), t)

        # keyframe update (Odometry.cpp:160-176)
        n_ref_kpts = self.ref_frame.n_kpts if self.ref_frame else 0
        add_keyframe = (
            self.frames_processed == 0 or
            float(reg.num_inliers) <= self.cfg.keyframe_thr * n_ref_kpts or
            reg.num_inliers <= self.cfg.vis_keyframe_thr)
        if add_keyframe:
            self.ref_frame = frame
            self.last_keyframe_pose = None

        self._keyframe_added = add_keyframe
        self.reg_info = reg
        return output
