"""Trajectory error against ground truth: the KITTI odometry metric and
the absolute trajectory error.

`segment_errors` is a frozen copy of
tpuslam_torch/geometry/kitti_metric.py (the devkit's logic, reference
KITTI.cpp:90-154): per-segment translation % and rotation deg/m over
100..800 m segments starting every 10 frames, averaged.
"""

from __future__ import annotations

import numpy as np

SEGMENT_LENGTHS = (100.0, 200.0, 300.0, 400.0, 500.0, 600.0, 700.0, 800.0)
STEP_SIZE = 10


def _trajectory_distances(poses: np.ndarray) -> np.ndarray:
    d = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    return np.concatenate([[0.0], np.cumsum(d)])


def segment_errors(poses_gt, poses_result):
    """(t_err %, r_err deg/m); nan where no segment of 100 m fits."""
    poses_gt = np.asarray(poses_gt, dtype=np.float64)
    poses_result = np.asarray(poses_result, dtype=np.float64)
    dist = _trajectory_distances(poses_gt)
    t_errs, r_errs = [], []
    for first in range(0, len(poses_gt), STEP_SIZE):
        for length in SEGMENT_LENGTHS:
            beyond = np.nonzero(dist[first:] > dist[first] + length)[0]
            if beyond.size == 0:
                continue
            last = first + int(beyond[0])
            delta_gt = np.linalg.inv(poses_gt[first]) @ poses_gt[last]
            delta_res = np.linalg.inv(poses_result[first]) @ \
                poses_result[last]
            err = np.linalg.inv(delta_res) @ delta_gt
            cos = np.clip(0.5 * (np.trace(err[:3, :3]) - 1.0), -1.0, 1.0)
            r_errs.append(float(np.arccos(cos)) / length)
            t_errs.append(float(np.linalg.norm(err[:3, 3])) / length)
    if not t_errs:
        return float("nan"), float("nan")
    return (float(np.mean(t_errs)) * 100.0,
            float(np.mean(r_errs)) * 180.0 / np.pi)


def ate(poses_gt, poses_result) -> float:
    """Root mean square of the position error, in metres."""
    gt = np.asarray(poses_gt, np.float64)[:, :3, 3]
    est = np.asarray(poses_result, np.float64)[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))
