"""Pose-graph optimization (SE3 Levenberg-Marquardt with robust
loop-closure outlier ejection, host f64) and bundle adjustment (torch):
counterpart of tpuslam/optim/.  The device pose-graph backend
(tpuslam/optim/device.py) is not ported yet (ROADMAP A5)."""

from .pose_graph import PoseGraphOptimizer, run_optimize, run_optimize_robust  # noqa: F401
