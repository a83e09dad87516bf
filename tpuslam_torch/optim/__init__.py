"""Pose-graph optimization (SE3 Levenberg-Marquardt with robust
loop-closure outlier ejection: the host backend in f64, the device
backends of optim/device.py in f32) and bundle adjustment (torch):
counterpart of tpuslam/optim/."""

from .pose_graph import PoseGraphOptimizer, run_optimize, run_optimize_robust  # noqa: F401
