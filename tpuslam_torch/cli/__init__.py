"""Command-line entry points: the batch SLAM app (slam_batch), the
realtime app (slam_realtime), the pose-graph replay (optimize_replay),
and the tool apps: the kernel A/B harness with its stage dumps
(kernel_test), the hardware self-tests (hw_test: 9dof, patterns through
the per-frame device front end, timing), stereo calibration
(stereo_calib) and the dataset capture app (stereo_capture); the
multi-process app (slam_multihost: the front end sharded by frame
blocks, the rank-partitioned map)."""
