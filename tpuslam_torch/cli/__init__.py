"""Command-line entry points: the batch SLAM app (slam_batch), the
realtime app (slam_realtime) and the pose-graph replay
(optimize_replay)."""
